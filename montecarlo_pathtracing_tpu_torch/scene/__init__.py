from .scene import Material, ScenePrimitives, MeshGeometry  # noqa: F401
