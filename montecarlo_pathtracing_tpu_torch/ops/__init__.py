from . import rng, intersect  # noqa: F401
