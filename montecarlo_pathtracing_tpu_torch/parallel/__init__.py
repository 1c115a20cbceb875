from .sharding import make_mesh, shard_rays  # noqa: F401
