from . import transforms  # noqa: F401
