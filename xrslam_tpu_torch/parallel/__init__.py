from . import mesh, sharded  # noqa: F401
