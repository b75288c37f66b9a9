from .psmnet import PSMNet  # noqa: F401
