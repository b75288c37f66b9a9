from .cfnet import CFNet  # noqa: F401
