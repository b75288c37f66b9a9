from .coex import CoExNet  # noqa: F401
