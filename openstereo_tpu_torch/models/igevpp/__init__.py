from .igevpp import IGEVPP  # noqa: F401
