from .monster import MonSter  # noqa: F401
