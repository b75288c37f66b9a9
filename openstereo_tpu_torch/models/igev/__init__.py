from .igev import IGEV  # noqa: F401
