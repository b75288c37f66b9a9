from .igev_rt import IGEVRT  # noqa: F401
