from .sttr import STTR  # noqa: F401
