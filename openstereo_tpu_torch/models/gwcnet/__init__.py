from .gwcnet import GwcNet  # noqa: F401
