from .fadnet import FADNet  # noqa: F401
