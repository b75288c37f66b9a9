from .msnet import MSNet2D, MSNet3D  # noqa: F401
