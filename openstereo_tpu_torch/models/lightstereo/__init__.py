from .lightstereo import LightStereo  # noqa: F401
