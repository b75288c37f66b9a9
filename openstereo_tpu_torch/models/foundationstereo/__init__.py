from .foundationstereo import FoundationStereo  # noqa: F401
