from .fastfoundationstereo import FastFoundationStereo  # noqa: F401
