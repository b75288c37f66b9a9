from .stereobase import StereoBase  # noqa: F401
