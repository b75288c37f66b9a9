from .mobilenetv2 import MobileNetV2Features  # noqa: F401
