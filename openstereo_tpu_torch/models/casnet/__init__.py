from .casnet import CasGwcNet, CasPSMNet  # noqa: F401
