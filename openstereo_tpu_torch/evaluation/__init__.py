from .metrics import METRIC_FNS, compute_metrics  # noqa: F401
