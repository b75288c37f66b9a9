"""Stereo ops, NCHW (counterpart of `openstereo_tpu/ops`)."""

from .cost_volume import (build_concat_volume, build_gwc_volume, correlation_volume,  # noqa: F401
                          groupwise_correlation)
from .corr_volume import corr_volume  # noqa: F401
from .disp_regression import disparity_regression, topk_disparity_regression  # noqa: F401
from .fused_mbconv import fold_bn, fused_mbconv, mbconv_plain  # noqa: F401
from .gwc_volume import gwc_volume  # noqa: F401
from .rel_attention import rel_attention, rel_attention_plain  # noqa: F401
from .upsample import (context_upsample, resize_bilinear, resize_linear_align_corners,  # noqa: F401
                       resize_nearest, resize_trilinear, unfold3x3, upsample_nearest)
