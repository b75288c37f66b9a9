"""Stereo ops, NCHW (counterpart of `openstereo_tpu/ops`)."""

from .cost_volume import (build_concat_volume, build_cosine_gwc_volume,  # noqa: F401
                          build_fs_concat_volume, build_gwc_volume, build_sub_volume,
                          correlation_volume, groupwise_correlation, l2_normalize,
                          normalize_groups)
from .corr_volume import corr_volume  # noqa: F401
from .disp_regression import disparity_regression, topk_disparity_regression  # noqa: F401
from .fused_mbconv import fold_bn, fused_mbconv, mbconv_plain  # noqa: F401
from .gwc_volume import gwc_volume  # noqa: F401
from .rel_attention import rel_attention, rel_attention_plain, rel_attention_trainable  # noqa: F401
from .sampler import bilinear_sampler, disp_warp, sample_along_w  # noqa: F401
from .upsample import (context_upsample, resize_bicubic_torch, resize_bilinear,  # noqa: F401
                       resize_linear, resize_linear_align_corners, resize_nearest,
                       resize_trilinear, unfold3x3, upsample_nearest)
