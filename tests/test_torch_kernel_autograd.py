"""The inference kernels under autograd, on the CPU.

K1 (`corr_volume`), K3 (`gwc_volume`) and K2 (`fused_mbconv`) have no
backward. With grad mode on and an input that requires grad, each
wrapper's result is an output of `kernels.without_backward`'s Function:
its values are the plain version's (on the CPU the wrapper runs it), and a
backward through it raises on every device, naming the plain function to
train through, where a result without a graph would cut the gradient
without a word. The models that run these kernels in eval (GwcNet, MSNet3D,
CoEx, and IGEV, IGEV-RT, StereoBase and IGEV++ with K3 and K2 in their
trunks; FoundationStereo, FastFoundationStereo and MonSter with K3) build
their training forwards with the plain builders and the trunk's eager
blocks, so a gradient reaches their first backbone conv (MonSter's: the
first of its trainable pyramid decoder, behind the frozen ViT) with
`use_kernels` on: no K2 or K3 result enters a backward. The compute dtype
set on those three models reaches every conv and linear of their forwards.
"""

import pytest
import torch

from openstereo_tpu_torch import ops
from openstereo_tpu_torch.models import set_kernels
from openstereo_tpu_torch.models.coex import CoExNet
from openstereo_tpu_torch.models.fastfoundationstereo import FastFoundationStereo
from openstereo_tpu_torch.models.foundationstereo import FoundationStereo
from openstereo_tpu_torch.models.gwcnet import GwcNet
from openstereo_tpu_torch.models.igev import IGEV
from openstereo_tpu_torch.models.igev_rt import IGEVRT
from openstereo_tpu_torch.models.igevpp import IGEVPP
from openstereo_tpu_torch.models.monster import MonSter
from openstereo_tpu_torch.models.msnet import MSNet3D
from openstereo_tpu_torch.models.stereobase import StereoBase

from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)


def _k1():
    g = torch.Generator().manual_seed(0)
    l, r = (torch.randn(2, 8, 5, 19, generator=g) for _ in range(2))
    return ops.corr_volume, ops.correlation_volume, (l, r), dict(max_disp=6), "correlation_volume"


def _k3():
    g = torch.Generator().manual_seed(1)
    l, r = (torch.randn(1, 12, 4, 17, generator=g) for _ in range(2))
    return (ops.gwc_volume, ops.build_gwc_volume, (l, r), dict(max_disp=5, num_groups=3),
            "build_gwc_volume")


def _k2():
    g = torch.Generator().manual_seed(2)
    cin, ch = 8, 16
    args = (torch.randn(2, cin, 6, 9, generator=g), torch.randn(cin, ch, generator=g) * 0.3,
            torch.randn(ch, generator=g) * 0.1, torch.randn(9, ch, generator=g) * 0.3,
            torch.randn(ch, generator=g) * 0.1, torch.randn(ch, cin, generator=g) * 0.3,
            torch.randn(cin, generator=g) * 0.1)
    return ops.fused_mbconv, ops.mbconv_plain, args, dict(residual=True), "mbconv_plain"


WRAPPERS = {"corr_volume": _k1, "gwc_volume": _k3, "fused_mbconv": _k2}


@pytest.mark.parametrize("name", WRAPPERS)
def test_backward_through_a_kernel_wrapper_raises_naming_the_plain_function(name):
    wrapper, _, args, kw, plain = WRAPPERS[name]()
    x = args[0].clone().requires_grad_(True)
    out = wrapper(x, *args[1:], **kw)
    assert out.requires_grad and type(out.grad_fn).__name__ == "_NoBackwardBackward"
    with pytest.raises(RuntimeError, match=f"{name} has no backward.*{plain}"):
        out.sum().backward()
    assert x.grad is None


@pytest.mark.parametrize("name", WRAPPERS)
def test_kernel_wrapper_forward_equals_the_plain_version(name):
    """The same values with grad mode on (input requiring grad), with it on
    and no input requiring grad (no graph at all), and under
    `torch.inference_mode()`."""
    wrapper, plain, args, kw, _ = WRAPPERS[name]()
    with torch.no_grad():
        ref = plain(*args, **kw)
    x = args[0].clone().requires_grad_(True)
    got = wrapper(x, *args[1:], **kw)
    assert torch.equal(got.detach(), ref)
    free = wrapper(*args, **kw)
    assert free.grad_fn is None and torch.equal(free, ref)
    with torch.inference_mode():
        inf = wrapper(*args, **kw)
    assert torch.equal(inf, ref)


@pytest.mark.parametrize("cls,kw,hw,first_conv", [
    (GwcNet, dict(max_disp=16, num_groups=8, concat_channels=4), (32, 64),
     "Backbone.feature_extraction.firstconv.0.0"),
    (MSNet3D, dict(max_disp=16), (32, 64), "feature_extraction.firstconv.0.conv.0"),
    (CoExNet, dict(max_disp=16), (48, 80), "Backbone.feat.conv_stem"),
    (IGEV, dict(max_disp=32, train_iters=2), (32, 64), "feature.conv_stem"),
    (IGEVRT, dict(max_disp=32, train_iters=2), (32, 64), "feature.conv_stem"),
    (StereoBase, dict(max_disp=32, use_concat_volume=True, concat_channels=8, train_iters=2),
     (32, 64), "feature.conv_stem"),
    (IGEVPP, dict(max_disp=128, s_disp_range=16, m_disp_range=16, l_disp_range=32,
                  train_iters=2), (32, 128), "feature.conv_stem"),
    (FoundationStereo, dict(max_disp=32, train_iters=2), (32, 64), "feature.stem.0"),
    (FastFoundationStereo, dict(max_disp=32, train_iters=2), (32, 64), "feature.stem.0"),
    (MonSter, dict(max_disp=32, train_iters=3, mix_iters=2), (32, 64), "feat_decoder.projects.0"),
], ids=["GwcNet", "MSNet3D", "CoEx", "IGEV", "IGEV-RT", "StereoBase", "IGEV++", "FoundationStereo",
        "FastFoundationStereo", "MonSter"])
def test_training_forward_with_kernels_on_reaches_the_backbone(cls, kw, hw, first_conv):
    g = torch.Generator().manual_seed(3)
    model = cls(**kw).train()
    assert model.use_kernels
    for p in model.parameters():
        p.data.normal_(0.0, 0.1, generator=g)
    batch = {"left": torch.randn(1, 3, *hw, generator=g),
             "right": torch.randn(1, 3, *hw, generator=g),
             "disp": torch.rand(1, *hw, generator=g) * 15}
    loss, _ = model.get_loss(model(batch), batch)
    loss.backward()
    grad = model.get_submodule(first_conv).weight.grad
    assert grad is not None and float(grad.abs().max()) > 0


@pytest.mark.parametrize("cls,kw", [
    (FoundationStereo, dict(max_disp=32, valid_iters=2)),
    (FastFoundationStereo, dict(max_disp=32, valid_iters=2)),
    (MonSter, dict(max_disp=32, valid_iters=3, mix_iters=2)),
], ids=["FoundationStereo", "FastFoundationStereo", "MonSter"])
def test_model_dtype_reaches_every_conv_and_linear(cls, kw):
    """The compute dtype is the model's alone: set on a built model (as the
    f64 reference of a gradient check sets it), every conv and linear of
    the forward runs in it, the features, the ViT and MonSter's REMP
    included (they take it from their caller)."""
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    ops_seen = (F.conv2d, F.conv3d, F.conv_transpose2d, F.conv_transpose3d, F.linear)
    seen = set()

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in ops_seen:
                seen.add((func.__name__, args[0].dtype))
            return func(*args, **(kwargs or {}))

    g = torch.Generator().manual_seed(4)
    model = set_kernels(cls(**kw).double().eval(), False)  # the kernels take f32 and bf16
    model.dtype = torch.float64
    batch = {k: torch.randn(1, 3, 32, 64, generator=g, dtype=torch.float64)
             for k in ("left", "right")}
    with torch.inference_mode(), Record():
        model(batch)
    assert {d for _, d in seen} == {torch.float64}, seen
    assert {"conv2d", "conv3d", "linear"} <= {f for f, _ in seen}
