"""Linear and bilinear sampling by gather (counterpart of `openstereo_tpu/ops/sampler.py`).

- `sample_along_w`: linear interpolation along W at per-sample positions,
  zero outside the frame: the warped-cost-volume core of CasNet and CFNet
  (`sampler.py:161-182`).
- `bilinear_sampler`: `grid_sample(align_corners=True, padding_mode="zeros")`
  on pixel coordinates (`sampler.py:80-96`): FADNet's warp.
- `disp_warp`: the right view sampled at (x − d, y) through
  `bilinear_sampler`, zero outside the frame or clamped to its border
  (`sampler.py:185-218`): MonSter's warps.

The JAX package's packed-patch and hat-matrix forms (`_pack_2x2`,
`_sample_packed`, `bilinear_sampler_mxu`) only work around TPU gathers;
these are plain gathers with the same results, rounding as the JAX program
does op by op: interpolation weights in the positions' dtype, then cast to
the sampled tensor's dtype.
"""

from __future__ import annotations

import torch


def sample_along_w(y: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """y [B,C,H,W] sampled at x-positions pos [B,D,H,W] → [B,C,D,H,W] in y's
    dtype: y[b,c,h,x] interpolated linearly in x, taps outside [0, W) zero.

    JAX counterpart maps [B,H,W,C] × [B,D,H,W] → [B,D,H,W,C]; the port's
    result is its transpose (0,4,1,2,3). As there, the fraction is taken in
    pos's dtype and rounded to y's, each tap's weight and product is in y's
    dtype, and the two taps are summed in y's dtype.
    """
    b, c, h, w = y.shape
    d = pos.shape[1]
    x0 = torch.floor(pos)
    frac = (pos - x0).to(y.dtype)
    x0 = x0.to(torch.int64)
    flat = y.reshape(b, c, h * w)
    row = (torch.arange(h, device=y.device) * w).reshape(1, 1, h, 1)
    out = None
    for tap, wgt in ((0, 1.0 - frac), (1, frac)):
        xi = x0 + tap
        wgt = wgt * ((xi >= 0) & (xi < w)).to(y.dtype)
        idx = (row + xi.clamp(0, w - 1)).reshape(b, 1, d * h * w).expand(b, c, d * h * w)
        g = torch.gather(flat, 2, idx).reshape(b, c, d, h, w)
        contrib = g * wgt[:, None]
        out = contrib if out is None else out + contrib
    return out


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img [B,C,H,W] sampled at coords [B,...,2] = (x, y) pixel coordinates →
    [B,C,...] in img's dtype, with `grid_sample(align_corners=True,
    padding_mode="zeros")` semantics: each of the four taps outside the
    frame contributes zero.

    JAX counterpart takes img [B,H,W,C] and returns [B,...,C]. As there, the
    tap weights are formed in the coordinates' dtype (a bf16 weight is
    rounded as JAX rounds it), cast to img's dtype, and the four weighted
    taps summed in img's dtype. The frame tests compare the floored
    coordinate with H−1, W−1 (H−2, W−2 for the second tap) rounded to the
    coordinates' dtype, as `_sample_packed` compares them with its weakly
    typed bounds: in bf16 above 256 a bound may round up, and a coordinate
    there then reads the edge pixel. A sample in [-1, 0) keeps its in-frame
    tap (the `y0f == -1` slot rule).
    """
    b, c, h, w = img.shape
    x, y = coords[..., 0].reshape(b, -1), coords[..., 1].reshape(b, -1)
    flat = img.reshape(b, c, h * w)
    q = x.shape[1]

    def taps(u, n):
        """Per axis: [(index, weight in u's dtype)] of the taps u0 and u0 + 1."""
        u0f = torch.floor(u)
        wu = u - u0f
        last, second_last = (float(torch.tensor(v, dtype=u.dtype)) for v in (n - 1, n - 2))
        u0 = u0f.to(torch.int64)
        first = (1 - wu) * ((u0f >= 0) & (u0f <= last)).to(u.dtype)
        second = wu * ((u0f >= -1) & (u0f <= second_last)).to(u.dtype)
        return [(u0.clamp(0, n - 1), first), ((u0 + 1).clamp(0, n - 1), second)]

    out = None
    for yi, ay in taps(y, h):
        for xi, ax in taps(x, w):
            idx = (yi * w + xi)[:, None].expand(b, c, q)
            contrib = torch.gather(flat, 2, idx) * (ay * ax).to(img.dtype)[:, None]
            out = contrib if out is None else out + contrib
    return out.reshape(b, c, *coords.shape[1:-1])


def disp_warp(right: torch.Tensor, disp: torch.Tensor, padding: str = "zeros",
              torch_unaligned: bool = False):
    """Warp the right view to the left camera: right [B,C,H,W] sampled at
    (x − disp, y), disp [B,H,W] → (warped [B,C,H,W] in right's dtype, valid
    [B,1,H,W]: 1 where the source x lies in [0, W−1]).

    `padding` "zeros" zeroes the warped values where the source lies outside
    the frame (FADNet's convention); "border" clamps the source to the frame
    before sampling (grid_sample's padding_mode="border", MonSter's). With
    `torch_unaligned` the source is (x − d)·W/(W−1) − 0.5 and y·H/(H−1) −
    0.5: the reference normalises its grid by W−1 but samples it with
    align_corners=False, a shear of up to half a pixel toward the right
    and bottom edges. The coordinates are formed in disp's dtype, as the JAX
    counterpart forms them (`sampler.py:185-218`, which takes and returns
    NHWC).
    """
    if padding not in ("zeros", "border"):
        raise ValueError(f"unknown padding {padding!r}")
    b, _, h, w = right.shape
    xs = torch.arange(w, dtype=disp.dtype, device=disp.device)
    ys = torch.arange(h, dtype=disp.dtype, device=disp.device)[:, None]
    x_src = xs - disp
    y_src = ys + torch.zeros_like(disp)
    if torch_unaligned:
        x_src = x_src * (w / max(w - 1, 1)) - 0.5
        y_src = y_src * (h / max(h - 1, 1)) - 0.5
    valid = ((x_src >= 0) & (x_src <= w - 1)).to(right.dtype)[:, None]
    if padding == "border":
        x_src, y_src = x_src.clamp(0.0, w - 1), y_src.clamp(0.0, h - 1)
    warped = bilinear_sampler(right, torch.stack([x_src, y_src], dim=-1))
    if padding == "zeros":
        warped = warped * valid
    return warped, valid
