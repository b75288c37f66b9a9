#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (`openstereo_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero, printing no result, without one (or
without the repository around it). Phases, each of which fails the run:

1. the card: `nvidia-smi` name and power limit, torch and CUDA versions;
2. build every CUDA kernel of the main path from `openstereo_tpu_torch/csrc`
   (one nvcc per source, in parallel), and print ptxas's registers, spills
   and shared memory for the tensor-core kernels of K4 and K2 and for the
   cost-volume kernel of K1 and K3;
3. K1 (corr_volume) against its plain version at the main-path shape and at
   CoEx's (C 48), f32 (TF32 off) and bf16, plus a ragged-width and a d >= W
   case. The bf16 plain version takes the same bf16 inputs and rounds each
   product to bf16, as JAX does; the kernel must be within `bf16_close`
   everywhere and bit-equal at all but VOLUME_FLIP_SHARE of the elements
   (`volume_bf16_check`), and at the main-path and CoEx shapes the unrounded
   control (products in f32) must fail that check;
4. K2 (fused_mbconv) against its plain version at the 14 distinct shapes of
   the LightStereo-S, CoEx, MSNet3D and MSNet2D paths, f32 (TF32 off) and
   bf16, with and without the residual where
   Cin == Cout, with the launcher's split count at each shape, and in bf16
   at forced hidden-channel split counts through the launcher itself;
5. K4 (rel_attention) against its plain version at the 3 STTR main-path
   shapes and at edge cases (W ragged against the row tile, W = 416, W = 1,
   masked with raw at a small W, W = 640 without raw, raw at its W limit,
   every supported head width), f32 (TF32 off) and bf16, and that W = 2048
   with raw is refused. The bf16 plain versions of K2 and K4 take the same
   bf16 inputs and round h, d and p to bf16 where the TPU kernels do
   (`bf16_close_flips` says how the two may differ); at the main-path
   shapes, controls that round in the wrong place (K2: h or d left in f32;
   K4: p left in f32, or exp(s - m) rounded before the division by l) must
   fail the same check;
6. the LightStereo path: LightStereo-S at 544x960, b1, bf16, random weights
   from a seed, through the port's infer entry (`tools/infer.py:run_pair`)
   on a few synthetic pairs (a random image and the same image rolled by
   12 px), with the launch counts, and the shapes the kernels were launched
   at, read around it and held against the expected ones, and the kernel
   path held against the eager path in f32 and bf16;
7. the STTR path: STTR at 540x960 (`cfgs/sttr/sttr_flyingthings3d.yaml`),
   b1, bf16, the same way, with 18 K4 launches per frame at 3 shapes; the
   kernel path against the eager path in f32 (last-layer raw attention and
   disparity) and bf16 (share of pixels within 3 px);
8. timing with CUDA events: frames/s eager vs kernels of both models (the
   `bench.py` protocol), and per kernel at each shape its path launched it
   at its time, its plain version's, a yardstick and its bound, summed per
   frame with the launch counts recorded in phases 6 and 7 (K1 also its
   device time per launch from torch.profiler beside its bound); and a
   torch.profiler pass over STTR frames of both paths (tables under
   `chiprun_out/sttr_profile/`).
9. K3 (gwc_volume) against its plain version at the GwcNet main-path shape
   and at edge cases (the JAX test's shape, W ragged against the 8-column
   chunks, D over six disparity chunks, d >= W, cg = 1, cg = 12), f32 (TF32
   off) and bf16 (checked as K1's, with the unrounded control at the main
   shape), and with G = 1 against K1;
10. the GwcNet path: GwcNet at 544x960 (`cfgs/gwcnet/gwcnet_sceneflow.yaml`),
   b1, bf16, through `run_pair` on the synthetic pairs, with 1 K3 launch
   per frame at the main shape and no other kernel; the kernel path against
   the eager path in f32 (max-abs) and bf16 (mean-abs);
11. the PSMNet path: PSMNet at 544x960 (`cfgs/psmnet/psmnet_sceneflow.yaml`),
   b1, bf16, through `run_pair`; no kernel of the port lies on it, and the
   phase checks that none launched;
12. timing: GwcNet frames/s eager vs kernels, PSMNet frames/s, K3 at the
   main shape beside its plain version and its bound (CUDA events and its
   device time per launch from torch.profiler), and torch.profiler
   passes over GwcNet frames of both paths and over PSMNet frames (tables
   in `gwcnet_profile/` and `psmnet_profile/` beside STTR's).

13. K1 and K2 at the trainer's evaluation batch (12 pairs at 544x960: K1
   [12,24,136,240] and K2 at batch 24 in the trunk and 12 in the
   aggregation), f32 (TF32 off) and bf16, with the checks of phases 3 and 4
   and the launcher's split count printed for each shape;
14. training: a synthetic SceneFlow-layout set (96 + 12 random-dot pairs at
   540x960, PNG and PFM, under `chiprun_out/train_smoke/`), and the port's
   training entry point (`openstereo_tpu_torch/tools/train.py`) on
   `cfgs/lightstereo/lightstereo_s_sceneflow.yaml` pointed at it, with
   NUM_EPOCHS cut to 1 (4 steps of 24 at 320x736, bf16, AdamW, OneCycleLR,
   clip by value). Finite losses; its evaluation launches K1 once and K2 18
   times per batch of 12 and nothing else is launched in the run; its EPE
   within 0.5 px of an eager evaluation of the same weights; a resumed
   Trainer starts at epoch 1, bit-equal to the checkpoint. Prints ms per
   step (CUDA events, median of steps 2-4), samples/s, peak memory;
15. the learning check: the port's `tools/overfit_check.py`, LightStereo,
   400 steps on one batch of 4 random-dot pairs at 192x384, max_disp 64,
   bf16, AdamW 4e-4, clip 0.1: the final train EPE must be below 3 px.
16-18. (run after phase 12) the CoEx, MSNet3D and MSNet2D paths, each at
   544x960 (`cfgs/coex/coex_sceneflow_amp.yaml`, `cfgs/msnet/msnet3d_sceneflow.yaml`,
   `cfgs/msnet/msnet2d_sceneflow.yaml`), b1, bf16, random weights from a
   seed, through `run_pair` on the synthetic pairs: the launch records per
   frame by shape (CoEx K1 1 at C 48 and K2 11; MSNet3D K3 1 and K2 2;
   MSNet2D K2 18; no other kernel), peak memory, the kernel path against
   the eager path in f32 with TF32 off (MSNets max-abs <= 5e-3 px; CoEx,
   whose top-k may flip on a near-tie, >= 99.9 % of pixels within 5e-3 px)
   and bf16 (MSNets mean-abs <= 0.5 px; CoEx the cost feeding its top-2
   head within 2^-7 of its largest magnitude on average, and the kernel
   path's disparity no more than 5 % further from the f32 one than the
   eager path's); frames/s of both paths (8 groups each, with their spread
   and the host's time to issue a frame), a torch.profiler pass over each
   (tables in `chiprun_out/<model>_profile/`), and each kernel at the
   path's shapes beside its plain version and bound.

The line before the card line is a JSON object with one entry per kernel;
the last line is {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

H, W = 544, 960
N_PAIRS = 3
ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"  # git-ignored: profiler tables
CFG_FILE = ROOT / "cfgs/lightstereo/lightstereo_s_sceneflow.yaml"
STTR_CFG = ROOT / "cfgs/sttr/sttr_flyingthings3d.yaml"
STTR_HW = (540, 960)
GWC_CFG = ROOT / "cfgs/gwcnet/gwcnet_sceneflow.yaml"
PSM_CFG = ROOT / "cfgs/psmnet/psmnet_sceneflow.yaml"
COEX_CFG = ROOT / "cfgs/coex/coex_sceneflow_amp.yaml"
MSNET3D_CFG = ROOT / "cfgs/msnet/msnet3d_sceneflow.yaml"
MSNET2D_CFG = ROOT / "cfgs/msnet/msnet2d_sceneflow.yaml"

# expected K2 launches per LightStereo-S frame: (batch, H, W, Cin, Ch, Cout, residual) → count
K2_SHAPES = {
    (2, 136, 240, 24, 144, 24, True): 1,
    (2, 68, 120, 32, 192, 32, True): 2,
    (2, 34, 60, 64, 384, 64, True): 3,
    (2, 34, 60, 64, 384, 96, False): 1,
    (2, 34, 60, 96, 576, 96, True): 2,
    (2, 17, 30, 160, 960, 160, True): 2,
    (1, 136, 240, 48, 192, 48, True): 2,
    (1, 68, 120, 96, 384, 96, True): 2,
    (1, 34, 60, 192, 768, 192, True): 3,
}
# expected K2 launches per frame of the CoEx, MSNet3D and MSNet2D paths at 544x960: CoEx's
# trunk is LightStereo-S's (batch 2, 11 launches); MSNet's trunk stem (2 launches) and,
# in MSNet2D, the 2D volume's blocks (dres 4, the hourglasses' conv2 and redir2 6,
# conv4 3, redir1 3)
COEX_K2_SHAPES = {k: n for k, n in K2_SHAPES.items() if k[0] == 2}
MSNET3D_K2_SHAPES = {(2, 272, 480, 32, 96, 32, True): 2}
MSNET2D_K2_SHAPES = {
    (2, 272, 480, 32, 96, 32, True): 2,
    (1, 136, 240, 48, 144, 48, True): 4,
    (1, 68, 120, 96, 192, 96, True): 6,
    (1, 34, 60, 192, 384, 192, True): 3,
    (1, 136, 240, 48, 96, 48, True): 3,
}
K2_ALL_SHAPES = sorted(set(K2_SHAPES) | set(COEX_K2_SHAPES) | set(MSNET3D_K2_SHAPES)
                       | set(MSNET2D_K2_SHAPES), reverse=True)
# the launcher's hidden-channel split count at each main-path shape (B, H, W, Ch) on a
# card with 132 SMs (H100 SXM); tests/test_torch_kernel_plans.py walks the same rule
K2_SPLITS_132 = {(2, 136, 240, 144): 1, (2, 68, 120, 192): 2, (2, 34, 60, 384): 6,
                 (2, 34, 60, 576): 6, (2, 17, 30, 960): 15, (1, 136, 240, 192): 2,
                 (1, 68, 120, 384): 4, (1, 34, 60, 768): 12,
                 # MSNet3D and MSNet2D
                 (2, 272, 480, 96): 1, (1, 136, 240, 144): 2, (1, 68, 120, 192): 3,
                 (1, 34, 60, 384): 12, (1, 136, 240, 96): 2}
K1_SHAPE = (1, 24, 136, 240, 48)  # B, C, H/4, W/4, D
COEX_K1_SHAPE = (1, 48, 136, 240, 48)  # CoEx's cosine volume: 48 descriptor channels
# K2 at forced split counts, through the launcher itself: (shape as K2_SHAPES,
# residual, splits)
K2_SPLIT_CASES = [
    ((1, 9, 21, 24, 80, 24, True), True, (1, 2, 3)),
    ((2, 17, 30, 160, 960, 160, True), True, (1, 30)),
]

# expected K4 launches per STTR frame: (lines, W', E, nheads, masked, need_raw) → count.
# 6 self layers on left+right (2·180 lines), 12 cross calls on 180 lines, the
# last of them masked and with the raw attention
K4_SHAPES = {
    (360, 320, 128, 8, False, False): 6,
    (180, 320, 128, 8, False, False): 11,
    (180, 320, 128, 8, True, True): 1,
}
# K4 edge cases: (B, W, E, nheads, masked, need_raw, what)
K4_EDGES = [
    (4, 37, 64, 2, True, True, "W ragged against the 32-row tile, hd 32"),
    (2, 416, 128, 2, False, True, "W of a 1248-wide frame, hd 64"),
    (3, 1, 32, 4, True, True, "W = 1, hd 8"),
    (2, 50, 128, 8, True, True, "masked with raw, small W"),
    (2, 640, 128, 8, False, False, "W of a 1920-wide frame, no raw"),
    (1, 448, 128, 2, True, True, "masked with raw at the bf16 raw tile's limit, hd 64"),
]

K3_SHAPE = (1, 320, 136, 240, 48, 40)  # B, C, H/4, W/4, D, G of GwcNet at 544x960
# K3 edge cases: ((B, C, H, W, D, G), what)
K3_EDGES = [
    ((1, 16, 4, 260, 12, 4), "the JAX test's shape"),
    ((1, 32, 3, 37, 12, 4), "W ragged against the 8-column chunks"),
    ((2, 64, 3, 130, 100, 8), "D = 100, 13 disparity chunks"),
    ((1, 8, 2, 6, 10, 2), "d >= W"),
    ((1, 16, 3, 50, 20, 16), "cg = 1"),
    ((1, 96, 5, 70, 24, 8), "cg = 12 (C 96, G 8)"),
]

# The trainer's evaluation batch (EVALUATOR.BATCH_SIZE_PER_GPU of the LightStereo-S config):
# K1 at [12, 24, 136, 240] and K2 at batch 24 in the siamese trunk, 12 in the aggregation
EVAL_BATCH = 12
K1_EVAL_SHAPE = (EVAL_BATCH,) + K1_SHAPE[1:]
K2_EVAL_SHAPES = {(s[0] * EVAL_BATCH,) + s[1:]: n for s, n in K2_SHAPES.items()}
# the training phase: a synthetic SceneFlow-layout set written by this script
TRAIN_PAIRS, EVAL_PAIRS, PAIR_HW = 96, 12, (540, 960)
TRAIN_DIR = OUT_DIR / "train_smoke"
OVERFIT_ARGS = ["--steps", "400", "--batch", "4", "--size", "192", "384", "--max_disp", "64",
                "--lr", "4e-4", "--device", "cuda"]

# The bf16 K2 and K4 checks (`bf16_close_flips`): the share of output elements that
# may miss `bf16_close`, each within its flip allowance. Set between what a correct
# kernel reads at the main-path shapes and what the misrounded controls read there
# (PERF.md, agreement): K2 at most 5.1e-5 against >= 3.9e-2, K4 at most 2.7e-7
# against >= 3.6e-6.
K2_FLIP_SHARE, K4_FLIP_SHARE = 1e-4, 1e-6
# The bf16 K1 and K3 checks (`volume_bf16_check`): the share of elements that may
# differ from the plain version's bits (two f32 sum orders of the bf16 products may
# round the mean to two neighbours); every element stays within `bf16_close`
VOLUME_FLIP_SHARE = 1e-4

# dense peaks: (memory bytes/s, bf16 tensor flop/s), NVIDIA data sheets
CARDS = {"H100 PCIe": (2.0e12, 756e12), "H100 NVL": (3.9e12, 835e12), "H100": (3.35e12, 989e12)}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def peaks(name):
    for key, val in CARDS.items():  # most specific names first
        if key in name:
            return val
    raise SmokeFailure(f"no peak rates known for card {name!r}")


def time_ms(fn, iters=50, warmup=5):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bf16_close(got, ref, rtol=8e-3, atol=1e-3):
    """|got - ref| <= rtol·|ref| + atol: one bf16 rounding of an f32 result."""
    return bool(((got.float() - ref).abs() <= rtol * ref.abs() + atol).all())


def bf16_close_flips(got, ref, allowance, share, what):
    """`bf16_close` for all but at most `share` of the elements (at least one),
    which may miss it by no more than `allowance`: where the plain version and
    the kernel each round an intermediate to bf16 (as the TPU kernel does),
    sums taken in two f32 orders may round one of them to two neighbours.
    Returns (elements beyond `bf16_close`, elements beyond it and the allowance)."""
    err = (got.float() - ref.float()).abs()
    tol = 8e-3 * ref.float().abs() + 1e-3
    beyond = int((err > tol).sum())
    over = err - tol - allowance
    n_over = int((over > 0).sum())
    check(n_over == 0, f"{what}: max-abs {err.max().item()} beyond 8e-3·|ref| + 1e-3 and the "
                       f"flip allowance at {n_over} elements (by up to {over.max().item()})")
    check(beyond <= max(1, share * err.numel()),
          f"{what}: {beyond} of {err.numel()} elements beyond 8e-3·|ref| + 1e-3 (share cap "
          f"{share})")
    return beyond, n_over


def rejected(got, ref, allowance, share):
    """For a control that rounds in the wrong place: whether `bf16_close_flips`
    rejects it, with (elements beyond `bf16_close`, beyond it and the allowance)."""
    try:
        bf16_close_flips(got, ref, allowance, share, "control")
    except SmokeFailure:
        pass
    else:
        return False, None
    err = (got.float() - ref.float()).abs()
    tol = 8e-3 * ref.float().abs() + 1e-3
    return True, (int((err > tol).sum()), int((err > tol + allowance).sum()))


def volume_bf16_check(got, ref, what):
    """bf16 K1/K3 against the plain version on the same bf16 inputs (which
    rounds each product to bf16, as JAX does): `bf16_close` at every element,
    and bit-equal at all but VOLUME_FLIP_SHARE of them. Returns (max-abs, share
    of elements not bit-equal)."""
    err = (got.float() - ref.float()).abs().max().item()
    check(bf16_close(got, ref.float()), f"{what}: max-abs {err} beyond 8e-3·|ref| + 1e-3")
    share = (got != ref).float().mean().item()
    check(share <= VOLUME_FLIP_SHARE,
          f"{what}: {share:.3g} of the elements not bit-equal (cap {VOLUME_FLIP_SHARE})")
    return err, share


def volume_rejected(bad, ref):
    """For the unrounded control: whether `volume_bf16_check` rejects it, and
    its share of elements that are not bit-equal."""
    try:
        volume_bf16_check(bad, ref, "control")
    except SmokeFailure:
        return True, (bad != ref).float().mean().item()
    return False, (bad != ref).float().mean().item()


def device_ms(fn, key="cv_kernel", iters=20):
    """Device time per launch of the kernels whose name holds `key`, from
    torch.profiler over `iters` back-to-back calls of `fn` (the launch overhead
    that CUDA events over back-to-back launches also count is left out),
    averaged over the launches the trace recorded. The profiler records a
    warm-up step of `iters` calls first and reads only the step after it:
    the trace may miss launches at its start (one run saw 9 of 20 without
    the warm-up step); a trace that still sees fewer than half is taken
    again, up to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and key in e.key]
        n = sum(e.count for e in rows)  # the trace may miss a launch at its edge
        if iters // 2 <= n <= iters:
            break
        print(f"[time] profiler saw {n} launches of {key!r} in {iters} calls; tracing again")
    check(iters // 2 <= n <= iters, f"profiler saw {n} launches of {key!r} in {iters} calls")
    return sum(e.self_device_time_total for e in rows) / 1e3 / n


def bf16_flip(u, err):
    """Where an f32 value u >= 0, rounded to bf16, lies within `err` of the
    midpoint between its rounding r and r's neighbour on u's side: the
    distance to that neighbour (another sum order may round u there), else 0."""
    import torch

    r = u.bfloat16()
    step = torch.sign(u - r.float()).to(torch.int16)
    other = (r.view(torch.int16) + step).view(torch.bfloat16).float()
    amb = (step != 0) & ((u - (r.float() + other) / 2).abs() <= err)
    return torch.where(amb, (other - r.float()).abs(), torch.zeros_like(u))


def k2_flip_allowance(x, args):
    """Per output element of K2's bf16 plain version: the most that rounding
    h or d to bf16 the other way can move it, where their f32 pre-rounding
    value lies within the error bound of two f32 sum orders ((n + 2)·2^-23
    of the sum of |terms| over n terms) of a rounding midpoint; 0 elsewhere.
    Relu6 is 1-Lipschitz, so the bound propagates linearly."""
    import torch
    import torch.nn.functional as F

    w1, b1, dw, b2, w2, _ = (a.float() for a in args)
    xf, ch, eps = x.float(), w1.shape[1], 2.0 ** -23
    pre = torch.einsum("bchw,cd->bdhw", xf, w1) + b1[:, None, None]
    mag = torch.einsum("bchw,cd->bdhw", xf.abs(), w1.abs()) + b1.abs()[:, None, None]
    u_h = pre.clamp(0.0, 6.0)
    flip_h = bf16_flip(u_h, (xf.shape[1] + 2) * eps * mag)
    h = u_h.bfloat16().float()
    k = dw.t().reshape(ch, 1, 3, 3)
    pre_d = F.conv2d(h, k, b2, padding=1, groups=ch)
    mag_d = F.conv2d(h.abs(), k.abs(), b2.abs(), padding=1, groups=ch)
    shift = F.conv2d(flip_h, k.abs(), padding=1, groups=ch)  # what h's flips move pre_d by
    flip_d = bf16_flip(pre_d.clamp(0.0, 6.0), 11 * eps * mag_d + shift)
    return torch.einsum("bchw,cd->bdhw", flip_d + shift, w2.abs())


def k4_flip_allowance(args, nh, masked):
    """Per output element of K4's bf16 plain version: the most that rounding
    p to bf16 the other way can move it, where p's f32 value lies within the
    error bound of two implementations of its f32 arithmetic of a rounding
    midpoint: each score within (hd + 2)·2^-23 of its sum of |terms|, the row
    max and sum within the row's worst score error, exp and the W-term sum
    within (W + 16)·2^-23; 0 elsewhere."""
    import torch

    from openstereo_tpu_torch.ops.rel_attention import rel_index

    q, k, v, ke, qe = (a.float() for a in args)
    b, w, e = q.shape
    hd, eps = e // nh, 2.0 ** -23
    idx = rel_index(w, q.device)
    qh, kh, vh = (t.reshape(b, w, nh, hd) for t in (q, k, v))
    k_r, q_r = (t[idx].reshape(w, w, nh, hd) for t in (ke, qe))
    s = (torch.einsum("bihc,bjhc->bhij", qh, kh) + torch.einsum("bihc,ijhc->bhij", qh, k_r)
         + torch.einsum("bjhc,ijhc->bhij", kh, q_r))
    ds = (torch.einsum("bihc,bjhc->bhij", qh.abs(), kh.abs())
          + torch.einsum("bihc,ijhc->bhij", qh.abs(), k_r.abs())
          + torch.einsum("bjhc,ijhc->bhij", kh.abs(), q_r.abs())) * ((hd + 2) * eps)
    if masked:
        above = torch.triu(torch.ones(w, w, dtype=torch.bool, device=q.device), 1)
        s, ds = s.masked_fill(above, -1e30), ds.masked_fill(above, 0.0)
    p = torch.softmax(s, dim=-1)
    dm = ds.amax(dim=-1, keepdim=True)
    rel = ds + 2 * dm + (p * ds).sum(dim=-1, keepdim=True) + (w + 16) * eps
    flip = bf16_flip(p, p * rel)
    return torch.einsum("bhij,bjhc->bihc", flip, vh.abs()).reshape(b, w, e)


def k2_misrounded(x, args, residual, round_h, round_d):
    """A control for the K2 check: the plain version's arithmetic with h or d
    left in f32 where the TPU kernel rounds it to bf16."""
    import torch
    import torch.nn.functional as F

    w1, b1, dw, b2, w2, b3 = (a.float() for a in args)
    xf, ch = x.float(), w1.shape[1]
    h = (torch.einsum("bchw,cd->bdhw", xf, w1) + b1[:, None, None]).clamp(0.0, 6.0)
    h = h.bfloat16().float() if round_h else h
    d = F.conv2d(h, dw.t().reshape(ch, 1, 3, 3), b2, padding=1, groups=ch).clamp(0.0, 6.0)
    d = d.bfloat16().float() if round_d else d
    y = torch.einsum("bchw,cd->bdhw", d, w2) + b3[:, None, None]
    return (y + xf if residual else y).to(x.dtype)


def k4_misrounded(args, nh, masked, mode):
    """A control for the K4 check: the plain version's arithmetic with p left
    in f32 (mode "p f32"), or with exp(s - m) rounded to bf16 before the
    division by the row sum l (mode "exp before /l", as a flash-attention
    style kernel rounds), where the TPU kernel rounds p = exp(s - m) / l."""
    import torch

    from openstereo_tpu_torch.ops.rel_attention import rel_index

    q, k, v, ke, qe = (a.float() for a in args)
    b, w, e = q.shape
    hd = e // nh
    idx = rel_index(w, q.device)
    qh, kh, vh = (t.reshape(b, w, nh, hd) for t in (q, k, v))
    k_r, q_r = (t[idx].reshape(w, w, nh, hd) for t in (ke, qe))
    s = (torch.einsum("bihc,bjhc->bhij", qh, kh) + torch.einsum("bihc,ijhc->bhij", qh, k_r)
         + torch.einsum("bjhc,ijhc->bhij", kh, q_r))
    if masked:
        s = s.masked_fill(torch.triu(torch.ones(w, w, dtype=torch.bool, device=q.device), 1),
                          -1e30)
    if mode == "p f32":
        out = torch.einsum("bhij,bjhc->bihc", torch.softmax(s, dim=-1), vh)
    else:
        ex = torch.exp(s - s.amax(dim=-1, keepdim=True))
        out = (torch.einsum("bhij,bjhc->bihc", ex.bfloat16().float(), vh)
               / ex.sum(dim=-1).transpose(1, 2)[..., None])
    return out.reshape(b, w, e).to(args[2].dtype)


def phase_card():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), using {name}")
    return smi, name


def phase_build():
    from openstereo_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    paths = build.build_all()
    print(f"[build] {len(paths)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        print(f"[build]   {name}: {path}")
    # ptxas's figures for the tensor-core kernels (namespace tc) of K4 and K2
    # and for the cost-volume kernel of K1 and K3
    ptxas = {}
    for name, key in (("rel_attention", "2tc"), ("fused_mbconv", "2tc"),
                      ("cost_volume", "cv_kernel")):
        ptxas[name] = [e for e in build.ptxas_info(name) if key in e["entry"]]
        check(ptxas[name], f"no ptxas figures for {name}'s kernels ({key})")
        for e in ptxas[name]:
            print(f"[ptxas] {name} {e['entry'][max(0, e['entry'].find(key)):][:48]}: "
                  f"{e['registers']} registers, spill "
                  f"stores {e['spill_stores']} B, spill loads {e['spill_loads']} B, static "
                  f"shared memory {e['smem']} B")
    return ptxas


def phase_k1(dev):
    import torch

    from openstereo_tpu_torch import ops

    g = torch.Generator().manual_seed(1)
    errs = {}
    for (b, c, h, w, d), tag in ((K1_SHAPE, "main"), (COEX_K1_SHAPE, "CoEx"),
                                 ((1, 8, 3, 37, 48), "ragged W"),
                                 ((2, 24, 5, 130, 100), "ragged W, D>64"),
                                 ((1, 4, 2, 6, 10), "d >= W")):
        left, right = (torch.randn(b, c, h, w, generator=g).to(dev) for _ in range(2))
        ref = ops.correlation_volume(left, right, d)
        got = ops.corr_volume(left, right, d)
        err32 = (got - ref).abs().max().item()
        check(err32 <= 1e-5, f"K1 f32 {tag} {(b, c, h, w, d)}: max-abs {err32} > 1e-5")
        lb, rb = left.bfloat16(), right.bfloat16()
        ref16 = ops.correlation_volume(lb, rb, d)
        got16 = ops.corr_volume(lb, rb, d)
        err16, share = volume_bf16_check(got16, ref16, f"K1 bf16 {tag}")
        control = ""
        if tag in ("main", "CoEx"):  # the unrounded control: products in f32
            no, c_share = volume_rejected(
                ops.correlation_volume(lb.float(), rb.float(), d).bfloat16(), ref16)
            check(no, f"K1 bf16 {tag}: the unrounded control passes the check")
            control = f"; unrounded control rejected ({c_share:.3g} not bit-equal)"
        if w < d:
            check(not got16[:, w:].any(), "K1: planes with d >= W are not zero")
        print(f"[K1] {tag} {(b, c, h, w, d)}: f32 max-abs {err32:.3g} (tol 1e-5), "
              f"bf16 max-abs {err16:.3g} (tol 8e-3·|ref| + 1e-3), {share:.3g} not bit-equal "
              f"(cap {VOLUME_FLIP_SHARE}){control}")
        errs[tag] = (err32, err16, share)
    return errs


def k2_inputs(shape, dev, dtype, g):
    import torch

    b, h, w, cin, ch, cout, _ = shape
    # scaled so that both relu6 clamps (at 0 and at 6) are active
    x = torch.randn(b, cin, h, w, generator=g) * 3.0
    ws = [torch.randn(cin, ch, generator=g) * cin ** -0.5, torch.randn(ch, generator=g) * 0.5,
          torch.randn(9, ch, generator=g) * 0.6, torch.randn(ch, generator=g) * 0.1,
          torch.randn(ch, cout, generator=g) * ch ** -0.5, torch.randn(cout, generator=g) * 0.1]
    args = [t.to(dev, dtype) if i % 2 == 0 else t.to(dev) for i, t in enumerate(ws)]
    return x.to(dev, dtype), args


def phase_k2(dev):
    import torch

    from openstereo_tpu_torch import ops
    from openstereo_tpu_torch.ops.kernels import build

    g = torch.Generator().manual_seed(2)
    lib = build.load("fused_mbconv")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst32 = worst16 = 0.0
    controls, by_shape = {}, {}
    for shape in K2_ALL_SHAPES:
        b, h, w, cin, ch, cout = shape[:6]
        splits = lib.fused_mbconv_splits(b, h, w, ch, 1)
        chunks = -(-ch // 32)
        check(splits >= 1 and (splits - 1) * -(-chunks // splits) < chunks,
              f"K2 {shape[:6]}: the launcher picks {splits} splits of {chunks} chunks")
        if sms == 132:
            check(splits == K2_SPLITS_132[(b, h, w, ch)],
                  f"K2 {shape[:6]}: the launcher picks S = {splits}, the plan says "
                  f"{K2_SPLITS_132[(b, h, w, ch)]}")
        x, args = k2_inputs(shape, dev, torch.float32, g)
        x16, args16 = x.bfloat16(), [a.bfloat16() if i % 2 == 0 else a for i, a in enumerate(args)]
        for res in ((True, False) if cin == cout else (False,)):
            ref = ops.mbconv_plain(x, *args, residual=res)
            got = ops.fused_mbconv(x, *args, residual=res)
            err32 = (got - ref).abs().max().item()
            check(torch.allclose(got, ref, rtol=1e-4, atol=1e-4),
                  f"K2 f32 {shape[:6]} residual={res}: max-abs {err32} beyond rtol 1e-4, atol 1e-4")
            ref16 = ops.mbconv_plain(x16, *args16, residual=res)
            allowance = k2_flip_allowance(x16, args16)
            got16 = ops.fused_mbconv(x16, *args16, residual=res)
            err16, beyond = k2_bf16_error(got16, ref16, allowance, f"{shape[:6]} residual={res}")
            # the controls: h or d left in f32 must not pass the same check
            for name, rh, rd in (("h f32", False, True), ("d f32", True, False)):
                bad = k2_misrounded(x16, args16, res, rh, rd)
                no, counts = rejected(bad, ref16, allowance, K2_FLIP_SHARE)
                check(no, f"K2 bf16 {shape[:6]} residual={res}: the control with {name} "
                          f"passes the check")
                controls[(shape[:6], res, name)] = counts
            print(f"[K2] {shape[:6]} residual={res}, S={splits}: f32 max-abs {err32:.3g} "
                  f"(tol 1e-4 + 1e-4·|ref|), bf16 max-abs {err16:.3g} (tol 8e-3·|ref| + 1e-3; "
                  f"{beyond} of {got16.numel()} beyond it, within the flip allowance); "
                  f"controls rejected, beyond / over the allowance: h f32 "
                  f"{controls[(shape[:6], res, 'h f32')]}, d f32 "
                  f"{controls[(shape[:6], res, 'd f32')]}")
            worst32, worst16 = max(worst32, err32), max(worst16, err16)
            e32, e16 = by_shape.get(shape, (0.0, 0.0))
            by_shape[shape] = (max(e32, err32), max(e16, err16))
    # the bf16 kernel at split counts other than the launcher's, through the launcher:
    # every S of a ragged 3-chunk case (Cin 24 padded), and the 30-chunk 17x30 shape
    # unsplit and one chunk per block
    for shape, res, splits in K2_SPLIT_CASES:
        x, args = k2_inputs(shape, dev, torch.bfloat16, g)
        ref = ops.mbconv_plain(x, *args, residual=res)
        allowance = k2_flip_allowance(x, args)
        for sp in splits:
            got = k2_launch_forced(lib, x, args, res, sp)
            err16, beyond = k2_bf16_error(got, ref, allowance, f"{shape[:6]} residual={res} S={sp}")
            print(f"[K2] {shape[:6]} residual={res}, S={sp} (forced): bf16 max-abs {err16:.3g} "
                  f"(tol 8e-3·|ref| + 1e-3; {beyond} beyond it, within the flip allowance)")
            worst16 = max(worst16, err16)
    return worst32, worst16, controls, by_shape


def k2_launch_forced(lib, x, args, residual, splits):
    """The bf16 K2 launcher called at a split count of our choosing (the wrapper
    takes the launcher's own); not counted as a launch of the main path."""
    import torch

    from openstereo_tpu_torch.ops import kernels

    b, cin, h, w = x.shape
    ch, cout = args[0].shape[1], args[4].shape[1]
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
    ws = torch.empty((splits, b, cout, h, w), dtype=torch.float32, device=x.device)
    err = lib.fused_mbconv_launch(x.data_ptr(), *(a.data_ptr() for a in args), out.data_ptr(),
                                  ws.data_ptr() if splits > 1 else None, b, cin, ch, cout, h, w,
                                  int(residual), splits, 1, kernels.stream_handle(x.device))
    check(err == 0, f"K2 bf16 launcher at S={splits}: cudaError_t {err}")
    return out


def k2_bf16_error(got, ref, allowance, what):
    """bf16 K2 against its plain version on the same bf16 inputs (which rounds h
    and d to bf16 where the TPU kernel does): (max-abs, elements beyond
    `bf16_close`), raising as `bf16_close_flips` says."""
    beyond, _ = bf16_close_flips(got, ref, allowance, K2_FLIP_SHARE, f"K2 bf16 {what}")
    return (got.float() - ref.float()).abs().max().item(), beyond


def k4_inputs(shape, dev, g):
    """q, k, v [B,W,E] and ke, qe [2W-1,E], f32; q and qe scaled by hd^-1/2
    as the model scales them, so the logits have the model's spread."""
    import torch

    b, w, e, nh = shape[:4]
    scale = (e // nh) ** -0.5
    q, k, v = (torch.randn(b, w, e, generator=g) for _ in range(3))
    ke, qe = (torch.randn(2 * w - 1, e, generator=g) * 0.5 for _ in range(2))
    return [t.to(dev) for t in (q * scale, k, v, ke, qe * scale)]


def k4_errors(args, nh, masked, need_raw, controls=None):
    """K4 against its plain version on the same inputs: (out max-abs, raw
    max-abs on finite entries or None, out elements beyond `bf16_close`),
    raising beyond the tolerances (f32: 1e-4 as
    tests/test_rel_attention.py; bf16: one bf16 rounding of out as
    `bf16_close_flips` says, raw at rtol 1e-3; the bf16 plain version rounds
    p to bf16 before p·v, as the TPU kernel does). With a dict `controls`
    (bf16), the misrounded controls must fail the same check; their counts
    go there."""
    import torch

    from openstereo_tpu_torch import ops

    bf16 = args[0].dtype == torch.bfloat16
    ref, ref_raw = ops.rel_attention_plain(*args, nh, masked, need_raw)
    ref = ref.float()
    got, raw = ops.rel_attention(*args, nh, masked, need_raw)
    err = (got.float() - ref).abs().max().item()
    beyond = 0
    if bf16:
        allowance = k4_flip_allowance(args, nh, masked)
        beyond, _ = bf16_close_flips(got, ref, allowance, K4_FLIP_SHARE, "out")
        for mode in () if controls is None else ("p f32", "exp before /l"):
            no, controls[mode] = rejected(k4_misrounded(args, nh, masked, mode), ref, allowance,
                                          K4_FLIP_SHARE)
            check(no, f"the control with {mode} passes the check")
    else:
        check(bool(((got - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all()),
              f"out max-abs {err} beyond rtol 1e-4, atol 1e-4")
    if not need_raw:
        check(raw is None, "raw returned without need_raw")
        return err, None, beyond
    fin = ref_raw.abs() < 1e20
    check(bool((raw[~fin] < -1e29).all()), "masked raw entries are not ~-1e30 per head")
    rtol, atol = (1e-3, 1e-4) if bf16 else (1e-4, 1e-4)
    rerr = (raw[fin] - ref_raw[fin]).abs()
    check(bool((rerr <= atol + rtol * ref_raw[fin].abs()).all()),
          f"raw max-abs {rerr.max().item()} beyond rtol {rtol}, atol {atol}")
    return err, rerr.max().item(), beyond


def phase_k4(dev):
    import torch

    from openstereo_tpu_torch import ops

    g = torch.Generator().manual_seed(4)
    worst = {"f32": 0.0, "bf16": 0.0}
    controls = {}
    cases = [(*key, "main path") for key in K4_SHAPES] + K4_EDGES
    for b, w, e, nh, masked, need_raw, what in cases:
        args = k4_inputs((b, w, e, nh), dev, g)
        for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            bf16 = dtype == torch.bfloat16
            ctl = {} if bf16 and what == "main path" else None
            try:
                err, rerr, beyond = k4_errors([a.to(dtype) for a in args], nh, masked, need_raw,
                                              ctl)
            except SmokeFailure as exc:
                raise SmokeFailure(f"K4 {tag} {(b, w, e, nh, masked, need_raw)} ({what}): {exc}")
            worst[tag] = max(worst[tag], err)
            if ctl:
                controls[(b, w, e, nh, masked, need_raw)] = ctl
            flips = f" ({beyond} of {b * w * e} beyond bf16_close, within the flip allowance)"
            print(f"[K4] {tag} B={b} W={w} E={e} heads={nh} masked={masked} raw={need_raw} "
                  f"({what}): out max-abs {err:.3g}{flips if bf16 else ''}"
                  f", raw max-abs {'-' if rerr is None else f'{rerr:.3g}'}"
                  f"{f'; controls rejected, beyond / over the allowance: {ctl}' if ctl else ''}")
    # W beyond what the tiles take: the f32 score tile, and the bf16 raw tile
    for dtype in (torch.float32, torch.bfloat16):
        args = [a.to(dtype) for a in k4_inputs((1, 2048, 32, 2), dev, g)]
        try:
            ops.rel_attention(*args, 2, False, True)
        except ValueError:
            pass
        else:
            raise SmokeFailure(f"K4 {dtype} took W = 2048 with raw, beyond its shared memory")
    print("[K4] W = 2048 with raw refused in f32 and bf16 (the tiles exceed shared memory)")
    torch.cuda.synchronize()
    return worst["f32"], worst["bf16"], controls


def synthetic_pairs(size=(H, W)):
    rng = np.random.RandomState(0)
    for _ in range(N_PAIRS):
        left = (rng.rand(*size, 3) * 255).astype(np.uint8).astype(np.float32)
        yield left, np.roll(left, -12, axis=1)


def phase_slice(dev):
    import torch

    from openstereo_tpu_torch.config import load_config
    from openstereo_tpu_torch.data.transforms import build_transforms
    from openstereo_tpu_torch.models import build_model, set_kernels
    from openstereo_tpu_torch.tools.infer import run_pair

    cfg = load_config(str(CFG_FILE))
    tf = build_transforms(cfg.DATA_CONFIG.DATA_TRANSFORM["EVALUATING"])
    pairs = list(synthetic_pairs())
    model = build_model(cfg.MODEL, dtype=torch.bfloat16, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[slice] LightStereo-S ({n_params} parameters), {H}x{W} b1 bf16, {N_PAIRS} pairs")

    run_pair(model, tf, *pairs[0])  # warm-up: kernel build and cuDNN plans
    wired, launches, per_frame = record_path(  # the main path
        {"corr_volume": {K1_SHAPE: 1}, "fused_mbconv": K2_SHAPES},
        lambda: [run_pair(model, tf, *p) for p in pairs])
    print(f"[slice] launches over {N_PAIRS} frames: {launches}; per frame by shape: "
          f"{per_frame}")

    set_kernels(model, False)
    eager = [run_pair(model, tf, *p) for p in pairs]
    mean16 = max(float(np.abs(a - b).mean()) for a, b in zip(wired, eager))
    for d in wired + eager:
        check(d.shape == (H, W) and np.isfinite(d).all(), "bf16 disparity not finite [H,W]")
    check(mean16 <= 0.5, f"bf16 kernel vs eager mean-abs {mean16} px > 0.5")

    model32 = build_model(cfg.MODEL, dtype=torch.float32, device=dev, seed=0)
    errs32 = []
    for p in pairs:
        a = run_pair(set_kernels(model32, True), tf, *p)
        b = run_pair(set_kernels(model32, False), tf, *p)
        errs32.append(float(np.abs(a - b).max()))
    max32 = max(errs32)
    check(max32 <= 5e-3, f"f32 kernel vs eager max-abs {max32} px > 5e-3")
    rng = [float(wired[0].min()), float(wired[0].max())]
    print(f"[slice] f32 kernel vs eager: max-abs {max32:.3g} px (tol 5e-3); "
          f"bf16 kernel vs eager: mean-abs {mean16:.3g} px (tol 0.5); "
          f"bf16 disparity range {rng[0]:.2f}..{rng[1]:.2f}")
    return model, launches, per_frame, max32, mean16


def record_path(want, run):
    """Zero the launch counts, `run()` a path over N_PAIRS frames, and hold the
    record of every kernel against `want` (kernel → shape key → launches per
    frame); a kernel not in `want` must not have launched."""
    import torch

    from openstereo_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    per_frame = {}
    for name, n in launches.items():
        shapes = dict(kernels.launch_shapes[name])
        expected = want.get(name, {})
        check(n == sum(expected.values()) * N_PAIRS,
              f"{name} launches {n} over {N_PAIRS} frames != {sum(expected.values())} per frame")
        check(all(k % N_PAIRS == 0 for k in shapes.values()),
              f"{name} launch shapes {shapes} differ between frames")
        if expected:
            per_frame[name] = {k: c // N_PAIRS for k, c in shapes.items()}
            check(per_frame[name] == expected,
                  f"{name} launch shapes per frame {per_frame[name]} != expected {expected}")
    return out, launches, per_frame


def phase_sttr(dev):
    import torch

    from openstereo_tpu_torch.config import load_config
    from openstereo_tpu_torch.data.transforms import build_transforms
    from openstereo_tpu_torch.models import build_model, set_kernels
    from openstereo_tpu_torch.tools.infer import run_pair

    cfg = load_config(str(STTR_CFG))
    tf = build_transforms(cfg.DATA_CONFIG.DATA_TRANSFORM["EVALUATING"])
    pairs = list(synthetic_pairs(STTR_HW))
    model = build_model(cfg.MODEL, dtype=torch.bfloat16, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[sttr] STTR ({n_params} parameters), {STTR_HW[0]}x{STTR_HW[1]} b1 bf16, "
          f"{N_PAIRS} pairs")
    run_pair(model, tf, *pairs[0])  # warm-up: kernel build and cuDNN plans
    wired, launches, per_frame = record_path(
        {"rel_attention": K4_SHAPES}, lambda: [run_pair(model, tf, *p) for p in pairs])
    print(f"[record] launches over {N_PAIRS} frames: {launches}; per frame by shape: "
          f"{per_frame}")
    launches, per_frame = launches["rel_attention"], per_frame["rel_attention"]

    set_kernels(model, False)
    eager = [run_pair(model, tf, *p) for p in pairs]
    set_kernels(model, True)
    for d in wired + eager:
        check(d.shape == STTR_HW and np.isfinite(d).all(), "bf16 disparity not finite [540,960]")
    diffs = [np.abs(a - b) for a, b in zip(wired, eager)]
    mean16 = max(float(d.mean()) for d in diffs)
    share16 = min(float((d <= 3.0).mean()) for d in diffs)
    print(f"[sttr] bf16 kernel vs eager: mean-abs {mean16:.4g} px, share within 3 px "
          f"{share16:.5f} (worst pair; tol >= 0.9); disparity range "
          f"{wired[0].min():.2f}..{wired[0].max():.2f}")
    check(share16 >= 0.9, f"bf16 kernel vs eager: only {share16:.4f} of pixels within 3 px")

    model32 = build_model(cfg.MODEL, dtype=torch.float32, device=dev, seed=0)
    captured = []
    hook = model32.transformer.register_forward_hook(
        lambda mod, inp, out: captured.append(out.float()))
    raw_err = 0.0
    share32, max32 = 1.0, 0.0
    try:
        for p in pairs:
            outs, raws = {}, {}
            for path in ("kernels", "eager"):
                set_kernels(model32, path == "kernels")
                outs[path] = run_pair(model32, tf, *p)
                raws[path] = captured.pop()
            ref = raws["eager"]
            fin = torch.isfinite(ref)
            err = (raws["kernels"][fin] - ref[fin]).abs().max().item()
            raw_err = max(raw_err, err / ref[fin].abs().max().item())
            check(bool((raws["kernels"][~fin] < -1e29).all()), "masked raw entries are finite")
            d = np.abs(outs["kernels"] - outs["eager"])
            share32, max32 = min(share32, float((d <= 5e-3).mean())), max(max32, float(d.max()))
    finally:
        hook.remove()
    print(f"[sttr] f32 kernel vs eager: last-layer raw attention max-abs {raw_err:.3g}·max|raw| "
          f"(tol 1e-4), disparity max-abs {max32:.4g} px, share within 5e-3 px {share32:.6f} "
          f"(tol >= 0.999)")
    check(raw_err <= 1e-4, f"f32 raw attention max-abs {raw_err}·max|raw| > 1e-4")
    check(share32 >= 0.999, f"f32 kernel vs eager: only {share32} of pixels within 5e-3 px")
    del model32
    torch.cuda.empty_cache()
    return model, launches, per_frame, (raw_err, max32, share32, mean16, share16)


def k1_work(shape, elem):
    b, c, h, w, d = shape
    nbytes = (2 * b * c * h * w + b * d * h * w) * elem
    flops = 2 * b * c * h * sum(max(w - k, 0) for k in range(d))  # products with w - d >= 0
    return nbytes, flops


def k2_work(shape, elem):
    b, h, w, cin, ch, cout, _ = shape
    weights = (cin * ch + 9 * ch + ch * cout) * elem + (2 * ch + cout) * 4
    nbytes = b * h * w * (cin + cout) * elem + weights
    flops = 2 * b * h * w * (cin * ch + 9 * ch + ch * cout)
    return nbytes, flops


def bound(nbytes, flops, card):
    t_bytes, t_ops = nbytes / card[0] * 1e3, flops / card[1] * 1e3  # ms, bf16 peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_timing(dev, per_frame, card, g, tag="K1"):
    """K1 at the one shape a path launched it at (`per_frame`: shape → launches
    per frame), bf16: CUDA events over back-to-back launches, device time per
    launch (torch.profiler), the plain version, the bound; summed per frame."""
    import torch

    from openstereo_tpu_torch import ops

    (shape, count), = per_frame.items()
    b, c, h, w, d = shape
    left, right = (torch.randn(b, c, h, w, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    t_k = time_ms(lambda: ops.corr_volume(left, right, d))
    t_d = device_ms(lambda: ops.corr_volume(left, right, d))
    t_p = time_ms(lambda: ops.correlation_volume(left, right, d), iters=10)
    t_b, by = bound(*k1_work(shape, 2), card)
    print(f"[time] {tag} {shape} x{count} bf16: kernel {t_k:.4f} ms (CUDA events over "
          f"back-to-back launches), device {t_d:.4f} ms per launch (torch.profiler), plain "
          f"{t_p:.4f} ms, bound {t_b:.4f} ms ({by}; {t_b / t_d:.1%} of the device time); no "
          f"single PyTorch call computes it")
    return {"ms": count * t_k, "device_ms": count * t_d, "plain_ms": count * t_p,
            "yardstick_ms": None, "bound_ms": count * t_b, "bound_by": by,
            "bound_share": t_b / t_d, "launches_per_frame": count,
            "shapes": [{"shape": list(shape), "launches_per_frame": count, "ms": t_k,
                        "device_ms": t_d, "plain_ms": t_p, "bound_ms": t_b, "bound_by": by}]}


def k2_timing(dev, per_frame, card, g, tag="K2"):
    """K2 at each shape a path launched it at, bf16: the kernel, its plain
    version, the cuDNN pw→dw→pw chain with folded BN (a yardstick, not one
    call), the bound; summed per frame with the launches of `per_frame`."""
    import torch
    import torch.nn.functional as F

    from openstereo_tpu_torch import ops

    k2 = {"ms": 0.0, "plain_ms": 0.0, "yardstick_ms": 0.0, "bound_ms": 0.0, "shapes": [],
          "launches_per_frame": sum(per_frame.values())}
    t_bytes = t_ops = 0.0
    for shape, count in sorted(per_frame.items(), reverse=True):
        res_ = shape[-1]
        x, args = k2_inputs(shape, dev, torch.bfloat16, g)
        w1, b1, dw, b2, w2, b3 = args
        cin, ch = w1.shape
        w1c, dwc, w2c = (w1.t().reshape(ch, cin, 1, 1).contiguous(),
                         dw.t().reshape(ch, 1, 3, 3).contiguous(),
                         w2.t().reshape(-1, ch, 1, 1).contiguous())
        b1c, b2c, b3c = b1.bfloat16(), b2.bfloat16(), b3.bfloat16()

        def cudnn_chain():
            y = F.conv2d(x, w1c, b1c).clamp_(0, 6)
            y = F.conv2d(y, dwc, b2c, padding=1, groups=ch).clamp_(0, 6)
            y = F.conv2d(y, w2c, b3c)
            return y + x if res_ else y

        t_k = time_ms(lambda: ops.fused_mbconv(x, *args, residual=res_))
        t_p = time_ms(lambda: ops.mbconv_plain(x, *args, residual=res_), iters=10)
        t_y = time_ms(cudnn_chain)
        nbytes, flops = k2_work(shape, 2)
        t_b, by = bound(nbytes, flops, card)
        t_bytes += count * nbytes / card[0] * 1e3
        t_ops += count * flops / card[1] * 1e3
        for key, t in (("ms", t_k), ("plain_ms", t_p), ("yardstick_ms", t_y), ("bound_ms", t_b)):
            k2[key] += count * t
        k2["shapes"].append({"shape": list(shape), "launches_per_frame": count, "ms": t_k,
                             "plain_ms": t_p, "yardstick_ms": t_y, "bound_ms": t_b, "bound_by": by})
        print(f"[time] {tag} {shape} x{count} bf16: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"cuDNN chain {t_y:.4f} ms, bound {t_b:.4f} ms ({by})")
        del x, args
    k2["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[time] {tag} per frame ({k2['launches_per_frame']} launches): kernel "
          f"{k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f} ms, cuDNN chain "
          f"{k2['yardstick_ms']:.4f} ms, bound {k2['bound_ms']:.4f} ms")
    return k2


def phase_timing(dev, model, card, per_frame):
    import torch

    from openstereo_tpu_torch.tools.bench import bench_eager_vs_kernels

    res = bench_eager_vs_kernels(model, groups=8, reps=20)
    for path in ("eager", "kernels"):
        print(f"[time] LightStereo-S {path}: {res[path]['fps']:.2f} frames/s, "
              f"{res[path]['ms_per_frame']:.3f} ms/frame (median of {len(res[path]['group_ms'])} "
              f"groups of 20 chained frames, spread {res[path]['group_spread']:.1%}); host issue "
              f"{res[path]['host_issue_ms']:.3f} ms/frame")
    g = torch.Generator().manual_seed(3)
    k1 = k1_timing(dev, per_frame["corr_volume"], card, g)
    k2 = k2_timing(dev, per_frame["fused_mbconv"], card, g)
    return res, k1, k2


def k4_work(shape, elem):
    """Bytes (q, k, v, out and both tables once, raw f32 when asked), flops
    (8·W²·E per line: three score products and p·v) and exponentials."""
    b, w, e, nh, masked, need_raw = shape
    nbytes = (4 * b * w * e + 2 * (2 * w - 1) * e) * elem + (b * w * w * 4 if need_raw else 0)
    return nbytes, 8 * b * w * w * e, b * nh * w * w


def phase_timing_sttr(dev, model, card, per_frame):
    import torch

    from openstereo_tpu_torch import ops
    from openstereo_tpu_torch.models.sttr.transformer import rel_attention_eager
    from openstereo_tpu_torch.tools.bench import bench_eager_vs_kernels, profile_paths

    res = bench_eager_vs_kernels(model, groups=4, reps=3, size=STTR_HW)
    for path in ("eager", "kernels"):
        print(f"[time] STTR {path}: {res[path]['fps']:.3f} frames/s, "
              f"{res[path]['ms_per_frame']:.3f} ms/frame (median of {len(res[path]['group_ms'])} "
              f"groups of 3 chained frames); host issue {res[path]['host_issue_ms']:.3f} ms/frame")
    prof = profile_paths(model, 2, str(OUT_DIR / "sttr_profile"), size=STTR_HW)
    for path, r in prof.items():
        r["idle_share"] = 1.0 - r["device_busy_ms_per_frame"] / res[path]["ms_per_frame"]
        top = "; ".join(f"{t['kernel'][:60]} {t['ms_per_frame']:.3f} ms x{t['calls_per_frame']:g}"
                        for t in r["top"][:6])
        print(f"[profile] STTR {path}: device busy {r['device_busy_ms_per_frame']:.3f} ms/frame, "
              f"{r['device_ops_per_frame']:g} device operations a frame, idle share "
              f"{r['idle_share']:.4f} (against {res[path]['ms_per_frame']:.3f} ms/frame untraced); "
              f"top: {top}")

    g = torch.Generator().manual_seed(5)
    k4 = {"ms": 0.0, "plain_ms": 0.0, "yardstick_ms": 0.0, "bound_ms": 0.0, "exp_count": 0,
          "shapes": [], "launches_per_frame": sum(per_frame.values())}
    t_bytes = t_ops = 0.0
    for shape, count in sorted(per_frame.items(), reverse=True):
        b, w, e, nh, masked, need_raw = shape
        args = [a.bfloat16() for a in k4_inputs(shape, dev, g)]
        t_k = time_ms(lambda: ops.rel_attention(*args, nh, masked, need_raw), iters=20, warmup=2)
        t_p = time_ms(lambda: ops.rel_attention_plain(*args, nh, masked, need_raw), iters=3,
                      warmup=1)
        t_y = time_ms(lambda: rel_attention_eager(*args, nh, masked), iters=10, warmup=2)
        nbytes, flops, exps = k4_work(shape, 2)
        t_b, by = bound(nbytes, flops, card)
        t_bytes += count * nbytes / card[0] * 1e3
        t_ops += count * flops / card[1] * 1e3
        k4["exp_count"] += count * exps
        for key, t in (("ms", t_k), ("plain_ms", t_p), ("yardstick_ms", t_y), ("bound_ms", t_b)):
            k4[key] += count * t
        k4["shapes"].append({"shape": list(shape), "launches_per_frame": count, "ms": t_k,
                             "plain_ms": t_p, "yardstick_ms": t_y, "bound_ms": t_b, "bound_by": by,
                             "bytes": nbytes, "flops": flops, "exps": exps})
        print(f"[time] K4 {shape} x{count} bf16: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"eager einsum chain {t_y:.4f} ms, bound {t_b:.4f} ms ({by}; {nbytes} B, "
              f"{flops} flop, {exps} exp)")
    k4["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[time] K4 per frame ({k4['launches_per_frame']} launches): kernel {k4['ms']:.4f} ms, "
          f"plain {k4['plain_ms']:.4f} ms, eager einsum chain {k4['yardstick_ms']:.4f} ms, "
          f"bound {k4['bound_ms']:.4f} ms ({k4['bound_by']}), {k4['exp_count']} exponentials")
    return res, prof, k4


def phase_k3(dev):
    import torch

    from openstereo_tpu_torch import ops

    g = torch.Generator().manual_seed(6)
    errs = {}
    for (b, c, h, w, d, gr), tag in [(K3_SHAPE, "main path")] + K3_EDGES:
        left, right = (torch.randn(b, c, h, w, generator=g).to(dev) for _ in range(2))
        ref = ops.build_gwc_volume(left, right, d, gr)
        got = ops.gwc_volume(left, right, d, gr)
        check(got.shape == (b, gr, d, h, w), f"K3 {tag}: shape {tuple(got.shape)}")
        err32 = (got - ref).abs().max().item()
        check(err32 <= 1e-5, f"K3 f32 {tag} {(b, c, h, w, d, gr)}: max-abs {err32} > 1e-5")
        lb, rb = left.bfloat16(), right.bfloat16()
        ref16 = ops.build_gwc_volume(lb, rb, d, gr)
        got16 = ops.gwc_volume(lb, rb, d, gr)
        err16, share = volume_bf16_check(got16, ref16, f"K3 bf16 {tag}")
        control = ""
        if tag == "main path":  # the unrounded control: products in f32
            no, c_share = volume_rejected(
                ops.build_gwc_volume(lb.float(), rb.float(), d, gr).bfloat16(), ref16)
            check(no, f"K3 bf16 {tag}: the unrounded control passes the check")
            control = f"; unrounded control rejected ({c_share:.3g} not bit-equal)"
        if w < d:
            check(not got[:, :, w:].any() and not got16[:, :, w:].any(),
                  "K3: planes with d >= W are not zero")
        print(f"[K3] {tag} {(b, c, h, w, d, gr)}: f32 max-abs {err32:.3g} (tol 1e-5), "
              f"bf16 max-abs {err16:.3g} (tol 8e-3·|ref| + 1e-3), {share:.3g} not bit-equal "
              f"(cap {VOLUME_FLIP_SHARE}){control}")
        errs[tag] = (err32, err16, share)
    # G = 1 is K1's function: the two kernels against each other
    left, right = (torch.randn(1, 24, 136, 240, generator=g).to(dev) for _ in range(2))
    err1 = (ops.gwc_volume(left, right, 48, 1)[:, 0] - ops.corr_volume(left, right, 48))
    err1 = err1.abs().max().item()
    check(err1 <= 1e-6, f"K3 with G = 1 vs K1: max-abs {err1} > 1e-6")
    print(f"[K3] G = 1 vs K1 at (1, 24, 136, 240, D 48), f32: max-abs {err1:.3g} (tol 1e-6)")
    torch.cuda.synchronize()
    return errs["main path"]


def phase_gwcnet(dev):
    import torch

    from openstereo_tpu_torch.config import load_config
    from openstereo_tpu_torch.data.transforms import build_transforms
    from openstereo_tpu_torch.models import build_model, set_kernels
    from openstereo_tpu_torch.tools.infer import run_pair

    cfg = load_config(str(GWC_CFG))
    tf = build_transforms(cfg.DATA_CONFIG.DATA_TRANSFORM["EVALUATING"])
    pairs = list(synthetic_pairs())
    model = build_model(cfg.MODEL, dtype=torch.bfloat16, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[gwcnet] GwcNet ({n_params} parameters), {H}x{W} b1 bf16, {N_PAIRS} pairs")
    run_pair(model, tf, *pairs[0])  # warm-up: kernel build and cuDNN plans
    wired, launches, per_frame = record_path(
        {"gwc_volume": {K3_SHAPE: 1}}, lambda: [run_pair(model, tf, *p) for p in pairs])
    print(f"[record] launches over {N_PAIRS} frames: {launches}; per frame by shape: "
          f"{per_frame}")
    launches, per_frame = launches["gwc_volume"], per_frame["gwc_volume"]

    set_kernels(model, False)
    eager = [run_pair(model, tf, *p) for p in pairs]
    set_kernels(model, True)
    for d in wired + eager:
        check(d.shape == (H, W) and np.isfinite(d).all(), "bf16 disparity not finite [H,W]")
    mean16 = max(float(np.abs(a - b).mean()) for a, b in zip(wired, eager))
    check(mean16 <= 0.5, f"GwcNet bf16 kernel vs eager mean-abs {mean16} px > 0.5")

    model32 = build_model(cfg.MODEL, dtype=torch.float32, device=dev, seed=0)
    max32 = 0.0
    for p in pairs:
        a = run_pair(set_kernels(model32, True), tf, *p)
        b = run_pair(set_kernels(model32, False), tf, *p)
        max32 = max(max32, float(np.abs(a - b).max()))
    del model32
    torch.cuda.empty_cache()
    print(f"[gwcnet] f32 kernel vs eager: max-abs {max32:.3g} px (tol 5e-3); bf16 kernel vs "
          f"eager: mean-abs {mean16:.3g} px (tol 0.5); bf16 disparity range "
          f"{wired[0].min():.2f}..{wired[0].max():.2f}")
    check(max32 <= 5e-3, f"GwcNet f32 kernel vs eager max-abs {max32} px > 5e-3")
    return model, launches, per_frame, (max32, mean16)


def phase_psmnet(dev):
    import torch

    from openstereo_tpu_torch.config import load_config
    from openstereo_tpu_torch.data.transforms import build_transforms
    from openstereo_tpu_torch.models import build_model
    from openstereo_tpu_torch.tools.infer import run_pair

    cfg = load_config(str(PSM_CFG))
    tf = build_transforms(cfg.DATA_CONFIG.DATA_TRANSFORM["EVALUATING"])
    pairs = list(synthetic_pairs())
    model = build_model(cfg.MODEL, dtype=torch.bfloat16, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[psmnet] PSMNet ({n_params} parameters), {H}x{W} b1 bf16, {N_PAIRS} pairs")
    run_pair(model, tf, *pairs[0])  # warm-up: cuDNN plans
    disps, launches, _ = record_path({}, lambda: [run_pair(model, tf, *p) for p in pairs])
    for d in disps:
        check(d.shape == (H, W) and np.isfinite(d).all(), "PSMNet bf16 disparity not finite [H,W]")
    print(f"[psmnet] launches over {N_PAIRS} frames: {launches} (no Pallas "
          f"kernel lies on the JAX PSMNet path, so none of the port's either); bf16 disparity "
          f"finite, {H}x{W}, range {disps[0].min():.2f}..{disps[0].max():.2f}")
    return model


def k3_work(shape, elem):
    b, c, h, w, d, g = shape
    nbytes = (2 * b * c * h * w + b * g * d * h * w) * elem
    flops = 2 * b * c * h * sum(max(w - k, 0) for k in range(d))  # products with w - d >= 0
    return nbytes, flops


def phase_timing_3d(dev, gwcnet, psmnet, card, per_frame):
    import torch

    from openstereo_tpu_torch.tools.bench import (bench_eager_vs_kernels, pair, profile_paths,
                                                  time_frames)

    res = bench_eager_vs_kernels(gwcnet, groups=4, reps=3)
    for path in ("eager", "kernels"):
        print(f"[time] GwcNet {path}: {res[path]['fps']:.3f} frames/s, "
              f"{res[path]['ms_per_frame']:.3f} ms/frame (median of {len(res[path]['group_ms'])} "
              f"groups of 3 chained frames)")
    psm_ms = time_frames(psmnet, pair(dev), groups=4, reps=3)
    psm = {"ms_per_frame": float(np.median(psm_ms)), "group_ms": [float(t) for t in psm_ms]}
    psm["fps"] = 1000.0 / psm["ms_per_frame"]
    print(f"[time] PSMNet: {psm['fps']:.3f} frames/s, {psm['ms_per_frame']:.3f} ms/frame "
          f"(median of 4 groups of 3 chained frames)")
    prof = profile_paths(gwcnet, 2, str(OUT_DIR / "gwcnet_profile"))
    psm_prof = profile_paths(psmnet, 2, str(OUT_DIR / "psmnet_profile"), paths=("eager",))
    rows = [("GwcNet", path, r, res[path]["ms_per_frame"]) for path, r in prof.items()]
    rows.append(("PSMNet", "eager", psm_prof["eager"], psm["ms_per_frame"]))
    for name, path, r, ms in rows:
        r["idle_share"] = 1.0 - r["device_busy_ms_per_frame"] / ms
        top = "; ".join(f"{t['kernel'][:60]} {t['ms_per_frame']:.3f} ms x{t['calls_per_frame']:g}"
                        for t in r["top"][:8])
        print(f"[profile] {name} {path}: device busy {r['device_busy_ms_per_frame']:.3f} "
              f"ms/frame, idle share {r['idle_share']:.4f} (against {ms:.3f} ms/frame "
              f"untraced); top: {top}")

    k3 = k3_timing(dev, per_frame, card, torch.Generator().manual_seed(7))
    return res, psm, prof, k3


def k3_timing(dev, per_frame, card, g, tag="K3"):
    """K3 at the one shape a path launched it at, bf16, as `k1_timing`."""
    import torch

    from openstereo_tpu_torch import ops

    (shape, count), = per_frame.items()
    b, c, h, w, d, gr = shape
    left, right = (torch.randn(b, c, h, w, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    t_k = time_ms(lambda: ops.gwc_volume(left, right, d, gr))
    t_d = device_ms(lambda: ops.gwc_volume(left, right, d, gr))
    t_p = time_ms(lambda: ops.build_gwc_volume(left, right, d, gr), iters=10)
    nbytes, flops = k3_work(shape, 2)
    t_b, by = bound(nbytes, flops, card)
    print(f"[time] {tag} {shape} x{count} bf16: kernel {t_k:.4f} ms (CUDA events over "
          f"back-to-back launches), device {t_d:.4f} ms per launch (torch.profiler), plain "
          f"{t_p:.4f} ms, bound {t_b:.4f} ms ({by}; {nbytes} B, {flops} flop; "
          f"{t_b / t_d:.1%} of the device time); no single PyTorch call computes it")
    return {"ms": count * t_k, "device_ms": count * t_d, "plain_ms": count * t_p,
            "yardstick_ms": None, "bound_ms": count * t_b, "bound_by": by,
            "bound_share": t_b / t_d, "launches_per_frame": count,
            "shapes": [{"shape": list(shape), "launches_per_frame": count, "ms": t_k,
                        "device_ms": t_d, "plain_ms": t_p, "bound_ms": t_b, "bound_by": by,
                        "bytes": nbytes, "flops": flops}]}


def model_paths():
    """The CoEx, MSNet3D and MSNet2D paths: (name, config, the kernels each
    must launch per frame by shape, the module whose output feeds a top-k head
    or None, the timing protocol). CoEx's top-k head picks 2 of its 48 costs;
    with random weights the costs are nearly flat, so a bf16 rounding moves
    the picks and the bf16 disparity of either path lies ~11 px from the f32
    one (the phase prints both; the flax model's own bf16 lies as far from
    its f32, `tests/coex_bf16_witness.py`): its bf16 check holds the cost
    that feeds the head, and the kernel path's distance from the f32
    disparity against the eager path's. Its f32 check is a share of pixels,
    as near-ties may flip there too (as STTR's argmax may). The protocol:
    (timing groups, chained frames per group, frames profiled), about 0.25-1
    s per group, as LightStereo-S's 8 groups of 20."""
    return [
        ("CoEx", COEX_CFG, {"corr_volume": {COEX_K1_SHAPE: 1}, "fused_mbconv": COEX_K2_SHAPES},
         "CostProcessor.cost_agg", (8, 20, 20)),
        ("MSNet3D", MSNET3D_CFG, {"gwc_volume": {K3_SHAPE: 1}, "fused_mbconv": MSNET3D_K2_SHAPES},
         None, (8, 12, 6)),
        ("MSNet2D", MSNET2D_CFG, {"fused_mbconv": MSNET2D_K2_SHAPES}, None, (8, 20, 10)),
    ]


def phase_model(dev, name, cfg_file, want, topk_input):
    """One of the CoEx/MSNet paths at 544x960, b1, bf16, random weights (seed
    0), through `run_pair` on the synthetic pairs: the launch records, peak
    memory, and the kernel path against the eager path. f32 (TF32 off):
    max-abs <= 5e-3 px, or with a top-k head >= 99.9 % of the pixels within
    5e-3 px. bf16: mean-abs <= 0.5 px; with a top-k head (`topk_input`, the
    module whose output feeds it), that cost within one bf16 unit of its
    largest magnitude on average, and the kernel path's disparity no more
    than 5 % further from the f32 eager one than the eager path's is
    (`model_paths` says why). Each bf16 path's distance from the f32 eager
    disparity is printed for every model."""
    import torch

    from openstereo_tpu_torch.config import load_config
    from openstereo_tpu_torch.data.transforms import build_transforms
    from openstereo_tpu_torch.models import build_model, set_kernels
    from openstereo_tpu_torch.tools.infer import run_pair

    tag = f"[{name.lower()}]"
    cfg = load_config(str(cfg_file))
    tf = build_transforms(cfg.DATA_CONFIG.DATA_TRANSFORM["EVALUATING"])
    pairs = list(synthetic_pairs())
    model = build_model(cfg.MODEL, dtype=torch.bfloat16, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{tag} {name} ({n_params} parameters), {H}x{W} b1 bf16, {N_PAIRS} pairs")
    run_pair(model, tf, *pairs[0])  # warm-up: kernel build and cuDNN plans
    costs = {"kernels": [], "eager": []}
    if topk_input:
        hook = model.get_submodule(topk_input).register_forward_hook(
            lambda mod, inp, out: costs[path].append(out.float()))
    path = "kernels"
    torch.cuda.reset_peak_memory_stats(dev)
    wired, launches, per_frame = record_path(want, lambda: [run_pair(model, tf, *p)
                                                            for p in pairs])
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"{tag} launches over {N_PAIRS} frames: {launches}; per frame by shape: {per_frame}; "
          f"peak memory (max_memory_allocated) {peak / 2**30:.3f} GiB")
    path = "eager"
    set_kernels(model, False)
    eager = [run_pair(model, tf, *p) for p in pairs]
    set_kernels(model, True)
    if topk_input:
        hook.remove()
    for d in wired + eager:
        check(d.shape == (H, W) and np.isfinite(d).all(), f"{name} bf16 disparity not finite [H,W]")
    mean16 = max(float(np.abs(a - b).mean()) for a, b in zip(wired, eager))

    model32 = build_model(cfg.MODEL, dtype=torch.float32, device=dev, seed=0)
    max32, share32, eager32 = 0.0, 1.0, []
    for p in pairs:
        a = run_pair(set_kernels(model32, True), tf, *p)
        eager32.append(run_pair(set_kernels(model32, False), tf, *p))
        d = np.abs(a - eager32[-1])
        max32, share32 = max(max32, float(d.max())), min(share32, float((d <= 5e-3).mean()))
    del model32
    torch.cuda.empty_cache()
    to_f32 = {k: max(float(np.abs(a - b).mean()) for a, b in zip(ds, eager32))
              for k, ds in (("kernels", wired), ("eager", eager))}
    print(f"{tag} f32 kernel vs eager: max-abs {max32:.3g} px, share within 5e-3 px "
          f"{share32:.6f} (tol {'>= 0.999' if topk_input else 'max-abs 5e-3'}); bf16 kernel vs "
          f"eager: mean-abs {mean16:.4g} px (tol {'-' if topk_input else '0.5'}); bf16 vs the f32 "
          f"eager disparity, mean-abs: kernels {to_f32['kernels']:.4g} px, eager "
          f"{to_f32['eager']:.4g} px; bf16 disparity range {wired[0].min():.2f}.."
          f"{wired[0].max():.2f}")
    rec = {"launches": launches, "per_frame": per_frame, "peak_bytes": peak,
           "max_abs_f32": max32, "share_within_5e-3_f32": share32, "mean_abs_bf16": mean16,
           "mean_abs_bf16_to_f32": to_f32}
    if topk_input:
        check(share32 >= 0.999, f"{name} f32 kernel vs eager: only {share32} of pixels within "
                                f"5e-3 px")
        cost = max(float((a - b).abs().mean() / b.abs().max())
                   for a, b in zip(costs["kernels"], costs["eager"]))
        print(f"{tag} bf16 kernel vs eager, the cost feeding the top-k head ({topk_input}): "
              f"mean-abs {cost:.3g} of its largest magnitude (tol 2^-7 = {2 ** -7:.3g})")
        check(cost <= 2 ** -7, f"{name} bf16 top-k input: mean-abs {cost}·max|cost| > 2^-7")
        check(to_f32["kernels"] <= 1.05 * to_f32["eager"],
              f"{name} bf16 kernel path {to_f32['kernels']} px from the f32 disparity, the eager "
              f"path {to_f32['eager']} px: more than 5 % further")
        rec["topk_input_mean_abs_rel_bf16"] = cost
    else:
        check(max32 <= 5e-3, f"{name} f32 kernel vs eager max-abs {max32} px > 5e-3")
        check(mean16 <= 0.5, f"{name} bf16 kernel vs eager mean-abs {mean16} px > 0.5")
    return model, rec


def phase_timing_model(dev, name, model, card, per_frame, protocol):
    """Frames/s of both paths (the bench protocol: `groups` groups of `reps`
    chained frames, with the spread between groups and the host's issue time
    per frame), a torch.profiler pass over `frames` frames of each (tables in
    `chiprun_out/<name>_profile/`), and each kernel of the path at its
    shapes beside its plain version and its bound."""
    import torch

    from openstereo_tpu_torch.tools.bench import bench_eager_vs_kernels, profile_paths

    groups, reps, frames = protocol
    res = bench_eager_vs_kernels(model, groups=groups, reps=reps)
    prof = profile_paths(model, frames, str(OUT_DIR / f"{name.lower()}_profile"))
    for path in ("eager", "kernels"):
        r, b = prof[path], res[path]
        ms = b["ms_per_frame"]
        r["idle_share"] = 1.0 - r["device_busy_ms_per_frame"] / ms
        top = "; ".join(f"{t['kernel'][:60]} {t['ms_per_frame']:.3f} ms x{t['calls_per_frame']:g}"
                        for t in r["top"][:8])
        print(f"[time] {name} {path}: {b['fps']:.3f} frames/s, {ms:.3f} ms/frame (median of "
              f"{len(b['group_ms'])} groups of {reps} chained frames; groups "
              f"{min(b['group_ms']):.3f}..{max(b['group_ms']):.3f} ms, spread "
              f"{b['group_spread']:.1%}); host issue {b['host_issue_ms']:.3f} ms/frame")
        print(f"[profile] {name} {path}: device busy {r['device_busy_ms_per_frame']:.3f} "
              f"ms/frame over {frames} frames, {r['device_ops_per_frame']:g} device operations "
              f"a frame, idle share {r['idle_share']:.4f}; top: {top}")
    g = torch.Generator().manual_seed(9)
    timing = {"corr_volume": k1_timing, "fused_mbconv": k2_timing, "gwc_volume": k3_timing}
    kernel_times = {k: timing[k](dev, shapes, card, g, tag=f"{k} ({name})")
                    for k, shapes in per_frame.items()}
    return res, prof, kernel_times


def phase_eval_batch(dev):
    """K1 and K2 at the shapes the trainer's evaluation launches them at
    (batch 12; K2 at 24 in the siamese trunk), f32 (TF32 off) and bf16, with
    the checks of phases 3 and 4 and the launcher's split count per shape."""
    import torch

    from openstereo_tpu_torch import ops
    from openstereo_tpu_torch.ops.kernels import build

    g = torch.Generator().manual_seed(8)
    b, c, h, w, d = K1_EVAL_SHAPE
    left, right = (torch.randn(b, c, h, w, generator=g).to(dev) for _ in range(2))
    err32 = (ops.corr_volume(left, right, d) - ops.correlation_volume(left, right, d))
    err32 = err32.abs().max().item()
    check(err32 <= 1e-5, f"K1 f32 {K1_EVAL_SHAPE}: max-abs {err32} > 1e-5")
    lb, rb = left.bfloat16(), right.bfloat16()
    err16, share = volume_bf16_check(ops.corr_volume(lb, rb, d), ops.correlation_volume(lb, rb, d),
                                     f"K1 bf16 {K1_EVAL_SHAPE}")
    print(f"[eval-batch] K1 {K1_EVAL_SHAPE}: f32 max-abs {err32:.3g} (tol 1e-5), bf16 max-abs "
          f"{err16:.3g} (tol 8e-3·|ref| + 1e-3), {share:.3g} not bit-equal "
          f"(cap {VOLUME_FLIP_SHARE})")
    del left, right, lb, rb
    k1 = (err32, err16, share)

    lib = build.load("fused_mbconv")
    worst32 = worst16 = 0.0
    splits_by_shape = {}
    for shape in K2_EVAL_SHAPES:
        b, h, w, cin, ch, cout = shape[:6]
        splits = lib.fused_mbconv_splits(b, h, w, ch, 1)
        chunks = -(-ch // 32)
        check(splits >= 1 and (splits - 1) * -(-chunks // splits) < chunks,
              f"K2 {shape[:6]}: the launcher picks {splits} splits of {chunks} chunks")
        splits_by_shape[shape[:6]] = splits
        x, args = k2_inputs(shape, dev, torch.float32, g)
        x16, args16 = x.bfloat16(), [a.bfloat16() if i % 2 == 0 else a for i, a in enumerate(args)]
        allowance = k2_flip_allowance(x16, args16)
        for res in ((True, False) if cin == cout else (False,)):
            ref = ops.mbconv_plain(x, *args, residual=res)
            got = ops.fused_mbconv(x, *args, residual=res)
            e32 = (got - ref).abs().max().item()
            check(torch.allclose(got, ref, rtol=1e-4, atol=1e-4),
                  f"K2 f32 {shape[:6]} residual={res}: max-abs {e32} beyond rtol 1e-4, atol 1e-4")
            del ref, got
            e16, beyond = k2_bf16_error(ops.fused_mbconv(x16, *args16, residual=res),
                                        ops.mbconv_plain(x16, *args16, residual=res), allowance,
                                        f"{shape[:6]} residual={res}")
            print(f"[eval-batch] K2 {shape[:6]} residual={res}, S={splits}: f32 max-abs "
                  f"{e32:.3g} (tol 1e-4 + 1e-4·|ref|), bf16 max-abs {e16:.3g} (tol "
                  f"8e-3·|ref| + 1e-3; {beyond} of {x16.numel() // cin * cout} beyond it, within "
                  f"the flip allowance, cap {K2_FLIP_SHARE})")
            worst32, worst16 = max(worst32, e32), max(worst16, e16)
        del x, x16, args, args16, allowance
        torch.cuda.empty_cache()
    print(f"[eval-batch] K2 launcher split counts: {splits_by_shape}")
    return k1, (worst32, worst16), splits_by_shape


def write_stereo_set(root, n, first, hw, max_disp):
    """`n` random-dot stereograms (the port's `make_stereogram`, seeds
    first..first+n-1) in the SceneFlow layout: left/, right/ PNG and left/
    PFM disparities; returns the split lines."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from openstereo_tpu_torch.data.readers import write_pfm
    from openstereo_tpu_torch.tools.overfit_check import make_stereogram

    for sub in ("left", "right"):
        (root / sub).mkdir(parents=True, exist_ok=True)

    def one(i):
        left, right, disp = make_stereogram(np.random.RandomState(i), *hw, max_disp)
        for sub, img in (("left", left), ("right", right)):
            Image.fromarray(np.clip(np.round(img), 0, 255).astype(np.uint8)).save(
                root / sub / f"{i:04d}.png")
        write_pfm(str(root / "left" / f"{i:04d}.pfm"), disp)
        return f"left/{i:04d}.png right/{i:04d}.png left/{i:04d}.pfm"

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(one, range(first, first + n)))


def phase_train(dev):
    """`run_training` on a data set written for it under `chiprun_out/`,
    which is deleted afterwards with the run's checkpoints (the run's log,
    metrics and config stay)."""
    import shutil

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    data_root = TRAIN_DIR / "SceneFlow"
    try:
        return run_training(dev, data_root)
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
        for ckpt in TRAIN_DIR.glob("runs/**/ckpt"):
            shutil.rmtree(ckpt, ignore_errors=True)


def run_training(dev, data_root):
    """The port's training entry point (`tools/train.py`) on the LightStereo-S
    SceneFlow config at full width: crop 320x736, batch 24, AMP bf16, AdamW
    2.4e-3, OneCycleLR, clip by value 0.1. Cuts: NUM_EPOCHS 1 (4 steps) and
    a synthetic data set. Its evaluation (544x960, batch 12) must go
    through K1 and K2; then the same weights evaluated eager, and a resumed
    Trainer against the checkpoint."""
    import torch
    import yaml

    from openstereo_tpu_torch.config import Config
    from openstereo_tpu_torch.models import set_kernels
    from openstereo_tpu_torch.ops import kernels
    from openstereo_tpu_torch.runtime import Trainer
    from openstereo_tpu_torch.tools import train

    t0 = time.perf_counter()
    split = {}
    for mode, n, first in (("train", TRAIN_PAIRS, 0), ("test", EVAL_PAIRS, TRAIN_PAIRS)):
        split[mode] = TRAIN_DIR / f"sceneflow_{mode}.txt"
        split[mode].write_text("\n".join(write_stereo_set(data_root, n, first, PAIR_HW, 192)))
    print(f"[train] wrote {TRAIN_PAIRS} + {EVAL_PAIRS} random-dot pairs at {PAIR_HW[0]}x"
          f"{PAIR_HW[1]} (PNG, PFM) in {time.perf_counter() - t0:.1f} s")

    cfg = yaml.safe_load(CFG_FILE.read_text())
    info = cfg["DATA_CONFIG"]["DATA_INFOS"][0]
    info["DATA_SPLIT"] = {"TRAINING": str(split["train"]), "EVALUATING": str(split["test"]),
                          "TESTING": str(split["test"])}
    info["DATA_PATH"] = str(data_root)
    cfg["OPTIMIZATION"]["NUM_EPOCHS"] = 1  # the cut: 96 pairs / 24 = 4 steps
    cfg_file = TRAIN_DIR / "lightstereo_s_sceneflow.yaml"
    cfg_file.write_text(yaml.safe_dump(cfg))
    paths = TRAIN_DIR / "data_paths.yaml"
    paths.write_text(yaml.safe_dump({info["DATASET"]: str(data_root)}))
    opt = cfg["OPTIMIZATION"]
    print(f"[train] config: crop {cfg['DATA_CONFIG']['DATA_TRANSFORM']['TRAINING'][0]['SIZE']}, "
          f"batch {opt['BATCH_SIZE_PER_GPU']}, AMP {opt['AMP']}, {opt['OPTIMIZER']['NAME']} "
          f"{opt['OPTIMIZER']['LR']}, {opt['SCHEDULER']['NAME']}, clip {opt['CLIP_GRAD']}, "
          f"NUM_EPOCHS {opt['NUM_EPOCHS']}; evaluation batch {cfg['EVALUATOR']['BATCH_SIZE_PER_GPU']}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = train.main(["--cfg_file", str(cfg_file), "--save_root", str(TRAIN_DIR / "runs"),
                          "--data_paths", str(paths), "--workers", "8", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    shapes = {k: dict(v) for k, v in kernels.launch_shapes.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    n_eval = trainer.eval_loader.steps_per_epoch
    steps = trainer.state.step
    check(steps == TRAIN_PAIRS // opt["BATCH_SIZE_PER_GPU"], f"{steps} train steps")
    losses, step_ms = trainer.epoch_losses, trainer.epoch_step_ms
    check(len(losses) == steps and all(np.isfinite(v) for v in losses), f"losses {losses}")
    print(f"[train] launches over the run ({steps} train steps, {n_eval} evaluation batch(es)): "
          f"{launches}")
    check(launches["corr_volume"] == n_eval and launches["fused_mbconv"] == 18 * n_eval,
          f"launches {launches} != K1 1 and K2 18 per evaluation batch (and none in training)")
    check(launches["rel_attention"] == 0 and launches["gwc_volume"] == 0, f"launches {launches}")
    check(shapes["corr_volume"] == {K1_EVAL_SHAPE: n_eval},
          f"K1 launch shapes {shapes['corr_volume']}")
    check(shapes["fused_mbconv"] == {k: n * n_eval for k, n in K2_EVAL_SHAPES.items()},
          f"K2 launch shapes {shapes['fused_mbconv']} != {K2_EVAL_SHAPES} per batch")
    ms = float(np.median(step_ms[1:4]))
    rate = opt["BATCH_SIZE_PER_GPU"] / ms * 1e3
    records = [json.loads(ln) for ln in open(trainer.metrics_file)]
    wired = [r for r in records if r["phase"] == "eval"][-1]
    print(f"[train] losses {[round(v, 4) for v in losses]}; step ms (CUDA events) "
          f"{[round(t, 2) for t in step_ms]}; median of steps 2-4 {ms:.2f} ms/step, "
          f"{rate:.1f} samples/s; peak memory (max_memory_allocated) {peak / 2**30:.3f} GiB; "
          f"run wall time {wall:.1f} s")

    set_kernels(trainer.model, False)
    kernels.reset_launch_counts()
    eager = trainer.evaluate(0)
    check(sum(kernels.launch_counts.values()) == 0, "the eager evaluation launched kernels")
    set_kernels(trainer.model, True)
    d_epe = abs(wired["epe"] - eager["epe"])
    print(f"[train] evaluation with kernels: "
          f"{ {k: round(v, 4) for k, v in wired.items() if k not in ('phase', 'epoch')} }; "
          f"eager: { {k: round(v, 4) for k, v in eager.items()} }; |EPE difference| "
          f"{d_epe:.4g} px (tol 0.5)")
    check(all(np.isfinite(v) for k, v in wired.items() if k not in ("phase",)), f"{wired}")
    check(d_epe <= 0.5, f"evaluation with kernels vs eager: EPE differs by {d_epe} px > 0.5")

    check(trainer.saved_epochs() == [0], f"checkpoints {trainer.saved_epochs()}")
    saved = torch.load(trainer.ckpt_path(0), map_location="cpu", weights_only=True)
    again = Trainer(Config.from_dict(cfg), trainer.run_dir, device=dev, num_workers=8)
    start = again.resume_ckpt()
    state = again.model.state_dict()
    same = all(torch.equal(state[k].cpu(), v) for k, v in saved["model_state"].items())
    check(start == 1 and again.start_epoch == 1 and again.state.step == steps and same,
          f"resume: start epoch {start}, step {again.state.step}, bit-equal {same}")
    print(f"[train] resumed Trainer: start epoch {start}, step {again.state.step}, "
          f"{len(saved['model_state'])} tensors bit-equal to the checkpoint")
    prof = profile_train_steps(again, ms)
    del trainer, again
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "samples_per_s": rate, "step_ms": step_ms, "losses": losses,
            "peak_bytes": peak, "eval_kernels": wired, "eval_eager": eager, "launches": launches,
            "eval_batches": n_eval, "profile": prof}


def profile_train_steps(trainer, untraced_ms, steps=2):
    """torch.profiler over `steps` train steps of `trainer` on one batch of its
    loader: device busy ms per step (the kernel rows summed; one stream), its
    idle share against `untraced_ms` per step, and the top kernels (table in
    `chiprun_out/train_smoke/profile_train_step.txt`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from openstereo_tpu_torch.data.loader import batch_to_device

    batches = trainer.train_loader.epoch(1)
    batch = batch_to_device(next(batches), trainer.device)
    batches.close()
    trainer.train_step(batch)  # warm-up outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e3 / steps
    (TRAIN_DIR / "profile_train_step.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    top = [{"kernel": e.key[:90], "ms_per_step": e.self_device_time_total / 1e3 / steps,
            "calls_per_step": e.count / steps} for e in events[:10]]
    idle = 1.0 - busy / untraced_ms
    print(f"[profile] train step (b24 320x736 bf16): device busy {busy:.2f} ms/step, idle share "
          f"{idle:.4f} (against {untraced_ms:.2f} ms/step untraced); top: " + "; ".join(
              f"{t['kernel'][:60]} {t['ms_per_step']:.2f} ms x{t['calls_per_step']:g}"
              for t in top[:8]))
    return {"device_busy_ms_per_step": busy, "idle_share": idle, "top": top}


def phase_overfit():
    """The port's learning check: LightStereo, 400 steps, 192x384, batch 4,
    max_disp 64, bf16, AdamW 4e-4, clip 0.1; the final train EPE must be
    below 3 px (the JAX tool's CONVERGED line)."""
    from openstereo_tpu_torch.tools import overfit_check

    t0 = time.perf_counter()
    res = overfit_check.main(OVERFIT_ARGS)
    took = time.perf_counter() - t0
    traj = [(s, round(l, 4), round(e, 3)) for s, l, e in res["trajectory"]]
    print(f"[overfit] trajectory (step, loss, train EPE px): {traj}; {took:.1f} s")
    check(res["final_epe"] < 3.0, f"overfit check: final train EPE {res['final_epe']} px >= 3.0")
    return res


def path_entries(models, kernel, errors):
    """The `paths` field of a kernel's JSON entry: for each CoEx/MSNet path
    that launched it, the launches counted on that path's run, per frame by
    shape, the times per frame at those shapes (`k1/k2/k3_timing`) and the
    errors at those shapes from the kernel phases."""
    out = {}
    for name, rec in models.items():
        if kernel not in rec["per_frame"]:
            continue
        t = rec["kernels"][kernel]
        out[name] = dict(launches=rec["launches"][kernel],
                         launches_per_frame=t["launches_per_frame"],
                         **{k: t[k] for k in ("ms", "device_ms", "plain_ms", "yardstick_ms",
                                              "bound_ms", "bound_by", "shapes") if k in t},
                         **errors.get(name, {}))
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    try:
        import openstereo_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    try:
        smi, kind = phase_card()
        card = peaks(kind)
        ptxas = phase_build()
        k1_err = phase_k1(dev)
        k2_err = phase_k2(dev)
        k4_err = phase_k4(dev)
        model, launches, per_frame, max32, mean16 = phase_slice(dev)
        sttr, k4_launches, k4_per_frame, sttr_agree = phase_sttr(dev)
        bench, k1, k2 = phase_timing(dev, model, card, per_frame)
        sttr_bench, sttr_prof, k4 = phase_timing_sttr(dev, sttr, card, k4_per_frame)
        del model, sttr
        torch.cuda.empty_cache()
        k3_err = phase_k3(dev)
        gwcnet, k3_launches, k3_per_frame, gwc_agree = phase_gwcnet(dev)
        psmnet = phase_psmnet(dev)
        gwc_bench, psm_bench, gwc_prof, k3 = phase_timing_3d(dev, gwcnet, psmnet, card,
                                                             k3_per_frame)
        del gwcnet, psmnet
        torch.cuda.empty_cache()
        models = {}
        for name, cfg_file, want, rule, protocol in model_paths():
            model, rec = phase_model(dev, name, cfg_file, want, rule)
            rec["bench"], rec["profile"], rec["kernels"] = phase_timing_model(
                dev, name, model, card, rec["per_frame"], protocol)
            models[name] = rec
            del model
            torch.cuda.empty_cache()
        k1_eval, k2_eval, k2_eval_splits = phase_eval_batch(dev)
        trained = phase_train(dev)
        overfit = phase_overfit()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    entries = [
        dict(name="corr_volume", route="cuda", source="openstereo_tpu_torch/csrc/cost_volume.cu",
             replaces="openstereo_tpu/ops/pallas/corr_volume.py:34",
             launches=launches["corr_volume"], max_abs_err=k1_err["main"][1],
             max_abs_err_f32=k1_err["main"][0], not_bit_equal_share=k1_err["main"][2],
             paths=path_entries(models, "corr_volume",
                                {"CoEx": dict(zip(("max_abs_err_f32", "max_abs_err",
                                                   "not_bit_equal_share"), k1_err["CoEx"]))}),
             launches_trainer_eval=trained["launches"]["corr_volume"],
             eval_batch=dict(shape=list(K1_EVAL_SHAPE), max_abs_err=k1_eval[1],
                             max_abs_err_f32=k1_eval[0], not_bit_equal_share=k1_eval[2]),
             flip_share=VOLUME_FLIP_SHARE, library_ms=None, ptxas=ptxas["cost_volume"], **k1),
        dict(name="fused_mbconv", route="cuda", source="openstereo_tpu_torch/csrc/fused_mbconv.cu",
             replaces="openstereo_tpu/ops/pallas/fused_mbconv.py:53",
             launches=launches["fused_mbconv"], max_abs_err=k2_err[1],
             max_abs_err_f32=k2_err[0], library_ms=None,
             paths=path_entries(models, "fused_mbconv", {
                 name: {"max_abs_err_f32": max(k2_err[3][k][0] for k in want["fused_mbconv"]),
                        "max_abs_err": max(k2_err[3][k][1] for k in want["fused_mbconv"])}
                 for name, _, want, _, _ in model_paths()}),
             launches_trainer_eval=trained["launches"]["fused_mbconv"],
             eval_batch=dict(max_abs_err=k2_eval[1], max_abs_err_f32=k2_eval[0],
                             splits=[dict(shape=list(k), splits=v)
                                     for k, v in k2_eval_splits.items()]),
             yardstick="eager cuDNN pw->dw->pw chain, folded BN", ptxas=ptxas["fused_mbconv"],
             flip_share=K2_FLIP_SHARE,
             controls=[dict(shape=list(shp), residual=res, control=ctl, beyond=c[0],
                            over_allowance=c[1]) for (shp, res, ctl), c in k2_err[2].items()],
             **k2),
        dict(name="rel_attention", route="cuda", source="openstereo_tpu_torch/csrc/rel_attention.cu",
             replaces="openstereo_tpu/ops/pallas/rel_attention.py:49",
             launches=k4_launches, max_abs_err=k4_err[1], max_abs_err_f32=k4_err[0],
             library_ms=None,
             yardstick="the port's eager einsum chain (gathered [W,W,E] tables, einsums, "
                       "softmax, p.v); a chain, not one call",
             ptxas=ptxas["rel_attention"], flip_share=K4_FLIP_SHARE,
             controls=[dict(shape=list(shp), control=ctl, beyond=c[0], over_allowance=c[1])
                       for shp, cs in k4_err[2].items() for ctl, c in cs.items()],
             **k4),
        dict(name="gwc_volume", route="cuda", source="openstereo_tpu_torch/csrc/cost_volume.cu",
             replaces="openstereo_tpu/ops/pallas/corr_volume.py:103",
             launches=k3_launches, max_abs_err=k3_err[1], max_abs_err_f32=k3_err[0],
             not_bit_equal_share=k3_err[2], flip_share=VOLUME_FLIP_SHARE, library_ms=None,
             paths=path_entries(models, "gwc_volume", {"MSNet3D": dict(zip(
                 ("max_abs_err_f32", "max_abs_err", "not_bit_equal_share"), k3_err))}),
             ptxas=ptxas["cost_volume"], **k3),
    ]
    print(f"[slice] fps eager {bench['eager']['fps']:.2f}, kernels {bench['kernels']['fps']:.2f}; "
          f"disparity f32 max-abs {max32:.3g}, bf16 mean-abs {mean16:.3g}; "
          f"total {time.perf_counter() - t0:.1f} s")
    raw_err, smax32, sshare32, smean16, sshare16 = sttr_agree
    print(f"[sttr] fps eager {sttr_bench['eager']['fps']:.3f}, kernels "
          f"{sttr_bench['kernels']['fps']:.3f}; f32 raw {raw_err:.3g}·max|raw|, disparity "
          f"max-abs {smax32:.4g} px ({sshare32:.6f} within 5e-3); bf16 mean-abs {smean16:.4g} px "
          f"({sshare16:.5f} within 3 px); device busy "
          f"{sttr_prof['kernels']['device_busy_ms_per_frame']:.3f} ms/frame (kernels), "
          f"{sttr_prof['eager']['device_busy_ms_per_frame']:.3f} (eager)")
    print(f"[gwcnet] fps eager {gwc_bench['eager']['fps']:.3f}, kernels "
          f"{gwc_bench['kernels']['fps']:.3f}; f32 max-abs {gwc_agree[0]:.3g} px, bf16 mean-abs "
          f"{gwc_agree[1]:.3g} px; device busy "
          f"{gwc_prof['kernels']['device_busy_ms_per_frame']:.3f} ms/frame (kernels), "
          f"{gwc_prof['eager']['device_busy_ms_per_frame']:.3f} (eager); PSMNet fps "
          f"{psm_bench['fps']:.3f}; total {time.perf_counter() - t0:.1f} s")
    for name, rec in models.items():
        b, p = rec["bench"], rec["profile"]
        print(f"[{name.lower()}] fps eager {b['eager']['fps']:.3f}, kernels "
              f"{b['kernels']['fps']:.3f} (group spread {b['eager']['group_spread']:.1%}, "
              f"{b['kernels']['group_spread']:.1%}; host issue {b['eager']['host_issue_ms']:.3f}, "
              f"{b['kernels']['host_issue_ms']:.3f} ms/frame); f32 max-abs {rec['max_abs_f32']:.3g} px "
              f"({rec['share_within_5e-3_f32']:.6f} within 5e-3), bf16 mean-abs "
              f"{rec['mean_abs_bf16']:.3g} px; device busy "
              f"{p['kernels']['device_busy_ms_per_frame']:.3f} ms/frame (kernels, idle "
              f"{p['kernels']['idle_share']:.4f}), {p['eager']['device_busy_ms_per_frame']:.3f} "
              f"(eager, idle {p['eager']['idle_share']:.4f}); peak {rec['peak_bytes'] / 2**30:.3f} "
              f"GiB")
    print(f"[train] LightStereo-S 320x736 b24 bf16: {trained['ms_per_step']:.2f} ms/step (median "
          f"of steps 2-4), {trained['samples_per_s']:.1f} samples/s, peak "
          f"{trained['peak_bytes'] / 2**30:.3f} GiB; losses {trained['losses']}; evaluation EPE "
          f"{trained['eval_kernels']['epe']:.4f} px with kernels, {trained['eval_eager']['epe']:.4f} "
          f"eager; overfit final train EPE {overfit['final_epe']:.3f} px; total "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
