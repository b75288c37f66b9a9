"""Parameters, FLOPs and latency of a config's model (counterpart of `tools/measure.py`).

    python -m openstereo_tpu_torch.tools.measure --cfg_file cfgs/igev/igev_sceneflow_amp.yaml \\
        [--shape 544 960] [--batch 1] [--reps 100] [--warmup 10] [--f32] [--device cpu]

The protocol of the JAX CLI: a zero input [batch,3,H,W], bf16 (f32 with
--f32), random weights from seed 0, `warmup` forwards, then `reps` timed
forwards. On the card the time is taken with CUDA events around the timed
forwards, and the card's name and power limit (`nvidia-smi`) are printed
beside it; on the CPU with the host clock. FLOPs come from
`torch.utils.flop_counter.FlopCounterMode` over one forward in place of
XLA's cost analysis: it counts the matrix products and convolutions
(2 per multiply-add), not elementwise work, and runs with the port's kernels
off, so that the fused MBConv blocks are counted through their convs (the
hand-written kernels are not PyTorch operators). Runs on the CUDA card
unless --device cpu is given (raises without a card).
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Dict, Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--shape", type=int, nargs=2, default=[544, 960])
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--reps", type=int, default=100)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--f32", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def card_line() -> str:
    """The card's name and power limit as `nvidia-smi` reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def count_flops(model: torch.nn.Module, data: Dict[str, torch.Tensor]) -> int:
    """FLOPs of one forward by FlopCounterMode, the port's kernels off."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..models import set_kernels

    set_kernels(model, False)
    try:
        with torch.inference_mode(), FlopCounterMode(display=False) as counter:
            model(data)
    finally:
        set_kernels(model, True)
    return int(counter.get_total_flops())


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Measure as the arguments say; prints two lines and returns their figures."""
    args = parse_args(argv)

    from ..config import load_config
    from ..device import resolve_device
    from ..models import build_model

    device = resolve_device(args.device)
    cfg = load_config(args.cfg_file)
    dtype = torch.float32 if args.f32 else torch.bfloat16
    model = build_model(cfg.MODEL, dtype=dtype, device=device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    h, w = args.shape
    data = {k: torch.zeros(args.batch, 3, h, w, device=device) for k in ("left", "right")}
    flops = count_flops(model, data)
    cuda = device.type == "cuda"
    with torch.inference_mode():
        for _ in range(args.warmup):
            model(data)
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = model(data)["disp_pred"]
        if cuda:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / args.reps
        else:
            float(out.sum())
            ms = (time.perf_counter() - t0) * 1e3 / args.reps
    where = card_line() if cuda else "cpu (host clock)"
    dname = "bf16" if dtype == torch.bfloat16 else "f32"
    print(f"model: {cfg.MODEL.NAME}  params: {n_params / 1e6:.2f}M ({n_params})  "
          f"flops: {flops / 1e9:.1f}G ({flops})  input: {args.batch}x3x{h}x{w} {dname}")
    print(f"latency: {ms:.2f} ms  ({args.batch / ms * 1e3:.1f} frames/s) on {where}")
    return {"params": n_params, "flops": flops, "ms": ms, "device": where}


if __name__ == "__main__":
    main()
