"""Inference throughput on one CUDA card, eager path vs kernel path.

    python -m openstereo_tpu_torch.tools.bench [--groups 9] [--reps 25]
        [--cfg_file cfgs/sttr/sttr_flyingthings3d.yaml --size 540 960]

LightStereo-S by default, or the MODEL section of `--cfg_file`.

The protocol of the JAX `bench.py:41-84`: input [1,3,544,960], bf16, random
weights from a seed; each timing group runs `reps` frames chained by a data
dependency (frame i+1's left image adds 0·mean(frame i's disparity)), timed
with CUDA events around the group; frames/s is the median over groups.
The eager path (cuDNN and PyTorch ops) and the kernel path (the port's CUDA
kernels wired in) run in turns, eager-kernel-kernel-eager, on one card.
Each path's turns also take the host's own time per frame: the host-clock
ms to issue one frame into an idle stream (`host_issue_ms`); where it
exceeds the device's busy time, the host sets the frame time.
Prints one JSON line. It has no CPU mode: without a card it raises.
`--profile DIR` adds a torch.profiler pass over each path: device busy time
per frame, its idle share against the untraced ms/frame, and the top kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import Config, load_config
from ..models import build_model, set_kernels

H, W = 544, 960
LIGHTSTEREO_S = Config.from_dict({"NAME": "LightStereo", "MAX_DISP": 192, "EXPANSE_RATIO": 4,
                                  "AGGREGATION_BLOCKS": [1, 2, 4], "LEFT_ATT": True})


def pair(device: torch.device, size: Tuple[int, int] = (H, W)) -> Dict[str, torch.Tensor]:
    """A random [1,3,h,w] pair from seed 0, at the caller's size."""
    rng = np.random.RandomState(0)
    return {k: torch.from_numpy(rng.rand(1, 3, *size).astype(np.float32)).to(device)
            for k in ("left", "right")}


def time_frames(model: torch.nn.Module, data: Dict[str, torch.Tensor], groups: int,
                reps: int, warmup: int = 3) -> np.ndarray:
    """Per-group ms/frame of `reps` chained frames, timed with CUDA events."""
    def chain(n):
        carry = torch.zeros((), device=data["left"].device)
        for _ in range(n):
            out = model({"left": data["left"] + carry, "right": data["right"]})["disp_pred"]
            carry = out.mean() * 0.0
        return carry

    times = []
    with torch.inference_mode():
        chain(warmup)
        torch.cuda.synchronize()
        for _ in range(groups):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            chain(reps)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
    return np.asarray(times)


def host_issue_ms(model: torch.nn.Module, data: Dict[str, torch.Tensor],
                  frames: int) -> np.ndarray:
    """Host-clock ms to issue each of `frames` frames into an idle stream (a
    synchronize before each): the host's own cost of a frame, as the
    model's forward has no host sync of its own, as long as the frame's
    launches fit in the card's launch queue; beyond that the host waits on
    the device and the time includes the wait (`profile_paths` counts the
    launches per frame)."""
    times = []
    with torch.inference_mode():
        for _ in range(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(data)
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return np.asarray(times)


def bench_eager_vs_kernels(model: torch.nn.Module, groups: int, reps: int,
                           size: Tuple[int, int] = (H, W)) -> Dict[str, dict]:
    """Run eager, kernels, kernels, eager (half the groups each time, then
    `reps` frames of `host_issue_ms`) on a random pair of `size`; return
    the median ms/frame and frames/s of each path, the spread of its groups
    and its median host ms per frame."""
    data = pair(next(model.parameters()).device, size)
    runs = {"eager": [], "kernels": []}
    host = {"eager": [], "kernels": []}
    for path in ("eager", "kernels", "kernels", "eager"):
        set_kernels(model, path == "kernels")
        runs[path].append(time_frames(model, data, max(1, groups // 2), reps))
        host[path].append(host_issue_ms(model, data, reps))
    set_kernels(model, True)
    out = {}
    for path, ts in runs.items():
        ts = np.concatenate(ts)
        ms = float(np.median(ts))
        out[path] = {"ms_per_frame": ms, "fps": 1000.0 / ms,
                     "group_ms": [float(t) for t in ts],
                     "group_spread": float((ts.max() - ts.min()) / ms),
                     "host_issue_ms": float(np.median(np.concatenate(host[path])))}
    return out


def profile_paths(model: torch.nn.Module, frames: int, out_dir: str,
                  size: Tuple[int, int] = (H, W),
                  paths: Tuple[str, ...] = ("eager", "kernels")) -> Dict[str, dict]:
    """torch.profiler over `frames` chained frames of each of `paths`: device
    time per frame summed over kernels (one stream, so the sum is the busy
    time), the device operations (kernels, copies, fills) per frame, the top
    kernels, and the full table in `out_dir/profile_<path>.txt`.
    A model without kernels of the port is profiled with paths=("eager",)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    data = pair(next(model.parameters()).device, size)
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for path in paths:
        set_kernels(model, path == "kernels")
        time_frames(model, data, groups=1, reps=frames)  # warm-up outside the trace
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced_ms = time_frames(model, data, groups=1, reps=frames, warmup=0)[0]
        # kernel rows only: an op's row repeats the device time of the kernels it launched
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        events.sort(key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in events) / 1e3 / frames
        launches = sum(e.count for e in events) / frames
        with open(os.path.join(out_dir, f"profile_{path}.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
        out[path] = {"device_busy_ms_per_frame": busy, "device_ops_per_frame": launches,
                     "traced_ms_per_frame": float(traced_ms),
                     "top": [{"kernel": e.key[:90], "ms_per_frame": e.self_device_time_total / 1e3 / frames,
                              "calls_per_frame": e.count / frames} for e in events[:12]]}
    set_kernels(model, True)
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--groups", type=int, default=9)
    p.add_argument("--reps", type=int, default=25)
    p.add_argument("--profile", default=None,
                   help="directory for torch.profiler tables of both paths (off by default)")
    p.add_argument("--cfg_file", default=None, help="a config whose MODEL to run (LightStereo-S)")
    p.add_argument("--size", type=int, nargs=2, default=(H, W), help="input height and width")
    args = p.parse_args()
    model_cfg = load_config(args.cfg_file).MODEL if args.cfg_file else LIGHTSTEREO_S
    model = build_model(model_cfg, dtype=torch.bfloat16, seed=0)
    size = tuple(args.size)
    res = bench_eager_vs_kernels(model, args.groups, args.reps, size)
    name = "lightstereo_s" if args.cfg_file is None else model_cfg.NAME.lower()
    line = {"metric": f"{name}_fps_{size[0]}x{size[1]}_b1_bf16",
            "device": torch.cuda.get_device_name(0),
            "eager": res["eager"], "kernels": res["kernels"],
            "kernels_over_eager": res["kernels"]["fps"] / res["eager"]["fps"]}
    if args.profile:
        prof = profile_paths(model, args.reps, args.profile, size)
        for path, r in prof.items():
            r["idle_share"] = 1.0 - r["device_busy_ms_per_frame"] / res[path]["ms_per_frame"]
        line["profile"] = prof
    print(json.dumps(line))


if __name__ == "__main__":
    main()
