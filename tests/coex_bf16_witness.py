"""CoEx in bf16 against f32, the flax model and the port side by side, on the CPU.

    JAX_PLATFORMS=cpu python tests/coex_bf16_witness.py [--size 256 512] [--pairs 2]

CoEx's config at full width (MAX_DISP 192, every channel count as
`cfgs/coex/coex_sceneflow_amp.yaml`) with the port's random weights
(`build_model`, seed 0, as `chip_smoke.py` builds them), carried to flax by
the JAX package's `convert_coex`. The inputs are random-dot pairs shifted
by 12 px (as `chip_smoke.py:synthetic_pairs`), normalized as the config's
EVALUATING transform does, at a reduced size (no nearest resize fires at
multiples of 64). Four forwards per pair: flax f32, flax bf16 (jitted),
port f32 and port bf16 (kernel wrappers on; on the CPU they run their plain
versions).

It asks whether the flax model's own bf16 disparity lies as far from its
f32 one as the port's does, with random weights: if it does, the distance
is the model's and not a fault of the port's bf16 code. Prints one JSON
line per pair and one summary line:
- `bf16_to_f32_px`: mean-abs distance of each bf16 disparity from its own
  model's f32 disparity; `port_vs_flax_px`: mean-abs port vs flax, f32 and
  bf16; in f32 also the max-abs and the share within 1e-3 px (a near-tie
  of the 2nd and 3rd costs may flip in f32 too, with another sum order);
- `agree_port_vs_flax_px_bf16`: mean-abs port vs flax in bf16 over the
  pixels whose top-2 picks agree around them (`agreeing`; their share is
  `agree_share_bf16`), where only the rounding of the values differs;
- `head_input_port_vs_flax`: the head input's mean-abs difference, port vs
  flax, over the largest magnitude of flax's, f32 and bf16;
- `topk_changed`: the share of quarter-resolution pixels whose top-2 index
  pair in bf16 differs from the f32 one;
- the head input (the cost that feeds the top-2 head), per model and dtype:
  `near_tie`, the share of pixels whose 2nd and 3rd largest costs lie within
  one bf16 unit of the 2nd (2^-7·|c2|); `tie`, the share where they are equal;
  `spread`, the mean of (largest − 3rd largest) / max|cost|.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from openstereo_tpu.models.coex import CoExNet as FlaxCoExNet  # noqa: E402
from openstereo_tpu.utils.torch_convert import convert_coex  # noqa: E402

from openstereo_tpu_torch.config import load_config  # noqa: E402
from openstereo_tpu_torch.models import build_model  # noqa: E402

CFG = ROOT / "cfgs/coex/coex_sceneflow_amp.yaml"
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def pairs(n, size):
    rng = np.random.RandomState(0)
    for _ in range(n):
        left = (rng.rand(*size, 3) * 255).astype(np.uint8).astype(np.float32)
        right = np.roll(left, -12, axis=1)
        yield [((img / 255.0 - MEAN) / STD)[None].astype(np.float32) for img in (left, right)]


def head_stats(cost):
    """cost [B,D,h,w] float32 (as the head reads it) → near-tie, tie, spread."""
    top = -np.sort(-cost, axis=1)[:, :3]
    c1, c2, c3 = top[:, 0], top[:, 1], top[:, 2]
    unit = 2.0 ** -7 * np.abs(c2)
    return {"near_tie": float(((c2 - c3) <= unit).mean()), "tie": float((c2 == c3).mean()),
            "spread": float(((c1 - c3) / np.abs(cost).max()).mean())}


def top2(cost):
    """The top-2 indices, ties lower index first, as a sorted pair per pixel."""
    idx = np.argsort(-cost, axis=1, kind="stable")[:, :2]
    return np.sort(idx, axis=1)


def models(cfg):
    """(the port's f32 and bf16 models, flax's jitted f32 and bf16 forwards,
    the flax variables): one set of weights, the port's seed-0 draw."""
    port32 = build_model(cfg, dtype=torch.float32, device="cpu", seed=0)
    port16 = build_model(cfg, dtype=torch.bfloat16, device="cpu", seed=0)
    port16.load_state_dict(port32.state_dict())
    variables = convert_coex({k: v.numpy() for k, v in port32.state_dict().items()})
    kw = dict(max_disp=cfg.MAX_DISP, spixel_branch_channels=tuple(cfg.SPIXEL_BRANCH_CHANNELS),
              matching_weighted=cfg.MATCHING_WEIGHTED, gce=cfg.GCE,
              aggregation_disp_strides=cfg.AGGREGATION_DISP_STRIDES,
              aggregation_channels=tuple(cfg.AGGREGATION_CHANNELS),
              aggregation_blocks_num=tuple(cfg.AGGREGATION_BLOCKS_NUM),
              regression_topk=cfg.REGRESSION_TOPK)

    def flax_fn(dtype):
        model = FlaxCoExNet(dtype=dtype, **kw)

        def run(v, left, right):
            out, state = model.apply(v, {"left": left, "right": right}, train=False,
                                     capture_intermediates=lambda mdl, _: mdl.name == "up0",
                                     mutable=["intermediates"])
            cost = state["intermediates"]["up0"]["__call__"][0][..., 0]  # [B,D,h,w]
            return out["disp_pred"], cost.astype(jnp.float32)
        return jax.jit(run)

    return ({"f32": port32, "bf16": port16},
            {"f32": flax_fn(jnp.float32), "bf16": flax_fn(jnp.bfloat16)}, variables)


def agreeing(cost_a, cost_b):
    """Full-resolution mask of the pixels whose quarter-resolution 3×3
    neighbourhood (the taps `context_upsample` reads) has the same top-2
    pair in both costs."""
    same = (top2(cost_a) == top2(cost_b)).all(axis=1)  # [B,h,w]
    pad = np.pad(same, ((0, 0), (1, 1), (1, 1)), constant_values=True)
    h, w = same.shape[1:]
    nbr = np.ones_like(same)
    for dy in range(3):
        for dx in range(3):
            nbr &= pad[:, dy:dy + h, dx:dx + w]
    return nbr.repeat(4, axis=1).repeat(4, axis=2)


def compare(ports, flax, variables, left, right):
    """One pair (NHWC float32) through the four forwards → the statistics."""
    disp, cost = {}, {}
    for dt, fn in flax.items():
        d, c = fn(variables, jnp.asarray(left), jnp.asarray(right))
        disp[("flax", dt)], cost[("flax", dt)] = np.asarray(d), np.asarray(c)
    for dt, model in ports.items():
        got = []
        hook = model.CostProcessor.cost_agg.register_forward_hook(
            lambda mod, inp, out: got.append(out.float().numpy()))
        with torch.inference_mode():
            d = model({"left": torch.from_numpy(left.transpose(0, 3, 1, 2)),
                       "right": torch.from_numpy(right.transpose(0, 3, 1, 2))})["disp_pred"]
        hook.remove()
        disp[("port", dt)], cost[("port", dt)] = d.float().numpy(), got[0]
    mean = lambda a, b: float(np.abs(disp[a] - disp[b]).mean())  # noqa: E731
    agree = agreeing(cost[("port", "bf16")], cost[("flax", "bf16")])
    return {
        "bf16_to_f32_px": {m: mean((m, "bf16"), (m, "f32")) for m in ("flax", "port")},
        "port_vs_flax_px": {dt: mean(("port", dt), ("flax", dt)) for dt in ("f32", "bf16")},
        "port_vs_flax_max_px_f32": float(np.abs(disp[("port", "f32")]
                                                - disp[("flax", "f32")]).max()),
        "port_vs_flax_within_1e-3_f32": float((np.abs(disp[("port", "f32")]
                                                      - disp[("flax", "f32")]) <= 1e-3).mean()),
        "agree_share_bf16": float(agree.mean()),
        "agree_port_vs_flax_px_bf16": float(np.abs(disp[("port", "bf16")]
                                                   - disp[("flax", "bf16")])[agree].mean()),
        "head_input_port_vs_flax": {dt: float(np.abs(cost[("port", dt)] - cost[("flax", dt)])
                                              .mean() / np.abs(cost[("flax", dt)]).max())
                                    for dt in ("f32", "bf16")},
        "topk_changed": {m: float((top2(cost[(m, "bf16")]) != top2(cost[(m, "f32")]))
                                  .any(axis=1).mean()) for m in ("flax", "port")},
        "head_input": {f"{m} {dt}": head_stats(cost[(m, dt)])
                       for m in ("flax", "port") for dt in ("f32", "bf16")},
    }


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", type=int, nargs=2, default=(256, 512))
    p.add_argument("--pairs", type=int, default=2)
    args = p.parse_args()
    ports, flax, variables = models(load_config(str(CFG)).MODEL)
    rows = []
    for i, (left, right) in enumerate(pairs(args.pairs, tuple(args.size))):
        row = {"pair": i, "size": list(args.size), **compare(ports, flax, variables, left, right)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    summary = {k: {m: float(np.mean([r[k][m] for r in rows])) for m in rows[0][k]}
               for k in ("bf16_to_f32_px", "port_vs_flax_px", "head_input_port_vs_flax",
                         "topk_changed")}
    print(json.dumps({"summary": summary, "pairs": len(rows), "size": list(args.size)}))


if __name__ == "__main__":
    main()
