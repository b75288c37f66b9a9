"""Optimizer, learning-rate schedule and gradient clip from an OPTIMIZATION
section: the port's copy of `openstereo_tpu/runtime/optim.py`.

It computes what the JAX package's optax chain computes,

    clip (by value | by global norm) → adamw | adam | sgd | rmsprop | lamb, lr = schedule(t),

with t the number of updates applied before this one (optax's count before
its increment). `torch.optim` and `torch.optim.lr_scheduler` are not used:
torch's OneCycleLR ends its phases one step earlier than
`optax.cosine_onecycle_schedule` and, with Adam, cycles beta1 as well;
`clip_grad_norm_` adds 1e-6 to the norm it divides by. AdamW decays every
parameter, BatchNorm scales and biases too, as optax's does. RMSprop is
optax's `rmsprop` with its defaults, not `torch.optim.RMSprop` (whose decay
is 0.99 and whose eps lies outside the square root). Lamb is optax's `lamb`
(Adam, decayed weights, a trust ratio per tensor), not the reference's
`stereo/utils/lamb.py`.

PARAM_GROUPS is ROADMAP item 8.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..config import Config

Schedule = Callable[[int], float]

_NOT_PORTED = "ROADMAP item 8"
B1, B2 = 0.9, 0.999  # optax's Adam defaults, which `_make_tx` (`optim.py:78`) keeps
RMS_DECAY = 0.9  # optax.rmsprop's default decay, which `_make_tx` (`optim.py:86`) keeps
_STATE = {"adamw": ("mu", "nu"), "adam": ("mu", "nu"), "sgd": ("trace",), "rmsprop": ("nu",),
          "lamb": ("mu", "nu")}
_DECAYED = ("adamw", "lamb")  # the optimizers that take WEIGHT_DECAY (`optim.py:82-89`)


# --------------------------------------------------------------- schedules
# Plain functions of the step, each the optax schedule `build_schedule`
# (`optim.py:26-75`) names, written out.

def constant_schedule(value: float) -> Schedule:
    return lambda step: float(value)


def cosine_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             div_factor: float = 25.0,
                             final_div_factor: float = 1e4) -> Schedule:
    """optax's: cosine from peak/div to peak over [0, int(pct_start·T)), then
    cosine down to peak/(div·final_div) over [int(pct_start·T), T), then flat."""
    bounds = np.array([0, int(pct_start * transition_steps), int(transition_steps)], np.float64)
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])
    sizes = bounds[1:] - bounds[:-1]

    def schedule(step: int) -> float:
        for i in range(2):
            if bounds[i] <= step < bounds[i + 1]:
                pct = (step - bounds[i]) / sizes[i]
                start, end = values[i], values[i + 1]
                return float(end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1))
        return float(values[-1]) if step >= bounds[-1] else 0.0

    return schedule


def piecewise_constant_schedule(init_value: float, boundaries_and_scales: Dict[int, float]
                                ) -> Schedule:
    """optax's: the value is scaled by each boundary's scale from that step on."""
    def schedule(step: int) -> float:
        v = init_value
        for threshold, scale in sorted(boundaries_and_scales.items()):
            if step >= threshold:
                v = v * scale
        return float(v)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    """optax's with alpha 0: half a cosine from init_value to 0, then 0."""
    def schedule(step: int) -> float:
        count = min(float(step), float(decay_steps))
        return float(init_value * 0.5 * (1 + math.cos(math.pi * count / decay_steps)))

    return schedule


def exponential_decay_staircase(init_value: float, transition_steps: int,
                                decay_rate: float) -> Schedule:
    """optax's `exponential_decay(..., staircase=True)`."""
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)

    def schedule(step: int) -> float:
        if step <= 0:
            return float(init_value)
        return float(init_value * decay_rate ** math.floor(step / transition_steps))

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax's: linear from init_value to end_value over transition_steps."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(step: int) -> float:
        count = min(max(step, 0), transition_steps)
        return float((init_value - end_value) * (1 - count / transition_steps) + end_value)

    return schedule


def _steps_per_epoch(opt_cfg: Config, total_steps: int) -> int:
    return max(1, total_steps // max(1, int(opt_cfg.NUM_EPOCHS)))


def build_schedule(opt_cfg: Config, total_steps: int) -> Schedule:
    """OPTIMIZATION → lr(step) (`optim.py:26-75`), TOTAL_STEPS = epochs × steps per epoch."""
    base_lr = float(opt_cfg.OPTIMIZER.LR)
    sched_cfg = opt_cfg.get("SCHEDULER", None)
    if sched_cfg is None:
        return constant_schedule(base_lr)
    name = sched_cfg.NAME
    if name == "OneCycleLR":
        # the warmup phase spans at least one step: a zero-width phase divides by zero
        pct_start = float(sched_cfg.get("PCT_START", 0.3))
        if total_steps > 1:
            pct_start = min(max(pct_start, 1.0 / total_steps), 1.0 - 1.0 / total_steps)
        sched = cosine_onecycle_schedule(
            total_steps, float(sched_cfg.get("MAX_LR", base_lr)), pct_start,
            float(sched_cfg.get("DIV_FACTOR", 25.0)), float(sched_cfg.get("FINAL_DIV_FACTOR", 1e4)))
    elif name == "MultiStepLR":
        unit = _steps_per_epoch(opt_cfg, total_steps) if bool(sched_cfg.get("ON_EPOCH", True)) else 1
        gamma = float(sched_cfg.get("GAMMA", 0.1))
        sched = piecewise_constant_schedule(
            base_lr, {int(m) * unit: gamma for m in sched_cfg.MILESTONES})
    elif name == "CosineAnnealingLR":
        sched = cosine_decay_schedule(base_lr, total_steps)
    elif name == "StepLR":
        size = int(sched_cfg.STEP_SIZE) * _steps_per_epoch(opt_cfg, total_steps)
        sched = exponential_decay_staircase(base_lr, size, float(sched_cfg.get("GAMMA", 0.1)))
    elif name == "ConstantLR":
        sched = constant_schedule(base_lr)
    else:
        raise ValueError(f"unknown scheduler {name!r}")

    warm_cfg = sched_cfg.get("WARMUP", None)
    if warm_cfg:
        warm_steps = int(warm_cfg.get("WARM_STEPS", 0)) or (
            int(warm_cfg.get("WARM_EPOCHS", 0)) * _steps_per_epoch(opt_cfg, total_steps))
        if warm_steps > 0:
            warmup, base = linear_schedule(0.0, 1.0, warm_steps), sched
            sched = lambda step: base(step) * warmup(step)  # noqa: E731
    return sched


# --------------------------------------------------------------- optimizer

def trust_ratio(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """optax's `scale_by_trust_ratio()` factor for one tensor: ‖p‖ / ‖u‖, or 1
    where either norm is 0 (a zero tensor, as a fresh BatchNorm bias)."""
    pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
    return torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)


class Optimizer:
    """clip → adamw | adam | sgd | rmsprop | lamb over named parameters, updated in place.

    Each step: the gradients are clipped (by value, or by their global norm:
    t / ‖g‖ · max_norm when ‖g‖ ≥ max_norm, with no epsilon), then
    - adamw/adam: mu = (1-b1)·g + b1·mu, nu = (1-b2)·g² + b2·nu,
      u = mu/(1-b1^n) / (sqrt(nu/(1-b2^n)) + eps) [+ wd·p for adamw],
    - sgd: u = g + momentum·u_prev (optax's trace),
    - rmsprop: nu = (1-d)·g² + d·nu, u = g·rsqrt(nu + eps) with d = 0.9 (optax
      0.2.6's `rmsprop` defaults: eps inside the root, nu starts at 0, no
      momentum, no centering, no bias correction),
    - lamb: optax 0.2.6's `lamb` chain: Adam's u as above (eps outside the
      root, eps_root 0), + wd·p on every tensor, then per tensor
      u·‖p‖/‖u‖, the ratio 1 where either norm is 0 (`scale_by_trust_ratio`),
    and p += -lr(t)·u, with n = t + 1 and t the updates applied so far.
    Parameters change in place (their version counters move), so caches
    keyed on a parameter's version see every update.
    """

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]], name: str,
                 schedule: Schedule, weight_decay: float = 0.0, eps: float = 1e-8,
                 momentum: float = 0.0, clip: Optional[Tuple[str, float]] = None):
        if name not in _STATE:
            raise ValueError(f"unknown optimizer {name!r}")
        if clip is not None and clip[0] not in ("value", "norm"):
            raise ValueError(clip[0])
        self.params = dict(named_params)
        self.name, self.schedule, self.clip = name, schedule, clip
        self.weight_decay = weight_decay if name in _DECAYED else 0.0
        self.eps, self.momentum = eps, momentum
        self.count = 0
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        for k, p in self.params.items():
            self.state[k] = {s: torch.zeros_like(p, memory_format=torch.preserve_format)
                             for s in _STATE[name]}

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def _clipped(self) -> Dict[str, torch.Tensor]:
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in self.params.items()}
        if self.clip is None:
            return grads
        kind, limit = self.clip
        if kind == "value":
            return {k: g.clamp(-limit, limit) for k, g in grads.items()}
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
        if bool(norm < limit):
            return grads
        return {k: g / norm.to(g.dtype) * limit for k, g in grads.items()}

    @torch.no_grad()
    def step(self) -> None:
        grads = self._clipped()
        lr = self.schedule(self.count)
        n = self.count + 1
        for k, p in self.params.items():
            g, st = grads[k], self.state[k]
            if self.name == "sgd":
                st["trace"].mul_(self.momentum).add_(g)
                u = st["trace"]
            elif self.name == "rmsprop":
                st["nu"].copy_((1 - RMS_DECAY) * g * g + RMS_DECAY * st["nu"])
                u = g * torch.rsqrt(st["nu"] + self.eps)
            else:
                st["mu"].copy_((1 - B1) * g + B1 * st["mu"])
                st["nu"].copy_((1 - B2) * g * g + B2 * st["nu"])
                mu_hat = st["mu"] / (1 - B1 ** n)
                nu_hat = st["nu"] / (1 - B2 ** n)
                u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
                if self.weight_decay:
                    u = u + self.weight_decay * p
                if self.name == "lamb":
                    u = u * trust_ratio(p, u)
            p.add_(u, alpha=-lr)
        self.count = n

    def state_dict(self) -> Dict:
        return {"name": self.name, "count": self.count,
                "state": {k: {s: t.detach().clone() for s, t in st.items()}
                          for k, st in self.state.items()}}

    def load_state_dict(self, sd: Dict) -> None:
        if sd["name"] != self.name or set(sd["state"]) != set(self.state):
            raise ValueError("optimizer state of another optimizer or parameter set")
        with torch.no_grad():
            for k, st in self.state.items():
                for s, t in st.items():
                    t.copy_(sd["state"][k][s])
        self.count = int(sd["count"])


def build_optimizer(opt_cfg: Config, total_steps: int,
                    named_params: Iterable[Tuple[str, torch.nn.Parameter]]
                    ) -> Tuple[Optimizer, Schedule]:
    """OPTIMIZATION section → (optimizer, lr schedule) (`optim.py:145`)."""
    schedule = build_schedule(opt_cfg, total_steps)
    ocfg = opt_cfg.OPTIMIZER
    if ocfg.get("PARAM_GROUPS", None):
        raise NotImplementedError(f"OPTIMIZER.PARAM_GROUPS is {_NOT_PORTED}")
    clip = None
    clip_cfg = opt_cfg.get("CLIP_GRAD", None)
    if clip_cfg:
        ctype = clip_cfg.get("TYPE", "norm")
        if ctype == "value":
            clip = ("value", float(clip_cfg.CLIP_VALUE))
        elif ctype == "norm":
            clip = ("norm", float(clip_cfg.MAX_NORM))
        else:
            raise ValueError(ctype)
    opt = Optimizer(named_params, ocfg.NAME.lower(), schedule,
                    weight_decay=float(ocfg.get("WEIGHT_DECAY", 0.0)),
                    eps=float(ocfg.get("EPS", 1e-8)), momentum=float(ocfg.get("MOMENTUM", 0.0)),
                    clip=clip)
    return opt, schedule
