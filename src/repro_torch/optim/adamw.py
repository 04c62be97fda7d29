"""AdamW with f32 moments and a cosine LR schedule.

The counterpart of ``repro.optim.adamw``: the same config, schedule and
update, op for op, elementwise in f32 and cast back to each parameter's
dtype.  The moments are f32 whatever the parameter dtype (bf16-safe) and
each has its parameter's spec, so a sharded parameter would have sharded
moments.

The reference's train step donates the parameters and the optimizer
state (``donate_argnums=(0, 1)``), so XLA writes the update over them.
Here ``adamw_update`` does the same in place: it writes the new values
into the parameter, ``mu`` and ``nu`` tensors it is given and returns
those trees, so a rank holds one copy of its state.  A caller that needs
the old values keeps a copy first.  Each leaf's update allocates at most
two f32 temporaries of the leaf's size at a time.

Every scalar (the step, lr, the clip factor, the bias corrections) is a
0-d tensor on the parameters' device: nothing waits for the device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.grad_sync import tree_flatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine decay to a tenth of it
    (f32, the reference's op order)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def adamw_init(params) -> dict:
    """Zero f32 moments shaped like each parameter, and an int32 step 0."""
    leaves, rebuild = tree_flatten(params)
    zeros = lambda: rebuild([torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                         device=p.device) for p in leaves])
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device)}


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the f32 sum of squares of every leaf, leaves summed in
    flatten order."""
    leaves, _ = tree_flatten(tree)
    total = torch.square(leaves[0].to(torch.float32)).sum()
    for g in leaves[1:]:
        total = total + torch.square(g.to(torch.float32)).sum()
    return torch.sqrt(total)


def _sqrt_(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, in place, as the reference's.
    CUDA's ``sqrt`` is; torch's vectorized CPU ``sqrt`` is not (about 1 in
    170 results of a random f32 vector is 1 ulp off), and the f64 root
    rounded to f32 is (f64 has more than 2 * 24 + 2 bits)."""
    if x.device.type == "cpu":
        return x.copy_(x.double().sqrt_())
    return x.sqrt_()


def _update_leaf(p, g, mu, nu, cfg: AdamWConfig, lr, clip, b1c, b2c) -> None:
    """One leaf of the reference's ``upd``, written into p, mu and nu:

        g = f32(g) * clip
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        delta = (mu / b1c) / (sqrt(nu / b2c) + eps) + wd * f32(p)
        p = dtype(f32(p) - lr * delta)

    Each product and sum is its own op, rounded once, in that order (no
    fused multiply-add, no ``alpha=``, which a CUDA kernel would fuse)."""
    g = g.to(torch.float32) * clip
    mu.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    t = g * (1 - cfg.b2)
    nu.mul_(cfg.b2).add_(t.mul_(g))
    del g, t
    den = _sqrt_(nu / b2c).add_(cfg.eps)
    delta = (mu / b1c).div_(den)
    del den
    delta.add_(p.to(torch.float32) * cfg.weight_decay).mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(delta)
    else:
        p.copy_(p.to(torch.float32).sub_(delta))


def adamw_update(params, grads, state, cfg: AdamWConfig, *, grad_norm=None):
    """One AdamW step, in place (module docstring).  ``grad_norm`` may be
    passed in when the true global norm needs a cross-rank reduction (the
    caller sums it).  Returns ``(params, state, {"lr", "gnorm"})``: the
    same parameter and moment trees, updated, and a new step tensor."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gn = grad_norm if grad_norm is not None else _global_norm(grads)
    # grad_clip / max(gn, 1e-9) as a division (torch's ``scalar / tensor``
    # is a reciprocal times the scalar: another rounding)
    clip = torch.clamp(torch.full_like(gn, cfg.grad_clip) / torch.clamp(gn, min=1e-9),
                       max=1.0)
    b1c = 1.0 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1.0 - torch.pow(cfg.b2, step.to(torch.float32))
    flat_p, _ = tree_flatten(params)
    flat_g, _ = tree_flatten(grads)
    flat_mu, _ = tree_flatten(state["mu"])
    flat_nu, _ = tree_flatten(state["nu"])
    with torch.no_grad():
        for p, g, mu, nu in zip(flat_p, flat_g, flat_mu, flat_nu):
            _update_leaf(p, g, mu, nu, cfg, lr, clip, b1c, b2c)
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, \
        {"lr": lr, "gnorm": gn}
