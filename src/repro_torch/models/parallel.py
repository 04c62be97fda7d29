"""Parallelism context + parameter-definition machinery.

The counterpart of ``repro.models.parallel``.  ``ParallelCtx`` keeps the
reference's fields.  ``fsdp_size > 1`` shards the weights over
``fsdp_axis`` (ZeRO-3): ``gather`` moves the leaf's sharded dim to the
front, gathers it (``core/grad_sync.fsdp_gather``: the train step's
``FsdpStep`` inside a step, else ``fsdp_all_gather``, whose backward is
the reduce-scatter, optionally compressed through ``fsdp_sync``) and
moves it back.  ``tp_size > 1`` (tensor parallelism, ROADMAP A11.7)
raises, so ``tp_reduce`` is the identity.

``ParamDef`` carries the GLOBAL shape, the reference's partition spec (a
tuple of mesh axis names, ``None`` for a replicated dim) and an init.
``init_params`` draws the same distributions from a ``torch.Generator``;
it does not reproduce JAX's random bits (tests carry weights across with
``convert.params_from_jax`` instead).  A leaf of more than ``SLAB``
elements (the moe configs' stacked experts: 12 B elements at 29 layers)
is drawn slab by slab along its first dim: an f32 draw of it whole would
need twice its bf16 bytes beside it.  Every leaf of the other models run
on the card (minitron-8b's 2.1 B-element MLP stacks the largest) is below
``SLAB`` and drawn whole.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.convert import tree_map
from repro_torch.core.grad_sync import SyncConfig, fsdp_gather
from repro_torch.core.transport import resolve_device

__all__ = ["ParallelCtx", "ParamDef", "init_params", "param_specs", "param_shapes",
           "torch_dtype", "SLAB"]

SLAB = 1 << 32  # elements: a larger leaf is drawn one slab of dim 0 at a time


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """Static description of how the mesh axes are used (one card here)."""

    tp_axis: str = "model"
    fsdp_axis: str = "data"
    dp_axes: tuple = ("data",)
    tp_size: int = 1
    fsdp_size: int = 1
    # gZ compression on the FSDP gather / reduce-scatter path
    fsdp_sync: Optional[SyncConfig] = None
    # remat policy for the per-layer loop ("none" | "full" | "dots"; the
    # last two alike, as in the reference): Model._backbone checkpoints
    # each layer when grad mode is on
    remat: str = "full"
    scan_unroll: int = 1

    def __post_init__(self):
        if self.tp_size > 1:
            raise NotImplementedError(
                "tensor parallelism (tp_size > 1) is not ported yet: ROADMAP A11.7")

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """FSDP all-gather of a parameter along ``dim`` (identity at 1)."""
        if self.fsdp_size == 1:
            return x
        return fsdp_gather(x, dim, self.fsdp_axis, self.fsdp_sync)

    def tp_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Row-parallel output reduction: the identity at 1."""
        return x

    def tp_index(self) -> int:
        return 0


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Global-view definition of one parameter tensor."""

    shape: tuple
    spec: tuple
    init: str = "normal"  # normal | zeros | ones | scaled
    scale: float = 0.02
    dtype: str = "bfloat16"

    def initializer(self, generator: torch.Generator, device) -> torch.Tensor:
        dt = torch_dtype(self.dtype)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt, device=device)
        if self.init == "scaled":
            fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
            scale = float(np.float32(1.0 / np.sqrt(fan_in)))
        else:
            scale = self.scale

        def draw(shape):
            x = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
            return x.mul_(scale).to(dt)

        if math.prod(self.shape) <= SLAB:
            return draw(self.shape)
        out = torch.empty(self.shape, dtype=dt, device=device)
        for i in range(self.shape[0]):
            out[i] = draw(self.shape[1:])
        return out


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def init_params(defs, generator: torch.Generator, device="cuda"):
    """Materialize a ParamDef tree into (global) tensors on ``device``,
    each leaf drawn in turn (the tree's order) from ``generator``, which
    must live on that device.  CUDA without a card raises."""
    device = resolve_device(device)
    return tree_map(lambda d: d.initializer(generator, device), defs)


def param_specs(defs):
    """Each parameter's partition spec (a tuple of axis names and None)."""
    return tree_map(lambda d: d.spec, defs)


def param_shapes(defs):
    """Meta tensors with each parameter's shape and dtype (no allocation)."""
    return tree_map(
        lambda d: torch.empty(d.shape, dtype=torch_dtype(d.dtype), device="meta"), defs)
