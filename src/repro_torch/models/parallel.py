"""Parallelism context + parameter-definition machinery.

The counterpart of ``repro.models.parallel``.  ``ParallelCtx`` keeps the
reference's fields.  Model code is rank-centric: it runs on every rank of
a mesh (``launch/mesh.py``) with that rank's LOCAL blocks of the
parameters, and reaches the other ranks through the handles bound on its
thread (``core/transport.py``).

  * ``fsdp_size > 1`` shards the weights over ``fsdp_axis`` (ZeRO-3):
    ``gather`` moves the leaf's sharded dim to the front, gathers it
    (``core/grad_sync.fsdp_gather``: the train step's ``FsdpStep`` inside
    a step, else ``fsdp_all_gather``, whose backward is the
    reduce-scatter, optionally compressed through ``fsdp_sync``) and
    moves it back.
  * ``tp_size > 1`` is Megatron-style tensor parallelism over ``tp_axis``
    (ROADMAP A11.7): ``tp_reduce`` is the reference's ``lax.psum``, the
    f32 sum of every rank's tensor in rank order rounded once to its
    dtype (what XLA's CPU all-reduce gives); ``tp_max``, ``tp_all_to_all``
    and ``tp_all_gather`` are its ``lax.pmax``, untiled ``lax.all_to_all``
    and tiled ``lax.all_gather``; ``tp_index`` is the rank's coordinate on
    ``tp_axis``.  Under grad, with an input that requires grad, each but
    ``tp_max`` (whose result carries no gradient, as the reference stops
    it) is an ``autograd.Function`` whose backward is the transposed
    collective: the psum of the cotangent, the same all-to-all, the
    reduce-scatter, on the handle the forward captured (never the one
    bound where backward runs).  A ``ThreadGroup`` rank's backward runs
    only on the rank's own thread: on a one-card ``ThreadGroup`` the
    autograd engine runs CUDA backward nodes on its device thread, where
    the ranks could never meet (ROADMAP C6), so there it raises instead of
    hanging or taking a wrong gradient.  A ``DistGroup`` rank's backward
    runs on any thread of its process: ``transport.DistMesh`` (one process
    per rank; over gloo the card's tensors stage through the host) is the
    TP train step's route on the card (``launch/training.py``).

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
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.convert import tree_map
from repro_torch.core import transport
from repro_torch.core.grad_sync import SyncConfig, fsdp_gather
from repro_torch.core.transport import resolve_device

__all__ = ["ParallelCtx", "ParamDef", "init_params", "param_specs", "param_shapes",
           "torch_dtype", "SLAB"]

SLAB = 1 << 32  # elements: a larger leaf is drawn one slab of dim 0 at a time


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """Static description of how the mesh axes are used."""

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

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """FSDP all-gather of a parameter along ``dim`` (identity at 1)."""
        if self.fsdp_size == 1:
            return x
        return fsdp_gather(x, dim, self.fsdp_axis, self.fsdp_sync)

    def _tp_handle(self):
        """This thread's rank of ``tp_axis``, checked against ``tp_size``."""
        h = transport.current(self.tp_axis)
        if h.size != self.tp_size:
            raise ValueError(f"ParallelCtx(tp_size={self.tp_size}) but the group bound to "
                             f"{self.tp_axis!r} has {h.size} ranks")
        return h

    def _tp_collective(self, x, what, fwd, bwd):
        h = self._tp_handle()
        if torch.is_grad_enabled() and x.requires_grad:
            return _TPCollective.apply(x, h, what, fwd, bwd)
        return fwd(h, x)

    def tp_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Row-parallel output reduction (``lax.psum`` over ``tp_axis``):
        the f32 sum in rank order, rounded once to ``x``'s dtype; the
        identity at 1."""
        if self.tp_size == 1:
            return x
        return self._tp_collective(x, "tp_reduce", _psum, _psum)

    def tp_max(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max over ``tp_axis`` (``lax.pmax``), no gradient."""
        if self.tp_size == 1:
            return x
        return self._tp_handle().max_across(x.detach())

    def tp_all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.all_to_all`` over ``tp_axis``, untiled on dim 0: slot i of
        the result is what rank i passed in its slot ``tp_index()``."""
        return self._tp_collective(x, "tp_all_to_all", _all_to_all, _all_to_all)

    def tp_all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``lax.all_gather(..., tiled=True)`` over ``tp_axis`` along
        ``dim``: every rank's ``x`` concatenated in rank order."""
        if self.tp_size == 1:
            return x
        return self._tp_collective(
            x, "tp_all_gather", lambda h, t: torch.cat(h.all_gather((t,))[0].unbind(0), dim),
            lambda h, g: _psum(h, g).chunk(h.size, dim)[h.rank])

    def tp_index(self) -> int:
        """This rank's coordinate on ``tp_axis`` (0 at 1)."""
        return self._tp_handle().rank if self.tp_size > 1 else 0


def _psum(h, x):
    return h.sum_across(x.to(torch.float32)).to(x.dtype)


def _all_to_all(h, x):
    return h.all_to_all((x.contiguous(),))[0]


class _TPCollective(torch.autograd.Function):
    """A TP collective with its transposed collective as the backward,
    which runs only on the rank's own thread (module docstring)."""

    @staticmethod
    def forward(ctx, x, handle, what, fwd, bwd):
        ctx.handle, ctx.what, ctx.bwd = handle, what, bwd
        return fwd(handle, x)

    @staticmethod
    def backward(ctx, g):
        thread = getattr(ctx.handle, "thread", None)
        if thread is not None and thread is not threading.current_thread():
            raise RuntimeError(
                f"{ctx.what} backward of ThreadGroup rank {ctx.handle.rank} runs on thread "
                f"{threading.current_thread().name!r}, not on the rank's own thread (the "
                "autograd engine runs CUDA backward nodes on a device thread), so the "
                "ranks' exchanges cannot meet (ROADMAP C6); take tensor-parallel gradients "
                "through a transport.DistMesh, one process per rank (DistGroup handles), "
                "where launch.training.make_train_step runs at tp > 1")
        return ctx.bwd(ctx.handle, g), None, None, None, None


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
