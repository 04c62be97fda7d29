"""Carry state between the JAX package and the port.

The collective layer holds no weights; its state is the wire container
and the plan.  Both cross as plain numpy/Python values, so a stream made
by either package decodes bitwise in the other and two plans compare
field by field:

  * ``compressed_to_numpy(c)`` / ``compressed_from_numpy(d, device)`` —
    a ``Compressed`` as a dict of numpy arrays (``packed`` as uint32
    words, ``bitwidth``/``anchor`` int32, ``nwords`` int32, ``eb``
    float32) plus ``n`` and ``block``.  ``compressed_to_numpy`` also
    accepts the JAX package's container: it only reads the attributes.
  * ``plan_fields(plan)`` — every field of a ``Plan`` or ``HierPlan``
    (either package's) as plain Python, with the route table and the
    fallback plan as nested tuples and a ``HierPlan``'s sub-plans as
    nested dicts.
  * ``tree_from_numpy(tree, device)`` / ``tree_to_numpy(tree)`` — a
    gradient tree (nested dicts, lists and tuples of arrays) with numpy
    leaves as the same tree with tensor leaves on ``device``, and back.
  * ``params_from_jax(tree, device)`` / ``params_to_numpy(tree)`` — a
    model's parameter tree.  JAX's bf16 leaves arrive as numpy arrays of
    ``ml_dtypes``' bfloat16, which ``torch.from_numpy`` refuses: they cross
    as their 16-bit patterns (``.view(np.int16)`` then
    ``.view(torch.bfloat16)``), bit for bit; f32 leaves cross as they are.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.compressed import Compressed
from repro_torch.core.transport import resolve_device

__all__ = ["compressed_to_numpy", "compressed_from_numpy", "plan_fields",
           "tree_map", "tree_from_numpy", "tree_to_numpy", "params_from_jax",
           "params_to_numpy"]


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def compressed_to_numpy(c) -> dict:
    """A ``Compressed`` (either package's) -> dict of numpy values."""
    return {
        "packed": np.ascontiguousarray(_np(c.packed)).view(np.uint32),
        "bitwidth": _np(c.bitwidth).astype(np.int32),
        "anchor": _np(c.anchor).astype(np.int32),
        "nwords": np.int32(_np(c.nwords)),
        "eb": np.float32(_np(c.eb)),
        "n": int(c.n),
        "block": int(c.block),
    }


def compressed_from_numpy(d: dict, device="cuda") -> Compressed:
    """dict of numpy values (``compressed_to_numpy``'s layout) -> the
    port's ``Compressed`` on ``device``; CUDA without a card raises."""
    device = resolve_device(device)

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    packed = np.ascontiguousarray(np.asarray(d["packed"], np.uint32)).view(np.int32)
    return Compressed(
        packed=t(packed, np.int32),
        bitwidth=t(d["bitwidth"], np.int32),
        anchor=t(d["anchor"], np.int32),
        nwords=t(d["nwords"], np.int32).reshape(()),
        eb=t(d["eb"], np.float32).reshape(()),
        n=int(d["n"]),
        block=int(d["block"]),
    )


def _schedule_tuple(s):
    if s is None:
        return None
    rounds = tuple(
        tuple((h.sender, h.receiver, tuple(h.chunk_slab), h.stage, h.payload_kind)
              for h in rnd)
        for rnd in s.rounds
    )
    return (s.op, s.algo, s.n, s.n_chunks, rounds, tuple(s.combine),
            s.initial_lossy)


def plan_fields(plan) -> dict:
    """Every field of a ``Plan`` or ``HierPlan`` as comparable plain
    Python (a ``HierPlan``'s sub-plans as their own fields)."""
    out = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if f.name == "route_table":
            v = _schedule_tuple(v)
        elif f.name == "fallback" and v is not None:
            v = tuple(getattr(v, g.name) for g in dataclasses.fields(v))
        elif f.name in ("inter", "flat_plan") and v is not None:
            v = plan_fields(v)
        out[f.name] = v
    return out


def tree_map(fn, tree):
    """``fn`` on every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_from_numpy(tree, device="cuda"):
    """A tree of numpy arrays (or anything ``np.asarray`` takes) -> the same
    tree of tensors on ``device``; CUDA without a card raises."""
    device = resolve_device(device)
    return tree_map(
        lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(device), tree)


def tree_to_numpy(tree):
    """A tree of tensors (or arrays of either package) -> numpy leaves."""
    return tree_map(_np, tree)


def _param_tensor(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:  # JAX's buffers are read-only; torch wants its own
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device="cuda"):
    """A parameter tree with numpy leaves (JAX's arrays through
    ``np.asarray``; bf16 as ``ml_dtypes.bfloat16``) -> the same tree of
    tensors on ``device``, bf16 bit for bit; CUDA without a card raises."""
    device = resolve_device(device)
    return tree_map(lambda a: _param_tensor(a, device), tree)


def _param_array(t) -> np.ndarray:
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        bits = t.detach().cpu().contiguous().view(torch.int16).numpy()
        try:
            return bits.view(np.dtype("bfloat16"))
        except TypeError:  # no bfloat16 registered with numpy: widen exactly
            return t.detach().cpu().to(torch.float32).numpy()
    return _np(t)


def params_to_numpy(tree):
    """A tree of tensors -> numpy leaves.  bf16 leaves become numpy
    bfloat16 arrays with the same bits where that dtype is registered with
    numpy (``ml_dtypes``, which JAX imports), else exact f32."""
    return tree_map(_param_array, tree)
