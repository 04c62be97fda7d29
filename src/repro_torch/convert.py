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
  * ``plan_fields(plan)`` — every field of a ``Plan`` (either package's)
    as plain Python, with the route table and the fallback plan as
    nested tuples.
  * ``tree_from_numpy(tree, device)`` / ``tree_to_numpy(tree)`` — a
    gradient tree (nested dicts, lists and tuples of arrays) with numpy
    leaves as the same tree with tensor leaves on ``device``, and back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.compressed import Compressed
from repro_torch.core.transport import resolve_device

__all__ = ["compressed_to_numpy", "compressed_from_numpy", "plan_fields",
           "tree_from_numpy", "tree_to_numpy"]


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
    """Every field of a ``Plan`` as comparable plain Python."""
    out = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if f.name == "route_table":
            v = _schedule_tuple(v)
        elif f.name == "fallback" and v is not None:
            v = tuple(getattr(v, g.name) for g in dataclasses.fields(v))
        out[f.name] = v
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_from_numpy(tree, device="cuda"):
    """A tree of numpy arrays (or anything ``np.asarray`` takes) -> the same
    tree of tensors on ``device``; CUDA without a card raises."""
    device = resolve_device(device)
    return _tree_map(
        lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(device), tree)


def tree_to_numpy(tree):
    """A tree of tensors (or arrays of either package) -> numpy leaves."""
    return _tree_map(_np, tree)
