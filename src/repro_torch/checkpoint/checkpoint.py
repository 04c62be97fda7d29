"""Checkpoints of a tree of tensors on the local filesystem, one ``.npy``
per leaf.

The counterpart of ``repro.checkpoint.checkpoint``, file for file, so
that either package restores what the other saved: a directory
``step_%08d`` under ``ckpt_dir`` holds each leaf as ``<key>.npy`` and a
``manifest.json`` of ``{"step", "leaves": {key: {"shape", "dtype"}}}``.
A leaf's key is the reference's: ``jax.tree_util.keystr`` of its path
(``['params']['blocks']['attn']['wq']``, ``[0]`` for a list or tuple
index) with every run of characters outside ``[A-Za-z0-9_.-]`` turned
into ``_`` and the ends stripped, so ``params_blocks_attn_wq``.  Trees are
nested dicts, lists and tuples, walked in ``jax.tree.flatten``'s order
(dict keys sorted).  bf16 goes to disk as its 16-bit pattern (``uint16``)
with dtype ``"bfloat16"`` in the manifest, and comes back through
``Tensor.view``: numpy has no bfloat16 of its own.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from repro_torch.core.transport import resolve_device

__all__ = ["save", "restore", "latest_step", "step_dir"]


def _paths(tree, prefix=()):
    """[(path, leaf)] in flatten order; a path is a tuple of dict keys and
    sequence indices."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in _paths(v, prefix + (i,))]
    return [(prefix, tree)]


def _key(path) -> str:
    """``keystr`` of the path (``[repr(key)]`` per dict key, ``[i]`` per
    index), sanitized as the reference does."""
    s = "".join(f"[{k}]" if isinstance(k, int) else f"[{k!r}]" for k in path)
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", s).strip("_")


def _rebuild(tree, leaves: dict, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, prefix + (i,)) for i, v in enumerate(tree))
    return leaves[prefix]


def step_dir(ckpt_dir: str, step: int) -> str:
    """The directory of checkpoint ``step`` under ``ckpt_dir``."""
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save(ckpt_dir: str, step: int, tree) -> str:
    """Write ``tree`` (tensors, or anything ``np.asarray`` takes) as
    checkpoint ``step``; returns its directory."""
    d = step_dir(ckpt_dir, step)
    os.makedirs(d, exist_ok=True)
    manifest = {}
    for path, leaf in _paths(tree):
        k = _key(path)
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                arr, dtype = t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
            else:
                arr = t.numpy()
                dtype = str(arr.dtype)
        else:
            arr = np.asarray(leaf)
            dtype = str(arr.dtype)
            if dtype == "bfloat16":
                arr = arr.view(np.uint16)
        np.save(os.path.join(d, k + ".npy"), arr)
        manifest[k] = {"shape": list(arr.shape), "dtype": dtype}
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f, indent=1)
    return d


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(n.split("_")[1]) for n in os.listdir(ckpt_dir) if n.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like, device="cuda"):
    """Read checkpoint ``step`` into a tree shaped like ``like`` (tensors
    or arrays: only the structure and each leaf's shape are read), as
    tensors on ``device`` (CUDA without a card raises).  A leaf whose
    shape differs from ``like``'s raises."""
    device = resolve_device(device)
    d = step_dir(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    out = {}
    for path, leaf in _paths(like):
        k = _key(path)
        arr = np.load(os.path.join(d, k + ".npy"))
        want = tuple(np.shape(leaf))
        if tuple(arr.shape) != want:
            raise ValueError(f"{k}: ckpt {arr.shape} != live {want}")
        if manifest[k]["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out[path] = t.to(device)
    return _rebuild(like, out)
