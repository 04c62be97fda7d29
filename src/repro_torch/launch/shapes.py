"""The assigned input shapes, and the per-leaf shapes and specs of a train
batch and a decode step.

The counterpart of ``repro.launch.shapes``.  ``INPUT_SHAPES`` are the four
assigned (seq_len, global_batch) points; decode shapes run ``serve_step``
(one token against a seq_len KV cache), and ``long_500k`` runs attention
archs on the sliding-window variant (``LONG_WINDOW``).  Shapes only,
nothing is allocated: a leaf is a tensor on the ``meta`` device (shape and
dtype, no storage), a spec a tuple with one entry per dim (an axis name,
a tuple of axis names, or None for a replicated dim).  A mesh is anything
with ``axis_names`` and ``shape`` (``launch/mesh.py``).

A decode batch that fills the data axes is split over them (each cache
entry's batch dim); one that cannot (the ``long_500k`` shape's batch of 1
on any mesh with ``data > 1``) is whole on every rank, and the k and v
caches' context dim is split over ``data`` instead (``KVCacheSpec.cp_size
> 1``, the flash-decoding combine of ``models/attention.py``): the
entries with no context dim (the MLA latent keeps ``s_total``, the conv
and SSD states, ``enc_out``) are then replicated over ``data``, and the
tokens too.  The port's ``Model`` defines the dense, vlm, audio and moe
families' cache (k and v, their kv heads over model), MLA's (mla: the
latent and rope-key rows, f32, replicated over model), the ssm family's
(conv_x, its channels over model; conv_bc, replicated; the SSD state ssm,
its heads over model; all f32), the hybrid's (both) and the encdec's (k,
v and the encoder's output enc_out, f32, its batch on dim 0, replicated
over model).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.convert import tree_map
from repro_torch.launch.mesh import dp_axes_of, mesh_axis_sizes
from repro_torch.models.attention import KVCacheSpec
from repro_torch.models.config import ModelConfig

__all__ = ["InputShape", "INPUT_SHAPES", "LONG_WINDOW", "train_specs", "decode_plan",
           "decode_specs"]

LONG_WINDOW = 8192


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "train"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_tree(cfg: ModelConfig, b: int, s: int) -> dict:
    s_text = s - (cfg.n_prefix if cfg.family in ("vlm", "audio") else 0)
    tree = {"tokens": _meta((b, s_text), torch.int32),
            "labels": _meta((b, s_text), torch.int32)}
    if cfg.family in ("vlm", "audio") and cfg.n_prefix:
        tree["prefix"] = _meta((b, cfg.n_prefix, cfg.d_model), torch.float32)
    if cfg.family == "encdec":
        tree["enc_input"] = _meta((b, cfg.n_prefix, cfg.d_model), torch.float32)
    return tree


def _axes_entry(axes: tuple):
    """A spec entry over ``axes``, normalized as ``PartitionSpec`` does:
    None for no axis, the bare name for one, the tuple for several."""
    return None if not axes else axes[0] if len(axes) == 1 else axes


def train_specs(cfg: ModelConfig, shape: InputShape, mesh):
    """(batch leaves, batch specs) for a train shape: the global batch's
    leading dim over the data-parallel axes, every other dim replicated."""
    dp = _axes_entry(dp_axes_of(mesh))
    tree = _batch_tree(cfg, shape.global_batch, shape.seq_len)
    specs = tree_map(lambda a: (dp,) + (None,) * (a.dim() - 1), tree)
    return tree, specs


def decode_plan(cfg: ModelConfig, shape: InputShape, mesh) -> KVCacheSpec:
    """Batch-sharded cache, or the context split over ``data`` when the
    batch cannot fill the data axes (module docstring)."""
    sizes = mesh_axis_sizes(mesh)
    dp_total = sizes.get("data", 1) * sizes.get("pod", 1)
    window = 0
    if shape.seq_len > 100_000 and cfg.family not in ("ssm",):
        window = LONG_WINDOW  # sub-quadratic sliding-window variant
    if shape.global_batch >= dp_total:
        return KVCacheSpec(s_total=shape.seq_len, cp_axis=None, cp_size=1, window=window)
    return KVCacheSpec(s_total=shape.seq_len, cp_axis="data", cp_size=sizes.get("data", 1),
                       window=window)


def decode_specs(cfg: ModelConfig, shape: InputShape, mesh, model,
                 cache_dtype=torch.float32):
    """(cache leaves, cache specs, tokens, tokens spec, plan) for
    ``serve_step``, with GLOBAL shapes (the batch whole).  ``cache_dtype``
    applies to k and v; the MLA latent, the conv and SSD states and the
    encoder's output are f32."""
    sizes = mesh_axis_sizes(mesh)
    dp = dp_axes_of(mesh)
    dp_total = 1
    for ax in dp:
        dp_total *= sizes[ax]
    plan = decode_plan(cfg, shape, mesh)
    tp = sizes.get("model", 1)
    batch_sharded = plan.cp_axis is None
    local = model.cache_defs(shape.global_batch // dp_total if batch_sharded
                             else shape.global_batch, plan)
    cache, specs = {}, {}
    for k, shp in local.items():
        if k not in ("k", "v", "mla", "conv_x", "conv_bc", "ssm", "enc_out"):
            raise ValueError(f"cache entry {k!r}: not one of the reference's")
        # the batch (dim 1; enc_out's dim 0) over dp, or under the context
        # split k and v's context (dim 2) over data; k and v's kv heads
        # (dim 3), conv_x's channels (last) and the SSD state's heads (dim 2)
        # over model (the MLA latent has no model dim: it is replicated over
        # TP)
        shp = list(shp)
        spec = [None] * len(shp)
        if batch_sharded:
            b_dim = 0 if k == "enc_out" else 1
            shp[b_dim] *= dp_total
            spec[b_dim] = _axes_entry(dp)
        elif k in ("k", "v"):
            shp[2] *= plan.cp_size
            spec[2] = "data"
        tp_dim = {"k": 3, "v": 3, "conv_x": len(shp) - 1, "ssm": 2}.get(k)
        if tp_dim is not None:
            shp[tp_dim] *= tp
            spec[tp_dim] = "model"
        cache[k] = _meta(tuple(shp), cache_dtype if k in ("k", "v") else torch.float32)
        specs[k] = tuple(spec)
    tokens = _meta((shape.global_batch, 1), torch.int32)
    tokens_spec = (_axes_entry(dp), None) if batch_sharded else (None, None)
    return cache, specs, tokens, tokens_spec, plan
