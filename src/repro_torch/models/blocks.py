"""Per-block ParamDef trees and apply functions of the dense family.

The counterpart of the dense half of ``repro.models.blocks``.  Shapes are
GLOBAL; the specs keep the reference's TP ("model") and FSDP ("data")
placement for when those axes are ported.  A leading L dim (stacked
layers) is added by ``model.py``.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.parallel import ParallelCtx, ParamDef

__all__ = ["attn_defs", "mlp_defs", "norm_def", "dense_block"]


def _pd(shape, spec, init="scaled", dtype="bfloat16"):
    return ParamDef(shape=tuple(shape), spec=spec, init=init, dtype=dtype)


def attn_defs(cfg: ModelConfig, tp: int) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    hp = cfg.padded_heads(tp)
    return {
        "wq": _pd((d, hp * hd), ("data", "model")),
        "wk": _pd((d, cfg.n_kv_heads * hd), ("data", None)),
        "wv": _pd((d, cfg.n_kv_heads * hd), ("data", None)),
        "wo": _pd((hp * hd, d), ("model", "data")),
    }


def mlp_defs(cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "wi": _pd((d, ff), ("data", "model")),
        "wg": _pd((d, ff), ("data", "model")),
        "wo": _pd((ff, d), ("model", "data")),
    }


def norm_def(cfg: ModelConfig) -> ParamDef:
    return ParamDef(shape=(cfg.d_model,), spec=(None,), init="ones")


def _mlp(h, w, ctx: ParallelCtx, reduce: bool = True):
    """SwiGLU; the gate's sigmoid is taken in f32 and cast back."""
    wi = ctx.gather(w["wi"], dim=0)
    wg = ctx.gather(w["wg"], dim=0)
    wo = ctx.gather(w["wo"], dim=1)
    a = torch.matmul(h, wg)
    a = a * torch.sigmoid(a.to(torch.float32)).to(a.dtype)
    b = torch.matmul(h, wi)
    out = torch.matmul(a * b, wo)
    return ctx.tp_reduce(out) if reduce else out


def dense_block(h, w, cfg: ModelConfig, ctx: ParallelCtx, *, positions,
                causal=True, window=0, cross_kv=None):
    """Pre-norm attention + SwiGLU MLP block.

    With cfg.parallel_block (PaLM-style): attention and MLP partials are
    summed BEFORE one shared TP reduction.
    """
    if cfg.parallel_block and cross_kv is None:
        a = attention.attention_train(
            rms_norm(h, w["ln1"], cfg.norm_eps), w["attn"], cfg, ctx,
            positions=positions, causal=causal, window=window, reduce=False,
        )
        m = _mlp(rms_norm(h, w["ln2"], cfg.norm_eps), w["mlp"], ctx, reduce=False)
        return h + ctx.tp_reduce(a + m)
    a = attention.attention_train(
        rms_norm(h, w["ln1"], cfg.norm_eps), w["attn"], cfg, ctx,
        positions=positions, causal=causal, window=window,
    )
    h = h + a
    if cross_kv is not None:
        c = attention.attention_train(
            rms_norm(h, w["ln_cross"], cfg.norm_eps), w["cross"], cfg, ctx,
            positions=positions, causal=False, cross_kv=cross_kv,
        )
        h = h + c
    m = _mlp(rms_norm(h, w["ln2"], cfg.norm_eps), w["mlp"], ctx)
    return h + m
