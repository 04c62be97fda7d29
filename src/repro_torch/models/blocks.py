"""Per-block ParamDef trees and apply functions of the dense (GQA and
MLA), moe, ssm and hybrid families.

The counterpart of ``repro.models.blocks`` for those families.  Shapes
are GLOBAL and the specs the reference's TP ("model") and FSDP ("data")
placement; the apply functions take a rank's LOCAL blocks (column-parallel
``wq``/``wi``/``wg``, row-parallel ``wo`` with its partial sums reduced
over TP, experts sharded over TP on their expert dim).  A leading L dim
(stacked layers) is added by ``model.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core.collectives import GZConfig
from repro_torch.core.comm import GZCommunicator
from repro_torch.models import attention, mla, moe, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.parallel import ParallelCtx, ParamDef

__all__ = ["attn_defs", "mlp_defs", "moe_defs", "ssm_defs", "mla_defs", "norm_def",
           "dense_block", "moe_block", "ssm_block", "mla_block", "dispatch_comm"]


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


def moe_defs(cfg: ModelConfig) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": _pd((d, e), ("data", None)),
        "wi": _pd((e, d, ff), ("model", "data", None)),
        "wg": _pd((e, d, ff), ("model", "data", None)),
        "wo": _pd((e, ff, d), ("model", None, "data")),
    }


def ssm_defs(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    h = s.n_heads(d)
    w = s.conv_width
    return {
        "w_z": _pd((d, di), ("data", "model")),
        "w_x": _pd((d, di), ("data", "model")),
        "w_bc": _pd((d, 2 * s.d_state), ("data", None)),
        "w_dt": _pd((d, h), ("data", "model")),
        "conv_x": _pd((w, di), (None, "model")),
        "conv_bc": _pd((w, 2 * s.d_state), (None, None)),
        "A_log": _pd((h,), ("model",), init="zeros", dtype="float32"),
        "D": _pd((h,), ("model",), init="ones", dtype="float32"),
        "dt_bias": _pd((h,), ("model",), init="zeros", dtype="float32"),
        "norm": _pd((di,), ("model",), init="ones"),
        "w_out": _pd((di, d), ("model", "data")),
    }


def mla_defs(cfg: ModelConfig, tp: int) -> dict:
    m = cfg.mla
    d = cfg.d_model
    hp = cfg.padded_heads(tp)
    return {
        "wq_a": _pd((d, m.q_lora_rank), ("data", None)),
        "wq_b": _pd((m.q_lora_rank, hp * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
                    (None, "model")),
        "wkv_a": _pd((d, m.kv_lora_rank + m.qk_rope_head_dim), ("data", None)),
        "wkv_b": _pd((m.kv_lora_rank, hp * (m.qk_nope_head_dim + m.v_head_dim)),
                     (None, "model")),
        "wo": _pd((hp * m.v_head_dim, d), ("model", "data")),
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


def moe_block(h, w, cfg: ModelConfig, ctx: ParallelCtx, *, positions, causal=True,
              window=0):
    """Pre-norm attention + MoE FFN block: (h, the router's aux loss).

    ``cfg.moe_dispatch_gz_eb`` routes the expert-parallel dispatch through
    the compressed all-to-all of the TP axis's communicator (memoized: one
    for every layer, its plan resolved once a payload shape), at
    capacity factor 0.8 as in the reference; ``moe_ffn`` uses it only at
    tp > 1 with one expert a rank, so at tp = 1 it changes nothing."""
    h = h + attention.attention_train(
        rms_norm(h, w["ln1"], cfg.norm_eps), w["attn"], cfg, ctx,
        positions=positions, causal=causal, window=window,
    )
    m, aux = moe.moe_ffn(rms_norm(h, w["ln2"], cfg.norm_eps), w["moe"], cfg, ctx,
                         dispatch_comm=dispatch_comm(cfg, ctx, h.device))
    return h + m, aux


def dispatch_comm(cfg: ModelConfig, ctx: ParallelCtx, device):
    """The communicator of ``cfg.moe_dispatch_gz_eb`` (None when it is 0)."""
    if not cfg.moe_dispatch_gz_eb:
        return None
    return GZCommunicator.for_config(
        ctx.tp_axis, GZConfig(eb=cfg.moe_dispatch_gz_eb, capacity_factor=0.8), device=device)


def ssm_block(h, w, cfg: ModelConfig, ctx: ParallelCtx):
    """Pre-norm Mamba2 block."""
    return h + ssm.ssm_train(rms_norm(h, w["ln1"], cfg.norm_eps), w["ssm"], cfg, ctx)


def mla_block(h, w, cfg: ModelConfig, ctx: ParallelCtx, *, positions):
    """Pre-norm MLA + SwiGLU MLP block."""
    h = h + mla.mla_train(rms_norm(h, w["ln1"], cfg.norm_eps), w["mla"], cfg, ctx,
                          positions=positions)
    return h + _mlp(rms_norm(h, w["ln2"], cfg.norm_eps), w["mlp"], ctx)
