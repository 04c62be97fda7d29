"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 family).

The counterpart of ``repro.models.mla`` on one card, in plain torch ops
(the reference's MLA is plain jnp, with no Pallas kernel).  The KV path
is compressed into a small latent (kv_lora_rank) plus ONE decoupled RoPE
key shared by every head; the decode cache stores only (latent, k_rope),
(B, S, r + dr).  The k up-projection is absorbed into q, so scores and
values are taken in latent space, in f32 as in the reference, and the v
up-projection follows the softmax.

``_attend`` has the reference's two routes: the chunked online softmax
over the latent length (``cfg.mla_chunk``, the reference's ``lax.scan``
as a loop, the last chunk zero-padded and masked) and the dense
``chunk == 0`` baseline.  Every contraction of the reference's einsums
is a batched ``matmul`` over explicit permutes: the scores as one
(b, h·q, r) x (b, r, k) product, so no (b, q, h, k, r) tensor is built.
Masked logits are ``NEG`` (-1e30), not -inf, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import NEG, _neg, _scale
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, rope
from repro_torch.models.parallel import ParallelCtx

__all__ = ["mla_train", "mla_decode", "mla_cache_dims"]

F32 = torch.float32


def mla_cache_dims(cfg: ModelConfig) -> int:
    m = cfg.mla
    return m.kv_lora_rank + m.qk_rope_head_dim


def _heads_local(cfg: ModelConfig, tp: int) -> int:
    return cfg.padded_heads(tp) // tp


def _project(h, w, cfg: ModelConfig, ctx: ParallelCtx, positions):
    """Common q / latent projections.

    w keys: wq_a (d, q_lora), wq_b (q_lora, hl*(nope+rope)),
            wkv_a (d, kv_lora + rope_dim), wkv_b (kv_lora, hl*(nope+v)),
            wo (hl*v, d).
    Returns q_nope (b, s, hl, nope), q_rope (b, s, hl, rope), latent
    (b, s, r) and k_rope (b, s, 1, rope): one rope head for all.
    """
    m = cfg.mla
    b, s, _ = h.shape
    hl = _heads_local(cfg, ctx.tp_size)
    q_lat = torch.matmul(h, ctx.gather(w["wq_a"], dim=0))
    q = torch.matmul(q_lat, w["wq_b"]).reshape(
        b, s, hl, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    kv_all = torch.matmul(h, ctx.gather(w["wkv_a"], dim=0))
    latent, k_rope = torch.split(kv_all, [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    sin, cos = rope(positions, m.qk_rope_head_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, sin, cos)
    k_rope = apply_rope(k_rope[:, :, None, :], sin, cos)
    return q_nope, q_rope, latent, k_rope


def _scores(q_lat, q_rope, lat, kr, heads):
    """``bqhr,bkr->bhqk`` of both parts, summed: the queries flattened to
    (b, h·q, ·) against the keys' (b, k, ·).  -> (b, h, q, k)."""
    b, hq, _ = q_lat.shape
    logits = torch.matmul(q_lat, lat.transpose(1, 2)) + \
        torch.matmul(q_rope, kr.transpose(1, 2))
    return logits.reshape(b, heads, hq // heads, -1)


def _values(p, lat):
    """``bhqk,bkr->bhqr``: (b, h, q, k) x (b, k, r) -> (b, h, q, r)."""
    b, h, sq, sk = p.shape
    return torch.matmul(p.reshape(b, h * sq, sk), lat).reshape(b, h, sq, -1)


def _per_head(x, wh):
    """A per-head product as one batched matmul over heads: x (b, q, h, i),
    wh (h, i, o) -> (b, q, h, o)."""
    b, sq, h, i = x.shape
    out = torch.matmul(x.permute(2, 0, 1, 3).reshape(h, b * sq, i), wh)  # (h, b*q, o)
    return out.reshape(h, b, sq, -1).permute(1, 2, 0, 3)


def _out_proj(o_lat, wv_b, w, cfg: ModelConfig, ctx: ParallelCtx):
    """The v up-projection of the attended latent (b, q, h, r), then wo."""
    b, sq, hl, _ = o_lat.shape
    out = _per_head(o_lat, wv_b.to(F32).permute(1, 0, 2))  # bqhr,rhv->bqhv
    wo = ctx.gather(w["wo"], dim=1)
    out = out.reshape(b, sq, hl * cfg.mla.v_head_dim).to(wo.dtype)
    return ctx.tp_reduce(torch.matmul(out, wo))


def _attend(q_nope, q_rope, latent, k_rope, w, cfg: ModelConfig, ctx: ParallelCtx, *,
            causal_offset=None, chunk: int = 1024):
    """Latent-space attention: scores from the nope (absorbed) and rope
    parts, values from the latent through wkv_b's v half.  The online
    softmax runs over chunks of the latent length; ``chunk == 0`` takes
    the dense softmax over the whole length."""
    m = cfg.mla
    b, sq, hl, _ = q_nope.shape
    sk = latent.shape[1]
    dev = latent.device
    wkv_b = w["wkv_b"].reshape(m.kv_lora_rank, hl, m.qk_nope_head_dim + m.v_head_dim)
    wk_b = wkv_b[..., : m.qk_nope_head_dim]
    wv_b = wkv_b[..., m.qk_nope_head_dim:]
    # absorb k up-projection into q (the MLA trick): q_lat (b, sq, hl, r),
    # contracted in f32 from the cast inputs
    q_lat = _per_head(q_nope.to(F32), wk_b.to(F32).permute(1, 2, 0))  # bqhn,rhn->bqhr
    scale = _scale(m.qk_nope_head_dim + m.qk_rope_head_dim)
    # (b, hl·sq, .): the layout the scores' matmul takes, made once
    q_lat = (q_lat * scale).permute(0, 2, 1, 3).reshape(b, hl * sq, -1)
    q_rope = (q_rope.to(F32) * scale).permute(0, 2, 1, 3).reshape(b, hl * sq, -1)
    kr = k_rope[:, :, 0].to(F32)
    lat = latent.to(F32)
    neg = _neg(dev)
    qpos = (0 if causal_offset is None else int(causal_offset)) + \
        torch.arange(sq, device=dev)

    if chunk == 0:  # the dense baseline, kept selectable as in the reference
        scores = _scores(q_lat, q_rope, lat, kr, hl)
        if causal_offset is not None:
            mask = torch.arange(sk, device=dev)[None, :] <= qpos[:, None]
            scores = torch.where(mask[None, None], scores, neg)
        p = torch.softmax(scores, dim=-1)
        o_lat = _values(p, lat).permute(0, 2, 1, 3)
        return _out_proj(o_lat, wv_b, w, cfg, ctx)

    chunk = min(chunk, sk)
    n_chunks = -(-sk // chunk)
    mx = torch.full((b, hl, sq), NEG, dtype=F32, device=dev)
    s = torch.zeros((b, hl, sq), dtype=F32, device=dev)
    acc = torch.zeros((b, hl, sq, m.kv_lora_rank), dtype=F32, device=dev)
    for c in range(n_chunks):
        lc = lat[:, c * chunk:(c + 1) * chunk]
        kc = kr[:, c * chunk:(c + 1) * chunk]
        n = lc.shape[1]
        if n < chunk:  # the reference pads the last chunk with zeros
            lc = torch.nn.functional.pad(lc, (0, 0, 0, chunk - n))
            kc = torch.nn.functional.pad(kc, (0, 0, 0, chunk - n))
        kpos = c * chunk + torch.arange(chunk, device=dev)
        logits = _scores(q_lat, q_rope, lc, kc, hl)
        mask = (kpos < sk)[None, :]
        if causal_offset is not None:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        logits = torch.where(mask[None, None], logits, neg)
        m_new = torch.maximum(mx, torch.amax(logits, dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(mx - m_new)
        s = s * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + _values(p, lc)
        mx = m_new
    o_lat = (acc / torch.clamp(s, min=1e-30)[..., None]).permute(0, 2, 1, 3)
    return _out_proj(o_lat, wv_b, w, cfg, ctx)


def mla_train(h, w, cfg: ModelConfig, ctx: ParallelCtx, *, positions):
    """Full-sequence causal MLA.  h: (B, S, d_model) -> (B, S, d_model)."""
    q_nope, q_rope, latent, k_rope = _project(h, w, cfg, ctx, positions)
    return _attend(q_nope, q_rope, latent, k_rope, w, cfg, ctx,
                   causal_offset=0, chunk=cfg.mla_chunk)


def mla_decode(h, w, cache, pos, cfg: ModelConfig, ctx: ParallelCtx):
    """One token.  h: (B, 1, d_model); cache: (B, S, r + dr), the latent and
    rope-key rows (f32; replicated over TP); pos: the token's absolute
    position (an int).  The new row is written into ``cache`` in place (at
    ``pos`` clamped into the cache, as ``lax.dynamic_update_slice`` clamps),
    then the token attends over the whole cache with the rows past ``pos``
    masked.  Returns (out, cache)."""
    m = cfg.mla
    pos = int(pos)
    dev = h.device
    q_nope, q_rope, latent_new, k_rope_new = _project(
        h, w, cfg, ctx, torch.arange(pos, pos + 1, device=dev))
    entry = torch.cat([latent_new, k_rope_new[:, :, 0, :]], dim=-1)
    row = min(max(pos, 0), cache.shape[1] - 1)
    cache[:, row:row + 1] = entry.to(cache.dtype)
    latent = cache[..., : m.kv_lora_rank]
    k_rope = cache[..., m.kv_lora_rank:][:, :, None, :]
    out = _attend(q_nope, q_rope, latent.to(F32), k_rope.to(F32), w, cfg, ctx,
                  causal_offset=pos, chunk=cfg.mla_chunk)
    return out, cache
