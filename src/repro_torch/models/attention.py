"""GQA attention: training forward (chunked flash or the flash kernel),
prefill, and one-token decode.

The counterpart of ``repro.models.attention``, rank-centric.  At
``tp_size > 1`` the q heads are sharded over the TP axis, padded to
``cfg.padded_heads(tp)`` (weights whose extra heads have zero
out-projection rows compute the unpadded function; ``init_params`` draws
those rows like the others, as the reference's does): a rank holds its
``hp / tp`` heads' columns of ``wq`` and rows of ``wo``, and the out-projection's partial sums are
reduced over TP (``ParallelCtx.tp_reduce``).  ``wk`` and ``wv`` are
replicated, and each rank uses only the kv heads its q heads need
(``_local_kv``): a contiguous slice when ``n_kv >= tp``, else one head
shared by a replication group of ``tp / n_kv`` ranks.  So the decode
cache is sharded over TP on its kv dim, and its context over ``data``
when a decode batch cannot fill the data axes (``KVCacheSpec.cp_size >
1``: each rank attends over its slice and the partial softmaxes are
combined over the ``data`` handle, flash-decoding).  The full-sequence
path runs either the chunked online softmax below (the default, the
reference's ``lax.scan`` as a loop over kv chunks) or, with
``cfg.use_flash_kernel``, the flash-attention kernel
(``kernels/flash_attn.py``: CUDA on the card, its plain version on the
CPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import transport
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, rope
from repro_torch.models.parallel import ParallelCtx

__all__ = ["NEG", "KVCacheSpec", "kv_local_heads", "flash_attention", "attention_train",
           "attention_decode"]

NEG = -1e30


def _local_kv(kv: torch.Tensor, cfg: ModelConfig, ctx: ParallelCtx) -> torch.Tensor:
    """This rank's kv heads of the full set: (..., n_kv, hd) -> (...,
    kv_local, hd)."""
    tp, n_kv = ctx.tp_size, cfg.n_kv_heads
    if tp == 1:
        return kv
    if n_kv >= tp:
        kv_local = n_kv // tp
        return kv.narrow(-2, ctx.tp_index() * kv_local, kv_local)
    # replication groups: tp / n_kv ranks share one kv head
    return kv.narrow(-2, ctx.tp_index() // (tp // n_kv), 1)


def kv_local_heads(cfg: ModelConfig, tp: int) -> int:
    return max(cfg.n_kv_heads // tp, 1)


def _repeat_kv(kv: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, kv, hd) -> (B, S, kv*n_rep, hd)."""
    if n_rep == 1:
        return kv
    b, s, k, d = kv.shape
    return kv[:, :, :, None, :].expand(b, s, k, n_rep, d).reshape(b, s, k * n_rep, d)


def _scale(d: int) -> float:
    """1 / sqrt(d) as the reference takes it: both steps in f32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _neg(device) -> torch.Tensor:
    return torch.full((), NEG, dtype=torch.float32, device=device)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    chunk: int = 1024) -> torch.Tensor:
    """Chunked-softmax attention, O(S) memory.

    q: (B, Sq, H, D); k, v: (B, Sk, H, D) (kv already repeated to H heads).
    ``q_offset``: absolute position of q[0] relative to k[0] (prefill=0).
    ``window`` > 0 applies a sliding-window causal mask.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dev = q.device
    qf = q.to(torch.float32) * _scale(d)
    chunk = min(chunk, sk)
    n_chunks = -(-sk // chunk)
    q_pos = q_offset + torch.arange(sq, device=dev)
    neg = _neg(dev)
    m = torch.full((b, h, sq), NEG, dtype=torch.float32, device=dev)
    s = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        kc = k[:, c * chunk:(c + 1) * chunk].to(torch.float32)
        vc = v[:, c * chunk:(c + 1) * chunk].to(torch.float32)
        n = kc.shape[1]
        if n < chunk:  # the reference pads the last chunk with zeros
            kc = torch.nn.functional.pad(kc, (0, 0, 0, 0, 0, chunk - n))
            vc = torch.nn.functional.pad(vc, (0, 0, 0, 0, 0, chunk - n))
        k_pos = c * chunk + torch.arange(chunk, device=dev)
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kc)
        if causal:
            mask = k_pos[None, :] <= q_pos[:, None]
            if window:
                mask &= k_pos[None, :] > (q_pos[:, None] - window)
        else:
            mask = torch.ones((sq, chunk), dtype=torch.bool, device=dev)
        mask &= (k_pos < sk)[None, :]
        logits = torch.where(mask[None, None], logits, neg)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        s = s * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc)
        m = m_new
    out = acc / torch.clamp(s, min=1e-30)[..., None]
    return torch.movedim(out, 1, 2).to(q.dtype)  # (B, Sq, H, D)


def attention_train(h: torch.Tensor, w: dict, cfg: ModelConfig, ctx: ParallelCtx, *,
                    positions: torch.Tensor, causal: bool = True, window: int = 0,
                    cross_kv: torch.Tensor | None = None,
                    reduce: bool = True) -> torch.Tensor:
    """Full-sequence attention (training forward / prefill).

    w: {"wq": (d, hp*hd), "wk": (d, n_kv*hd), "wv": same, "wo": (hp*hd, d)}.
    ``cross_kv``: (B, S_enc, d) encoder output for cross-attention.
    """
    b, s, _ = h.shape
    hd = cfg.head_dim
    h_local = cfg.padded_heads(ctx.tp_size) // ctx.tp_size
    wq = ctx.gather(w["wq"], dim=0)
    wk = ctx.gather(w["wk"], dim=0)
    wv = ctx.gather(w["wv"], dim=0)
    wo = ctx.gather(w["wo"], dim=1)
    q = torch.matmul(h, wq).reshape(b, s, h_local, hd)
    kv_src = cross_kv if cross_kv is not None else h
    sk = kv_src.shape[1]
    k = torch.matmul(kv_src, wk).reshape(b, sk, cfg.n_kv_heads, hd)
    v = torch.matmul(kv_src, wv).reshape(b, sk, cfg.n_kv_heads, hd)
    if cross_kv is None:
        sin, cos = rope(positions, hd, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    k = _local_kv(k, cfg, ctx)
    v = _local_kv(v, cfg, ctx)
    n_rep = h_local // k.shape[-2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    if cfg.use_flash_kernel:
        from repro_torch.kernels import flash_attn

        out = flash_attn.flash_attention(q, k, v, causal=causal and cross_kv is None,
                                         window=window)
    else:
        out = flash_attention(q, k, v, causal=causal and cross_kv is None,
                              window=window)
    out = out.reshape(b, s, h_local * hd)
    out = torch.matmul(out, wo)
    return ctx.tp_reduce(out) if reduce else out


# ---------------------------------------------------------------------------
# Decode (one token) against a KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Decode cache layout: (B_local, S_local, kv_local, hd) per rank.

    S (the cache context) is sharded over ``cp_axis`` (the "data" axis)
    when the batch cannot occupy it (long-context, small batch); kv heads
    are sharded over TP.  ``window`` > 0 means ring-buffer semantics.
    """

    s_total: int
    cp_axis: str | None
    cp_size: int
    window: int = 0

    @property
    def s_local(self) -> int:
        s = self.window if self.window else self.s_total
        return s // max(self.cp_size, 1)


def _cp_handle(spec: KVCacheSpec):
    """This thread's rank of ``spec.cp_axis``, checked against
    ``spec.cp_size``; None when the context is not split."""
    if not (spec.cp_axis and spec.cp_size > 1):
        return None
    h = transport.current(spec.cp_axis)
    if h.size != spec.cp_size:
        raise ValueError(f"KVCacheSpec(cp_size={spec.cp_size}) but the group bound to "
                         f"{spec.cp_axis!r} has {h.size} ranks")
    return h


def attention_decode(h: torch.Tensor, w: dict, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, cfg: ModelConfig,
                     ctx: ParallelCtx, spec: KVCacheSpec):
    """One-token attention against a (possibly context-parallel) KV cache.

    h: (B, 1, d).  cache_k/v: (B, S_local, kv_local, hd).  pos: the absolute
    position of the incoming token (an int).  Returns (out, new_k, new_v).
    The new token's k and v are written into ``cache_k``/``cache_v`` in
    place by the rank whose slice holds its slot (the reference returns
    updated copies); ``new_k``/``new_v`` are those same tensors.  Across
    the context-parallel axis the partial softmaxes combine as the
    reference's flash-decoding ``pmax``/``psum``: the max of the ranks'
    maxima, then the rank-order f32 sums of the rescaled sums and outputs.
    """
    b = h.shape[0]
    hd = cfg.head_dim
    pos = int(pos)
    dev = h.device
    h_local = cfg.padded_heads(ctx.tp_size) // ctx.tp_size
    wq = ctx.gather(w["wq"], dim=0)
    wk = ctx.gather(w["wk"], dim=0)
    wv = ctx.gather(w["wv"], dim=0)
    wo = ctx.gather(w["wo"], dim=1)
    q = torch.matmul(h, wq).reshape(b, 1, h_local, hd)
    k_new = torch.matmul(h, wk).reshape(b, 1, cfg.n_kv_heads, hd)
    v_new = torch.matmul(h, wv).reshape(b, 1, cfg.n_kv_heads, hd)
    sin, cos = rope(torch.arange(pos, pos + 1, device=dev), hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k_new = apply_rope(k_new, sin, cos)
    k_new = _local_kv(k_new, cfg, ctx)
    v_new = _local_kv(v_new, cfg, ctx)
    kv_local = k_new.shape[-2]

    # Which cache slot does this token land in, and is it mine?
    s_local = spec.s_local
    cp = _cp_handle(spec)
    my_start = cp.rank * s_local if cp is not None else 0
    slot = (pos % spec.window if spec.window else pos) - my_start
    if 0 <= slot < s_local:
        cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)

    # Validity of cache slots (global positions covered so far, incl. the new one).
    slot_ids = my_start + torch.arange(s_local, device=dev)
    if spec.window:
        # ring buffer: slot holds position p iff p = latest p' <= pos with
        # p' % window == slot; valid iff within the last `window` tokens.
        cycle = (pos // spec.window) * spec.window + slot_ids
        slot_pos = torch.where(cycle <= pos, cycle, cycle - spec.window)
        valid = (slot_pos >= 0) & (slot_pos > pos - spec.window)
    else:
        valid = slot_ids <= pos

    n_rep = h_local // kv_local
    kk = _repeat_kv(cache_k, n_rep)  # (B, S_local, H_local, hd)
    vv = _repeat_kv(cache_v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * _scale(hd),
                          kk.to(torch.float32))  # (B, H, 1, S_local)
    logits = torch.where(valid[None, None, None, :], logits, _neg(dev))
    m = torch.amax(logits, dim=-1)
    p = torch.exp(logits - m[..., None])
    s = torch.sum(p, dim=-1)
    o = torch.einsum("bhqk,bkhd->bhqd", p, vv.to(torch.float32))
    if cp is not None:  # the flash-decoding combine over the context split
        m_all = cp.max_across(m)
        corr = torch.exp(m - m_all)
        s = cp.sum_across(s * corr)
        o = cp.sum_across(o * corr[..., None])
    out = (o / torch.clamp(s, min=1e-30)[..., None]).to(h.dtype)
    out = torch.movedim(out, 1, 2).reshape(b, 1, h_local * hd)
    proj = ctx.tp_reduce(torch.matmul(out, wo))
    return proj, cache_k, cache_v
