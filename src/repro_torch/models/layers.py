"""Shared layers: RMSNorm, RoPE, vocab-parallel embedding and loss.

The counterpart of ``repro.models.layers``, function for function.  Each
is rank-centric: at ``tp_size > 1`` the vocab is sharded over the TP axis
(a rank holds v_local rows of the embedding from ``tp_index() * v_local``
on, and those columns of the unembedding), the loss takes the row max and
the partition sum over the ranks (``ParallelCtx.tp_max``/``tp_reduce``,
the reference's ``lax.pmax``/``psum``) and decode's logits are gathered
whole (``tp_all_gather``).  At 1 every TP step is the identity.  Every
``astype`` of the reference is kept as a ``.to``, and where JAX
promotes bf16 with f32 to f32 the cast is written out: torch keeps a
tensor's dtype against a 0-d tensor, JAX does not.  Scalars enter as
Python floats holding f32 values, never as host tensors copied to the
card (each such copy would stall the host until the card catches up).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.parallel import ParallelCtx

__all__ = [
    "rms_norm",
    "rope",
    "apply_rope",
    "embed_lookup",
    "vocab_parallel_logits",
    "vocab_parallel_xent",
    "chunked_vocab_xent",
    "gather_logits",
]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(dt)


def rope(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """(sin, cos) tables for given positions: (..., head_dim/2), f32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / torch.pow(float(np.float32(theta)), exps)  # f32 theta ** f32 exps
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); sin/cos: (S, D/2) or broadcastable.  The rotation
    is taken in f32 (bf16 x f32 promotes, as in JAX) and cast back."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    s = sin[..., None, :] if sin.ndim == 2 else sin
    c = cos[..., None, :] if cos.ndim == 2 else cos
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def embed_lookup(ids: torch.Tensor, w_embed: torch.Tensor,
                 ctx: ParallelCtx) -> torch.Tensor:
    """Vocab-parallel embedding: ``w_embed`` is this rank's (v_local, d)
    rows; ids outside them give zero rows, and the ranks' rows are summed
    over TP."""
    w = ctx.gather(w_embed, dim=1)  # (v_local, d)
    v_local = w.shape[0]
    local_ids = ids.long() - ctx.tp_index() * v_local
    valid = (local_ids >= 0) & (local_ids < v_local)
    emb = w[local_ids.clamp(0, v_local - 1)]
    emb = torch.where(valid[..., None], emb, torch.zeros((), dtype=emb.dtype,
                                                          device=emb.device))
    return ctx.tp_reduce(emb)


def vocab_parallel_logits(h: torch.Tensor, w_unembed: torch.Tensor,
                          ctx: ParallelCtx) -> torch.Tensor:
    """h: (..., d); w_unembed (d, v) -> f32 logits (the product in f32)."""
    w = ctx.gather(w_unembed, dim=0)
    return torch.matmul(h.to(torch.float32), w.to(torch.float32))


def _nll(logits: torch.Tensor, labels: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """Per-position -log softmax(logits)[label] over TP-sharded logits
    (logsumexp shifted by the row max, as the reference takes it; at
    tp > 1 the max over the ranks, detached, and the partition sums
    summed over them)."""
    v_local = logits.shape[-1]
    m = torch.amax(logits, dim=-1)
    if ctx.tp_size > 1:
        m = ctx.tp_max(m)
    z = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
    z = ctx.tp_reduce(z)
    logz = torch.log(z) + m
    local_label = labels.long() - ctx.tp_index() * v_local
    valid = (local_label >= 0) & (local_label < v_local)
    picked = torch.gather(logits, -1, local_label.clamp(0, v_local - 1)[..., None])[..., 0]
    picked = ctx.tp_reduce(torch.where(valid, picked, torch.zeros_like(picked)))
    return logz - picked


def vocab_parallel_xent(logits_local: torch.Tensor, labels: torch.Tensor,
                        ctx: ParallelCtx, *, mask: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Mean NLL over (masked) positions, the same on every TP rank.
    logits_local: (B, S, v_local) f32; labels: (B, S) global ids."""
    nll = _nll(logits_local, labels, ctx)
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(torch.sum(mask), min=1.0)
    else:
        denom = float(nll.numel())
    return torch.sum(nll) / denom


def chunked_vocab_xent(h: torch.Tensor, w_unembed: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor, ctx: ParallelCtx, *, chunk: int = 1024
                       ) -> torch.Tensor:
    """Sequence-chunked vocab loss: the (B, chunk, v) f32 logits of one
    chunk at a time (the reference's ``lax.scan``, here a loop); the padded
    tail has mask 0.  Returns the mean NLL (the same math as
    ``vocab_parallel_xent``)."""
    b, s, _ = h.shape
    w = ctx.gather(w_unembed, dim=0)
    chunk = min(chunk, s)
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    m_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        hc, lc, mc = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk]
        logits = torch.matmul(hc.to(torch.float32), w.to(torch.float32))
        nll_sum = nll_sum + torch.sum(_nll(logits, lc, ctx) * mc)
        m_sum = m_sum + torch.sum(mc)
    return nll_sum / torch.clamp(m_sum, min=1.0)


def gather_logits(logits_local: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """All-gather TP-sharded logits into the full vocab along the last dim
    (decode only: the payload is (B, 1, v_local)); the identity at 1."""
    return ctx.tp_all_gather(logits_local, logits_local.dim() - 1)
