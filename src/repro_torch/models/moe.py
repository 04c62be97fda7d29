"""Mixture-of-Experts FFN: top-k routing with capacity (Switch/GShard).

The counterpart of ``repro.models.moe``, in plain torch ops (the
reference's MoE is plain jnp, with no Pallas kernel).  Every step keeps
the reference's order and precision:

  * router logits and softmax in f32 (the softmax written out, its max
    detached, as ``jax.nn.softmax``);
  * the top k experts of each token, the lower expert index first among
    equal probabilities, as ``lax.top_k`` orders them (``_top_k``); with
    ``top_k > 1`` the k gates renormalised to sum to 1;
  * the capacity cut: a running count over the (token, k) slots
    flattened token-major, so earlier tokens win a full expert; a
    dropped slot points at slot ``cap - 1`` with a zero gate;
  * the scatter into (E, cap, d) f32 slots, an out-of-place accumulating
    ``index_put`` (a dropped slot adds ``x * 0`` there, NaN for a NaN x,
    as in the reference);
  * the three expert contractions in f32 on f32 casts of the bf16
    weights, ``silu(x wg) * (x wi)`` then ``wo`` (no TF32: the card's
    ``torch.bmm`` runs them on CUDA cores);
  * the gather back, each slot weighted by its gate, summed over k;
  * the Switch-style load-balance loss, ``E * sum(frac_tokens *
    frac_probs)``: the top-1 assignment share (no gradient) against the
    mean router probability.

At ``tp_size > 1`` the experts are sharded over the TP axis (``E / tp``
a rank) and the FFN is expert-parallel, as in the reference:

  * the activations are replicated over TP, so each rank routes only its
    slice of ``ceil(t / tp)`` tokens (zero rows pad the token range to a
    multiple of tp, as at decode when B·S < tp), at the capacity of that
    slice;
  * the (E, cap, d) slots go to their experts' ranks, ``(E, cap, d) ->
    (E/tp, tp·cap, d)``, each rank's slots in rank order along the
    capacity dim, through the exact all-to-all
    (``ParallelCtx.tp_all_to_all``) or, with ``dispatch_comm`` and one
    expert a rank, through its compressed ``all_to_all`` on the (tp,
    cap·d) view (one lossy hop, the codec kernels); the expert outputs
    come back the same way;
  * the ranks' token slices are gathered in rank order and cut to the
    token count (``tp_all_gather``).

The aux loss is the rank's own, over its token slice, as in the
reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.parallel import ParallelCtx

__all__ = ["moe_capacity", "moe_route", "moe_ffn"]

F32 = torch.float32


def moe_capacity(tokens: int, cfg: ModelConfig) -> int:
    cap = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(-(-cap // 8) * 8, 8)


def _silu(x):
    return x * torch.sigmoid(x)


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``: exp of the logits less their (detached) row max,
    over the row sum."""
    e = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True).detach())
    return e / torch.sum(e, dim=-1, keepdim=True)


def _top_k(probs: torch.Tensor, k: int):
    """The k largest of each row, as ``lax.top_k``: by repeated argmax,
    which returns the first of equal maxima (and a NaN as the largest), so
    the lower expert index comes first among ties."""
    vals, idx = [], []
    rest = probs
    for j in range(k):
        i = torch.argmax(rest, dim=-1, keepdim=True)
        idx.append(i)
        vals.append(torch.gather(probs, -1, i))
        if j + 1 < k:
            rest = rest.scatter(-1, i, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idx, dim=-1)


def moe_route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig, cap: int) -> dict:
    """Route t tokens x (t, d) over ``router`` (d, E) into ``cap`` slots an
    expert.  Returns probs (t, E) f32, gate_idx (t, k), and per flattened
    (token, k) slot: e_flat (t*k,) its expert, pos its slot (``cap - 1``
    where dropped), keep whether it fits, gate_flat its gate (0 where
    dropped)."""
    logits = torch.matmul(x.to(F32), router.to(F32))
    probs = _softmax(logits)
    gate_vals, gate_idx = _top_k(probs, cfg.top_k)
    if cfg.top_k > 1:
        gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    e_flat = gate_idx.reshape(-1)  # token-major: token 0's k slots, then token 1's
    count = torch.cumsum(F.one_hot(e_flat, cfg.n_experts), dim=0)
    pos = torch.gather(count, 1, e_flat[:, None])[:, 0] - 1
    keep = pos < cap
    pos = torch.where(keep, pos, cap - 1)
    gate_flat = gate_vals.reshape(-1) * keep.to(gate_vals.dtype)
    return {"probs": probs, "gate_idx": gate_idx, "e_flat": e_flat, "pos": pos,
            "keep": keep, "gate_flat": gate_flat}


def moe_ffn(h: torch.Tensor, w: dict, cfg: ModelConfig, ctx: ParallelCtx,
            dispatch_comm=None):
    """h: (B, S, d), replicated over TP.  w: {"router": (d, E), "wi", "wg":
    (E_local, d, ff), "wo": (E_local, ff, d)}, the experts this rank owns.
    ``dispatch_comm``: a ``GZCommunicator`` bound to the TP axis for the
    compressed dispatch (used at tp > 1 with one expert a rank).  Returns
    (out (B, S, d) in h's dtype, aux f32)."""
    b, s, d = h.shape
    e, k, tp = cfg.n_experts, cfg.top_k, ctx.tp_size
    if e % tp:
        raise ValueError(f"{e} experts do not divide over tp {tp}")
    e_local = e // tp
    t_full = b * s
    x = h.reshape(t_full, d)
    if tp > 1:  # this rank's token slice
        t_pad = -(-t_full // tp) * tp
        if t_pad != t_full:
            x = torch.cat([x, torch.zeros((t_pad - t_full, d), dtype=x.dtype,
                                          device=x.device)])
        t = t_pad // tp
        x = x[ctx.tp_index() * t:(ctx.tp_index() + 1) * t]
    else:
        t = t_full
    cap = moe_capacity(t, cfg)
    r = moe_route(x, ctx.gather(w["router"], dim=0), cfg, cap)
    e_flat, pos, keep = r["e_flat"], r["pos"], r["keep"]
    tok_idx = torch.arange(t * k, device=h.device) // k
    expert_in = torch.zeros((e, cap, d), dtype=F32, device=h.device).index_put(
        (e_flat, pos), x.to(F32)[tok_idx] * keep[:, None].to(F32), accumulate=True)
    compressed = tp > 1 and dispatch_comm is not None and e_local == 1
    if compressed:
        expert_in = dispatch_comm.all_to_all(expert_in.reshape(tp, cap * d)).value
    elif tp > 1:
        expert_in = ctx.tp_all_to_all(expert_in.reshape(tp, e_local, cap, d)).movedim(0, 1)
    expert_in = expert_in.reshape(e_local, tp * cap, d)

    wi = ctx.gather(w["wi"], dim=1)  # (E_local, d, ff)
    wg = ctx.gather(w["wg"], dim=1)
    wo = ctx.gather(w["wo"], dim=2)  # (E_local, ff, d)
    hmid = _silu(torch.bmm(expert_in, wg.to(F32)))
    hmid = hmid * torch.bmm(expert_in, wi.to(F32))
    expert_out = torch.bmm(hmid, wo.to(F32))

    if compressed:
        expert_out = dispatch_comm.all_to_all(expert_out.reshape(tp, cap * d)).value
    elif tp > 1:
        expert_out = ctx.tp_all_to_all(expert_out.reshape(e_local, tp, cap, d).movedim(1, 0))
    expert_out = expert_out.reshape(e, cap, d)

    y_slots = expert_out[e_flat, pos]  # (t*k, d): the gather back
    y = (y_slots * r["gate_flat"][:, None]).reshape(t, k, d).sum(dim=1)
    if tp > 1:  # the ranks' token slices, in rank order
        y = ctx.tp_all_gather(y, 0)[:t_full]
    out = y.reshape(b, s, d)

    frac_tokens = torch.mean(F.one_hot(r["gate_idx"][:, 0], e).to(F32), dim=0)
    frac_probs = torch.mean(r["probs"], dim=0)
    aux = e * torch.sum(frac_tokens * frac_probs)
    return out.to(h.dtype), aux
