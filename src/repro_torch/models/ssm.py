"""Mamba2 / SSD (state-space duality) block [arXiv:2405.21060].

The counterpart of ``repro.models.ssm`` on one card, in plain torch ops
(the reference's SSD is plain jnp ops, with no Pallas kernel):

  * within a chunk: the quadratic "attention-like" form over the chunk,
  * across chunks: the sequential state recurrence (the reference's
    ``lax.scan`` over S/chunk steps, here a loop).

The reference's three- and four-operand einsums are contracted pairwise
as batched ``matmul``s over (b, chunk, head), so no (b, nc, q, q, h, p)
tensor is ever built.  dt, A, the decays, B, C and the SSD sums are f32,
as in the reference; the cast back to the activations' dtype comes
before ``w_out``.  The causal conv is the reference's sum of W shifted
products in its order, not ``F.conv1d`` (cuDNN may take TF32 on the
card, which would change the f32 function).

Decode carries (conv_state, ssm_state) and is one recurrence step; no
KV cache.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.parallel import ParallelCtx

__all__ = ["ssm_train", "ssm_decode", "ssm_state_shapes"]

F32 = torch.float32


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the reference's ``jnp.logaddexp(x, 0)`` (no
    threshold, unlike ``F.softplus``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _tp_mean_sq(y: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """Mean of y**2 over the (TP-sharded) last dim as the reference takes
    it: the local f32 sum of squares, summed over the TP ranks in rank
    order (``ctx.tp_reduce``, the identity at tp 1), over the global
    count, not ``torch.mean``.  XLA's CPU ``psum`` may add the ranks'
    partials in another order, so at tp > 1 this is the reference's value
    within f32 rounding, not by bits."""
    ss = ctx.tp_reduce(torch.sum(y * y, dim=-1, keepdim=True))
    return ss / float(y.shape[-1] * ctx.tp_size)


def _proj_sizes(cfg: ModelConfig, tp: int):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    h = s.n_heads(cfg.d_model)
    assert h % tp == 0, f"ssm heads {h} must divide tp {tp}"
    h_local = h // tp
    return di, h, h_local, h_local * s.head_dim


def _in_proj(h, w, cfg: ModelConfig, ctx: ParallelCtx):
    """The input projections (w_z, w_x, w_bc, w_dt; the reference's split
    for their TP layouts).  Returns local (z, x, B, C, dt)."""
    z = torch.matmul(h, ctx.gather(w["w_z"], dim=0))
    xs = torch.matmul(h, ctx.gather(w["w_x"], dim=0))
    bcm = torch.matmul(h, ctx.gather(w["w_bc"], dim=0))
    bmat, cmat = torch.chunk(bcm, 2, dim=-1)
    dt = torch.matmul(h, ctx.gather(w["w_dt"], dim=0))
    return z, xs, bmat, cmat, dt


def _conv_step(x_bc, conv_w, conv_state):
    """Depthwise causal conv (width W), one step: x_bc (B, C), state
    (B, W-1, C).  The window takes the state's dtype (f32 in the cache) as
    the reference's concatenate promotes; the W products are summed in
    order."""
    window = torch.cat([conv_state, x_bc[:, None, :].to(conv_state.dtype)], dim=1)
    wf = conv_w.to(window.dtype)
    out = window[:, 0] * wf[0]
    for i in range(1, wf.shape[0]):
        out = out + window[:, i] * wf[i]
    return _silu(out), window[:, 1:, :]


def _conv_seq(x, conv_w):
    """Causal depthwise conv over a sequence: x (B, S, C), conv_w (W, C);
    tap i sees x shifted right by W-1-i, the taps summed in order."""
    w, slen = conv_w.shape[0], x.shape[1]
    out = None
    for i in range(w):
        shift = w - 1 - i
        p = torch.nn.functional.pad(x, (0, 0, shift, 0))[:, :slen] if shift else x
        out = p * conv_w[i] if out is None else out + p * conv_w[i]
    return _silu(out)


def _gated_norm_out(y, z, h_dtype, w, cfg: ModelConfig, ctx: ParallelCtx):
    """Mamba2's gated RMSNorm in f32, then the cast and the out-projection."""
    y = y * _silu(z.to(F32))
    var = _tp_mean_sq(y, ctx)
    y = y * torch.rsqrt(var + cfg.norm_eps) * w["norm"].to(F32)
    out = torch.matmul(y.to(h_dtype), ctx.gather(w["w_out"], dim=1))
    return ctx.tp_reduce(out)


def ssm_train(h, w, cfg: ModelConfig, ctx: ParallelCtx):
    """Full-sequence SSD.  h: (B, S, d_model) -> (B, S, d_model).

    w: {"w_z", "w_x": (d, di), "w_bc": (d, 2n), "w_dt": (d, H),
        "conv_x": (W, di), "conv_bc": (W, 2n), "A_log", "D", "dt_bias": (H,),
        "norm": (di,), "w_out": (di, d)}
    """
    s = cfg.ssm
    b, slen, _ = h.shape
    _, _, h_local, di_local = _proj_sizes(cfg, ctx.tp_size)
    p, n = s.head_dim, s.d_state
    z, xs, bmat, cmat, dt = _in_proj(h, w, cfg, ctx)
    # depthwise conv over the (x | B | C) channels
    conv_w = torch.cat([w["conv_x"], w["conv_bc"]], dim=1)
    xbc = _conv_seq(torch.cat([xs, bmat, cmat], dim=-1), conv_w)
    xs, bmat, cmat = torch.split(xbc, [di_local, n, n], dim=-1)
    x = xs.reshape(b, slen, h_local, p)
    dt = _softplus(dt.to(F32) + w["dt_bias"].to(F32))
    a = -torch.exp(w["A_log"].to(F32))  # (h_local,)
    da = dt * a  # (B, S, h_local), negative

    q = s.chunk
    nc = -(-slen // q)
    pad = nc * q - slen

    def padq(t):
        if not pad:
            return t
        return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))

    xc = padq(x).reshape(b, nc, q, h_local, p).to(F32)
    bc = padq(bmat).reshape(b, nc, q, n).to(F32)
    cc = padq(cmat).reshape(b, nc, q, n).to(F32)
    dac = padq(da).reshape(b, nc, q, h_local)
    dtc = padq(dt).reshape(b, nc, q, h_local)

    lc = torch.cumsum(dac, dim=2)  # within-chunk cumulative log decay
    # The diagonal-block term.  Mask BEFORE the exp: for j > i the exponent
    # lc_i - lc_j is >= 0 and overflows to inf once a within-chunk decay
    # passes ~88, and inf * 0 is NaN; -inf first gives an exact 0.
    idx = torch.arange(q, device=h.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    seg = lc[:, :, :, None, :] - lc[:, :, None, :, :]  # (b, nc, q_i, q_j, h)
    att = torch.exp(torch.where(causal, seg, torch.full((), -torch.inf, dtype=F32,
                                                        device=h.device)))
    cb = torch.matmul(cc, bc.transpose(-1, -2))  # (b, nc, q_i, q_j)
    w_att = cb[..., None] * att
    # y_diag[b,k,i,h,p] = sum_j w_att[b,k,i,j,h] dt[b,k,j,h] x[b,k,j,h,p]
    dx = dtc[..., None] * xc  # (b, nc, q, h, p)
    y_diag = torch.matmul(w_att.permute(0, 1, 4, 2, 3),  # (b, nc, h, q_i, q_j)
                          dx.permute(0, 1, 3, 2, 4))      # (b, nc, h, q_j, p)
    y_diag = y_diag.permute(0, 1, 3, 2, 4)  # (b, nc, q, h, p)

    # chunk-local end states: (b, nc, h, p, n)
    decay_to_end = torch.exp(lc[:, :, -1:, :] - lc)  # (b, nc, q, h)
    u = (decay_to_end * dtc)[..., None] * xc  # (b, nc, q, h, p)
    s_loc = torch.matmul(u.permute(0, 1, 3, 4, 2),  # (b, nc, h, p, q)
                         bc[:, :, None])             # (b, nc, 1, q, n)
    chunk_decay = torch.exp(torch.sum(dac, dim=2))  # (b, nc, h)

    # the state ENTERING each chunk, the recurrence run chunk by chunk
    state = torch.zeros((b, h_local, p, n), dtype=F32, device=h.device)
    s_in = []
    for k in range(nc):
        s_in.append(state)
        state = state * chunk_decay[:, k, :, None, None] + s_loc[:, k]
    s_in = torch.stack(s_in, dim=1)  # (b, nc, h, p, n)
    # y_inter[b,k,i,h,p] = sum_n C[b,k,i,n] exp(lc)[b,k,i,h] s_in[b,k,h,p,n]
    cs = torch.matmul(cc[:, :, None], s_in.transpose(-1, -2))  # (b, nc, h, q, p)
    y_inter = cs.permute(0, 1, 3, 2, 4) * torch.exp(lc)[..., None]
    y = y_diag + y_inter  # (b, nc, q, h, p)
    y = y.reshape(b, nc * q, h_local, p)[:, :slen]
    y = y + w["D"].to(F32)[None, None, :, None] * x.to(F32)
    y = y.reshape(b, slen, di_local)
    return _gated_norm_out(y, z, h.dtype, w, cfg, ctx)


def ssm_state_shapes(cfg: ModelConfig, tp: int, batch_local: int):
    """Decode-cache shapes per layer: (conv_state, ssm_state)."""
    s = cfg.ssm
    _, _, h_local, di_local = _proj_sizes(cfg, tp)
    conv_ch = di_local + 2 * s.d_state
    return ((batch_local, s.conv_width - 1, conv_ch),
            (batch_local, h_local, s.head_dim, s.d_state))


def ssm_decode(h, w, conv_state, ssm_state, cfg: ModelConfig, ctx: ParallelCtx):
    """One-token SSD recurrence.  h: (B, 1, d).  Returns (out, new_conv,
    new_ssm), new tensors (the caller writes them into its cache)."""
    s = cfg.ssm
    b = h.shape[0]
    _, _, h_local, di_local = _proj_sizes(cfg, ctx.tp_size)
    p, n = s.head_dim, s.d_state
    z, xs, bmat, cmat, dt = _in_proj(h, w, cfg, ctx)
    conv_w = torch.cat([w["conv_x"], w["conv_bc"]], dim=1)
    xbc = torch.cat([xs, bmat, cmat], dim=-1)[:, 0]  # (B, C)
    xbc, new_conv = _conv_step(xbc, conv_w, conv_state)
    xs, bmat, cmat = torch.split(xbc, [di_local, n, n], dim=-1)
    x = xs.reshape(b, h_local, p).to(F32)
    dt = _softplus(dt[:, 0].to(F32) + w["dt_bias"].to(F32))  # (B, h_local)
    a = -torch.exp(w["A_log"].to(F32))
    da = torch.exp(dt * a)
    bmat, cmat = bmat.to(F32), cmat.to(F32)
    new_ssm = ssm_state * da[:, :, None, None] + \
        (dt[:, :, None] * x)[..., None] * bmat[:, None, None, :]
    y = torch.matmul(new_ssm, cmat[:, None, :, None])[..., 0]  # (B, h_local, p)
    y = y + w["D"].to(F32)[None, :, None] * x
    y = y.reshape(b, 1, di_local)
    return _gated_norm_out(y, z, h.dtype, w, cfg, ctx), new_conv, new_ssm
