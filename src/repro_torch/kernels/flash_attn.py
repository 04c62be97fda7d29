"""The flash-attention forward kernel.

The counterpart of ``src/repro/kernels/flash_attn.py``: the Pallas TPU
kernel ``flash_attention_bhsd`` (``:82``) written by hand in CUDA C++ and
bound through a C ABI with ``ctypes``.  It computes online-softmax
attention, causal, causal with a sliding window, or non-causal, with f32
softmax state and the output in the input's dtype; masked logits are
-1e30, not -inf.  Two routes, chosen by dtype:

  * bf16 -> ``csrc/flash_attn_sm90.cu`` (``fa_forward_tensor_core_bf16``):
    both products on Hopper's ``wgmma`` tensor cores, bf16 in and f32
    accumulate, fed by TMA through a K/V ring; P is rounded to bf16 for
    P.V.  The model's path.
  * f32 -> ``csrc/flash_attn.cu`` (``fa_forward_cuda_core_f32``): f32 FMAs
    on the CUDA cores.  The tensor cores take f32 only as TF32 (a 10-bit
    mantissa), which would break the f32 tolerance of 2e-5.

  * ``flash_attention(q, k, v)``: q (B, Sq, H, D), k and v (B, Sk, H, D)
    (kv already head-repeated), JAX's public layout, read as it lies;
  * ``flash_attention_bhsd(q, k, v)``: the reference's (BH, S, D) call.

Beside them sits the plain PyTorch version ``flash_attention_bhsd_plain``
(``flash_attention_plain`` on (B, S, H, D)): the same online softmax over
128-key blocks in f32 torch, with the same masks, padding and cast.  A CPU
tensor takes the plain version, a CUDA tensor the kernel of its dtype's
route, which raises if it cannot build or launch (there is no fallback,
and no route sends a call to the other).  Launches are counted in
``LAUNCHES["flash_attention"]`` and by route in ``ROUTES``.

The kernel has no backward, and neither has the reference's (``jax.grad``
through the Pallas kernel fails; the reference trains through the chunked
path).  So every entry point raises when grad mode is on and q, k or v
requires grad, on the card and on the CPU alike, instead of returning an
output that autograd would treat as a constant.  Under ``torch.no_grad()``
and ``torch.inference_mode()`` nothing changes.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch.kernels import build

__all__ = [
    "NEG",
    "BQ",
    "BK",
    "HEAD_DIMS",
    "KERNELS",
    "LAUNCHES",
    "ROUTES",
    "reset_launch_counts",
    "flash_attention",
    "flash_attention_bhsd",
    "flash_attention_bhsd_plain",
    "flash_attention_plain",
    "flash_attention_kernel",
]

NEG = -1e30
BQ = 128  # the reference's q tile
BK = 128  # the reference's kv tile: the plain version's block
HEAD_DIMS = (32, 64, 128)
KERNELS = ("flash_attention",)
LAUNCHES = dict.fromkeys(KERNELS, 0)
# dtype -> (route, library in csrc/, C entry point)
_ROUTE_OF = {
    torch.bfloat16: ("tensor_core_bf16", "flash_attn_sm90", "fa_forward_tensor_core_bf16"),
    torch.float32: ("cuda_core_f32", "flash_attn", "fa_forward_cuda_core_f32"),
}
ROUTES = {route: 0 for route, _, _ in _ROUTE_OF.values()}
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for counts in (LAUNCHES, ROUTES):
            for k in counts:
                counts[k] = 0


def _refuse_grad(q, k, v) -> None:
    """Raise when autograd would need a backward through kernel 11."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention: kernel 11 has no backward (nor has the reference's "
            "Pallas kernel); train through the chunked path (use_flash_kernel=False), "
            "or call it under torch.no_grad() / torch.inference_mode() (ROADMAP A11)")


def _scale(d: int) -> float:
    """The f32 value of 1/sqrt(D), as the reference scales q."""
    return float(np.float32(1.0 / d ** 0.5))


def _scale_log2(d: int) -> float:
    """The bf16 kernel's folded scale, f32(f32(1/sqrt(D)) * f32(log2 e)):
    it applies this to S after the product and takes exp2."""
    return float(np.float32(_scale(d)) * np.float32(np.log2(np.e)))


# ---------------------------------------------------------------------------
# Plain version (the CPU path, and the yardstick on the card)
# ---------------------------------------------------------------------------


def flash_attention_bhsd_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (BH, Sq, D); k, v: (BH, Sk, D) -> (BH, Sq, D) in q's dtype.

    The reference's kernel body, vectorised over the q tiles: keys padded
    with zeros to a multiple of ``BK`` and walked one block at a time with
    the running (max, sum, acc) in f32, every block visited."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    nk = -(-sk // BK)
    qf = q.to(torch.float32) * _scale(d)
    kf = torch.zeros((bh, nk * BK, d), dtype=torch.float32, device=q.device)
    vf = torch.zeros_like(kf)
    kf[:, :sk] = k
    vf[:, :sk] = v
    q_pos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((bh, sq, 1), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, sq, d), dtype=torch.float32, device=q.device)
    neg = torch.full((), NEG, dtype=torch.float32, device=q.device)
    for j in range(nk):
        kb, vb = kf[:, j * BK:(j + 1) * BK], vf[:, j * BK:(j + 1) * BK]
        s = torch.matmul(qf, kb.transpose(1, 2))  # (bh, sq, BK)
        k_pos = j * BK + torch.arange(BK, device=q.device)[None, :]
        mask = k_pos < sk
        if causal:
            mask = mask & (k_pos <= q_pos)
            if window:
                mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vb)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """The plain version on (B, S, H, D) tensors, through the reference's
    transposes to (BH, S, D) and back."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    to_bhsd = lambda x, s: x.transpose(1, 2).reshape(b * h, s, d)  # noqa: E731
    out = flash_attention_bhsd_plain(to_bhsd(q, sq), to_bhsd(k, sk), to_bhsd(v, sk),
                                     causal=causal, window=window)
    return out.reshape(b, h, sq, d).transpose(1, 2)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, o, batch, heads, sq, sk, d, causal, window, scale, stream
_SIGNATURE = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P)


def _check(x: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes contiguous 16-byte aligned tensors")


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0):
    """The CUDA kernel on (B, S, H, D) tensors: q (B, Sq, H, D), k and v
    (B, Sk, H, D), all f32 or all bf16, D in ``HEAD_DIMS``; bf16 runs on
    the tensor-core kernel, f32 on the CUDA-core one.  Raises on anything
    it does not take, on a failed build or launch, and under grad."""
    _refuse_grad(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: dtype {q.dtype} (f32 or bf16 only)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if b * h > 65535 or sq == 0 or sk == 0:
        raise ValueError(f"flash_attention: B*H = {b * h}, Sq = {sq}, Sk = {sk} "
                         "(B*H <= 65535 and non-empty sequences only)")
    _check(q, "q", q.dtype, (b, sq, h, d))
    _check(k, "k", q.dtype, (b, sk, h, d))
    _check(v, "v", q.dtype, (b, sk, h, d))
    route, lib, entry = _ROUTE_OF[q.dtype]
    scale = _scale_log2(d) if route == "tensor_core_bf16" else _scale(d)
    o = torch.empty_like(q)
    build.launch(build.load(lib, {entry: _SIGNATURE}), entry,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, sq, sk,
                 d, int(causal), int(window), scale)
    with _COUNT_LOCK:
        LAUNCHES["flash_attention"] += 1
        ROUTES[route] += 1
    return o


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window: int = 0):
    """q/k/v: (BH, S, D), batch*heads flattened.  Returns (BH, Sq, D)."""
    _refuse_grad(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_bhsd_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    out = flash_attention_kernel(q.contiguous()[:, :, None], k.contiguous()[:, :, None],
                                 v.contiguous()[:, :, None], causal=causal,
                                 window=window)
    return out[:, :, 0]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, D); k/v: (B, Sk, H, D) (kv already head-repeated)."""
    _refuse_grad(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return flash_attention_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=causal, window=window)
