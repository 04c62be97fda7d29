"""Plain PyTorch versions of the Lorenzo codec arithmetic, and the dense
attention oracle (``attention_ref``) of the flash kernel.

These are the counterparts of ``repro.kernels.ref`` and the ground truth
every CUDA kernel in ``kernels/lorenzo.py`` is held against: the CPU
tests compare them bitwise with the JAX kernel path, and ``chip_smoke.py``
compares each kernel with them on the card.

Compression scheme (cuSZp adapted, see ``repro.kernels.ref``):
  q      = rint(x * (1 / (2*eb)))          # error-bounded pre-quantization
  anchor = q[0]                            # per-block absolute, 32-bit raw
  d[j]   = q[j] - q[j-1]  (d[0] := 0)      # 1D Lorenzo within each block
  code   = zigzag(d)                       # non-negative uint32
  bw_i   = bits(max(code in block i))      # per-block fixed width

torch has little uint32 support on the CPU (no shifts, max, where or
scatter-add), so codes and wire words are handled here as int64 tensors
holding values in [0, 2**32), and every int32 quantity that the reference
lets wrap is wrapped explicitly (``wrap_i32``).  Wire words leave this
layer as int32 tensors carrying the uint32 bit pattern.

Two roundings matter for bitwise equality with the JAX kernel path:

* float -> int32 conversion saturates and maps NaN to 0 (XLA's convert and
  CUDA's ``cvt.rni.s32.f32`` agree on this), and rounds half to even;
* the reduce ``acc + q*2eb`` is rounded ONCE, as a fused multiply-add: the
  Pallas kernels contract it to an FMA, and so does the CUDA kernel
  (``__fmaf_rn``).  ``fma_f32`` reproduces that single rounding exactly.
"""
from __future__ import annotations

import torch

__all__ = [
    "MASK32",
    "wrap_i32",
    "as_u32",
    "f32_to_i32_rn",
    "fma_f32",
    "add_f32",
    "bitwidth_of",
    "quantize_ref",
    "dequantize_ref",
    "dequantize_reduce_ref",
    "recip_of",
    "twoeb_of",
    "attention_ref",
]

MASK32 = 0xFFFFFFFF


def wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (the reference's int32
    overflow semantics, and the uint32 -> int32 bit reinterpretation)."""
    v = v & MASK32
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def as_u32(w: torch.Tensor) -> torch.Tensor:
    """int32 tensor carrying uint32 bits -> int64 in [0, 2**32)."""
    return w.to(torch.int64) & MASK32


def f32_to_i32_rn(y: torch.Tensor) -> torch.Tensor:
    """rint(y) as int32: half to even, saturating, NaN -> 0."""
    r = torch.nan_to_num(torch.round(y).to(torch.float64), nan=0.0)
    return r.clamp(-(2.0**31), 2.0**31 - 1).to(torch.int32)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a*b + c`` rounded once (IEEE fused multiply-add).

    ``a*b`` of two f32 values is exact in f64 (24 + 24 < 53 bits).  The sum
    is then rounded to odd in f64 (TwoSum gives the exact error; an
    inexact sum with an even last bit moves one ulp toward the error), and
    rounding that to f32 is correct rounding of the exact value, because
    f64 carries more than 24 + 2 bits.  A plain f64 sum followed by a cast
    would round twice and can land on an f32 midpoint that the exact value
    is not on (``tests/test_torch_kernels.py`` pins such a case).
    """
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    move = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where(move, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


_QUIET_BIT = 0x00400000
_DEFAULT_NAN = -0x00400000  # 0xFFC00000 as int32


def add_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 ``a + b`` with the NaN that the reference kernel's add returns on
    the CPU, on any device: a NaN operand comes out quieted, ``b``'s where
    both are NaN, and inf - inf as x86's default NaN 0xFFC00000.  torch's
    add does the same on the CPU, but returns the card's canonical NaN on
    CUDA; the CUDA kernels follow this rule (``add_acc``)."""
    s = a + b
    ai, bi = a.view(torch.int32), b.view(torch.int32)
    nan = torch.where(torch.isnan(b), bi, torch.where(torch.isnan(a), ai, _DEFAULT_NAN))
    return torch.where(torch.isnan(s), (nan | _QUIET_BIT).view(torch.float32), s)


def twoeb_of(eb: torch.Tensor) -> torch.Tensor:
    """f32 ``2*eb`` (exact), as the reference wrappers compute it."""
    return eb.to(torch.float32) * 2.0


def recip_of(eb: torch.Tensor) -> torch.Tensor:
    """f32 ``1/(2*eb)``, correctly rounded, as the reference computes it."""
    return 1.0 / twoeb_of(eb)


def bitwidth_of(umax: torch.Tensor) -> torch.Tensor:
    """Exact bit length of non-negative int64 values below 2**32 (0 -> 0)."""
    _, exp = torch.frexp(umax.to(torch.float64))
    return exp.to(torch.int32)


def _zigzag(d: torch.Tensor) -> torch.Tensor:
    """int32-valued int64 -> zigzag code in [0, 2**32) (``(d<<1)^(d>>31)``)."""
    return ((d << 1) ^ (d >> 31)) & MASK32


def _unzigzag(u: torch.Tensor) -> torch.Tensor:
    """code in [0, 2**32) -> int32-valued int64."""
    return (u >> 1) ^ (-(u & 1))


def quantize_ref(x2d: torch.Tensor, eb: torch.Tensor):
    """f32 (nb, B) -> (codes int64 in [0, 2**32) (nb, B), bw int32 (nb,),
    anchor int32 (nb,))."""
    q = f32_to_i32_rn(x2d.to(torch.float32) * recip_of(eb)).to(torch.int64)
    d = torch.zeros_like(q)
    d[:, 1:] = q[:, 1:] - q[:, :-1]
    d = wrap_i32(d).to(torch.int64)
    zig = _zigzag(d)
    bw = bitwidth_of(zig.amax(dim=1))
    return zig, bw, q[:, 0].to(torch.int32)


def _reconstruct_q(codes: torch.Tensor, anchor: torch.Tensor) -> torch.Tensor:
    """codes + anchor -> q as f32 (int32-wrapping prefix sum, then an int32
    to f32 conversion rounded to nearest)."""
    d = _unzigzag(codes)
    q = wrap_i32(anchor.to(torch.int64)[:, None] + torch.cumsum(d, dim=1))
    return q.to(torch.float32)


def dequantize_ref(codes: torch.Tensor, anchor: torch.Tensor,
                   eb: torch.Tensor) -> torch.Tensor:
    """codes (nb, B) + anchor int32 (nb,) -> f32 (nb, B)."""
    return _reconstruct_q(codes, anchor) * twoeb_of(eb)


def dequantize_reduce_ref(codes: torch.Tensor, anchor: torch.Tensor,
                          eb: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """acc + dequantize(codes), rounded once (the kernel path's FMA)."""
    return fma_f32(_reconstruct_q(codes, anchor), twoeb_of(eb), acc)


def attention_ref(q, k, v, *, causal=True, window=0):
    """Dense softmax-attention oracle for the flash kernel.

    q: (B, Sq, H, D); k/v: (B, Sk, H, D).  f32 math throughout; the
    masked logits are -1e30, the causal mask from positions 0..Sq-1 and
    0..Sk-1, as ``repro.kernels.ref.attention_ref``.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / (d ** 0.5)
    if causal:
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(sk, device=q.device)[None, :]
        mask = kp <= qp
        if window:
            mask &= kp > (qp - window)
        s = torch.where(mask[None, None], s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32)).to(q.dtype)
