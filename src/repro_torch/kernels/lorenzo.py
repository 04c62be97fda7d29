"""The Lorenzo codec kernels.

Seven kernels, each the counterpart of a Pallas kernel in
``src/repro/kernels/lorenzo.py`` and each written by hand in CUDA C++
(``csrc/lorenzo.cu``, bound through a C ABI with ``ctypes``).  The fused
codec:

  * ``quantize_pack``             f32 blocks -> packed wire words, bw, anchor
  * ``unpack_dequantize``         wire words -> f32 blocks
  * ``unpack_dequantize_reduce``  acc + decompress(wire words)
  * ``unpack_reduce_repack``      the single-pass ring hop: received words +
                                  local f32 -> the next hop's words (and,
                                  with ``emit_f32``, the updated f32)

and the unfused codec, whose zigzag codes are packed by
``core/bitpack.py`` (the scatter and all-to-all batch every chunk into
one ``quantize``; ``fused=False`` runs all three):

  * ``quantize``                  f32 blocks -> codes, bw, anchor
  * ``dequantize``                codes + anchor -> f32 blocks
  * ``dequantize_reduce``         acc + dequantize(codes), rounded once

Beside each kernel wrapper sits its plain PyTorch version (``*_plain``),
which computes the same function bitwise; ``kernels/ops.py`` sends a CPU
tensor to the plain version and a CUDA tensor to the kernel.  Each kernel
wrapper counts its launches in ``LAUNCHES`` (one per call: a call is a
short fixed sequence of CUDA launches, see the source note in
``lorenzo.cu``), so a run can show that the main path went through it.

Shapes and types: f32 data is (nb, 256) with nb a multiple of 8; wire
words and zigzag codes are int32 tensors carrying uint32 bits (codes are
(nb, 256)); ``bw`` and ``anchor`` are int32 (nb,); ``eb`` is a 0-d f32
tensor on the data's device.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.core import bitpack
from repro_torch.kernels import build, ref

__all__ = [
    "BLOCK",
    "TILE_ROWS",
    "KERNELS",
    "LAUNCHES",
    "reset_launch_counts",
    "quantize_pack",
    "quantize_pack_plain",
    "unpack_dequantize",
    "unpack_dequantize_plain",
    "unpack_dequantize_reduce",
    "unpack_dequantize_reduce_plain",
    "unpack_reduce_repack",
    "unpack_reduce_repack_plain",
    "quantize",
    "quantize_plain",
    "dequantize",
    "dequantize_plain",
    "dequantize_reduce",
    "dequantize_reduce_plain",
]

BLOCK = 256
TILE_ROWS = 8

KERNELS = ("quantize_pack", "unpack_reduce_repack", "unpack_dequantize_reduce",
           "unpack_dequantize", "quantize", "dequantize", "dequantize_reduce")
LAUNCHES = dict.fromkeys(KERNELS, 0)
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the yardstick on the card)
# ---------------------------------------------------------------------------


def quantize_pack_plain(x2d, eb, capacity_words: int):
    codes, bw, anchor = ref.quantize_ref(x2d, eb)
    packed, _ = bitpack.pack(codes, bw, capacity_words)
    return packed, bw, anchor


def unpack_dequantize_plain(packed, bitwidth, anchor, eb):
    return dequantize_plain(bitpack.unpack_padded(packed, bitwidth, BLOCK), anchor, eb)


def unpack_dequantize_reduce_plain(packed, bitwidth, anchor, eb, acc):
    codes = bitpack.unpack_padded(packed, bitwidth, BLOCK)
    return dequantize_reduce_plain(codes, anchor, eb, acc)


def unpack_reduce_repack_plain(packed, bitwidth, anchor, eb_in, acc, eb_out,
                               capacity_words: int, *, emit_f32: bool = False):
    x = unpack_dequantize_reduce_plain(packed, bitwidth, anchor, eb_in, acc)
    out = quantize_pack_plain(x, eb_out, capacity_words)
    return (*out, x) if emit_f32 else out


def quantize_plain(x2d, eb):
    codes, bw, anchor = ref.quantize_ref(x2d, eb)
    return ref.wrap_i32(codes), bw, anchor


def dequantize_plain(codes, anchor, eb):
    return ref.dequantize_ref(ref.as_u32(codes), anchor, eb)


def dequantize_reduce_plain(codes, anchor, eb, acc):
    return ref.dequantize_reduce_ref(ref.as_u32(codes), anchor, eb, acc)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "lz_quantize_pack": (_P, _I, _P, _P, _L, _P, _P, _P, _P),
    "lz_unpack_dequantize": (_P, _L, _P, _P, _I, _P, _P, _P, _P, _P),
    "lz_unpack_reduce_repack": (_P, _L, _P, _P, _I, _P, _P, _P, _P, _P, _L, _P,
                                _P, _P, _P, _P),
    "lz_quantize": (_P, _I, _P, _P, _P, _P, _P),
    "lz_dequantize": (_P, _P, _I, _P, _P, _P, _P),
}


def _check(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def _check_blocks(x2d: torch.Tensor, name: str) -> int:
    _check(x2d, name, torch.float32)
    nb = x2d.shape[0]
    if x2d.dim() != 2 or x2d.shape[1] != BLOCK or nb % TILE_ROWS:
        raise ValueError(f"{name} must be (nb, {BLOCK}) with nb % {TILE_ROWS} == 0, "
                         f"got {tuple(x2d.shape)}")
    if nb * BLOCK >= 2**31:
        raise ValueError(f"{name}: {nb * BLOCK} elements exceed the int32 word offsets")
    return nb


def _scalars(eb: torch.Tensor):
    _check(eb, "eb", torch.float32, ())
    twoeb = ref.twoeb_of(eb).reshape(1)
    return twoeb, 1.0 / twoeb


def _launch(fn: str, *args) -> None:
    build.launch(build.load("lorenzo", _SIGNATURES), fn, *args)


def quantize_pack(x2d, eb, capacity_words: int):
    """f32 (nb, 256) -> (packed int32[cap], bw int32 (nb,), anchor int32 (nb,))."""
    nb = _check_blocks(x2d, "x2d")
    _, recip = _scalars(eb)
    packed = torch.empty(int(capacity_words), dtype=torch.int32, device=x2d.device)
    bw = torch.empty(nb, dtype=torch.int32, device=x2d.device)
    anchor = torch.empty_like(bw)
    offsets = torch.empty(nb + 1, dtype=torch.int32, device=x2d.device)
    _launch("lz_quantize_pack", x2d.data_ptr(), nb, recip.data_ptr(),
            packed.data_ptr(), int(capacity_words), bw.data_ptr(),
            anchor.data_ptr(), offsets.data_ptr())
    _count("quantize_pack")
    return packed, bw, anchor


def _unpack(name, packed, bitwidth, anchor, eb, acc):
    nb = bitwidth.shape[0]
    _check(packed, "packed", torch.int32)
    _check(bitwidth, "bitwidth", torch.int32, (nb,))
    _check(anchor, "anchor", torch.int32, (nb,))
    if acc is not None:
        _check(acc, "acc", torch.float32, (nb, BLOCK))
    twoeb, _ = _scalars(eb)
    out = torch.empty((nb, BLOCK), dtype=torch.float32, device=packed.device)
    offsets = torch.empty(nb + 1, dtype=torch.int32, device=packed.device)
    _launch("lz_unpack_dequantize", packed.data_ptr(), packed.shape[0],
            bitwidth.data_ptr(), anchor.data_ptr(), nb, twoeb.data_ptr(),
            acc.data_ptr() if acc is not None else None, out.data_ptr(),
            offsets.data_ptr())
    _count(name)
    return out


def unpack_dequantize(packed, bitwidth, anchor, eb):
    """Wire words -> f32 (nb, 256)."""
    return _unpack("unpack_dequantize", packed, bitwidth, anchor, eb, None)


def unpack_dequantize_reduce(packed, bitwidth, anchor, eb, acc):
    """acc + decompress(wire words), each element rounded once."""
    return _unpack("unpack_dequantize_reduce", packed, bitwidth, anchor, eb, acc)


def unpack_reduce_repack(packed, bitwidth, anchor, eb_in, acc, eb_out,
                         capacity_words: int, *, emit_f32: bool = False):
    """Received words + local f32 -> (packed_out, bw_out, anchor_out[, f32])."""
    nb = _check_blocks(acc, "acc")
    _check(packed, "packed", torch.int32)
    _check(bitwidth, "bitwidth", torch.int32, (nb,))
    _check(anchor, "anchor", torch.int32, (nb,))
    twoeb, _ = _scalars(eb_in)
    _, recip = _scalars(eb_out)
    dev = acc.device
    x = torch.empty((nb, BLOCK), dtype=torch.float32, device=dev)
    packed_out = torch.empty(int(capacity_words), dtype=torch.int32, device=dev)
    bw_out = torch.empty(nb, dtype=torch.int32, device=dev)
    anchor_out = torch.empty_like(bw_out)
    offsets = torch.empty((2, nb + 1), dtype=torch.int32, device=dev)
    _launch("lz_unpack_reduce_repack", packed.data_ptr(), packed.shape[0],
            bitwidth.data_ptr(), anchor.data_ptr(), nb, twoeb.data_ptr(),
            acc.data_ptr(), recip.data_ptr(), x.data_ptr(), packed_out.data_ptr(),
            int(capacity_words), bw_out.data_ptr(), anchor_out.data_ptr(),
            offsets[0].data_ptr(), offsets[1].data_ptr())
    _count("unpack_reduce_repack")
    return (packed_out, bw_out, anchor_out, x) if emit_f32 else \
        (packed_out, bw_out, anchor_out)


def quantize(x2d, eb):
    """f32 (nb, 256) -> (codes int32 (nb, 256), bw int32 (nb,), anchor int32 (nb,))."""
    nb = _check_blocks(x2d, "x2d")
    _, recip = _scalars(eb)
    codes = torch.empty((nb, BLOCK), dtype=torch.int32, device=x2d.device)
    bw = torch.empty(nb, dtype=torch.int32, device=x2d.device)
    anchor = torch.empty_like(bw)
    _launch("lz_quantize", x2d.data_ptr(), nb, recip.data_ptr(), codes.data_ptr(),
            bw.data_ptr(), anchor.data_ptr())
    _count("quantize")
    return codes, bw, anchor


def _dequantize(name, codes, anchor, eb, acc):
    nb = codes.shape[0]
    _check(codes, "codes", torch.int32, (nb, BLOCK))
    _check(anchor, "anchor", torch.int32, (nb,))
    if acc is not None:
        _check(acc, "acc", torch.float32, (nb, BLOCK))
    twoeb, _ = _scalars(eb)
    out = torch.empty((nb, BLOCK), dtype=torch.float32, device=codes.device)
    _launch("lz_dequantize", codes.data_ptr(), anchor.data_ptr(), nb, twoeb.data_ptr(),
            acc.data_ptr() if acc is not None else None, out.data_ptr())
    _count(name)
    return out


def dequantize(codes, anchor, eb):
    """Zigzag codes (nb, 256) + anchor -> f32 (nb, 256)."""
    return _dequantize("dequantize", codes, anchor, eb, None)


def dequantize_reduce(codes, anchor, eb, acc):
    """acc + dequantize(codes), each element rounded once."""
    return _dequantize("dequantize_reduce", codes, anchor, eb, acc)
