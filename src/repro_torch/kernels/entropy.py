"""The entropy-coded wire kernels.

Three kernels, each the counterpart of a Pallas kernel in
``src/repro/kernels/entropy.py`` and written by hand in CUDA C++
(``csrc/entropy.cu``, bound through a C ABI with ``ctypes``):

  * ``quantize_pack``             f32 blocks -> stream, desc, anchor
  * ``unpack_dequantize``         stream -> f32 blocks
  * ``unpack_dequantize_reduce``  acc + decompress(stream)

Each block of 256 codes is packed as four 64-element sub-blocks at their
own widths; ``desc`` carries the four 6-bit widths in one int32
(``core/entropy.py`` has the layout).  ``lossless=True`` quantizes to the
f32 bit pattern instead (eb is not read, so eb = 0 never divides).

Beside each kernel wrapper sits its plain PyTorch version (``*_plain``),
bitwise the same function (words at or past the capacity read as 0, the
lossy reduce rounded once); ``kernels/ops.py`` sends a CPU tensor to the
plain version and a CUDA tensor to the kernel.  Launches are counted in
``LAUNCHES``, one per call.

Shapes and types: f32 data is (nb, 256) with nb a multiple of 8; wire
words are int32 tensors carrying uint32 bits; ``desc`` and ``anchor`` are
int32 (nb,); ``eb`` is a 0-d f32 tensor on the data's device.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.core import entropy
from repro_torch.kernels import build, lorenzo

__all__ = [
    "KERNELS",
    "LAUNCHES",
    "reset_launch_counts",
    "quantize_pack",
    "quantize_pack_plain",
    "unpack_dequantize",
    "unpack_dequantize_plain",
    "unpack_dequantize_reduce",
    "unpack_dequantize_reduce_plain",
]

BLOCK = lorenzo.BLOCK
KERNELS = ("quantize_pack", "unpack_dequantize", "unpack_dequantize_reduce")
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


def quantize_pack_plain(x2d, eb, capacity_words: int, *, lossless: bool = False):
    codes, anchor = entropy.encode_blocks(x2d, eb, lossless=lossless)
    packed, desc, _ = entropy.pack(codes, capacity_words)
    return packed, desc, anchor


def unpack_dequantize_plain(packed, desc, anchor, eb, *, lossless: bool = False):
    codes = entropy.unpack_padded(packed, desc, BLOCK)
    return entropy.decode_blocks(codes, anchor, eb, lossless=lossless)


def unpack_dequantize_reduce_plain(packed, desc, anchor, eb, acc, *,
                                   lossless: bool = False):
    codes = entropy.unpack_padded(packed, desc, BLOCK)
    return entropy.decode_reduce_blocks(codes, anchor, eb, acc, lossless=lossless)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ent_quantize_pack": (_P, _I, _P, _I, _P, _L, _P, _P, _P, _P),
    "ent_unpack_dequantize": (_P, _L, _P, _P, _I, _P, _I, _P, _P, _P, _P),
}


def _launch(fn: str, *args) -> None:
    build.launch(build.load("entropy", _SIGNATURES), fn, *args)


def _scalars(eb: torch.Tensor, lossless: bool):
    """(twoeb, recip) as 1-element device tensors; inert ones in lossless
    mode, where the kernels read neither."""
    if lossless:
        one = torch.ones(1, dtype=torch.float32, device=eb.device)
        return one, one
    return lorenzo._scalars(eb)


def quantize_pack(x2d, eb, capacity_words: int, *, lossless: bool = False):
    """f32 (nb, 256) -> (packed int32[cap], desc int32 (nb,), anchor int32 (nb,))."""
    nb = lorenzo._check_blocks(x2d, "x2d")
    lorenzo._check(eb, "eb", torch.float32, ())
    _, recip = _scalars(eb, lossless)
    dev = x2d.device
    packed = torch.empty(int(capacity_words), dtype=torch.int32, device=dev)
    desc = torch.empty(nb, dtype=torch.int32, device=dev)
    anchor = torch.empty_like(desc)
    offsets = torch.empty(nb + 1, dtype=torch.int32, device=dev)
    _launch("ent_quantize_pack", x2d.data_ptr(), nb, recip.data_ptr(), int(lossless),
            packed.data_ptr(), int(capacity_words), desc.data_ptr(),
            anchor.data_ptr(), offsets.data_ptr())
    _count("quantize_pack")
    return packed, desc, anchor


def _unpack(name, packed, desc, anchor, eb, acc, lossless):
    nb = desc.shape[0]
    lorenzo._check(packed, "packed", torch.int32)
    lorenzo._check(desc, "desc", torch.int32, (nb,))
    lorenzo._check(anchor, "anchor", torch.int32, (nb,))
    lorenzo._check(eb, "eb", torch.float32, ())
    if acc is not None:
        lorenzo._check(acc, "acc", torch.float32, (nb, BLOCK))
    twoeb, _ = _scalars(eb, lossless)
    out = torch.empty((nb, BLOCK), dtype=torch.float32, device=packed.device)
    offsets = torch.empty(nb + 1, dtype=torch.int32, device=packed.device)
    _launch("ent_unpack_dequantize", packed.data_ptr(), packed.shape[0],
            desc.data_ptr(), anchor.data_ptr(), nb, twoeb.data_ptr(), int(lossless),
            acc.data_ptr() if acc is not None else None, out.data_ptr(),
            offsets.data_ptr())
    _count(name)
    return out


def unpack_dequantize(packed, desc, anchor, eb, *, lossless: bool = False):
    """Entropy stream -> f32 (nb, 256)."""
    return _unpack("unpack_dequantize", packed, desc, anchor, eb, None, lossless)


def unpack_dequantize_reduce(packed, desc, anchor, eb, acc, *, lossless: bool = False):
    """acc + decompress(stream); lossy elements rounded once."""
    return _unpack("unpack_dequantize_reduce", packed, desc, anchor, eb, acc, lossless)
