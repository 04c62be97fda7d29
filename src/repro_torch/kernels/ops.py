"""Flat-array entry points around the Lorenzo and entropy kernels.

The counterpart of ``repro.kernels.ops``: block padding (``BLOCK``=256
elements per Lorenzo block, ``TILE_ROWS``=8 blocks per row-tile, so the
padded block count is a multiple of 8) and one dispatch rule, by the
device of the data: a CPU tensor takes the kernel's plain PyTorch
version; a CUDA tensor launches the CUDA kernel, which raises if it
cannot build or launch.  Nothing falls back from the card to the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import entropy, lorenzo

__all__ = [
    "BLOCK",
    "TILE_ROWS",
    "n_blocks_for",
    "to_blocks",
    "from_blocks",
    "as_eb",
    "quantize_pack",
    "unpack_dequantize",
    "unpack_dequantize_reduce",
    "unpack_reduce_repack",
    "quantize",
    "dequantize",
    "dequantize_reduce",
    "entropy_quantize_pack",
    "entropy_unpack_dequantize",
    "entropy_unpack_dequantize_reduce",
]

BLOCK = lorenzo.BLOCK
TILE_ROWS = lorenzo.TILE_ROWS


def n_blocks_for(n: int) -> int:
    """Number of Lorenzo blocks (padded to the row-tile multiple)."""
    nb = -(-n // BLOCK)
    return -(-nb // TILE_ROWS) * TILE_ROWS


def to_blocks(x: torch.Tensor) -> torch.Tensor:
    """Flatten + zero-pad to (n_blocks, BLOCK) f32 (a view when no padding
    is needed)."""
    flat = x.reshape(-1).to(torch.float32)
    nb = n_blocks_for(flat.shape[0])
    if flat.shape[0] == nb * BLOCK:
        return flat.contiguous().view(nb, BLOCK)
    padded = torch.zeros(nb * BLOCK, dtype=torch.float32, device=flat.device)
    padded[: flat.shape[0]] = flat
    return padded.view(nb, BLOCK)


def from_blocks(x2d: torch.Tensor, n: int) -> torch.Tensor:
    return x2d.reshape(-1)[:n]


def as_eb(eb, device) -> torch.Tensor:
    """The error bound as a 0-d f32 tensor on ``device`` (no host sync)."""
    if isinstance(eb, torch.Tensor):
        return eb.to(device=device, dtype=torch.float32)
    return torch.full((), float(eb), dtype=torch.float32, device=device)


def _route(t: torch.Tensor, name: str, module=lorenzo):
    if t.device.type == "cpu":
        return getattr(module, f"{name}_plain")
    if t.device.type == "cuda":
        return getattr(module, name)
    raise ValueError(f"{name}: no kernel for device {t.device}")


def quantize_pack(x2d, eb, capacity_words: int):
    """f32 blocks -> (packed int32 (capacity_words,), bw, anchor, total
    words int32 0-d, which may pass the capacity)."""
    return _route(x2d, "quantize_pack")(x2d, as_eb(eb, x2d.device), int(capacity_words))


def unpack_dequantize(packed, bitwidth, anchor, eb):
    """Packed words -> decompressed f32 (nb, BLOCK)."""
    return _route(packed, "unpack_dequantize")(
        packed, bitwidth, anchor, as_eb(eb, packed.device))


def unpack_dequantize_reduce(packed, bitwidth, anchor, eb, acc2d):
    """Packed words + acc -> acc + decompressed f32 (nb, BLOCK)."""
    return _route(acc2d, "unpack_dequantize_reduce")(
        packed, bitwidth, anchor, as_eb(eb, acc2d.device), acc2d)


def unpack_reduce_repack(packed, bitwidth, anchor, eb_in, acc2d, eb_out,
                         capacity_words: int, *, emit_f32: bool = False,
                         return_total: bool = False):
    """Single-pass ring hop: received stream + local f32 chunk -> the next
    hop's stream (packed_out, bw_out, anchor_out[, updated f32][, total
    words int32 0-d, which may pass the capacity])."""
    return _route(acc2d, "unpack_reduce_repack")(
        packed, bitwidth, anchor, as_eb(eb_in, acc2d.device), acc2d,
        as_eb(eb_out, acc2d.device), int(capacity_words), emit_f32=emit_f32,
        return_total=return_total)


def quantize(x2d, eb):
    """f32 blocks -> (zigzag codes int32 (nb, BLOCK), bw, anchor)."""
    return _route(x2d, "quantize")(x2d, as_eb(eb, x2d.device))


def dequantize(codes, anchor, eb):
    """Zigzag codes + anchor -> f32 (nb, BLOCK)."""
    return _route(codes, "dequantize")(codes, anchor, as_eb(eb, codes.device))


def dequantize_reduce(codes, anchor, eb, acc2d):
    """acc + dequantize(codes), each element rounded once."""
    return _route(acc2d, "dequantize_reduce")(
        codes, anchor, as_eb(eb, acc2d.device), acc2d)


def entropy_quantize_pack(x2d, eb, capacity_words: int, *, lossless: bool = False):
    """f32 blocks -> entropy-coded (packed int32 (capacity_words,), desc,
    anchor, total words int32 0-d); ``desc`` packs the four per-sub-block
    widths, and the total is the stream's true length (it may pass the
    capacity)."""
    return _route(x2d, "quantize_pack", entropy)(
        x2d, as_eb(eb, x2d.device), int(capacity_words), lossless=lossless)


def entropy_unpack_dequantize(packed, desc, anchor, eb, *, lossless: bool = False):
    """Entropy-coded words -> decompressed f32 (nb, BLOCK)."""
    return _route(packed, "unpack_dequantize", entropy)(
        packed, desc, anchor, as_eb(eb, packed.device), lossless=lossless)


def entropy_unpack_dequantize_reduce(packed, desc, anchor, eb, acc2d, *,
                                     lossless: bool = False):
    """Entropy-coded words + acc -> acc + decompressed f32 (nb, BLOCK)."""
    return _route(acc2d, "unpack_dequantize_reduce", entropy)(
        packed, desc, anchor, as_eb(eb, acc2d.device), acc2d, lossless=lossless)
