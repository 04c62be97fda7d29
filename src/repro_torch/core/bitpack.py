"""Dense variable-bitwidth bit packing/unpacking, plain PyTorch.

The counterpart of ``repro.core.bitpack``: each block of ``B`` zigzag
codes is packed at its own per-block bitwidth ``b_i`` into one dense
stream of 32-bit words.  Block *i*'s element *j* occupies bits
``[off_i + j*b_i, off_i + (j+1)*b_i)`` where ``off_i = sum_{k<i} B*b_k``,
LSB first.  Words past the provisioned capacity are dropped; the true
size travels alongside as ``nwords``.

Codes and the packed stream are int32 tensors carrying uint32 bit
patterns (``pack`` also takes codes as int64 values in [0, 2**32)).  The
bit work runs in int64 with a 32-bit mask, because torch has no uint32
shifts or scatter-add on the CPU.

``unpack`` clips out-of-range word indices like the JAX oracle does;
``unpack_padded`` reads every word at or past the end of the buffer as 0,
which is what the kernel path does (it pads the received stream with
zeros) and what the CUDA kernels do.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import MASK32, as_u32, wrap_i32

__all__ = ["pack", "unpack", "unpack_padded", "packed_words"]


def packed_words(bitwidth: torch.Tensor, block: int) -> torch.Tensor:
    """Total 32-bit words needed for dense packing (int32 0-d tensor)."""
    total_bits = bitwidth.to(torch.int64).sum() * block
    return ((total_bits + 31) // 32).to(torch.int32)


def _positions(bitwidth: torch.Tensor, block: int):
    """Per-element (word index, intra-word shift, block bitwidth), int64,
    each of shape (n_blocks, block)."""
    bw = bitwidth.to(torch.int64)
    bits_per_block = bw * block
    block_off = torch.cumsum(bits_per_block, dim=0) - bits_per_block
    j = torch.arange(block, dtype=torch.int64, device=bw.device)
    bitpos = block_off[:, None] + j[None, :] * bw[:, None]
    return bitpos >> 5, bitpos & 31, bw[:, None].expand_as(bitpos)


def _width_mask(bw: torch.Tensor) -> torch.Tensor:
    return (torch.ones_like(bw) << bw) - 1  # bw in 0..32, int64: exact


def pack(codes: torch.Tensor, bitwidth: torch.Tensor, capacity_words: int):
    """Pack per-block-bitwidth codes densely.

    Returns (packed int32[capacity_words], nwords int32 0-d tensor).  Words
    at index >= capacity_words are dropped (``nwords > capacity_words``
    flags the overflow).
    """
    n_blocks, block = codes.shape
    word, shift, bw = _positions(bitwidth, block)
    u = codes.to(torch.int64) & _width_mask(bw)  # int32 bits: sign-extended, masked
    lo = (u << shift) & MASK32
    hi = u >> (32 - shift)  # u < 2**32: shift 0 gives 0, as the reference
    # Disjoint bit ranges: add == or.  The buffer spans every word the
    # stream can touch (<= block words per block, plus the straddle word),
    # so no index needs a data-dependent mask; the tail is sliced off.
    span = max(int(capacity_words), n_blocks * block + 1)
    buf = torch.zeros(span + 1, dtype=torch.int64, device=codes.device)
    flat = word.reshape(-1)
    buf.index_add_(0, flat, lo.reshape(-1))
    buf.index_add_(0, flat + 1, hi.reshape(-1))
    return wrap_i32(buf[: int(capacity_words)]), packed_words(bitwidth, block)


def _gather_codes(words: torch.Tensor, word: torch.Tensor, shift: torch.Tensor,
                  bw: torch.Tensor, n_words: int) -> torch.Tensor:
    w0 = words[word.clamp(0, n_words - 1)]
    w1 = words[(word + 1).clamp(0, n_words - 1)]
    lo = w0 >> shift
    hi = torch.where(shift == 0, torch.zeros_like(w1), (w1 << (32 - shift)) & MASK32)
    return wrap_i32((lo | hi) & _width_mask(bw))


def unpack(packed: torch.Tensor, bitwidth: torch.Tensor, block: int) -> torch.Tensor:
    """Inverse of :func:`pack` with the oracle's clipped word indices.
    Returns int32 codes (n_blocks, block) carrying uint32 bits."""
    word, shift, bw = _positions(bitwidth, block)
    return _gather_codes(as_u32(packed), word, shift, bw, packed.shape[0])


def unpack_padded(packed: torch.Tensor, bitwidth: torch.Tensor,
                  block: int) -> torch.Tensor:
    """Inverse of :func:`pack` where every word at or past the end of
    ``packed`` reads as 0 (the kernel path's semantics).  Returns int32
    codes like :func:`unpack`."""
    word, shift, bw = _positions(bitwidth, block)
    n_blocks = bitwidth.shape[0]
    words = torch.cat([
        as_u32(packed),
        torch.zeros(n_blocks * block + 2, dtype=torch.int64, device=packed.device),
    ])
    return _gather_codes(words, word, shift, bw, words.shape[0])
