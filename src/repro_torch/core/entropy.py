"""Per-block entropy stage over the quantized Lorenzo codes, plain PyTorch.

The counterpart of ``repro.core.entropy`` (the jnp oracle): each block of
``BLOCK`` zigzag codes splits into ``SUBS`` sub-blocks of ``SUB``
elements, and each sub-block is packed at its own width.  ``SUB`` is a
multiple of 32, so every sub payload is ``SUB_WORDS_PER_BIT * bw`` whole
words and sub boundaries stay word-aligned.

Wire format (per block): the four 6-bit sub-widths travel as one int32
descriptor ``bw0 | bw1<<6 | bw2<<12 | bw3<<18`` in the ``Compressed``
container's ``bitwidth`` slot; sub ``k``'s payload is
``SUB_WORDS_PER_BIT * bw_k`` words, in sub order inside the block's
segment.  A block's payload is ``2 * sum_k bw_k`` words, never more than
the dense ``8 * max_k bw_k``.

``lossless`` replaces the quantizer with the bit pattern of the f32
value (int32 wraparound makes the delta chain exact).

As in ``core/bitpack.py``, codes and wire words are int32 tensors carrying
uint32 bits and the bit work runs in int64 with a 32-bit mask.  ``unpack``
clips out-of-range word indices like the oracle; ``unpack_padded`` reads
every word at or past the end of the stream as 0, as the kernels do.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.lorenzo import BLOCK
from repro_torch.kernels.ref import MASK32, as_u32, wrap_i32

__all__ = [
    "SUBS", "SUB", "SUB_WORDS_PER_BIT",
    "sub_widths", "make_desc", "split_desc", "packed_words",
    "pack", "unpack", "unpack_padded", "encode_blocks", "decode_blocks",
    "decode_reduce_blocks",
]

SUBS = 4
SUB = BLOCK // SUBS  # 64: sub payloads stay word-aligned (SUB % 32 == 0)
SUB_WORDS_PER_BIT = SUB // 32  # 2 words per bit of sub-width
_DESC_BITS = 6  # sub-widths are 0..32, 6 bits each; 4 of them fit one int32


def _as_eb(eb, device) -> torch.Tensor:
    return torch.as_tensor(eb, dtype=torch.float32, device=device)


def sub_widths(codes: torch.Tensor) -> torch.Tensor:
    """Codes (n_blocks, BLOCK) -> int32 (n_blocks, SUBS) per-sub bitwidths."""
    n_blocks, block = codes.shape
    u = as_u32(codes) if codes.dtype == torch.int32 else codes.to(torch.int64)
    umax = u.reshape(n_blocks, SUBS, block // SUBS).amax(dim=2)
    return ref.bitwidth_of(umax)


def make_desc(sub_bw: torch.Tensor) -> torch.Tensor:
    """int32 (n_blocks, SUBS) sub-widths -> packed int32 (n_blocks,) descriptor."""
    desc = torch.zeros(sub_bw.shape[0], dtype=torch.int32, device=sub_bw.device)
    for k in range(SUBS):
        desc = desc | (sub_bw[:, k].to(torch.int32) << (_DESC_BITS * k))
    return desc


def split_desc(desc: torch.Tensor) -> torch.Tensor:
    """Packed descriptor (n_blocks,) -> int32 (n_blocks, SUBS) sub-widths."""
    mask = (1 << _DESC_BITS) - 1
    return torch.stack([(desc >> (_DESC_BITS * k)) & mask for k in range(SUBS)], dim=1)


def packed_words(desc: torch.Tensor) -> torch.Tensor:
    """True entropy-coded stream size in 32-bit words (int32 0-d tensor)."""
    return (split_desc(desc).to(torch.int64).sum() * SUB_WORDS_PER_BIT).to(torch.int32)


def _positions(desc: torch.Tensor, block: int):
    """Per-element (word index, intra-word shift, width), int64, each
    (n_blocks, block): element j of block i lives in sub j // SUB at that
    sub's width, after the words of the blocks before i and of the subs
    before it inside i."""
    sub_bw = split_desc(desc).to(torch.int64)
    words_per_sub = sub_bw * SUB_WORDS_PER_BIT
    words_per_block = words_per_sub.sum(dim=1)
    block_off = torch.cumsum(words_per_block, dim=0) - words_per_block
    sub_off = torch.cumsum(words_per_sub, dim=1) - words_per_sub
    j = torch.arange(block, dtype=torch.int64, device=desc.device)
    sub_idx = j // SUB
    jj = j - sub_idx * SUB
    bw = sub_bw[:, sub_idx]
    bitpos = (block_off[:, None] + sub_off[:, sub_idx]) * 32 + jj[None, :] * bw
    return bitpos >> 5, bitpos & 31, bw


def _width_mask(bw: torch.Tensor) -> torch.Tensor:
    return (torch.ones_like(bw) << bw) - 1  # bw in 0..32, int64: exact


def pack(codes: torch.Tensor, capacity_words: int):
    """Entropy-pack zigzag codes (n_blocks, BLOCK) at per-sub-block widths.

    Returns (packed int32[capacity_words], desc int32 (n_blocks,), nwords
    int32 0-d).  Words at index >= capacity_words are dropped.
    """
    n_blocks, block = codes.shape
    desc = make_desc(sub_widths(codes))
    word, shift, bw = _positions(desc, block)
    u = codes.to(torch.int64) & _width_mask(bw)  # int32 bits: sign-extended, masked
    lo = (u << shift) & MASK32
    hi = u >> (32 - shift)  # u < 2**32: shift 0 gives 0, as the oracle
    # Disjoint bit ranges: add == or.  The buffer spans every word the
    # stream can touch, so no index needs a data-dependent mask.
    span = max(int(capacity_words), n_blocks * block + 1)
    buf = torch.zeros(span + 1, dtype=torch.int64, device=codes.device)
    flat = word.reshape(-1)
    buf.index_add_(0, flat, lo.reshape(-1))
    buf.index_add_(0, flat + 1, hi.reshape(-1))
    return wrap_i32(buf[: int(capacity_words)]), desc, packed_words(desc)


def _gather(words, word, shift, bw, n_words):
    w0 = words[word.clamp(0, n_words - 1)]
    w1 = words[(word + 1).clamp(0, n_words - 1)]
    lo = w0 >> shift
    hi = torch.where(shift == 0, torch.zeros_like(w1), (w1 << (32 - shift)) & MASK32)
    return wrap_i32((lo | hi) & _width_mask(bw))


def unpack(packed: torch.Tensor, desc: torch.Tensor, block: int) -> torch.Tensor:
    """Inverse of :func:`pack` with the oracle's clipped word indices.
    Returns int32 codes (n_blocks, block) carrying uint32 bits."""
    word, shift, bw = _positions(desc, block)
    return _gather(as_u32(packed), word, shift, bw, packed.shape[0])


def unpack_padded(packed: torch.Tensor, desc: torch.Tensor, block: int) -> torch.Tensor:
    """Inverse of :func:`pack` where every word at or past the end of
    ``packed`` reads as 0 (the kernels' semantics)."""
    word, shift, bw = _positions(desc, block)
    words = torch.cat([
        as_u32(packed),
        torch.zeros(desc.shape[0] * block + 2, dtype=torch.int64, device=packed.device),
    ])
    return _gather(words, word, shift, bw, words.shape[0])


def encode_blocks(x2d: torch.Tensor, eb, *, lossless: bool = False):
    """f32 (nb, B) -> (zigzag codes int32 (nb, B) carrying uint32 bits,
    anchor int32 (nb,)).  The quantizer is the Lorenzo kernels' own; with
    ``lossless`` it is the f32 bit pattern."""
    x2d = x2d.to(torch.float32)
    eb = _as_eb(eb, x2d.device)
    if lossless:
        q = x2d.contiguous().view(torch.int32).to(torch.int64)
    else:
        q = ref.f32_to_i32_rn(x2d * ref.recip_of(eb)).to(torch.int64)
    d = torch.zeros_like(q)
    d[:, 1:] = q[:, 1:] - q[:, :-1]
    d = wrap_i32(d).to(torch.int64)
    zig = ((d << 1) ^ (d >> 31)) & MASK32
    return wrap_i32(zig), q[:, 0].to(torch.int32)


def _reconstruct(codes: torch.Tensor, anchor: torch.Tensor) -> torch.Tensor:
    """codes + anchor -> int32 q (int32-wrapping prefix sum)."""
    u = as_u32(codes)
    d = (u >> 1) ^ (-(u & 1))
    return wrap_i32(anchor.to(torch.int64)[:, None] + torch.cumsum(d, dim=1))


def decode_blocks(codes: torch.Tensor, anchor: torch.Tensor, eb, *,
                  lossless: bool = False) -> torch.Tensor:
    """Inverse of :func:`encode_blocks`: codes + anchor -> f32 (nb, B)."""
    q = _reconstruct(codes, anchor)
    if lossless:
        return q.view(torch.float32)
    return q.to(torch.float32) * ref.twoeb_of(_as_eb(eb, q.device))


def decode_reduce_blocks(codes: torch.Tensor, anchor: torch.Tensor, eb,
                         acc: torch.Tensor, *, lossless: bool = False) -> torch.Tensor:
    """``acc + decode_blocks(...)``, each element rounded once when lossy.

    The reference composes this from ``decode_blocks`` and an add; traced
    under ``jit`` (every collective), XLA contracts the multiply and the
    add into one FMA, as the kernels do, so the port rounds once too.
    Lossless is one add of the decoded bit patterns (``ref.add_f32``: a
    NaN comes out as the reference kernel's add returns it on the CPU, on
    the card too)."""
    q = _reconstruct(codes, anchor)
    if lossless:
        return ref.add_f32(acc, q.view(torch.float32))
    return ref.fma_f32(q.to(torch.float32), ref.twoeb_of(_as_eb(eb, q.device)), acc)
