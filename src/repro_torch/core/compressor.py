"""Compressor implementations.

The counterparts of ``repro.core.compressor``:

  * ``ErrorBoundedLorenzo`` (codec ``lorenzo``): ``fused=True`` makes
    every call one of the four fused Lorenzo kernels; ``fused=False`` is
    the two-pass composition (the ``quantize`` kernel and ``bitpack.pack``
    to compress, ``bitpack.unpack`` and the ``dequantize`` or
    ``dequantize_reduce`` kernel to decompress).  Byte-identical streams.
  * ``EntropyLorenzo`` (codecs ``lorenzo+entropy`` and, with
    ``lossless=True``, ``lossless``): the same quantizer, the codes packed
    at four per-sub-block widths.  ``fused=True`` runs the three entropy
    kernels; ``fused=False`` the plain ``core/entropy.py`` stages.  It has
    no single-pass hop kernel: the hop is ``decompress_reduce`` then
    ``compress``.
  * ``Passthrough`` (codec ``passthrough``): raw f32 bit patterns in the
    same container, a bitcast copy and no kernel.
  * ``FixedRate``: the fixed-rate baseline whose clamped codes make the
    error unbounded (not a registry codec; benchmarks compare against it).

All share the ``Compressed`` wire container; ``kernels/ops.py``
dispatches every kernel by device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bitpack, entropy
from repro_torch.core.compressed import Compressed, capacity_words_for
from repro_torch.kernels import ops
from repro_torch.kernels.ref import as_u32, wrap_i32

__all__ = [
    "ErrorBoundedLorenzo",
    "EntropyLorenzo",
    "Passthrough",
    "FixedRate",
    "lossless_capacity_words",
]


@dataclasses.dataclass(frozen=True)
class ErrorBoundedLorenzo:
    """Error-bounded block-Lorenzo compressor (the gZCCL default).

    Guarantee: |x - decompress(compress(x, eb))| <= eb element-wise (up to
    the f32 rounding of q*2eb), as long as |x|/(2*eb) < 2**30.
    """

    capacity_factor: float = 0.5
    block: int = ops.BLOCK
    fused: bool = True

    def compress(self, x: torch.Tensor, eb) -> Compressed:
        n = int(x.numel())
        eb = ops.as_eb(eb, x.device)
        x2d = ops.to_blocks(x)
        cap = capacity_words_for(n, self.capacity_factor, self.block)
        if self.fused:
            packed, bw, anchor, nwords = ops.quantize_pack(x2d, eb, cap)
        else:
            codes, bw, anchor = ops.quantize(x2d, eb)
            packed, nwords = bitpack.pack(codes, bw, cap)
        return Compressed(
            packed=packed, bitwidth=bw, anchor=anchor, nwords=nwords, eb=eb,
            n=n, block=self.block,
        )

    def stream_nwords(self, bitwidth: torch.Tensor, n: int) -> torch.Tensor:
        """True stream words implied by wire metadata (receive-side rebuild)."""
        del n
        return bitpack.packed_words(bitwidth, self.block)

    def decompress(self, c: Compressed) -> torch.Tensor:
        if self.fused:
            x2d = ops.unpack_dequantize(c.packed, c.bitwidth, c.anchor, c.eb)
        else:
            codes = bitpack.unpack(c.packed, c.bitwidth, c.block)
            x2d = ops.dequantize(codes, c.anchor, c.eb)
        return ops.from_blocks(x2d, c.n)

    def decompress_reduce(self, c: Compressed, acc: torch.Tensor) -> torch.Tensor:
        """acc + decompress(c), flat (n,), each element rounded once."""
        acc2d = ops.to_blocks(acc)
        if self.fused:
            out2d = ops.unpack_dequantize_reduce(
                c.packed, c.bitwidth, c.anchor, c.eb, acc2d)
        else:
            codes = bitpack.unpack(c.packed, c.bitwidth, c.block)
            out2d = ops.dequantize_reduce(codes, c.anchor, c.eb, acc2d)
        return ops.from_blocks(out2d, c.n)

    def decompress_reduce_compress(
        self, c: Compressed, acc: torch.Tensor, eb_out=None, *,
        return_updated: bool = False,
    ):
        """Single-pass ring hop: ``compress(acc + decompress(c))`` as one
        ``unpack_reduce_repack`` call (``fused=False``: the two-pass
        ``decompress_reduce`` then ``compress``, byte-identical).
        ``eb_out`` defaults to the incoming stream's bound.  Returns
        ``(Compressed, updated | None)``; the f32 sum comes back only with
        ``return_updated`` (the redoub carry).  ``nwords`` is the total the
        hop returns beside the stream."""
        if not self.fused:
            return _composed_hop(self, c, acc, eb_out, return_updated)
        if int(acc.numel()) != c.n:
            raise ValueError(f"acc has {acc.numel()} elements, stream has {c.n}")
        eb_out = c.eb if eb_out is None else ops.as_eb(eb_out, acc.device)
        cap = capacity_words_for(c.n, self.capacity_factor, self.block)
        res = ops.unpack_reduce_repack(
            c.packed, c.bitwidth, c.anchor, c.eb, ops.to_blocks(acc), eb_out,
            cap, emit_f32=return_updated, return_total=True,
        )
        packed, bw, anchor = res[:3]
        c_out = Compressed(
            packed=packed, bitwidth=bw, anchor=anchor, nwords=res[-1], eb=eb_out,
            n=c.n, block=self.block,
        )
        updated = ops.from_blocks(res[3], c.n) if return_updated else None
        return c_out, updated


def _composed_hop(comp, c: Compressed, acc: torch.Tensor, eb_out, return_updated):
    """``compress(acc + decompress(c))`` as two calls (codecs without a
    single-pass hop kernel)."""
    if int(acc.numel()) != c.n:
        raise ValueError(f"acc has {acc.numel()} elements, stream has {c.n}")
    eb_out = c.eb if eb_out is None else ops.as_eb(eb_out, acc.device)
    updated = comp.decompress_reduce(c, acc)
    return comp.compress(updated, eb_out), (updated if return_updated else None)


@dataclasses.dataclass(frozen=True)
class FixedRate:
    """1D fixed-rate baseline: constant bits per element.  Codes above the
    rate are clamped, so the error is unbounded (the failure mode the
    paper's error-bounded design avoids)."""

    rate_bits: int = 8
    block: int = ops.BLOCK

    def compress(self, x: torch.Tensor, eb) -> Compressed:
        n = int(x.numel())
        eb = ops.as_eb(eb, x.device)
        codes, _, anchor = ops.quantize(ops.to_blocks(x), eb)
        codes = wrap_i32(as_u32(codes).clamp(max=(1 << self.rate_bits) - 1))  # CLAMP
        bw = torch.full((codes.shape[0],), self.rate_bits, dtype=torch.int32,
                        device=x.device)
        cap = capacity_words_for(n, self.rate_bits / 32.0 + 1e-9, self.block)
        packed, nwords = bitpack.pack(codes, bw, cap)
        return Compressed(packed=packed, bitwidth=bw, anchor=anchor, nwords=nwords,
                          eb=eb, n=n, block=self.block)

    def stream_nwords(self, bitwidth: torch.Tensor, n: int) -> torch.Tensor:
        del n
        return bitpack.packed_words(bitwidth, self.block)

    def decompress(self, c: Compressed) -> torch.Tensor:
        codes = bitpack.unpack(c.packed, c.bitwidth, c.block)
        return ops.from_blocks(ops.dequantize(codes, c.anchor, c.eb), c.n)

    def decompress_reduce(self, c: Compressed, acc: torch.Tensor) -> torch.Tensor:
        """``acc + decompress(c)``: two roundings, as the reference."""
        return acc + self.decompress(c)

    def decompress_reduce_compress(self, c, acc, eb_out=None, *,
                                   return_updated: bool = False):
        return _composed_hop(self, c, acc, eb_out, return_updated)


def lossless_capacity_words(n: int, block: int = ops.BLOCK) -> int:
    """Worst-case entropy-stream words for ``n`` elements: every real block
    at its ceiling of ``2 * SUBS * 32 = block`` words (padding blocks are
    all-zero and pack to 0 words).  The ``lossless`` codec's structural
    provisioning: it cannot overflow."""
    return max(-(-n // block) * block, 8)


@dataclasses.dataclass(frozen=True)
class EntropyLorenzo:
    """Lorenzo quantizer + per-sub-block entropy-coded wire.

    Quantization is ``ErrorBoundedLorenzo``'s, so the error bound is the
    same; only the wire changes (four 64-element sub-blocks per block at
    their own widths, the descriptor in the ``bitwidth`` slot), and the
    stream is never longer than the dense one.  ``lossless=True`` packs
    the f32 bit patterns instead (eb ignored, a bit-exact round trip, NaN
    payloads included) at the structural capacity
    ``lossless_capacity_words``.  The hop is the two-call composition
    (there is no fused entropy hop kernel; the plan layer downgrades
    ``fused_hop`` and notes why).
    """

    capacity_factor: float = 0.5
    block: int = ops.BLOCK
    fused: bool = True
    lossless: bool = False

    def compress(self, x: torch.Tensor, eb) -> Compressed:
        n = int(x.numel())
        eb = ops.as_eb(eb, x.device)
        x2d = ops.to_blocks(x)
        if self.lossless:
            cap = lossless_capacity_words(n, self.block)
        else:
            cap = capacity_words_for(n, self.capacity_factor, self.block)
        if self.fused:
            packed, desc, anchor, nwords = ops.entropy_quantize_pack(
                x2d, eb, cap, lossless=self.lossless)
        else:
            codes, anchor = entropy.encode_blocks(x2d, eb, lossless=self.lossless)
            packed, desc, nwords = entropy.pack(codes, cap)
        return Compressed(packed=packed, bitwidth=desc, anchor=anchor, nwords=nwords,
                          eb=eb, n=n, block=self.block)

    def stream_nwords(self, bitwidth: torch.Tensor, n: int) -> torch.Tensor:
        del n
        return entropy.packed_words(bitwidth)

    def decompress(self, c: Compressed) -> torch.Tensor:
        if self.fused:
            x2d = ops.entropy_unpack_dequantize(
                c.packed, c.bitwidth, c.anchor, c.eb, lossless=self.lossless)
        else:
            codes = entropy.unpack(c.packed, c.bitwidth, c.block)
            x2d = entropy.decode_blocks(codes, c.anchor, c.eb, lossless=self.lossless)
        return ops.from_blocks(x2d, c.n)

    def decompress_reduce(self, c: Compressed, acc: torch.Tensor) -> torch.Tensor:
        """acc + decompress(c), flat (n,); lossy elements rounded once."""
        acc2d = ops.to_blocks(acc)
        if self.fused:
            out2d = ops.entropy_unpack_dequantize_reduce(
                c.packed, c.bitwidth, c.anchor, c.eb, acc2d, lossless=self.lossless)
        else:
            codes = entropy.unpack(c.packed, c.bitwidth, c.block)
            out2d = entropy.decode_reduce_blocks(
                codes, c.anchor, c.eb, acc2d, lossless=self.lossless)
        return ops.from_blocks(out2d, c.n)

    def decompress_reduce_compress(self, c, acc, eb_out=None, *,
                                   return_updated: bool = False):
        """Composition hop (no fused entropy hop kernel)."""
        return _composed_hop(self, c, acc, eb_out, return_updated)


@dataclasses.dataclass(frozen=True)
class Passthrough:
    """Identity codec: raw f32 bit patterns in the ``Compressed`` container
    (wire bytes equal the payload plus metadata; compressing is a bitcast
    copy, no kernel)."""

    block: int = ops.BLOCK

    def compress(self, x: torch.Tensor, eb) -> Compressed:
        n = int(x.numel())
        eb = ops.as_eb(eb, x.device)
        flat = x.reshape(-1).to(torch.float32).contiguous()
        packed = torch.zeros(max(n, 8), dtype=torch.int32, device=x.device)
        packed[:n] = flat.view(torch.int32)
        nb = ops.n_blocks_for(n)
        return Compressed(
            packed=packed,
            bitwidth=torch.full((nb,), 32, dtype=torch.int32, device=x.device),
            anchor=torch.zeros(nb, dtype=torch.int32, device=x.device),
            nwords=torch.full((), n, dtype=torch.int32, device=x.device),
            eb=eb, n=n, block=self.block,
        )

    def stream_nwords(self, bitwidth: torch.Tensor, n: int) -> torch.Tensor:
        return torch.full((), n, dtype=torch.int32, device=bitwidth.device)

    def decompress(self, c: Compressed) -> torch.Tensor:
        # a copy: the stream may be another rank's (ThreadGroup exchanges
        # hand over the sender's tensors)
        return c.packed[: c.n].clone().view(torch.float32)

    def decompress_reduce(self, c: Compressed, acc: torch.Tensor) -> torch.Tensor:
        return acc + self.decompress(c)

    def decompress_reduce_compress(self, c, acc, eb_out=None, *,
                                   return_updated: bool = False):
        return _composed_hop(self, c, acc, eb_out, return_updated)
