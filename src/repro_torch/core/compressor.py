"""The error-bounded Lorenzo compressor.

The counterpart of ``repro.core.compressor.ErrorBoundedLorenzo``.
``fused=True`` makes every call one of the four fused codec kernels;
``fused=False`` is the two-pass composition: the ``quantize`` kernel and
``bitpack.pack`` to compress, ``bitpack.unpack`` and the ``dequantize``
(or ``dequantize_reduce``) kernel to decompress.  Both give byte-identical
wire streams.  ``kernels/ops.py`` dispatches every kernel by device.  The
other codecs' compressors are not ported yet (ROADMAP A7).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bitpack
from repro_torch.core.compressed import Compressed, capacity_words_for
from repro_torch.kernels import ops

__all__ = ["ErrorBoundedLorenzo"]


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
            packed, bw, anchor = ops.quantize_pack(x2d, eb, cap)
            nwords = bitpack.packed_words(bw, self.block)
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
        ``return_updated`` (the redoub carry)."""
        if int(acc.numel()) != c.n:
            raise ValueError(f"acc has {acc.numel()} elements, stream has {c.n}")
        eb_out = c.eb if eb_out is None else ops.as_eb(eb_out, acc.device)
        if not self.fused:
            updated = self.decompress_reduce(c, acc)
            return self.compress(updated, eb_out), (
                updated if return_updated else None)
        cap = capacity_words_for(c.n, self.capacity_factor, self.block)
        res = ops.unpack_reduce_repack(
            c.packed, c.bitwidth, c.anchor, c.eb, ops.to_blocks(acc), eb_out,
            cap, emit_f32=return_updated,
        )
        packed, bw, anchor = res[:3]
        c_out = Compressed(
            packed=packed, bitwidth=bw, anchor=anchor,
            nwords=bitpack.packed_words(bw, self.block), eb=eb_out,
            n=c.n, block=self.block,
        )
        updated = ops.from_blocks(res[3], c.n) if return_updated else None
        return c_out, updated
