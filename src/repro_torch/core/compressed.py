"""Static-capacity compressed payload container.

The counterpart of ``repro.core.compressed``: a provisioned ``packed``
capacity buffer, per-block bitwidths and anchors, and the true stream size
``nwords``.  A stream longer than the buffer is truncated, never
corrupting the words that fit, and ``overflowed()`` reports it.

All five tensors live on one device.  ``packed`` is int32 carrying the
uint32 word bits; ``nwords`` (int32) and ``eb`` (f32) are 0-d tensors, so
nothing here forces a device-to-host sync.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "Compressed",
    "MAX_CAPACITY_FACTOR",
    "validate_capacity_factor",
    "capacity_words_for",
]


@dataclasses.dataclass(frozen=True)
class Compressed:
    """An error-bounded-compressed float payload with static wire shape.

    Attributes:
      packed: int32[capacity_words] dense bitstream (valid prefix ``nwords``).
      bitwidth: int32[n_blocks] per-block code width in bits (0..32).
      anchor: int32[n_blocks] absolute quantized first element per block.
      nwords: int32 0-d, true number of valid words in ``packed``.
      eb: f32 0-d absolute error bound the stream was quantized at.
      n: original element count.
      block: block size.
    """

    packed: torch.Tensor
    bitwidth: torch.Tensor
    anchor: torch.Tensor
    nwords: torch.Tensor
    eb: torch.Tensor
    n: int
    block: int

    def overflowed(self) -> torch.Tensor:
        """True iff the stream did not fit the provisioned capacity."""
        return self.nwords > self.packed.shape[0]

    def payload_bytes(self) -> torch.Tensor:
        """True compressed bytes (what a ragged transport would move): the
        valid stream words plus the per-block metadata and 8 bytes of
        header, as an int32 0-d tensor."""
        meta = self.bitwidth.numel() * 4 + self.anchor.numel() * 4 + 8
        return self.nwords.to(torch.int32) * 4 + meta

    def tensors(self) -> tuple:
        """The wire tensors, in the order the transport ships them."""
        return (self.packed, self.bitwidth, self.anchor, self.nwords, self.eb)

    def with_tensors(self, tensors) -> "Compressed":
        """The same container shape around received wire tensors."""
        packed, bitwidth, anchor, nwords, eb = tensors
        return Compressed(packed, bitwidth, anchor, nwords, eb, self.n, self.block)


MAX_CAPACITY_FACTOR = 2.0


def validate_capacity_factor(capacity_factor: float, *, knob: str) -> None:
    """Reject capacity factors outside (0, MAX_CAPACITY_FACTOR]: they are
    the fraction of the raw f32 byte size provisioned for the stream."""
    if not (0.0 < float(capacity_factor) <= MAX_CAPACITY_FACTOR):
        raise ValueError(
            f"{knob}={capacity_factor!r} is outside the legal range "
            f"(0.0, {MAX_CAPACITY_FACTOR}]: it is the fraction of the raw "
            "f32 byte size to provision for the packed stream."
        )


def capacity_words_for(n: int, capacity_factor: float, block: int) -> int:
    """Provisioned 32-bit words for an ``n``-element f32 payload: the
    ``capacity_factor`` fraction of its raw size, at least one word per
    block and at least 8."""
    if n <= 0:
        raise ValueError(f"capacity_words_for: n={n} must be positive")
    if block <= 0:
        raise ValueError(f"capacity_words_for: block={block} must be positive")
    validate_capacity_factor(capacity_factor, knob="capacity_factor")
    n_blocks = -(-n // block)
    words = int(n * capacity_factor)  # n f32 == n 4-byte words
    return max(words, n_blocks, 8)
