"""Wire-codec registry.

The counterpart of ``repro.core.codecs`` with its one ported entry,
``lorenzo`` (the dense per-block bitpack, the gZCCL default).  The other
codecs of the JAX package (``lorenzo+entropy``, ``lossless``,
``passthrough``) and planner selection (``codec="auto"``, which ranks
them) are not ported yet: naming them raises ``NotImplementedError``
(ROADMAP A7).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core import compressor as compressor_lib
from repro_torch.core import cost_model
from repro_torch.core.compressed import capacity_words_for
from repro_torch.kernels import ops

__all__ = [
    "AUTO",
    "CodecSpec",
    "register_codec",
    "codec_names",
    "get_codec",
    "validate_codec",
    "codec_capacity_words",
    "build_compressor",
]

AUTO = "auto"
# Codec names of the JAX package that the port does not have yet.
_NOT_PORTED = ("lorenzo+entropy", "lossless", "passthrough", AUTO)


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """One wire-codec registry entry (the fields of
    ``repro.core.codecs.CodecSpec`` that the ported codec uses).

    ``factory(capacity_factor, fused)`` builds the compressor; ``fused_hop``
    says whether the codec has a single-pass hop kernel; ``terms`` are the
    planner's modeled pricing terms.
    """

    name: str
    factory: Callable
    fused_hop: bool
    terms: cost_model.CodecTerms


_CODECS: dict = {}


def register_codec(spec: CodecSpec) -> None:
    """Register (or replace) a wire codec."""
    if not isinstance(spec, CodecSpec):
        raise TypeError(f"register_codec needs a CodecSpec, got {spec!r}")
    if spec.name == AUTO:
        raise ValueError(f"codec name {AUTO!r} is reserved for planner selection")
    if spec.terms.codec != spec.name:
        raise ValueError(
            f"codec {spec.name!r}: terms are labeled {spec.terms.codec!r}"
        )
    _CODECS[spec.name] = spec


def codec_names() -> tuple:
    return tuple(_CODECS)


def get_codec(name: str) -> CodecSpec:
    try:
        return _CODECS[name]
    except KeyError:
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"codec {name!r} is not ported to repro_torch yet (ROADMAP A7); "
                f"ported: {sorted(_CODECS)}"
            ) from None
        raise ValueError(
            f"unknown codec {name!r}; registered: {sorted(_CODECS)}"
        ) from None


def validate_codec(name: str, *, knob: str) -> None:
    """Constructor-time validation for codec knobs."""
    try:
        get_codec(name)
    except ValueError as e:
        raise ValueError(f"{knob}={name!r}: {e}") from None


def codec_capacity_words(
    name: str, n_elems: int, capacity_factor: float, block: int = ops.BLOCK
) -> int:
    """Provisioned packed-stream words for ``n_elems`` f32 under ``name``:
    the one provisioning authority of the compressor and the plan layer."""
    get_codec(name)
    return capacity_words_for(n_elems, capacity_factor, block)


def build_compressor(name: str, *, capacity_factor: float, fused: bool):
    """The compressor instance of a codec entry."""
    return get_codec(name).factory(capacity_factor, fused)


register_codec(CodecSpec(
    name="lorenzo",
    factory=lambda cf, fused: compressor_lib.ErrorBoundedLorenzo(
        capacity_factor=cf, fused=fused
    ),
    fused_hop=True,
    terms=cost_model.CodecTerms("lorenzo"),
))
