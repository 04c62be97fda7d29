"""Wire-codec registry.

The counterpart of ``repro.core.codecs``: a codec is a named entry that
says how payload bytes become wire bytes (which compressor to build,
whether it has a single-pass hop kernel, how its capacity is provisioned,
and how the planner prices it).  ``GZConfig.codec`` names an entry, or
``"auto"`` to let the plan layer pick one per call from modeled
collective time; the plan cache keys on it, and the execute layer builds
the compressor from the frozen plan.

Built-in entries, the same as the reference's:

  * ``lorenzo``          the dense per-block bitpack (the default);
  * ``lorenzo+entropy``  the same quantizer, per-sub-block entropy-coded
                         wire (smaller streams, the same error bound);
  * ``lossless``         the entropy stage over the f32 bit patterns
                         (eb = 0 semantics, a bit-exact round trip);
  * ``passthrough``      raw f32 words in the same container.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

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
    "auto_codecs",
    "validate_codec",
    "codec_capacity_words",
    "build_compressor",
]

# Config value for planner selection; never a registry key.
AUTO = "auto"


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """One wire-codec registry entry (``repro.core.codecs.CodecSpec``'s
    fields).

    ``factory(capacity_factor, fused)`` builds the compressor;
    ``fused_hop`` says whether the codec has a single-pass hop kernel;
    ``lossy`` whether the error bound applies (else bit-exact);
    ``eb_scaled`` whether its ratio tracks the caller's assumed dense
    ratio; ``terms`` are the planner's modeled pricing terms;
    ``auto_selectable`` makes it a ``codec="auto"`` candidate;
    ``capacity_factor`` overrides the config's provisioning factor and
    ``capacity_words(n_elems)`` replaces factor-based provisioning.
    """

    name: str
    factory: Callable
    fused_hop: bool
    lossy: bool
    eb_scaled: bool
    terms: cost_model.CodecTerms
    description: str
    auto_selectable: bool = True
    capacity_factor: Optional[float] = None
    capacity_words: Optional[Callable] = None


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
        raise ValueError(
            f"unknown codec {name!r}; registered: {sorted(_CODECS)} "
            f"(or {AUTO!r} for planner selection)"
        ) from None


def auto_codecs() -> tuple:
    """Candidate codecs the planner may pick for ``codec='auto'``."""
    return tuple(n for n, s in _CODECS.items() if s.auto_selectable)


def validate_codec(name: str, *, knob: str) -> None:
    """Constructor-time validation for codec knobs (``auto`` allowed)."""
    if name != AUTO:
        try:
            get_codec(name)
        except ValueError as e:
            raise ValueError(f"{knob}={name!r}: {e}") from None


def _factor(spec: CodecSpec, capacity_factor: float) -> float:
    return spec.capacity_factor if spec.capacity_factor is not None else capacity_factor


def codec_capacity_words(
    name: str, n_elems: int, capacity_factor: float, block: int = ops.BLOCK
) -> int:
    """Provisioned packed-stream words for ``n_elems`` f32 under ``name``:
    the one provisioning authority of the compressor and the plan layer."""
    spec = get_codec(name)
    if spec.capacity_words is not None:
        return int(spec.capacity_words(n_elems))
    return capacity_words_for(n_elems, _factor(spec, capacity_factor), block)


def build_compressor(name: str, *, capacity_factor: float, fused: bool):
    """The compressor instance of a codec entry (``auto`` must have been
    resolved by the plan layer first)."""
    if name == AUTO:
        raise ValueError(
            "codec='auto' must be resolved by the plan layer before the "
            "execute layer builds a compressor (Plan.codec is always "
            "concrete); construct the config from plan.as_config()."
        )
    spec = get_codec(name)
    return spec.factory(_factor(spec, capacity_factor), fused)


register_codec(CodecSpec(
    name="lorenzo",
    factory=lambda cf, fused: compressor_lib.ErrorBoundedLorenzo(
        capacity_factor=cf, fused=fused
    ),
    fused_hop=True,
    lossy=True,
    eb_scaled=True,
    terms=cost_model.CodecTerms("lorenzo"),
    description="dense per-block bitpack over Lorenzo-quantized codes "
                "(the gZCCL default)",
))

register_codec(CodecSpec(
    name="lorenzo+entropy",
    factory=lambda cf, fused: compressor_lib.EntropyLorenzo(
        capacity_factor=cf, fused=fused
    ),
    fused_hop=False,  # no fused unpack+reduce+repack kernel
    lossy=True,
    eb_scaled=True,
    terms=cost_model.CodecTerms("lorenzo+entropy", ratio_scale=1.3),
    description="same quantizer, per-sub-block entropy-coded wire "
                "(smaller streams, identical error bound)",
))

register_codec(CodecSpec(
    name="lossless",
    factory=lambda cf, fused: compressor_lib.EntropyLorenzo(
        capacity_factor=cf, fused=fused, lossless=True
    ),
    fused_hop=False,
    lossy=False,
    eb_scaled=False,
    # structural worst case: overflow is impossible by construction
    capacity_words=compressor_lib.lossless_capacity_words,
    terms=cost_model.CodecTerms("lossless", ratio_abs=1.3),
    description="entropy stage over bitcast IEEE words: eb=0 semantics, "
                "bit-exact round trip",
))

register_codec(CodecSpec(
    name="passthrough",
    factory=lambda cf, fused: compressor_lib.Passthrough(),
    fused_hop=False,
    lossy=False,
    eb_scaled=False,
    capacity_words=lambda n: max(int(n), 8),
    terms=cost_model.CodecTerms(
        "passthrough", ratio_abs=1.0, cmp_overhead_us=1.0
    ),
    auto_selectable=False,  # explicit opt-in control codec
    description="raw f32 words in the compressed container (control / "
                "compression-never-pays escape hatch)",
))
