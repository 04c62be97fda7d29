"""Deterministic fault injection for the compressed collectives.

The counterpart of ``repro.core.faults``: seeded injectors that force
each failure mode of the degradation layer on chosen ranks, so that its
detection paths (overflow, the non-finite guard, stream verification)
and the lossless fallback can be driven and checked.

Fault kinds (:class:`FaultSpec.kind`):

  ``"nan"`` / ``"inf"``  poison ``n`` seeded positions of the INPUT with
                         NaN/Inf on the target ranks (before compression:
                         exercises the non-finite guard).
  ``"overflow"``         replace the target ranks' input with seeded
                         high-entropy noise (sigma 1e6) that no capacity
                         factor <= 1 can pack: a genuine capacity overflow
                         through the real kernels, no flag is faked.
  ``"bitflip"``          XOR ``n`` seeded bits into the packed stream (the
                         first wire tensor, int32 words) of every
                         compressed payload RECEIVED on the target ranks:
                         in-flight corruption, detected only when
                         ``verify_streams`` ships checksums.  Raw f32
                         payloads (the lossless fallback's) are never
                         touched, so a fallback re-run is immune.

What differs from the reference: the reference gates injection at trace
time and embeds the seeded material as constants; here the collectives
run eagerly, so the spec armed when a collective is CALLED applies to
that call.  The seeded material is drawn exactly as the reference draws
it (``numpy.random.default_rng(spec.seed)``), so the same spec hits the
same positions, values, words, bits and rounds in both packages, and
:func:`poison_np` gives bitwise the reference's host-side twin.  The
rank is a Python int, so the reference's rank mask becomes
``g.rank in spec.ranks``.  The armed spec is process-wide: the rank
threads of a ``ThreadGroup`` all read it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

__all__ = [
    "KINDS",
    "OVERFLOW_SIGMA",
    "FaultSpec",
    "install",
    "clear",
    "active",
    "inject",
    "poison_np",
    "maybe_poison_input",
    "maybe_corrupt_wire",
]

KINDS = ("nan", "inf", "overflow", "bitflip")

# Sigma of the "overflow" replacement noise: a seeded N(0, 1e6) payload
# needs ~all 32 bits per code at any practical eb, so every capacity
# factor < 1 genuinely overflows the pack kernel.
OVERFLOW_SIGMA = 1e6


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: what, where, and from which seed.

    ``rounds`` (bitflip only) targets wire rounds by schedule-table index
    (``core/schedule.py``): ``None`` corrupts every received compressed
    payload on the target ranks; ``(k, ...)`` only the exchanges that
    implement those table rounds.  An exchange that passes no round index
    never matches a round-targeted spec.
    """

    kind: str
    ranks: tuple = (0,)
    seed: int = 0
    n: int = 1  # poisoned positions (nan/inf) or flipped bits (bitflip)
    rounds: Optional[tuple] = None  # schedule-table round indices, or all

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"FaultSpec.kind must be one of {KINDS}; got {self.kind!r}"
            )
        object.__setattr__(
            self, "ranks", tuple(int(r) for r in self.ranks)
        )
        if self.n < 1:
            raise ValueError(f"FaultSpec.n must be >= 1; got {self.n!r}")
        if self.rounds is not None:
            if self.kind != "bitflip":
                raise ValueError(
                    "FaultSpec.rounds targets wire rounds and only applies "
                    f"to kind='bitflip'; got kind={self.kind!r}"
                )
            rr = tuple(int(k) for k in self.rounds)
            if not rr or any(k < 0 for k in rr):
                raise ValueError(
                    f"FaultSpec.rounds must be non-empty, non-negative "
                    f"schedule round indices; got {self.rounds!r}"
                )
            object.__setattr__(self, "rounds", rr)


_ACTIVE: Optional[FaultSpec] = None
_LOCK = threading.Lock()


def install(spec: FaultSpec) -> None:
    """Arm ``spec`` process-wide (until :func:`clear`)."""
    global _ACTIVE
    with _LOCK:
        _ACTIVE = spec


def clear() -> None:
    global _ACTIVE
    with _LOCK:
        _ACTIVE = None


def active() -> Optional[FaultSpec]:
    return _ACTIVE


@contextlib.contextmanager
def inject(spec: FaultSpec):
    """Arm ``spec`` for the collectives called inside the block."""
    install(spec)
    try:
        yield spec
    finally:
        clear()


# ---------------------------------------------------------------------------
# Seeded fault material (shared by the hooks and the numpy twin)
# ---------------------------------------------------------------------------


def _poison_positions(size: int, spec: FaultSpec) -> np.ndarray:
    rng = np.random.default_rng(spec.seed)
    k = max(1, min(spec.n, size))
    return np.sort(rng.choice(size, size=k, replace=False))


def _overflow_noise(shape, spec: FaultSpec) -> np.ndarray:
    rng = np.random.default_rng(spec.seed)
    return rng.normal(0.0, OVERFLOW_SIGMA, size=shape).astype(np.float32)


def poison_np(x, rank: int, spec: Optional[FaultSpec]):
    """Numpy twin of :func:`maybe_poison_input`: what rank ``rank``'s
    input looks like under ``spec``, bitwise, for host-side references."""
    x = np.array(x, copy=True)
    if (
        spec is None
        or spec.kind == "bitflip"
        or rank not in spec.ranks
        or not np.issubdtype(x.dtype, np.floating)
    ):
        return x
    if spec.kind == "overflow":
        return _overflow_noise(x.shape, spec).astype(x.dtype)
    flat = x.reshape(-1)
    flat[_poison_positions(flat.size, spec)] = (
        np.nan if spec.kind == "nan" else np.inf
    )
    return flat.reshape(x.shape)


# ---------------------------------------------------------------------------
# Hooks (identity when no fault is armed)
# ---------------------------------------------------------------------------


def maybe_poison_input(x: torch.Tensor, g) -> torch.Tensor:
    """Input-poisoning hook, called by every communicator method on the
    payload before detection and compression.  Identity unless a
    nan/inf/overflow fault is armed and ``g.rank`` is a target; never
    writes into ``x``."""
    spec = _ACTIVE
    if (spec is None or spec.kind == "bitflip" or not x.dtype.is_floating_point
            or g.rank not in spec.ranks):
        return x
    if spec.kind == "overflow":
        return torch.from_numpy(_overflow_noise(tuple(x.shape), spec)).to(
            device=x.device, dtype=x.dtype)
    flat = x.reshape(-1).clone()
    idx = torch.from_numpy(_poison_positions(flat.shape[0], spec)).to(x.device)
    flat[idx] = float("nan") if spec.kind == "nan" else float("inf")
    return flat.view(x.shape)


def maybe_corrupt_wire(tensors: tuple, g, round_idx: Optional[int] = None) -> tuple:
    """Wire-corruption hook, applied by the collectives to every RECEIVED
    compressed payload (``tensors``, in wire order).  Flips ``spec.n``
    seeded bits of the first tensor (the packed stream, int32 words) on
    the target ranks; identity for other faults, for payloads whose first
    tensor is not int32 words (the lossless fallback's f32) and, under a
    round-targeted spec, for exchanges of other rounds or of none.

    The flips go into a NEW tensor: on a ``ThreadGroup`` the received
    tensors are the sender's own, and flipping them in place would change
    the sender's copy too (its checksum would then agree, and detection
    would go silent)."""
    spec = _ACTIVE
    if spec is None or spec.kind != "bitflip" or g.rank not in spec.ranks:
        return tensors
    if spec.rounds is not None and round_idx not in spec.rounds:
        return tensors
    leaf = tensors[0]
    if leaf.dtype != torch.int32 or leaf.numel() == 0:
        return tensors
    rng = np.random.default_rng(spec.seed)
    flat = leaf.reshape(-1).clone()
    for _ in range(spec.n):
        word = int(rng.integers(flat.shape[0]))
        bit = int(rng.integers(32))
        flat[word] ^= (1 << bit) - (1 << 32 if bit == 31 else 0)  # int32 bits
    return (flat.view(leaf.shape),) + tuple(tensors[1:])
