"""Deterministic bucket ledger for gradient trees.

The counterpart of ``repro.core.buckets``: built once per (leaf shapes,
bucket_bytes), a ``BucketLedger`` tiles the tree's ravel order into
equal-payload buckets (the last zero-padded) and records, for every
bucket, which slices of which leaves it carries.

  * **Exact tiling.**  Every element of every leaf lands in exactly one
    bucket slice, with no gaps and no overlap (``assert_tiles_exactly``).
  * **Bitwise equivalence to the whole-tree chunk scan.**  Bucket ``i``'s
    payload is element for element chunk ``i`` of the whole-tree ravel,
    and every bucket's collective is independent of the others, so the
    buckets may be issued in any order (last-layer-first, the order in
    which backward completes gradients) with the same values.

Ledgers are memoized per (shapes, bucket_bytes); ``ledger_cache_stats``
counts hits and misses.
"""
from __future__ import annotations

import dataclasses
import math
import threading

import torch

__all__ = [
    "LeafSlice",
    "Bucket",
    "BucketLedger",
    "build_ledger",
    "ledger_for",
    "ledger_cache_stats",
    "clear_ledger_cache",
]


@dataclasses.dataclass(frozen=True)
class LeafSlice:
    """One contiguous run of a leaf's ravel order inside one bucket."""

    leaf: int    # index into the flattened leaf list
    start: int   # element range within the leaf's own ravel order
    stop: int
    offset: int  # where the run sits inside the bucket payload

    @property
    def size(self) -> int:
        return self.stop - self.start


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One wire quantum: ``n_elems`` real elements, zero-padded to the
    ledger's uniform ``bucket_elems`` payload (one frozen Plan serves
    every bucket)."""

    index: int     # position in ravel order (0 == first elements)
    n_elems: int   # real elements; payload[n_elems:] is padding
    slices: tuple  # LeafSlice runs, in ravel order


@dataclasses.dataclass(frozen=True)
class BucketLedger:
    """Frozen tiling of a fixed leaf structure into equal buckets."""

    shapes: tuple        # per-leaf shapes (the construction identity)
    bucket_elems: int    # payload length of EVERY bucket
    total_elems: int
    buckets: tuple       # Bucket..., in ravel order

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def issue_order(self) -> tuple:
        """Buckets last-layer-first: the reverse of ravel order."""
        return tuple(reversed(self.buckets))

    def gather(self, flat_leaves, bucket: Bucket) -> torch.Tensor:
        """One bucket's padded payload from 1-D leaf views (a new tensor)."""
        parts = [flat_leaves[s.leaf][s.start:s.stop] for s in bucket.slices]
        vec = torch.zeros(self.bucket_elems, dtype=parts[0].dtype, device=parts[0].device)
        torch.cat(parts, out=vec[:bucket.n_elems])
        return vec

    def scatter(self, vec: torch.Tensor, bucket: Bucket, flat_out) -> None:
        """Write one bucket's payload back into 1-D output leaves, in place
        (padding dropped)."""
        for s in bucket.slices:
            flat_out[s.leaf][s.start:s.stop] = vec[s.offset:s.offset + s.size]

    def stack_payloads(self, flat_leaves) -> torch.Tensor:
        """(n_buckets, bucket_elems) payload stack in ISSUE order."""
        return torch.stack([self.gather(flat_leaves, b) for b in self.issue_order()])

    def unstack(self, stacked) -> list:
        """Invert :meth:`stack_payloads`: rows in issue order -> per-leaf
        1-D tensors (padding dropped)."""
        ref = stacked[0]
        out = [torch.empty(math.prod(s), dtype=ref.dtype, device=ref.device)
               for s in self.shapes]
        for pos, bucket in enumerate(self.issue_order()):
            self.scatter(stacked[pos], bucket, out)
        return out

    def assert_tiles_exactly(self) -> None:
        """Every leaf element covered exactly once, in ravel order, with
        per-bucket offsets forming a gapless run of n_elems."""
        sizes = [int(math.prod(s)) for s in self.shapes]
        cursor = {i: 0 for i in range(len(sizes))}
        total = 0
        for bucket in self.buckets:
            if not 0 < bucket.n_elems <= self.bucket_elems:
                raise AssertionError(f"bucket {bucket.index}: {bucket.n_elems} elements")
            off = 0
            for s in bucket.slices:
                if (s.offset != off or s.start != cursor[s.leaf]
                        or s.stop > sizes[s.leaf]):
                    raise AssertionError(f"bucket {bucket.index}: bad slice {s}")
                cursor[s.leaf] = s.stop
                off += s.size
            if off != bucket.n_elems:
                raise AssertionError(f"bucket {bucket.index}: slices cover {off}")
            total += bucket.n_elems
        if not total == self.total_elems == sum(sizes):
            raise AssertionError(f"tiling covers {total} of {sum(sizes)} elements")
        if any(cursor[i] != sizes[i] for i in cursor):
            raise AssertionError(f"leaves not covered: {cursor} vs {sizes}")


def build_ledger(shapes, bucket_bytes: int, *, elem_bytes: int = 4) -> BucketLedger:
    """Tile leaves of ``shapes`` (ravel order) into equal-payload buckets of
    ``min(bucket_bytes // elem_bytes, total)`` elements."""
    shapes = tuple(tuple(int(d) for d in s) for s in shapes)
    sizes = [int(math.prod(s)) for s in shapes]
    total = sum(sizes)
    if total == 0:
        raise ValueError(
            "build_ledger: the leaf structure has zero elements — an empty "
            "gradient tree cannot be bucketed (and silently skipping gradient "
            "sync would be a correctness bug)"
        )
    if bucket_bytes < elem_bytes:
        raise ValueError(
            f"build_ledger: bucket_bytes={bucket_bytes!r} holds no "
            f"{elem_bytes}-byte element"
        )
    bucket_elems = min(bucket_bytes // elem_bytes, total)
    n_buckets = -(-total // bucket_elems)

    buckets = []
    leaf, leaf_off = 0, 0
    for index in range(n_buckets):
        lo = index * bucket_elems
        hi = min(lo + bucket_elems, total)
        slices, off = [], 0
        while off < hi - lo:
            take = min(sizes[leaf] - leaf_off, (hi - lo) - off)
            if take > 0:
                slices.append(LeafSlice(leaf=leaf, start=leaf_off,
                                        stop=leaf_off + take, offset=off))
                leaf_off += take
                off += take
            if leaf_off == sizes[leaf] and leaf < len(sizes) - 1:
                leaf, leaf_off = leaf + 1, 0
        buckets.append(Bucket(index=index, n_elems=hi - lo, slices=tuple(slices)))
    ledger = BucketLedger(shapes=shapes, bucket_elems=bucket_elems,
                          total_elems=total, buckets=tuple(buckets))
    ledger.assert_tiles_exactly()
    return ledger


_LEDGER_CACHE: dict = {}
_LEDGER_STATS = {"hits": 0, "misses": 0}
_LEDGER_LOCK = threading.Lock()  # the rank threads of a ThreadGroup share the cache


def ledger_for(shapes, bucket_bytes: int) -> BucketLedger:
    """Memoized :func:`build_ledger`."""
    key = (tuple(tuple(int(d) for d in s) for s in shapes), int(bucket_bytes))
    with _LEDGER_LOCK:
        hit = _LEDGER_CACHE.get(key)
        _LEDGER_STATS["hits" if hit is not None else "misses"] += 1
        if hit is None:
            hit = _LEDGER_CACHE[key] = build_ledger(shapes, bucket_bytes)
    return hit


def ledger_cache_stats() -> dict:
    return {"hits": _LEDGER_STATS["hits"], "misses": _LEDGER_STATS["misses"],
            "entries": len(_LEDGER_CACHE)}


def clear_ledger_cache() -> None:
    with _LEDGER_LOCK:
        _LEDGER_CACHE.clear()
        _LEDGER_STATS["hits"] = 0
        _LEDGER_STATS["misses"] = 0
