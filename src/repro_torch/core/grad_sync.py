"""Data-parallel gradient sync through the compressed allreduce.

The counterpart of the data-parallel half of ``repro.core.grad_sync``:
``dp_allreduce_grads{,_stats}`` sums a gradient tree (nested dicts,
lists and tuples of tensors) across the ranks of one axis or of several,
called as a rank of a ``ThreadGroup`` or ``DistGroup`` bound to that
axis name, or of a mesh that binds those axes.

The tree is tiled by a memoized ``BucketLedger`` (``core/buckets.py``)
into equal ``SyncConfig.bucket_bytes`` payloads, and each bucket is one
``GZCommunicator.allreduce`` (or ``GZHierCommunicator.allreduce``),
issued last-layer-first (the reference's ``lax.scan`` is a Python loop
over the buckets in issue order).  Each
bucket is gathered from the leaves, synced and written back into the
output leaves on its own, so no stack of payloads is ever held.  With
``relative_eb`` the absolute eb is ``eb * RMS`` of the whole tree over
all ranks: one ``sum_across`` of the per-rank sums of squares, folded in
rank order, so every rank quantizes on the same grid.

Values are bitwise the reference's: leaves are flattened in JAX's order
(dict keys sorted), the sums of squares follow XLA's CPU reduction order
(``_sum_squares``), and ``_dp_allreduce_whole_tree_stats`` (the
whole-tree ravel and chunk scan, kept as the reference) gives the same
bits as the bucketed path.

The degradation policy is the communicator's, per bucket: under
``gz.on_overflow="fallback"`` a bucket that overflowed or saw NaN/Inf is
the lossless rank-order sum of its payload (bitwise the reference's
recovery bucket), and ``SyncStats`` still reports the flags; under
``"raise"`` the sync raises.

Several axis names resolve one two-level plan (``GZHierCommunicator``):
the last axis is the slow inter-node one, every axis before it collapses
into "local"; the ranks are a mesh that binds those axes and their
composites (``core/transport.py``).  The relative-eb scale then folds
over the composite of ``axis_names`` in their order (the reference's
``psum`` over the tuple), the buckets go through the hier communicator,
and ``SyncStats.wire_bytes`` counts its inter-node wire.

The port's communicators plan at its default ``hw`` point
(``cost_model.A100_SLINGSHOT``); the reference's at its own.  With an
explicit algorithm and codec (the default ``SyncConfig``) both resolve
the same single-axis schedule; over several axes the port's point has a
link asymmetry and may resolve hierarchical where the reference resolves
flat.  The FSDP gather and reduce-scatter, with ``mark_degraded`` and the
trainer's skip of a degraded step (``_skip_merge``), are not ported
(ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from repro_torch.core import transport
from repro_torch.core.buckets import ledger_for
from repro_torch.core.collectives import GZConfig
from repro_torch.core.comm import GZCommunicator, GZHierCommunicator
from repro_torch.kernels import ref

__all__ = [
    "SyncConfig",
    "SyncStats",
    "tree_flatten",
    "dp_allreduce_grads",
    "dp_allreduce_grads_stats",
]


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """How gradients cross the wire (``repro.core.grad_sync.SyncConfig``'s
    fields, defaults and validation).

    ``gz``: the compressed allreduce's knobs, or None for an exact sum;
    ``relative_eb``: scale eb by the tree's global RMS; ``bucket_bytes``:
    the f32 payload of one collective call; ``pipeline_chunks``: 0 plans
    the ring depth per bucket, > 0 forces it; ``mark_degraded`` belongs
    to the FSDP path (ROADMAP A11) and is only validated here.
    """

    gz: Optional[GZConfig] = GZConfig(eb=1e-4, algo="redoub", worst_case_budget=False)
    relative_eb: bool = True
    bucket_bytes: int = 16 * 1024 * 1024
    pipeline_chunks: int = 0
    mark_degraded: bool = False

    def __post_init__(self):
        if self.pipeline_chunks < 0 or (
            self.pipeline_chunks > 0
            and self.pipeline_chunks & (self.pipeline_chunks - 1)
        ):
            raise ValueError(
                "SyncConfig.pipeline_chunks must be 0 (plan the ring depth "
                "from the cost model) or a power of two >= 1 (forced "
                f"depth); got {self.pipeline_chunks!r}"
            )
        if (not isinstance(self.bucket_bytes, int)
                or self.bucket_bytes < 4 or self.bucket_bytes % 4):
            raise ValueError(
                "SyncConfig.bucket_bytes must be a positive multiple of 4 "
                "(whole f32 elements per bucket payload); got "
                f"{self.bucket_bytes!r}"
            )

    def with_algo(self, algo: str) -> "SyncConfig":
        if self.gz is None:
            raise ValueError(
                "SyncConfig.with_algo: this SyncConfig has gz=None "
                "(uncompressed psum sync) — there is no GZConfig to set an "
                "algorithm on; construct one explicitly, e.g. "
                "SyncConfig(gz=GZConfig(algo=...))"
            )
        return dataclasses.replace(self, gz=dataclasses.replace(self.gz, algo=algo))


DEFAULT_SYNC = SyncConfig()


@dataclasses.dataclass(frozen=True)
class SyncStats:
    """Health flags of one gradient sync, OR-ed across every bucket and
    rank (0-d bool tensors, equal on every rank), and the static wire
    facts: provisioned bytes per rank for the whole tree and the number
    of bucket collectives."""

    overflow: torch.Tensor
    nonfinite: torch.Tensor
    wire_bytes: int = 0
    n_buckets: int = 0

    @property
    def degraded(self) -> torch.Tensor:
        """True iff this sync overflowed or saw non-finite input."""
        return self.overflow | self.nonfinite


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def tree_flatten(tree):
    """(leaves, rebuild) of a tree of nested dicts, lists and tuples, in
    ``jax.tree.flatten``'s order (dict keys sorted); ``rebuild(leaves)``
    puts new leaves back in the same structure."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [tree_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    counts = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(new):
        out, i = [], 0
        for (_, fn), c in zip(parts, counts):
            out.append(fn(new[i:i + c]))
            i += c
        if keys is not None:
            vals = dict(zip(keys, out))
            return {k: vals[k] for k in tree}
        return type(tree)(out)

    return leaves, rebuild


# ---------------------------------------------------------------------------
# The relative-eb scale
# ---------------------------------------------------------------------------

_WINDOW = 32  # XLA's CPU tree-reduction window


def _sum_squares(v: torch.Tensor) -> torch.Tensor:
    """f32 sum of ``v ** 2`` (1-D), in the reference's order on the CPU.

    XLA's CPU backend rewrites a long reduction into windows of 32 (the
    input padded evenly on both sides, each window summed in order from
    0), recursively, and sums the last <= 32 values in order.  A leaf of
    at most 32 elements is one fused loop, ``s = fma(v_i, v_i, s)``.  The
    sum is built from exact f32 adds in that order (and the exact FMA of
    ``ref.fma_f32``), so it has the same bits on any device.
    """
    n = v.numel()
    zero = torch.zeros((), dtype=torch.float32, device=v.device)
    if n <= _WINDOW:
        s = zero
        for i in range(n):
            s = ref.fma_f32(v[i], v[i], s)
        return s
    y = v * v
    while y.numel() > _WINDOW:
        n = y.numel()
        m = -(-n // _WINDOW) * _WINDOW
        lo = (m - n) // 2
        padded = torch.zeros(m, dtype=torch.float32, device=v.device)
        padded[lo:lo + n] = y
        cols = padded.view(-1, _WINDOW)
        y = torch.zeros(m // _WINDOW, dtype=torch.float32, device=v.device)
        for j in range(_WINDOW):
            y = y + cols[:, j]
    s = zero
    for i in range(y.numel()):
        s = s + y[i]
    return s


def _tree_scale(leaves_f32, g) -> torch.Tensor:
    """The relative-eb scale of a list of 1-D f32 leaves: per-leaf sums of
    squares accumulated in leaf order, one ``sum_across`` over the ranks
    of ``g`` (the composite of every synced axis),
    ``sqrt(ss * (1 / count))`` (XLA turns the reference's division by the
    constant count into that product), floored at 1e-30 and pinned to 1
    when not finite."""
    ss = torch.zeros((), dtype=torch.float32, device=leaves_f32[0].device)
    cnt = 0.0
    for leaf in leaves_f32:
        ss = ss + _sum_squares(leaf)
        cnt += float(leaf.numel())
    ss = g.sum_across(ss)
    cnt *= g.size
    inv = (torch.ones((), dtype=torch.float32)
           / torch.tensor(max(cnt, 1.0), dtype=torch.float32)).to(ss.device)
    scale = torch.sqrt(ss * inv).clamp(min=1e-30)
    return torch.where(torch.isfinite(scale), scale, torch.ones_like(scale))


# ---------------------------------------------------------------------------
# Sync
# ---------------------------------------------------------------------------


def _comm(axis_name, sync: SyncConfig, device) -> GZCommunicator:
    """The memoized per-axis communicator: a forced depth is written into
    the knobs; otherwise the plan picks the ring depth even for an
    explicitly requested algorithm."""
    cfg = sync.gz
    if sync.pipeline_chunks > 0:
        cfg = dataclasses.replace(cfg, pipeline_chunks=sync.pipeline_chunks)
        return GZCommunicator.for_config(axis_name, cfg, device=device)
    return GZCommunicator.for_config(axis_name, cfg, device=device, auto_depth=True)


def _hier_comm(axis_names, sync: SyncConfig, device) -> GZHierCommunicator:
    """The memoized two-level communicator of a several-axis sync: the
    last axis is the node axis, the others collapse into local; depth as
    in :func:`_comm`.  Its topology is read from the bound handles per
    call."""
    node = axis_names[-1]
    local = axis_names[0] if len(axis_names) == 2 else tuple(axis_names[:-1])
    cfg = sync.gz
    if sync.pipeline_chunks > 0:
        cfg = dataclasses.replace(cfg, pipeline_chunks=sync.pipeline_chunks)
        return GZHierCommunicator.for_axes(node, local, config=cfg, device=device)
    return GZHierCommunicator.for_axes(node, local, config=cfg, device=device,
                                       auto_depth=True)


def _prepare(grads, axis_names, sync, device):
    """(sync, axis names, group, leaves, rebuild, flat f32 leaves); the
    group is the handle of the one axis, or of the composite of all."""
    sync = DEFAULT_SYNC if sync is None else sync
    axis_names = tuple(axis_names)
    if not axis_names:
        raise ValueError(
            "dp_allreduce_grads: axis_names is empty — pass the axis to sum "
            "over (a silent no-op here would skip gradient sync)"
        )
    leaves, rebuild = tree_flatten(grads)
    if not leaves:
        raise ValueError(
            "dp_allreduce_grads: empty gradient tree — nothing to sync "
            "(a silent no-op here would skip gradient sync)"
        )
    device = transport.resolve_device(device)
    for leaf in leaves:
        if leaf.device.type != device.type:
            raise ValueError(f"gradient sync runs on {device}, got a leaf on {leaf.device}")
    g = transport.current(axis_names[0] if len(axis_names) == 1 else axis_names)
    flat = [leaf.to(torch.float32).reshape(-1) for leaf in leaves]
    return sync, axis_names, g, leaves, rebuild, flat


def _allreduce_fn(axis_names, g, sync, device):
    """One bucket's collective: the single-axis communicator on ``g``, or
    the two-level one over the bound mesh."""
    if len(axis_names) == 1:
        comm = _comm(axis_names[0], sync, device)
        return lambda x: comm.allreduce(x, group=g)
    return _hier_comm(axis_names, sync, device).allreduce


def _finish_tree(out_flat, leaves, rebuild):
    return rebuild([o.reshape(leaf.shape).to(leaf.dtype)
                    for o, leaf in zip(out_flat, leaves)])


def _psum_tree_stats(flat, g):
    """The gz=None path: an exact rank-order sum per leaf and one
    non-finite flag."""
    out = [g.sum_across(leaf) for leaf in flat]
    bad = torch.zeros((), dtype=torch.bool, device=flat[0].device)
    for leaf in flat:
        bad = bad | ~torch.isfinite(leaf).all()
    (nf,) = g.flags_across(bad)
    no = torch.zeros((), dtype=torch.bool, device=flat[0].device)
    return out, SyncStats(overflow=no, nonfinite=nf,
                          wire_bytes=4 * sum(leaf.numel() for leaf in flat),
                          n_buckets=0)


def dp_allreduce_grads_stats(grads, axis_names: Sequence[str],
                             sync: Optional[SyncConfig] = None, *, device="cuda"):
    """Sum a gradient tree across the ranks of ``axis_names`` (one axis,
    or several through the two-level plan).

    Returns ``(summed tree, SyncStats)``; callers divide by the rank
    count for a mean and should consult ``stats.degraded`` before applying
    the update under ``on_overflow="flag"`` (under ``"fallback"`` the
    values are already exact; the flags then say the lossless path ran).
    Every leaf lies on ``device`` ("cuda" unless the caller
    asks for "cpu").  Bitwise the reference's ``dp_allreduce_grads_stats``
    (module docstring).
    """
    sync, axis_names, g, leaves, rebuild, flat = _prepare(grads, axis_names, sync, device)
    if sync.gz is None:
        out, stats = _psum_tree_stats(flat, g)
        return _finish_tree(out, leaves, rebuild), stats
    scale = _tree_scale(flat, g) if sync.relative_eb else None
    ledger = ledger_for([leaf.shape for leaf in leaves], sync.bucket_bytes)
    allreduce = _allreduce_fn(axis_names, g, sync, device)
    out = [torch.empty(math.prod(leaf.shape), dtype=torch.float32, device=leaf.device)
           for leaf in leaves]
    ovf = nf = torch.zeros((), dtype=torch.bool, device=flat[0].device)
    wire = 0
    for bucket in ledger.issue_order():
        payload = ledger.gather(flat, bucket)
        if scale is not None:
            payload = payload / scale  # zero padding stays zero
        res = allreduce(payload)
        ovf, nf, wire = ovf | res.overflow, nf | res.nonfinite, res.wire_bytes
        synced = res.value * scale if scale is not None else res.value
        ledger.scatter(synced, bucket, out)
        del payload, res, synced  # one bucket's buffers at a time
    stats = SyncStats(overflow=ovf, nonfinite=nf, wire_bytes=wire * ledger.n_buckets,
                      n_buckets=ledger.n_buckets)
    return _finish_tree(out, leaves, rebuild), stats


def _dp_allreduce_whole_tree_stats(grads, axis_names: Sequence[str],
                                   sync: Optional[SyncConfig] = None, *,
                                   device="cuda"):
    """REFERENCE: the whole-tree ravel and fixed-size chunk scan in ravel
    order, kept for the bitwise-equality contract with the bucketed path
    (the same scale, the same per-chunk collectives)."""
    sync, axis_names, g, leaves, rebuild, flat = _prepare(grads, axis_names, sync, device)
    if sync.gz is None:
        out, stats = _psum_tree_stats(flat, g)
        return _finish_tree(out, leaves, rebuild), stats
    scale = _tree_scale(flat, g) if sync.relative_eb else None
    if scale is not None:
        flat = [leaf / scale for leaf in flat]
    whole = torch.cat(flat)
    n = whole.numel()
    chunk = min(sync.bucket_bytes // 4, n)
    n_chunks = -(-n // chunk)
    padded = torch.zeros(n_chunks * chunk, dtype=torch.float32, device=whole.device)
    padded[:n] = whole
    allreduce = _allreduce_fn(axis_names, g, sync, device)
    ovf = nf = torch.zeros((), dtype=torch.bool, device=whole.device)
    rows, wire = [], 0
    for row in padded.view(n_chunks, chunk):
        res = allreduce(row)
        ovf, nf, wire = ovf | res.overflow, nf | res.nonfinite, res.wire_bytes
        rows.append(res.value)
    out_flat = torch.cat(rows)[:n]
    if scale is not None:
        out_flat = out_flat * scale
    out = list(torch.split(out_flat, [leaf.numel() for leaf in leaves]))
    stats = SyncStats(overflow=ovf, nonfinite=nf, wire_bytes=wire * n_chunks,
                      n_buckets=n_chunks)
    return _finish_tree(out, leaves, rebuild), stats


def dp_allreduce_grads(grads, axis_names: Sequence[str],
                       sync: Optional[SyncConfig] = None, *, device="cuda"):
    """Single-return wrapper over :func:`dp_allreduce_grads_stats` (drops
    the health flags; prefer the ``_stats`` form)."""
    return dp_allreduce_grads_stats(grads, axis_names, sync, device=device)[0]
