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
flat.

The FSDP half (ZeRO-3 sharding of the weights over one axis):

  * ``fsdp_all_gather`` — the reference's ``custom_vjp`` as a
    ``torch.autograd.Function``: its forward gathers the shard along
    dim 0 (``GZCommunicator.allgather`` of the f32 cast under a
    ``SyncConfig.gz``, else the exact ``all_gather``), its backward is
    ``fsdp_reduce_scatter_stats`` of the cotangent.  Under
    ``mark_degraded`` a degraded gather or reduce-scatter turns its
    result to NaN, which the trainer's per-leaf probe catches.  Its
    backward runs only on the rank's own thread: a backward on another
    thread (CUDA's autograd thread on a one-card ``ThreadGroup``) raises
    instead of waiting for peers that cannot come.
  * ``fsdp_reduce_scatter{,_stats}`` — sum-and-shard along dim 0:
    ``GZCommunicator.reduce_scatter`` of the flat f32 cotangent, or the
    exact sum in f32, in rank order, rounded once to the cotangent's
    dtype (what XLA's CPU reduce-scatter computes, bf16 included).
  * ``FsdpStep`` — the train step's route, with no collective on the
    autograd thread: in the step's forward each gather runs on the rank
    thread and keeps its result; a recompute (remat, bound to the step
    through ``fsdp_recompute_context``) finds it by the shard slice it
    came from; the backward only records each
    application's cotangent; after backward, on the rank thread, each
    cotangent is reduce-scattered as ``fsdp_all_gather``'s backward
    would, and the shard gradients are summed in the order autograd
    sums them, so both routes give the same bits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
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
    "fsdp_all_gather",
    "fsdp_reduce_scatter",
    "fsdp_reduce_scatter_stats",
    "FsdpStep",
    "fsdp_gather",
    "fsdp_recompute_context",
]


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """How gradients cross the wire (``repro.core.grad_sync.SyncConfig``'s
    fields, defaults and validation).

    ``gz``: the compressed allreduce's knobs, or None for an exact sum;
    ``relative_eb``: scale eb by the tree's global RMS; ``bucket_bytes``:
    the f32 payload of one collective call; ``pipeline_chunks``: 0 plans
    the ring depth per bucket, > 0 forces it; ``mark_degraded``: an FSDP
    gather or reduce-scatter that overflowed or saw NaN/Inf returns NaN
    instead of silently lossy values (the trainer's per-leaf probe then
    flags the step).
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


# ---------------------------------------------------------------------------
# FSDP gather / reduce-scatter
# ---------------------------------------------------------------------------


def _nan_where(bad: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out`` turned to NaN where the 0-d flag ``bad`` is set (the
    reference's ``jnp.where(bad, nan, out)``)."""
    return torch.where(bad, torch.full_like(out, float("nan")), out)


def _fsdp_gather_impl(x: torch.Tensor, g, axis_name, sync: Optional[SyncConfig]):
    """The shard ``x`` (s, ...) gathered over the ranks of ``g`` along dim 0:
    (n*s, ...) in ``x``'s dtype."""
    shape = (g.size * x.shape[0],) + tuple(x.shape[1:])
    if sync is None or sync.gz is None:
        return g.all_gather((x,))[0].reshape(shape)
    res = _comm(axis_name, sync, x.device).allgather(x.reshape(-1).to(torch.float32), group=g)
    out = res.value
    if sync.mark_degraded:
        # a degraded gather already corrupted the weights: NaN makes it loud
        out = _nan_where(res.overflow | res.nonfinite, out)
    return out.to(x.dtype).reshape(shape)


def _fsdp_reduce_scatter_impl(ct: torch.Tensor, g, axis_name,
                              sync: Optional[SyncConfig]):
    """Sum ``ct`` (n*s, ...) over the ranks of ``g`` and keep this rank's
    block of dim 0: ((s, ...), SyncStats)."""
    n, shape = g.size, tuple(ct.shape)
    if not shape or shape[0] % n:
        raise ValueError(f"FSDP reduce-scatter over {n} ranks: dim 0 of a {shape} "
                         "cotangent does not split into equal blocks")
    out_shape = (shape[0] // n,) + shape[1:]
    if sync is None or sync.gz is None:
        # the reference's psum_scatter: XLA's CPU reduce-scatter sums in
        # f32, in rank order, and rounds once to the cotangent's dtype
        parts = g.all_to_all((ct.to(torch.float32).reshape(n, -1),))[0]
        out = parts[0]
        for i in range(1, n):
            out = out + parts[i]
        (nf,) = g.flags_across(~torch.isfinite(ct).all())
        no = torch.zeros((), dtype=torch.bool, device=ct.device)
        return (out.to(ct.dtype).reshape(out_shape),
                SyncStats(overflow=no, nonfinite=nf, wire_bytes=ct.numel() * 4,
                          n_buckets=0))
    res = _comm(axis_name, sync, ct.device).reduce_scatter(
        ct.to(torch.float32).reshape(-1), group=g)
    return (res.value.to(ct.dtype).reshape(out_shape),
            SyncStats(overflow=res.overflow, nonfinite=res.nonfinite,
                      wire_bytes=res.wire_bytes, n_buckets=1))


def _shard_gradient(ct, g, axis_name, sync):
    """What the gather's backward returns for cotangent ``ct``: the
    reduce-scattered block, NaN-marked if degraded under ``mark_degraded``."""
    out, stats = _fsdp_reduce_scatter_impl(ct, g, axis_name, sync)
    if sync is not None and sync.mark_degraded:
        out = _nan_where(stats.degraded, out)
    return out


def fsdp_reduce_scatter_stats(g: torch.Tensor, axis_name,
                              sync: Optional[SyncConfig] = None):
    """Sum-and-shard along the leading axis with health flags:
    (n*s, ...) -> ((s, ...), SyncStats); the rank of ``axis_name`` bound
    on this thread."""
    return _fsdp_reduce_scatter_impl(g, transport.current(axis_name), axis_name, sync)


def fsdp_reduce_scatter(g: torch.Tensor, axis_name,
                        sync: Optional[SyncConfig] = None) -> torch.Tensor:
    """Sum-and-shard along the leading axis: (n*s, ...) -> (s, ...)."""
    return fsdp_reduce_scatter_stats(g, axis_name, sync)[0]


class _FsdpAllGather(torch.autograd.Function):
    """The reference's ``custom_vjp``: gather forward, reduce-scatter
    backward, both on the rank handle bound in forward."""

    @staticmethod
    def forward(ctx, x, axis_name, sync):
        ctx.g, ctx.axis_name, ctx.sync = transport.current(axis_name), axis_name, sync
        return _fsdp_gather_impl(x, ctx.g, axis_name, sync)

    @staticmethod
    def backward(ctx, ct):
        thread = getattr(ctx.g, "thread", None)
        if thread is not None and thread is not threading.current_thread():
            raise RuntimeError(
                f"fsdp_all_gather backward of ThreadGroup rank {ctx.g.rank} runs on "
                f"thread {threading.current_thread().name!r}, not on the rank's own "
                "thread (the autograd engine runs CUDA backward nodes on a device "
                "thread), so the ranks' reduce-scatters cannot meet; train through "
                "launch.training.make_train_step (FsdpStep: the reduce-scatters run "
                "after backward, on the rank threads) or take gradients through "
                "DistGroup (one process per rank)")
        return _shard_gradient(ct, ctx.g, ctx.axis_name, ctx.sync), None, None


def fsdp_all_gather(x: torch.Tensor, axis_name, sync: Optional[SyncConfig] = None):
    """All-gather a parameter shard along its leading (FSDP) axis: (s, ...)
    local shard -> (n*s, ...) full parameter, differentiable: the backward
    is the matching reduce-scatter of the cotangent.  With a gz
    ``SyncConfig`` the forward is the compressed allgather (one lossy hop)
    and the backward the compressed reduce-scatter.  The backward must run
    on the rank's own thread (module docstring)."""
    return _FsdpAllGather.apply(x, axis_name, sync)


# ---------------------------------------------------------------------------
# The train step's route: no collective on the autograd thread
# ---------------------------------------------------------------------------

_BOUND = threading.local()  # .step: (FsdpStep, replay) whose gathers run on this thread


class _Bound:
    """Binds ``step`` to the thread that enters it: its forward
    (``replay`` False: gathers run) or a recompute of it (``replay``
    True: gathers take the forward's results).  Re-entrant, as
    ``torch.utils.checkpoint`` enters a recompute context once a
    recompute."""

    def __init__(self, step, replay: bool):
        self.step, self.replay, self._prev = step, replay, []

    def __enter__(self):
        self._prev.append(getattr(_BOUND, "step", None))
        _BOUND.step = (self.step, self.replay)
        return self.step

    def __exit__(self, *exc):
        _BOUND.step = self._prev.pop()
        return False


class _Recompute:
    """Around one recompute, on whatever thread it runs: the forward
    thread's transport bindings and, if the forward ran in one, its
    ``FsdpStep`` in replay."""

    def __init__(self, handles: dict, step):
        self._handles, self._step, self._stacks = handles, step, []

    def __enter__(self):
        stack = contextlib.ExitStack()
        stack.enter_context(transport.bound(self._handles))
        if self._step is not None:
            stack.enter_context(_Bound(self._step, replay=True))
        self._stacks.append(stack)
        return self

    def __exit__(self, *exc):
        self._stacks.pop().close()
        return False


def fsdp_recompute_context():
    """``torch.utils.checkpoint``'s ``context_fn`` for a layer that may
    gather or reach a collective: its forward runs as it is; its
    recompute, on whatever thread autograd runs it (CUDA's autograd
    thread), finds the rank handles the forward's thread had bound (a TP
    collective in the layer reaches its ranks again; on a ``DistMesh``
    they are this process's) and is bound to the step whose forward this
    is, so its FSDP gathers take the forward's results and launch no
    collective."""
    bound = getattr(_BOUND, "step", None)
    return contextlib.nullcontext(), _Recompute(transport.bindings(),
                                                None if bound is None else bound[0])


def _slice_key(x: torch.Tensor, dim: int) -> tuple:
    """What identifies a gathered shard slice, however often its view is
    made again: its storage, offset, shape, stride and the gather's dim."""
    return (x.untyped_storage().data_ptr(), x.storage_offset(), tuple(x.shape),
            tuple(x.stride()), dim)


class _RecordedGather(torch.autograd.Function):
    """The gathered weight as a function of the shard, for autograd: its
    backward records the cotangent for ``FsdpStep.reduce_scatter`` and
    gives the shard no gradient."""

    @staticmethod
    def forward(ctx, moved, full, step, key):
        ctx.step, ctx.key = step, key
        return full.view_as(full)

    @staticmethod
    def backward(ctx, ct):
        ctx.step._records.append((ctx.key, ct))
        return None, None, None, None


class FsdpStep:
    """One rank's FSDP gathers and reduce-scatters over one train step,
    with no collective on the autograd thread (ROADMAP C6).

    ``leaves``: the rank's parameter shards, as given to autograd;
    ``data_dims``: the dim of each leaf's spec that lies over
    ``axis_name`` (None for a replicated leaf).  Use::

        fs = FsdpStep(axis_name, sync, leaves, data_dims)
        with fs.forward():
            loss = model.loss_fn(params, batch)  # ParallelCtx.gather
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = fs.reduce_scatter(grads)

    In ``forward()`` every gather (``fsdp_gather``) runs the collective on
    this thread and keeps its result under the shard slice's key.  A
    layer checkpointed with ``fsdp_recompute_context`` recomputes bound to
    this step, on whatever thread autograd runs it, and its gathers take
    the kept results, or raise if there is none.  Each application's
    backward records its cotangent; ``reduce_scatter`` reduce-scatters
    every record on this thread, in the same order on every rank, and
    sums each leaf's blocks in the order autograd would have summed
    ``fsdp_all_gather``'s gradients (arrival order), so the shard
    gradients equal that route's by bits.  The step holds every gathered
    weight and every cotangent until ``reduce_scatter``."""

    def __init__(self, axis_name, sync: Optional[SyncConfig], leaves, data_dims):
        self.axis_name, self.sync = axis_name, sync
        self.group = transport.current(axis_name)
        self._leaves = list(leaves)
        self._dims = list(data_dims)
        self._memo: dict = {}
        self._where: dict = {}  # key -> (leaf number, slice index or None, dim)
        self._records: list = []
        self._by_storage: dict = {}
        for i, (leaf, d) in enumerate(zip(self._leaves, self._dims)):
            if d is not None:
                self._by_storage.setdefault(leaf.untyped_storage().data_ptr(), []).append(i)

    def forward(self) -> _Bound:
        """The step's forward on this thread: gathers run here."""
        return _Bound(self, replay=False)

    def _resolve(self, x: torch.Tensor, key) -> tuple:
        """(leaf number, slice index or None) of a gathered tensor: a whole
        sharded leaf gathered along its spec's dim, or a dim-0 slice of a
        stacked one gathered along the slice's."""
        dim = key[-1]
        for i in self._by_storage.get(key[0], ()):
            leaf, d = self._leaves[i], self._dims[i]
            off = x.storage_offset() - leaf.storage_offset()
            if x.shape == leaf.shape and x.stride() == leaf.stride() and off == 0:
                if dim != d:
                    raise ValueError(f"FSDP gather along dim {dim} of a leaf whose spec "
                                     f"shards dim {d}")
                return i, None
            if (x.shape == leaf.shape[1:] and x.stride() == leaf.stride()[1:]
                    and off % leaf.stride(0) == 0 and 0 <= off // leaf.stride(0) < len(leaf)):
                if dim != d - 1:
                    raise ValueError(f"FSDP gather along dim {dim} of a layer slice whose "
                                     f"spec shards dim {d - 1}")
                return i, off // leaf.stride(0)
        raise ValueError(f"FSDP gather of a {tuple(x.shape)} tensor that is neither a sharded "
                         "leaf of this step nor a dim-0 slice of one")

    def _apply(self, x, dim, key, full):
        moved = x.movedim(dim, 0) if dim else x
        out = _RecordedGather.apply(moved, full, self, key)
        return out.movedim(0, dim) if dim else out

    def _gather(self, x: torch.Tensor, dim: int, key) -> torch.Tensor:
        if key not in self._where:
            self._where[key] = self._resolve(x, key) + (dim,)
        with torch.no_grad():
            moved = x.movedim(dim, 0) if dim else x
            full = _fsdp_gather_impl(moved, self.group, self.axis_name, self.sync)
        self._memo[key] = full
        return self._apply(x, dim, key, full)

    def _replay(self, x: torch.Tensor, dim: int, key) -> torch.Tensor:
        full = self._memo.get(key)
        if full is None:
            raise RuntimeError(
                "FSDP gather in a recompute found no gathered weight of the step's forward "
                "for its shard slice; it does not gather off the forward")
        return self._apply(x, dim, key, full)

    def reduce_scatter(self, grads) -> list:
        """``grads`` (autograd's, one per leaf, None where it gave none) with
        every sharded leaf's gradient made from its recorded cotangents,
        and zeros for a leaf that got nothing (as JAX gives)."""
        self._memo.clear()
        keys = [key for key, _ in self._records]
        cts = [ct for _, ct in self._records]
        self._records = []
        uses: dict = {}
        order = []
        for pos, key in enumerate(keys):
            k = uses[key] = uses.get(key, -1) + 1
            leaf, index, _ = self._where[key]
            order.append(((leaf, -1 if index is None else index, k), pos))
        blocks = [None] * len(keys)
        with torch.no_grad():
            # the same collectives in the same order on every rank: by
            # leaf, slice and use, not by autograd's arrival order
            for _, pos in sorted(order):
                ct, cts[pos] = cts[pos], None  # each cotangent freed once sent
                dim = keys[pos][-1]
                block = _shard_gradient(ct, self.group, self.axis_name, self.sync)
                blocks[pos] = block.movedim(0, dim) if dim else block
                del ct, block
            per_leaf: dict = {}
            for key, block in zip(keys, blocks):  # arrival order
                leaf, index, _ = self._where[key]
                per_leaf.setdefault(leaf, []).append((index, block))
            out = list(grads)
            for i, parts in per_leaf.items():
                if out[i] is not None:
                    raise ValueError("a sharded leaf got a gradient outside its FSDP gathers")
                out[i] = _sum_blocks(self._leaves[i], parts)
            return [torch.zeros_like(leaf) if g is None else g
                    for g, leaf in zip(out, self._leaves)]


def _sum_blocks(leaf: torch.Tensor, parts) -> torch.Tensor:
    """Autograd's sum of the gradients ``fsdp_all_gather``'s backward gives
    ``leaf`` through its uses, ``parts`` = [(slice index or None, block)]
    in arrival order: uses of the whole leaf add their blocks in that
    order; uses of distinct dim-0 slices each add zeros with the block at
    its slice (``select``'s backward), which changes no value but turns a
    -0 into +0 once two are added (``0 + b`` does the same)."""
    index = [i for i, _ in parts]
    if all(i is None for i in index):
        acc = parts[0][1]
        for _, b in parts[1:]:
            acc = acc + b
        return acc
    if None in index or len(set(index)) != len(index):
        raise ValueError("FSDP step: a leaf gathered both whole and by slices, or a slice "
                         "gathered twice, in one step")
    acc = torch.zeros_like(leaf)
    for i, b in parts:
        if len(parts) == 1:
            acc[i].copy_(b)
        else:
            acc[i].add_(b)
    return acc


def fsdp_gather(x: torch.Tensor, dim: int, axis_name,
                sync: Optional[SyncConfig] = None) -> torch.Tensor:
    """``ParallelCtx.gather``'s FSDP route: ``x`` gathered along ``dim``
    (moved to the front and back, as the reference does).  Bound to an
    ``FsdpStep`` (its forward or a recompute of it) it is that step's
    gather; else ``fsdp_all_gather``."""
    bound = getattr(_BOUND, "step", None)
    if bound is not None:
        step, replay = bound
        key = _slice_key(x, dim)
        return step._replay(x, dim, key) if replay else step._gather(x, dim, key)
    moved = x.movedim(dim, 0) if dim else x
    out = fsdp_all_gather(moved, axis_name, sync)
    return out.movedim(0, dim) if dim else out
