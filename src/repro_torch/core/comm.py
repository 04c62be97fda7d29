"""Plan-then-execute communicator for the compressed collectives.

The counterpart of the planning half of ``repro.core.comm`` and of its
``GZCommunicator``: the same frozen, hashable :class:`Plan` (algorithm,
pipeline depth, per-stage eb, capacity, provisioned wire bytes, slab
table, route table), resolved by the same policy registry (``auto``,
``paper``, ``throughput``, ``accuracy``) and memoized in the same plan
cache, so a plan here equals the reference's field for field at the same
``hw`` point, for all six ops.

What differs from the reference:

  * the default ``hw`` is ``cost_model.A100_SLINGSHOT``, the paper's GPU
    point (the reference defaults to its TPU point), for
    ``GZHierCommunicator`` too: its 48:1 link asymmetry resolves a
    ``node x local`` topology with ``L > 1`` hierarchical where the
    reference's default resolves it flat;
  * ranks are not a traced mesh axis but a rank handle from
    ``core/transport.py``: every op runs inside
    ``ThreadGroup.run(..., axis_name=...)`` or a ``DistGroup.bind(...)``,
    or takes ``group=`` explicitly;
  * the communicator runs on ``device`` ("cuda" unless the caller asks
    for "cpu"); asking for CUDA without a card raises;
  * the ``all_to_all`` gradient is a ``torch.autograd.Function`` instead
    of a ``custom_vjp``;
  * on a ``ThreadGroup`` the ``all_to_all`` backward must run on the
    rank's own thread (CUDA backward runs on the autograd device thread,
    where it raises: take gradients through ``DistGroup``);
  * the degradation policy runs after the collective instead of inside a
    trace.  ``flags_across`` gives every rank the same ``overflow`` and
    ``nonfinite``; under ``fallback`` every rank then re-runs the op's
    lossless schedule (``collectives._execute_lossless``) over the input
    the compressed schedule consumed when either is set, and under
    ``raise`` every rank raises the reference's ``RuntimeError``.  Both
    read the replicated flags on the host (one sync per call); ``flag``
    adds nothing;
  * the health counters are counted on the host by rank 0 of each call,
    under a lock (the rank threads of a ``ThreadGroup`` share them);
  * ``GZHierCommunicator.calibrate`` is not ported (ROADMAP A12).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import (
    codecs, collectives, cost_model, error_budget, faults, schedule, transport,
)
from repro_torch.core.compressed import capacity_words_for
from repro_torch.kernels import ops

__all__ = [
    "Plan",
    "HierPlan",
    "FallbackPlan",
    "CollectiveResult",
    "GZCommunicator",
    "GZHierCommunicator",
    "select_allreduce",
    "select_allreduce_plan",
    "register_policy",
    "policy_names",
    "plan_cache_stats",
    "clear_plan_cache",
    "enable_health_tracking",
    "health_stats",
    "clear_health_stats",
]

OPS = (
    "allreduce",
    "reduce_scatter",
    "allgather",
    "scatter",
    "broadcast",
    "all_to_all",
)

# Fixed algorithm per data-movement op (only allreduce has a real choice).
_OP_ALGO = {
    "reduce_scatter": "ring",
    "allgather": "ring",
    "scatter": "binomial",
    "broadcast": "binomial",
    "all_to_all": "direct",
}


# ---------------------------------------------------------------------------
# Plan & CollectiveResult
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FallbackPlan:
    """The lossless degradation target of a compressed plan."""

    op: str
    kind: str          # lossless primitive: psum | psum_scatter | ...
    axis_size: int
    wire_bytes: int    # raw uncompressed bytes the fallback moves per rank
    t_model: float     # modeled seconds of one fallback execution


# Lossless primitive each op degrades to (FallbackPlan.kind).
_FALLBACK_KIND = {
    "allreduce": "psum",
    "reduce_scatter": "psum_scatter",
    "allgather": "all_gather",
    "scatter": "raw_slab_tree",
    "broadcast": "raw_tree_forward",
    "all_to_all": "all_to_all",
}


def _fallback_plan(op, n_elems, axis_size, hw) -> FallbackPlan:
    return FallbackPlan(
        op=op, kind=_FALLBACK_KIND[op], axis_size=axis_size,
        wire_bytes=n_elems * 4,
        t_model=cost_model.fallback_time(op, n_elems * 4, axis_size, hw),
    )


@dataclasses.dataclass(frozen=True)
class Plan:
    """A frozen, hashable execution plan for one collective call (the
    fields of ``repro.core.comm.Plan``; see there for each one)."""

    op: str
    algo: str
    n_elems: int
    nbytes: int
    dtype: str
    axis_size: int
    eb: float
    eb_stage: float
    pipeline_chunks: int
    fused: bool
    fused_hop: bool
    capacity_factor: float
    worst_case_budget: bool
    capacity_words: int
    wire_bytes: int
    ratio: float
    policy: str
    slab_table: tuple = ()
    on_overflow: str = "flag"
    verify_streams: bool = False
    fallback: Optional[FallbackPlan] = None
    codec: str = "lorenzo"
    codec_ratio: float = 1.0
    notes: tuple = ()
    route_table: Optional[schedule.Schedule] = None

    def as_config(self):
        """The concrete GZConfig the execute layer dispatches on."""
        return collectives.GZConfig(
            eb=self.eb,
            capacity_factor=self.capacity_factor,
            algo=self.algo,
            worst_case_budget=self.worst_case_budget,
            pipeline_chunks=self.pipeline_chunks,
            fused=self.fused,
            fused_hop=self.fused_hop,
            on_overflow=self.on_overflow,
            verify_streams=self.verify_streams,
            codec=self.codec,
        )


@dataclasses.dataclass(frozen=True)
class HierPlan:
    """A frozen, hashable plan for one two-level (node x local) allreduce
    (the fields of ``repro.core.comm.HierPlan``; see there for each one).

    ``topology`` is the full ``(n_nodes, gpus_per_node)`` tuple: 2x4 and
    4x2 are different plans.  ``flat`` runs ``flat_plan`` over the
    composite axis; otherwise an exact intra-node reduce-scatter, the
    compressed ``inter`` allreduce of the shard across nodes (the whole
    error budget) and an exact intra-node allgather.
    ``inter_wire_bytes`` is the provisioned payload a rank ships across
    node boundaries (on the flat path every send of a boundary rank
    crosses: the flat plan's ``wire_bytes``)."""

    op: str
    topology: tuple
    n_elems: int
    nbytes: int
    dtype: str
    eb: float
    flat: bool
    inter: Optional[Plan]
    flat_plan: Optional[Plan]
    intra_wire_bytes: int
    inter_wire_bytes: int
    t_model: float
    t_flat: float
    policy: str
    on_overflow: str = "flag"
    verify_streams: bool = False
    fallback: Optional[FallbackPlan] = None
    codec: str = "lorenzo"
    route_table: Optional[schedule.Schedule] = None

    @property
    def ratio(self) -> float:
        """Inter-node wire reduction against what the flat path crosses."""
        if self.flat:
            return self.flat_plan.ratio
        if not self.inter_wire_bytes:
            return 1.0
        return self.inter.ratio


@dataclasses.dataclass(frozen=True)
class CollectiveResult:
    """Result-and-stats channel of a communicator call.

    ``overflow`` and ``nonfinite`` are 0-d bool tensors on the result's
    device, each the OR across all ranks: "did any stream of any hop
    anywhere exceed its capacity" and "did any rank's input hold NaN/Inf".
    ``wire_bytes`` is the provisioned payload a rank ships; ``ratio`` the
    uncompressed equivalent over that.
    """

    value: torch.Tensor
    overflow: torch.Tensor
    nonfinite: torch.Tensor
    wire_bytes: int
    ratio: float


# ---------------------------------------------------------------------------
# Provisioned wire accounting (static, from the plan inputs alone)
# ---------------------------------------------------------------------------


def _stream_bytes(n_elems: int, capacity_factor: float,
                  codec: str = "lorenzo") -> int:
    """Wire bytes of one provisioned ``Compressed`` stream for n f32."""
    cap = codecs.codec_capacity_words(codec, n_elems, capacity_factor)
    n_blocks = ops.n_blocks_for(n_elems)
    return cap * 4 + 2 * n_blocks * 4 + 8  # packed + bitwidth + anchor + meta


def _int_stream_bytes(n_elems_padded: int, capacity_factor: float) -> int:
    """intring hop payload: packed codes + per-block bitwidth + anchor."""
    cap = capacity_words_for(n_elems_padded, capacity_factor, ops.BLOCK)
    rows = n_elems_padded // ops.BLOCK
    return cap * 4 + 2 * rows * 4


_PIECE_QUANTUM = ops.BLOCK * ops.TILE_ROWS


def _ring_piece_sizes(n_elems, n, chunks):
    """(chunk, piece) the ring schedules actually run."""
    p = max(chunks, 1)
    if p > 1:
        quantum = n * p * _PIECE_QUANTUM
        total = -(-n_elems // quantum) * quantum
        return total // n, total // (n * p)
    chunk = -(-n_elems // n)
    return chunk, chunk


def _wire_accounting(op, algo, n_elems, n, capacity_factor, chunks,
                     codec: str = "lorenzo"):
    """(capacity_words, wire_bytes, uncompressed_bytes) for one call: the
    busiest sender's sum over the route table (``schedule.build``), each
    entry priced at the op's transport granularity."""
    cap, entry_wire, entry_raw = _entry_pricers(
        op, algo, n_elems, n, capacity_factor, chunks, codec)
    if n < 2:
        # Degenerate axis: no wire rounds.  One full stream for the
        # log-depth ops, one exchange lane for the all-to-all, zero for
        # the rings (the reference's historic provisioning).
        if (op == "allreduce" and algo == "redoub") or op == "broadcast":
            return cap, _stream_bytes(n_elems, capacity_factor, codec), \
                n_elems * 4
        if op == "all_to_all":
            h = schedule.Hop(0, 0, (0, 1), "lossy", "compressed")
            return cap, entry_wire(h), entry_raw(h)
        return cap, 0, 0
    table = schedule.build(op, algo, n)
    send = [0] * n
    send_raw = [0] * n
    for rnd in table.rounds:
        for h in rnd:
            send[h.sender] += entry_wire(h)
            send_raw[h.sender] += entry_raw(h)
    return cap, max(send), max(send_raw)


def _entry_pricers(op, algo, n_elems, n, capacity_factor, chunks, codec):
    """``(capacity_words, entry_wire(h), entry_raw(h))``: the provisioned
    capacity of one wire stream and the compressed / uncompressed bytes
    one route-table entry ships, including the execute layer's padding
    (pipelined rings pad to whole-tile pieces, intring pads chunks to
    whole code rows, the scatter ships one stream per real chunk)."""
    p = max(chunks, 1)
    chunk_in = -(-n_elems // max(n, 1))
    if op == "allreduce" and algo == "redoub" or op == "broadcast":
        cap = codecs.codec_capacity_words(codec, n_elems, capacity_factor)
        stream = _stream_bytes(n_elems, capacity_factor, codec)
        return cap, (lambda h: stream), (lambda h: n_elems * 4)
    if op == "allreduce" and algo == "intring":
        chunk = ops.n_blocks_for(chunk_in) * ops.BLOCK
        cap = capacity_words_for(chunk, capacity_factor, ops.BLOCK)
        stream = _int_stream_bytes(chunk, capacity_factor)
        return cap, (lambda h: stream), (lambda h: chunk_in * 4)
    if op == "allreduce":  # float ring
        _, piece = _ring_piece_sizes(n_elems, n, chunks)
        cap = codecs.codec_capacity_words(codec, piece, capacity_factor)
        stream = p * _stream_bytes(piece, capacity_factor, codec)
        return cap, (lambda h: stream), (lambda h: chunk_in * 4)
    if op in ("reduce_scatter", "allgather"):
        # a reduce-scatter pads each chunk, an allgather the own chunk,
        # to p whole-tile pieces
        own = chunk_in if op == "reduce_scatter" else n_elems
        quantum = p * _PIECE_QUANTUM
        piece = (-(-own // quantum) * quantum) // p if p > 1 else own
        cap = codecs.codec_capacity_words(codec, piece, capacity_factor)
        stream = p * _stream_bytes(piece, capacity_factor, codec)
        return cap, (lambda h: stream), (lambda h: own * 4)
    if op == "scatter":
        # one stream per REAL chunk of each entry's slab: the root's
        # entries sum to n-1 chunk streams at any axis size
        cap = codecs.codec_capacity_words(codec, chunk_in, capacity_factor)
        stream = _stream_bytes(chunk_in, capacity_factor, codec)
        return cap, (lambda h: h.chunk_slab[1] * stream), \
            (lambda h: h.chunk_slab[1] * chunk_in * 4)
    if op == "all_to_all":
        cap = codecs.codec_capacity_words(codec, chunk_in, capacity_factor)
        stream = _stream_bytes(chunk_in, capacity_factor, codec)
        return cap, (lambda h: stream), (lambda h: chunk_in * 4)
    raise ValueError(f"unknown op {op!r}")


def _eb_stage(op, algo, eb, n, worst_case):
    if op == "allreduce":
        if algo == "intring":
            return eb  # single quantization grid; n addends share it
        return error_budget.allocate(eb, f"allreduce_{algo}", n,
                                     worst_case=worst_case)
    if op == "reduce_scatter":
        return error_budget.allocate(eb, "reduce_scatter_ring", n,
                                     worst_case=worst_case)
    return eb  # data-movement ops: exactly one lossy hop


# ---------------------------------------------------------------------------
# Algorithm selection (the paper's §3.3.3 design framework)
# ---------------------------------------------------------------------------


def select_allreduce(
    d_bytes: int,
    n_ranks: int,
    ratio: float = 20.0,
    hw: cost_model.Hardware = cost_model.A100_SLINGSHOT,
    *,
    allow_beyond_paper: bool = False,
) -> str:
    """The paper's selector: 'ring' | 'redoub' (| 'intring') under the
    two-kernel multi-stream cost models."""
    costs = {
        "ring": cost_model.allreduce_ring_gz(d_bytes, n_ranks, ratio, hw),
        "redoub": cost_model.allreduce_redoub_gz(
            d_bytes, n_ranks, ratio, hw, fused_hop=False
        ),
    }
    if allow_beyond_paper:
        costs["intring"] = cost_model.allreduce_intring_gz(
            d_bytes, n_ranks, ratio, hw)
    return min(costs, key=costs.get)


def select_allreduce_plan(
    d_bytes: int,
    n_ranks: int,
    ratio: float = 20.0,
    hw: cost_model.Hardware = cost_model.A100_SLINGSHOT,
    *,
    allow_beyond_paper: bool = False,
    chunk_candidates=cost_model.PIPELINE_CHUNK_CANDIDATES,
    fused_hop: bool = True,
) -> tuple:
    """(algo, pipeline_chunks) from the per-chunk cost model: ring at its
    best chunk count under the chunked double-buffered schedule vs redoub."""
    ring_chunks = cost_model.best_pipeline_chunks(
        d_bytes, n_ranks, ratio, hw, chunk_candidates, fused_hop=fused_hop
    )
    costs = {
        ("ring", ring_chunks): cost_model.allreduce_ring_gz_chunked(
            d_bytes, n_ranks, ratio, hw, ring_chunks, fused_hop=fused_hop
        ),
        ("redoub", 1): cost_model.allreduce_redoub_gz(
            d_bytes, n_ranks, ratio, hw, fused_hop=fused_hop
        ),
    }
    if allow_beyond_paper:
        costs[("intring", 1)] = cost_model.allreduce_intring_gz(
            d_bytes, n_ranks, ratio, hw
        )
    return min(costs, key=costs.get)


# ---------------------------------------------------------------------------
# Policy registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """Everything a policy may inspect when choosing (algo, chunks)."""

    op: str
    n_elems: int
    nbytes: int
    axis_size: int
    requested_algo: Optional[str]  # None == "pick for me"
    requested_chunks: int          # 0 == "plan the ring depth for me"
    fused_hop: bool
    ratio: float
    hw: cost_model.Hardware


PolicyFn = Callable[[PlanRequest], tuple]
_POLICIES: dict = {}


def register_policy(name: str, fn: PolicyFn) -> None:
    """Add/replace a named plan policy: fn(PlanRequest) -> (algo, chunks)."""
    _POLICIES[name] = fn


def policy_names() -> tuple:
    return tuple(sorted(_POLICIES))


def _ring_depth(req: PlanRequest) -> int:
    return collectives.plan_ring_pipeline_chunks(
        req.n_elems, req.axis_size, ratio=req.ratio, hw=req.hw,
        fused_hop=req.fused_hop,
    )


def _data_movement_plan(req: PlanRequest):
    """(algo, chunks) for the fixed-algorithm data-movement ops, shared by
    every policy but ``paper``.  ``requested_chunks == 0`` asks for a
    planned depth: the scatter's from
    ``cost_model.best_scatter_pipeline_chunks``; the other data movers
    stay sequential."""
    chunks = req.requested_chunks
    if req.op == "scatter" and chunks == 0:
        chunks = cost_model.best_scatter_pipeline_chunks(
            req.nbytes, req.axis_size, req.ratio, req.hw
        )
    return _OP_ALGO[req.op], max(chunks, 1)


def _policy_auto(req: PlanRequest):
    """Production default: algorithm from the fused-hop chunked cost
    model, ring depth from ``best_pipeline_chunks`` capped by whole-tile
    fill; explicit requests are honored."""
    if req.op != "allreduce":
        return _data_movement_plan(req)
    algo, chunks = req.requested_algo, req.requested_chunks
    if algo is None:
        algo, _ = select_allreduce_plan(
            req.nbytes, req.axis_size, req.ratio, req.hw,
            fused_hop=req.fused_hop,
        )
        if algo == "ring" and chunks in (0, 1):
            chunks = _ring_depth(req)
    elif algo == "ring" and chunks == 0:
        chunks = _ring_depth(req)
    return algo, max(chunks, 1)


def _policy_paper(req: PlanRequest):
    """The paper's §3.3.3 crossover, sequential schedule (for every op: a
    depth request of 0 does not pipeline the scatter here)."""
    if req.op != "allreduce":
        return _OP_ALGO[req.op], max(req.requested_chunks, 1)
    algo = req.requested_algo
    if algo is None:
        algo = select_allreduce(req.nbytes, req.axis_size, req.ratio, req.hw)
    return algo, max(req.requested_chunks, 1)


def _policy_throughput(req: PlanRequest):
    """Fastest modeled plan, beyond-paper algorithms allowed."""
    if req.op != "allreduce":
        return _data_movement_plan(req)
    algo, chunks = req.requested_algo, req.requested_chunks
    if algo is None:
        algo, _ = select_allreduce_plan(
            req.nbytes, req.axis_size, req.ratio, req.hw,
            allow_beyond_paper=True, fused_hop=req.fused_hop,
        )
        if algo == "ring" and chunks in (0, 1):
            chunks = _ring_depth(req)
    elif algo == "ring" and chunks == 0:
        chunks = _ring_depth(req)
    return algo, max(chunks, 1)


def _policy_accuracy(req: PlanRequest):
    """Bitwise rank-consistent integer ring."""
    if req.op != "allreduce":
        return _data_movement_plan(req)
    return req.requested_algo or "intring", max(req.requested_chunks, 1)


register_policy("auto", _policy_auto)
register_policy("paper", _policy_paper)
register_policy("throughput", _policy_throughput)
register_policy("accuracy", _policy_accuracy)


# ---------------------------------------------------------------------------
# Memoized plan resolution
# ---------------------------------------------------------------------------

_PLAN_CACHE: dict = {}
_HIER_PLAN_CACHE: dict = {}
_COMM_CACHE: dict = {}  # GZCommunicator.for_config, GZHierCommunicator.for_axes
_PLAN_STATS = {"hits": 0, "misses": 0}
_PLAN_STATS_BY_CODEC: dict = {}
_PLAN_STATS_BY_OP: dict = {}
_PLAN_LOCK = threading.Lock()  # the rank threads of a ThreadGroup share the cache


def _stat(table: dict, key: str, field: str) -> None:
    rec = table.setdefault(key, {"hits": 0, "misses": 0})
    rec[field] += 1


def plan_cache_stats() -> dict:
    """{'hits', 'misses', 'entries', 'keys', 'hier_entries', 'hier_keys',
    'by_codec', 'by_op'}: both caches, the breakdowns by the requested
    codec (the last key field of both) and by op (the first)."""
    def breakdown(table, pos):
        return {
            k: {"hits": rec["hits"], "misses": rec["misses"],
                "entries": sum(1 for key in _PLAN_CACHE if key[pos] == k),
                "hier_entries": sum(1 for key in _HIER_PLAN_CACHE if key[pos] == k)}
            for k, rec in table.items()
        }

    with _PLAN_LOCK:
        return {
            "hits": _PLAN_STATS["hits"],
            "misses": _PLAN_STATS["misses"],
            "entries": len(_PLAN_CACHE),
            "keys": tuple(_PLAN_CACHE),
            "hier_entries": len(_HIER_PLAN_CACHE),
            "hier_keys": tuple(_HIER_PLAN_CACHE),
            "by_codec": breakdown(_PLAN_STATS_BY_CODEC, -1),
            "by_op": breakdown(_PLAN_STATS_BY_OP, 0),
        }


def clear_plan_cache() -> None:
    with _PLAN_LOCK:
        _PLAN_CACHE.clear()
        _HIER_PLAN_CACHE.clear()
        _COMM_CACHE.clear()
        _PLAN_STATS["hits"] = 0
        _PLAN_STATS["misses"] = 0
        _PLAN_STATS_BY_CODEC.clear()
        _PLAN_STATS_BY_OP.clear()


def _codec_adjusted(codec, ratio, hw):
    """(effective_ratio, adjusted_hw, codec_fused_hop) for pricing a codec;
    identity terms short-circuit to the caller's own (ratio, hw)."""
    spec = codecs.get_codec(codec)
    terms = hw.terms_for(codec) or spec.terms
    if terms == cost_model.CodecTerms(codec):
        return ratio, hw, spec.fused_hop
    return terms.effective_ratio(ratio), terms.apply(hw), spec.fused_hop


def _allreduce_model_time(algo, nbytes, n, ratio, hw, chunks, fused_hop):
    """Modeled seconds of one single-axis compressed allreduce."""
    if n <= 1:
        return 0.0
    if algo == "redoub":
        return cost_model.allreduce_redoub_gz(nbytes, n, ratio, hw, fused_hop=fused_hop)
    if algo == "intring":
        return cost_model.allreduce_intring_gz(nbytes, n, ratio, hw)
    return cost_model.allreduce_ring_gz_chunked(nbytes, n, ratio, hw, chunks,
                                                fused_hop=fused_hop)


def _op_model_time(op, algo, nbytes, n, ratio, hw, chunks, fused_hop):
    """Modeled seconds of one collective under (algo, ratio, hw): the
    per-op comparator ``codec='auto'`` ranks candidates with (the
    reference's formulas, term for term)."""
    if n <= 1:
        return 0.0
    if op == "allreduce":
        return _allreduce_model_time(algo, nbytes, n, ratio, hw, chunks, fused_hop)
    if op == "scatter":
        return cost_model.scatter_binomial_gz_chunked(nbytes, n, ratio, hw, max(chunks, 1))
    if op == "allgather":
        return cost_model.allgather_ring_gz(nbytes, n, ratio, hw)
    if op == "broadcast":
        steps = cost_model.steps_for("binomial", n)
        return (cost_model.t_compress(nbytes, hw)
                + steps * cost_model.t_net(nbytes / ratio, hw)
                + cost_model.t_decompress(nbytes, hw))
    chunk = nbytes / n
    if op == "reduce_scatter":
        return (n - 1) * (cost_model.t_compress(chunk, hw)
                          + cost_model.t_net(chunk / ratio, hw)
                          + cost_model.t_decompress(chunk, hw))
    # all_to_all: compress/decompress the whole payload, n exchange lanes
    return (cost_model.t_compress(nbytes, hw)
            + n * cost_model.t_net(chunk / ratio, hw)
            + cost_model.t_decompress(nbytes, hw))


# Policies that rank algorithms by modeled time: the only ones where
# ranking codecs by the same model is meaningful.
_CODEC_AUTO_POLICIES = ("auto", "throughput")


def _policy_for_codec(policy_fn, req, codec):
    """(algo, chunks, codec_ratio, fused_hop, hw) of the policy priced at
    the codec's adjusted (ratio, hw)."""
    codec_ratio, hw_c, codec_fused_hop = _codec_adjusted(codec, req.ratio, req.hw)
    fused_hop = req.fused_hop and codec_fused_hop
    algo, chunks = policy_fn(dataclasses.replace(
        req, fused_hop=fused_hop, ratio=codec_ratio, hw=hw_c))
    return algo, chunks, codec_ratio, fused_hop, hw_c


def _resolve_codec(op, policy, policy_fn, req, codec):
    """(codec, algo, chunks, codec_ratio, fused_hop, notes): every codec
    rule in one place, with the reference's notes word for word.

      * an explicit codec prices the policy at its adjusted (ratio, hw);
      * ``auto`` under an auto/throughput policy runs the policy per
        candidate and takes the least modeled time of the op;
      * ``auto`` under other policies is ``lorenzo``, with a note;
      * ``intring`` ships its own integer wire: codec back to ``lorenzo``;
      * a codec without a fused hop kernel turns ``fused_hop`` off (noted).
    """
    notes = []
    if codec == codecs.AUTO and policy in _CODEC_AUTO_POLICIES:
        best = None
        for cand in codecs.auto_codecs():
            algo_c, chunks_c, ratio_c, fh, hw_c = _policy_for_codec(policy_fn, req, cand)
            t = _op_model_time(op, algo_c, req.nbytes, req.axis_size, ratio_c, hw_c,
                               chunks_c, fh)
            if best is None or t < best[0]:
                best = (t, cand, algo_c, chunks_c, ratio_c)
        _, codec, algo, chunks, codec_ratio = best
        notes.append(f"codec auto->{codec!r} (fastest modeled {op} of "
                     f"{codecs.auto_codecs()})")
    else:
        if codec == codecs.AUTO:
            codec = "lorenzo"
            notes.append(f"codec auto->'lorenzo' (policy {policy!r} does not rank "
                         "codecs by modeled time)")
        algo, chunks, codec_ratio, _, _ = _policy_for_codec(policy_fn, req, codec)
    if algo == "intring" and codec != "lorenzo":
        notes.append(f"codec {codec!r}->'lorenzo' (intring ships its own integer "
                     "wire format)")
        codec = "lorenzo"
        codec_ratio, _, _ = _codec_adjusted(codec, req.ratio, req.hw)
    spec = codecs.get_codec(codec)
    fused_hop = req.fused_hop and spec.fused_hop
    if req.fused_hop and not spec.fused_hop:
        notes.append(f"fused_hop off (codec {codec!r} has no fused "
                     "unpack+reduce+repack kernel; hops run the two-pass "
                     "composition)")
    return codec, algo, max(chunks, 1), codec_ratio, fused_hop, tuple(notes)


def _resolve_plan(
    op, n_elems, dtype, axis_size, eb, *, policy, requested_algo,
    requested_chunks, capacity_factor, worst_case_budget, fused, fused_hop,
    ratio, hw, on_overflow="flag", verify_streams=False, codec="lorenzo",
) -> Plan:
    key = (
        op, n_elems * 4, str(dtype), axis_size, eb,
        policy, requested_algo, requested_chunks, capacity_factor,
        worst_case_budget, fused, fused_hop, ratio, hw,
        on_overflow, verify_streams,
        codec,  # last: plan_cache_stats' by_codec reads key[-1]
    )
    with _PLAN_LOCK:
        hit = _PLAN_CACHE.get(key)
        field = "misses" if hit is None else "hits"
        _PLAN_STATS[field] += 1
        _stat(_PLAN_STATS_BY_CODEC, codec, field)
        _stat(_PLAN_STATS_BY_OP, op, field)
    if hit is not None:
        return hit
    if op not in OPS:
        raise ValueError(f"unknown collective op {op!r}")
    try:
        policy_fn = _POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown policy {policy!r}; registered: {policy_names()}"
        ) from None
    req = PlanRequest(
        op=op, n_elems=n_elems, nbytes=n_elems * 4, axis_size=axis_size,
        requested_algo=requested_algo, requested_chunks=requested_chunks,
        fused_hop=fused_hop, ratio=ratio, hw=hw,
    )
    codec, algo, chunks, codec_ratio, fused_hop, notes = _resolve_codec(
        op, policy, policy_fn, req, codec)
    cap, wire, raw = _wire_accounting(
        op, algo, n_elems, axis_size, capacity_factor, chunks, codec
    )
    plan = Plan(
        op=op, algo=algo, n_elems=n_elems, nbytes=n_elems * 4,
        dtype=str(dtype), axis_size=axis_size, eb=eb,
        eb_stage=_eb_stage(op, algo, eb, axis_size, worst_case_budget),
        pipeline_chunks=chunks, fused=fused, fused_hop=fused_hop,
        capacity_factor=capacity_factor, worst_case_budget=worst_case_budget,
        capacity_words=cap, wire_bytes=wire,
        ratio=(raw / wire) if wire else 1.0, policy=policy,
        slab_table=(cost_model.binomial_slab_table(axis_size)
                    if algo == "binomial" else ()),
        on_overflow=on_overflow, verify_streams=verify_streams,
        fallback=_fallback_plan(op, n_elems, axis_size, hw),
        codec=codec, codec_ratio=codec_ratio, notes=notes,
        route_table=(schedule.build(op, algo, axis_size)
                     if axis_size >= 2 else None),
    )
    with _PLAN_LOCK:
        return _PLAN_CACHE.setdefault(key, plan)


def _resolve_hier_plan(
    op, n_elems, dtype, topology, eb, *, policy, requested_algo,
    requested_chunks, capacity_factor, worst_case_budget, fused, fused_hop,
    ratio, hw, on_overflow="flag", verify_streams=False, codec="lorenzo",
) -> HierPlan:
    """The frozen two-level plan for ``topology = (n_nodes, L)``, memoized
    on the full topology tuple (the reference's rule, step for step).

    Flat when ``L == 1`` or the fabric has no link asymmetry, or when the
    flat compressed allreduce over all N ranks (every link priced at the
    inter terms) models no slower than ``cost_model.allreduce_hier_gz``;
    the policy picks the inter stage by resolving an ordinary plan at the
    shard size over ``n_nodes`` ranks, with the whole error budget."""
    topology = (int(topology[0]), int(topology[1]))
    key = (
        op, n_elems * 4, str(dtype), topology, eb,
        policy, requested_algo, requested_chunks, capacity_factor,
        worst_case_budget, fused, fused_hop, ratio, hw,
        on_overflow, verify_streams,
        codec,  # last, as in the flat cache
    )
    with _PLAN_LOCK:
        hit = _HIER_PLAN_CACHE.get(key)
        field = "misses" if hit is None else "hits"
        _PLAN_STATS[field] += 1
        _stat(_PLAN_STATS_BY_CODEC, codec, field)
        _stat(_PLAN_STATS_BY_OP, op, field)
    if hit is not None:
        return hit
    if op != "allreduce":
        raise ValueError(
            f"hierarchical plans support op='allreduce' only; got {op!r}"
        )
    n_nodes, L = topology
    N = n_nodes * L
    nbytes = n_elems * 4
    knobs = dict(
        policy=policy, requested_algo=requested_algo,
        requested_chunks=requested_chunks, capacity_factor=capacity_factor,
        worst_case_budget=worst_case_budget, fused=fused,
        fused_hop=fused_hop, ratio=ratio, hw=hw,
        on_overflow=on_overflow, verify_streams=verify_streams,
        codec=codec,
    )
    flat_plan = _resolve_plan(op, n_elems, dtype, N, eb, **knobs)
    flat_ratio, flat_hw, _ = _codec_adjusted(flat_plan.codec, ratio, hw)
    t_flat = _allreduce_model_time(
        flat_plan.algo, nbytes, N, flat_ratio, flat_hw,
        flat_plan.pipeline_chunks, flat_plan.fused_hop,
    )
    inter = None
    t_hier = float("inf")
    shard_elems = -(-n_elems // L)
    if L > 1 and hw.link_asymmetry() > 1.0:
        # only the inter-node stage is lossy: the exact intra stages get 0
        eb_inter = error_budget.split_lossy(eb, (False, n_nodes > 1, False))[1]
        if n_nodes > 1:
            inter = _resolve_plan(op, shard_elems, dtype, n_nodes, eb_inter, **knobs)
        inter_ratio, inter_hw, _ = _codec_adjusted(
            inter.codec if inter else "lorenzo", ratio, hw)
        t_hier = cost_model.allreduce_hier_gz(
            nbytes, n_nodes, L, inter_ratio, inter_hw,
            inter_algo=inter.algo if inter else "ring",
            chunks=inter.pipeline_chunks if inter else 1,
            fused_hop=inter.fused_hop if inter else fused_hop,
        )
    flat = t_flat <= t_hier
    if flat:
        inter = None
        intra_wire = 0
        inter_wire = flat_plan.wire_bytes  # a boundary rank: every send crosses
        t_model = t_flat
    else:
        intra_wire = 2 * (L - 1) * shard_elems * 4
        inter_wire = inter.wire_bytes if inter else 0
        t_model = t_hier
    plan = HierPlan(
        op=op, topology=topology, n_elems=n_elems, nbytes=nbytes,
        dtype=str(dtype), eb=eb, flat=flat, inter=inter, flat_plan=flat_plan,
        intra_wire_bytes=intra_wire, inter_wire_bytes=inter_wire,
        t_model=t_model, t_flat=t_flat, policy=policy,
        on_overflow=on_overflow, verify_streams=verify_streams,
        fallback=_fallback_plan(op, n_elems, N, hw),
        codec=(flat_plan.codec if flat else (inter.codec if inter else "lorenzo")),
        route_table=(flat_plan.route_table if flat else schedule.build_hier(
            n_nodes, L, inter.algo if inter else "ring")),
    )
    with _PLAN_LOCK:
        return _HIER_PLAN_CACHE.setdefault(key, plan)


def _dtype_name(dtype) -> str:
    """'float32' for torch.float32, np.float32 or 'float32'."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


# ---------------------------------------------------------------------------
# Differentiable all-to-all
# ---------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    """The compressed all-to-all with its gradient (the reference's
    ``custom_vjp`` on ``_a2a_planned``).  The rank-exchange layout is
    self-inverse (chunk r of rank p lands at rank r, slot p), so the
    backward is the same compressed exchange applied to the cotangent,
    straight through the quantizer.  Every rank must call backward, as
    every rank called forward.

    The autograd engine runs the backward nodes of CUDA tensors on its
    own device thread, not on the rank threads of a ``ThreadGroup``, so
    there the ranks' backward exchanges could never meet: backward raises
    instead of waiting forever.  Take gradients through ``DistGroup`` (one
    process per rank)."""

    @staticmethod
    def forward(ctx, x, g, cfg):
        ctx.g, ctx.cfg = g, cfg
        out, ovf = collectives._execute_all_to_all(x, g, cfg)
        ctx.mark_non_differentiable(ovf)
        return out, ovf

    @staticmethod
    def backward(ctx, g_out, _g_ovf):
        thread = getattr(ctx.g, "thread", None)
        if thread is not None and thread is not threading.current_thread():
            raise RuntimeError(
                f"all_to_all backward of ThreadGroup rank {ctx.g.rank} runs on "
                f"thread {threading.current_thread().name!r}, not on the rank's "
                "own thread (the autograd engine runs CUDA backward nodes on a "
                "device thread), so the ranks' exchanges cannot meet; take "
                "gradients through DistGroup (one process per rank)"
            )
        return collectives._execute_all_to_all(g_out, ctx.g, ctx.cfg)[0], None, None


# ---------------------------------------------------------------------------
# Health counters
# ---------------------------------------------------------------------------
#
# Per-(op, axis) counts of calls, overflow events, non-finite events and
# fallback executions, counted once per call by rank 0.  Off by default:
# counting reads the flags on the host, one sync per call.

_HEALTH: dict = {}
_HEALTH_ENABLED = False
_HEALTH_LOCK = threading.Lock()


def enable_health_tracking(enabled: bool = True) -> None:
    """Toggle the per-communicator health counters."""
    global _HEALTH_ENABLED
    _HEALTH_ENABLED = enabled


def health_stats() -> dict:
    """{(op, axis_repr): {'calls', 'overflow', 'nonfinite', 'fallbacks'}}"""
    with _HEALTH_LOCK:
        return {k: dict(v) for k, v in _HEALTH.items()}


def clear_health_stats() -> None:
    with _HEALTH_LOCK:
        _HEALTH.clear()


def _count_health(key, overflow: bool, nonfinite: bool, fell_back: bool) -> None:
    with _HEALTH_LOCK:
        rec = _HEALTH.setdefault(
            key, {"calls": 0, "overflow": 0, "nonfinite": 0, "fallbacks": 0})
        rec["calls"] += 1
        rec["overflow"] += int(overflow)
        rec["nonfinite"] += int(nonfinite)
        rec["fallbacks"] += int(fell_back)


def _degraded_message(what, overflow: bool, nonfinite: bool) -> str:
    """The reference's ``_raise_degraded`` text, word for word."""
    return (
        f"gZ collective degraded ({what}): overflow={overflow} "
        f"nonfinite={nonfinite} — a compressed stream exceeded "
        "its provisioned capacity (or failed verification) or the "
        "input held NaN/Inf.  Use on_overflow='fallback' for in-trace "
        "lossless recovery, or 'flag' to only report."
    )


def _degrade(op, g, axis, x, out, ovf, policy, cfg, *, root: int = 0):
    """The shared epilogue of every communicator call: OR the overflow
    and non-finite flags across the ranks of ``g``, apply the degradation
    ``policy``, count health under ``(op, repr(axis))``.  Returns ``(out,
    overflow, nonfinite)``.

    For scatter and broadcast only the root's payload is significant, so
    only the root's non-finite bit counts.  ``x`` is the (possibly
    poisoned) input the compressed schedule consumed: under ``fallback``
    every rank re-runs the lossless schedule over it when the replicated
    flags say the call degraded, so the result is the exact collective of
    the sanitized input."""
    if op not in ("scatter", "broadcast") or g.rank == root:
        nf_loc = collectives._nonfinite_local(x)
    else:
        nf_loc = collectives._false(x.device)
    overflow, nonfinite = g.flags_across(ovf, nf_loc)
    if policy != "flag" or _HEALTH_ENABLED:
        # the replicated flags: every rank takes the same branch
        ovf_now, nf_now = bool(overflow), bool(nonfinite)
        fell_back = policy == "fallback" and (ovf_now or nf_now)
        if fell_back:
            out = collectives._execute_lossless(op, x, g, cfg, root=root)
        if _HEALTH_ENABLED and g.rank == 0:
            _count_health((op, repr(axis)), ovf_now, nf_now, fell_back)
        if policy == "raise" and (ovf_now or nf_now):
            raise RuntimeError(_degraded_message(f"{op} over {axis!r}", ovf_now, nf_now))
    return out, overflow, nonfinite


# ---------------------------------------------------------------------------
# The communicator
# ---------------------------------------------------------------------------


class GZCommunicator:
    """Resolve-once communicator bound to one axis name.

    ``axis_size`` may be passed explicitly or left None to be read from
    the rank handle bound to ``axis_name`` at call time.  ``device`` is
    where the collective runs: "cuda" unless the caller asks for "cpu";
    CUDA without a card raises here.  ``auto_depth`` plans the ring depth
    even when the algorithm was requested explicitly (the grad-sync
    routing rule: a requested depth of 1 becomes 0, "plan it").
    """

    def __init__(
        self,
        axis_name,
        *,
        config=None,
        policy: str = "auto",
        hw: cost_model.Hardware = cost_model.A100_SLINGSHOT,
        ratio: float = 20.0,
        axis_size: Optional[int] = None,
        device="cuda",
        auto_depth: bool = False,
    ):
        self.axis_name = axis_name
        self.config = config if config is not None else collectives.GZConfig()
        if policy not in _POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; registered: {policy_names()}"
            )
        self.policy = policy
        self.hw = hw
        self.ratio = ratio
        self._axis_size = axis_size
        self.device = transport.resolve_device(device)
        self._auto_depth = auto_depth

    @classmethod
    def for_config(cls, axis_name, config, *, policy: str = "auto",
                   hw: cost_model.Hardware = cost_model.A100_SLINGSHOT,
                   ratio: float = 20.0, axis_size: Optional[int] = None,
                   device="cuda", auto_depth: bool = False) -> "GZCommunicator":
        """Memoized communicator: one instance per distinct (axis, knobs)."""
        key = (axis_name, config, policy, hw, ratio, axis_size,
               str(transport.resolve_device(device)), auto_depth)
        comm = _COMM_CACHE.get(key)
        if comm is None:
            comm = _COMM_CACHE[key] = cls(
                axis_name, config=config, policy=policy, hw=hw, ratio=ratio,
                axis_size=axis_size, device=device, auto_depth=auto_depth)
        return comm

    def _group(self, group):
        g = group if group is not None else transport.current(self.axis_name)
        if self._axis_size is not None and g.size != self._axis_size:
            raise ValueError(
                f"communicator bound to axis size {self._axis_size}, but the "
                f"group on {self.axis_name!r} has {g.size} ranks"
            )
        return g

    def axis_size(self, group=None) -> int:
        if self._axis_size is not None:
            return self._axis_size
        return self._group(group).size

    def plan(self, op: str, shape, dtype=torch.float32, *, group=None) -> Plan:
        """Resolve the frozen Plan for ``op`` over a payload of ``shape``
        (a shape tuple or an element count)."""
        n_elems = int(np.prod(shape)) if not isinstance(shape, int) else shape
        cfg = self.config
        requested_algo = None if cfg.algo == "auto" else cfg.algo
        requested_chunks = cfg.pipeline_chunks
        if self._auto_depth and requested_chunks == 1:
            requested_chunks = 0
        return _resolve_plan(
            op, n_elems, _dtype_name(dtype), self.axis_size(group), cfg.eb,
            policy=self.policy, requested_algo=requested_algo,
            requested_chunks=requested_chunks,
            capacity_factor=cfg.capacity_factor,
            worst_case_budget=cfg.worst_case_budget, fused=cfg.fused,
            fused_hop=cfg.fused_hop, ratio=self.ratio, hw=self.hw,
            on_overflow=cfg.on_overflow, verify_streams=cfg.verify_streams,
            codec=cfg.codec,
        )

    def _run(self, op, x, plan, group, execute, **kw) -> CollectiveResult:
        """The shared call path: device check, trivial axis, the input
        fault hook, plan, ``execute(x, g, config, **kw)``, the epilogue."""
        if x.device.type != self.device.type:
            raise ValueError(
                f"communicator runs on {self.device}, got a tensor on {x.device}"
            )
        g = self._group(group)
        if g.size == 1:
            zero = torch.zeros((), dtype=torch.bool, device=x.device)
            return CollectiveResult(x, zero, zero, 0, 1.0)
        x = faults.maybe_poison_input(x, g)
        plan = plan or self.plan(op, x.shape, x.dtype, group=g)
        cfg = plan.as_config()
        out, ovf = execute(x, g, cfg, **kw)
        out, overflow, nonfinite = _degrade(op, g, self.axis_name, x, out, ovf,
                                            plan.on_overflow, cfg, **kw)
        return CollectiveResult(out, overflow, nonfinite, plan.wire_bytes, plan.ratio)

    def allreduce(self, x: torch.Tensor, *, plan: Optional[Plan] = None,
                  group=None) -> CollectiveResult:
        """Compressed sum-allreduce of this rank's ``x`` over the group."""
        return self._run("allreduce", x, plan, group, collectives._execute_allreduce)

    def reduce_scatter(self, x: torch.Tensor, *, plan: Optional[Plan] = None,
                       group=None) -> CollectiveResult:
        """Ring reduce-scatter: rank r returns summed chunk r (flat view)."""
        return self._run("reduce_scatter", x, plan, group,
                         collectives._execute_reduce_scatter)

    def allgather(self, x: torch.Tensor, *, plan: Optional[Plan] = None,
                  group=None) -> CollectiveResult:
        """Ring allgather: compress once, forward compressed N-1 times."""
        return self._run("allgather", x, plan, group, collectives._execute_allgather)

    def scatter(self, x_full: torch.Tensor, *, root: int = 0,
                plan: Optional[Plan] = None, group=None) -> CollectiveResult:
        """Binomial-tree compressed scatter from ``root`` (root 0 only):
        ``x_full`` (n*chunk,) is significant on the root; rank r returns
        chunk r."""
        return self._run("scatter", x_full, plan, group,
                         collectives._execute_scatter, root=root)

    def broadcast(self, x: torch.Tensor, *, root: int = 0,
                  plan: Optional[Plan] = None, group=None) -> CollectiveResult:
        """Binomial-tree broadcast from ``root`` (root 0 only): compress
        once at the root."""
        return self._run("broadcast", x, plan, group,
                         collectives._execute_broadcast, root=root)

    def all_to_all(self, x: torch.Tensor, *, plan: Optional[Plan] = None,
                   group=None) -> CollectiveResult:
        """Compressed rank exchange; differentiable (straight through the
        quantizer, compressed cotangent: see :class:`_AllToAll`)."""
        return self._run("all_to_all", x, plan, group, _AllToAll.apply)

    def __repr__(self):
        return (
            f"GZCommunicator(axis={self.axis_name!r}, n={self._axis_size}, "
            f"policy={self.policy!r}, eb={self.config.eb}, hw={self.hw.name}, "
            f"device={self.device})"
        )


class GZHierCommunicator:
    """Resolve-once communicator bound to a two-level ``node x local``
    topology (the reference's ``GZHierCommunicator``).

    ``node_axis`` is the slow inter-node axis; ``local_axis`` the fast
    intra-node one, or a tuple of axes, all collapsed into "local" (the
    gradient sync folds every non-node axis in).  Calls run as a rank of
    a mesh (``ThreadGroup.run(..., axis_name=(node, local), shape=...)``
    or ``DistMesh.bind()``) that binds the node, local and composite
    ``(node, *local)`` handles.  ``topology`` may be given as ``(n_nodes,
    gpus_per_node)`` or read from the bound handles per call.  The
    default ``hw`` is the port's, ``cost_model.A100_SLINGSHOT``, which has
    a link asymmetry: ``L > 1`` may resolve hierarchical where the
    reference's default resolves flat.  ``CollectiveResult.wire_bytes``
    is the inter-node wire.  ``calibrate`` waits for ROADMAP A12.
    """

    def __init__(
        self,
        node_axis,
        local_axis,
        *,
        config=None,
        policy: str = "auto",
        hw: cost_model.Hardware = cost_model.A100_SLINGSHOT,
        ratio: float = 20.0,
        topology: Optional[tuple] = None,
        device="cuda",
        auto_depth: bool = False,
    ):
        self.node_axis = node_axis
        self.local_axis = (tuple(local_axis) if isinstance(local_axis, (tuple, list))
                           else local_axis)
        self.config = config if config is not None else collectives.GZConfig()
        if policy not in _POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; registered: {policy_names()}"
            )
        self.policy = policy
        self.hw = hw
        self.ratio = ratio
        self._topology = tuple(topology) if topology is not None else None
        self.device = transport.resolve_device(device)
        self._auto_depth = auto_depth

    @classmethod
    def for_axes(cls, node_axis, local_axis, *, config=None, policy: str = "auto",
                 hw: cost_model.Hardware = cost_model.A100_SLINGSHOT,
                 ratio: float = 20.0, topology: Optional[tuple] = None,
                 device="cuda", auto_depth: bool = False) -> "GZHierCommunicator":
        """Memoized communicator: one instance per distinct (axes, knobs),
        cleared with :func:`clear_plan_cache`."""
        local = (tuple(local_axis) if isinstance(local_axis, (tuple, list))
                 else local_axis)
        topo = tuple(topology) if topology is not None else None
        key = (cls, node_axis, local, config, policy, hw, ratio, topo,
               str(transport.resolve_device(device)), auto_depth)
        comm = _COMM_CACHE.get(key)
        if comm is None:
            comm = _COMM_CACHE[key] = cls(
                node_axis, local, config=config, policy=policy, hw=hw, ratio=ratio,
                topology=topo, device=device, auto_depth=auto_depth)
        return comm

    def _composite_axes(self) -> tuple:
        local = (self.local_axis if isinstance(self.local_axis, tuple)
                 else (self.local_axis,))
        return (self.node_axis,) + local

    def _handles(self):
        """(node, local, composite) rank handles bound on this thread."""
        g_node = transport.current(self.node_axis)
        g_local = transport.current(self.local_axis)
        g_all = transport.current(self._composite_axes())
        topo = (g_node.size, g_local.size)
        if self._topology is not None and topo != self._topology:
            raise ValueError(
                f"communicator bound to topology {self._topology}, but the mesh "
                f"on {self._composite_axes()!r} is {topo}"
            )
        return g_node, g_local, g_all

    def topology(self) -> tuple:
        """``(n_nodes, gpus_per_node)``: the bound tuple, or the sizes of
        the handles bound on this thread (never cached: one memoized
        communicator replans across reshaped meshes)."""
        if self._topology is not None:
            return self._topology
        g_node, g_local, _ = self._handles()
        return (g_node.size, g_local.size)

    def plan(self, shape, dtype=torch.float32) -> HierPlan:
        """The frozen :class:`HierPlan` for an allreduce of ``shape`` (a
        shape tuple or an element count) over the topology."""
        n_elems = int(np.prod(shape)) if not isinstance(shape, int) else shape
        cfg = self.config
        requested_algo = None if cfg.algo == "auto" else cfg.algo
        requested_chunks = cfg.pipeline_chunks
        if self._auto_depth and requested_chunks == 1:
            requested_chunks = 0
        return _resolve_hier_plan(
            "allreduce", n_elems, _dtype_name(dtype), self.topology(), cfg.eb,
            policy=self.policy, requested_algo=requested_algo,
            requested_chunks=requested_chunks,
            capacity_factor=cfg.capacity_factor,
            worst_case_budget=cfg.worst_case_budget, fused=cfg.fused,
            fused_hop=cfg.fused_hop, ratio=self.ratio, hw=self.hw,
            on_overflow=cfg.on_overflow, verify_streams=cfg.verify_streams,
            codec=cfg.codec,
        )

    def allreduce(self, x: torch.Tensor, *, plan: Optional[HierPlan] = None
                  ) -> CollectiveResult:
        """Two-level compressed sum-allreduce of this rank's ``x`` over
        ``node x local``.  The flags are OR-ed over the composite axis;
        under ``fallback`` a degraded call is the exact rank-order sum over
        the composite axis (the lossless twin of either branch)."""
        if x.device.type != self.device.type:
            raise ValueError(
                f"communicator runs on {self.device}, got a tensor on {x.device}"
            )
        n_nodes, L = self.topology()
        if n_nodes * L == 1:
            zero = torch.zeros((), dtype=torch.bool, device=x.device)
            return CollectiveResult(x, zero, zero, 0, 1.0)
        g_node, g_local, g_all = self._handles()
        axes = self._composite_axes()
        x = faults.maybe_poison_input(x, g_all)
        hplan = plan or self.plan(x.shape, x.dtype)
        out, ovf = collectives._execute_allreduce_hier(x, g_node, g_local, g_all, hplan)
        cfg = (hplan.flat_plan or hplan.inter).as_config()
        out, overflow, nonfinite = _degrade("allreduce", g_all, axes, x, out, ovf,
                                            hplan.on_overflow, cfg)
        return CollectiveResult(out, overflow, nonfinite, hplan.inter_wire_bytes,
                                hplan.ratio)

    def __repr__(self):
        return (
            f"GZHierCommunicator(node={self.node_axis!r}, "
            f"local={self.local_axis!r}, topology={self._topology}, "
            f"policy={self.policy!r}, eb={self.config.eb}, hw={self.hw.name}, "
            f"device={self.device})"
        )
