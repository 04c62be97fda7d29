"""Schedule IR: the ONE per-round route table every layer walks.

A copy of ``repro.core.schedule`` (same names, same tables — the
``tests/test_torch_plan.py`` sweep pins them equal), kept in the port so
that ``repro_torch`` imports nothing of the JAX package.  gZCCL's core
claim is that compression-enabled collectives must be *planned* —
schedule, pipeline depth and error budget resolved together (paper §3);
this module authors the per-round routes once for every algorithm.

A :class:`Schedule` is a frozen route table: ``rounds[k]`` is a tuple of
:class:`Hop` entries ``(sender, receiver, chunk_slab, stage,
payload_kind)`` — who ships which chunk slab to whom in wire round
``k``, whether the hop re-quantizes (``stage``) and what travels
(``payload_kind``).  Builders exist for every algorithm the stack runs:

  * ring reduce-scatter / allgather (both the fused-into-allreduce and
    the standalone owner conventions),
  * recursive doubling including the non-power-of-two fold/unfold
    remainder stage,
  * the integer ring (``intring`` — exact hops over one quantization
    grid),
  * the trimmed-slab binomial tree (scatter / broadcast — the slab
    combinatorics moved here from ``cost_model``),
  * the single-exchange all_to_all,
  * the two-level hierarchical composition (raw exact intra rounds
    around a lifted compressed inter schedule).

The table is authored ONCE here, resolved by the plan layer (carried on
``Plan.route_table`` / ``HierPlan.route_table``) and *walked* by the
consumers: ``collectives`` takes every exchange's perm from it and
``comm._wire_accounting`` prices it by summing per-entry payload bytes.
``error_budget.lossy_hops`` is derived from it too, by
the abstract error replay in :func:`lossy_hop_count` — the worst-case
multiplier now holds by construction for any future algorithm instead
of by per-algo string dispatch.

Everything here is pure Python over ints, with no imports from the
package, so every other core module may depend on it without cycles.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

__all__ = [
    "Hop",
    "Schedule",
    "STAGES",
    "PAYLOAD_KINDS",
    "build",
    "build_hier",
    "ring_perm",
    "redoub_layout",
    "binomial_slab_table",
    "scatter_root_chunk_streams",
    "tree_plan",
    "lossy_hop_count",
    "lossy_hops_for",
    "validate",
    "sender_entry_counts",
]

STAGES = ("lossy", "exact", "unfold")
PAYLOAD_KINDS = ("compressed", "raw", "checksum")

OPS = ("allreduce", "reduce_scatter", "allgather", "scatter", "broadcast",
       "all_to_all")


class Hop(NamedTuple):
    """One wire exchange inside a round.

    ``chunk_slab = (start, length)`` indexes the schedule's chunk space
    (``Schedule.n_chunks`` chunks; chunk indices are taken mod
    ``n_chunks`` so ring arithmetic can stay in rank space).  ``stage``
    says whether the hop carries a FRESH quantization ("lossy"), an
    already-quantized stream forwarded bit-exactly ("exact"), or the
    remainder unfold install ("unfold" — lossy, but structurally the
    post-hop).  ``payload_kind`` is what travels: a compressed stream, a
    raw f32 slab (exact intra-node stages, lossless fallback) or a
    checksum sidecar.
    """

    sender: int
    receiver: int
    chunk_slab: Tuple[int, int]
    stage: str
    payload_kind: str


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Frozen per-round route table for one collective.

    ``rounds[k]`` is the tuple of hops of wire round ``k`` (all shipped
    concurrently — payloads are computed from the pre-round state).
    ``combine[k]`` says how a receiver folds what arrives: ``"reduce"``
    (accumulate into the slab) or ``"install"`` (overwrite the slab).
    ``initial_lossy`` charges quantizations that happen BEFORE any wire
    round (intring's single up-front grid).
    """

    op: str
    algo: str
    n: int
    n_chunks: int
    rounds: Tuple[Tuple[Hop, ...], ...]
    combine: Tuple[str, ...]
    initial_lossy: int = 0

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    def perm(self, k: int) -> tuple:
        """The exchange perm of round ``k`` — (sender, receiver) pairs in
        entry order.  THE one place execute-layer perms come from."""
        return tuple((h.sender, h.receiver) for h in self.rounds[k])


# ---------------------------------------------------------------------------
# Shared combinatorics (moved here from cost_model / collectives — this
# module is the bottom of the import graph)
# ---------------------------------------------------------------------------


def ceil_log2(n: int) -> int:
    """ceil(log2 n) for n >= 1 (0 for n == 1)."""
    return max(int(n) - 1, 1).bit_length() if n > 1 else 0


@lru_cache(maxsize=None)
def ring_perm(n: int) -> tuple:
    """The uniform ring perm rank i -> i+1 every ring round uses."""
    return tuple((i, (i + 1) % n) for i in range(n))


def redoub_layout(n: int):
    """(p, rem, phys) of the non-power-of-two recursive-doubling layout:
    ``p = 2**floor(log2 n)`` participants, ``rem = n - p`` folded pairs,
    ``phys(v)`` the physical rank of virtual participant ``v``."""
    n = max(int(n), 1)
    p = 1 << (n.bit_length() - 1)
    rem = n - p

    def phys(v: int) -> int:
        return 2 * v + 1 if v < rem else v + rem

    return p, rem, phys


@lru_cache(maxsize=None)
def binomial_slab_table(n: int) -> tuple:
    """Trimmed-slab binomial-tree schedule over ``n`` ranks (top-down).

    One entry per ``ceil(log2 n)`` tree round, largest span first:
    ``(span, full_senders, trim)``.  Senders ``i`` in ``full_senders``
    ship a full ``span``-chunk slab to ``i + span`` (the receiver's
    whole virtual subtree ``[i+span, i+2*span)`` is real ranks);
    ``trim`` is the at-most-one boundary exchange ``(sender, receiver,
    slab)`` per round whose virtual subtree straddles ``n`` — it ships
    only the ``slab = n - receiver`` real chunks.  Exchanges whose
    receiver is ``>= n`` do not appear.  On power-of-two axes every
    round is all-full (``trim is None``).

    Moved here from ``cost_model`` (which now delegates): the slab
    combinatorics are schedule authority, not pricing.
    """
    n = int(n)
    steps = ceil_log2(max(n, 2))
    n_virt = 1 << steps
    rounds = []
    for k in reversed(range(steps)):
        span = 1 << k
        full, trim = [], None
        for i in range(0, n_virt, 2 * span):
            recv = i + span
            if recv >= n:
                continue
            slab = min(n, recv + span) - recv
            if slab == span:
                full.append(i)
            else:  # at most one straddling subtree per round
                trim = (i, recv, slab)
        rounds.append((span, tuple(full), trim))
    return tuple(rounds)


def scatter_root_chunk_streams(n: int) -> int:
    """Chunk streams the scatter root ships under the trimmed-slab
    schedule — exactly ``n - 1`` at ANY axis size."""
    total = 0
    for span, full, trim in binomial_slab_table(n):
        if 0 in full:
            total += span
        elif trim is not None and trim[0] == 0:
            total += trim[2]
    return total


def tree_plan(n: int):
    """Per-round ``(span, full_senders, trim, perm)`` of the binomial
    tree, with the perm taken from the scatter schedule builder — the
    walking surface ``collectives`` uses so tree perms never get
    re-derived inline."""
    sched = build("scatter", "binomial", n)
    table = binomial_slab_table(n)
    return tuple(
        (span, full, trim, sched.perm(k))
        for k, (span, full, trim) in enumerate(table)
    )


# ---------------------------------------------------------------------------
# Builders — one per algorithm; all memoized
# ---------------------------------------------------------------------------


def _ring_rs_rounds(n: int, owner_offset: int, stage: str, payload: str):
    """Ring reduce-scatter rounds: at round ``s`` rank ``i`` ships chunk
    ``(i - s + owner_offset) % n`` to ``i + 1``, which accumulates it.
    ``owner_offset = 0`` is the fused-into-allreduce convention (rank r
    ends owning chunk ``(r+1) % n``); ``owner_offset = -1`` the
    standalone reduce_scatter one (rank r ends owning chunk ``r``)."""
    return tuple(
        tuple(
            Hop(i, (i + 1) % n, ((i - s + owner_offset) % n, 1),
                stage, payload)
            for i in range(n)
        )
        for s in range(n - 1)
    )


def _ring_ag_rounds(n: int, own_offset: int, stage0: str, payload: str):
    """Ring allgather rounds: at round ``s`` rank ``r`` installs chunk
    ``(r - s + own_offset) % n`` from rank ``r - 1``.  Round 0 carries
    the sender's freshly compressed own chunk (``stage0``); later rounds
    forward that stream bit-exactly ("exact")."""
    return tuple(
        tuple(
            Hop((r - 1) % n, r, ((r - s + own_offset) % n, 1),
                stage0 if s == 0 else "exact", payload)
            for r in range(n)
        )
        for s in range(n - 1)
    )


@lru_cache(maxsize=None)
def _build_allreduce_ring(n: int) -> Schedule:
    rs = _ring_rs_rounds(n, 0, "lossy", "compressed")
    ag = _ring_ag_rounds(n, 0, "lossy", "compressed")
    return Schedule(
        op="allreduce", algo="ring", n=n, n_chunks=n,
        rounds=rs + ag,
        combine=("reduce",) * len(rs) + ("install",) * len(ag),
    )


@lru_cache(maxsize=None)
def _build_allreduce_intring(n: int) -> Schedule:
    # Same routes as the float ring, but every hop is EXACT: the single
    # up-front quantization grid is charged via initial_lossy and the
    # integer codes ride the ring losslessly.
    rs = _ring_rs_rounds(n, 0, "exact", "compressed")
    ag = _ring_ag_rounds(n, 0, "exact", "compressed")
    return Schedule(
        op="allreduce", algo="intring", n=n, n_chunks=n,
        rounds=rs + ag,
        combine=("reduce",) * len(rs) + ("install",) * len(ag),
        initial_lossy=1,
    )


@lru_cache(maxsize=None)
def _build_allreduce_redoub(n: int) -> Schedule:
    p, rem, phys = redoub_layout(n)
    rounds, combine = [], []
    if rem:
        rounds.append(tuple(
            Hop(2 * i, 2 * i + 1, (0, 1), "lossy", "compressed")
            for i in range(rem)
        ))
        combine.append("reduce")
    for k in range(p.bit_length() - 1):
        dist = 1 << k
        rounds.append(tuple(
            Hop(phys(v), phys(v ^ dist), (0, 1), "lossy", "compressed")
            for v in range(p)
        ))
        combine.append("reduce")
    if rem:
        rounds.append(tuple(
            Hop(2 * i + 1, 2 * i, (0, 1), "unfold", "compressed")
            for i in range(rem)
        ))
        combine.append("install")
    return Schedule(
        op="allreduce", algo="redoub", n=n, n_chunks=1,
        rounds=tuple(rounds), combine=tuple(combine),
    )


@lru_cache(maxsize=None)
def _build_reduce_scatter_ring(n: int) -> Schedule:
    rs = _ring_rs_rounds(n, -1, "lossy", "compressed")
    return Schedule(
        op="reduce_scatter", algo="ring", n=n, n_chunks=n,
        rounds=rs, combine=("reduce",) * len(rs),
    )


@lru_cache(maxsize=None)
def _build_allgather_ring(n: int) -> Schedule:
    # Standalone convention: chunk c is rank c's own payload; at round s
    # rank r installs chunk (r - s - 1) % n — its sender's own chunk at
    # round 0, then forwarded streams.
    ag = _ring_ag_rounds(n, -1, "lossy", "compressed")
    return Schedule(
        op="allgather", algo="ring", n=n, n_chunks=n,
        rounds=ag, combine=("install",) * len(ag),
    )


def _tree_rounds(n: int, root_only_payload: bool):
    """Binomial-tree install rounds from the slab table.  A hop is
    "lossy" iff the ROOT is the sender — every stream is compressed
    exactly once at the root; mid-rank forwards are bit-exact.  With
    ``root_only_payload`` (broadcast) each hop ships the whole message
    (chunk space 1); otherwise (scatter) the receiver's real-subtree
    slab ``[receiver, receiver + slab)``."""
    rounds = []
    for span, full, trim in binomial_slab_table(n):
        entries = []
        for i in full:
            slab = (0, 1) if root_only_payload else (i + span, span)
            entries.append(Hop(i, i + span, slab,
                               "lossy" if i == 0 else "exact", "compressed"))
        if trim is not None:
            snd, rcv, slab_len = trim
            slab = (0, 1) if root_only_payload else (rcv, slab_len)
            entries.append(Hop(snd, rcv, slab,
                               "lossy" if snd == 0 else "exact",
                               "compressed"))
        rounds.append(tuple(entries))
    return tuple(rounds)


@lru_cache(maxsize=None)
def _build_scatter_binomial(n: int) -> Schedule:
    rounds = _tree_rounds(n, root_only_payload=False)
    return Schedule(
        op="scatter", algo="binomial", n=n, n_chunks=n,
        rounds=rounds, combine=("install",) * len(rounds),
    )


@lru_cache(maxsize=None)
def _build_broadcast_binomial(n: int) -> Schedule:
    rounds = _tree_rounds(n, root_only_payload=True)
    return Schedule(
        op="broadcast", algo="binomial", n=n, n_chunks=1,
        rounds=rounds, combine=("install",) * len(rounds),
    )


@lru_cache(maxsize=None)
def _build_all_to_all(n: int) -> Schedule:
    # One exchange: rank i ships its j-th chunk to rank j (self-send
    # included — lax.all_to_all moves the diagonal through the same
    # buffer, and the wire accounting has always priced n streams).
    rounds = (tuple(
        Hop(i, j, (j, 1), "lossy", "compressed")
        for i in range(n) for j in range(n)
    ),)
    return Schedule(
        op="all_to_all", algo="direct", n=n, n_chunks=n,
        rounds=rounds, combine=("install",),
    )


_BUILDERS = {
    ("allreduce", "ring"): _build_allreduce_ring,
    ("allreduce", "intring"): _build_allreduce_intring,
    ("allreduce", "redoub"): _build_allreduce_redoub,
    ("reduce_scatter", "ring"): _build_reduce_scatter_ring,
    ("allgather", "ring"): _build_allgather_ring,
    ("scatter", "binomial"): _build_scatter_binomial,
    ("broadcast", "binomial"): _build_broadcast_binomial,
    ("all_to_all", "direct"): _build_all_to_all,
}


def build(op: str, algo: str, n: int) -> Schedule:
    """THE route-table authority: the memoized schedule for one
    collective over ``n`` ranks.  Raises ValueError for unknown
    (op, algo) pairs."""
    try:
        builder = _BUILDERS[(op, algo)]
    except KeyError:
        raise ValueError(f"no schedule builder for op={op!r} algo={algo!r}")
    return builder(int(n))


@lru_cache(maxsize=None)
def build_hier(n_nodes: int, local: int, inter_algo: str = "redoub") -> Schedule:
    """Two-level hierarchical allreduce composition over ``n_nodes * local``
    node-major ranks (rank = node*local + l — the layout
    ``launch.mesh.make_hier_mesh`` carves).

    Three stages concatenated: exact RAW intra-node reduce-scatter rounds
    (the canonical local ring — models ``lax.psum_scatter``'s 2(L-1)
    shard movement, which is what ``HierPlan`` prices), the compressed
    ``inter_algo`` allreduce lifted to every local index (hop
    ``s -> r`` of the inter table becomes ``s*L + l -> r*L + l`` for
    each ``l``), then exact RAW intra-node allgather rounds.  Intra
    rounds index the L-shard chunk space; the lifted inter rounds keep
    the inter schedule's own chunk space over the shard (documented
    asymmetry — pricing and fault targeting only need senders, stages
    and payload kinds, which are uniform).
    """
    L = int(local)
    n = int(n_nodes) * L
    rounds, combine = [], []
    if L > 1:
        for s in range(L - 1):
            rounds.append(tuple(
                Hop(m * L + j, m * L + (j + 1) % L, ((j - s - 1) % L, 1),
                    "exact", "raw")
                for m in range(n_nodes) for j in range(L)
            ))
            combine.append("reduce")
    if n_nodes > 1:
        inter = build("allreduce", inter_algo, n_nodes)
        for k, rnd in enumerate(inter.rounds):
            rounds.append(tuple(
                Hop(h.sender * L + l, h.receiver * L + l, h.chunk_slab,
                    h.stage, h.payload_kind)
                for h in rnd for l in range(L)
            ))
            combine.append(inter.combine[k])
    if L > 1:
        for s in range(L - 1):
            rounds.append(tuple(
                Hop(m * L + (j - 1) % L, m * L + j, ((j - s - 1) % L, 1),
                    "exact", "raw")
                for m in range(n_nodes) for j in range(L)
            ))
            combine.append("install")
    return Schedule(
        op="allreduce", algo=f"hier_{inter_algo}", n=n, n_chunks=L,
        rounds=tuple(rounds), combine=tuple(combine),
    )


# ---------------------------------------------------------------------------
# Derived analyses: error replay, conservation validation, entry counts
# ---------------------------------------------------------------------------


def _slab_chunks(h: Hop, n_chunks: int):
    start, length = h.chunk_slab
    return [(start + j) % n_chunks for j in range(length)]


def lossy_hop_count(sched: Schedule) -> int:
    """Worst-case error multiplier by ABSTRACT REPLAY of the table.

    Track an error multiplier ``e[rank][chunk]`` (how many fresh
    quantization errors of magnitude ``eb_stage`` the held value embeds,
    worst case).  A "reduce" hop merges the sender's accumulated error
    plus one fresh quantization if the hop re-quantizes; an "install"
    hop replaces with the stream's error (plus one if fresh).  The
    maximum over all (rank, chunk) at the end is the bound — this
    reproduces every closed form ``error_budget`` used to hard-code
    (redoub ``n-1``/``n``, ring ``n``, reduce-scatter ``n-1``, intring
    ``n``, movement ops ``1``) and holds by construction for any new
    builder.
    """
    n, C = sched.n, sched.n_chunks
    err = [[sched.initial_lossy] * C for _ in range(n)]
    for k, rnd in enumerate(sched.rounds):
        snap = [row[:] for row in err]
        mode = sched.combine[k]
        for h in rnd:
            add = 1 if h.stage in ("lossy", "unfold") else 0
            for c in _slab_chunks(h, C):
                if mode == "reduce":
                    err[h.receiver][c] += snap[h.sender][c] + add
                else:
                    err[h.receiver][c] = snap[h.sender][c] + add
    return max(max(row) for row in err)


_ALGO_KEYS = {
    "allreduce_redoub": ("allreduce", "redoub"),
    "allreduce_ring": ("allreduce", "ring"),
    "allreduce_intring": ("allreduce", "intring"),
    "reduce_scatter_ring": ("reduce_scatter", "ring"),
    "allgather_ring": ("allgather", "ring"),
    "scatter_binomial": ("scatter", "binomial"),
    "broadcast_binomial": ("broadcast", "binomial"),
}


@lru_cache(maxsize=None)
def lossy_hops_for(algo_key: str, n: int) -> int:
    """``error_budget.lossy_hops`` backend: the abstract replay of the
    resolved schedule table (n is floored at 2, preserving the historic
    degenerate-axis budgets)."""
    try:
        op, algo = _ALGO_KEYS[algo_key]
    except KeyError:
        raise ValueError(f"unknown algo {algo_key!r}")
    return lossy_hop_count(build(op, algo, max(int(n), 2)))


def sender_entry_counts(sched: Schedule):
    """Per-rank count of table entries sent (all rounds) — the busiest
    rank drives the wire accounting."""
    counts = [0] * sched.n
    for rnd in sched.rounds:
        for h in rnd:
            counts[h.sender] += 1
    return tuple(counts)


def validate(sched: Schedule) -> None:
    """Conservation + structural invariants of one table.  Raises
    AssertionError naming the violated invariant.

    * every hop names live ranks, a legal stage/payload kind, a slab
      inside the chunk space;
    * reduce ops: contributor-set replay — every rank's addend reaches
      every delivered chunk EXACTLY once (no duplicate, no loss);
    * movement ops: held-set replay — a sender must hold what it ships,
      every destination receives its payload exactly once;
    * binomial rounds carry at most one trimmed entry; redoub carries
      fold/unfold rounds iff n is non-power-of-two.
    """
    n, C = sched.n, sched.n_chunks

    def _require(cond, msg):
        if not cond:
            raise AssertionError(f"{sched.op}/{sched.algo} n={n}: {msg}")

    _require(len(sched.combine) == len(sched.rounds),
             "combine/rounds length mismatch")
    for k, rnd in enumerate(sched.rounds):
        _require(sched.combine[k] in ("reduce", "install"),
                 f"bad combine tag {sched.combine[k]!r}")
        seen_pairs = set()
        for h in rnd:
            _require(0 <= h.sender < n and 0 <= h.receiver < n,
                     f"rank out of range in round {k}: {h}")
            _require(h.sender != h.receiver or sched.op == "all_to_all",
                     f"self-send in round {k}: {h}")
            _require(h.stage in STAGES, f"bad stage {h.stage!r}")
            _require(h.payload_kind in PAYLOAD_KINDS,
                     f"bad payload kind {h.payload_kind!r}")
            start, length = h.chunk_slab
            _require(0 <= start < C and 1 <= length <= C,
                     f"slab out of range in round {k}: {h}")
            _require((h.sender, h.receiver) not in seen_pairs,
                     f"duplicate (sender, receiver) in round {k}")
            seen_pairs.add((h.sender, h.receiver))

    if sched.op in ("allreduce", "reduce_scatter"):
        _validate_reduce(sched, _require)
    elif sched.op in ("allgather", "scatter", "broadcast"):
        _validate_movement(sched, _require)
    elif sched.op == "all_to_all":
        pairs = {(h.sender, h.receiver) for h in sched.rounds[0]}
        _require(len(sched.rounds) == 1, "all_to_all is a single exchange")
        _require(pairs == {(i, j) for i in range(n) for j in range(n)},
                 "all_to_all must cover every (src, dst) pair exactly once")

    if sched.algo == "binomial":
        for k, (span, full, trim) in enumerate(binomial_slab_table(n)):
            trims = [h for h in sched.rounds[k]
                     if sched.op == "scatter" and h.chunk_slab[1] < span]
            _require(len(trims) <= 1,
                     f"round {k} has {len(trims)} trimmed entries")
            if n & (n - 1) == 0:
                _require(trim is None and not trims,
                         f"power-of-two n must have no trim (round {k})")
    if sched.algo == "redoub":
        has_unfold = any(h.stage == "unfold"
                         for rnd in sched.rounds for h in rnd)
        pow2 = n & (n - 1) == 0
        _require(has_unfold == (not pow2 and n > 1),
                 "fold/unfold rounds must appear iff n is non-power-of-two")


def _validate_reduce(sched: Schedule, _require) -> None:
    """Contributor-set replay: every addend delivered exactly once."""
    n, C = sched.n, sched.n_chunks
    contrib = [[{r} for _ in range(C)] for r in range(n)]
    for k, rnd in enumerate(sched.rounds):
        snap = [[s.copy() for s in row] for row in contrib]
        mode = sched.combine[k]
        for h in rnd:
            for c in _slab_chunks(h, C):
                if mode == "reduce":
                    dup = contrib[h.receiver][c] & snap[h.sender][c]
                    _require(not dup,
                             f"round {k}: contributors {sorted(dup)} merged "
                             f"twice into rank {h.receiver} chunk {c}")
                    contrib[h.receiver][c] |= snap[h.sender][c]
                else:
                    contrib[h.receiver][c] = snap[h.sender][c].copy()
    full = set(range(n))
    if sched.op == "allreduce":
        for r in range(n):
            for c in range(C):
                _require(contrib[r][c] == full,
                         f"rank {r} chunk {c} holds contributors "
                         f"{sorted(contrib[r][c])}, not all {n}")
    else:  # reduce_scatter: standalone owner convention — rank r owns chunk r
        for r in range(n):
            _require(contrib[r][r] == full,
                     f"rank {r}'s own chunk holds contributors "
                     f"{sorted(contrib[r][r])}, not all {n}")


def _validate_movement(sched: Schedule, _require) -> None:
    """Held-set replay: senders must hold what they ship; every
    destination receives exactly once."""
    n, C = sched.n, sched.n_chunks
    if sched.op == "allgather":
        held = [{r} for r in range(n)]
        expected_recv = {r: n - 1 for r in range(n)}
    else:  # scatter / broadcast: root 0 holds everything
        held = [set(range(C)) if r == 0 else set() for r in range(n)]
        expected_recv = {r: 1 for r in range(1, n)}
    received = {r: 0 for r in range(n)}
    for k, rnd in enumerate(sched.rounds):
        snap = [s.copy() for s in held]
        for h in rnd:
            chunks = set(_slab_chunks(h, C))
            missing = chunks - snap[h.sender]
            _require(not missing,
                     f"round {k}: sender {h.sender} ships chunks "
                     f"{sorted(missing)} it does not hold")
            if sched.op == "allgather":
                dup = chunks & held[h.receiver]
                _require(not dup,
                         f"round {k}: rank {h.receiver} receives chunks "
                         f"{sorted(dup)} twice")
            held[h.receiver] |= chunks
            received[h.receiver] += 1
    for r, want in expected_recv.items():
        if sched.op in ("scatter", "broadcast"):
            _require(received[r] == want,
                     f"rank {r} received {received[r]} slabs, expected "
                     f"{want}")
    if sched.op == "allgather":
        for r in range(n):
            _require(held[r] == set(range(n)),
                     f"rank {r} ends holding {sorted(held[r])}, not all "
                     f"{n} chunks")
    elif sched.op == "scatter":
        for r in range(n):
            _require(r in held[r], f"rank {r} never received its chunk")
    else:  # broadcast
        for r in range(n):
            _require(0 in held[r],
                     f"rank {r} never received the root payload")
