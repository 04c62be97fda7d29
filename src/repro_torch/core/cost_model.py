"""Analytic performance model for compression-enabled collectives.

A copy of ``repro.core.cost_model`` (same names, same results — the
``tests/test_torch_plan.py`` sweep pins them equal), kept in the port so
that ``repro_torch`` imports nothing of the JAX package.  It is the
executable form of the paper's §3.2/§3.3 analysis and the engine behind
the algorithm selector.  ``A100_SLINGSHOT`` is the paper's published GPU
point (A100 + Slingshot-10) and the port's default planning point;
``TPU_V5E`` is the JAX package's default, kept here only so the port's
plans can be compared with the reference's at the same point.  No H100
point exists yet: it comes with a ported ``calibrate()``.

Model pieces:

  t_comp(size)  = overhead + size / (peak * util(size))        [Fig. 3]
      util(s)   = s / (s + saturation)   — the under-utilization curve:
                  halves at the saturation size (~5 MB for cuSZp/A100,
                  paper §3.2.2), the root cause of ring's poor scaling.
  t_net(bytes)  = alpha + bytes / bw     — classic alpha-beta term per hop.

Collective compositions mirror the step counts in §3.2.3/§3.3.3 exactly;
``overlap`` discounts the portion of compression hidden behind
communication (the paper's multi-stream/async optimization), applied only
to the gZ (optimized) variants, not to CPRP2P/C-Coll baselines.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import schedule as _schedule

__all__ = [
    "Hardware",
    "CodecTerms",
    "A100_SLINGSHOT",
    "TPU_V5E",
    "steps_for",
    "binomial_slab_table",
    "scatter_root_chunk_streams",
    "t_compress",
    "t_decompress",
    "t_hop_fused",
    "allreduce_ring_gz",
    "allreduce_redoub_gz",
    "allreduce_intring_gz",
    "allreduce_uncompressed_ring",
    "t_net_intra",
    "reduce_scatter_uncompressed_intra",
    "allgather_uncompressed_intra",
    "allreduce_hier_gz",
    "allreduce_cprp2p",
    "allreduce_ccoll",
    "allreduce_ring_gz_chunked",
    "scatter_binomial_gz",
    "scatter_binomial_gz_chunked",
    "scatter_uncompressed_binomial",
    "allgather_ring_gz",
    "best_pipeline_chunks",
    "best_scatter_pipeline_chunks",
    "BucketPlan",
    "best_bucket_plan",
    "BUCKET_BYTES_CANDIDATES",
    "fallback_time",
    "expected_collective_time",
]


@dataclasses.dataclass(frozen=True)
class CodecTerms:
    """Per-codec pricing terms for the planner (DESIGN.md §10).

    Every field except ``codec`` is optional-by-sentinel so a terms entry
    only overrides what was actually measured or modeled:

      * ``ratio_scale``  — wire-ratio multiplier applied to the caller's
        assumed dense-Lorenzo ratio (eb-scaled codecs: the achievable
        ratio tracks the data/eb regime, only the *relative* win is
        codec-intrinsic);
      * ``ratio_abs``    — absolute wire ratio (> 0 overrides the scale;
        eb-independent codecs: lossless / passthrough ship the same bytes
        whatever the bound);
      * ``cmp_peak_gbps`` / ``dec_peak_gbps`` / ``cmp_overhead_us`` —
        codec-specific compressor terms (sentinels: 0 / 0 / negative mean
        "inherit the Hardware point's dense-Lorenzo terms").

    Instances live in ``Hardware.codec_terms`` (a tuple, so the Hardware
    point stays hashable for the plan-cache key) and are produced either
    by the registry's modeled defaults (``codecs.get_codec(...).terms``)
    or by ``comm.fit_codec_terms`` from measured samples.
    """

    codec: str
    ratio_scale: float = 1.0
    ratio_abs: float = 0.0
    cmp_peak_gbps: float = 0.0
    dec_peak_gbps: float = 0.0
    cmp_overhead_us: float = -1.0

    def effective_ratio(self, assumed_ratio: float) -> float:
        if self.ratio_abs > 0.0:
            return self.ratio_abs
        # Entropy trim cannot make the wire worse than raw (ratio < 1).
        return max(assumed_ratio * self.ratio_scale, 1.0)

    def apply(self, hw: "Hardware") -> "Hardware":
        """Hardware point with this codec's compressor terms swapped in."""
        kw = {}
        if self.cmp_peak_gbps > 0.0:
            kw["cmp_peak_gbps"] = self.cmp_peak_gbps
        if self.dec_peak_gbps > 0.0:
            kw["dec_peak_gbps"] = self.dec_peak_gbps
        if self.cmp_overhead_us >= 0.0:
            kw["cmp_overhead_us"] = self.cmp_overhead_us
        return dataclasses.replace(hw, **kw) if kw else hw


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    cmp_peak_gbps: float      # compressor throughput at full utilization
    dec_peak_gbps: float
    cmp_saturation_mb: float  # input size at which utilization = 50%
    cmp_overhead_us: float    # per-invocation fixed cost (kernel launch /
                              # dispatch + pipeline fill)
    net_gbps: float           # INTER-node per-link bandwidth (the slow hop)
    net_alpha_us: float       # inter-node per-hop latency
    reduce_gbps: float        # on-device reduction bandwidth
    pcie_gbps: float = 0.0    # host staging penalty (CPU-centric designs)
    # Per-link-class terms for the two-level (node x intra-node) topology:
    # NVLink/ICI-class links inside a node vs the fabric between nodes.
    # intra_gbps == 0.0 declares a FLAT fabric (every link priced at
    # net_gbps/net_alpha_us) — the pre-hierarchy behavior, and the default
    # so every existing Hardware point keeps its meaning.
    intra_gbps: float = 0.0       # intra-node per-link bandwidth
    intra_alpha_us: float = 0.0   # intra-node per-hop latency
    # Dense matmul throughput of one accelerator (TFLOP/s) — the term the
    # bucketed-overlap planner prices backward compute with.  0.0 means
    # "uncalibrated": best_bucket_plan then treats backward as free and
    # degenerates to pure wire-serialization planning.
    compute_tflops: float = 0.0
    # Measured per-codec pricing (tuple of CodecTerms so the point stays
    # hashable for plan-cache keys).  Empty means "no codec was calibrated
    # here": the planner falls back to the registry's modeled defaults.
    codec_terms: tuple = ()

    def terms_for(self, codec: str):
        """The calibrated CodecTerms for ``codec``, or None."""
        for t in self.codec_terms:
            if t.codec == codec:
                return t
        return None

    def intra_terms(self) -> tuple:
        """(gbps, alpha_us) of the intra-node link class; falls back to
        the inter-node terms on a flat fabric (intra_gbps == 0)."""
        if self.intra_gbps > 0.0:
            return self.intra_gbps, self.intra_alpha_us
        return self.net_gbps, self.net_alpha_us

    def link_asymmetry(self) -> float:
        """intra / inter bandwidth ratio (1.0 on a flat fabric) — the
        quantity that decides whether two-level planning can pay."""
        return self.intra_terms()[0] / self.net_gbps


# Calibrated to paper Fig. 3 (cuSZp on A100: ~5 MB saturation; ~100 GB/s
# class compression at saturation) and Slingshot-10 (100 Gbps).  The
# intra-node link is NVLink3 (~600 GB/s per GPU): the ~48:1 asymmetry is
# exactly the regime where the paper's 512-GPU numbers live — compression
# only pays on the slow inter-node hop.
A100_SLINGSHOT = Hardware(
    name="a100-slingshot10",
    cmp_peak_gbps=140.0 * 8,
    dec_peak_gbps=200.0 * 8,
    cmp_saturation_mb=5.0,
    cmp_overhead_us=30.0,
    net_gbps=100.0,
    net_alpha_us=5.0,
    reduce_gbps=1300.0 * 8,
    pcie_gbps=64.0 * 8,
    intra_gbps=600.0 * 8,
    intra_alpha_us=2.0,
    compute_tflops=312.0,  # A100 dense bf16 tensor-core peak
)

# The JAX package's default planning point, copied unchanged for plan
# comparisons only; never the port's default.
TPU_V5E = Hardware(
    name="tpu-v5e",
    cmp_peak_gbps=400.0 * 8,
    dec_peak_gbps=500.0 * 8,
    cmp_saturation_mb=2.0,
    cmp_overhead_us=8.0,
    net_gbps=50.0 * 8,
    net_alpha_us=1.0,
    reduce_gbps=819.0 * 8,
    compute_tflops=197.0,  # v5e dense bf16 peak
)


def steps_for(algo: str, n: int) -> int:
    """Wire-exchange count per (busiest) rank, exactly as the execute
    layer schedules it — the ONE step-count authority shared by this cost
    model, the plan layer's wire accounting (``comm._wire_accounting``)
    and the policy selectors, so floor-vs-ceil drift between planning and
    costing cannot recur.

    * ``redoub``:   ceil(log2 n) — floor(log2 n) doubling rounds plus the
                    non-power-of-two remainder fold exchange (the unfold
                    send comes from the *other* half of each folded pair,
                    so the busiest rank still ships ceil(log2 n) full
                    streams: fold-destination ranks send every doubling
                    round plus the unfold).
    * ``binomial``: ceil(log2 n) tree rounds (scatter / broadcast; the
                    root sends every round).
    * ``ring``:     n - 1 hops per ring stage.
    * ``intring``:  2(n - 1) lossless integer hops (RS + AG rings).
    * ``direct``:   1 (the all_to_all single exchange).
    """
    n = max(int(n), 2)
    if algo in ("redoub", "binomial"):
        return max(n - 1, 1).bit_length()  # == ceil(log2 n)
    if algo == "ring":
        return n - 1
    if algo == "intring":
        return 2 * (n - 1)
    if algo == "direct":
        return 1
    raise ValueError(f"unknown algo {algo!r}")


# The trimmed-slab binomial-tree combinatorics moved to core/schedule.py
# (the Schedule IR is the one route authority); these names stay
# importable here because the pricing models address the schedule
# through the cost model.
binomial_slab_table = _schedule.binomial_slab_table
scatter_root_chunk_streams = _schedule.scatter_root_chunk_streams


def _root_slab_chunks(round_entry) -> tuple:
    """(slab_chunks, is_full) of the ROOT's outgoing exchange in one
    ``binomial_slab_table`` round (the root sends every round — the
    busiest rank the scatter models price)."""
    span, full, trim = round_entry
    if 0 in full:
        return span, True
    return trim[2], False  # root's subtree straddles n: trimmed slab


def _util(size_bytes: float, hw: Hardware) -> float:
    s_mb = size_bytes / 1e6
    return s_mb / (s_mb + hw.cmp_saturation_mb)


def t_compress(size_bytes: float, hw: Hardware) -> float:
    """Seconds for one compression call of `size_bytes` input."""
    if size_bytes <= 0:
        return 0.0
    eff = hw.cmp_peak_gbps * 1e9 / 8 * _util(size_bytes, hw)
    return hw.cmp_overhead_us * 1e-6 + size_bytes / eff


def t_decompress(size_bytes: float, hw: Hardware) -> float:
    if size_bytes <= 0:
        return 0.0
    eff = hw.dec_peak_gbps * 1e9 / 8 * _util(size_bytes, hw)
    return hw.cmp_overhead_us * 1e-6 + size_bytes / eff


def t_hop_fused(size_bytes: float, hw: Hardware) -> float:
    """One single-pass unpack→reduce→repack hop over a `size_bytes` piece.

    The fused kernel streams the piece through on-chip memory once: decode + re-encode
    at the piece size's utilization, ONE per-invocation overhead instead of
    the two the decoupled composition pays, and no separate reduce term —
    the add rides the same pass, so the f32 intermediate's HBM round-trip
    (what ``t_reduce`` models) is gone.
    """
    if size_bytes <= 0:
        return 0.0
    u = _util(size_bytes, hw)
    dec_eff = hw.dec_peak_gbps * 1e9 / 8 * u
    cmp_eff = hw.cmp_peak_gbps * 1e9 / 8 * u
    return hw.cmp_overhead_us * 1e-6 + size_bytes / dec_eff + size_bytes / cmp_eff


def t_net(bytes_on_wire: float, hw: Hardware) -> float:
    return hw.net_alpha_us * 1e-6 + bytes_on_wire / (hw.net_gbps * 1e9 / 8)


def t_reduce(size_bytes: float, hw: Hardware) -> float:
    return size_bytes / (hw.reduce_gbps * 1e9 / 8)


def _overlapped(compute: float, comm: float, overlap: float) -> float:
    """Combine a compute and a comm phase with fractional overlap."""
    hidden = min(compute, comm) * overlap
    return compute + comm - hidden


# --- Allreduce variants (message D bytes, N ranks, compression ratio R) ---


def allreduce_ring_gz(D, N, R, hw: Hardware, overlap: float = 0.7) -> float:
    """gZ-Allreduce (Ring): (N-1) RS steps of chunk D/N + AG forwarding."""
    ch = D / N
    step_rs = _overlapped(
        t_compress(ch, hw) + t_decompress(ch, hw) + t_reduce(ch, hw),
        t_net(ch / R, hw),
        overlap,
    )
    step_ag = _overlapped(t_decompress(ch, hw), t_net(ch / R, hw), overlap)
    return (N - 1) * step_rs + t_compress(ch, hw) + (N - 1) * step_ag


def allreduce_redoub_gz(
    D, N, R, hw: Hardware, overlap: float = 0.7, *, fused_hop: bool = True
) -> float:
    """gZ-Allreduce (ReDoub): ~log2(N) full-message exchanges.

    ``fused_hop`` models the single-pass schedule (one fill compression,
    then one ``t_hop_fused`` kernel per step instead of the decoupled
    compress + decompress+reduce pair) — keep it in sync with the ring's
    fused costing so auto-selection compares like with like.

    Non-power-of-two N is priced with the paper's remainder stage
    (§3.2.3): the fold pre-hop rides the same per-step cost (it is one
    more full-message compressed exchange, hence ``steps_for`` returns
    ceil(log2 N)), and the unfold post-hop adds one compressed send plus
    a decompress on the folded pairs — the extra term that shifts the
    ring-vs-redoub crossover at non-power-of-two N.
    """
    N = max(int(N), 2)
    steps = steps_for("redoub", N)
    remainder = N & (N - 1) != 0
    post = (t_net(D / R, hw) + t_decompress(D, hw)) if remainder else 0.0
    if fused_hop:
        # The unfold stream falls out of the last doubling step's fused
        # kernel (decompress_reduce_compress instead of decompress_reduce
        # — already charged as one t_hop_fused like every step), so the
        # post-hop adds only wire + the folded ranks' decompress.
        one = _overlapped(t_hop_fused(D, hw), t_net(D / R, hw), overlap)
        return t_compress(D, hw) + steps * one + post
    if remainder:
        # Two-kernel schedule: the unfold payload needs its own explicit
        # compression of the final accumulator before the post-hop.
        post += t_compress(D, hw)
    one = _overlapped(
        t_compress(D, hw) + t_decompress(D, hw) + t_reduce(D, hw),
        t_net(D / R, hw),
        overlap,
    )
    return steps * one + post


def allreduce_intring_gz(D, N, R, hw: Hardware, overlap: float = 0.7) -> float:
    """Beyond-paper integer ring: one quantize + lossless int repack hops.

    Repacking costs ~a decompress+compress of the (compressed-size) codes;
    wire width grows ~log2(step)/32 per hop (modeled via a 15% inflation).
    """
    ch = D / N
    wire = ch / R * 1.15
    quant = t_compress(D, hw)  # single full-size quantize (saturated)
    step = _overlapped(
        t_compress(ch / R, hw) + t_decompress(ch / R, hw) + t_reduce(ch / R, hw),
        t_net(wire, hw),
        overlap,
    )
    return quant + (2 * N - 2) * step


def allreduce_uncompressed_ring(D, N, hw: Hardware) -> float:
    """NCCL-class baseline: 2(N-1) hops of D/N, no compression."""
    return 2 * (N - 1) * t_net(D / N, hw)


# --- Two-level (node x intra-node) topology (DESIGN.md §8) ---


def t_net_intra(bytes_on_wire: float, hw: Hardware) -> float:
    """Alpha-beta term for one intra-node hop (NVLink/ICI link class);
    identical to ``t_net`` on a flat fabric (``intra_gbps == 0``)."""
    gbps, alpha_us = hw.intra_terms()
    return alpha_us * 1e-6 + bytes_on_wire / (gbps * 1e9 / 8)


def reduce_scatter_uncompressed_intra(D, L, hw: Hardware) -> float:
    """Uncompressed ring reduce-scatter over the L intra-node ranks:
    (L-1) hops of D/L on the fast link, no codec anywhere — at NVLink
    bandwidth the compressor would be the bottleneck, which is the whole
    point of placing codec work only on the slow hop."""
    L = max(int(L), 1)
    if L == 1:
        return 0.0
    return (L - 1) * (t_net_intra(D / L, hw) + t_reduce(D / L, hw))


def allgather_uncompressed_intra(D, L, hw: Hardware) -> float:
    """Uncompressed ring allgather of the L node-local shards (D total)."""
    L = max(int(L), 1)
    if L == 1:
        return 0.0
    return (L - 1) * t_net_intra(D / L, hw)


def allreduce_hier_gz(
    D, n_nodes, L, R, hw: Hardware, *,
    inter_algo: str = "ring", chunks: int = 1,
    fused_hop: bool = True, overlap: float = 0.7,
) -> float:
    """Two-level allreduce: uncompressed intra-node reduce-scatter
    (fast link, D/L shards) → compressed ``inter_algo`` allreduce of the
    D/L shard across the n_nodes node peers (slow link — the only place
    the codec runs) → uncompressed intra-node allgather.

    Each stage reuses the exact single-axis model it composes, so the
    hier-vs-flat comparison in the planner prices both sides with the
    same machinery.  The inter stage dominates whenever
    ``hw.link_asymmetry()`` is large: the flat compressed ring ships
    ~2(N-1) chunk streams across node boundaries, the hierarchy ships
    the inter pattern on a 1/L-size shard.
    """
    n_nodes = max(int(n_nodes), 1)
    L = max(int(L), 1)
    total = reduce_scatter_uncompressed_intra(D, L, hw)
    shard = D / L
    if n_nodes > 1:
        if inter_algo == "redoub":
            total += allreduce_redoub_gz(
                shard, n_nodes, R, hw, overlap, fused_hop=fused_hop
            )
        elif inter_algo == "intring":
            total += allreduce_intring_gz(shard, n_nodes, R, hw, overlap)
        else:
            total += allreduce_ring_gz_chunked(
                shard, n_nodes, R, hw, chunks, fused_hop=fused_hop
            )
    total += allgather_uncompressed_intra(D, L, hw)
    return total


def allreduce_cprp2p(D, N, R, hw: Hardware) -> float:
    """CPRP2P [30]: compress+decompress around EVERY hop, no overlap."""
    ch = D / N
    per_hop = t_compress(ch, hw) + t_net(ch / R, hw) + t_decompress(ch, hw) + t_reduce(ch, hw)
    return 2 * (N - 1) * per_hop


def allreduce_ccoll(D, N, R, hw: Hardware) -> float:
    """C-Coll [12]: compression-optimized but CPU-centric — adds host
    staging (PCIe both ways per hop) and no GPU-side overlap."""
    ch = D / N
    stage = 2 * ch / (hw.pcie_gbps * 1e9 / 8) if hw.pcie_gbps else 0.0
    step_rs = t_compress(ch, hw) + t_net(ch / R, hw) + t_decompress(ch, hw) \
        + t_reduce(ch, hw) + stage
    step_ag = t_net(ch / R, hw) + t_decompress(ch, hw) + stage
    return (N - 1) * step_rs + t_compress(ch, hw) + (N - 1) * step_ag


# --- Chunked double-buffered pipeline (DESIGN.md §4) ---
#
# The explicit per-chunk overlap model of the pipelined schedules in
# core/collectives.py.  Unlike the fractional ``overlap`` discount above
# (which credits an *assumed* multi-stream engine), this models the
# schedule the implementation actually runs, over TWO resources: the
# device (where every codec kernel serializes — compress and
# decompress+reduce cannot overlap each other) and the wire.  Each ring
# chunk is split into ``chunks`` pieces double-buffered through the
# [device, wire] chain, so steady-state throughput is set by the slower
# resource and the ends pay a fill + drain of one piece.  chunks=1 is the
# sequential schedule (zero overlap) — what the unpipelined code paths do.
# The cost of pipelining is explicit too: every piece-hop pays the
# per-invocation device overhead (TWO ``cmp_overhead_us`` on the
# decoupled two-kernel hop, ONE on the fused single-pass hop) and runs at
# the *piece* size's utilization — which is why the best chunk count
# falls back to 1 below the saturation size, and why fusing the hop
# moves the overhead-vs-overlap break-even toward deeper pipelines.


def _pipeline_phase(stage_times, chunks: int) -> float:
    """Fill/drain + steady-state time of `chunks` pieces through serial,
    double-buffered stages: sum(stages) + (chunks-1) * max(stages)."""
    return sum(stage_times) + (chunks - 1) * max(stage_times)


def allreduce_ring_gz_chunked(
    D, N, R, hw: Hardware, chunks: int = 1, *, fused_hop: bool = True
) -> float:
    """gZ-Allreduce (Ring) under the chunked double-buffered schedule.

    Each of the (N-1) RS steps pipelines `chunks` pieces of D/(N*chunks)
    bytes over the [device, wire] resource pair; the AG stage does the
    same with the forwarding decompress, plus the owner's one-off
    piece-wise compression.

    Per piece-hop the device stage is:

      two-kernel hop:         t_compress + t_decompress + t_reduce
                              — TWO ``cmp_overhead_us`` plus the f32
                              intermediate's HBM round-trip, every hop;
      ``fused_hop``:          ``t_hop_fused`` — ONE overhead, one on-chip
                              pass, preceded by a one-off pipeline fill
                              (step 0's P piece compressions).

    Pipelining hides wire time behind device time (or vice versa); its
    price is the per-piece device overhead times depth.  Halving that
    overhead via the fused hop is what moves ``best_pipeline_chunks``
    deeper (DESIGN.md §4).
    """
    piece = D / N / chunks
    wire = t_net(piece / R, hw)
    if fused_hop:
        fill = chunks * t_compress(piece, hw)  # step 0's sends, up front
        rs = fill + (N - 1) * _pipeline_phase(
            [t_hop_fused(piece, hw), wire], chunks
        )
    else:
        dev = t_compress(piece, hw) + t_decompress(piece, hw) + t_reduce(piece, hw)
        rs = (N - 1) * _pipeline_phase([dev, wire], chunks)
    own = chunks * t_compress(piece, hw)  # owner compress, not overlappable
    step_ag = _pipeline_phase([wire, t_decompress(piece, hw)], chunks)
    return rs + own + (N - 1) * step_ag


def scatter_binomial_gz_chunked(D, N, R, hw: Hardware, chunks: int = 1) -> float:
    """gZ-Scatter with each tree round's full-span slab split into
    `chunks` piece chains: the receiver-side install (buffer copy at
    reduce bandwidth) overlaps the next piece's wire time.  Rounds and
    slab sizes follow the trimmed-slab schedule the execute layer runs at
    any N (``binomial_slab_table``): only real-rank chunks are priced,
    and a trimmed boundary slab ships as one piece (its size is not a
    power of two, so the execute layer does not split it)."""
    chunk = D / N
    total = t_compress(D, hw)  # batched root compression, saturated
    for entry in binomial_slab_table(N):
        span = entry[0]
        slab, is_full = _root_slab_chunks(entry)
        g = min(chunks, span) if (is_full and span > 1) else 1
        piece = slab * chunk / R / g
        total += _pipeline_phase(
            [t_net(piece, hw), t_reduce(piece, hw)], g
        )
    total += t_decompress(D / N, hw)
    return total


# Single source of truth for every planner entry point (selector plan,
# gz_allreduce auto, grad_sync routing) — keep them agreeing.
PIPELINE_CHUNK_CANDIDATES = (1, 2, 4, 8, 16)


def best_pipeline_chunks(
    D, N, R, hw: Hardware, candidates=PIPELINE_CHUNK_CANDIDATES, *,
    fused_hop: bool = True,
) -> int:
    """Chunk count minimizing the chunked-ring model (1 == don't pipeline).

    With ``fused_hop`` the per-piece fixed cost is one kernel overhead
    instead of two, so the optimum is deeper (or equal) at every (D, N).
    """
    return min(
        candidates,
        key=lambda c: allreduce_ring_gz_chunked(
            D, N, R, hw, c, fused_hop=fused_hop
        ),
    )


def best_scatter_pipeline_chunks(
    D, N, R, hw: Hardware, candidates=PIPELINE_CHUNK_CANDIDATES
) -> int:
    """Per-round piece count minimizing the chunked scatter model — the
    depth ``comm.plan("scatter", ...)`` resolves when the caller asks for
    auto depth (``requested_chunks == 0``)."""
    return min(
        candidates,
        key=lambda c: scatter_binomial_gz_chunked(D, N, R, hw, c),
    )


# --- Bucketed backward overlap ---

BUCKET_BYTES_CANDIDATES = tuple(
    (1 << 20) * m for m in (1, 2, 4, 8, 16, 32, 64)
)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Frozen co-plan of bucket size and ring pipeline depth for the
    backward-overlapped gradient sync.

    ``overlap_efficiency`` is the fraction of the total sync time hidden
    under backward compute by the greedy schedule: 0.0 means fully serial
    (one bucket, or no calibrated compute term), values approach 1.0 when
    the wire is completely hidden.  All fields are static model outputs —
    BENCH_gradsync.json pins them exactly in CI.
    """

    bucket_bytes: int        # payload per compressed allreduce
    n_buckets: int
    pipeline_chunks: int     # ring depth each bucket's plan resolves
    t_backward: float        # seconds of backward compute (model)
    t_bucket: float          # seconds per bucket allreduce (model)
    t_sync_total: float      # n_buckets * t_bucket
    t_serial: float          # backward THEN sync
    t_overlapped: float      # greedy last-layer-first schedule finish
    overlap_efficiency: float

    @property
    def speedup(self) -> float:
        return self.t_serial / self.t_overlapped if self.t_overlapped else 1.0


def _overlap_schedule(t_backward: float, n_buckets: int,
                      t_bucket: float) -> float:
    """Finish time of the greedy last-layer-first schedule.

    Backward produces gradients in reverse layer order at a uniform
    modeled rate, so bucket ``i`` (issue order) is ready at
    ``(i+1) * t_backward / K``; the wire is a single serial resource, so
    each bucket starts at ``max(ready_i, prev_finish)``.  Compute-bound
    regimes finish at ``t_backward + t_bucket`` (all but the last bucket
    fully hidden); wire-bound regimes at ``t_backward/K + K*t_bucket``
    (the wire never idles after the first bucket lands).
    """
    finish = 0.0
    for i in range(n_buckets):
        ready = (i + 1) * t_backward / n_buckets
        finish = max(finish, ready) + t_bucket
    return finish


def best_bucket_plan(
    hw: Hardware, tree_bytes: float, backward_flops: float, n: int,
    R: float = 20.0, *, candidates=BUCKET_BYTES_CANDIDATES,
    fused_hop: bool = True,
) -> BucketPlan:
    """Co-plan bucket size with ring pipeline depth so codec work hides
    under both ppermute AND backward FLOPs.

    The tension the search resolves: big buckets keep the compressor on
    its saturation plateau (``_util``) and amortize per-hop alphas, but
    the first bucket cannot launch before ``t_backward / K`` — small
    buckets start the wire earlier and drain it in parallel with the
    remaining backward, at worse codec utilization.  Each candidate
    prices its per-bucket allreduce through the SAME chunked-ring model
    the plan layer uses (``best_pipeline_chunks`` →
    ``allreduce_ring_gz_chunked``), so the depth the bucket's frozen Plan
    will actually resolve is the depth being priced.
    """
    n = int(n)
    tree_bytes = float(tree_bytes)
    if tree_bytes <= 0:
        raise ValueError(f"best_bucket_plan: tree_bytes={tree_bytes!r}")
    t_backward = (
        float(backward_flops) / (hw.compute_tflops * 1e12)
        if hw.compute_tflops > 0 else 0.0
    )
    best = None
    for cand in candidates:
        b = int(min(cand, tree_bytes))
        k = int(math.ceil(tree_bytes / b))
        if n > 1:
            depth = best_pipeline_chunks(b, n, R, hw, fused_hop=fused_hop)
            t_bucket = allreduce_ring_gz_chunked(
                b, n, R, hw, depth, fused_hop=fused_hop
            )
        else:
            depth, t_bucket = 1, 0.0
        t_sync = k * t_bucket
        t_serial = t_backward + t_sync
        t_over = _overlap_schedule(t_backward, k, t_bucket)
        eff = (t_serial - t_over) / t_sync if t_sync > 0 else 0.0
        plan = BucketPlan(
            bucket_bytes=b, n_buckets=k, pipeline_chunks=depth,
            t_backward=t_backward, t_bucket=t_bucket, t_sync_total=t_sync,
            t_serial=t_serial, t_overlapped=t_over,
            overlap_efficiency=eff,
        )
        if best is None or plan.t_overlapped < best.t_overlapped:
            best = plan
    return best


# --- Data movement ---


def allgather_ring_gz(D_chunk, N, R, hw: Hardware, overlap: float = 0.7) -> float:
    """gZ-Allgather: 1 compression + (N-1) forward hops w/ overlapped dec."""
    one = _overlapped(t_decompress(D_chunk, hw), t_net(D_chunk / R, hw), overlap)
    return t_compress(D_chunk, hw) + (N - 1) * one


def scatter_binomial_gz(D, N, R, hw: Hardware, overlap: float = 0.7) -> float:
    """gZ-Scatter: batched root compression of N chunks (ONE saturated call
    — the multi-stream analog) + ceil(log2 N) tree rounds of trimmed
    slabs + one decompression at each leaf.  Per-round payloads are the
    root's real-rank slab sizes from ``binomial_slab_table`` (summing to
    N-1 chunks at any N) — identical to the classic 2**k halving slabs on
    power-of-two axes, strictly smaller otherwise."""
    chunk = D / N
    total = t_compress(D, hw)  # batched: full-size utilization
    for entry in binomial_slab_table(N):
        slab, _ = _root_slab_chunks(entry)
        total += t_net(slab * chunk / R, hw)
    total += t_decompress(D / N, hw)
    return total


def scatter_uncompressed_binomial(D, N, hw: Hardware) -> float:
    """Cray-MPI-model binomial scatter: same trimmed-slab round structure
    (a real MPI scatter ships exactly N-1 chunks too), uncompressed."""
    chunk = D / N
    return sum(
        t_net(_root_slab_chunks(entry)[0] * chunk, hw)
        for entry in binomial_slab_table(N)
    )


# --- Degradation pricing (DESIGN.md §9) ---


def fallback_time(op: str, D, N, hw: Hardware) -> float:
    """Seconds the LOSSLESS fallback schedule of ``op`` costs: the price
    of one degraded call (``collectives._execute_lossless``), recorded on
    every ``Plan.fallback`` so the planner can expose what an overflow /
    non-finite event will cost at runtime.

    ``D`` is the raw f32 byte size of the op's input payload.  The
    fallback is algorithm-UNIFORM — the same uncompressed schedule runs
    regardless of which compressed algo the plan picked — so this is
    informational/observable, never a re-ranking input for the selector
    (a fallback should be rare; pricing it into the ranking would just
    bias against compression everywhere).
    """
    N = int(N)
    if N <= 1:
        return 0.0
    if op == "allreduce":
        return allreduce_uncompressed_ring(D, N, hw)
    if op == "reduce_scatter":
        return (N - 1) * (t_net(D / N, hw) + t_reduce(D / N, hw))
    if op == "allgather":
        return (N - 1) * t_net(D, hw)
    if op == "scatter":
        return scatter_uncompressed_binomial(D, N, hw)
    if op == "broadcast":
        return steps_for("binomial", N) * t_net(D, hw)
    if op == "all_to_all":
        return t_net(D, hw)
    raise ValueError(f"fallback_time: unknown op {op!r}")


def expected_collective_time(
    t_compressed: float, t_fallback: float, p_degraded: float
) -> float:
    """Expected wall time when a fraction ``p_degraded`` of calls degrade:
    a degraded call pays the compressed schedule (the overflow is only
    known once the streams have been exchanged) AND the lossless
    re-execute on top."""
    p = min(max(float(p_degraded), 0.0), 1.0)
    return float(t_compressed) + p * float(t_fallback)
