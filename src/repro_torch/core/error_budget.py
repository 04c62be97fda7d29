"""Accuracy-aware error-budget allocation (paper §3.3.3).

A copy of ``repro.core.error_budget`` (same names, same results), kept in
the port so that ``repro_torch`` imports nothing of the JAX package.

Every lossy hop in a compression-enabled collective re-quantizes data, so
per-hop bounds stack.  Getting the worst case right requires tracking how
*accumulated* error merges, not just counting compression events:

  * ReDoub allreduce: each of the log2(N) rounds computes
        acc' = acc + D(C(partner_acc)),
    so e_{k+1} = 2*e_k + eb_stage  (the partner's accumulated error merges
    in as well) => worst case e = (2**log2(N) - 1)*eb_stage = (N-1)*eb_stage.
    Equivalently: a rank's final value embeds one fresh quantization per
    merge event in its merge tree, and a tree over N leaves has N-1
    internal nodes.  That count is INVARIANT under the non-power-of-two
    remainder stage (the fold pre-hops are merge events like any other:
    r fold merges + 2**floor(log2 N) - 1 doubling merges = N - 1), so the
    only extra charge on a remainder axis is the unfold post-hop — one
    more quantization on the folded pairs => N*eb_stage worst case.
  * Ring allreduce: the reduce-scatter running chunk sum absorbs one fresh
    quantization error per hop, (N-1) hops, plus one more lossy hop in the
    allgather stage => N*eb_stage.
  * Ring allgather / binomial scatter / binomial bcast: data-movement
    collectives compress exactly once at the endpoints => 1 hop.

So in the WORST case both computation algorithms stack linearly in N —
the paper's "log N vs N-1" compares compression *events per rank* (which
is what costs time and compressor utilization), not the adversarial error
bound.  Statistically the story is the one the paper tells: the final
value embeds ~N zero-mean independent quantization errors under either
algorithm (a merge tree has N-1 internal nodes), so errors random-walk as
sqrt(N)*eb_stage, and ReDoub's fewer sequential requantizations of any
single element path give it the better constant (validated empirically in
tests/test_error_budget.py and the image-stacking example).

``allocate(worst_case=True)`` divides by the hard-bound hop count;
``worst_case=False`` divides by sqrt(hops) — the paper's statistical
argument, which is the practical choice for gradient sync.
"""
from __future__ import annotations

import math

from repro_torch.core import schedule

__all__ = ["lossy_hops", "allocate", "split_lossy"]


def lossy_hops(algo: str, n: int) -> int:
    """Worst-case multiplier: end-to-end error <= lossy_hops * eb_stage.

    Counted from the RESOLVED schedule table (``schedule.build``) by the
    abstract error replay in ``schedule.lossy_hop_count`` — the per-algo
    closed forms this function used to hard-code (redoub's ``n-1``
    merge-tree bound plus the non-pow2 unfold, ring's ``n``, intring's
    shared-grid ``n``, the movement ops' single endpoint hop; see the
    module docstring for the derivations) now fall out of the same route
    table the execute layer walks, so the ≤-eb property holds by
    construction for any future algorithm instead of by string dispatch.
    Still raises ValueError
    for unknown algo keys.
    """
    return schedule.lossy_hops_for(algo, int(n))


def compression_events(algo: str, n: int) -> int:
    """Sequential compression invocations per rank (the paper's log-N vs
    N-1 *performance* metric — what drives compressor utilization cost)."""
    if algo == "allreduce_redoub":
        # ceil(log2 n) also under the remainder stage: the busiest rank
        # (a fold destination) compresses floor(log2 n) doubling rounds
        # plus the unfold send; it *receives* in the fold pre-hop.
        return max(int(math.ceil(math.log2(max(n, 2)))), 1)
    if algo == "allreduce_ring":
        return max(n - 1, 1) + 1
    if algo == "reduce_scatter_ring":
        return max(n - 1, 1)
    if algo == "allreduce_intring":
        return 1  # quantize once; ring repacks are lossless
    if algo in ("allgather_ring", "scatter_binomial", "broadcast_binomial"):
        return 1
    raise ValueError(f"unknown algo {algo!r}")


def allocate(eb_total: float, algo: str, n: int, *, worst_case: bool = True) -> float:
    """Per-stage eb such that the end-to-end error stays within eb_total."""
    hops = lossy_hops(algo, n)
    if worst_case:
        return eb_total / hops
    return eb_total / math.sqrt(hops)


def split_lossy(eb_total: float, lossy_flags) -> tuple:
    """Split an end-to-end budget across composed stages, charging ONLY
    the lossy ones (two-level collectives: the uncompressed intra-node
    reduce-scatter/allgather stages contribute exact f32 arithmetic, so
    they get 0.0 and the inter-node compressed stage keeps the whole
    budget undiluted — splitting evenly across all stages would shrink
    eb by the stage count for no accuracy gain).

    Returns one eb per stage, in order.  Multiple lossy stages share
    ``eb_total`` evenly (each stage's own ``allocate`` then divides its
    share by its hop count).
    """
    flags = tuple(bool(f) for f in lossy_flags)
    n_lossy = sum(flags)
    if n_lossy == 0:
        return tuple(0.0 for _ in flags)
    share = eb_total / n_lossy
    return tuple(share if f else 0.0 for f in flags)
