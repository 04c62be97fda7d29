"""gZCCL compressed allreduce, rank-centric, over a rank transport.

The counterpart of the allreduce half of ``repro.core.collectives``: the
same schedules, hop for hop and piece for piece, so every rank's result
is bitwise the JAX package's.  What changed:

  * ``lax.ppermute``/``lax.psum``/``lax.axis_index`` become the rank
    handle of ``core/transport.py`` (``g.exchange``, ``g.flags_across``,
    ``g.rank``); every exchange's perm still comes from the route table
    (``core/schedule.py``);
  * ``lax.fori_loop`` becomes a Python loop, and the pipelined ring's
    stacked pending ``Compressed`` a list;
  * the rank is a Python int, so the redoub remainder masks are Python
    booleans: the idle ranks still run every exchange and doubling kernel,
    as the SPMD reference does, and only the ranks that keep the unfold
    payload decompress it;
  * ``acc`` is a private padded copy updated in place.

Only the allreduce execute layer is here.  Outside this slice, and
raising ``NotImplementedError`` that names the ROADMAP item:
``algo="intring"`` (A9), ``fused=False`` (B2), ``on_overflow`` other than
``"flag"`` and ``verify_streams=True`` (A8).  The data-movement ops are A5.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import codecs, cost_model, error_budget, schedule
from repro_torch.core.compressed import validate_capacity_factor
from repro_torch.kernels import ops

__all__ = ["GZConfig", "PIECE_QUANTUM", "plan_ring_pipeline_chunks"]


@dataclasses.dataclass(frozen=True)
class GZConfig:
    """Knobs for the compressed-collective layer (``repro.core.collectives.
    GZConfig``: same fields, defaults and validation).

    ``eb`` is the end-to-end absolute error bound; per-stage budgets come
    from ``core.error_budget``.  ``pipeline_chunks`` (a power of two)
    splits every ring chunk into that many whole-tile pieces; ``fused_hop``
    runs every intermediate reduce hop as one ``unpack_reduce_repack``.
    """

    eb: float = 1e-4
    capacity_factor: float = 0.6
    algo: str = "auto"  # auto | redoub | ring | intring
    worst_case_budget: bool = True
    pipeline_chunks: int = 1
    fused: bool = True
    fused_hop: bool = True
    on_overflow: str = "flag"  # flag | fallback | raise
    verify_streams: bool = False
    codec: str = "lorenzo"

    def __post_init__(self):
        if self.pipeline_chunks < 1 or not _is_pow2(self.pipeline_chunks):
            raise ValueError(
                "GZConfig.pipeline_chunks must be a power of two >= 1 "
                "(the chunked double-buffered schedules split ring chunks "
                f"in half repeatedly); got {self.pipeline_chunks!r}"
            )
        validate_capacity_factor(
            self.capacity_factor, knob="GZConfig.capacity_factor"
        )
        if self.on_overflow not in ("flag", "fallback", "raise"):
            raise ValueError(
                "GZConfig.on_overflow must be one of 'flag' (report only), "
                "'fallback' (lossless re-execute) or 'raise'; got "
                f"{self.on_overflow!r}"
            )
        codecs.validate_codec(self.codec, knob="GZConfig.codec")

    def compressor(self):
        """The wire compressor this config's codec entry resolves to."""
        return codecs.build_compressor(
            self.codec, capacity_factor=self.capacity_factor, fused=self.fused
        )


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _require_slice(cfg: GZConfig) -> None:
    """Raise for the knobs this port does not execute yet."""
    if cfg.algo == "intring":
        raise NotImplementedError("algo='intring' is not ported yet (ROADMAP A9)")
    if not cfg.fused or not cfg.fused_hop:
        raise NotImplementedError(
            "fused=False / fused_hop=False (the two-pass composition) is not "
            "ported yet (ROADMAP B2)")
    if cfg.on_overflow != "flag":
        raise NotImplementedError(
            f"on_overflow={cfg.on_overflow!r} is not ported yet (ROADMAP A8)")
    if cfg.verify_streams:
        raise NotImplementedError("verify_streams=True is not ported yet (ROADMAP A8)")


def _exchange(g, c, perm):
    """One compressed exchange: ``c`` travels along ``perm``."""
    return c.with_tensors(g.exchange(c.tensors(), perm))


def _false(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.bool, device=device)


# ---------------------------------------------------------------------------
# Recursive doubling
# ---------------------------------------------------------------------------


def _allreduce_redoub(x, g, cfg: GZConfig):
    """Recursive-doubling gZ-Allreduce with the fused hop.

    Non-power-of-two axes fold each surplus even rank ``2i < 2*rem`` into
    ``2i + 1`` in a compressed pre-hop, run the doubling over the
    power-of-two participants (idle ranks ride along and receive zero
    streams), and unfold the result in a compressed post-hop whose payload
    the last doubling step's fused kernel emits directly.  Overflow flags
    are masked to streams that actually travel.
    """
    n = g.size
    comp = cfg.compressor()
    eb_stage = error_budget.allocate(
        cfg.eb, "allreduce_redoub", n, worst_case=cfg.worst_case_budget
    )
    p, rem, _phys = schedule.redoub_layout(n)
    steps = p.bit_length() - 1
    r = g.rank
    in_pair = r < 2 * rem
    is_fold_src = in_pair and r % 2 == 0
    is_fold_dst = in_pair and r % 2 == 1
    is_participant = not is_fold_src
    sched = schedule.build("allreduce", "redoub", n)
    base = 1 if rem else 0
    step_perms = [sched.perm(base + k) for k in range(steps)]
    acc = x
    overflow = _false(x.device)

    c = comp.compress(acc, eb_stage)
    if is_fold_src or not rem:
        overflow = overflow | c.overflowed()
    if rem:
        c_recv = _exchange(g, c, sched.perm(0))
        c, acc = comp.decompress_reduce_compress(
            c_recv, acc, eb_stage, return_updated=True)
        if is_participant:
            overflow = overflow | c.overflowed()
    for k in range(steps):
        c_recv = _exchange(g, c, step_perms[k])
        if k < steps - 1:
            c, acc = comp.decompress_reduce_compress(
                c_recv, acc, eb_stage, return_updated=True)
            if is_participant:
                overflow = overflow | c.overflowed()
        elif rem:
            c, acc = comp.decompress_reduce_compress(
                c_recv, acc, eb_stage, return_updated=True)
            if is_fold_dst:
                overflow = overflow | c.overflowed()
        else:
            acc = comp.decompress_reduce(c_recv, acc)
    if rem:
        c_back = _exchange(g, c, sched.perm(base + steps))
        if is_fold_src:
            acc = comp.decompress(c_back)
    return acc, overflow


# ---------------------------------------------------------------------------
# Ring
# ---------------------------------------------------------------------------


def _chunk(x, idx, chunk_n):
    return x[idx * chunk_n:(idx + 1) * chunk_n]


def _set_chunk(x, val, idx, chunk_n):
    x[idx * chunk_n:(idx + 1) * chunk_n] = val
    return x


def _pad_to_chunks(x, n):
    total = -(-x.shape[0] // n) * n
    padded = torch.zeros(total, dtype=x.dtype, device=x.device)
    padded[: x.shape[0]] = x
    return padded, total // n


def _reduce_scatter_ring(x, g, cfg: GZConfig, eb_stage):
    """Ring reduce-scatter with the fused hop: each intermediate hop turns
    the received stream + the local chunk into the next outgoing stream
    in one kernel; the last hop emits the f32 sum.  Returns (acc, chunk_n,
    overflow); rank r's reduced chunk is at index (r + 1) % N.
    """
    n = g.size
    comp = cfg.compressor()
    r = g.rank
    acc, chunk_n = _pad_to_chunks(x, n)
    perm = schedule.ring_perm(n)

    c = comp.compress(_chunk(acc, r, chunk_n), eb_stage)
    overflow = c.overflowed()
    for s in range(n - 2):
        c_recv = _exchange(g, c, perm)
        recv_idx = (r - s - 1) % n
        c, _ = comp.decompress_reduce_compress(
            c_recv, _chunk(acc, recv_idx, chunk_n), eb_stage)
        overflow = overflow | c.overflowed()
    c_recv = _exchange(g, c, perm)
    recv_idx = (r - (n - 2) - 1) % n
    updated = comp.decompress_reduce(c_recv, _chunk(acc, recv_idx, chunk_n))
    return _set_chunk(acc, updated, recv_idx, chunk_n), chunk_n, overflow


# Elements per compressor row-tile: pipelined pieces are whole row-tiles, so
# the quantization grid matches the sequential schedule.
PIECE_QUANTUM = ops.BLOCK * ops.TILE_ROWS


def _piece(x, chunk_idx, piece_idx, chunk_n, piece_n):
    start = chunk_idx * chunk_n + piece_idx * piece_n
    return x[start:start + piece_n]


def _set_piece(x, val, chunk_idx, piece_idx, chunk_n, piece_n):
    start = chunk_idx * chunk_n + piece_idx * piece_n
    x[start:start + piece_n] = val
    return x


def _pad_for_pipeline(x, n, p):
    """Pad flat x so each of n chunks is p pieces of whole row-tiles."""
    quantum = n * p * PIECE_QUANTUM
    total = -(-x.shape[0] // quantum) * quantum
    padded = torch.zeros(total, dtype=x.dtype, device=x.device)
    padded[: x.shape[0]] = x
    return padded, total // n, total // (n * p)


def plan_ring_pipeline_chunks(n_elems: int, n_ranks: int, *, ratio: float = 20.0,
                              hw=None, fused_hop: bool = True) -> int:
    """Cost-model pipeline depth for a ring over ``n_elems`` f32 elements,
    capped at what the payload can fill with whole-tile pieces.  ``hw``
    defaults to the port's planning point, ``cost_model.A100_SLINGSHOT``."""
    chunks = cost_model.best_pipeline_chunks(
        n_elems * 4, n_ranks, ratio,
        hw if hw is not None else cost_model.A100_SLINGSHOT, fused_hop=fused_hop,
    )
    fill = n_elems // (n_ranks * PIECE_QUANTUM)
    while chunks > 1 and chunks > fill:
        chunks //= 2
    return chunks


def _reduce_scatter_ring_pipelined(x, g, cfg: GZConfig, eb_stage):
    """Chunked double-buffered ring reduce-scatter with the fused hop.

    Same hops as :func:`_reduce_scatter_ring`, per piece: the pending
    streams (one per piece) are a list; each iteration ships the next
    piece's stream, produced P-1 hops earlier, then runs this hop's fused
    kernel.  The last step's P hops drain to the f32 accumulator.
    """
    n = g.size
    p_chunks = cfg.pipeline_chunks
    if p_chunks < 2:
        raise ValueError("pipelined schedule needs >= 2 pieces per chunk")
    comp = cfg.compressor()
    r = g.rank
    acc, chunk_n, piece_n = _pad_for_pipeline(x, n, p_chunks)
    perm = schedule.ring_perm(n)
    T = (n - 1) * p_chunks

    overflow = _false(x.device)
    pend = []
    for p in range(p_chunks):
        c = comp.compress(_piece(acc, r, p, chunk_n, piece_n), eb_stage)
        overflow = overflow | c.overflowed()
        pend.append(c)
    c_fly = _exchange(g, pend[0], perm)

    for u in range(T - p_chunks):
        c_fly_next = _exchange(g, pend[(u + 1) % p_chunks], perm)
        s, p = u // p_chunks, u % p_chunks
        recv_idx = (r - s - 1) % n
        c_next, _ = comp.decompress_reduce_compress(
            c_fly, _piece(acc, recv_idx, p, chunk_n, piece_n), eb_stage)
        pend[p] = c_next
        overflow = overflow | c_next.overflowed()
        c_fly = c_fly_next

    recv_last = (r - (n - 2) - 1) % n
    for p in range(p_chunks):
        if p + 1 < p_chunks:
            c_fly_next = _exchange(g, pend[p + 1], perm)
        updated = comp.decompress_reduce(
            c_fly, _piece(acc, recv_last, p, chunk_n, piece_n))
        acc = _set_piece(acc, updated, recv_last, p, chunk_n, piece_n)
        if p + 1 < p_chunks:
            c_fly = c_fly_next
    return acc, chunk_n, overflow


def _compress_own_pieces(buf, own_idx, eb, cfg: GZConfig, chunk_n, piece_n,
                         overflow):
    """Compress chunk ``own_idx`` of ``buf`` as P pieces, installing the
    decompressed copy in place (the owner sees what everyone else will)."""
    comp = cfg.compressor()
    pieces = []
    for p in range(cfg.pipeline_chunks):
        c = comp.compress(_piece(buf, own_idx, p, chunk_n, piece_n), eb)
        overflow = overflow | c.overflowed()
        buf = _set_piece(buf, comp.decompress(c), own_idx, p, chunk_n, piece_n)
        pieces.append(c)
    return buf, tuple(pieces), overflow


def _forward_pieces_ring(buf, pieces, g, cfg: GZConfig, recv_idx_fn,
                         chunk_n, piece_n):
    """Forward P compressed pieces around the ring for n-1 steps,
    installing decompressed copies at chunk ``recv_idx_fn(s)``."""
    n = g.size
    comp = cfg.compressor()
    perm = schedule.ring_perm(n)
    for s in range(n - 1):
        recv_idx = recv_idx_fn(s)
        new_pieces = []
        for p, c_p in enumerate(pieces):
            c_new = _exchange(g, c_p, perm)
            buf = _set_piece(buf, comp.decompress(c_new), recv_idx, p, chunk_n,
                             piece_n)
            new_pieces.append(c_new)
        pieces = tuple(new_pieces)
    return buf


def _allgather_forward_pipelined(acc, g, cfg: GZConfig, eb_stage, chunk_n,
                                 piece_n, overflow):
    """Pipelined ring-allgather forwarding stage over an RS-reduced acc."""
    n, r = g.size, g.rank
    acc, pieces, overflow = _compress_own_pieces(
        acc, (r + 1) % n, eb_stage, cfg, chunk_n, piece_n, overflow)
    acc = _forward_pieces_ring(acc, pieces, g, cfg, lambda s: (r - s) % n,
                               chunk_n, piece_n)
    return acc, overflow


def _allreduce_ring(x, g, cfg: GZConfig):
    """Ring gZ-Allreduce: reduce-scatter, then the allgather stage that
    compresses each reduced chunk once (owner) and forwards it N-1 times."""
    n, r = g.size, g.rank
    comp = cfg.compressor()
    hops = error_budget.lossy_hops("allreduce_ring", n)
    eb_stage = cfg.eb / hops if cfg.worst_case_budget else cfg.eb / math.sqrt(hops)

    if cfg.pipeline_chunks > 1:
        acc, chunk_n, overflow = _reduce_scatter_ring_pipelined(
            x, g, cfg, eb_stage)
        acc, overflow = _allgather_forward_pipelined(
            acc, g, cfg, eb_stage, chunk_n, chunk_n // cfg.pipeline_chunks,
            overflow)
        return acc[: x.shape[0]], overflow

    acc, chunk_n, overflow = _reduce_scatter_ring(x, g, cfg, eb_stage)
    own_idx = (r + 1) % n
    c_cur = comp.compress(_chunk(acc, own_idx, chunk_n), eb_stage)
    overflow = overflow | c_cur.overflowed()
    acc = _set_chunk(acc, comp.decompress(c_cur), own_idx, chunk_n)
    perm = schedule.ring_perm(n)
    for s in range(n - 1):
        c_cur = _exchange(g, c_cur, perm)
        acc = _set_chunk(acc, comp.decompress(c_cur), (r - s) % n, chunk_n)
    return acc[: x.shape[0]], overflow


def _execute_allreduce(x, g, cfg: GZConfig):
    """EXECUTE layer: run a fully-resolved allreduce schedule on rank
    handle ``g``.  Returns ``(out, local_overflow)``; the caller owns the
    cross-rank OR."""
    _require_slice(cfg)
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1).to(torch.float32)
    if cfg.algo == "redoub":
        out, ovf = _allreduce_redoub(flat, g, cfg)
    elif cfg.algo == "ring":
        out, ovf = _allreduce_ring(flat, g, cfg)
    else:
        raise ValueError(
            f"unresolved allreduce algo {cfg.algo!r} reached the execute "
            "layer — resolve a Plan via GZCommunicator.plan first"
        )
    return out.reshape(shape).to(dtype), ovf
