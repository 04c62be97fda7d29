"""gZCCL compressed collectives, rank-centric, over a rank transport.

The counterpart of ``repro.core.collectives``: the allreduce (recursive
doubling, sequential and pipelined ring, with the single-pass or the
two-kernel hop) and the data movers (ring reduce-scatter and allgather,
the trimmed-slab binomial scatter and broadcast, the direct all-to-all),
with the same schedules, hop for hop and piece for piece, so every
rank's result is bitwise the JAX package's.  What changed:

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
  * ``acc`` is a private padded copy updated in place;
  * the scatter's non-root ranks skip compressing their local payload
    (the reference compresses it SPMD and masks its overflow flag away:
    only the root's streams travel), and tree installs copy the received
    slab into the receiver's own held buffers;
  * ``lax.all_to_all`` becomes the transport's ``all_to_all``.

Every codec of ``core/codecs.py`` runs on every schedule: the scatter
and the all-to-all batch the ``lorenzo`` chunks into one ``quantize`` and
send the other codecs' chunks through their compressor one by one, as
the reference does.

The degradation layer (the reference's ``collectives.py:213-380``):
every compressed exchange is ``_exchange``, the counterpart of
``_ppermute_guarded``, with the reference's schedule-table round index;
it applies the wire-fault hook (``core/faults.py``) to what it received
and, under ``verify_streams``, ships the XOR checksum of what was sent as
an exchange of its own on the same perm and compares it with the
checksum of what arrived.  A mismatch is OR-ed into the overflow flag
where the reference ORs it.  The all-to-all stays unguarded, as in the
reference.  ``_execute_lossless`` is the uncompressed re-run of each op
over the same transport (the communicator's ``fallback`` policy, in
``core/comm.py``).

The integer ring (``algo="intring"``) quantizes once with the two-pass
``quantize`` kernel and ring-reduces the Lorenzo delta codes in int32
(``bitpack`` packs, unpacks and the final prefix sum stay torch ops, as
they are jnp outside any Pallas kernel in the reference).  The two-level
allreduce (``_execute_allreduce_hier``) runs on three handles of a mesh
(``core/transport.py``): node, local and their node-major composite.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import (
    bitpack, codecs, cost_model, error_budget, faults, schedule, transport,
)
from repro_torch.core.compressed import (
    Compressed, capacity_words_for, validate_capacity_factor,
)
from repro_torch.kernels import ops, ref

__all__ = ["GZConfig", "PIECE_QUANTUM", "plan_ring_pipeline_chunks"]


@dataclasses.dataclass(frozen=True)
class GZConfig:
    """Knobs for the compressed-collective layer (``repro.core.collectives.
    GZConfig``: same fields, defaults and validation).

    ``eb`` is the end-to-end absolute error bound; per-stage budgets come
    from ``core.error_budget``.  ``pipeline_chunks`` (a power of two)
    splits every ring chunk into that many whole-tile pieces (and every
    full scatter slab into that many piece exchanges); ``fused`` picks the
    single-pass codec kernels over the two-pass ``quantize``/``bitpack``
    composition; ``fused_hop`` runs every intermediate reduce hop as one
    ``unpack_reduce_repack`` instead of ``decompress_reduce`` then
    ``compress``.  Results are bitwise the same under all four settings.
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


def _false(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.bool, device=device)


def _or(flag, bad):
    """``flag | bad``, where ``bad`` is None for an unguarded exchange (no
    extra launch on the flag-mode path)."""
    return flag if bad is None else flag | bad


def _tree_checksum(tensors) -> torch.Tensor:
    """XOR of every 32-bit word of every wire tensor (packed, bitwidth,
    anchor, nwords as int32, eb's f32 bits), as an int32 0-d tensor: the
    bits of the reference's ``_tree_checksum`` of the same container.
    torch has no XOR reduction, so the words are laid end to end, padded
    with zeros to a power of two, and folded in halves."""
    words = [t.reshape(-1).view(torch.int32) for t in tensors]
    n = sum(w.numel() for w in words)
    size = 1 << max(n - 1, 0).bit_length()
    flat = torch.cat(words + [torch.zeros(size - n, dtype=torch.int32,
                                          device=words[0].device)])
    while flat.numel() > 1:
        half = flat.numel() // 2
        flat = torch.bitwise_xor(flat[:half], flat[half:])
    return flat[0]


def _exchange_tensors(g, tensors, perm, guard=False, round_idx=None):
    """One exchange of wire tensors along ``perm`` (the reference's
    ``_ppermute_guarded``).  The wire-fault hook applies to what was
    received.  With ``guard`` the sender's checksum travels on the same
    perm as an exchange of its own and is compared with the checksum of
    what arrived; a rank no pair addresses receives zero streams and a
    zero checksum, so it cannot raise a false alarm.  Returns ``(recv,
    bad)``, ``bad`` None when unguarded."""
    recv = faults.maybe_corrupt_wire(g.exchange(tensors, perm), g, round_idx)
    if not guard:
        return recv, None
    (chk_sent,) = g.exchange((_tree_checksum(tensors),), perm)
    return recv, chk_sent != _tree_checksum(recv)


def _exchange(g, c, perm, guard=False, round_idx=None):
    """One compressed exchange: ``c`` travels along ``perm``.  Returns
    ``(received container, bad)`` (``_exchange_tensors``)."""
    recv, bad = _exchange_tensors(g, c.tensors(), perm, guard, round_idx)
    return c.with_tensors(recv), bad


# ---------------------------------------------------------------------------
# Lossless fallback schedules
# ---------------------------------------------------------------------------
#
# Every op has an uncompressed twin over the same transport.  NaN/Inf
# become 0 first (identity on finite data), so an overflow-only fallback
# is the exact lossless result and a poisoned input gives the lossless
# result of the sanitized input.  The sums fold in rank order, as
# ``sum_across`` does (the reference's CPU ``psum`` bits); the scatter and
# broadcast walk the same tree tables with raw f32 payloads, which the
# wire-fault hook never touches.


def _nonfinite_local(x) -> torch.Tensor:
    """This rank's NaN/Inf presence (False for non-float payloads)."""
    if not x.dtype.is_floating_point:
        return _false(x.device)
    return ~torch.isfinite(x).all()


def _sanitize(x):
    """NaN/Inf replaced by 0 (identity on finite data)."""
    if not x.dtype.is_floating_point:
        return x
    return torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


def _lossless_scatter(x_full, g, cfg: GZConfig):
    """The trimmed-slab tree with raw f32 held slabs: rank r ends with the
    root's sanitized chunk r.  Non-root ranks start from zeros, which the
    installs overwrite before anything reads them."""
    n, r = g.size, g.rank
    chunk_n = x_full.shape[0] // n
    n_virt = 1 << cost_model.steps_for("binomial", n)
    held = torch.zeros((n_virt, chunk_n), dtype=torch.float32, device=x_full.device)
    if r == 0:
        held[:n] = _sanitize(x_full.to(torch.float32)).view(n, chunk_n)
    (held,), _ = _scatter_tree_trimmed((held,), g, n, n_virt, cfg)
    return held[r].to(x_full.dtype)


def _lossless_broadcast(x, g):
    """The binomial tree's forwarding pairs (``schedule.tree_plan``) with
    the raw f32 payload."""
    r = g.rank
    buf = _sanitize(x.reshape(-1).to(torch.float32))
    for span, _full, _trim, perm in schedule.tree_plan(g.size):
        (recv,) = g.exchange((buf,), perm)
        if r % (span * 2) == span:
            buf = recv
    return buf.reshape(x.shape).to(x.dtype)


def _fold_scatter(x, g):
    """Exact reduce-scatter of flat ``x``: rank r folds every rank's chunk
    r in rank order (the bits of the reference's CPU ``psum_scatter``)."""
    (parts,) = g.all_to_all((x.view(g.size, -1),))
    return transport._fold(parts)


def _execute_lossless(op, x, g, cfg: GZConfig, *, root: int = 0):
    """Uncompressed re-run of ``op`` on rank handle ``g`` (exact)."""
    n = g.size
    if op == "allreduce":
        return g.sum_across(_sanitize(x.to(torch.float32))).to(x.dtype)
    if op == "reduce_scatter":
        return _fold_scatter(_sanitize(x.to(torch.float32)), g).to(x.dtype)
    if op == "allgather":
        (parts,) = g.all_gather((_sanitize(x),))
        return parts.reshape((n * x.shape[0],) + tuple(x.shape[1:])) if x.dim() \
            else parts
    if op == "scatter":
        return _lossless_scatter(x, g, cfg)
    if op == "broadcast":
        return _lossless_broadcast(x, g)
    if op == "all_to_all":
        (parts,) = g.all_to_all((_sanitize(x).reshape((n, -1)),))
        return parts.reshape(x.shape)
    raise ValueError(f"no lossless fallback for op {op!r}")


# ---------------------------------------------------------------------------
# Recursive doubling
# ---------------------------------------------------------------------------


def _allreduce_redoub(x, g, cfg: GZConfig):
    """Recursive-doubling gZ-Allreduce.

    Non-power-of-two axes fold each surplus even rank ``2i < 2*rem`` into
    ``2i + 1`` in a compressed pre-hop, run the doubling over the
    power-of-two participants (idle ranks ride along and receive zero
    streams), and unfold the result in a compressed post-hop.  With the
    fused hop the last doubling step's kernel emits the unfold payload
    directly; ``fused_hop=False`` compresses before every exchange and
    reduces after it.  Overflow flags are masked to streams that actually
    travel; a failed stream check counts on the rank that received it.
    Round indices: 0 the fold, ``base + k`` doubling step k, ``base +
    steps`` the unfold.
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
    guard = cfg.verify_streams

    if not cfg.fused_hop:
        if rem:
            c = comp.compress(acc, eb_stage)
            if is_fold_src:
                overflow = overflow | c.overflowed()
            c_recv, bad = _exchange(g, c, sched.perm(0), guard, 0)
            overflow = _or(overflow, bad)
            acc = comp.decompress_reduce(c_recv, acc)
        for k in range(steps):
            c = comp.compress(acc, eb_stage)
            if is_participant:
                overflow = overflow | c.overflowed()
            c_recv, bad = _exchange(g, c, step_perms[k], guard, base + k)
            overflow = _or(overflow, bad)
            acc = comp.decompress_reduce(c_recv, acc)
        if rem:
            c = comp.compress(acc, eb_stage)
            if is_fold_dst:
                overflow = overflow | c.overflowed()
            c_back, bad = _exchange(g, c, sched.perm(base + steps), guard, base + steps)
            overflow = _or(overflow, bad)
            if is_fold_src:
                acc = comp.decompress(c_back)
        return acc, overflow

    c = comp.compress(acc, eb_stage)
    if is_fold_src or not rem:
        overflow = overflow | c.overflowed()
    if rem:
        c_recv, bad = _exchange(g, c, sched.perm(0), guard, 0)
        overflow = _or(overflow, bad)
        c, acc = comp.decompress_reduce_compress(
            c_recv, acc, eb_stage, return_updated=True)
        if is_participant:
            overflow = overflow | c.overflowed()
    for k in range(steps):
        c_recv, bad = _exchange(g, c, step_perms[k], guard, base + k)
        overflow = _or(overflow, bad)
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
        c_back, bad = _exchange(g, c, sched.perm(base + steps), guard, base + steps)
        overflow = _or(overflow, bad)
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


def _reduce_scatter_ring(x, g, cfg: GZConfig, eb_stage, *, owner_offset=0):
    """Ring reduce-scatter.  With the fused hop each intermediate hop
    turns the received stream + the local chunk into the next outgoing
    stream in one kernel and the last hop emits the f32 sum;
    ``fused_hop=False`` compresses the send chunk, exchanges, and reduces
    into the receive chunk every step.  Returns (acc, chunk_n, overflow);
    rank r's reduced chunk is at index (r + 1 + owner_offset) % N.  Step
    s is round s.
    """
    n = g.size
    comp = cfg.compressor()
    r = g.rank
    t = owner_offset
    acc, chunk_n = _pad_to_chunks(x, n)
    perm = schedule.ring_perm(n)
    guard = cfg.verify_streams

    if not cfg.fused_hop:
        overflow = _false(x.device)
        for s in range(n - 1):
            c = comp.compress(_chunk(acc, (r - s + t) % n, chunk_n), eb_stage)
            overflow = overflow | c.overflowed()
            recv_idx = (r - s - 1 + t) % n
            c_recv, bad = _exchange(g, c, perm, guard, s)
            overflow = _or(overflow, bad)
            updated = comp.decompress_reduce(c_recv, _chunk(acc, recv_idx, chunk_n))
            _set_chunk(acc, updated, recv_idx, chunk_n)
        return acc, chunk_n, overflow

    c = comp.compress(_chunk(acc, (r + t) % n, chunk_n), eb_stage)
    overflow = c.overflowed()
    for s in range(n - 2):
        c_recv, bad = _exchange(g, c, perm, guard, s)
        recv_idx = (r - s - 1 + t) % n
        c, _ = comp.decompress_reduce_compress(
            c_recv, _chunk(acc, recv_idx, chunk_n), eb_stage)
        overflow = _or(overflow, bad) | c.overflowed()
    c_recv, bad = _exchange(g, c, perm, guard, n - 2)
    overflow = _or(overflow, bad)
    recv_idx = (r - (n - 2) - 1 + t) % n
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


def _reduce_scatter_ring_pipelined(x, g, cfg: GZConfig, eb_stage, *,
                                   owner_offset=0):
    """Chunked double-buffered ring reduce-scatter.

    Same hops as :func:`_reduce_scatter_ring`, per piece, with the same
    ownership convention.  With the fused hop the pending streams (one
    per piece) are a list; each iteration ships the next piece's stream,
    produced P-1 hops earlier, then runs this hop's fused kernel, and the
    last step's P hops drain to the f32 accumulator.  ``fused_hop=False``
    compresses piece t+1 from the pre-update accumulator, ships piece t
    and reduces it, one piece per iteration.  A piece shipped for step s
    is round s.
    """
    n = g.size
    p_chunks = cfg.pipeline_chunks
    if p_chunks < 2:
        raise ValueError("pipelined schedule needs >= 2 pieces per chunk")
    comp = cfg.compressor()
    r = g.rank
    t0 = owner_offset
    acc, chunk_n, piece_n = _pad_for_pipeline(x, n, p_chunks)
    perm = schedule.ring_perm(n)
    T = (n - 1) * p_chunks
    guard = cfg.verify_streams

    if not cfg.fused_hop:
        def send_piece(t):
            s, p = divmod(t, p_chunks)
            return comp.compress(
                _piece(acc, (r - s + t0) % n, p, chunk_n, piece_n), eb_stage)

        c_in = send_piece(0)
        overflow = c_in.overflowed()
        for t in range(T):
            if t + 1 < T:
                c_next = send_piece(t + 1)
                overflow = overflow | c_next.overflowed()
            s, p = divmod(t, p_chunks)
            recv_idx = (r - s - 1 + t0) % n
            c_recv, bad = _exchange(g, c_in, perm, guard, s)
            overflow = _or(overflow, bad)
            updated = comp.decompress_reduce(
                c_recv, _piece(acc, recv_idx, p, chunk_n, piece_n))
            _set_piece(acc, updated, recv_idx, p, chunk_n, piece_n)
            if t + 1 < T:
                c_in = c_next
        return acc, chunk_n, overflow

    overflow = _false(x.device)
    pend = []
    for p in range(p_chunks):
        c = comp.compress(_piece(acc, (r + t0) % n, p, chunk_n, piece_n), eb_stage)
        overflow = overflow | c.overflowed()
        pend.append(c)
    c_fly, bad = _exchange(g, pend[0], perm, guard, 0)
    overflow = _or(overflow, bad)

    for u in range(T - p_chunks):
        c_fly_next, bad = _exchange(g, pend[(u + 1) % p_chunks], perm, guard,
                                    (u + 1) // p_chunks)
        overflow = _or(overflow, bad)
        s, p = u // p_chunks, u % p_chunks
        recv_idx = (r - s - 1 + t0) % n
        c_next, _ = comp.decompress_reduce_compress(
            c_fly, _piece(acc, recv_idx, p, chunk_n, piece_n), eb_stage)
        pend[p] = c_next
        overflow = overflow | c_next.overflowed()
        c_fly = c_fly_next

    recv_last = (r - (n - 2) - 1 + t0) % n
    for p in range(p_chunks):
        if p + 1 < p_chunks:
            c_fly_next, bad = _exchange(g, pend[p + 1], perm, guard, n - 2)
            overflow = _or(overflow, bad)
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
                         chunk_n, piece_n, overflow, round_offset=0):
    """Forward P compressed pieces around the ring for n-1 steps,
    installing decompressed copies at chunk ``recv_idx_fn(s)``; step s is
    round ``round_offset + s``.  Returns (buf, overflow)."""
    n = g.size
    comp = cfg.compressor()
    perm = schedule.ring_perm(n)
    for s in range(n - 1):
        recv_idx = recv_idx_fn(s)
        new_pieces = []
        for p, c_p in enumerate(pieces):
            c_new, bad = _exchange(g, c_p, perm, cfg.verify_streams, round_offset + s)
            overflow = _or(overflow, bad)
            buf = _set_piece(buf, comp.decompress(c_new), recv_idx, p, chunk_n,
                             piece_n)
            new_pieces.append(c_new)
        pieces = tuple(new_pieces)
    return buf, overflow


def _allgather_forward_pipelined(acc, g, cfg: GZConfig, eb_stage, chunk_n,
                                 piece_n, overflow):
    """Pipelined ring-allgather forwarding stage over an RS-reduced acc."""
    n, r = g.size, g.rank
    acc, pieces, overflow = _compress_own_pieces(
        acc, (r + 1) % n, eb_stage, cfg, chunk_n, piece_n, overflow)
    # the allgather rounds follow the n-1 reduce-scatter rounds
    return _forward_pieces_ring(acc, pieces, g, cfg, lambda s: (r - s) % n,
                                chunk_n, piece_n, overflow, round_offset=n - 1)


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
        c_cur, bad = _exchange(g, c_cur, perm, cfg.verify_streams, (n - 1) + s)
        overflow = _or(overflow, bad)
        acc = _set_chunk(acc, comp.decompress(c_cur), (r - s) % n, chunk_n)
    return acc[: x.shape[0]], overflow


def _unzigzag_i32(u):
    """int32 zigzag codes (uint32 bits) -> int32 deltas, in int32 with a
    logical shift: ``(u >>> 1) ^ -(u & 1)``."""
    return ((u >> 1) & 0x7FFFFFFF) ^ -(u & 1)


def _allreduce_intring(x, g, cfg: GZConfig):
    """Integer-domain ring allreduce (beyond the paper).

    Quantize once, the only lossy step (one ``quantize`` over every
    chunk, each padded to whole row-tiles), then ring reduce-scatter and
    ring allgather the int32 Lorenzo delta codes with lossless repacking:
    deltas and anchors add exactly (wrapping in int32, as the
    reference's), so every rank gets the same bits on one quantization
    grid, and ``anchor + cumsum(d)`` rebuilds the sum once at the end.
    Each hop packs the chunk's zigzag codes at their per-block widths
    (up to log2(step) bits wider per hop); a stream past ``cap`` words
    sets the overflow flag.  Reduce-scatter step s is round s, allgather
    step s round ``(n - 1) + s``."""
    n, r = g.size, g.rank
    dev = x.device
    eb = ops.as_eb(cfg.eb, dev)
    n_orig = x.shape[0]
    B = ops.BLOCK
    rows = ops.n_blocks_for(-(-n_orig // n))
    chunk_n = rows * B
    xf = torch.zeros(n * chunk_n, dtype=torch.float32, device=dev)
    xf[:n_orig] = x
    zig, _, anchor = ops.quantize(xf.view(-1, B), eb)
    del xf
    d = _unzigzag_i32(zig)
    del zig
    cap = capacity_words_for(chunk_n, cfg.capacity_factor, B)
    perm = schedule.ring_perm(n)
    guard = cfg.verify_streams

    def rows_of(idx):
        return slice(idx * rows, (idx + 1) * rows)

    def pack_codes(idx):
        dd = d[rows_of(idx)]
        z = ref.as_u32((dd << 1) ^ (dd >> 31))
        bw = ref.bitwidth_of(z.amax(dim=1))
        packed, nwords = bitpack.pack(z, bw, cap)
        return (packed, bw, anchor[rows_of(idx)].clone()), nwords

    def unpack_codes(wire):
        packed, bw, _ = wire
        return _unzigzag_i32(bitpack.unpack(packed, bw, B))

    overflow = _false(dev)
    for s in range(n - 1):
        wire, nwords = pack_codes((r - s) % n)
        overflow = overflow | (nwords > cap)
        wire, bad = _exchange_tensors(g, wire, perm, guard, s)
        overflow = _or(overflow, bad)
        at = rows_of((r - s - 1) % n)
        d[at] += unpack_codes(wire)
        anchor[at] += wire[2]
    cur, nwords = pack_codes((r + 1) % n)
    overflow = overflow | (nwords > cap)
    for s in range(n - 1):
        cur, bad = _exchange_tensors(g, cur, perm, guard, (n - 1) + s)
        overflow = _or(overflow, bad)
        at = rows_of((r - s) % n)
        d[at] = unpack_codes(cur)
        anchor[at] = cur[2]
    q = torch.cumsum(d, dim=1, dtype=torch.int32)
    del d
    q += anchor[:, None]
    out = q.to(torch.float32).mul_(ref.twoeb_of(eb)).view(-1)
    return out[:n_orig], overflow


def _execute_allreduce(x, g, cfg: GZConfig):
    """EXECUTE layer: run a fully-resolved allreduce schedule on rank
    handle ``g``.  Returns ``(out, local_overflow)``; the caller owns the
    cross-rank OR."""
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1).to(torch.float32)
    if cfg.algo == "redoub":
        out, ovf = _allreduce_redoub(flat, g, cfg)
    elif cfg.algo == "ring":
        out, ovf = _allreduce_ring(flat, g, cfg)
    elif cfg.algo == "intring":
        out, ovf = _allreduce_intring(flat, g, cfg)
    else:
        raise ValueError(
            f"unresolved allreduce algo {cfg.algo!r} reached the execute "
            "layer — resolve a Plan via GZCommunicator.plan first"
        )
    return out.reshape(shape).to(dtype), ovf


def _execute_allreduce_hier(x, g_node, g_local, g_all, hplan):
    """EXECUTE layer for the two-level (node x local) allreduce on a
    mesh's node, local and composite ``(node, *local)`` handles;
    ``hplan`` is a resolved ``comm.HierPlan``.

    The flat branch is the ordinary allreduce over the composite handle
    (ranks node-major) on ``hplan.flat_plan``.  The hierarchical branch
    is an exact reduce-scatter over local (each local rank ends with one
    node-reduced shard of ceil(D/L) elements), the compressed allreduce
    of that shard over node on ``hplan.inter`` (the only lossy stage),
    and an exact allgather over local; a stage whose axis has one rank
    is skipped.  Returns ``(out, local_overflow)``."""
    if hplan.flat:
        return _execute_allreduce(x, g_all, hplan.flat_plan.as_config())
    n_nodes, L = hplan.topology
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1).to(torch.float32)
    padded, _ = _pad_to_chunks(flat, L)
    shard = _fold_scatter(padded, g_local) if L > 1 else padded
    ovf = _false(x.device)
    if n_nodes > 1:
        shard, ovf = _execute_allreduce(shard, g_node, hplan.inter.as_config())
    if L > 1:
        (parts,) = g_local.all_gather((shard,))
        padded = parts.reshape(-1)
    else:
        padded = shard
    return padded[: flat.shape[0]].reshape(shape).to(dtype), ovf


# ---------------------------------------------------------------------------
# Reduce_scatter / Allgather — the ring stages standalone
# ---------------------------------------------------------------------------


def _execute_reduce_scatter(x, g, cfg: GZConfig):
    """EXECUTE layer for the ring reduce-scatter: rank r returns the summed
    chunk r of the flat payload (``owner_offset=-1``)."""
    n, r = g.size, g.rank
    if x.dim() != 1 or x.shape[0] % n != 0:
        raise ValueError(
            f"reduce_scatter over {n} ranks: the payload must be flat with "
            "length divisible by the axis size (rank r returns summed chunk "
            f"r); got shape {tuple(x.shape)}"
        )
    eb_stage = error_budget.allocate(
        cfg.eb, "reduce_scatter_ring", n, worst_case=cfg.worst_case_budget
    )
    flat = x.to(torch.float32)
    chunk_in = x.shape[0] // n
    if cfg.pipeline_chunks > 1:
        # Chunk boundaries are caller semantics: pad each chunk (not the
        # flat tail) so every chunk is pipeline_chunks whole-tile pieces.
        quantum = cfg.pipeline_chunks * PIECE_QUANTUM
        chunk_pad = -(-chunk_in // quantum) * quantum
        padded = torch.zeros((n, chunk_pad), dtype=torch.float32, device=x.device)
        padded[:, :chunk_in] = flat.view(n, chunk_in)
        acc, chunk_n, ovf = _reduce_scatter_ring_pipelined(
            padded.view(-1), g, cfg, eb_stage, owner_offset=-1)
    else:
        acc, chunk_n, ovf = _reduce_scatter_ring(
            flat, g, cfg, eb_stage, owner_offset=-1)
    return _chunk(acc, r, chunk_n)[:chunk_in].to(x.dtype), ovf


def _execute_allgather(x, g, cfg: GZConfig):
    """EXECUTE layer for the ring allgather: compress the own chunk once,
    forward the compressed stream N-1 times; slot j of the result holds
    decompress(compress(x_j)) on every rank."""
    n, r = g.size, g.rank
    comp = cfg.compressor()
    flat = x.reshape(-1).to(torch.float32)
    n_orig = flat.shape[0]
    dev = x.device

    if cfg.pipeline_chunks > 1:
        quantum = cfg.pipeline_chunks * PIECE_QUANTUM
        chunk_n = -(-n_orig // quantum) * quantum
        piece_n = chunk_n // cfg.pipeline_chunks
        out = torch.zeros(n * chunk_n, dtype=torch.float32, device=dev)
        out[r * chunk_n:r * chunk_n + n_orig] = flat
        out, pieces, ovf = _compress_own_pieces(
            out, r, cfg.eb, cfg, chunk_n, piece_n, _false(dev))
        out, ovf = _forward_pieces_ring(out, pieces, g, cfg,
                                        lambda s: (r - s - 1) % n, chunk_n, piece_n, ovf)
        out = out.view(n, chunk_n)[:, :n_orig].reshape(-1)
    else:
        out = torch.zeros(n * n_orig, dtype=torch.float32, device=dev)
        c_cur = comp.compress(flat, cfg.eb)
        ovf = c_cur.overflowed()
        _set_chunk(out, comp.decompress(c_cur), r, n_orig)
        perm = schedule.ring_perm(n)
        for s in range(n - 1):
            c_cur, bad = _exchange(g, c_cur, perm, cfg.verify_streams, s)
            ovf = _or(ovf, bad)
            _set_chunk(out, comp.decompress(c_cur), (r - s - 1) % n, n_orig)
    if x.dim():
        out = out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
    return out.to(x.dtype), ovf


# ---------------------------------------------------------------------------
# Scatter / Broadcast — the binomial tree (paper §3.3.4)
# ---------------------------------------------------------------------------


def _wire_container(comp, packed, bitwidth, anchor, eb, n) -> Compressed:
    """Rebuild a ``Compressed`` from bare wire parts on the receive side
    (the batched scatter/all-to-all paths ship the parts, not the
    container); the true stream size is recomputed from the metadata."""
    return Compressed(
        packed=packed, bitwidth=bitwidth, anchor=anchor,
        nwords=comp.stream_nwords(bitwidth, n), eb=ops.as_eb(eb, packed.device),
        n=n, block=ops.BLOCK,
    )


def _compress_chunks(chunks, n, chunk_n, cfg: GZConfig):
    """Every chunk of ``chunks`` (n, chunk_n) compressed on its own.  Under
    ``lorenzo``: ONE batched ``quantize`` (what N CUDA streams did in the
    paper) and n ``bitpack.pack`` calls, chunks padded to whole row-tiles
    so chunk boundaries are block boundaries.  Other codecs: one
    ``compress`` per chunk (their pack kernels are not batched across
    chunk boundaries), the same stacked layout.  Returns ``(packed (n,
    cap), bw (n, rows), anchor (n, rows), overflow)``."""
    dev = chunks.device
    ovf = _false(dev)
    if cfg.codec != "lorenzo":
        comp = cfg.compressor()
        cs = []
        for i in range(n):
            cs.append(comp.compress(chunks[i], cfg.eb))
            ovf = ovf | cs[-1].overflowed()
        return (torch.stack([c.packed for c in cs]), torch.stack([c.bitwidth for c in cs]),
                torch.stack([c.anchor for c in cs]), ovf)
    B = ops.BLOCK
    rows = ops.n_blocks_for(chunk_n)
    x2d = torch.zeros((n, rows * B), dtype=torch.float32, device=dev)
    x2d[:, :chunk_n] = chunks
    codes, bw, anchor = ops.quantize(x2d.view(n * rows, B), cfg.eb)
    cap = capacity_words_for(chunk_n, cfg.capacity_factor, B)
    packed = torch.empty((n, cap), dtype=torch.int32, device=dev)
    for i in range(n):
        pk, nw = bitpack.pack(codes[i * rows:(i + 1) * rows],
                              bw[i * rows:(i + 1) * rows], cap)
        packed[i] = pk
        ovf = ovf | (nw > cap)
    return packed, bw.view(n, rows), anchor.view(n, rows), ovf


def _scatter_held_buffers(x_full, n, cfg: GZConfig, *, compress: bool):
    """The tree's held buffers ``(packed, bw, anchor)`` over a virtual
    ``2**ceil(log2 n)``-rank space: slot i holds chunk i's stream, the
    padding slots zero streams (they keep slab indexing uniform and never
    travel under the trimmed schedule).  Only the root compresses
    (``compress``); the other ranks start from zero streams, which every
    install overwrites before anything reads them.  Returns
    ``(held, chunk_n, n_virt, ovf)``."""
    chunk_n = x_full.shape[0] // n
    rows = ops.n_blocks_for(chunk_n)
    n_virt = 1 << cost_model.steps_for("binomial", n)
    cap = codecs.codec_capacity_words(cfg.codec, chunk_n, cfg.capacity_factor)
    dev = x_full.device
    held = (torch.zeros((n_virt, cap), dtype=torch.int32, device=dev),
            torch.zeros((n_virt, rows), dtype=torch.int32, device=dev),
            torch.zeros((n_virt, rows), dtype=torch.int32, device=dev))
    if not compress:
        return held, chunk_n, n_virt, _false(dev)
    chunks = x_full.reshape(n, chunk_n).to(torch.float32)
    *parts, ovf = _compress_chunks(chunks, n, chunk_n, cfg)
    for h, part in zip(held, parts):
        h[:n] = part
    return held, chunk_n, n_virt, ovf


def _slab_exchange(held, g, install_at, perm, start, slab, n_virt, is_recv,
                   guard=False, round_idx=None):
    """Ship a ``slab``-chunk window of the held buffers along ``perm`` and,
    on a receiver, copy it into its own buffers at ``install_at``.  Window
    starts are clamped into the buffer like ``lax.dynamic_slice``'s.
    Returns ``bad`` (``_exchange_tensors``), None on a rank that installs
    nothing."""
    lo = min(start % n_virt, n_virt - slab)
    recv, bad = _exchange_tensors(g, tuple(h[lo:lo + slab] for h in held), perm,
                                  guard, round_idx)
    if not is_recv:
        return None
    at = min(install_at, n_virt - slab)
    for h, rv in zip(held, recv):
        h[at:at + slab] = rv
    return bad


def _scatter_tree_trimmed(held, g, n, n_virt, cfg: GZConfig):
    """Trimmed-slab binomial tree: each round ships only the real ranks of
    the receiver's subtree.  Per round k (``schedule.tree_plan``, perms
    verbatim from the route table): the full-span exchanges, split into
    ``cfg.pipeline_chunks`` piece exchanges, then the at most one
    boundary exchange of ``n - receiver`` chunks as one exchange, all of
    them round k.  The root ships exactly n-1 chunk streams at any axis
    size.  Returns ``(held, corrupt)``: a failed stream check on a
    receiver."""
    r = g.rank
    guard = cfg.verify_streams
    corrupt = _false(held[0].device)
    for k, (span, full_senders, trim, perm) in enumerate(schedule.tree_plan(n)):
        start = r + span  # a sender's outgoing slab: its subtree's right half
        if full_senders:
            perm_full = perm[: len(full_senders)]
            is_recv = r % (span * 2) == span and r + span <= n
            groups = min(max(cfg.pipeline_chunks, 1), span)
            sub = span // groups
            for j in range(groups):
                corrupt = _or(corrupt, _slab_exchange(
                    held, g, r + j * sub, perm_full, start + j * sub, sub, n_virt,
                    is_recv, guard, k))
        if trim is not None:
            _snd, rcv, slab = trim
            corrupt = _or(corrupt, _slab_exchange(
                held, g, r, perm[len(full_senders):], start, slab, n_virt, r == rcv,
                guard, k))
    return held, corrupt


def _scatter_tree_padded_reference(held, g, n, n_virt, cfg: GZConfig):
    """The padded virtual-tree walk, kept as the byte-parity oracle for
    the trimmed schedule (tests only: every real rank must decode the
    same bytes from both walks).  Round k ships a full 2**k-chunk slab,
    padding chunks included, from each sender ``i % 2**(k+1) == 0`` to
    ``i + 2**k``.  Its exchanges carry no round index, as the
    reference's."""
    r = g.rank
    steps = n_virt.bit_length() - 1
    corrupt = _false(held[0].device)
    for k in reversed(range(steps)):
        span = 1 << k
        # schedule-authority: allow — padded-tree byte-parity oracle
        perm = [(i, i + span) for i in range(0, n_virt, span * 2)
                if i + span < n]
        is_recv = r % (span * 2) == span
        groups = min(max(cfg.pipeline_chunks, 1), span)
        sub = span // groups
        for j in range(groups):
            corrupt = _or(corrupt, _slab_exchange(
                held, g, r + j * sub, perm, r + span + j * sub, sub, n_virt, is_recv,
                cfg.verify_streams))
    return held, corrupt


def _execute_scatter(x_full, g, cfg: GZConfig, *, root: int = 0,
                     _padded_reference: bool = False):
    """EXECUTE layer for the binomial-tree scatter from rank 0.

    ``x_full`` (n*chunk,) is significant on the root only.  The root
    compresses each chunk on its own (``_compress_chunks``); the
    streams travel down the trimmed-slab tree and each rank decompresses
    its own chunk once.  Non-root ranks do not compress: their streams
    would never travel and the reference masks their overflow away, so
    the result and the root-masked flag are bitwise the reference's.
    Under ``lorenzo``: one ``quantize`` per call (root) and one decode
    per rank.  A failed stream check is not root-masked: a corrupt stream
    is unusable wherever it lands.
    ``_padded_reference=True`` walks the padded virtual tree instead
    (test oracle; the same bytes at every real rank).
    """
    n, r = g.size, g.rank
    if root != 0:
        raise ValueError(
            f"scatter over {n} ranks: only root 0 is supported (the binomial "
            f"tree is rooted at rank 0); got root={root}.  Roll the payload "
            "so the source rank is 0."
        )
    if x_full.shape[0] % n != 0:
        raise ValueError(
            f"scatter over {n} ranks: the full payload's leading dim must be "
            "divisible by the axis size (each rank receives one chunk); got "
            f"shape {tuple(x_full.shape)}"
        )
    held, chunk_n, n_virt, ovf = _scatter_held_buffers(
        x_full, n, cfg, compress=r == 0)
    tree = (_scatter_tree_padded_reference if _padded_reference
            else _scatter_tree_trimmed)
    (packed, bw, anchor), corrupt = tree(held, g, n, n_virt, cfg)
    comp = cfg.compressor()
    out = comp.decompress(
        _wire_container(comp, packed[r], bw[r], anchor[r], cfg.eb, chunk_n))
    return out.to(x_full.dtype), ovf | corrupt


def _execute_broadcast(x, g, cfg: GZConfig, *, root: int = 0):
    """EXECUTE layer for the binomial-tree broadcast from rank 0: compress
    once, forward the stream down the trimmed tree (``schedule.tree_plan``
    pairs), decompress once per rank.  Every rank compresses its local
    ``x`` as the reference does; only the root's stream travels, so only
    its overflow flag counts; a failed stream check counts on the rank
    that keeps the stream."""
    n, r = g.size, g.rank
    if root != 0:
        raise ValueError(
            f"broadcast over {n} ranks: only root 0 is supported (the binomial "
            f"tree is rooted at rank 0); got root={root}."
        )
    comp = cfg.compressor()
    c = comp.compress(x.reshape(-1).to(torch.float32), cfg.eb)
    ovf = c.overflowed() if r == 0 else _false(x.device)
    for k, (span, _full, _trim, perm) in enumerate(schedule.tree_plan(n)):
        c_recv, bad = _exchange(g, c, perm, cfg.verify_streams, k)
        if r % (span * 2) == span:
            c = c_recv
            ovf = _or(ovf, bad)
    return comp.decompress(c).reshape(x.shape).to(x.dtype), ovf


# ---------------------------------------------------------------------------
# All-to-all — the direct compressed rank exchange
# ---------------------------------------------------------------------------


def _execute_all_to_all(x, g, cfg: GZConfig):
    """EXECUTE layer for the compressed rank exchange (one lossy hop).

    ``x`` (n*chunk, ...) holds slot buffers grouped by destination rank
    along the leading dim.  Each destination chunk is compressed on its
    own (``_compress_chunks``), the streams travel through the
    transport's ``all_to_all`` (unguarded, as in the reference), and each
    rank decompresses what it received, stacked in sender order."""
    n = g.size
    if x.shape[0] % n != 0:
        raise ValueError(
            f"all_to_all over {n} ranks: the leading dim must be divisible by "
            "the axis size (slot buffers grouped by destination rank); got "
            f"shape {tuple(x.shape)}"
        )
    chunk_n = x.numel() // n
    packed, bw, anchor, ovf = _compress_chunks(
        x.reshape(n, chunk_n).to(torch.float32), n, chunk_n, cfg)
    rp, rb, ra = g.all_to_all((packed, bw, anchor))
    comp = cfg.compressor()
    out = torch.stack([
        comp.decompress(_wire_container(comp, rp[i], rb[i], ra[i], cfg.eb, chunk_n))
        for i in range(n)
    ])
    return out.reshape(x.shape).to(x.dtype), ovf
