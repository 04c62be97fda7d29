"""The single-pass ring hop (kernel 2, ``unpack_reduce_repack`` in
``src/repro_torch/kernels/csrc/lorenzo.cu``), replayed in torch on the CPU.

The CUDA kernel runs only on the card.  What it adds over the plain
version is its tiling, so that is replayed here and held against
``unpack_reduce_repack_plain``, and through it against the Pallas kernel
in interpret mode:

* ``_walk``: one launch's tiles, drawn in start order, each running two
  decoupled look-backs of ``csrc/lorenzo_common.cuh`` (the incoming word
  offsets, then the outgoing ones, in a second state array with the same
  epoch) with the tile's decode and re-pack between them.  A seeded
  scheduler interleaves the tiles' steps in random orders, or in the worst
  order (every publication first, then the highest tile that can move),
  with at most ``resident`` tiles in flight.  Both state arrays start with
  stale words of an earlier epoch.
* ``_receive``: the staged incoming segment (from the 16-byte boundary at
  or below the tile's first word, at every pointer alignment; words
  outside [0, cap_in) read 0), the lane layout (lane l decodes elements
  4l..4l+3 and 128+4l..128+4l+3) and the two-part warp scan.
* ``_send``: the reduce rounded once, the re-quantize, the shuffled Lorenzo
  deltas and the whole-warp maximum, the codes in skewed shared rows, and
  the pack in place: lane r of a block's eight packs codes 32r..32r+31
  into words bw*r..bw*r+bw-1.
* The copy-out with the capacity clamp and the tail launch's 4-word split:
  every word below the capacity is written exactly once.

Stream words, widths, anchors, the total and the f32 sum must be bitwise
the plain version's, with ``emit_f32`` on and off, at 8, 32, 40 and 72
blocks, with capacities inside a tile and overflowing streams, all-zero
widths and full-width random bits.  The compressor's ``nwords`` after a
hop is the total, ``packed_words(bw_out)``, overflow included.  A last
test holds the kernels' C prototypes against their ``ctypes`` signatures.
"""
import ctypes
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import bitpack, compressor
from repro_torch.core.compressed import capacity_words_for
from repro_torch.kernels import entropy as kentropy
from repro_torch.kernels import lookback, lorenzo, ops, ref
from repro_torch.kernels.ref import MASK32, as_u32, wrap_i32
from test_torch_lookback import EPOCH, FLAG_AGGREGATE, FLAG_INCLUSIVE, _state_word

R = lookback.TILE_BLOCKS        # blocks per tile
SEG_WORDS = R * 256 + 8         # kSegWords: the staged incoming segment
RUN = 32                        # kRun: codes a lane packs
ZROW = 256 + 4 * (256 // RUN)   # kZRow: a block's skewed row of codes
SENTINEL = 0x5EED5EED
CSRC = pathlib.Path(lorenzo.__file__).resolve().parent / "csrc"


# ---------------------------------------------------------------------------
# Two look-backs per tile
# ---------------------------------------------------------------------------


def _stale(rng, tiles):
    flags, values = rng.integers(0, 4, tiles), rng.integers(0, 2**31, tiles)
    return torch.tensor([_state_word(EPOCH - 1, int(f), int(v)) for f, v in zip(flags, values)],
                        dtype=torch.int64)


def _window(state, pred):
    """One window read: lane i reads the (i+1)-th nearest predecessor.
    Returns (flags, values); before tile 0 reads as an empty inclusive."""
    i = pred - torch.arange(32)
    w = state[i.clamp(min=0)]
    flag = torch.where((w >> 34) == EPOCH, (w >> 32) & 3, torch.zeros_like(w))
    value = w & MASK32
    flag = torch.where(i < 0, torch.full_like(w, FLAG_INCLUSIVE), flag)
    value = torch.where(i < 0, torch.zeros_like(w), value)
    return flag, value


def _walk(aggs_in, body, seed, *, worst=False, resident=None):
    """One launch: tiles drawn in index order, at most ``resident`` in
    flight; each publishes its incoming aggregate, looks back (state array
    A), runs ``body(t, off_in) -> outgoing aggregate``, publishes that and
    looks back again (array B).  A ``body`` that returns None ends its tile
    after look-back A (kernel 1's single look-back).  Returns (incoming
    offsets, outgoing offsets, the last tile's inclusive prefix in the last
    array it published, window reads)."""
    rng = np.random.default_rng(seed)
    tiles = len(aggs_in)
    states = [_stale(rng, tiles), _stale(rng, tiles)]
    aggs = [list(aggs_in), [None] * tiles]
    offs = [[None] * tiles, [None] * tiles]
    resident = resident or tiles
    active, started, reads = {}, 0, 0  # tile -> [look-back, None | [pred, sum]]

    def finish(t, lb, excl):
        offs[lb][t] = excl
        states[lb][t] = _state_word(EPOCH, FLAG_INCLUSIVE, excl + aggs[lb][t])
        if lb == 0:
            aggs[1][t] = body(t, excl)
        if lb == 0 and aggs[1][t] is not None:
            active[t] = [1, None]
        else:
            del active[t]

    def can_move(t):
        lb, st = active[t]
        return st is None or not bool((_window(states[lb], st[0])[0] == 0).any())

    while started < tiles or active:
        can_start = started < tiles and len(active) < resident
        if worst:
            movers = [t for t in active if can_move(t)]
            pick = "start" if can_start else max(
                [t for t in movers if active[t][1] is None] or movers)
        else:
            choices = list(active) + (["start"] if can_start else [])
            pick = choices[rng.integers(len(choices))]
        if pick == "start":
            active[started] = [0, None]
            started += 1
            continue
        t = pick
        lb, st = active[t]
        if st is None:  # publish the aggregate (tile 0: its inclusive prefix)
            if t == 0:
                finish(0, lb, 0)
            else:
                states[lb][t] = _state_word(EPOCH, FLAG_AGGREGATE, aggs[lb][t])
                active[t][1] = [t - 1, 0]
            continue
        flag, value = _window(states[lb], st[0])
        reads += 1
        if bool((flag == 0).any()):
            continue  # spin: re-read the window later
        incl = torch.nonzero(flag == FLAG_INCLUSIVE).flatten()
        stop = int(incl[0]) if incl.numel() else 31
        st[1] += int(value[: stop + 1].sum())
        if incl.numel():
            finish(t, lb, st[1])
        else:
            st[0] -= 32
    last = states[0 if aggs[1][tiles - 1] is None else 1][tiles - 1]
    assert int(last >> 34) == EPOCH and int((last >> 32) & 3) == FLAG_INCLUSIVE
    return offs[0], offs[1], int(last & MASK32), reads


# ---------------------------------------------------------------------------
# One tile: receive, reduce, send
# ---------------------------------------------------------------------------


def _lanes():
    """(part, lane, e) -> element index 128 * part + 4 * lane + e."""
    part = torch.arange(2)[:, None, None]
    lane = torch.arange(32)[None, :, None]
    e = torch.arange(4)[None, None, :]
    return 128 * part + 4 * lane + e


def _receive(pk, cap_in, bw, anchor, off, mis):
    """The tile's staged segment and decode: int32 q (blocks, 256) of the
    tile's blocks (``bw``, ``anchor`` theirs), the segment starting at word
    ``off``; ``mis`` is the stream pointer's offset in words from a 16-byte
    boundary."""
    words = 8 * bw.to(torch.int64)
    inoff = torch.cumsum(words, 0) - words
    end = off + int(words.sum())
    lo = ((off + mis) & ~3) - mis
    n4 = (end - lo + 3) >> 2
    assert 4 * n4 <= SEG_WORDS
    idx = lo + torch.arange(4 * n4 + 1, dtype=torch.int64)
    inside = (idx >= 0) & (idx < cap_in)
    seg = torch.where(inside, pk[idx.clamp(0, max(cap_in - 1, 0))], torch.zeros_like(idx)) \
        if cap_in else torch.zeros_like(idx)
    first = (off - lo + inoff)[:, None, None, None]
    b = bw.to(torch.int64)[:, None, None, None]
    bit = first * 32 + _lanes()[None] * b                # (block, part, lane, e)
    wi, sh = bit >> 5, bit & 31
    last = seg.numel() - 1
    u = seg[wi.clamp(max=last)] >> sh
    spill = (sh != 0) & (sh + b > 32)
    u = u | torch.where(spill, (seg[(wi + 1).clamp(max=last)] << (32 - sh)) & MASK32,
                        torch.zeros_like(u))
    return _unzigzag_scan(u & ((torch.ones_like(b) << b) - 1), anchor)


def _unzigzag_scan(u, anchor):
    """``unzigzag`` then ``scan_block`` of ``csrc/lorenzo.cu``: zigzag codes
    (block, part, lane, e) in the lane layout + int32 anchors (block,) ->
    int32 q (blocks, 256) in element order, by the two-part warp scan."""
    d = ((u >> 1) ^ -(u & 1)) & MASK32
    s = d.sum(dim=3)                                      # (block, part, lane)
    inc = torch.cumsum(s, dim=2)                          # the warp scans
    run = anchor.to(torch.int64)[:, None, None] + inc - s
    run[:, 1] += inc[:, 0, 31:32]
    q = wrap_i32(run[..., None] + torch.cumsum(d, dim=3))
    return q.reshape(-1, 256)                             # element order


def _send(q_in, acc, eb_in, eb_out):
    """Reduce (rounded once), re-quantize and encode in the lane layout:
    (f32 sum, skewed rows of codes (blocks, ZROW), bw_out, anchor_out)."""
    x = ref.fma_f32(q_in.to(torch.float32), ref.twoeb_of(eb_in), acc)
    q = ref.f32_to_i32_rn(x * ref.recip_of(eb_out))
    return (x,) + _encode(q)


def _encode(q):
    """encode_block of int32 q (blocks, 256) in the lane layout: (skewed
    rows of codes (blocks, ZROW), bw, anchor)."""
    q = q.to(torch.int64)
    ql = q.view(-1, 2, 32, 4)                             # (block, part, lane, e)
    prev = torch.empty_like(ql)
    prev[..., 1:] = ql[..., :-1]                          # the same lane
    prev[:, :, 1:, 0] = ql[:, :, :-1, 3]                  # __shfl_up_sync of e = 3
    prev[:, 0, 0, 0] = ql[:, 0, 0, 0]                     # element 0: no predecessor
    prev[:, 1, 0, 0] = ql[:, 0, 31, 3]                    # element 128: lane 31's 127
    dz = wrap_i32(ql - prev).to(torch.int64)
    zz = (((dz << 1) ^ (dz >> 31)) & MASK32).reshape(-1, 256)
    bw = ref.bitwidth_of(zz.amax(dim=1))
    e = torch.arange(256)
    rows = torch.full((zz.shape[0], ZROW), SENTINEL, dtype=torch.int64)
    rows[:, e + 4 * (e // RUN)] = zz                     # zrow(e)
    return rows, bw, wrap_i32(q[:, 0])


def _pack_in_place(rows, bw):
    """pack_run_in_place: every lane reads its 32 codes first; lane r then
    writes words bw*r.. over the row.  Returns the blocks' words (blocks,
    256), the first 8 * bw of each valid."""
    nblk = rows.shape[0]
    e = torch.arange(256)
    codes = rows[:, e + 4 * (e // RUN)].view(nblk, 8, RUN)  # (block, lane r, k)
    out = rows.clone()
    b = bw.to(torch.int64)[:, None].expand(nblk, 8)
    cur = torch.zeros(nblk, 8, dtype=torch.int64)
    used = torch.zeros_like(cur)
    widx = b * torch.arange(8)[None, :]
    blk = torch.arange(nblk)[:, None].expand(nblk, 8)
    for k in range(RUN):
        c = codes[:, :, k]
        cur = cur | ((c << used) & MASK32)
        full = used + b >= 32
        out[blk[full], widx[full]] = cur[full]
        widx = widx + full.long()
        cur = torch.where(full, c >> (32 - used), cur)  # c < 2^32: 0 when used == 0
        used = (used + b) & 31
    assert torch.equal(widx, b * torch.arange(1, 9)[None, :])  # bw words a lane
    assert nblk == 0 or int((8 * b[:, 0]).max()) <= ZROW
    return out[:, :256]


def _hop_replay(stream, acc, eb_in, eb_out, cap_out, *, seed, worst=False, resident=None,
                mis=0, emit_f32=False):
    """The hop kernel's tile walk and the tail launch: (packed_out, bw_out,
    anchor_out[, x], total), as the plain version returns them with
    ``return_total``."""
    packed, bw_in, anchor_in = stream
    nb, cap_in = bw_in.shape[0], packed.shape[0]
    pk = as_u32(packed)
    tiles = -(-nb // R)
    padded = torch.zeros(tiles * R, dtype=torch.int64)
    padded[:nb] = 8 * bw_in.to(torch.int64)
    aggs_in = padded.view(tiles, R).sum(dim=1).tolist()
    x = torch.empty(nb, 256, dtype=torch.float32)
    bw_out = torch.empty(nb, dtype=torch.int32)
    anchor_out = torch.empty(nb, dtype=torch.int32)
    words = torch.empty(nb, 256, dtype=torch.int64)

    def body(t, off_in):
        blocks = slice(t * R, min((t + 1) * R, nb))
        q = _receive(pk, cap_in, bw_in[blocks], anchor_in[blocks], off_in, mis)
        x[blocks], rows, bw_out[blocks], anchor_out[blocks] = _send(q, acc[blocks], eb_in,
                                                                    eb_out)
        words[blocks] = _pack_in_place(rows, bw_out[blocks])
        return 8 * int(bw_out[blocks].to(torch.int64).sum())

    _, offs_out, total, _ = _walk(aggs_in, body, seed, worst=worst, resident=resident)
    out = _copy_out(offs_out, words, bw_out, cap_out, total)
    res = (out, bw_out, anchor_out) + ((x,) if emit_f32 else ())
    return res + (torch.tensor(total, dtype=torch.int32),)


def _copy_out(offs, words, bw, cap, total):
    """Each tile's copy-out below the capacity from its first word
    ``offs[t]``, then the tail launch's zeroing of [total, cap) in its
    4-word split; every word below the capacity is written exactly once.
    Returns the int32 stream."""
    nb = bw.shape[0]
    out = torch.full((cap,), SENTINEL, dtype=torch.int64)
    writes = torch.zeros(cap, dtype=torch.int64)
    nw = 8 * bw.to(torch.int64)
    for t, off in enumerate(offs):
        base = off
        for b in range(t * R, min((t + 1) * R, nb)):
            g = base + torch.arange(int(nw[b]))
            keep = g < cap
            out[g[keep]] = words[b, : int(nw[b])][keep]
            writes.index_add_(0, g[keep], torch.ones_like(g[keep]))
            base += int(nw[b])
    mid = min((total + 3) & ~3, cap) if total < cap else cap
    end4 = max(mid, cap & ~3)
    for lo, hi in ((total, mid), (mid, end4), (end4, cap)):  # the tail launch
        if lo < hi:
            out[lo:hi] = 0
            writes[lo:hi] += 1
    assert cap == 0 or (int(writes.min()) == 1 and int(writes.max()) == 1)
    return wrap_i32(out)


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------

EB_IN, EB_OUT = 1e-4 / 8, 1e-4 / 7


def _data(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        return (np.cumsum(rng.normal(0, 0.01, n)) * 8.0).astype(np.float32)
    if kind == "zero":
        return np.zeros(n, np.float32)
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)


def _case(nb, kind, cap_in_kind, cap_out_kind, seed):
    """Incoming stream, acc, the bounds and the outgoing capacity.  Capacity
    kinds: "ample" (factor 2, never overflows), "in-tile" (inside the
    second tile, or the first of a one-tile stream), "small" (64 words)."""
    n = nb * 256
    x2d = torch.from_numpy(_data(kind, n, seed)).view(nb, 256)
    acc = torch.from_numpy(_data("zero" if kind == "zero" else "smooth", n, seed + 1))
    acc = acc.view(nb, 256)
    eb_in, eb_out = ops.as_eb(EB_IN, "cpu"), ops.as_eb(EB_OUT, "cpu")

    def cap_of(kind_, bw):
        w = (8 * bw.to(torch.int64)).tolist()
        if kind_ == "ample":
            return capacity_words_for(n, 2.0, 256)
        if kind_ == "small":
            return 64
        lo = R if nb > R else 0  # cut inside tile 1, or tile 0
        return sum(w[:lo]) + sum(w[lo: lo + 3]) + 5

    full = lorenzo.quantize_pack_plain(x2d, eb_in, capacity_words_for(n, 2.0, 256))
    cap_in = cap_of(cap_in_kind, full[1])
    stream = lorenzo.quantize_pack_plain(x2d, eb_in, cap_in)[:3]
    probe = lorenzo.unpack_reduce_repack_plain(*stream, eb_in, acc, eb_out, 8)
    cap_out = cap_of(cap_out_kind, probe[1])
    return stream, acc, eb_in, eb_out, cap_out


CASES = [  # (nb, data kind, incoming capacity, outgoing capacity)
    (8, "smooth", "ample", "ample"),       # one part-full tile
    (32, "smooth", "ample", "ample"),      # one full tile
    (40, "smooth", "ample", "ample"),      # a part-full last tile
    (72, "smooth", "ample", "ample"),
    (72, "smooth", "ample", "in-tile"),    # the outgoing stream cut inside tile 1
    (32, "smooth", "ample", "in-tile"),    # ... inside the only tile
    (40, "smooth", "ample", "small"),      # overflowing far
    (72, "smooth", "in-tile", "ample"),    # the incoming stream cut: words past it read 0
    (40, "zero", "ample", "ample"),        # all-zero widths in and out
    (40, "random-bits", "ample", "ample"),  # full-width random bits (NaN, Inf, saturating)
    (72, "random-bits", "ample", "in-tile"),
]


def _check(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), f"output {i}"


@pytest.mark.parametrize("emit_f32", [False, True])
@pytest.mark.parametrize("nb,kind,cap_in,cap_out", CASES)
def test_hop_replay_bitwise_equals_plain(nb, kind, cap_in, cap_out, emit_f32):
    seed = CASES.index((nb, kind, cap_in, cap_out))
    stream, acc, eb_in, eb_out, cap = _case(nb, kind, cap_in, cap_out, seed)
    want = lorenzo.unpack_reduce_repack_plain(*stream, eb_in, acc, eb_out, cap,
                                              emit_f32=emit_f32, return_total=True)
    got = _hop_replay(stream, acc, eb_in, eb_out, cap, seed=seed, emit_f32=emit_f32,
                      mis=seed % 4)
    _check(got, want)
    total = int(want[-1])
    assert total == int(bitpack.packed_words(want[1], 256))
    if cap_out != "ample":
        assert total > cap  # the outgoing stream overflows
    if kind == "zero":
        assert total == 0 and not bool(want[1].any())
    if kind == "random-bits":
        assert int(want[1].max()) == 32


@pytest.mark.parametrize("seed,worst,resident,mis", [
    (0, False, None, 0), (1, False, 2, 1), (2, True, None, 2), (3, True, 3, 3),
    (4, False, 1, 0),   # one tile in flight: strictly in start order
])
def test_hop_replay_under_schedules(seed, worst, resident, mis):
    """Both look-backs under random and worst orders, few resident tiles,
    stale state words, every stream alignment; 72 blocks (3 tiles) cut
    inside tile 1, and 264 blocks (9 tiles) so that a window steps back."""
    for nb, cap_out in ((72, "in-tile"), (264, "ample")):
        stream, acc, eb_in, eb_out, cap = _case(nb, "smooth", "ample", cap_out, seed)
        want = lorenzo.unpack_reduce_repack_plain(*stream, eb_in, acc, eb_out, cap,
                                                  emit_f32=True, return_total=True)
        got = _hop_replay(stream, acc, eb_in, eb_out, cap, seed=seed, worst=worst,
                          resident=resident, mis=mis, emit_f32=True)
        _check(got, want)


def test_walk_worst_order_steps_back():
    """In the worst order the highest tile looks back first, over 40 tiles
    of aggregates: its window steps back past 32 predecessors."""
    aggs = list(range(1, 41))
    outs = []
    _, offs, total, reads = _walk(aggs, lambda t, off: (outs.append(off) or 3), 5,
                                  worst=True)
    want = np.concatenate([[0], np.cumsum(aggs)[:-1]]).tolist()
    assert sorted(outs) == want and offs == [3 * t for t in range(40)]
    assert total == 120 and reads >= 2 * 39 + 2


@pytest.mark.parametrize("bw", range(33))
def test_pack_runs_fill_whole_words(bw):
    """32 codes of bw bits are bw whole words: the lane packer's words equal
    ``bitpack.pack`` of the block at width bw, for every width."""
    rng = np.random.default_rng(bw)
    codes = torch.from_numpy(rng.integers(0, 2**bw, (3, 256), dtype=np.int64))
    widths = torch.full((3,), bw, dtype=torch.int32)
    e = torch.arange(256)
    rows = torch.full((3, ZROW), SENTINEL, dtype=torch.int64)
    rows[:, e + 4 * (e // RUN)] = codes
    got = _pack_in_place(rows, widths)[:, : 8 * bw].reshape(-1)
    want = as_u32(bitpack.pack(codes, widths, 3 * 8 * bw)[0])
    assert torch.equal(got, want)


@pytest.mark.parametrize("emit_f32", [False, True])
@pytest.mark.parametrize("nb,kind,cap_out", [(40, "smooth", "in-tile"),
                                            (16, "random-bits", "ample")])
def test_hop_replay_bitwise_equals_pallas(nb, kind, cap_out, emit_f32):
    """The replay against the JAX package's Pallas kernel in interpret mode,
    on the same inputs."""
    stream, acc, eb_in, eb_out, cap = _case(nb, kind, "ample", cap_out, 7)
    got = _hop_replay(stream, acc, eb_in, eb_out, cap, seed=7, emit_f32=emit_f32)
    pk = jnp.asarray(stream[0].numpy().view(np.uint32))
    bw, an = jnp.asarray(stream[1].numpy()), jnp.asarray(stream[2].numpy())
    jres = jops.unpack_reduce_repack(pk, bw, an, EB_IN,
                                     jnp.asarray(acc.numpy()), EB_OUT, cap,
                                     emit_f32=emit_f32)
    for g, w in zip(got, jres):
        assert np.array_equal(g.numpy().view(np.int32), np.asarray(w).view(np.int32))


# ---------------------------------------------------------------------------
# The total through the wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap_out", ["ample", "small"])
def test_hop_total_and_compressor_nwords(cap_out):
    """``ops.unpack_reduce_repack`` returns the total last with
    ``return_total`` (after the f32 sum), and the fused compressor's hop
    carries it as ``nwords``: ``packed_words(bw_out)``, overflow
    included."""
    stream, acc, eb_in, eb_out, cap = _case(40, "smooth", "ample", cap_out, 11)
    for emit in (False, True):
        res = ops.unpack_reduce_repack(*stream, eb_in, acc, eb_out, cap, emit_f32=emit,
                                       return_total=True)
        assert len(res) == 4 + emit and res[-1].dtype == torch.int32 and res[-1].shape == ()
        assert int(res[-1]) == int(bitpack.packed_words(res[1], 256))
        assert (int(res[-1]) > cap) == (cap_out == "small")
        assert len(ops.unpack_reduce_repack(*stream, eb_in, acc, eb_out, cap,
                                            emit_f32=emit)) == 3 + emit
    codec = compressor.ErrorBoundedLorenzo(capacity_factor=0.6 if cap_out == "ample" else 0.02)
    n = acc.numel()
    c = codec.compress(torch.from_numpy(_data("smooth", n, 12)), EB_IN)
    for fused_codec in (codec, compressor.ErrorBoundedLorenzo(
            capacity_factor=codec.capacity_factor, fused=False)):
        for ret in (False, True):
            c_out, upd = fused_codec.decompress_reduce_compress(c, acc.reshape(-1), EB_OUT,
                                                                return_updated=ret)
            assert c_out.nwords.dtype == torch.int32
            assert torch.equal(c_out.nwords, bitpack.packed_words(c_out.bitwidth, 256))
            assert (upd is not None) == ret
    assert bool(c_out.overflowed()) == (cap_out == "small")


# ---------------------------------------------------------------------------
# The C prototypes against the ctypes signatures
# ---------------------------------------------------------------------------


def _prototypes(source):
    """{C entry point: its parameters' types} of a source's extern "C" block."""
    text = (CSRC / source).read_text()
    text = text[text.index('extern "C" {'):]
    return {m.group(1): [" ".join(p.split()[:-1]) for p in m.group(2).split(",")]
            for m in re.finditer(r"^int (\w+)\(([^)]*)\)", text, re.M)}


def _ctype_of(c_type):
    """The ctypes argument type a C parameter type needs: a pointer or the
    stream is c_void_p, ``long long`` c_longlong, an int c_int."""
    if c_type.endswith("*") or c_type == "cudaStream_t":
        return ctypes.c_void_p
    if c_type == "long long":
        return ctypes.c_longlong
    assert c_type in ("int", "unsigned int"), c_type
    return ctypes.c_int


@pytest.mark.parametrize("module,source", [(lorenzo, "lorenzo.cu"),
                                           (kentropy, "entropy.cu")])
def test_ctypes_signatures_match_prototypes(module, source):
    """Every wrapper passes as many arguments as the C function takes (the
    stream last), each of the ctypes type its C type needs: a short
    signature truncates the stream pointer, an int where a pointer goes
    cuts the pointer."""
    protos = _prototypes(source)
    assert set(protos) == set(module._SIGNATURES)
    for fn, argtypes in module._SIGNATURES.items():
        assert len(argtypes) == len(protos[fn]), fn
        assert list(argtypes) == [_ctype_of(t) for t in protos[fn]], fn
