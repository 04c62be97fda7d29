"""The single-pass design of the entropy kernels (kernels 8-10,
``src/repro_torch/kernels/csrc/entropy.cu``), replayed in torch on the CPU.

The CUDA kernels run only on the card.  What they add over the plain
versions is their tiling, so that is replayed here and held against the
plain versions, and through them against the Pallas kernels in interpret
mode:

* ``_lookback``: the decoupled look-back of ``csrc/lorenzo_common.cuh``.
  Tiles draw indices in start order, and a seeded scheduler interleaves
  their steps in random orders, or in the worst order, where every tile
  publishes its aggregate before any looks back and the last looks back
  first.  The steps are: publish the aggregate; read 32 predecessors,
  re-read while any is invalid, and sum back to the nearest inclusive
  prefix or step back 32; publish the inclusive prefix.  The state array
  starts with stale words of an earlier epoch.  The offsets must equal the
  exclusive cumsum of the tiles' word counts 2 * sum_k bw_k.
* ``_pack_replay``: the pack kernel's lane layout (lane l holds elements
  4l..4l+3 and 128+4l..128+4l+3), its shuffled Lorenzo deltas and
  half-warp sub maxima, the in-tile block offsets, the word building (the
  sub search, the reciprocal division, the OR of the overlapping codes),
  the capacity clamp and the tail launch's 4-word split.  Every word below
  the capacity must be written exactly once, and the result must be bitwise
  ``quantize_pack_plain``'s.
* ``_unpack_replay``: the staged segment (from the 16-byte boundary at or
  below the tile's first word, at every pointer alignment; words outside
  [0, cap) read 0), the per-lane decode and the two-part warp scan,
  bitwise ``unpack_dequantize{,_reduce}_plain``'s.
* The total that ``quantize_pack`` returns equals ``packed_words(desc)``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import compressor, entropy
from repro_torch.kernels import entropy as kentropy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import MASK32, as_u32, wrap_i32

R = kentropy.TILE_BLOCKS  # blocks per tile in the kernels
FLAG_AGGREGATE, FLAG_INCLUSIVE = 1, 2
EPOCH = 7
RECIP_SHIFT = 21
SENTINEL = 0x5EED5EED


# ---------------------------------------------------------------------------
# The look-back
# ---------------------------------------------------------------------------


def _state_word(epoch, flag, value):
    return (epoch << 34) | (flag << 32) | value


def _lookback(aggs, seed, *, worst=False, resident=None):
    """Exclusive prefix of each tile's aggregate by the decoupled look-back,
    with tile steps interleaved by a seeded scheduler (at most ``resident``
    tiles in flight, started in index order).  Returns (offsets, the last
    tile's inclusive prefix, window reads)."""
    rng = np.random.default_rng(seed)
    tiles = len(aggs)
    stale = rng.integers(0, 2**31, tiles)
    state = torch.tensor([_state_word(EPOCH - 1, int(f), int(v))
                          for f, v in zip(rng.integers(0, 4, tiles), stale)], dtype=torch.int64)
    resident = resident or tiles
    lanes = torch.arange(32)
    excl, active, started, reads = [None] * tiles, {}, 0, 0
    while started < tiles or active:
        publishing = [t for t, a in active.items() if a is None]
        if worst:
            if started < tiles and len(active) < resident:
                pick = "start"
            else:
                pick = publishing[0] if publishing else max(active)
        else:
            choices = list(active) + (["start"] if started < tiles and
                                      len(active) < resident else [])
            pick = choices[rng.integers(len(choices))]
        if pick == "start":
            active[started] = None
            started += 1
            continue
        t = pick
        if active[t] is None:  # publish the aggregate (tile 0: its inclusive prefix)
            if t == 0:
                state[0] = _state_word(EPOCH, FLAG_INCLUSIVE, aggs[0])
                excl[0] = 0
                del active[0]
            else:
                state[t] = _state_word(EPOCH, FLAG_AGGREGATE, aggs[t])
                active[t] = [t - 1, 0]
            continue
        pred, acc = active[t]
        i = pred - lanes  # lane j reads the (j+1)-th nearest predecessor
        w = state[i.clamp(min=0)]
        flag = torch.where((w >> 34) == EPOCH, (w >> 32) & 3, torch.zeros_like(w))
        value = w & MASK32
        flag = torch.where(i < 0, torch.full_like(w, FLAG_INCLUSIVE), flag)
        value = torch.where(i < 0, torch.zeros_like(w), value)
        reads += 1
        if bool((flag == 0).any()):
            continue  # spin: re-read the window later
        incl = torch.nonzero(flag == FLAG_INCLUSIVE).flatten()
        stop = int(incl[0]) if incl.numel() else 31
        acc += int(value[: stop + 1].sum())
        if incl.numel():
            excl[t] = acc
            state[t] = _state_word(EPOCH, FLAG_INCLUSIVE, acc + aggs[t])
            del active[t]
        else:
            active[t] = [pred - 32, acc]
    last = state[tiles - 1]
    assert int(last >> 34) == EPOCH and int((last >> 32) & 3) == FLAG_INCLUSIVE
    return excl, int(last & MASK32), reads


def _random_desc(nb, seed):
    """Descriptors with random sub widths in 0..32, whole zero blocks and
    full 32-bit blocks."""
    rng = np.random.default_rng(seed)
    bw = rng.integers(0, 33, (nb, 4))
    bw[rng.random(nb) < 0.2] = 0
    bw[rng.random(nb) < 0.1] = 32
    return entropy.make_desc(torch.from_numpy(bw).to(torch.int32))


def _block_words(desc):
    return entropy.split_desc(desc).to(torch.int64).sum(dim=1) * entropy.SUB_WORDS_PER_BIT


def _tile_aggs(words, tile_blocks):
    nb = words.shape[0]
    tiles = -(-nb // tile_blocks)
    padded = torch.zeros(tiles * tile_blocks, dtype=torch.int64)
    padded[:nb] = words
    return padded.view(tiles, tile_blocks).sum(dim=1).tolist()


@pytest.mark.parametrize("tile_blocks", [8, 32])
@pytest.mark.parametrize("nb,seed,worst,resident", [
    (8, 0, False, None),        # one tile
    (100, 1, False, None),      # a part-full last tile
    (2048, 2, False, None),     # 64 (R=32) or 256 (R=8) tiles, any order
    (2048, 3, True, None),      # every aggregate first, the last tile looks back first
    (2048, 4, False, 5),        # few resident tiles: mostly in start order
    (1111, 5, True, 40),
])
def test_lookback_offsets_equal_exclusive_cumsum(tile_blocks, nb, seed, worst, resident):
    desc = _random_desc(nb, seed)
    aggs = _tile_aggs(_block_words(desc), tile_blocks)
    got, total, reads = _lookback(aggs, seed, worst=worst, resident=resident)
    want = np.concatenate([[0], np.cumsum(aggs)[:-1]]).tolist()
    assert got == want
    assert total == int(entropy.packed_words(desc)) == sum(aggs)
    if worst and len(aggs) > 64:  # the last tile stepped back window after window
        assert reads >= len(aggs) - 1 + (len(aggs) - 1) // 32


def test_lookback_all_zero_and_full_width():
    for bw in (0, 32):
        desc = entropy.make_desc(torch.full((96, 4), bw, dtype=torch.int32))
        aggs = _tile_aggs(_block_words(desc), R)
        got, total, _ = _lookback(aggs, bw)
        assert got == [i * R * 8 * bw for i in range(3)] and total == 96 * 8 * bw


# ---------------------------------------------------------------------------
# The pack kernel
# ---------------------------------------------------------------------------


def _recip(bw):
    """ceil(2^21 / bw), the kernel's ``kRecip`` table (0 for bw = 0)."""
    return torch.where(bw > 0, ((1 << RECIP_SHIFT) + bw - 1) // bw.clamp(min=1),
                       torch.zeros_like(bw))


def test_reciprocal_division_is_exact():
    """The pack kernel's division: (n * kRecip[bw]) >> 21 == n // bw for
    every first bit n of a word inside its sub (n < 64 * 32), without
    overflowing 32 bits."""
    n = torch.arange(64 * 32, dtype=torch.int64)[:, None]
    bw = torch.arange(1, 33, dtype=torch.int64)[None, :]
    prod = n * _recip(bw)
    assert int(prod.max()) < 2**32
    assert torch.equal(prod >> RECIP_SHIFT, n // bw)


def _lane_front(x2d, eb, lossless):
    """The pack kernel's front, per block: zigzag codes (nb, 256), desc,
    anchor.  Lane l of the block's warp holds elements 4l..4l+3 (part 0)
    and 128+4l..128+4l+3 (part 1); deltas take the previous element from
    the same lane or by a shuffle; sub maxima are half-warp maxima."""
    nb = x2d.shape[0]
    if lossless:
        q = x2d.contiguous().view(torch.int32).to(torch.int64)
    else:
        q = ref.f32_to_i32_rn(x2d * ref.recip_of(eb)).to(torch.int64)
    ql = q.view(nb, 2, 32, 4)  # (block, part, lane, i)
    prev = torch.empty_like(ql)
    prev[..., 1:] = ql[..., :-1]              # element i - 1 of the same lane
    prev[:, :, 1:, 0] = ql[:, :, :-1, 3]      # __shfl_up_sync of element 3
    prev[:, 0, 0, 0] = ql[:, 0, 0, 0]         # element 0 has no predecessor
    prev[:, 1, 0, 0] = ql[:, 0, 31, 3]        # element 128: lane 31's element 127
    d = wrap_i32(ql - prev).to(torch.int64)
    zz = ((d << 1) ^ (d >> 31)) & MASK32
    m = zz.amax(dim=3).view(nb, 2, 2, 16).amax(dim=3).reshape(nb, 4)  # sub 2 * part + half
    desc = entropy.make_desc(ref.bitwidth_of(m))
    return zz.reshape(nb, 256), desc, wrap_i32(q[:, 0])


def _block_bases(desc, tile_blocks, seed):
    """Each block's first word: its tile's look-back offset plus the
    exclusive scan of the word counts before it inside the tile."""
    words = _block_words(desc)
    nb = words.shape[0]
    offsets, total, _ = _lookback(_tile_aggs(words, tile_blocks), seed)
    tile = torch.arange(nb) // tile_blocks
    inclusive = torch.cumsum(words, 0)
    tile_start = (torch.tensor(offsets, dtype=torch.int64))[tile]
    in_tile = inclusive - words - (inclusive - words)[tile * tile_blocks]
    return tile_start + in_tile, total


def _pack_replay(x2d, eb, cap, lossless, seed):
    zz, desc, anchor = _lane_front(x2d, eb, lossless)
    nb = x2d.shape[0]
    base, total = _block_bases(desc, R, seed)
    bw_k = entropy.split_desc(desc).to(torch.int64)  # (nb, 4)
    so = torch.cumsum(bw_k * entropy.SUB_WORDS_PER_BIT, dim=1)  # so1, so2, so3, nw
    j = torch.arange(256, dtype=torch.int64)[None, :]
    valid = j < so[:, 3:4]
    k = (j >= so[:, 0:1]).long() + (j >= so[:, 1:2]).long() + (j >= so[:, 2:3]).long()
    bw = torch.gather(bw_k, 1, k.clamp(max=3))
    start = torch.gather(torch.cat([torch.zeros(nb, 1, dtype=torch.int64), so[:, :3]], 1),
                         1, k.clamp(max=3))
    bit0 = 32 * (j - start)
    rc = _recip(bw)
    e0 = (bit0 * rc) >> RECIP_SHIFT
    e1 = torch.minimum((bit0 + 31) * rc >> RECIP_SHIFT, torch.full_like(bit0, 63))
    w = torch.zeros_like(bit0)
    for step in range(33):  # the OR loop over the codes that overlap the word
        e = e0 + step
        use = valid & (e <= e1)
        z = torch.gather(zz, 1, (k.clamp(max=3) * 64 + e.clamp(max=63)))
        sh = e * bw - bit0
        part = torch.where(sh >= 0, (z << sh.clamp(min=0)) & MASK32, z >> (-sh).clamp(min=0))
        w = w | torch.where(use, part, torch.zeros_like(part))
    out = torch.full((cap,), SENTINEL, dtype=torch.int64)
    writes = torch.zeros(cap, dtype=torch.int64)
    g = base[:, None] + j
    keep = valid & (g < cap)
    out[g[keep]] = w[keep]
    writes.index_add_(0, g[keep], torch.ones_like(g[keep]))
    # the tail launch: scalar words up to the next 4-word boundary and past
    # the last one, 16-byte stores between
    mid = min((total + 3) & ~3, cap) if total < cap else cap
    end4 = max(mid, cap & ~3)
    assert mid % 4 == 0 or mid == cap
    for lo, hi in ((total, mid), (mid, end4), (end4, cap)):
        if lo < hi:
            out[lo:hi] = 0
            writes[lo:hi] += 1
    assert int(writes.max()) == 1 and int(writes.min()) == 1  # every word once
    return wrap_i32(out), desc, anchor, torch.tensor(total, dtype=torch.int32)


# ---------------------------------------------------------------------------
# The unpack kernels
# ---------------------------------------------------------------------------


def _unpack_replay(packed, desc, anchor, eb, acc, lossless, seed, mis):
    """Decode tile by tile from a staged segment; ``mis`` is the stream
    pointer's offset in words from a 16-byte boundary."""
    nb, cap = desc.shape[0], packed.shape[0]
    words = _block_words(desc)
    aggs = _tile_aggs(words, R)
    offsets, _, _ = _lookback(aggs, seed)
    pk = as_u32(packed)
    bw_k = entropy.split_desc(desc).to(torch.int64)
    sub_start = torch.cumsum(bw_k * entropy.SUB_WORDS_PER_BIT, 1) - bw_k * entropy.SUB_WORDS_PER_BIT
    lane = torch.arange(32)[:, None, None]
    part = torch.arange(2)[None, :, None]
    e = torch.arange(4)[None, None, :]
    k = (2 * part + lane // 16).expand(32, 2, 4)
    out = torch.empty(nb, 256, dtype=torch.float32)
    for t, off in enumerate(offsets):
        lo = ((off + mis) & ~3) - mis
        n4 = (off + aggs[t] - lo + 3) >> 2
        assert 4 * n4 <= R * 256 + 8  # seg_s
        idx = lo + torch.arange(4 * n4 + 1, dtype=torch.int64)
        seg = torch.where((idx >= 0) & (idx < cap), pk[idx.clamp(0, max(cap - 1, 0))],
                          torch.zeros_like(idx)) if cap else torch.zeros_like(idx)
        inner = 0
        for b in range(t * R, min((t + 1) * R, nb)):
            first = off - lo + inner
            inner += int(words[b])
            bw = bw_k[b][k]
            bit = (first + sub_start[b][k]) * 32 + (4 * (lane % 16) + e) * bw
            wi, sh = bit >> 5, bit & 31
            u = seg[wi] >> sh
            spill = (sh != 0) & (sh + bw > 32)
            u = u | torch.where(spill, (seg[(wi + 1).clamp(max=seg.numel() - 1)] << (32 - sh))
                                & MASK32, torch.zeros_like(u))
            u = u & ((torch.ones_like(bw) << bw) - 1)
            d = ((u >> 1) ^ -(u & 1)) & MASK32  # (lane, part, e)
            s = d.sum(dim=2)                    # each lane's sum per part
            inc = torch.cumsum(s, dim=0)        # warp inclusive scan per part
            run = anchor[b].item() + (inc - s)
            run[:, 1] += inc[31, 0]
            q = wrap_i32(run[:, :, None] + torch.cumsum(d, dim=2))  # (lane, part, e)
            q = q.permute(1, 0, 2).reshape(256)  # element 128 part + 4 lane + e
            if lossless:
                v = q.view(torch.float32)
                out[b] = v if acc is None else acc[b] + v
            else:
                qf = q.to(torch.float32)
                twoeb = ref.twoeb_of(eb)
                out[b] = qf * twoeb if acc is None else ref.fma_f32(qf, twoeb, acc[b])
    return out


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------


def _data(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        return np.cumsum(rng.normal(0, 0.01, n)).astype(np.float32)
    if kind == "rough":
        return rng.normal(0, 3.0, n).astype(np.float32)
    if kind == "zero-blocks":
        x = np.cumsum(rng.normal(0, 0.01, n)).astype(np.float32)
        x[: 40 * 256] = 0.0  # a tile and more of width-0 blocks
        x[50 * 256 + 64: 50 * 256 + 128] = x[50 * 256 + 63]
        return x
    if kind == "all-zero":
        return np.zeros(n, np.float32)
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)


N = 100 * 256 + 77  # 104 blocks after padding: 3 full tiles and a part-full one
EB = 1e-4
CASES = [  # (kind, lossless, capacity: "structural", "tile-edge", "in-tile" or "small")
    ("smooth", False, "structural"), ("rough", False, "structural"),
    ("zero-blocks", False, "structural"), ("random-bits", False, "structural"),
    ("all-zero", False, "structural"),
    ("smooth", True, "structural"), ("random-bits", True, "structural"),
    ("zero-blocks", True, "structural"),
    ("smooth", False, "tile-edge"), ("smooth", False, "in-tile"),
    ("random-bits", True, "tile-edge"), ("random-bits", True, "in-tile"),
    ("rough", False, "small"),
]


def _case(kind, lossless, capacity, seed):
    x = _data(kind, N, seed)
    x2d = ops.to_blocks(torch.from_numpy(x))
    eb = ops.as_eb(0.0 if lossless else EB, "cpu")
    structural = (compressor.lossless_capacity_words(N) if lossless
                  else max(int(N * 0.6), -(-N // 256), 8))
    if capacity == "structural":
        cap = structural
    else:
        words = _block_words(kentropy.quantize_pack_plain(x2d, eb, 8, lossless=lossless)[1])
        cut = int(words[: 2 * R].sum())  # the end of tile 1
        cap = {"tile-edge": cut, "in-tile": cut + int(words[2 * R]) // 2 + 3,
               "small": 64}[capacity]
    acc = torch.from_numpy(_data("rough", x2d.numel(), seed + 1)).view(-1, 256)
    return x, x2d, eb, cap, acc


@pytest.mark.parametrize("kind,lossless,capacity", CASES)
def test_pack_replay_bitwise_equals_plain(kind, lossless, capacity):
    seed = CASES.index((kind, lossless, capacity))
    _, x2d, eb, cap, _ = _case(kind, lossless, capacity, seed)
    got = _pack_replay(x2d, eb, cap, lossless, seed)
    want = kentropy.quantize_pack_plain(x2d, eb, cap, lossless=lossless)
    for name, g, w in zip(("packed", "desc", "anchor", "total"), got, want):
        assert torch.equal(g, w), name
    if capacity != "structural":
        assert int(want[3]) > cap  # the stream is cut inside or at the end of a tile
    if kind == "all-zero":
        assert int(want[3]) == 0


@pytest.mark.parametrize("mis", [0, 1, 2, 3])
@pytest.mark.parametrize("kind,lossless,capacity", CASES)
def test_unpack_replay_bitwise_equals_plain(kind, lossless, capacity, mis):
    seed = CASES.index((kind, lossless, capacity))
    _, x2d, eb, cap, acc = _case(kind, lossless, capacity, seed)
    packed, desc, anchor, _ = kentropy.quantize_pack_plain(x2d, eb, cap, lossless=lossless)
    for a in (None, acc):
        got = _unpack_replay(packed, desc, anchor, eb, a, lossless, seed + mis, mis)
        if a is None:
            want = kentropy.unpack_dequantize_plain(packed, desc, anchor, eb, lossless=lossless)
        else:
            want = kentropy.unpack_dequantize_reduce_plain(packed, desc, anchor, eb, a,
                                                           lossless=lossless)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_unpack_replay_part_full_tiles():
    """The unpack kernels take any block count: 45, 13 and 1 descriptors
    of a longer stream leave the last tile part-full."""
    _, x2d, eb, cap, acc = _case("rough", False, "structural", 99)
    packed, desc, anchor, _ = kentropy.quantize_pack_plain(x2d, eb, cap)
    for nb in (45, 13, 1):
        got = _unpack_replay(packed, desc[:nb], anchor[:nb], eb, acc[:nb], False, nb, 2)
        want = kentropy.unpack_dequantize_reduce_plain(packed, desc[:nb], anchor[:nb], eb,
                                                       acc[:nb])
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("kind,lossless,capacity", [
    ("smooth", False, "in-tile"), ("random-bits", True, "structural"),
    ("zero-blocks", False, "structural"),
])
def test_replays_bitwise_equal_pallas(kind, lossless, capacity):
    """The replays against the JAX package's Pallas kernels in interpret
    mode, on the same inputs."""
    seed = CASES.index((kind, lossless, capacity))
    x, x2d, eb, cap, acc = _case(kind, lossless, capacity, seed)
    jx2d = jops.to_blocks(jnp.asarray(x))
    jeb = float(eb)
    jpk, jdesc, jan = jops.entropy_quantize_pack(jx2d, jeb, cap, lossless=lossless)
    packed, desc, anchor, _ = _pack_replay(x2d, eb, cap, lossless, seed)
    for g, w in ((packed, jpk), (desc, jdesc), (anchor, jan)):
        assert np.array_equal(g.numpy(), np.asarray(w).view(np.int32))
    jacc = jops.to_blocks(jnp.asarray(acc.reshape(-1).numpy()))
    jout = jops.entropy_unpack_dequantize_reduce(jpk, jdesc, jan, jeb, jacc, lossless=lossless)
    got = _unpack_replay(packed, desc, anchor, eb, acc, lossless, seed, 0)
    assert np.array_equal(got.view(torch.int32).numpy(), np.asarray(jout).view(np.int32))


# ---------------------------------------------------------------------------
# The total
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,lossless,capacity", CASES)
def test_total_equals_packed_words(kind, lossless, capacity):
    """``quantize_pack`` returns the stream's true length beside the
    stream; on the CPU path it is ``packed_words(desc)``, also past the
    capacity, and ``EntropyLorenzo.compress`` carries it as ``nwords``."""
    seed = CASES.index((kind, lossless, capacity))
    x, x2d, eb, cap, _ = _case(kind, lossless, capacity, seed)
    _, desc, _, total = ops.entropy_quantize_pack(x2d, eb, cap, lossless=lossless)
    assert total.dtype == torch.int32 and total.shape == ()
    assert int(total) == int(entropy.packed_words(desc))
    for fused in (True, False):
        codec = compressor.EntropyLorenzo(lossless=lossless, fused=fused)
        c = codec.compress(torch.from_numpy(x), eb)
        assert torch.equal(c.nwords, entropy.packed_words(c.bitwidth))
