"""Kernel 1 (``quantize_pack`` in ``src/repro_torch/kernels/csrc/lorenzo.cu``)
replayed in torch on the CPU, and the reduces of kernels 3, 7 and 10 on a
NaN in ``acc``.

The CUDA kernel runs only on the card.  It is the ring hop's send half
alone, so its replay is built from ``tests/test_torch_hop.py``'s helpers:

* ``_walk``: one launch's tiles, drawn in start order, each running one
  decoupled look-back of ``csrc/lorenzo_common.cuh`` on its 8 * sum(bw),
  under seeded and worst-case schedules with at most ``resident`` tiles in
  flight and stale state words of an earlier epoch;
* ``_encode``: the quantize (``__float2int_rn(__fmul_rn(x, recip))``) and
  the lane layout's shuffled Lorenzo deltas and whole-warp maximum, the
  codes in skewed shared rows, the anchor lane 0's q[0];
* ``_pack_in_place``: lane r of a block's eight packs codes 32r..32r+31
  into words bw*r..bw*r+bw-1;
* ``_copy_out``: each block's words below the capacity, then the tail
  launch's zeroing of [total, cap); every word below it written once.

Stream words, widths, anchors and the total must be bitwise
``quantize_pack_plain``'s, at 8, 32, 40, 72 and
264 blocks, with capacities on a tile boundary, inside a tile and far
below the stream, on smooth, all-zero, NaN/Inf/saturating and full-width
random inputs; for a few small cases also the Pallas kernel's in
interpret mode.  The total through ``ops.quantize_pack`` and
``Compressed.nwords`` is ``bitpack.packed_words``; the C prototype of
``lz_quantize_pack`` matches its ``ctypes`` signature.

The reduces: the plain versions of kernels 3 (``unpack_dequantize_reduce``),
7 (``dequantize_reduce``) and 10 (entropy ``unpack_dequantize_reduce``,
lossy and lossless) give the JAX package's f32 bits when ``acc`` holds
signalling NaNs and NaNs with payloads (lossless also with NaN values and
inf - inf), which the CUDA kernels follow (``fma_acc``, ``add_acc``).
Tolerance everywhere: bitwise.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import bitpack, compressor
from repro_torch.core.compressed import capacity_words_for
from repro_torch.kernels import entropy as kentropy
from repro_torch.kernels import lorenzo, ops, ref
from test_torch_hop import R, _copy_out, _encode, _pack_in_place, _prototypes, _walk

EB = 1e-4


# ---------------------------------------------------------------------------
# The replay
# ---------------------------------------------------------------------------


def _qp_replay(x2d, eb, cap, *, seed, worst=False, resident=None):
    """Kernel 1's tile walk and tail launch: (packed, bw, anchor, total), as
    ``quantize_pack_plain`` returns them."""
    nb = x2d.shape[0]
    q = ref.f32_to_i32_rn(x2d * ref.recip_of(eb))
    rows, bw, anchor = _encode(q)
    words = _pack_in_place(rows, bw)  # each warp packs while its tile looks back
    padded = torch.zeros(-(-nb // R) * R, dtype=torch.int64)
    padded[:nb] = 8 * bw.to(torch.int64)
    aggs = padded.view(-1, R).sum(dim=1).tolist()
    offs, _, total, _ = _walk(aggs, lambda t, off: None, seed, worst=worst,
                              resident=resident)
    assert total == offs[-1] + aggs[-1]  # written by the tile with the last block
    out = _copy_out(offs, words, bw, cap, total)
    return out, bw, anchor, torch.tensor(total, dtype=torch.int32)


def _data(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        return (np.cumsum(rng.normal(0, 0.01, n)) * 8.0).astype(np.float32)
    if kind == "zero":
        return np.zeros(n, np.float32)
    if kind == "wild":  # NaN, +-Inf and values whose q passes the int32 range
        x = (np.cumsum(rng.normal(0, 0.01, n)) * 100.0).astype(np.float32)
        x[::97], x[5::89], x[7::83] = np.nan, np.inf, -np.inf
        x[11::79], x[13::71] = 5e5, -1e30
        return x
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)


def _tile_cap(bw, kind):
    """Capacities: "ample" (never overflows), "on-tile" (the stream's words
    through tile 0, or all of a one-tile stream, minus one), "in-tile"
    (inside tile 1, or tile 0 of a one-tile stream), "small" (64 words)."""
    w = (8 * bw.to(torch.int64)).tolist()
    if kind == "ample":
        return capacity_words_for(len(w) * 256, 2.0, 256)
    if kind == "small":
        return 64
    lo = R if len(w) > R else 0
    if kind == "on-tile":
        return sum(w[:R]) if len(w) > R else sum(w) - 1
    first = next(x for x in w[lo:] if x)
    return sum(w[:lo]) + first // 2 + 1


def _case(nb, kind, cap_kind, seed):
    x2d = torch.from_numpy(_data(kind, nb * 256, seed)).view(nb, 256)
    eb = ops.as_eb(EB, "cpu")
    bw = lorenzo.quantize_pack_plain(x2d, eb, 8)[1]
    return x2d, eb, _tile_cap(bw, cap_kind)


CASES = [  # (nb, data kind, capacity)
    (8, "smooth", "ample"),         # one part-full tile
    (32, "smooth", "ample"),        # one full tile
    (40, "smooth", "ample"),        # part-full last tiles
    (72, "smooth", "ample"),
    (264, "smooth", "ample"),       # 9 tiles: a window steps back
    (72, "smooth", "on-tile"),      # the capacity on tile 0's last word
    (72, "smooth", "in-tile"),      # ... inside tile 1
    (32, "smooth", "in-tile"),      # ... inside the only tile
    (32, "smooth", "on-tile"),
    (40, "smooth", "small"),        # overflowing far
    (40, "zero", "ample"),          # all-zero widths: an empty stream
    (72, "wild", "ample"),          # NaN (q = 0), +-Inf and saturating q
    (40, "random-bits", "ample"),   # full-width random bits
    (72, "random-bits", "in-tile"),
]


def _check(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                           w.view(torch.int32) if w.dtype == torch.float32 else w), \
            f"output {i}"


@pytest.mark.parametrize("nb,kind,cap_kind", CASES)
def test_qp_replay_bitwise_equals_plain(nb, kind, cap_kind):
    seed = CASES.index((nb, kind, cap_kind))
    x2d, eb, cap = _case(nb, kind, cap_kind, seed)
    want = lorenzo.quantize_pack_plain(x2d, eb, cap)
    _check(_qp_replay(x2d, eb, cap, seed=seed), want)
    total = int(want[-1])
    assert total == int(bitpack.packed_words(want[1], 256))
    assert (total > cap) == (cap_kind != "ample")
    if kind == "zero":
        assert total == 0 and not bool(want[0].any())
    if kind == "random-bits":
        assert int(want[1].max()) == 32


@pytest.mark.parametrize("seed,worst,resident", [
    (0, False, None), (1, False, 2), (2, True, None), (3, True, 3),
    (4, False, 1),  # one tile in flight: strictly in start order
])
def test_qp_replay_under_schedules(seed, worst, resident):
    """The look-back under random and worst orders, few resident tiles and
    stale state words; 72 blocks cut inside tile 1, and 264 blocks (9
    tiles) so that a window steps back."""
    for nb, cap_kind in ((72, "in-tile"), (264, "ample")):
        x2d, eb, cap = _case(nb, "smooth", cap_kind, 20 + seed)
        want = lorenzo.quantize_pack_plain(x2d, eb, cap)
        _check(_qp_replay(x2d, eb, cap, seed=seed, worst=worst, resident=resident), want)


@pytest.mark.parametrize("nb,kind,cap_kind", [(40, "smooth", "in-tile"),
                                              (16, "random-bits", "ample"),
                                              (8, "wild", "ample")])
def test_qp_replay_bitwise_equals_pallas(nb, kind, cap_kind):
    """The replay against the JAX package's Pallas kernel in interpret mode,
    on the same inputs."""
    x2d, eb, cap = _case(nb, kind, cap_kind, 30)
    got = _qp_replay(x2d, eb, cap, seed=30)
    jres = jops.quantize_pack(jnp.asarray(x2d.numpy()), EB, cap)
    for g, w in zip(got, jres):
        assert np.array_equal(g.numpy().view(np.int32), np.asarray(w).view(np.int32))


# ---------------------------------------------------------------------------
# The total through the wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap_kind", ["ample", "small"])
def test_quantize_pack_total_and_compressor_nwords(cap_kind):
    """``ops.quantize_pack`` returns the total last, and the fused
    compressor carries it as ``nwords``: ``packed_words(bw)``, overflow
    included, as the two-pass path's."""
    x2d, eb, cap = _case(40, "smooth", cap_kind, 11)
    res = ops.quantize_pack(x2d, eb, cap)
    assert len(res) == 4 and res[-1].dtype == torch.int32 and res[-1].shape == ()
    assert torch.equal(res[-1], bitpack.packed_words(res[1], 256))
    assert (int(res[-1]) > cap) == (cap_kind == "small")
    codes, bw, anchor = ops.quantize(x2d, eb)  # the two-pass path
    packed, total = bitpack.pack(codes, bw, cap)
    _check(res, (packed, bw, anchor, total))
    cf = 0.6 if cap_kind == "ample" else 0.02
    outs = [compressor.ErrorBoundedLorenzo(capacity_factor=cf, fused=fused)
            .compress(x2d.reshape(-1), EB) for fused in (True, False)]
    for c in outs:
        assert c.nwords.dtype == torch.int32
        assert torch.equal(c.nwords, bitpack.packed_words(c.bitwidth, 256))
        assert bool(c.overflowed()) == (cap_kind == "small")
    _check((outs[0].packed, outs[0].nwords), (outs[1].packed, outs[1].nwords))


def test_quantize_pack_prototype():
    """``lz_quantize_pack``'s C parameters, one by one, against the ctypes
    signature the wrapper launches it with: the look-back state, counter
    and epoch after the total, the stream last."""
    params = _prototypes("lorenzo.cu")["lz_quantize_pack"]
    assert params == ["const float*", "int", "const float*", "uint32_t*", "long long",
                      "int32_t*", "int32_t*", "int32_t*", "unsigned long long*",
                      "unsigned int*", "unsigned int", "cudaStream_t"]
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert lorenzo._SIGNATURES["lz_quantize_pack"] == (p, i, p, p, ll, p, p, p, p, p, i, p)


def test_quantize_pack_wrapper_takes_cuda_only():
    """The kernel wrapper refuses a CPU tensor (the plain version is the
    CPU path, chosen by ``ops``), which returns the total as the kernel
    does."""
    x2d, eb, cap = _case(8, "smooth", "ample", 12)
    with pytest.raises(ValueError, match="CUDA"):
        lorenzo.quantize_pack(x2d, eb, cap)
    assert len(ops.quantize_pack(x2d, EB, cap)) == 4


# ---------------------------------------------------------------------------
# NaN in acc: kernels 3, 7 and 10's plain versions against the JAX package
# ---------------------------------------------------------------------------

NAN_BITS = np.array([0x7F800001, 0xFF800001, 0x7FA5A5A5, 0xFFBFFFFF,  # signalling
                     0x7FC00000, 0xFFC00000, 0x7FC12345, 0xFFE00ABC,  # quiet, payloads
                     0x7FFFFFFF], np.uint32)


def _nan_acc(nb, seed):
    """A smooth acc with the NaNs of ``NAN_BITS`` every few elements, and
    +-Inf beside them."""
    rng = np.random.default_rng(seed)
    acc = np.cumsum(rng.normal(0, 0.01, nb * 256)).astype(np.float32)
    bits = acc.view(np.uint32)
    idx = rng.choice(nb * 256, 3 * NAN_BITS.size, replace=False)
    bits[idx[: 2 * NAN_BITS.size]] = np.tile(NAN_BITS, 2)
    acc[idx[2 * NAN_BITS.size:]] = np.where(np.arange(NAN_BITS.size) % 2, np.inf, -np.inf)
    return acc.reshape(nb, 256)


def _jax_plain_nan(kernel, nb, seed):
    """(JAX's output bits, the plain version's) on one NaN-laden acc."""
    acc = _nan_acc(nb, seed)
    rng = np.random.default_rng(seed + 1)
    x = np.cumsum(rng.normal(0, 0.01, nb * 256)).astype(np.float32).reshape(nb, 256)
    acc_t, x_t, acc_j = torch.from_numpy(acc), torch.from_numpy(x), jnp.asarray(acc)
    eb = ops.as_eb(EB, "cpu")
    if kernel == "unpack_dequantize_reduce":  # kernel 3
        pk, bw, an, _ = lorenzo.quantize_pack_plain(x_t, eb, 8 * nb * 256)
        want = jops.unpack_dequantize_reduce(jnp.asarray(pk.numpy().view(np.uint32)),
                                             jnp.asarray(bw.numpy()), jnp.asarray(an.numpy()),
                                             EB, acc_j)
        got = lorenzo.unpack_dequantize_reduce_plain(pk, bw, an, eb, acc_t)
    elif kernel == "dequantize_reduce":  # kernel 7
        codes, _, an = lorenzo.quantize_plain(x_t, eb)
        want = jops.dequantize_reduce(jnp.asarray(codes.numpy().view(np.uint32)),
                                      jnp.asarray(an.numpy()), EB, acc_j)
        got = lorenzo.dequantize_reduce_plain(codes, an, eb, acc_t)
    else:  # kernel 10; lossless values carry NaNs and +-Inf of their own
        lossless = kernel.endswith("lossless")
        if lossless:  # NaN values of their own, both NaN, and inf - inf
            x = _nan_acc(nb, seed + 2)
            both = np.flatnonzero(np.isnan(acc))[::2]
            x.flat[both] = np.uint32(0x7FA00001).view(np.float32)
            infs = np.isinf(acc)
            x[infs] = -acc[infs]
            x_t = torch.from_numpy(x)
        pk, desc, an, _ = kentropy.quantize_pack_plain(x_t, eb, 8 * nb * 256,
                                                       lossless=lossless)
        want = jops.entropy_unpack_dequantize_reduce(
            jnp.asarray(pk.numpy().view(np.uint32)), jnp.asarray(desc.numpy()),
            jnp.asarray(an.numpy()), EB, acc_j, lossless=lossless)
        got = kentropy.unpack_dequantize_reduce_plain(pk, desc, an, eb, acc_t,
                                                      lossless=lossless)
    return np.asarray(want).view(np.uint32), got.numpy().view(np.uint32), acc, x


@pytest.mark.parametrize("kernel", ["unpack_dequantize_reduce", "dequantize_reduce",
                                    "entropy_unpack_dequantize_reduce",
                                    "entropy_unpack_dequantize_reduce/lossless"])
def test_nan_acc_plain_bitwise_equals_jax(kernel):
    """Every f32 output bit-equal to the JAX package's when acc holds
    signalling NaNs and NaNs with payloads: a NaN comes out as acc's,
    quieted (lossless: the value's where it is NaN too, and 0xFFC00000 for
    inf - inf)."""
    want, got, acc, x = _jax_plain_nan(kernel, 16, len(kernel))
    assert np.array_equal(got, want), f"{int((got != want).sum())} differ"
    nan = np.isnan(acc)
    assert nan.sum() == 2 * NAN_BITS.size
    only = nan & ~np.isnan(x)
    np.testing.assert_array_equal(got[only], acc.view(np.uint32)[only] | 0x00400000)
    if kernel.endswith("lossless"):  # the other NaN cases occur too
        both = np.isnan(x) & nan
        inf_inf = np.isinf(acc) & (x == -acc)
        assert both.any() and inf_inf.any() and (np.isnan(x) & ~nan).any()
        np.testing.assert_array_equal(got[both], x.view(np.uint32)[both] | 0x00400000)
        assert (got[inf_inf] == 0xFFC00000).all()
