"""Kernels 3 and 4 (``unpack_dequantize_reduce`` and ``unpack_dequantize``,
one template ``ud_lookback_kernel`` in
``src/repro_torch/kernels/csrc/lorenzo.cu``) replayed in torch on the CPU.

The CUDA kernel runs only on the card.  It is the ring hop's receive half
alone, so its replay is built from ``tests/test_torch_hop.py``'s helpers:

* ``_walk``: one launch's tiles, drawn in start order, each running one
  decoupled look-back of ``csrc/lorenzo_common.cuh`` on its 8 * sum(bw),
  under seeded and worst-case schedules with at most ``resident`` tiles in
  flight and stale state words of an earlier epoch;
* ``_receive``: the tile's staged segment (from the 16-byte boundary at or
  below its first word, at a stream pointer 0, 1, 2 or 3 words off that
  boundary; words outside [0, cap) read 0), the lane layout (lane l
  decodes elements 4l..4l+3 and 128+4l..128+4l+3) and the two-part warp
  scan;
* the last step: acc + q * 2eb rounded once (``ref.fma_f32``, kernel 3)
  or q * 2eb (kernel 4); every block is written by exactly one tile.

The f32 outputs must be bitwise ``unpack_dequantize{,_reduce}_plain``'s, at
8, 32, 40, 72 and 264 blocks, on smooth, all-zero, NaN/Inf/saturating and
full-width random inputs, with capacities ample, on a tile boundary,
inside a tile and far below the stream (a cut stream reads 0 past its
capacity); with NaNs in ``acc`` kernel 3 gives acc's NaN, quieted; for a
few small cases also the Pallas kernels' in interpret mode.  The C
prototype of ``lz_unpack_dequantize`` matches its ``ctypes`` signature, and
the wrapper refuses 0 blocks, too many elements and CPU tensors.
Tolerance everywhere: bitwise.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import lorenzo, ops, ref
from repro_torch.kernels.ref import as_u32
from test_torch_hop import R, _prototypes, _receive, _walk
from test_torch_pack import EB, _data, _nan_acc, _tile_cap

KERNELS = ("unpack_dequantize", "unpack_dequantize_reduce")


# ---------------------------------------------------------------------------
# The replay
# ---------------------------------------------------------------------------


def _ud_replay(stream, eb, acc, *, seed, worst=False, resident=None, mis=0):
    """The kernel's tile walk: f32 (nb, 256), kernel 3 with ``acc``, kernel
    4 without."""
    packed, bw, anchor = stream
    nb, cap = bw.shape[0], packed.shape[0]
    pk = as_u32(packed)
    padded = torch.zeros(-(-nb // R) * R, dtype=torch.int64)
    padded[:nb] = 8 * bw.to(torch.int64)
    aggs = padded.view(-1, R).sum(dim=1).tolist()
    twoeb = ref.twoeb_of(eb)
    out = torch.empty(nb, 256, dtype=torch.float32)
    writes = torch.zeros(nb, dtype=torch.int64)

    def body(t, off):
        blocks = slice(t * R, min((t + 1) * R, nb))
        q = _receive(pk, cap, bw[blocks], anchor[blocks], off, mis).to(torch.float32)
        out[blocks] = q * twoeb if acc is None else ref.fma_f32(q, twoeb, acc[blocks])
        writes[blocks] += 1
        return None  # one look-back: the tile ends after it

    offs, _, total, _ = _walk(aggs, body, seed, worst=worst, resident=resident)
    assert offs == np.concatenate([[0], np.cumsum(aggs)[:-1]]).tolist()
    assert total == sum(aggs) and bool((writes == 1).all())
    return out


def _case(nb, kind, cap_kind, seed):
    """(stream cut at the capacity, acc, eb): the stream packs ``kind``
    data at EB; acc is a smooth walk (all zero with all-zero data)."""
    x2d = torch.from_numpy(_data(kind, nb * 256, seed)).view(nb, 256)
    acc = torch.from_numpy(_data("zero" if kind == "zero" else "smooth", nb * 256, seed + 1))
    eb = ops.as_eb(EB, "cpu")
    cap = _tile_cap(lorenzo.quantize_pack_plain(x2d, eb, 8)[1], cap_kind)
    return lorenzo.quantize_pack_plain(x2d, eb, cap)[:3], acc.view(nb, 256), eb


def _plain(kernel, stream, eb, acc):
    if kernel == "unpack_dequantize":
        return lorenzo.unpack_dequantize_plain(*stream, eb)
    return lorenzo.unpack_dequantize_reduce_plain(*stream, eb, acc)


def _replay(kernel, stream, eb, acc, **kw):
    return _ud_replay(stream, eb, acc if kernel == "unpack_dequantize_reduce" else None, **kw)


def _bits(x):
    return x.view(torch.int32)


CASES = [  # (nb, data kind, capacity)
    (8, "smooth", "ample"),         # one part-full tile
    (32, "smooth", "ample"),        # one full tile
    (40, "smooth", "ample"),        # part-full last tiles
    (72, "smooth", "ample"),
    (264, "smooth", "ample"),       # 9 tiles: a window steps back
    (72, "smooth", "on-tile"),      # the stream cut on tile 0's last word
    (72, "smooth", "in-tile"),      # ... inside tile 1
    (32, "smooth", "in-tile"),      # ... inside the only tile
    (32, "smooth", "on-tile"),
    (40, "smooth", "small"),        # cut far below the stream
    (40, "zero", "ample"),          # all-zero widths: an empty stream
    (72, "wild", "ample"),          # NaN (q = 0), +-Inf and saturating q
    (40, "random-bits", "ample"),   # full-width random bits
    (72, "random-bits", "in-tile"),
]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("nb,kind,cap_kind", CASES)
def test_ud_replay_bitwise_equals_plain(nb, kind, cap_kind, kernel):
    seed = CASES.index((nb, kind, cap_kind))
    stream, acc, eb = _case(nb, kind, cap_kind, seed)
    want = _plain(kernel, stream, eb, acc)
    got = _replay(kernel, stream, eb, acc, seed=seed, mis=seed % 4)
    assert got.shape == want.shape == (nb, 256)
    assert torch.equal(_bits(got), _bits(want))
    words = 8 * int(stream[1].to(torch.int64).sum())
    assert (words > stream[0].shape[0]) == (cap_kind != "ample")
    if kind == "zero":
        assert words == 0 and not bool(got.any())
    if kind == "random-bits":
        assert int(stream[1].max()) == 32


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("seed,worst,resident,mis", [
    (0, False, None, 0), (1, False, 2, 1), (2, True, None, 2), (3, True, 3, 3),
    (4, False, 1, 0),   # one tile in flight: strictly in start order
])
def test_ud_replay_under_schedules(seed, worst, resident, mis, kernel):
    """The look-back under random and worst orders, few resident tiles,
    stale state words, every stream alignment; 72 blocks cut inside tile 1,
    and 264 blocks (9 tiles) so that a window steps back."""
    for nb, cap_kind in ((72, "in-tile"), (264, "ample")):
        stream, acc, eb = _case(nb, "smooth", cap_kind, 40 + seed)
        got = _replay(kernel, stream, eb, acc, seed=seed, worst=worst, resident=resident,
                      mis=mis)
        assert torch.equal(_bits(got), _bits(_plain(kernel, stream, eb, acc)))


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("mis", [0, 1, 2, 3])
def test_ud_replay_at_every_alignment(mis, kernel):
    """The staging from the 16-byte boundary at or below each tile's first
    word, for a stream pointer ``mis`` words past a boundary, on a stream
    cut on a tile boundary and one of full-width random bits."""
    for nb, kind, cap_kind in ((72, "smooth", "on-tile"), (40, "random-bits", "ample")):
        stream, acc, eb = _case(nb, kind, cap_kind, 50 + mis)
        for seed in (mis, mis + 10):
            got = _replay(kernel, stream, eb, acc, seed=seed, worst=seed > 9, mis=mis)
            assert torch.equal(_bits(got), _bits(_plain(kernel, stream, eb, acc)))


@pytest.mark.parametrize("nb,worst", [(40, False), (72, True)])
def test_ud_replay_nan_acc(nb, worst):
    """Kernel 3 with signalling NaNs and NaNs carrying payloads (and +-Inf)
    in acc: bitwise the plain version, every NaN of acc out as itself,
    quieted."""
    stream, _, eb = _case(nb, "smooth", "ample", 60 + nb)
    acc = torch.from_numpy(_nan_acc(nb, nb))
    got = _ud_replay(stream, eb, acc, seed=nb, worst=worst, mis=nb % 4)
    assert torch.equal(_bits(got), _bits(lorenzo.unpack_dequantize_reduce_plain(*stream, eb,
                                                                                 acc)))
    nan = torch.isnan(acc)
    assert int(nan.sum()) > 0
    assert torch.equal(_bits(got)[nan], _bits(acc)[nan] | 0x00400000)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("nb,kind,cap_kind", [(40, "smooth", "in-tile"),
                                              (16, "random-bits", "ample"),
                                              (8, "wild", "ample")])
def test_ud_replay_bitwise_equals_pallas(nb, kind, cap_kind, kernel):
    """The replay against the JAX package's Pallas kernel in interpret mode,
    on the same inputs."""
    stream, acc, eb = _case(nb, kind, cap_kind, 70)
    got = _replay(kernel, stream, eb, acc, seed=70, mis=2)
    args = (jnp.asarray(stream[0].numpy().view(np.uint32)), jnp.asarray(stream[1].numpy()),
            jnp.asarray(stream[2].numpy()), EB)
    if kernel == "unpack_dequantize":
        want = jops.unpack_dequantize(*args)
    else:
        want = jops.unpack_dequantize_reduce(*args, jnp.asarray(acc.numpy()))
    assert np.array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


# ---------------------------------------------------------------------------
# The wrapper and the C entry point
# ---------------------------------------------------------------------------


def test_unpack_dequantize_prototype():
    """``lz_unpack_dequantize``'s C parameters, one by one, against the
    ctypes signature the wrapper launches it with: the look-back state,
    counter and epoch after the output, the stream last; no offsets."""
    params = _prototypes("lorenzo.cu")["lz_unpack_dequantize"]
    assert params == ["const uint32_t*", "long long", "const int32_t*", "const int32_t*",
                      "int", "const float*", "const float*", "float*",
                      "unsigned long long*", "unsigned int*", "unsigned int", "cudaStream_t"]
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert lorenzo._SIGNATURES["lz_unpack_dequantize"] == (p, ll, p, p, i, p, p, p, p, p, i, p)


@pytest.mark.parametrize("kernel", KERNELS)
def test_unpack_wrapper_refuses_what_the_kernel_does_not_take(kernel):
    """0 blocks and nb * 256 >= 2**31 elements raise ``ValueError`` before
    anything is launched, and so does a CPU tensor (the plain version is
    the CPU path, chosen by ``ops``)."""
    stream, acc, eb = _case(8, "smooth", "ample", 80)
    extra = (acc,) if kernel == "unpack_dequantize_reduce" else ()
    fn = getattr(lorenzo, kernel)
    empty = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="no blocks"):
        fn(stream[0], empty, empty, eb, *((torch.zeros(0, 256),) if extra else ()))
    huge = torch.zeros(1, dtype=torch.int32).expand(2**23)
    with pytest.raises(ValueError, match="exceed"):
        fn(stream[0], huge, huge, eb, *extra)
    with pytest.raises(ValueError, match="CUDA"):
        fn(*stream, eb, *extra)
    via_ops = getattr(ops, kernel)(*stream, eb, *extra)
    assert torch.equal(_bits(via_ops), _bits(_plain(kernel, stream, eb, acc)))
