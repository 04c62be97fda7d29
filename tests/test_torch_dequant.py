"""Kernels 6 and 7 (``dequantize`` and ``dequantize_reduce``, one template
``dq_tile_kernel`` in ``src/repro_torch/kernels/csrc/lorenzo.cu``)
replayed in torch on the CPU.

The CUDA kernel runs only on the card.  Its replay here follows its
layout:

* one CTA per tile of 8 * wb blocks, in any order (no look-back: the
  codes sit at fixed offsets); warp w of a tile takes blocks w, w + 8, ..,
  w + 8 (wb - 1) and stops at the last block, warp-uniformly; wb is 4
  from ``kWideRows`` rows on, else 1;
* lane l owns elements 4l..4l+3 and 128+4l..128+4l+3 of each of its
  blocks and reads them as two 16-byte pieces; a warp reads every one of
  its blocks' codes (and acc, kernel 7) before it scans any, from buffers
  that start 0-3 words past a 16-byte boundary;
* un-zigzag and the two-part warp scan plus the anchor
  (``test_torch_hop._unzigzag_scan``, the replay of ``scan_block``), then
  q * 2eb (kernel 6) or acc + q * 2eb rounded once (``ref.fma_f32``,
  kernel 7); every block is written by exactly one warp.

The f32 outputs must be bitwise ``dequantize{,_reduce}_plain``'s at 1, 7,
31, 32, 33, 72 and 264 blocks, with 4 and 1 blocks a warp, on the codes
of smooth data, all-zero codes
and full-range codes whose prefix sum wraps in int32; kernel 7 with
signalling NaNs and NaNs carrying payloads in ``acc``, compared by bits;
at small sizes also the Pallas kernels' in interpret mode.  The C
prototype of ``lz_dequantize`` matches its ``ctypes`` signature, and the
wrapper refuses 0 rows, a wrong dtype or shape, and CPU tensors.
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
from test_torch_hop import CSRC, R, _lanes, _prototypes, _unzigzag_scan
from test_torch_pack import EB, NAN_BITS, _nan_acc

KERNELS = ("dequantize", "dequantize_reduce")
WARPS = 8  # kTileThreads / 32
WARP_BLOCKS = R // WARPS  # kWarpBlocks
WIDE_ROWS = 4 * 132 * R  # kWideRows


def _warp_blocks(nb):
    """``lz_dequantize``'s blocks a warp for nb rows."""
    return WARP_BLOCKS if nb >= WIDE_ROWS else 1


# ---------------------------------------------------------------------------
# The replay
# ---------------------------------------------------------------------------


def _dq_replay(codes, anchor, eb, acc=None, *, mis=0, seed=0, wb=None):
    """The kernel's launch: f32 (nb, 256), kernel 7 with ``acc``, kernel 6
    without, with ``wb`` blocks a warp (by default ``lz_dequantize``'s).
    ``codes`` and ``acc`` are read from flat buffers ``mis`` words past a
    16-byte boundary; the tiles, and the warps inside each, run in an
    order drawn from ``seed``."""
    nb = codes.shape[0]
    n = nb * 256
    cbuf = torch.zeros(n + 4, dtype=torch.int64)
    cbuf[mis: mis + n] = as_u32(codes).reshape(-1)
    if acc is not None:
        abuf = torch.zeros(n + 4, dtype=torch.float32)
        abuf[mis: mis + n] = acc.reshape(-1)
    twoeb = ref.twoeb_of(eb)
    out = torch.full((nb, 256), float("nan"), dtype=torch.float32)
    writes = torch.zeros(nb, dtype=torch.int64)
    lanes = _lanes()                                       # (part, lane, e)
    assert bool((lanes[..., 0] % 4 == 0).all())            # 16-byte pieces in a row
    rng = np.random.default_rng(seed)
    wb = _warp_blocks(nb) if wb is None else wb
    assert 1 <= wb <= WARP_BLOCKS
    tiles = -(-nb // (WARPS * wb))                         # the grid
    for t in rng.permutation(tiles).tolist():
        for w in rng.permutation(WARPS).tolist():
            blocks = []
            for i in range(wb):
                b = t * WARPS * wb + w + WARPS * i
                if b >= nb:  # warp-uniform; later steps are further on
                    break
                blocks.append(b)
            if not blocks:
                continue
            bt = torch.tensor(blocks)
            idx = mis + bt[:, None, None, None] * 256 + lanes[None]  # (block, part, lane, e)
            u = cbuf[idx]                                   # every load first
            a = abuf[idx].reshape(-1, 256) if acc is not None else None
            q = _unzigzag_scan(u, anchor[bt]).to(torch.float32)
            out[bt] = q * twoeb if acc is None else ref.fma_f32(q, twoeb, a)
            writes[bt] += 1
    assert bool((writes == 1).all())
    return out


def _codes(nb, kind, seed):
    """(codes int32 carrying uint32 bits, anchor int32): the unfused
    quantizer's output on smooth data, all-zero codes with random anchors,
    or full-range codes and anchors (the prefix sum wraps in int32)."""
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        x = (np.cumsum(rng.normal(0, 0.01, nb * 256)) * 8.0).astype(np.float32)
        codes, _, anchor = lorenzo.quantize_plain(torch.from_numpy(x).view(nb, 256),
                                                  ops.as_eb(EB, "cpu"))
        return codes, anchor
    anchor = torch.from_numpy(rng.integers(-2**31, 2**31, nb, dtype=np.int64)
                              .astype(np.int32))
    if kind == "zero":
        return torch.zeros((nb, 256), dtype=torch.int32), anchor
    codes = rng.integers(0, 2**32, (nb, 256), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(codes.view(np.int32)), anchor


def _acc(nb, kind, seed):
    """A smooth acc (+-1e6 under wrapping codes, whose values are large)."""
    rng = np.random.default_rng(seed + 1000)
    scale = 1e6 if kind == "wrap" else 1.0
    return torch.from_numpy((np.cumsum(rng.normal(0, 0.01, nb * 256)) * scale)
                            .astype(np.float32)).view(nb, 256)


def _plain(kernel, codes, anchor, eb, acc):
    if kernel == "dequantize":
        return lorenzo.dequantize_plain(codes, anchor, eb)
    return lorenzo.dequantize_reduce_plain(codes, anchor, eb, acc)


def _replay(kernel, codes, anchor, eb, acc, **kw):
    return _dq_replay(codes, anchor, eb, acc if kernel == "dequantize_reduce" else None, **kw)


def _bits(x):
    return x.view(torch.int32)


NBS = (1, 7, 31, 32, 33, 72, 264)  # one part-full tile .. 9 tiles, part-full last ones
KINDS = ("smooth", "zero", "wrap")


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("wb", [WARP_BLOCKS, 1])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nb", NBS)
def test_dq_replay_bitwise_equals_plain(nb, kind, wb, kernel):
    seed = 10 * NBS.index(nb) + KINDS.index(kind)
    codes, anchor = _codes(nb, kind, seed)
    acc, eb = _acc(nb, kind, seed), ops.as_eb(EB, "cpu")
    want = _plain(kernel, codes, anchor, eb, acc)
    got = _replay(kernel, codes, anchor, eb, acc, mis=seed % 4, seed=seed, wb=wb)
    assert got.shape == want.shape == (nb, 256)
    assert torch.equal(_bits(got), _bits(want))
    if kind == "wrap":  # the prefix sum wraps in int32 in nearly every block
        d = ref._unzigzag(as_u32(codes))
        q = anchor.to(torch.int64)[:, None] + torch.cumsum(d, dim=1)
        assert int(((q < -2**31) | (q >= 2**31)).any(dim=1).sum()) >= nb * 0.9
    if kind == "zero" and kernel == "dequantize":  # constant rows: the anchor's value
        assert torch.equal(got, got[:, :1].expand(nb, 256))


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("mis", [0, 1, 2, 3])
def test_dq_replay_at_every_alignment(mis, kernel):
    """``codes`` and ``acc`` 0-3 words past a 16-byte boundary (``load4``
    falls back to 4-byte loads there), 40 smooth and 72 wrapping blocks,
    two orders each."""
    eb = ops.as_eb(EB, "cpu")
    for nb, kind in ((40, "smooth"), (72, "wrap")):
        codes, anchor = _codes(nb, kind, 50 + mis)
        acc = _acc(nb, kind, 50 + mis)
        want = _plain(kernel, codes, anchor, eb, acc)
        for seed, wb in ((mis, WARP_BLOCKS), (mis + 10, 1)):
            got = _replay(kernel, codes, anchor, eb, acc, mis=mis, seed=seed, wb=wb)
            assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("nb", [1, 33, 72])
def test_dq_replay_nan_acc(nb):
    """Kernel 7 with signalling NaNs and NaNs carrying payloads (and +-Inf)
    in acc: bitwise the plain version, every NaN of acc out as itself,
    quieted."""
    codes, anchor = _codes(nb, "smooth", 60 + nb)
    acc = torch.from_numpy(_nan_acc(nb, nb))
    eb = ops.as_eb(EB, "cpu")
    got = _dq_replay(codes, anchor, eb, acc, mis=nb % 4, seed=nb, wb=WARP_BLOCKS)
    assert torch.equal(_bits(got), _bits(lorenzo.dequantize_reduce_plain(codes, anchor, eb,
                                                                         acc)))
    nan = torch.isnan(acc)
    assert int(nan.sum()) == 2 * NAN_BITS.size
    assert torch.equal(_bits(got)[nan], _bits(acc)[nan] | 0x00400000)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("nb,kind", [(8, "smooth"), (16, "wrap"), (32, "zero")])
def test_dq_replay_bitwise_equals_pallas(nb, kind, kernel):
    """The replay against the JAX package's Pallas kernel in interpret mode,
    on the same inputs."""
    codes, anchor = _codes(nb, kind, 70 + nb)
    acc, eb = _acc(nb, kind, 70 + nb), ops.as_eb(EB, "cpu")
    got = _replay(kernel, codes, anchor, eb, acc, mis=nb % 4, seed=70, wb=WARP_BLOCKS)
    args = (jnp.asarray(codes.numpy().view(np.uint32)), jnp.asarray(anchor.numpy()), EB)
    if kernel == "dequantize":
        want = jops.dequantize(*args)
    else:
        want = jops.dequantize_reduce(*args, jnp.asarray(acc.numpy()))
    assert np.array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


# ---------------------------------------------------------------------------
# The wrapper and the C entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nb,wb,tiles", [
    (1, 1, 1), (984, 1, 123), (WIDE_ROWS - 1, 1, 2112),  # the ring/2 piece at 16 MB
    (WIDE_ROWS, 4, 528), (78_864, 4, 2465), (630_912, 4, 19_716),  # the scatter's
])
def test_dequantize_grid(nb, wb, tiles):
    """``lz_dequantize``'s blocks a warp and CTAs for nb rows: 32-block
    tiles from ``kWideRows`` rows on, 8-block tiles below; the constant as
    the source states it."""
    assert "constexpr int kWideRows = 4 * 132 * kTileBlocks;" in \
        (CSRC / "lorenzo.cu").read_text()
    assert _warp_blocks(nb) == wb
    assert -(-nb // (WARPS * wb)) == tiles


def test_dequantize_prototype():
    """``lz_dequantize``'s C parameters, one by one, against the ctypes
    signature the wrapper launches it with (unchanged by the tiled design:
    no scratch, no epoch)."""
    params = _prototypes("lorenzo.cu")["lz_dequantize"]
    assert params == ["const uint32_t*", "const int32_t*", "int", "const float*",
                      "const float*", "float*", "cudaStream_t"]
    p, i = ctypes.c_void_p, ctypes.c_int
    assert lorenzo._SIGNATURES["lz_dequantize"] == (p, p, i, p, p, p, p)


@pytest.mark.parametrize("kernel", KERNELS)
def test_dequantize_wrapper_refuses_what_the_kernel_does_not_take(kernel):
    """0 rows, codes of a wrong dtype, shape or layout, and a CPU tensor
    raise ``ValueError`` before anything is launched (the plain version is the CPU path,
    chosen by ``ops``)."""
    lorenzo.reset_launch_counts()
    codes, anchor = _codes(8, "smooth", 80)
    acc, eb = _acc(8, "smooth", 80), ops.as_eb(EB, "cpu")
    fn = getattr(lorenzo, kernel)
    extra = (acc,) if kernel == "dequantize_reduce" else ()
    with pytest.raises(ValueError, match="no blocks"):
        fn(torch.zeros((0, 256), dtype=torch.int32), torch.zeros(0, dtype=torch.int32), eb,
           *((torch.zeros(0, 256),) if extra else ()))
    with pytest.raises(ValueError, match="must be torch.int32"):
        fn(codes.to(torch.int64), anchor, eb, *extra)
    with pytest.raises(ValueError, match="has shape"):
        fn(codes.reshape(16, 128), anchor, eb, *extra)
    with pytest.raises(ValueError, match="contiguous"):
        fn(codes.t().contiguous().t(), anchor, eb, *extra)
    with pytest.raises(ValueError, match="CUDA"):
        fn(codes, anchor, eb, *extra)
    assert lorenzo.LAUNCHES == dict.fromkeys(lorenzo.KERNELS, 0)
    via_ops = getattr(ops, kernel)(codes, anchor, eb, *extra)
    assert torch.equal(_bits(via_ops), _bits(_plain(kernel, codes, anchor, eb, acc)))
