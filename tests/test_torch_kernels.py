"""The port's Lorenzo kernels (plain versions, as they run on the CPU)
against the JAX package's kernel path, bitwise.

The reference is ``repro.kernels.ops`` (the Pallas kernels, in interpret
mode on the CPU).  For every case the same seeded inputs go through both
sides; packed words, zigzag codes, per-block bitwidths and anchors, and
every f32 output must be bitwise equal.  Cases cover raw block counts
that are and are not a multiple of 8, eb in {1e-2, 1e-4}, smooth and
rough data, capacity factors 0.6, 2.0 and an overflowing 0.05, and
``emit_f32`` both ways; the unfused kernels also NaN, +-Inf, values past
the int32 range of q, and codes whose prefix sum wraps in int32.  Two
tests pin the single FMA rounding of the reduce.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitpack as jbitpack
from repro.core.compressed import capacity_words_for as j_capacity_words_for
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import bitpack
from repro_torch.core.compressed import capacity_words_for
from repro_torch.kernels import lorenzo, ops, ref

# raw block counts 16 (a multiple of 8) and 12 (padded to 16)
SIZES = (16 * 256, 11 * 256 + 77)
EBS = (1e-2, 1e-4)
KINDS = ("smooth", "rough")
FACTORS = (0.6, 2.0, 0.05)
CASES = [(n, eb, kind, cf) for n in SIZES for eb in EBS for kind in KINDS
         for cf in FACTORS]


def _data(n, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        return np.cumsum(rng.normal(0, 0.01, n)).astype(np.float32)
    return rng.normal(0, 3.0, n).astype(np.float32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype in (np.float32, np.uint32) else a


def _assert_bitwise(got, want, what):
    got, want = _bits(got), _bits(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    mism = int((got != want).sum())
    assert mism == 0, f"{what}: {mism} of {got.size} differ"


@functools.lru_cache(maxsize=None)
def _case(n, eb, kind, cf):
    """Inputs and the JAX kernel path's outputs for one case."""
    x = _data(n, kind, seed=CASES.index((n, eb, kind, cf)))
    acc = _data(n, "rough", seed=7 + n)
    cap = j_capacity_words_for(n, cf, 256)
    assert cap == capacity_words_for(n, cf, 256)
    x2d_j, acc_j = jops.to_blocks(jnp.asarray(x)), jops.to_blocks(jnp.asarray(acc))
    pk, bw, an = jops.quantize_pack(x2d_j, eb, cap)
    eb_out = eb * 0.7
    jax_out = {
        "quantize_pack": (pk, bw, an),
        "unpack_dequantize": (jops.unpack_dequantize(pk, bw, an, eb),),
        "unpack_dequantize_reduce": (
            jops.unpack_dequantize_reduce(pk, bw, an, eb, acc_j),),
        "unpack_reduce_repack": jops.unpack_reduce_repack(
            pk, bw, an, eb, acc_j, eb_out, cap),
        "unpack_reduce_repack/emit_f32": jops.unpack_reduce_repack(
            pk, bw, an, eb, acc_j, eb_out, cap, emit_f32=True),
    }
    jax_out = {k: tuple(np.asarray(a) for a in v) for k, v in jax_out.items()}
    return x, acc, cap, eb_out, jax_out


def _stream(jax_out):
    pk, bw, an = jax_out["quantize_pack"]
    return (torch.from_numpy(pk.view(np.int32).copy()),
            torch.from_numpy(bw.copy()), torch.from_numpy(an.copy()))


def _port(kernel, n, eb, kind, cf):
    x, acc, cap, eb_out, jax_out = _case(n, eb, kind, cf)
    x2d = ops.to_blocks(torch.from_numpy(x))
    acc2d = ops.to_blocks(torch.from_numpy(acc))
    pk, bw, an = _stream(jax_out)  # decode the JAX package's own stream
    if kernel == "quantize_pack":
        return ops.quantize_pack(x2d, eb, cap)
    if kernel == "unpack_dequantize":
        return (ops.unpack_dequantize(pk, bw, an, eb),)
    if kernel == "unpack_dequantize_reduce":
        return (ops.unpack_dequantize_reduce(pk, bw, an, eb, acc2d),)
    return ops.unpack_reduce_repack(pk, bw, an, eb, acc2d, eb_out, cap,
                                    emit_f32=kernel.endswith("emit_f32"))


@pytest.mark.parametrize("kernel", [
    "quantize_pack", "unpack_dequantize", "unpack_dequantize_reduce",
    "unpack_reduce_repack", "unpack_reduce_repack/emit_f32"])
@pytest.mark.parametrize("n,eb,kind,cf", CASES)
def test_plain_kernel_bitwise_equals_jax(kernel, n, eb, kind, cf):
    want = _case(n, eb, kind, cf)[4][kernel]
    got = _port(kernel, n, eb, kind, cf)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_bitwise(g.numpy(), w, f"{kernel} output {i}")
    if kernel == "quantize_pack":
        nwords = 8 * int(got[1].sum())
        assert (nwords > got[0].shape[0]) == (cf == 0.05)


def test_plain_stream_decodes_in_jax():
    """A stream packed by the port decodes in the JAX kernel path."""
    n, eb = SIZES[1], 1e-4
    x = _data(n, "smooth", 3)
    cap = capacity_words_for(n, 0.6, 256)
    pk, bw, an = ops.quantize_pack(ops.to_blocks(torch.from_numpy(x)), eb, cap)
    got = jops.unpack_dequantize(jnp.asarray(pk.numpy().view(np.uint32)),
                                 jnp.asarray(bw.numpy()), jnp.asarray(an.numpy()), eb)
    want = ops.unpack_dequantize(pk, bw, an, eb)
    _assert_bitwise(want.numpy(), got, "cross decode")
    assert np.abs(ops.from_blocks(want, n).numpy() - x).max() <= eb * 1.0001


def test_fma_single_rounding_pinned():
    """acc + q*2eb is rounded once.  Here the exact value lies just above
    the f32 midpoint 1 + 2**-24; rounding the f64 sum and then casting
    lands ON the midpoint and ties to even (1.0), the FMA gives 1 + 2**-23.
    """
    eb = np.float32(16773121 * 2.0**-61)  # 2eb * 4097 == 2**-24 + 2**-60
    twoeb = np.float64(np.float32(2) * eb)
    assert np.float32(4097.0 * twoeb + 1.0) == np.float32(1.0)  # double rounding
    cap = 64
    args = (np.zeros(cap, np.uint32), np.zeros(8, np.int32),
            np.full(8, 4097, np.int32))
    acc = np.ones((8, 256), np.float32)
    want = np.asarray(jops.unpack_dequantize_reduce(
        *map(jnp.asarray, args), eb, jnp.asarray(acc)))
    assert want[0, 0] == np.float32(1.0 + 2.0**-23)
    got = ops.unpack_dequantize_reduce(
        torch.from_numpy(args[0].view(np.int32)), torch.from_numpy(args[1]),
        torch.from_numpy(args[2]), float(eb), torch.from_numpy(acc))
    _assert_bitwise(got.numpy(), want, "fma pin")
    hop = ops.unpack_reduce_repack(
        torch.from_numpy(args[0].view(np.int32)), torch.from_numpy(args[1]),
        torch.from_numpy(args[2]), float(eb), torch.from_numpy(acc), 1e-3, cap,
        emit_f32=True)
    _assert_bitwise(hop[3].numpy(), want, "fma pin (hop)")


def test_fma_matches_kernel_path_where_two_roundings_differ():
    """The ROADMAP C1 probe: 64x256 N(0, 3), eb = 1e-3.  The kernel path
    and the two-rounding jnp oracle disagree in thousands of elements; the
    port agrees with the kernel path in all of them."""
    rng = np.random.default_rng(11)
    x2d = rng.normal(0, 3, (64, 256)).astype(np.float32)
    acc = rng.normal(0, 3, (64, 256)).astype(np.float32)
    eb = 1e-3
    codes, bw, an = jops.quantize(jnp.asarray(x2d), eb)
    kernel = np.asarray(jops.dequantize_reduce(codes, an, eb, jnp.asarray(acc)))
    oracle = np.asarray(jref.dequantize_reduce_ref(
        codes, an, jnp.float32(eb), jnp.asarray(acc)))
    assert (kernel != oracle).sum() > 1000
    got = ref.dequantize_reduce_ref(
        torch.from_numpy(np.asarray(codes).astype(np.int64)),
        torch.from_numpy(np.array(an)), ops.as_eb(eb, "cpu"),
        torch.from_numpy(acc))
    _assert_bitwise(got.numpy(), kernel, "fma vs kernel path")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("eb", EBS)
def test_quantize_ref_equals_jax_quantize(eb, kind):
    x2d = _data(24 * 256, kind, 5).reshape(24, 256)
    codes, bw, an = ref.quantize_ref(torch.from_numpy(x2d), ops.as_eb(eb, "cpu"))
    jc, jbw, jan = jops.quantize(jnp.asarray(x2d), eb)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc).astype(np.int64))
    np.testing.assert_array_equal(bw.numpy(), np.asarray(jbw))
    np.testing.assert_array_equal(an.numpy(), np.asarray(jan))


def test_float_to_int_saturates_like_xla():
    vals = np.array([1e20, -1e20, np.nan, np.inf, -np.inf, 2.5, 3.5, -2.5, -0.5,
                     2147483520.0, -2147483648.0, 0.49999997], np.float32)
    want = np.asarray(jnp.rint(jnp.asarray(vals)).astype(jnp.int32))
    np.testing.assert_array_equal(ref.f32_to_i32_rn(torch.from_numpy(vals)).numpy(), want)


@pytest.mark.parametrize("n_blocks,kind", [(8, "smooth"), (13, "rough"), (40, "smooth")])
@pytest.mark.parametrize("cap_factor", [0.6, 2.0, 0.05])
def test_bitpack_equals_jax_bitpack(n_blocks, kind, cap_factor):
    x2d = _data(n_blocks * 256, kind, n_blocks).reshape(n_blocks, 256)
    codes, bw, _ = jops.quantize(jnp.asarray(x2d), 1e-4) if n_blocks % 8 == 0 else \
        jref.quantize_ref(jnp.asarray(x2d), jnp.float32(1e-4))
    cap = capacity_words_for(n_blocks * 256, cap_factor, 256)
    jp, jn = jbitpack.pack(codes, bw, cap)
    tp, tn = bitpack.pack(torch.from_numpy(np.asarray(codes).astype(np.int64)),
                          torch.from_numpy(np.array(bw)), cap)
    _assert_bitwise(tp.numpy(), np.asarray(jp), "pack")
    assert int(tn) == int(jn)
    ju = jbitpack.unpack(jp, bw, 256)
    tu = bitpack.unpack(tp, torch.from_numpy(np.array(bw)), 256)
    assert tu.dtype == torch.int32  # uint32 bits, the codes convention
    _assert_bitwise(tu.numpy(), np.asarray(ju), "unpack")


def test_block_helpers_equal_jax():
    for n in (1, 255, 256, 2047, 2048, 2049, 5000):
        assert ops.n_blocks_for(n) == jops.n_blocks_for(n)
        x = np.arange(n, dtype=np.float32)
        tb = ops.to_blocks(torch.from_numpy(x))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jops.to_blocks(jnp.asarray(x))))
        np.testing.assert_array_equal(ops.from_blocks(tb, n).numpy(), x)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper given CPU data raises instead of running it."""
    lorenzo.reset_launch_counts()
    x2d = torch.zeros((8, 256))
    eb = ops.as_eb(1e-3, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        lorenzo.quantize_pack(x2d, eb, 64)
    with pytest.raises(ValueError, match="CUDA"):
        lorenzo.unpack_dequantize(torch.zeros(64, dtype=torch.int32),
                                  torch.zeros(8, dtype=torch.int32),
                                  torch.zeros(8, dtype=torch.int32), eb)
    with pytest.raises(ValueError, match="CUDA"):
        lorenzo.quantize(x2d, eb)
    with pytest.raises(ValueError, match="CUDA"):
        lorenzo.dequantize_reduce(torch.zeros((8, 256), dtype=torch.int32),
                                  torch.zeros(8, dtype=torch.int32), eb, x2d)
    assert lorenzo.LAUNCHES == dict.fromkeys(lorenzo.KERNELS, 0)
    with pytest.raises(ValueError, match="no kernel"):
        ops.quantize_pack(torch.zeros((8, 256), device="meta"), 1e-3, 64)


# ---------------------------------------------------------------------------
# The unfused kernels: quantize, dequantize, dequantize_reduce
# ---------------------------------------------------------------------------


def _wild(n, seed):
    """Rough data with NaN, +-Inf, and values whose q passes the int32
    range (saturating) at eb = 1e-4."""
    x = _data(n, "rough", seed)
    x[::97] = np.nan
    x[5::89] = np.inf
    x[7::83] = -np.inf
    x[11::79] = 5e5  # > 2**31 * 2eb
    x[13::71] = -1e30
    return x


UNFUSED = [(n, eb, kind) for n in SIZES for eb in EBS for kind in KINDS] + \
    [(n, 1e-4, "wild") for n in SIZES]


@pytest.mark.parametrize("n,eb,kind", UNFUSED)
def test_unfused_plain_kernels_bitwise_equal_jax(n, eb, kind):
    seed = UNFUSED.index((n, eb, kind))
    x = _wild(n, seed) if kind == "wild" else _data(n, kind, seed)
    acc = _data(n, "rough", seed + 50)
    x2d_j, acc_j = jops.to_blocks(jnp.asarray(x)), jops.to_blocks(jnp.asarray(acc))
    jc, jbw, jan = jops.quantize(x2d_j, eb)
    codes, bw, an = ops.quantize(ops.to_blocks(torch.from_numpy(x)), eb)
    assert codes.dtype == torch.int32
    _assert_bitwise(codes.numpy(), np.asarray(jc), "quantize codes")
    _assert_bitwise(bw.numpy(), np.asarray(jbw), "quantize bw")
    _assert_bitwise(an.numpy(), np.asarray(jan), "quantize anchor")
    acc2d = ops.to_blocks(torch.from_numpy(acc))
    _assert_bitwise(ops.dequantize(codes, an, eb).numpy(),
                    np.asarray(jops.dequantize(jc, jan, eb)), "dequantize")
    _assert_bitwise(ops.dequantize_reduce(codes, an, eb, acc2d).numpy(),
                    np.asarray(jops.dequantize_reduce(jc, jan, eb, acc_j)),
                    "dequantize_reduce")


@pytest.mark.parametrize("eb", EBS)
def test_unfused_dequantize_wraps_like_int32(eb):
    """Random full-range codes and anchors: the prefix sum wraps in int32
    in nearly every block, on both sides the same way."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 2**32, (16, 256), dtype=np.uint64).astype(np.uint32)
    anchor = rng.integers(-2**31, 2**31, 16, dtype=np.int64).astype(np.int32)
    acc = rng.normal(0, 1e6, (16, 256)).astype(np.float32)
    tc = torch.from_numpy(codes.view(np.int32).copy())
    ta = torch.from_numpy(anchor)
    _assert_bitwise(ops.dequantize(tc, ta, eb).numpy(),
                    np.asarray(jops.dequantize(jnp.asarray(codes), jnp.asarray(anchor), eb)),
                    "dequantize (wrap)")
    _assert_bitwise(
        ops.dequantize_reduce(tc, ta, eb, torch.from_numpy(acc)).numpy(),
        np.asarray(jops.dequantize_reduce(jnp.asarray(codes), jnp.asarray(anchor), eb,
                                          jnp.asarray(acc))),
        "dequantize_reduce (wrap)")
