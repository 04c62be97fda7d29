"""The port's entropy-coded wire stage against the JAX package's, bitwise.

Two references, each for its own counterpart:

* the plain versions of kernels 8-10 (``repro_torch.kernels.entropy``,
  what a CPU tensor runs) against the JAX kernel path
  (``repro.kernels.ops.entropy_*``: the Pallas kernels in interpret mode);
* the port's ``core/entropy.py`` stages against the jnp oracle
  (``repro.core.entropy``), whose decoder clips out-of-range word indices
  where the kernels read zeros.

Packed words, descriptors, anchors, codes and every f32 output must be
bitwise equal, lossy and lossless, on ragged sizes, all-zero blocks
(width 0), full 32-bit sub-widths, NaN and +-Inf (the lossy quantizer
saturates them; lossless keeps their bit patterns, NaN payloads included)
and overflowed capacities.  A pinned input fixes the single rounding of
the lossy reduce.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressor as jcompressor
from repro.core import entropy as jentropy
from repro.core.compressed import Compressed as JCompressed
from repro.kernels import ops as jops
from repro_torch.core import entropy
from repro_torch.kernels import entropy as kentropy
from repro_torch.kernels import ops

# raw block counts 16 (a multiple of 8) and 11 + a partial block (padded to 16)
SIZES = (16 * 256, 11 * 256 + 77)
KINDS = ("smooth", "rough", "zero-blocks", "wild", "random-bits")
# (data kind, n, eb, capacity factor or None for the lossless structural one)
CASES = (
    [(kind, n, 1e-4, 0.6) for kind in KINDS for n in SIZES]
    + [(kind, SIZES[1], 1e-2, 2.0) for kind in ("smooth", "rough")]
    + [("rough", n, 1e-6, 0.05) for n in SIZES]            # overflows
    + [(kind, n, 0.0, None) for kind in KINDS for n in SIZES]  # lossless
    + [("random-bits", SIZES[0], 0.0, 0.3)]                # lossless, overflowing
)


def _data(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        return np.cumsum(rng.normal(0, 0.01, n)).astype(np.float32)
    if kind == "rough":
        return rng.normal(0, 3.0, n).astype(np.float32)
    if kind == "zero-blocks":  # whole blocks and single subs of width 0
        x = np.cumsum(rng.normal(0, 0.01, n)).astype(np.float32)
        x[256:768] = 0.0
        x[1024 + 64:1024 + 128] = x[1024 + 63]
        return x
    if kind == "wild":  # NaN, +-Inf and values whose q saturates int32
        x = rng.normal(0, 3.0, n).astype(np.float32)
        x[::97] = np.nan
        x[5::89] = np.inf
        x[7::83] = -np.inf
        x[11::79] = 5e5
        x[13::71] = -1e30
        x[17::61] = np.float32(np.uint32(0x7FC00123).view(np.float32))  # NaN payload
        return x
    # full-range bit patterns: 32-bit sub-widths (and, lossless, sNaN payloads)
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)


def _lossless(eb, cf):
    return cf is None or eb == 0.0


def _cap(n, cf):
    if cf is None:
        return jcompressor.lossless_capacity_words(n)
    return max(int(n * cf), -(-n // 256), 8)


def _bits(a):
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    return a.view(np.int32) if a.dtype in (np.float32, np.uint32) else a


def _assert_bitwise(got, want, what):
    got, want = _bits(got), _bits(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    mism = int((got != want).sum())
    assert mism == 0, f"{what}: {mism} of {got.size} differ"


def _t(a, dtype=None):
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy() if dtype is None else a.astype(dtype))


@functools.lru_cache(maxsize=None)
def _case(kind, n, eb, cf):
    """Inputs and the JAX kernel path's outputs for one case."""
    lossless = _lossless(eb, cf)
    seed = CASES.index((kind, n, eb, cf))
    x = _data(kind, n, seed)
    acc = _data("rough", n, seed + 1000)
    cap = _cap(n, cf)
    x2d, acc2d = jops.to_blocks(jnp.asarray(x)), jops.to_blocks(jnp.asarray(acc))
    pk, desc, an = jops.entropy_quantize_pack(x2d, eb, cap, lossless=lossless)
    out = {
        "quantize_pack": (pk, desc, an),
        "unpack_dequantize": (jops.entropy_unpack_dequantize(
            pk, desc, an, eb, lossless=lossless),),
        "unpack_dequantize_reduce": (jops.entropy_unpack_dequantize_reduce(
            pk, desc, an, eb, acc2d, lossless=lossless),),
    }
    out = {k: tuple(np.asarray(a) for a in v) for k, v in out.items()}
    return x, acc, cap, lossless, out


@pytest.mark.parametrize("kernel", ["quantize_pack", "unpack_dequantize",
                                    "unpack_dequantize_reduce"])
@pytest.mark.parametrize("kind,n,eb,cf", CASES)
def test_plain_kernel_bitwise_equals_jax(kernel, kind, n, eb, cf):
    x, acc, cap, lossless, want = _case(kind, n, eb, cf)
    x2d, acc2d = ops.to_blocks(torch.from_numpy(x)), ops.to_blocks(torch.from_numpy(acc))
    pk, desc, an = (_t(a) for a in want["quantize_pack"])  # the JAX stream
    if kernel == "quantize_pack":
        got = ops.entropy_quantize_pack(x2d, eb, cap, lossless=lossless)
    elif kernel == "unpack_dequantize":
        got = (ops.entropy_unpack_dequantize(pk, desc, an, eb, lossless=lossless),)
    else:
        got = (ops.entropy_unpack_dequantize_reduce(pk, desc, an, eb, acc2d,
                                                    lossless=lossless),)
    assert len(got) == len(want[kernel])
    for i, (g, w) in enumerate(zip(got, want[kernel])):
        _assert_bitwise(g, w, f"{kernel} output {i}")
    if kernel == "quantize_pack":
        assert int(entropy.packed_words(got[1])) == \
            int(jentropy.packed_words(jnp.asarray(want[kernel][1])))


def test_case_coverage():
    """The cases reach what they are named for: 32-bit and 0-bit sub-widths,
    overflow both ways, and the lossless round trip bit for bit (NaN
    payloads too)."""
    widths = set()
    for case in CASES:
        x, _, cap, lossless, out = _case(*case)
        pk, desc, an = out["quantize_pack"]
        widths |= set(np.unique(entropy.split_desc(_t(desc)).numpy()))
        overflow = int(entropy.packed_words(_t(desc))) > cap
        if case[3] in (0.05, 0.3):
            assert overflow, case
        if case[3] is None or case[0] in ("smooth", "zero-blocks"):
            assert not overflow, case
        if lossless and case[3] is None:
            back = out["unpack_dequantize"][0].reshape(-1)[: x.size]
            np.testing.assert_array_equal(back.view(np.uint32), x.view(np.uint32))
    assert {0, 32} <= widths


@pytest.mark.parametrize("kind,n,eb,cf", CASES)
def test_oracle_stages_bitwise_equal_jax_oracle(kind, n, eb, cf):
    """``core/entropy.py`` against ``repro.core.entropy``: codes, anchors,
    widths, descriptor, stream, clipped unpack and decode."""
    x, acc, cap, lossless, _ = _case(kind, n, eb, cf)
    x2d_j = jops.to_blocks(jnp.asarray(x))
    jcodes, jan = jentropy.encode_blocks(x2d_j, eb, lossless=lossless)
    codes, an = entropy.encode_blocks(ops.to_blocks(torch.from_numpy(x)), eb,
                                      lossless=lossless)
    _assert_bitwise(codes, jcodes, "codes")
    _assert_bitwise(an, jan, "anchor")
    _assert_bitwise(entropy.sub_widths(codes), jentropy.sub_widths(jcodes), "sub widths")
    jpk, jdesc, jnw = jentropy.pack(jcodes, cap)
    pk, desc, nw = entropy.pack(codes, cap)
    _assert_bitwise(pk, jpk, "packed")
    _assert_bitwise(desc, jdesc, "desc")
    assert int(nw) == int(jnw) == int(entropy.packed_words(desc))
    _assert_bitwise(entropy.split_desc(desc), jentropy.split_desc(jdesc), "split")
    _assert_bitwise(entropy.make_desc(entropy.split_desc(desc)), jdesc, "make_desc")
    back = entropy.unpack(pk, desc, 256)
    _assert_bitwise(back, jentropy.unpack(jpk, jdesc, 256), "unpack (clipped)")
    _assert_bitwise(entropy.decode_blocks(back, an, eb, lossless=lossless),
                    jentropy.decode_blocks(jentropy.unpack(jpk, jdesc, 256), jan, eb,
                                           lossless=lossless), "decode")


def test_overflow_semantics_differ_by_path():
    """An overflowed stream: the kernel path reads words past the capacity
    as 0, the oracle clips to the last word; each port path follows its
    own reference and the two disagree somewhere."""
    kind, n, eb, cf = ("rough", SIZES[0], 1e-6, 0.05)
    x, _, cap, _, want = _case(kind, n, eb, cf)
    pk, desc, an = (_t(a) for a in want["quantize_pack"])
    padded = entropy.unpack_padded(pk, desc, 256)
    clipped = entropy.unpack(pk, desc, 256)
    assert int((padded != clipped).sum()) > 0
    jclipped = jentropy.unpack(jnp.asarray(want["quantize_pack"][0]),
                               jnp.asarray(want["quantize_pack"][1]), 256)
    _assert_bitwise(clipped, jclipped, "clipped")
    _assert_bitwise(ops.entropy_unpack_dequantize(pk, desc, an, eb),
                    want["unpack_dequantize"][0], "kernel path")


def _pinned_stream():
    """All-zero codes and anchor 4097: every element decodes to q = 4097.
    With eb below, 2eb * 4097 = 2**-24 + 2**-60, so acc = 1 + q*2eb lies
    just above the f32 midpoint 1 + 2**-24: one rounding gives 1 + 2**-23,
    a rounded product then a rounded sum gives 1.0."""
    eb = np.float32(16773121 * 2.0**-61)
    assert np.float32(np.float32(4097.0 * np.float32(2 * eb)) + np.float32(1)) == 1.0
    return eb, np.zeros(64, np.uint32), np.zeros(8, np.int32), np.full(8, 4097, np.int32)


def test_reduce_single_rounding_pinned():
    """The lossy reduce rounds once on every path the reference runs in a
    collective: the kernel (interpret mode, eager or jitted) and the
    unfused ``acc + decode_blocks`` under ``jit``, where XLA contracts the
    multiply and the add.  Eagerly the unfused composition rounds twice;
    the port's unfused path follows the jitted reference."""
    eb, pk, desc, an = _pinned_stream()
    acc = np.ones((8, 256), np.float32)
    one_rounding = np.float32(1.0 + 2.0**-23)
    kern = np.asarray(jops.entropy_unpack_dequantize_reduce(
        jnp.asarray(pk), jnp.asarray(desc), jnp.asarray(an), eb, jnp.asarray(acc)))
    assert kern[0, 0] == one_rounding
    jcomp = jcompressor.EntropyLorenzo(fused=False)

    def unfused(p, d, a, e, x):
        c = JCompressed(packed=p, bitwidth=d, anchor=a, nwords=jnp.int32(0), eb=e,
                        n=2048, block=256)
        return jcomp.decompress_reduce(c, x)

    args = (jnp.asarray(pk), jnp.asarray(desc), jnp.asarray(an), jnp.float32(eb),
            jnp.ones(2048, jnp.float32))
    assert np.asarray(jax.jit(unfused)(*args))[0] == one_rounding
    assert np.asarray(unfused(*args))[0] == np.float32(1.0)  # eager: two roundings
    got = ops.entropy_unpack_dequantize_reduce(
        _t(pk), _t(desc), _t(an), float(eb), torch.from_numpy(acc))
    _assert_bitwise(got, kern, "kernel 10 plain version")
    codes = entropy.unpack(_t(pk), _t(desc), 256)
    got = entropy.decode_reduce_blocks(codes, _t(an), float(eb), torch.from_numpy(acc))
    assert got[0, 0].item() == one_rounding


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper given CPU data raises instead of running it."""
    kentropy.reset_launch_counts()
    x2d = torch.zeros((8, 256))
    eb = ops.as_eb(1e-3, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kentropy.quantize_pack(x2d, eb, 64)
    zeros = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kentropy.unpack_dequantize(torch.zeros(64, dtype=torch.int32), zeros, zeros, eb)
    with pytest.raises(ValueError, match="CUDA"):
        kentropy.unpack_dequantize_reduce(torch.zeros(64, dtype=torch.int32), zeros,
                                          zeros, eb, x2d, lossless=True)
    assert kentropy.LAUNCHES == dict.fromkeys(kentropy.KERNELS, 0)
    with pytest.raises(ValueError, match="no kernel"):
        ops.entropy_quantize_pack(torch.zeros((8, 256), device="meta"), 1e-3, 64)
