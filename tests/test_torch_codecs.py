"""The port's codec registry and its compressors against the JAX package's.

* Every registry entry (fields, pricing terms, provisioning hooks) and
  ``auto_codecs()`` equal ``repro.core.codecs``'s.
* Every codec's compressor, fused and ``fused=False``, gives the
  reference's stream, round trip, reduce and hop bitwise.  The
  reference's calls run under ``jax.jit``, as inside a collective: there
  XLA contracts the unfused entropy reduce into one FMA, which the port
  follows (``tests/test_torch_entropy.py`` pins the rounding).
* Round trips hold the bound (lossy: eb plus one f32 ulp of the data's
  magnitude, ROADMAP C3) or are bitwise (``lossless``, ``passthrough``,
  NaN payloads included).
* The ``payload_bytes`` of each codec on ``benchmarks/codec_bench.py``'s
  smooth tensor equal ``benchmarks/BENCH_codec.json`` exactly.
* ``FixedRate`` (the benchmarks' baseline) equals the reference's.
"""
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codecs as jcodecs
from repro.core import compressor as jcompressor
from repro.core.compressed import Compressed as JCompressed
from repro_torch import convert
from repro_torch.core import codecs, compressor

ROOT = pathlib.Path(__file__).resolve().parents[1]
CODECS = ("lorenzo", "lorenzo+entropy", "lossless", "passthrough")
LENGTHS = (1000, 3 * 2049)


def _data(n, seed, kind="smooth"):
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        return np.cumsum(rng.normal(0, 0.01, n)).astype(np.float32)
    if kind == "rough":
        return rng.normal(0, 3.0, n).astype(np.float32)
    x = rng.normal(0, 3.0, n).astype(np.float32)  # "special"
    x[::53] = np.nan
    x[3::59] = np.inf
    x[5::61] = -np.inf
    x[7::67] = -0.0
    x[9::71] = np.float32(np.uint32(0x7FA00042).view(np.float32))  # sNaN payload
    return x


def test_registry_equals_reference():
    assert codecs.codec_names() == jcodecs.codec_names()
    assert codecs.auto_codecs() == jcodecs.auto_codecs()
    assert codecs.AUTO == jcodecs.AUTO
    for name in codecs.codec_names():
        ours, ref = codecs.get_codec(name), jcodecs.get_codec(name)
        for field in ("name", "fused_hop", "lossy", "eb_scaled", "description",
                      "auto_selectable", "capacity_factor"):
            assert getattr(ours, field) == getattr(ref, field), (name, field)
        assert (ours.capacity_words is None) == (ref.capacity_words is None)
        assert dataclass_tuple(ours.terms) == dataclass_tuple(ref.terms), name
        for n in (1, 7, 256, 1000, 5000 * 3 + 37, 1 << 20):
            for cf in (0.05, 0.6, 2.0):
                assert codecs.codec_capacity_words(name, n, cf) == \
                    jcodecs.codec_capacity_words(name, n, cf), (name, n, cf)
        for fused in (True, False):
            comp = codecs.build_compressor(name, capacity_factor=0.6, fused=fused)
            jcomp = jcodecs.build_compressor(name, capacity_factor=0.6, fused=fused)
            assert type(comp).__name__ == type(jcomp).__name__
            assert [getattr(comp, f) for f in ("block",)] == [jcomp.block]
    for n in (1, 255, 256, 257, 100_000):
        assert compressor.lossless_capacity_words(n) == jcompressor.lossless_capacity_words(n)
    for bad in ("zstd", "auto"):
        with pytest.raises(ValueError):
            codecs.build_compressor(bad, capacity_factor=0.6, fused=True)


def dataclass_tuple(d):
    return tuple(getattr(d, f) for f in d.__dataclass_fields__)


def _pair(name, fused, cf=0.6):
    return (codecs.build_compressor(name, capacity_factor=cf, fused=fused),
            jcodecs.build_compressor(name, capacity_factor=cf, fused=fused))


def _assert_same_stream(c, jc):
    got, want = convert.compressed_to_numpy(c), convert.compressed_to_numpy(jc)
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert bool(c.overflowed()) == bool(jc.overflowed())
    assert int(c.payload_bytes()) == int(jc.payload_bytes())


def _bits_equal(a, b, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, what
    mism = int((a.view(np.int32) != b.view(np.int32)).sum())
    assert mism == 0, f"{what}: {mism} differ"


# (codec, fused): lorenzo's two-pass path is tests/test_torch_compressor.py's;
# passthrough has no kernel, so ``fused`` does not change it.
PAIRS = [("lorenzo", True), ("lorenzo+entropy", True), ("lorenzo+entropy", False),
         ("lossless", True), ("lossless", False), ("passthrough", True)]
# (n, kind): 6147 elements decode in more than one interpret-mode grid step
DATA = [(3 * 2049, "smooth"), (3 * 2049, "rough"), (3 * 2049, "special"),
        (1000, "smooth")]


@functools.lru_cache(maxsize=None)
def _jitted_reduce_and_hop(name, fused, cf, eb_out):
    jcomp = jcodecs.build_compressor(name, capacity_factor=cf, fused=fused)

    def f(c, acc):
        return jcomp.decompress_reduce(c, acc), jcomp.decompress_reduce_compress(
            c, acc, eb_out, return_updated=True)

    return jax.jit(f)


@pytest.mark.parametrize("n,kind", DATA)
@pytest.mark.parametrize("name,fused", PAIRS)
def test_compressor_equals_jax(name, fused, n, kind):
    """Stream, decompress, decompress_reduce and the hop (with the updated
    f32) bitwise against the reference compressor; the reduce and the hop
    run under ``jit``, as inside a collective."""
    cf = 0.05 if kind == "rough" else 0.6  # rough data overflows lossy codecs
    comp, jcomp = _pair(name, fused, cf)
    seed = 31 * n + CODECS.index(name) + 7 * ["smooth", "rough", "special"].index(kind)
    x, acc = _data(n, seed, kind), _data(n, seed + 1, "rough")
    eb, eb_out = 1e-4, 3e-5
    c = comp.compress(torch.from_numpy(x), eb)
    jc = jcomp.compress(jnp.asarray(x), eb)
    _assert_same_stream(c, jc)
    _bits_equal(comp.decompress(c).numpy(), jcomp.decompress(jc), "decompress")
    jred, (jout, jupd) = _jitted_reduce_and_hop(name, fused, cf, eb_out)(
        jc, jnp.asarray(acc))
    _bits_equal(comp.decompress_reduce(c, torch.from_numpy(acc)).numpy(), jred, "reduce")
    out, upd = comp.decompress_reduce_compress(c, torch.from_numpy(acc), eb_out,
                                               return_updated=True)
    _assert_same_stream(out, jout)
    _bits_equal(upd.numpy(), jupd, "hop carry")


@pytest.mark.parametrize("name", CODECS)
def test_round_trip_holds_bound_or_is_exact(name):
    spec = codecs.get_codec(name)
    for n, kind in ((20_000, "smooth"), (5000, "special")):
        x = _data(n, 3 + n, kind)
        comp = codecs.build_compressor(name, capacity_factor=2.0, fused=True)
        c = comp.compress(torch.from_numpy(x), 1e-4)
        assert not bool(c.overflowed())
        y = comp.decompress(c).numpy()
        if spec.lossy:
            if kind == "special":
                continue  # NaN/Inf saturate: no bound is promised there
            err = np.abs(y.astype(np.float64) - x).max()
            assert err <= 1e-4 + np.abs(x).max() * np.finfo(np.float32).eps, err
        else:
            np.testing.assert_array_equal(y.view(np.uint32), x.view(np.uint32))


def test_payload_bytes_equal_bench_codec():
    """``benchmarks/codec_bench.py``'s smooth tensor (seed 0, 65,536
    elements, eb 1e-4, capacity 0.6): the true shipped bytes of each codec
    equal the recorded ones exactly."""
    want = json.loads((ROOT / "benchmarks" / "BENCH_codec.json").read_text())["codec"]
    assert sorted(want) == sorted(CODECS)
    x = torch.from_numpy(np.cumsum(
        np.random.default_rng(0).normal(0, 0.01, 1 << 16)).astype(np.float32))
    got = {}
    for name in CODECS:
        comp = codecs.build_compressor(name, capacity_factor=0.6, fused=True)
        c = comp.compress(x, 1e-4)
        assert not bool(c.overflowed())
        got[name] = int(c.payload_bytes())
        assert got[name] == want[name]["payload_bytes"], name
        assert codecs.get_codec(name).lossy == want[name]["lossy"]
        assert codecs.get_codec(name).fused_hop == want[name]["fused_hop"]
    assert got == {"lorenzo": 75240, "lorenzo+entropy": 71560, "lossless": 177128,
                   "passthrough": 264200}
    two_pass = codecs.build_compressor("lorenzo+entropy", capacity_factor=0.6, fused=False)
    assert int(two_pass.compress(x, 1e-4).payload_bytes()) == 71560


@pytest.mark.parametrize("n", (1000, 3 * 2049))
def test_fixed_rate_equals_jax(n):
    """The fixed-rate baseline: clamped codes, a pre-known wire size and
    ``acc + decompress(c)`` rounded twice; bitwise against the reference.
    The reference's reduce is compared eagerly and, where its interpret-
    mode decode runs more than one grid step, under ``jit`` too: with a
    single step XLA inlines the kernel and contracts the add into its
    multiply (one rounding), which the port does not copy."""
    x, acc = _data(n, 5 + n, "rough"), _data(n, 6 + n, "rough")
    comp, jcomp = compressor.FixedRate(), jcompressor.FixedRate()
    c = comp.compress(torch.from_numpy(x), 1e-2)
    jc = jax.jit(lambda v: jcomp.compress(v, 1e-2))(jnp.asarray(x))
    _assert_same_stream(c, jc)
    _bits_equal(comp.decompress(c).numpy(), jax.jit(jcomp.decompress)(jc), "decompress")
    red = comp.decompress_reduce(c, torch.from_numpy(acc)).numpy()
    _bits_equal(red, jcomp.decompress_reduce(jc, jnp.asarray(acc)), "reduce")
    if n > 8 * 256:
        _bits_equal(red, jax.jit(jcomp.decompress_reduce)(jc, jnp.asarray(acc)),
                    "reduce (jit)")
    err = np.abs(comp.decompress(c).numpy() - x).max()
    assert err > 1.0  # clamped codes: the bound does not hold


def test_streams_cross_between_packages():
    """An entropy stream made by the port decodes in the JAX package and
    the other way round."""
    x = _data(5000, 77)
    for name in ("lorenzo+entropy", "lossless"):
        comp, jcomp = _pair(name, True)
        c = comp.compress(torch.from_numpy(x), 1e-4)
        d = convert.compressed_to_numpy(c)
        jc_from_port = JCompressed(
            packed=jnp.asarray(d["packed"]), bitwidth=jnp.asarray(d["bitwidth"]),
            anchor=jnp.asarray(d["anchor"]), nwords=jnp.int32(d["nwords"]),
            eb=jnp.float32(d["eb"]), n=d["n"], block=d["block"])
        _bits_equal(jcomp.decompress(jc_from_port), comp.decompress(c).numpy(), name)
        jc = jcomp.compress(jnp.asarray(x), 1e-4)
        back = convert.compressed_from_numpy(convert.compressed_to_numpy(jc), "cpu")
        _bits_equal(comp.decompress(back).numpy(), jcomp.decompress(jc), name)
