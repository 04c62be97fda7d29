"""The port's compressor, codec registry and state conversion against the
JAX package's ``ErrorBoundedLorenzo``, bitwise, fused and two-pass
(``fused=False``).

Lengths are not multiples of 2048 (the row-tile), so every path pads.
Streams cross between the packages through ``repro_torch.convert`` and
decode bitwise on the other side.  The port's two-pass streams are
byte-identical to its fused ones.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressor as jcompressor
from repro.core.compressed import Compressed as JCompressed
from repro_torch import convert
from repro_torch.core import codecs
from repro_torch.core.compressor import ErrorBoundedLorenzo

LENGTHS = (1000, 5000, 3 * 2049)
FACTORS = (0.6, 2.0, 0.05)


def _data(n, seed, kind="smooth"):
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        return np.cumsum(rng.normal(0, 0.01, n)).astype(np.float32)
    return rng.normal(0, 3.0, n).astype(np.float32)


def _pair(cf, fused=True):
    return (ErrorBoundedLorenzo(capacity_factor=cf, fused=fused),
            jcompressor.ErrorBoundedLorenzo(capacity_factor=cf, fused=fused))


def _assert_same_stream(c, jc):
    got, want = convert.compressed_to_numpy(c), convert.compressed_to_numpy(jc)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert bool(c.overflowed()) == bool(jc.overflowed())


def _f32_equal(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape
    assert (a.view(np.int32) != b.view(np.int32)).sum() == 0


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("n", LENGTHS)
def test_compress_and_decompress_equal_jax(n, cf):
    x = _data(n, n)
    comp, jcomp = _pair(cf)
    c, jc = comp.compress(torch.from_numpy(x), 1e-4), jcomp.compress(jnp.asarray(x), 1e-4)
    _assert_same_stream(c, jc)
    assert bool(c.overflowed()) == (cf == 0.05)
    _f32_equal(comp.decompress(c).numpy(), jcomp.decompress(jc))
    acc = _data(n, n + 1, "rough")
    _f32_equal(comp.decompress_reduce(c, torch.from_numpy(acc)).numpy(),
               jcomp.decompress_reduce(jc, jnp.asarray(acc)))


@pytest.mark.parametrize("return_updated", [False, True])
@pytest.mark.parametrize("eb_out", [None, 3e-5])
@pytest.mark.parametrize("n", LENGTHS)
def test_decompress_reduce_compress_equals_jax(n, eb_out, return_updated):
    x, acc = _data(n, 2 * n), _data(n, 2 * n + 1)
    comp, jcomp = _pair(0.6)
    c, jc = comp.compress(torch.from_numpy(x), 1e-4), jcomp.compress(jnp.asarray(x), 1e-4)
    out, upd = comp.decompress_reduce_compress(
        c, torch.from_numpy(acc), eb_out, return_updated=return_updated)
    jout, jupd = jcomp.decompress_reduce_compress(
        jc, jnp.asarray(acc), eb_out, return_updated=return_updated)
    _assert_same_stream(out, jout)
    assert (upd is None) == (jupd is None) == (not return_updated)
    if return_updated:
        _f32_equal(upd.numpy(), jupd)


@pytest.mark.parametrize("n", LENGTHS)
def test_streams_cross_decode_through_convert(n):
    x = _data(n, 3 * n)
    comp, jcomp = _pair(0.6)
    jc = jcomp.compress(jnp.asarray(x), 1e-4)
    # JAX stream -> the port
    c = convert.compressed_from_numpy(convert.compressed_to_numpy(jc), "cpu")
    _f32_equal(comp.decompress(c).numpy(), jcomp.decompress(jc))
    # port stream -> JAX
    d = convert.compressed_to_numpy(comp.compress(torch.from_numpy(x), 1e-4))
    jc2 = JCompressed(packed=jnp.asarray(d["packed"]), bitwidth=jnp.asarray(d["bitwidth"]),
                      anchor=jnp.asarray(d["anchor"]), nwords=jnp.asarray(d["nwords"]),
                      eb=jnp.asarray(d["eb"]), n=d["n"], block=d["block"])
    _f32_equal(jcomp.decompress(jc2), comp.decompress(c).numpy())
    # round trip of the container itself
    again = convert.compressed_to_numpy(convert.compressed_from_numpy(d, "cpu"))
    for k in d:
        np.testing.assert_array_equal(np.asarray(again[k]), np.asarray(d[k]))


@pytest.mark.parametrize("eb", [1e-2, 1e-4])
def test_error_bound_holds(eb):
    x = _data(20_000, 9)
    comp = ErrorBoundedLorenzo(capacity_factor=2.0)
    err = np.abs(comp.decompress(comp.compress(torch.from_numpy(x), eb)).numpy() - x)
    assert err.max() <= eb + np.abs(x).max() * 2**-23


def test_codec_registry():
    assert codecs.codec_names() == ("lorenzo", "lorenzo+entropy", "lossless",
                                    "passthrough")
    comp = codecs.build_compressor("lorenzo", capacity_factor=0.6, fused=True)
    assert comp == ErrorBoundedLorenzo(capacity_factor=0.6)
    assert codecs.codec_capacity_words("lorenzo", 5000, 0.6) == 3000
    with pytest.raises(ValueError, match="plan layer"):
        codecs.build_compressor("auto", capacity_factor=0.6, fused=True)
    with pytest.raises(ValueError, match="unknown codec"):
        codecs.get_codec("zstd")
    two_pass = codecs.build_compressor("lorenzo", capacity_factor=0.6, fused=False)
    assert two_pass == ErrorBoundedLorenzo(capacity_factor=0.6, fused=False)
    assert two_pass.stream_nwords(torch.tensor([3, 0, 32], dtype=torch.int32), 768) == 280


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("n", LENGTHS)
def test_two_pass_compressor_equals_jax(n, cf):
    """``fused=False`` against the JAX two-pass compressor: stream, round
    trip and reduce bitwise."""
    x = _data(n, 5 * n, "rough" if cf == 0.05 else "smooth")
    comp, jcomp = _pair(cf, fused=False)
    c, jc = comp.compress(torch.from_numpy(x), 1e-4), jcomp.compress(jnp.asarray(x), 1e-4)
    _assert_same_stream(c, jc)
    _f32_equal(comp.decompress(c).numpy(), jcomp.decompress(jc))
    acc = _data(n, 5 * n + 1, "rough")
    _f32_equal(comp.decompress_reduce(c, torch.from_numpy(acc)).numpy(),
               jcomp.decompress_reduce(jc, jnp.asarray(acc)))


@pytest.mark.parametrize("return_updated", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_two_pass_decompress_reduce_compress_equals_jax(n, return_updated):
    x, acc = _data(n, 6 * n), _data(n, 6 * n + 1)
    comp, jcomp = _pair(0.6, fused=False)
    c, jc = comp.compress(torch.from_numpy(x), 1e-4), jcomp.compress(jnp.asarray(x), 1e-4)
    out, upd = comp.decompress_reduce_compress(
        c, torch.from_numpy(acc), 3e-5, return_updated=return_updated)
    jout, jupd = jcomp.decompress_reduce_compress(
        jc, jnp.asarray(acc), 3e-5, return_updated=return_updated)
    _assert_same_stream(out, jout)
    assert (upd is None) == (jupd is None) == (not return_updated)
    if return_updated:
        _f32_equal(upd.numpy(), jupd)


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("n", LENGTHS)
def test_two_pass_streams_equal_fused_streams(n, cf):
    x = torch.from_numpy(_data(n, 7 * n, "rough" if cf == 0.05 else "smooth"))
    fused, two_pass = ErrorBoundedLorenzo(cf), ErrorBoundedLorenzo(cf, fused=False)
    _assert_same_stream(two_pass.compress(x, 1e-4), fused.compress(x, 1e-4))
    if cf != 0.05:  # an overflowed stream decodes by each path's own rule
        c = fused.compress(x, 1e-4)
        _f32_equal(two_pass.decompress(c).numpy(), fused.decompress(c).numpy())
