"""Kernel 11's plain version and the chunked attention path against the
JAX package, on the CPU.

* ``repro_torch.kernels.flash_attn.flash_attention`` on CPU tensors (the
  plain version of the CUDA kernel) against the Pallas kernel in interpret
  mode over the sweeps of ``tests/test_flash_kernel.py`` (plus D = 32, the
  smoke configs' head dim), with its tolerances: atol = rtol = 2e-5 in f32,
  2e-2 in bf16 (the two sum in other orders; bf16 adds an output rounding).
* The port's chunked ``models.attention.flash_attention`` and
  ``kernels.ref.attention_ref`` against JAX's.
* Tile skipping: the CUDA kernels walk only the kv tiles their q tile can
  see.  ``_kernel_walk`` below replays that walk in torch at both kernels'
  tiles (32-row q tiles and 64-key tiles in ``csrc/flash_attn.cu``, 128 x
  128 in ``csrc/flash_attn_sm90.cu``, the same range rule), and is held
  against the reference where whole tiles are masked: windows that cross
  tile boundaries, and rows that see no key at all.
* The bf16 tensor-core kernel's arithmetic (``csrc/flash_attn_sm90.cu``):
  ``_tensor_core_emulation`` repeats it in torch (bf16 inputs, f32
  products, the scale applied to S after the product in log2 units, exp2,
  l from f32 P, P rounded to bf16 before P.V) and is held against the
  Pallas kernel in interpret mode at the bf16 tolerance.
* Dispatch: a CPU tensor takes the plain version and launches nothing;
  other devices raise; on a CUDA tensor bf16 takes the tensor-core entry
  point and f32 the CUDA-core one, counted in ``ROUTES``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attn as jflash
from repro.kernels import ref as jref
from repro.models import attention as jattention
from repro_torch.kernels import flash_attn, ref
from repro_torch.models import attention

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b, sq, sk, h, d, dtype):
    rng = np.random.default_rng(seed)
    jd, td = DT[dtype]
    arrs = [rng.normal(0, 1, (b, s, h, d)).astype(np.float32) for s in (sq, sk, sk)]
    return [jnp.asarray(a, jd) for a in arrs], [torch.from_numpy(a).to(td) for a in arrs]


def _check(got, want, dtype):
    assert got.dtype == DT[dtype][1]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk", [(128, 128), (256, 256), (100, 300)])
@pytest.mark.parametrize("d", [64, 128])
def test_plain_matches_pallas_causal(dtype, sq, sk, d):
    (jq, jk, jv), (q, k, v) = _inputs(0, 2, sq, sk, 2, d, dtype)
    want = jflash.flash_attention(jq, jk, jv, causal=True)
    _check(flash_attn.flash_attention(q, k, v, causal=True), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_head_dim_32(dtype):
    (jq, jk, jv), (q, k, v) = _inputs(1, 2, 200, 200, 4, 32, dtype)
    want = jflash.flash_attention(jq, jk, jv, causal=True)
    _check(flash_attn.flash_attention(q, k, v, causal=True), want, dtype)


@pytest.mark.parametrize("window", [64, 128, 100])
def test_plain_matches_pallas_sliding_window(window):
    (jq, jk, jv), (q, k, v) = _inputs(2, 1, 256, 256, 2, 64, "float32")
    want = jflash.flash_attention(jq, jk, jv, causal=True, window=window)
    _check(flash_attn.flash_attention(q, k, v, causal=True, window=window), want,
           "float32")


@pytest.mark.parametrize("sq,sk", [(130, 200), (100, 300)])
def test_plain_matches_pallas_non_causal(sq, sk):
    (jq, jk, jv), (q, k, v) = _inputs(3, 1, sq, sk, 1, 64, "float32")
    want = jflash.flash_attention(jq, jk, jv, causal=False)
    _check(flash_attn.flash_attention(q, k, v, causal=False), want, "float32")


def test_bhsd_call_matches_pallas():
    (jq, jk, jv), (q, k, v) = _inputs(4, 3, 150, 150, 1, 64, "float32")
    want = jflash.flash_attention_bhsd(jq[:, :, 0], jk[:, :, 0], jv[:, :, 0], causal=True)
    _check(flash_attn.flash_attention_bhsd(q[:, :, 0], k[:, :, 0], v[:, :, 0]), want,
           "float32")


@pytest.mark.parametrize("causal,window,q_offset,chunk", [
    (True, 0, 0, 1024), (True, 0, 0, 64), (True, 48, 0, 64), (False, 0, 0, 96),
    (True, 0, 40, 64)])
def test_chunked_path_matches_jax(causal, window, q_offset, chunk):
    (jq, jk, jv), (q, k, v) = _inputs(5, 2, 150, 190, 3, 32, "float32")
    want = jattention.flash_attention(jq, jk, jv, causal=causal, window=window,
                                      q_offset=q_offset, chunk=chunk)
    got = attention.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, chunk=chunk)
    _check(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_path_bf16_and_f32(dtype):
    (jq, jk, jv), (q, k, v) = _inputs(6, 1, 192, 192, 2, 64, dtype)
    want = jattention.flash_attention(jq, jk, jv, causal=True)
    _check(attention.flash_attention(q, k, v, causal=True), want, dtype)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32), (False, 0)])
def test_attention_ref_matches_jax(causal, window):
    (jq, jk, jv), (q, k, v) = _inputs(7, 2, 70, 70, 2, 32, "float32")
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    _check(ref.attention_ref(q, k, v, causal=causal, window=window), want, "float32")


# ---------------------------------------------------------------------------
# The kernel's tile walk
# ---------------------------------------------------------------------------

# (q rows, keys) per tile: csrc/flash_attn.cu's kBQ, kBK (f32) and
# csrc/flash_attn_sm90.cu's (bf16)
TILES = {"cuda_core_f32": (32, 64), "tensor_core_bf16": (128, 128)}


def _kv_range(q0, bq, sq, sk, causal, window):
    """The kernels' range rule: [k_begin, k_end) of the keys that some row of
    the q tile at q0 can see, or the whole 128-padded range when a row of
    it sees none."""
    q_last = min(q0 + bq, sq) - 1
    k_begin, k_end = 0, sk
    if causal:
        k_end = min(sk, q_last + 1)
        if window > 0:
            k_begin = max(0, q0 - window + 1)
            if q_last >= sk - 1 + window:
                k_begin, k_end = 0, -(-sk // 128) * 128
    return k_begin, k_end


def _kernel_walk(q, k, v, *, causal, window, tiles=TILES["cuda_core_f32"]):
    """The CUDA kernels' walk in torch, (BH, S, D) f32: per q tile only the
    key tiles in [k_begin, k_end), with the kernels' range rule.  Returns
    (output, number of tiles walked, number the reference visits)."""
    kernel_bq, kernel_bk = tiles
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = flash_attn._scale(d)
    out = torch.zeros_like(q)
    walked, full = 0, 0
    for q0 in range(0, sq, kernel_bq):
        k_begin, k_end = _kv_range(q0, kernel_bq, sq, sk, causal, window)
        qs = q[:, q0:q0 + kernel_bq] * scale
        qp = torch.arange(q0, q0 + qs.shape[1])[:, None]
        m = torch.full((bh, qs.shape[1], 1), -1e30)
        l = torch.zeros((bh, qs.shape[1], 1))
        acc = torch.zeros((bh, qs.shape[1], d))
        for k0 in range(k_begin // kernel_bk * kernel_bk, k_end, kernel_bk):
            walked += 1
            kt = torch.zeros((bh, kernel_bk, d))
            vt = torch.zeros((bh, kernel_bk, d))
            n = max(0, min(sk - k0, kernel_bk))
            kt[:, :n], vt[:, :n] = k[:, k0:k0 + n], v[:, k0:k0 + n]
            kp = torch.arange(k0, k0 + kernel_bk)[None, :]
            ok = (kp < sk) & (qp < sq)
            if causal:
                ok &= kp <= qp
                if window:
                    ok &= kp > qp - window
            s = torch.where(ok, qs @ kt.transpose(1, 2), torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p @ vt
            m = m_new
        full += -(-sk // 128) * 128 // kernel_bk
        out[:, q0:q0 + kernel_bq] = acc / torch.clamp(l, min=1e-30)
    return out, walked, full


@pytest.mark.parametrize("route", sorted(TILES))
@pytest.mark.parametrize("sq,sk,causal,window", [
    (384, 384, True, 64),     # q tiles whose first kv tiles are fully masked
    (384, 384, True, 100),    # a window that crosses 64- and 128-key tiles
    (300, 300, True, 1000),   # a window wider than the sequence
    (256, 256, True, 0),      # causal: the upper kv tiles skipped
    (300, 100, True, 64),     # rows that see no key: the padded average
    (100, 300, False, 0),
])
def test_kernel_tile_walk_is_exact(sq, sk, causal, window, route):
    (jq, jk, jv), (q, k, v) = _inputs(8, 2, sq, sk, 1, 32, "float32")
    want = jflash.flash_attention_bhsd(jq[:, :, 0], jk[:, :, 0], jv[:, :, 0],
                                       causal=causal, window=window)
    got, walked, full = _kernel_walk(q[:, :, 0], k[:, :, 0], v[:, :, 0], causal=causal,
                                     window=window, tiles=TILES[route])
    _check(got, want, "float32")
    _check(flash_attn.flash_attention_bhsd(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                           causal=causal, window=window), want, "float32")
    if causal and sq == sk:
        assert walked < full  # masked tiles were skipped


# ---------------------------------------------------------------------------
# The bf16 tensor-core kernel's arithmetic
# ---------------------------------------------------------------------------

NEG_LOG2 = float(np.float32(-1e30) * np.float32(np.log2(np.e)))  # kNegLog2


def _tensor_core_emulation(q, k, v, *, causal, window):
    """csrc/flash_attn_sm90.cu's arithmetic in torch on (BH, S, D) bf16:
    128-row q tiles and 128-key tiles walked by the range rule; S = q.k^T
    of the bf16 values in f32, then times the folded scale f32(1/sqrt(D))
    * log2(e) (masked: -1e30 * log2(e)); the running max and l in f32, p =
    exp2(t - max), l summed from the f32 p; P rounded to bf16 for P.V with
    f32 accumulation; O / max(l, 1e-30) rounded to bf16."""
    bq, bk = TILES["tensor_core_bf16"]
    bh, sq, d = q.shape
    sk = k.shape[1]
    c = torch.tensor(flash_attn._scale_log2(d), dtype=torch.float32)
    neg = torch.tensor(NEG_LOG2, dtype=torch.float32)
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    out = torch.empty_like(q)
    for q0 in range(0, sq, bq):
        k_begin, k_end = _kv_range(q0, bq, sq, sk, causal, window)
        qt = qf[:, q0:q0 + bq]
        qp = torch.arange(q0, q0 + qt.shape[1])[:, None]
        m = torch.full((bh, qt.shape[1], 1), NEG_LOG2)
        l = torch.zeros((bh, qt.shape[1], 1))
        acc = torch.zeros((bh, qt.shape[1], d))
        for k0 in range(k_begin // bk * bk, k_end, bk):
            kt = torch.zeros((bh, bk, d))
            vt = torch.zeros((bh, bk, d))
            n = min(sk - k0, bk)
            kt[:, :n], vt[:, :n] = kf[:, k0:k0 + n], vf[:, k0:k0 + n]
            kp = torch.arange(k0, k0 + bk)[None, :]
            ok = kp < sk
            if causal:
                ok = ok & (kp <= qp)
                if window:
                    ok = ok & (kp > qp - window)
            t = torch.where(ok, (qt @ kt.transpose(1, 2)) * c, neg)
            m_new = torch.maximum(m, t.amax(-1, keepdim=True))
            p = torch.exp2(t - m_new)
            corr = torch.exp2(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.to(torch.bfloat16).to(torch.float32) @ vt
            m = m_new
        out[:, q0:q0 + bq] = (acc / torch.clamp(l, min=1e-30)).to(torch.bfloat16)
    return out


# (b, sq, sk, h, d, causal, window).  The largest |emulation - Pallas| over
# these cases is 2^-7 = 7.8125e-3, one bf16 ulp of an output in [1, 2)
# (1.95e-3 non-causal; 0 at Sk = 1 and Sq = 1), inside atol = rtol = 2e-2.
EMULATION_CASES = [
    (2, 300, 300, 2, 32, True, 0),
    (2, 300, 300, 2, 64, True, 0),
    (2, 300, 300, 2, 128, True, 0),
    (1, 384, 384, 2, 64, True, 64),
    (1, 384, 384, 2, 128, True, 100),   # a window crossing a 128-key tile
    (1, 300, 300, 2, 32, True, 1000),   # a window wider than the sequence
    (2, 100, 300, 2, 64, False, 0),     # non-causal, Sq < Sk
    (1, 260, 130, 2, 128, False, 0),    # non-causal, Sq > Sk, ragged
    (3, 77, 77, 3, 64, True, 0),        # ragged, one partial q tile
    (1, 300, 100, 2, 32, True, 64),     # rows that see no key
    (1, 129, 1, 1, 128, True, 0),
    (1, 1, 129, 1, 64, True, 0),
]


@pytest.mark.parametrize("b,sq,sk,h,d,causal,window", EMULATION_CASES)
def test_tensor_core_emulation_matches_pallas(b, sq, sk, h, d, causal, window):
    (jq, jk, jv), (q, k, v) = _inputs(11, b, sq, sk, h, d, "bfloat16")
    to_bhsd = lambda x: x.transpose(1, 2).reshape(b * h, x.shape[1], d)  # noqa: E731
    want = jflash.flash_attention(jq, jk, jv, causal=causal, window=window)
    got = _tensor_core_emulation(to_bhsd(q), to_bhsd(k), to_bhsd(v), causal=causal,
                                 window=window)
    got = got.reshape(b, h, sq, d).transpose(1, 2)
    _check(got, want, "bfloat16")


def test_tensor_core_scale_is_folded_in_f32():
    for d in flash_attn.HEAD_DIMS:
        want = np.float32(np.float32(1.0 / np.sqrt(d)) * np.float32(np.log2(np.e)))
        assert np.float32(flash_attn._scale_log2(d)) == want


def test_fully_masked_first_tile_pinned():
    """A q tile whose first kv tile is entirely masked: with -inf masking the
    first step would give exp(-inf + inf) = NaN; -1e30 gives garbage that the
    first real key's corr = 0 wipes out."""
    (jq, jk, jv), (q, k, v) = _inputs(9, 1, 256, 256, 1, 64, "float32")
    got = flash_attn.flash_attention(q, k, v, causal=True, window=64)
    want = ref.attention_ref(q, k, v, causal=True, window=64)
    assert torch.isfinite(got).all()
    _check(got, np.asarray(want), "float32")
    # row 200 sees keys 137..200 only: kv tile 0 (keys 0..127) is all masked
    row = got[0, 200, 0]
    s = (q[0, 200, 0] @ k[0, 137:201, 0].T) * flash_attn._scale(64)
    expect = torch.softmax(s, -1) @ v[0, 137:201, 0]
    torch.testing.assert_close(row, expect, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("the CUDA kernel was called for CPU tensors")

    monkeypatch.setattr(flash_attn, "flash_attention_kernel", no_kernel)
    flash_attn.reset_launch_counts()
    _, (q, k, v) = _inputs(10, 1, 40, 40, 2, 32, "bfloat16")
    out = flash_attn.flash_attention(q, k, v)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    flash_attn.flash_attention_bhsd(q[:, :, 0], k[:, :, 0], v[:, :, 0])
    assert flash_attn.LAUNCHES == {"flash_attention": 0}
    assert flash_attn.ROUTES == {"tensor_core_bf16": 0, "cuda_core_f32": 0}


def test_kernel_routes_by_dtype(monkeypatch):
    """bf16 goes to the tensor-core entry point, f32 to the CUDA-core one;
    each call is counted once in LAUNCHES and once under its route.  The
    device check and the build are faked: there is no card here."""
    calls = []

    class FakeLib:
        def __init__(self, name):
            self.name = name

    monkeypatch.setattr(flash_attn, "_check", lambda *a: None)
    monkeypatch.setattr(flash_attn.build, "load", lambda name, sigs: FakeLib(name))
    monkeypatch.setattr(flash_attn.build, "launch",
                        lambda lib, fn, *args: calls.append((lib.name, fn, args[-1])))
    flash_attn.reset_launch_counts()
    for dt in (torch.bfloat16, torch.float32, torch.bfloat16):
        x = torch.zeros(1, 8, 2, 64, dtype=dt)
        assert flash_attn.flash_attention_kernel(x, x, x).dtype == dt
    assert calls == [
        ("flash_attn_sm90", "fa_forward_tensor_core_bf16", flash_attn._scale_log2(64)),
        ("flash_attn", "fa_forward_cuda_core_f32", flash_attn._scale(64)),
        ("flash_attn_sm90", "fa_forward_tensor_core_bf16", flash_attn._scale_log2(64)),
    ]
    assert flash_attn.LAUNCHES == {"flash_attention": 3}
    assert flash_attn.ROUTES == {"tensor_core_bf16": 2, "cuda_core_f32": 1}
    flash_attn.reset_launch_counts()
    assert flash_attn.ROUTES == {"tensor_core_bf16": 0, "cuda_core_f32": 0}


def test_route_entry_points_exist_in_their_sources():
    """Each route's C entry point is defined, with the wrapper's arity, in
    the source that ``build`` compiles for it."""
    for route, lib, entry in flash_attn._ROUTE_OF.values():
        assert lib in flash_attn.build.SOURCES
        src = (flash_attn.build.CSRC / f"{lib}.cu").read_text()
        head = src[src.index(f"int {entry}("):]
        args = head[:head.index(")")].count(",") + 1
        assert args == len(flash_attn._SIGNATURE), (route, args)


def test_other_devices_and_cpu_kernel_calls_raise():
    q = torch.zeros(1, 8, 1, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attn.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attn.flash_attention_bhsd(q[:, :, 0], q[:, :, 0], q[:, :, 0])
    c = torch.zeros(1, 8, 1, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attn.flash_attention_kernel(c, c, c)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attn.flash_attention_kernel(*(torch.zeros(1, 8, 1, 48),) * 3)
    with pytest.raises(ValueError, match="f32 or bf16"):
        flash_attn.flash_attention_kernel(*(torch.zeros(1, 8, 1, 32, dtype=torch.float16),) * 3)

