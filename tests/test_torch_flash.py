"""Kernel 11's plain version and the chunked attention path against the
JAX package, on the CPU.

* ``repro_torch.kernels.flash_attn.flash_attention`` on CPU tensors (the
  plain version of the CUDA kernel) against the Pallas kernel in interpret
  mode over the sweeps of ``tests/test_flash_kernel.py`` (plus D = 32, the
  smoke configs' head dim), with its tolerances: atol = rtol = 2e-5 in f32,
  2e-2 in bf16 (the two sum in other orders; bf16 adds an output rounding).
* The port's chunked ``models.attention.flash_attention`` and
  ``kernels.ref.attention_ref`` against JAX's.
* Tile skipping: the CUDA kernel walks only the kv tiles its q tile can
  see (``csrc/flash_attn.cu``).  ``_kernel_walk`` below replays that walk
  (32-row q tiles, 64-key tiles, the same range rule) in torch, and is held
  against the reference where whole tiles are masked: windows that cross
  tile boundaries, and rows that see no key at all.
* Dispatch: a CPU tensor takes the plain version and launches nothing;
  other devices raise.
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

KERNEL_BQ, KERNEL_BK = 32, 64  # csrc/flash_attn.cu: kBQ, kBK


def _kernel_walk(q, k, v, *, causal, window):
    """csrc/flash_attn.cu's walk in torch, (BH, S, D) f32: per 32-row q tile
    only the 64-key tiles in [k_begin, k_end), with the kernel's range rule.
    Returns (output, number of tiles walked, number the reference visits)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = flash_attn._scale(d)
    out = torch.zeros_like(q)
    walked, full = 0, 0
    for q0 in range(0, sq, KERNEL_BQ):
        q_last = min(q0 + KERNEL_BQ, sq) - 1
        k_begin, k_end = 0, sk
        if causal:
            k_end = min(sk, q_last + 1)
            if window > 0:
                k_begin = max(0, q0 - window + 1)
                if q_last >= sk - 1 + window:
                    k_begin, k_end = 0, -(-sk // 128) * 128
        qs = q[:, q0:q0 + KERNEL_BQ] * scale
        qp = torch.arange(q0, q0 + qs.shape[1])[:, None]
        m = torch.full((bh, qs.shape[1], 1), -1e30)
        l = torch.zeros((bh, qs.shape[1], 1))
        acc = torch.zeros((bh, qs.shape[1], d))
        for k0 in range(k_begin // KERNEL_BK * KERNEL_BK, k_end, KERNEL_BK):
            walked += 1
            kt = torch.zeros((bh, KERNEL_BK, d))
            vt = torch.zeros((bh, KERNEL_BK, d))
            n = max(0, min(sk - k0, KERNEL_BK))
            kt[:, :n], vt[:, :n] = k[:, k0:k0 + n], v[:, k0:k0 + n]
            kp = torch.arange(k0, k0 + KERNEL_BK)[None, :]
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
        full += -(-sk // 128) * 2
        out[:, q0:q0 + KERNEL_BQ] = acc / torch.clamp(l, min=1e-30)
    return out, walked, full


@pytest.mark.parametrize("sq,sk,causal,window", [
    (384, 384, True, 64),     # q tiles whose first kv tiles are fully masked
    (384, 384, True, 100),    # a window that crosses 64- and 128-key tiles
    (300, 300, True, 1000),   # a window wider than the sequence
    (256, 256, True, 0),      # causal: the upper kv tiles skipped
    (300, 100, True, 64),     # rows that see no key: the padded average
    (100, 300, False, 0),
])
def test_kernel_tile_walk_is_exact(sq, sk, causal, window):
    (jq, jk, jv), (q, k, v) = _inputs(8, 2, sq, sk, 1, 32, "float32")
    want = jflash.flash_attention_bhsd(jq[:, :, 0], jk[:, :, 0], jv[:, :, 0],
                                       causal=causal, window=window)
    got, walked, full = _kernel_walk(q[:, :, 0], k[:, :, 0], v[:, :, 0], causal=causal,
                                     window=window)
    _check(got, want, "float32")
    _check(flash_attn.flash_attention_bhsd(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                           causal=causal, window=window), want, "float32")
    if causal and sq == sk:
        assert walked < full  # masked tiles were skipped


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

