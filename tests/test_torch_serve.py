"""The port's decode path and serving loop against the JAX package, on the
CPU.

* ``Model.decode_fn``, step by step, against the reference's with the same
  weights (``convert.params_from_jax``), the same tokens and zero f32
  caches, the reference run op by op (``jax.disable_jit``) as the port
  runs.  With f32 weights the logits of every step agree at rel 1e-5
  (relative to the step's largest logit), where the algorithm is the
  point.  With the bf16 weights the two agree to ~1e-7 at most steps, but
  the packages' f32 exp, sin and cos differ by a unit in the last place
  at some arguments (``test_torch_model.py`` holds RoPE at 1e-6), and such
  a unit can flip the bf16 rounding of one activation or cached k, which
  moves that step's logits by ~1 % (0.94 % measured with the window cache
  at step 10): the bf16 bound is rel 2e-2, two such flips.  (Under ``jit``
  XLA also keeps f32 between the bf16 ops it fuses, which moves the bf16
  logits by up to 1.3 %.)  Greedy tokens are compared only where the
  reference's top-2 logit gap exceeds the tolerance, both packages fed the
  reference's tokens.
* Token-by-token decode against the full-sequence forward (through the
  flash kernel's path) at rel 0.05, the bound of
  ``tests/test_prefill_decode_consistency.py``, with a full cache and with a
  ring-buffer ``window`` cache shorter than the sequence.
* ``serve(["--arch", "minitron-8b", "--smoke", "--device", "cpu", ...])``
  runs and prints the reference's two lines.
"""
import dataclasses
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jattention
from repro.models import model as jmodel
from repro.models import parallel as jparallel
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models.attention import KVCacheSpec
from repro_torch.models.layers import embed_lookup, rms_norm, vocab_parallel_logits
from repro_torch.models.model import Model
from repro_torch.models.parallel import ParallelCtx

JCTX = jparallel.ParallelCtx(tp_size=1, fsdp_size=1, remat="none")
CTX = ParallelCtx(remat="none")
STEP_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # see the module docstring
B, S = 2, 24


def _pair(dtype, seed=2, **cfg_kw):
    jcfg = dataclasses.replace(jregistry.get("minitron-8b", smoke=True), **cfg_kw)
    tcfg = dataclasses.replace(registry.get("minitron-8b", smoke=True), **cfg_kw)
    jm = jmodel.Model(jcfg, JCTX)
    jp = jparallel.init_params(jm.param_defs(), jax.random.key(seed))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, Model(tcfg, CTX, params=tp, device="cpu"), tp


def _rel(got, want):
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(dtype, window):
    jm, jp, tm, tp = _pair(dtype)
    spec_kw = dict(s_total=S, cp_axis=None, cp_size=1, window=window)
    jspec, tspec = jattention.KVCacheSpec(**spec_kw), KVCacheSpec(**spec_kw)
    jcache = {k: jnp.zeros(v, jnp.float32) for k, v in jm.cache_defs(B, jspec).items()}
    tshapes = tm.cache_defs(B, tspec)
    assert tshapes == jm.cache_defs(B, jspec)
    tcache = {k: torch.zeros(v) for k, v in tshapes.items()}
    tokens = np.random.default_rng(0).integers(0, 512, (B, S)).astype(np.int32)
    tok, compared = tokens[:, :1], 0
    for i in range(S):
        with jax.disable_jit():
            want, jcache = jm.decode_fn(jp, jcache, jnp.asarray(tok), jnp.int32(i), jspec)
        got, tcache = tm.decode_fn(tp, tcache, torch.from_numpy(tok), i, tspec)
        want, got = np.asarray(want), got.numpy()
        assert got.shape == want.shape == (B, 1, 512) and got.dtype == np.float32
        assert _rel(got, want) <= STEP_TOL[dtype], (i, _rel(got, want))
        assert _rel(tcache["k"].numpy(), np.asarray(jcache["k"])) <= STEP_TOL[dtype]
        top2 = np.sort(want[:, 0], axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > STEP_TOL[dtype] * np.abs(want).max()
        np.testing.assert_array_equal(got[clear, 0].argmax(-1), want[clear, 0].argmax(-1))
        compared += int(clear.sum())
        # the next input: the prompt, then the reference's greedy token
        tok = tokens[:, i + 1:i + 2] if i + 1 < S // 2 else want.argmax(-1).astype(np.int32)
    assert compared >= B * S // 2


def _forward_logits(model, params, tokens, window=0):
    """The full-sequence logits at every position (the prefill reference)."""
    h = embed_lookup(torch.from_numpy(tokens), params["embed"], model.ctx)
    h, _ = model._backbone(h, params, positions=torch.arange(h.shape[1]), window=window)
    h = rms_norm(h, params["final_norm"], model.cfg.norm_eps)
    return vocab_parallel_logits(h, params["unembed"], model.ctx)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("flash", [False, True])
def test_decode_matches_prefill(flash, window):
    cfg = dataclasses.replace(registry.get("minitron-8b", smoke=True),
                              use_flash_kernel=flash, sliding_window=window)
    model = Model(cfg, CTX, device="cpu", seed=2)
    params = model.params()
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    with torch.inference_mode():
        want = _forward_logits(model, params, tokens, window).numpy()
        spec = KVCacheSpec(s_total=S, cp_axis=None, cp_size=1, window=window)
        cache = {k: torch.zeros(v) for k, v in model.cache_defs(B, spec).items()}
        got = []
        for i in range(S):
            logits, cache = model.decode_fn(params, cache, tokens[:, i:i + 1], i, spec)
            got.append(logits[:, 0].numpy())
    err = _rel(np.stack(got, axis=1), want)
    assert err < 0.05, f"decode/prefill mismatch: rel {err}"


def test_decode_matches_jax_prefill():
    """The port's decode against the reference's full-sequence forward."""
    jm, jp, tm, tp = _pair("float32")
    tokens = np.random.default_rng(1).integers(0, 512, (B, S)).astype(np.int32)

    def fwd(p, t):
        from repro.models.layers import embed_lookup as je, rms_norm as jr
        from repro.models.layers import vocab_parallel_logits as jv

        h = je(t, p["embed"], JCTX)
        h, _ = jm._backbone(h, p, positions=jnp.arange(t.shape[1]))
        return jv(jr(h, p["final_norm"], jm.cfg.norm_eps), p["unembed"], JCTX)

    want = np.asarray(jax.jit(fwd)(jp, tokens))
    spec = KVCacheSpec(s_total=S, cp_axis=None, cp_size=1)
    cache = {k: torch.zeros(v) for k, v in tm.cache_defs(B, spec).items()}
    got = np.stack([tm.decode_fn(tp, cache, tokens[:, i:i + 1], i, spec)[0][:, 0].numpy()
                    for i in range(S)], axis=1)
    assert _rel(got, want) < 0.05


def test_serve_runs_on_the_cpu_and_prints():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        gen = serve.serve(["--arch", "minitron-8b", "--smoke", "--device", "cpu", "--batch",
                           "2", "--prompt-len", "5", "--gen", "6", "--cache-len", "16"])
    lines = out.getvalue().splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("arch=minitron-smoke decoded 7 tokens x2 in ")
    assert "tok/s incl. prefill" in lines[0] and lines[1].startswith("sample:")
    assert gen.shape == (2, 7) and gen.dtype == np.int32
    assert ((0 <= gen) & (gen < 512)).all()


@pytest.mark.parametrize("arch", ["minitron-8b", "mamba2-780m", "zamba2-2.7b", "minicpm3-4b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_serve_is_deterministic_and_matches_the_model(arch):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "4", "--gen", "3", "--cache-len", "16", "--seed", "5"]
    with contextlib.redirect_stdout(io.StringIO()):
        a, b = serve.serve(argv), serve.serve(argv)
    np.testing.assert_array_equal(a, b)
    # the same loop by hand on the same seed's model
    cfg = registry.get(arch, smoke=True)
    model = Model(cfg, ParallelCtx(), device="cpu", seed=5)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    spec = KVCacheSpec(s_total=16, cp_axis=None, cp_size=1)
    cache = {k: torch.zeros(v) for k, v in model.cache_defs(2, spec).items()}
    tok, out = None, []
    for i in range(7):
        tok = torch.from_numpy(prompt[:, i:i + 1]) if i < 4 else tok
        logits, cache = model.decode_fn(model.params(), cache, tok, i, spec)
        if i >= 3:
            tok = logits[:, :, :cfg.vocab].argmax(-1).to(torch.int32)
            out.append(tok[:, 0].numpy())
    np.testing.assert_array_equal(a, np.stack(out, axis=1))


def test_serve_defaults_to_the_reference_arch():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.serve(["--smoke", "--device", "cpu", "--batch", "1", "--prompt-len", "2",
                     "--gen", "1", "--cache-len", "4"])
    assert out.getvalue().startswith("arch=mamba2-smoke decoded 2 tokens x1 in ")


@pytest.mark.parametrize("arch,arch_id", [("seamless-m4t-medium", "seamless-m4t-medium-smoke"),
                                          ("internvl2-26b", "internvl2-smoke")])
def test_serve_runs_the_encdec_and_vlm_families(arch, arch_id):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        gen = serve.serve(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                           "--prompt-len", "4", "--gen", "3", "--cache-len", "16"])
    assert out.getvalue().startswith(f"arch={arch_id} decoded 4 tokens x2 in ")
    assert gen.shape == (2, 4) and ((0 <= gen) & (gen < 512)).all()
