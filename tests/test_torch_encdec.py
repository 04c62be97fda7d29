"""The port's encoder-decoder and prefix-frontend families against the JAX
package, on the CPU.

``Model``'s encdec branches (seamless-m4t-medium at its smoke size: 2
encoder and 2 decoder layers, d_model 128, 4 heads of 32, 16 encoder
frames), its vlm branches (internvl2 at its smoke size: 2 layers, d_model
128, 4 heads over 2 kv, a prefix of 16 positions) and the audio family
(the vlm smoke config with ``family="audio"``, ``dataclasses.replace``)
take the same inputs, made from a seed with numpy, and the same weights,
carried across with ``convert.params_from_jax``; the cross-attention path
of ``attention.attention_train`` and ``blocks.dense_block`` (Sq != Sk, no
RoPE, non-causal) is held on its own, through the chunked path and the
flash kernel's plain version (the reference's Pallas kernel in interpret
mode).  Every comparison runs in this process on one CPU device.

The f32 cases run the reference's bf16 weights cast to f32 with
``cfg.dtype = "float32"`` on both sides: the two consistent cases are the
weights' dtype equal to ``cfg.dtype`` (``torch.matmul`` refuses the mixed
products ``jnp`` promotes, and the encoder casts its input to
``cfg.dtype``).  Tolerances, relative to the largest value of the
reference's result, as ``tests/test_torch_model.py``'s ``TOL`` and
``LAYER_TOL``:

  * one layer (cross ``attention_train``, ``dense_block`` with
    ``cross_kv``, ``_encode``): f32 1e-6, bf16 2**-7;
  * ``loss_fn``: f32 1e-5, bf16 2e-3 (the reference jitted);
  * the gradients of ``loss_fn`` at f32, each leaf within 1e-4 of its
    largest value, the MLA tests' bound;
  * decode steps against the reference's jitted decode at f32: 1e-5, and
    against the port's full-sequence forward: 0.05, the bound of
    ``tests/test_prefill_decode_consistency.py``, at f32 and bf16.

Across packages by bits: the ``params_from_jax`` round trip, checkpoints
each way, ``SyntheticStream``'s batches.  Port-only: an unknown family
raises; remat bit-neutral with the encoder stack checkpointed;
``serve``'s ``enc_out`` and prompt are the reference's draws; the serve
step on two ranks, ``enc_out`` split over ``data``; the train step on a
two-rank CPU mesh, replicas equal by bits; each leaf's gradient-sync plan
the reference's; the train CLI's loss falls.
"""
import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jcheckpoint
from repro.configs import registry as jregistry
from repro.core import comm as jcomm
from repro.core import cost_model as jcost_model
from repro.core.collectives import GZConfig as JGZConfig
from repro.data import pipeline as jpipeline
from repro.launch import serve as jserve
from repro.models import attention as jattention
from repro.models import blocks as jblocks
from repro.models import model as jmodel
from repro.models import parallel as jparallel
from repro_torch import convert
from repro_torch.checkpoint import checkpoint
from repro_torch.configs import registry
from repro_torch.core import cost_model
from repro_torch.core.collectives import GZConfig
from repro_torch.core.comm import GZCommunicator
from repro_torch.core.grad_sync import tree_flatten
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.launch import serve, shapes, training
from repro_torch.launch.mesh import ThreadMesh
from repro_torch.launch.train import train
from repro_torch.models import attention, blocks, layers, parallel
from repro_torch.models.attention import KVCacheSpec
from repro_torch.models.model import Model
from repro_torch.optim import adamw

ENCDEC, VLM, AUDIO = "seamless-m4t-medium", "internvl2-26b", "audio"
JCTX = jparallel.ParallelCtx(tp_size=1, fsdp_size=1, remat="none")
CTX = parallel.ParallelCtx(remat="none")
TOL = {"float32": 1e-5, "bfloat16": 2e-3}
LAYER_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
GRAD_TOL = 1e-4
B, S = 2, 24  # S text tokens; the vlm and audio batches add n_prefix (16) before them


def _cfgs(arch, dtype="bfloat16", **kw):
    """(JAX config, port config) at smoke size: ``arch``, or ``AUDIO`` (the
    vlm smoke config as the audio family), with ``cfg.dtype`` ``dtype``."""
    out = []
    for reg in (jregistry, registry):
        cfg = reg.get(VLM if arch == AUDIO else arch, smoke=True)
        if arch == AUDIO:
            cfg = dataclasses.replace(cfg, family="audio", arch_id="audio-smoke")
        out.append(dataclasses.replace(cfg, dtype=dtype, **kw))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jparams(arch, dtype, seed=0):
    """The reference's init from ``key(seed)`` (its bf16 weights), cast to
    f32 for ``dtype`` f32 (cached: the tests only read it)."""
    jcfg, _ = _cfgs(arch)
    params = jparallel.init_params(jmodel.Model(jcfg, JCTX).param_defs(),
                                   jax.random.key(seed))
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return params


def _both(arch, dtype, seed=0):
    params = _jparams(VLM if arch == AUDIO else arch, dtype, seed)
    return params, convert.params_from_jax(jax.tree.map(np.asarray, params), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _close(got, want, rel):
    err = _rel(got, want)
    assert err <= rel, f"rel err {err} > {rel}"


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(parallel.torch_dtype(dtype))


def _eager(dtype):
    """The reference op by op for bf16 (ROADMAP C21: XLA keeps f32 between
    the bf16 ops it fuses, inside a scan body even without ``jit``, and
    two bf16 layers then differ from eager rounding by 1.1e-2 of the
    encoder's largest output; eager, the port's equals it by bits)."""
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


def _batch(cfg, s=S, seed=0):
    """A batch as ``SyntheticStream`` makes one for ``cfg``'s family, the
    first three labels masked."""
    batch = next(SyntheticStream(cfg, B, s + (cfg.n_prefix if cfg.family in ("vlm", "audio")
                                              else 0), seed=seed))
    batch["labels"][:, :3] = -1
    return batch


# ---------------------------------------------------------------------------
# The cross-attention path and the encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_and_block_match_jax(dtype, flash):
    """Sq = 24 decoder rows over Sk = 16 encoder rows: no RoPE on either,
    every key seen (non-causal), through the chunked path and kernel 11's
    plain version (the Pallas kernel in interpret mode)."""
    jcfg, tcfg = _cfgs(ENCDEC, dtype, use_flash_kernel=flash)
    jp, tp = _both(ENCDEC, dtype)
    jw, tw = _layer0(jp["blocks"]), _layer0(tp["blocks"])
    assert sorted(tw) == ["attn", "cross", "ln1", "ln2", "ln_cross", "mlp"]
    jh, th = _x((B, S, tcfg.d_model), dtype, 1)
    je, te = _x((B, tcfg.n_prefix, tcfg.d_model), dtype, 2)
    jpos, tpos = jnp.arange(S), torch.arange(S)
    want = jattention.attention_train(jh, jw["cross"], jcfg, JCTX, positions=jpos,
                                      causal=False, cross_kv=je)
    got = attention.attention_train(th, tw["cross"], tcfg, CTX, positions=tpos,
                                    causal=False, cross_kv=te)
    assert got.dtype == th.dtype
    _close(got, want, LAYER_TOL[dtype])
    # the positions do not enter the cross path: other positions, the same bits
    again = attention.attention_train(th, tw["cross"], tcfg, CTX, positions=tpos + 7,
                                      causal=True, cross_kv=te)
    assert torch.equal(again, got)
    want = jblocks.dense_block(jh, jw, jcfg, JCTX, positions=jpos, cross_kv=je)
    got = blocks.dense_block(th, tw, tcfg, CTX, positions=tpos, cross_kv=te)
    _close(got, want, LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    """The encoder: f32 frames cast to ``cfg.dtype``, two non-causal dense
    blocks with positions from 0, ``enc_norm``."""
    jcfg, tcfg = _cfgs(ENCDEC, dtype)
    jp, tp = _both(ENCDEC, dtype)
    x = np.random.default_rng(3).normal(0, 1, (B, tcfg.n_prefix, tcfg.d_model)).astype(
        np.float32)
    with _eager(dtype):
        want = jmodel.Model(jcfg, JCTX)._encode(jp, jnp.asarray(x))
    got = Model(tcfg, CTX, params=tp, device="cpu")._encode(tp, torch.from_numpy(x))
    assert got.dtype == parallel.torch_dtype(dtype) and got.shape == (B, tcfg.n_prefix,
                                                                      tcfg.d_model)
    _close(got, want, LAYER_TOL[dtype])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [ENCDEC, VLM, AUDIO])
def test_loss_fn_matches_jax(arch, dtype, flash):
    jcfg, tcfg = _cfgs(arch, dtype, use_flash_kernel=flash)
    jp, tp = _both(arch, dtype)
    batch = _batch(tcfg)
    assert ("enc_input" in batch) == (arch == ENCDEC) and ("prefix" in batch) != (arch == ENCDEC)
    want = float(jax.jit(jmodel.Model(jcfg, JCTX).loss_fn)(jp, batch))
    model = Model(tcfg, CTX, params=tp, device="cpu")
    got = model.loss_fn(tp, batch)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(model(batch)) == float(got)
    assert np.isfinite(float(got)) and abs(float(got) - want) <= TOL[dtype] * abs(want), \
        (float(got), want)


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_loss_gradients_match_jax(arch):
    jcfg, tcfg = _cfgs(arch, "float32")
    jp, tp = _both(arch, "float32")
    batch = _batch(tcfg)
    want = jax.jit(jax.grad(jmodel.Model(jcfg, JCTX).loss_fn))(jp, batch)
    leaves, rebuild = tree_flatten(tp)
    req = [p.detach().requires_grad_(True) for p in leaves]
    model = Model(tcfg, CTX, params=tp, device="cpu")
    got = rebuild(list(torch.autograd.grad(model.loss_fn(rebuild(req), batch), req)))
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(paths) == len(leaves) == (27 if arch == ENCDEC else 12)
    for path, w in paths:
        g = got
        for k in path:
            g = g[k.key]
        assert float(np.abs(np.asarray(w)).max()) > 0, path
        _close(g, w, GRAD_TOL)


def _prefill(model, params, tokens, enc_out=None):
    """The full-sequence logits of ``tokens`` (the encdec decoder over
    ``enc_out``, cast to ``cfg.dtype`` as ``_encode`` returns it)."""
    cross = None if enc_out is None else enc_out.to(parallel.torch_dtype(model.cfg.dtype))
    with torch.no_grad():
        h = layers.embed_lookup(torch.from_numpy(tokens), params["embed"], model.ctx)
        h, _ = model._backbone(h, params, positions=torch.arange(tokens.shape[1]),
                               cross_kv=cross)
        h = layers.rms_norm(h, params["final_norm"], model.cfg.norm_eps)
        return layers.vocab_parallel_logits(h, params["unembed"], model.ctx)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_decode_steps_match_jax_and_prefill(arch, flash):
    """f32: every step's logits and the final k, v and enc_out against the
    reference's jitted decode from zero caches (encdec: the encoder's output
    of one batch in ``enc_out``), then the steps against the port's
    full-sequence forward.  With the flash kernel on, each encdec step's
    cross-attention (Sq = 1, Sk = 16) goes through its plain version."""
    jcfg, tcfg = _cfgs(arch, "float32", use_flash_kernel=flash)
    jp, tp = _both(arch, "float32")
    jm, tm = jmodel.Model(jcfg, JCTX), Model(tcfg, CTX, params=tp, device="cpu")
    spec_kw = dict(s_total=S, cp_axis=None, cp_size=1)
    jspec, tspec = jattention.KVCacheSpec(**spec_kw), KVCacheSpec(**spec_kw)
    defs = tm.cache_defs(B, tspec)
    assert defs == jm.cache_defs(B, jspec)
    kv = (tcfg.n_layers, B, S, tcfg.n_kv_heads, tcfg.head_dim)
    assert defs == ({"k": kv, "v": kv, "enc_out": (B, tcfg.n_prefix, tcfg.d_model)}
                    if arch == ENCDEC else {"k": kv, "v": kv})
    jcache = {k: jnp.zeros(v, jnp.float32) for k, v in defs.items()}
    tcache = {k: torch.zeros(v) for k, v in defs.items()}
    enc_out = None
    if arch == ENCDEC:
        enc_out = tm._encode(tp, torch.from_numpy(_batch(tcfg)["enc_input"]))
        tcache["enc_out"].copy_(enc_out)
        jcache["enc_out"] = jnp.asarray(enc_out.numpy())
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, pos: jm.decode_fn(p, c, t, pos, jspec))
    got = []
    for i in range(S):
        jl, jcache = jstep(jp, jcache, jnp.asarray(tokens[:, i:i + 1]), jnp.int32(i))
        with torch.no_grad():
            tl, tcache = tm.decode_fn(tp, tcache, tokens[:, i:i + 1], i, tspec)
        _close(tl, jl, 1e-5)
        got.append(tl[:, 0])
    for k in defs:
        _close(tcache[k], jcache[k], 1e-5)
    assert _rel(torch.stack(got, dim=1), _prefill(tm, tp, tokens, enc_out)) < 0.05


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_bf16_decode_matches_prefill(arch):
    """bf16 weights and ``cfg.dtype``: the encoder's bf16 output cached in
    f32 and cast back to bf16 by decode, so both paths attend over the same
    values."""
    _, tcfg = _cfgs(arch, "bfloat16")
    _, tp = _both(arch, "bfloat16")
    tm = Model(tcfg, CTX, params=tp, device="cpu")
    spec = KVCacheSpec(s_total=S, cp_axis=None, cp_size=1)
    cache = {k: torch.zeros(v) for k, v in tm.cache_defs(B, spec).items()}
    enc_out = None
    if arch == ENCDEC:
        with torch.no_grad():
            enc_out = tm._encode(tp, torch.from_numpy(_batch(tcfg)["enc_input"]))
        assert enc_out.dtype == torch.bfloat16
        cache["enc_out"].copy_(enc_out)
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    with torch.no_grad():
        got = torch.stack([tm.decode_fn(tp, cache, tokens[:, i:i + 1], i, spec)[0][:, 0]
                           for i in range(S)], dim=1)
    assert _rel(got, _prefill(tm, tp, tokens, enc_out)) < 0.05


def _flat_defs(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_defs(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


# the full configs' parameters: seamless-m4t-medium 12 + 12 layers, vocab
# 256206 padded to 256512; internvl2-26b 48 layers, vocab 92553 padded to
# 92672 (internlm2-20b's tree)
FULL_PARAMS = {ENCDEC: 978_384_896, VLM: 19_862_722_560}


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_param_tree_and_cache_defs_match_jax(arch, smoke):
    jcfg, tcfg = jregistry.get(arch, smoke=smoke), registry.get(arch, smoke=smoke)
    jm = jmodel.Model(jcfg, JCTX)
    jleaves = jax.tree_util.tree_flatten_with_path(
        jm.param_defs(), is_leaf=lambda x: isinstance(x, jparallel.ParamDef))[0]
    want = {".".join(k.key for k in path): (d.shape, d.init, d.dtype, tuple(d.spec))
            for path, d in jleaves}
    model = Model(tcfg, CTX, params={}, device="cpu")
    assert {name: (d.shape, d.init, d.dtype, d.spec)
            for name, d in _flat_defs(model.param_defs())} == want
    assert ("blocks.cross.wk" in want and "enc_blocks.attn.wq" in want
            and "enc_norm" in want) == (arch == ENCDEC)
    assert "enc_blocks.cross.wk" not in want
    for s_total, window in ((64, 0), (32768, 0), (100, 16)):
        kw = dict(s_total=s_total, cp_axis=None, cp_size=1, window=window)
        assert model.cache_defs(3, KVCacheSpec(**kw)) == \
            jm.cache_defs(3, jattention.KVCacheSpec(**kw))
    if smoke:
        state = Model(tcfg, CTX, device="cpu").state_dict()
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in state.items()} == \
            {k: (v[0], f"torch.{v[2]}") for k, v in want.items()}
    else:
        n = sum(int(np.prod(d.shape)) for _, d in _flat_defs(model.param_defs()))
        assert n == FULL_PARAMS[arch]


def test_encdec_cache_without_prefix_and_unknown_family():
    """``enc_out`` takes 128 frames where ``n_prefix`` is 0, as the
    reference's; a family the reference does not know raises ValueError in
    ``param_defs`` and ``cache_defs``, as its ``_block_defs`` does."""
    jcfg, tcfg = _cfgs(ENCDEC, n_prefix=0)
    spec_kw = dict(s_total=8, cp_axis=None, cp_size=1)
    got = Model(tcfg, CTX, params={}, device="cpu").cache_defs(2, KVCacheSpec(**spec_kw))
    assert got["enc_out"] == (2, 128, tcfg.d_model)
    assert got == jmodel.Model(jcfg, JCTX).cache_defs(2, jattention.KVCacheSpec(**spec_kw))
    bad = dataclasses.replace(tcfg, family="speech")
    with pytest.raises(ValueError, match="speech"):
        Model(bad, CTX, device="cpu")
    with pytest.raises(ValueError, match="speech"):
        Model(bad, CTX, params={}, device="cpu").cache_defs(2, KVCacheSpec(**spec_kw))


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_params_and_checkpoint_round_trips_are_bit_exact(arch, tmp_path):
    """``params_from_jax`` and back by bits; the port's checkpoint restored
    by the reference, and the reference's by the port."""
    jcfg = jregistry.get(arch, smoke=True)
    params = jparallel.init_params(jmodel.Model(jcfg, JCTX).param_defs(), jax.random.key(5))
    tree = jax.tree.map(np.asarray, params)
    t = convert.params_from_jax(tree, "cpu")
    if arch == ENCDEC:
        assert sorted(t) == ["blocks", "embed", "enc_blocks", "enc_norm", "final_norm",
                             "unembed"]
        assert t["blocks"]["cross"]["wk"].dtype == torch.bfloat16
    back = convert.params_to_numpy(t)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                            jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        bits = np.uint16 if a.dtype.itemsize == 2 else np.uint32
        np.testing.assert_array_equal(a.view(bits), b.view(bits))
    checkpoint.save(str(tmp_path / "torch"), 1, t)
    theirs = jcheckpoint.restore(str(tmp_path / "torch"), 1, params)
    jcheckpoint.save(str(tmp_path / "jax"), 1, params)
    ours = checkpoint.restore(str(tmp_path / "jax"), 1, t, device="cpu")
    assert _same_bits(ours, t)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(theirs)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", [ENCDEC, VLM, AUDIO])
def test_synthetic_stream_matches_the_reference(arch):
    """The batches' leaves (tokens, labels and the frames or the prefix)
    equal by bits to the reference's, two batches deep."""
    jcfg, tcfg = _cfgs(arch)
    ours, theirs = SyntheticStream(tcfg, B, 40, seed=3), jpipeline.SyntheticStream(jcfg, B, 40,
                                                                                 seed=3)
    for _ in range(2):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b) == sorted(
            ["tokens", "labels", "enc_input" if arch == ENCDEC else "prefix"])
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


# ---------------------------------------------------------------------------
# The port alone: remat, serving, training
# ---------------------------------------------------------------------------


def _bits(t):
    t = t.detach().contiguous()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else \
        t.reshape(-1).view(torch.uint8).numpy()


def _same_bits(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and np.array_equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_remat_is_bit_neutral(arch, monkeypatch):
    """bf16: every decoder layer, and every encoder layer, checkpointed
    once; the gradients equal by bits."""
    from repro_torch.models import model as model_mod

    calls = []
    real = model_mod.checkpoint.checkpoint
    monkeypatch.setattr(model_mod.checkpoint, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _, cfg = _cfgs(arch)
    batch = _batch(cfg)
    grads = {}
    for remat in ("none", "full"):
        model = Model(cfg, parallel.ParallelCtx(remat=remat), device="cpu", seed=3)
        leaves, rebuild = tree_flatten(model.params())
        req = [p.detach().requires_grad_(True) for p in leaves]
        grads[remat] = torch.autograd.grad(model.loss_fn(rebuild(req), batch), req)
    assert len(calls) == cfg.n_layers + cfg.n_enc_layers
    assert all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(grads["none"], grads["full"]))


class _Recorder:
    """A numpy ``Generator`` that records what ``normal`` and ``integers``
    return, in order."""

    def __init__(self, rng, log):
        self._rng, self._log = rng, log

    def normal(self, *a, **kw):
        out = self._rng.normal(*a, **kw)
        self._log.append(("normal", out))
        return out

    def integers(self, *a, **kw):
        out = self._rng.integers(*a, **kw)
        self._log.append(("integers", out))
        return out


def test_serve_draws_enc_out_and_prompt_as_the_reference(monkeypatch):
    """``serve --arch seamless-m4t-medium --smoke``: the reference's and the
    port's generators give the same draws in the same order (the encoder
    output, then the prompt), and the port's first decode step reads them."""
    argv = ["--arch", ENCDEC, "--smoke", "--batch", "2", "--prompt-len", "3", "--gen", "1",
            "--cache-len", "8", "--seed", "4"]
    draws = {"ref": [], "port": []}
    log = []
    real_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda seed: _Recorder(real_rng(seed), log))
    seen = []
    real = Model.decode_fn

    def decode_fn(self, params, cache, tokens, pos, spec):
        if pos == 0:
            seen.append((cache["enc_out"].clone(), tokens.clone()))
        return real(self, params, cache, tokens, pos, spec)

    monkeypatch.setattr(Model, "decode_fn", decode_fn)
    with contextlib.redirect_stdout(io.StringIO()):
        jserve.serve(argv)
        draws["ref"], log[:] = list(log), []
        gen = serve.serve(argv + ["--device", "cpu"])
        draws["port"] = list(log)
    assert gen.shape == (2, 2)
    assert [k for k, _ in draws["port"]] == [k for k, _ in draws["ref"]] == ["normal",
                                                                           "integers"]
    for (_, a), (_, b) in zip(draws["port"], draws["ref"]):
        np.testing.assert_array_equal(a, b)
    (enc_out, tokens), = seen
    cfg = registry.get(ENCDEC, smoke=True)
    assert enc_out.dtype == torch.float32 and enc_out.shape == (2, cfg.n_prefix, cfg.d_model)
    np.testing.assert_array_equal(enc_out.numpy(), draws["ref"][0][1].astype(np.float32))
    np.testing.assert_array_equal(tokens.numpy(), draws["ref"][1][1][:, :1].astype(np.int32))


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_train_step_on_two_ranks_keeps_replicas_equal(arch):
    cfg = registry.get(arch, smoke=True)
    mesh = ThreadMesh((2, 1), ("data", "model"), "cpu")
    setup = training.make_setup(cfg, mesh, fsdp=False,
                                grad_gz=GZConfig(eb=1e-4, algo="ring", on_overflow="fallback"))
    seq = 64 + (cfg.n_prefix if arch == VLM else 0)
    bshapes, bspecs = shapes.train_specs(cfg, shapes.InputShape("t", seq, 4, "train"), mesh)
    assert sorted(bshapes) == sorted(["tokens", "labels",
                                      "enc_input" if arch == ENCDEC else "prefix"])
    step = training.make_train_step(setup, bspecs)
    p0 = parallel.init_params(setup.defs, torch.Generator().manual_seed(0), "cpu")
    params = [convert.tree_map(torch.clone, p0) for _ in range(2)]
    opt = [adamw.adamw_init(p) for p in params]
    stream = SyntheticStream(cfg, 4, seq, seed=0)
    for _ in range(2):
        params, opt, m = step(params, opt, next(stream))
        assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["gnorm"]))
        assert _same_bits(params[0], params[1]) and _same_bits(opt[0], opt[1])
    assert int(opt[0]["step"]) == 2 and not _same_bits(params[0], p0)


def test_serve_step_splits_enc_out_over_data():
    """``decode_specs`` puts ``enc_out``'s batch (dim 0) over ``data``: on
    two ranks each decodes its half of the batch against its half of the
    encoder output, as one ``decode_fn`` over the whole batch does."""
    cfg = registry.get(ENCDEC, smoke=True)
    mesh = ThreadMesh((2, 1), ("data", "model"), "cpu")
    setup = training.make_setup(cfg, mesh, fsdp=False)
    shape = shapes.InputShape("d", 16, 4, "decode")
    cache, cspecs, _, tspec, plan = shapes.decode_specs(cfg, shape, mesh, setup.model)
    assert cspecs["enc_out"] == ("data", None, None)
    assert cache["enc_out"].shape == (4, cfg.n_prefix, cfg.d_model)
    assert cache["enc_out"].dtype == torch.float32
    model = Model(cfg, setup.ctx, device="cpu", seed=5)
    params = model.params()
    step = training.make_serve_step(setup, cspecs, tspec, plan)
    rng = np.random.default_rng(0)
    enc = torch.from_numpy(rng.normal(0, 1, cache["enc_out"].shape).astype(np.float32))
    caches = [{k: torch.zeros(v.shape) for k, v in cache.items()} for _ in range(2)]
    for c in caches:
        c["enc_out"].copy_(enc)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 3)).astype(np.int32))
    with torch.no_grad():
        for pos in range(3):
            got, caches[0] = step([params, params], caches[0], toks[:, pos:pos + 1], pos)
            want, caches[1] = model.decode_fn(params, caches[1], toks[:, pos:pos + 1], pos,
                                              plan)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(caches[0]["k"].numpy(), caches[1]["k"].numpy(), atol=1e-6)


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_sync_plans_match_the_reference(arch):
    """Each leaf's ring allreduce over 2 data ranks at eb 1e-4, the train
    step's sync: the same plan as the reference's at the port's hardware
    point (``make_setup``'s), at the smoke size and at full size."""
    ours = GZCommunicator("data", config=GZConfig(eb=1e-4, algo="ring"), axis_size=2,
                          device="cpu")
    ref = jcomm.GZCommunicator("data", config=JGZConfig(eb=1e-4, algo="ring"), axis_size=2,
                               hw=jcost_model.A100_SLINGSHOT)
    assert ours.hw == cost_model.A100_SLINGSHOT
    for smoke in (True, False):
        cfg = registry.get(arch, smoke=smoke)
        defs = tree_flatten(Model(cfg, CTX, params={}, device="cpu").param_defs())[0]
        assert len(defs) == (27 if arch == ENCDEC else 12)
        for d in defs:
            a = convert.plan_fields(ours.plan("allreduce", d.shape, parallel.torch_dtype(d.dtype)))
            b = convert.plan_fields(ref.plan("allreduce", d.shape, jnp.dtype(d.dtype)))
            assert a == b, (d.shape, d.dtype)


def test_train_cli_loss_falls():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = train(["--arch", ENCDEC, "--smoke", "--device", "cpu", "--steps", "12",
                        "--batch", "4", "--seq", "64", "--lr", "1e-3", "--grad-gz", "ring"])
    assert out.getvalue().splitlines()[0].startswith("arch=seamless-m4t-medium-smoke ")
    assert len(losses) == 12 and np.isfinite(losses).all() and losses[-1] < losses[0]
