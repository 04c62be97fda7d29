"""The port's MLA family against the JAX package, on the CPU.

``models/mla.py`` (``mla_train``, ``mla_decode``), ``blocks.mla_block``
and ``Model``'s MLA branches (minicpm3-4b at its smoke size: 2 layers,
d_model 128, 4 heads, q_lora 64, kv_lora 32, qk_nope 32, qk_rope 16, v 32)
take the same inputs, made from a seed with numpy, and the same weights,
carried across with ``convert.params_from_jax``.  ``mla_chunk`` is cut to
16, so S = 40 runs three chunks of the online softmax, the last one
padded; one case runs S = 11 < chunk, one the dense ``chunk == 0`` route.
Every comparison runs in this process on one CPU device; the reference's
layer functions, gradients and decode steps run under ``jit``, its
``loss_fn`` eagerly.

Tolerances, relative to the largest value of the reference's result:

  * one layer (``mla_train``, ``mla_block``, ``mla_decode`` steps): f32
    1e-5 (another summation order: the batched ``matmul``s against XLA's
    einsums; measured at most 5.8e-7); bf16 ``LAYER_TOL`` = 2**-7, as
    ``tests/test_torch_model.py`` (one bf16 rounding flipped by an f32
    difference below it; measured 6.67e-3, one ulp of an output near
    half the largest; the bf16 decode steps measured 0);
  * ``loss_fn``: f32 1e-5, bf16 2e-3, as the dense family's (measured
    6.9e-8 and 2.7e-4);
  * the gradients of ``loss_fn`` at f32, each leaf within 1e-4 of its
    largest value (measured at most 1.8e-6);
  * decode steps against the reference's (jitted) decode at f32: 1e-5
    (measured at most 1.24e-6, logits and cache), and against the
    full-sequence forward: 0.05, the bound of
    ``tests/test_prefill_decode_consistency.py``, at f32 on S = 40 (three
    chunks; measured at most 1.24e-6) and at bf16 on its S = 24
    (measured 0: in one chunk the two paths round alike).

Port-only: the softmax scale's f32 bits; remat bit-neutral; the train
step on a two-rank CPU mesh, replicas equal by bits; the train CLI; each
leaf's gradient-sync plan the reference's.  (``serve``:
``tests/test_torch_serve.py``.)
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

from repro.configs import registry as jregistry
from repro.core.collectives import GZConfig as JGZConfig
from repro.core import comm as jcomm
from repro.core import cost_model as jcost_model
from repro.models import attention as jattention
from repro.models import blocks as jblocks
from repro.models import mla as jmla
from repro.models import model as jmodel
from repro.models import parallel as jparallel
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import cost_model
from repro_torch.core.collectives import GZConfig
from repro_torch.core.comm import GZCommunicator
from repro_torch.core.grad_sync import tree_flatten
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.launch import shapes, training
from repro_torch.launch.mesh import ThreadMesh
from repro_torch.launch.train import train
from repro_torch.models import attention, blocks, layers, mla, parallel
from repro_torch.models.attention import KVCacheSpec
from repro_torch.models.model import Model
from repro_torch.optim import adamw

ARCH = "minicpm3-4b"
JCTX = jparallel.ParallelCtx(tp_size=1, fsdp_size=1, remat="none")
CTX = parallel.ParallelCtx(remat="none")
TOL = {"float32": 1e-5, "bfloat16": 2e-3}
LAYER_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
GRAD_TOL = 1e-4
CHUNK, S = 16, 40  # three chunks of the online softmax, the last one padded
B = 2


def _cfgs(chunk=CHUNK):
    """(JAX config, port config): the smoke config with ``mla_chunk``."""
    return tuple(dataclasses.replace(reg.get(ARCH, smoke=True), mla_chunk=chunk)
                 for reg in (jregistry, registry))


@functools.lru_cache(maxsize=None)
def _jparams(dtype, seed=0):
    """The reference's init from ``key(seed)``, cast to f32 for ``dtype``
    f32 (cached: the tests only read it)."""
    jcfg, _ = _cfgs()
    params = jparallel.init_params(jmodel.Model(jcfg, JCTX).param_defs(),
                                   jax.random.key(seed))
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return params


def _both(dtype, seed=0):
    params = _jparams(dtype, seed)
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


def _h(cfg, s, dtype, seed=1):
    x = np.random.default_rng(seed).normal(0, 1, (B, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(parallel.torch_dtype(dtype))


def _batch(cfg, s, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)}
    batch["labels"][:, :3] = -1
    return batch


# ---------------------------------------------------------------------------
# One layer
# ---------------------------------------------------------------------------


def test_scale_is_the_references_f32():
    """``1 / jnp.sqrt(nope + rope)``: an f32 root and an f32 divide.  At
    minicpm3-4b's 96 a Python ``1 / math.sqrt(96)`` rounded once to f32 is
    one ulp above it."""
    _, tcfg = _cfgs()
    for d in (tcfg.mla.qk_nope_head_dim + tcfg.mla.qk_rope_head_dim, 96):
        want = np.asarray(jax.jit(lambda: 1.0 / jnp.sqrt(d))(), np.float32)
        got = np.float32(attention._scale(d))
        assert want.dtype == np.float32 and got.view(np.uint32) == want.view(np.uint32), d
    once = np.float32(1 / np.sqrt(96.0)).view(np.uint32)
    assert int(once) - int(np.float32(attention._scale(96)).view(np.uint32)) == 1


@pytest.mark.parametrize("chunk,s", [(CHUNK, S), (CHUNK, 11), (0, S)],
                         ids=["three-chunks", "one-short-chunk", "dense"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_train_and_block_match_jax(dtype, chunk, s):
    jcfg, tcfg = _cfgs(chunk)
    jp, tp = _both(dtype)
    jw, tw = _layer0(jp["blocks"]), _layer0(tp["blocks"])
    jh, th = _h(jcfg, s, dtype)
    jpos, tpos = jnp.arange(s), torch.arange(s)
    want = jax.jit(lambda h, w: jmla.mla_train(h, w, jcfg, JCTX, positions=jpos))(jh, jw["mla"])
    got = mla.mla_train(th, tw["mla"], tcfg, CTX, positions=tpos)
    assert got.dtype == th.dtype
    _close(got, want, LAYER_TOL[dtype])
    _close(blocks.mla_block(th, tw, tcfg, CTX, positions=tpos),
           jax.jit(lambda h, w: jblocks.mla_block(h, w, jcfg, JCTX, positions=jpos))(jh, jw),
           LAYER_TOL[dtype])


@pytest.mark.parametrize("chunk", [CHUNK, 0], ids=["chunked", "dense"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_steps_match_jax(dtype, chunk):
    """Six steps into an S = 40 f32 cache: rows written in place where the
    reference writes them; the chunks past ``pos`` wholly masked."""
    jcfg, tcfg = _cfgs(chunk)
    jp, tp = _both(dtype)
    jw, tw = _layer0(jp["blocks"])["mla"], _layer0(tp["blocks"])["mla"]
    shape = (B, S, mla.mla_cache_dims(tcfg))
    assert mla.mla_cache_dims(tcfg) == jmla.mla_cache_dims(jcfg) == 48
    jcache, tcache = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    jh, th = _h(jcfg, 6, dtype, seed=4)
    jstep = jax.jit(lambda h, c, pos: jmla.mla_decode(h, jw, c, pos, jcfg, JCTX))
    for i in range(6):
        jout, jcache = jstep(jh[:, i:i + 1], jcache, jnp.int32(i))
        tout, tcache2 = mla.mla_decode(th[:, i:i + 1], tw, tcache, i, tcfg, CTX)
        assert tcache2 is tcache and tout.dtype == th.dtype
        assert bool(torch.isfinite(tout).all())
        _close(tout, jout, LAYER_TOL[dtype])
        _close(tcache, jcache, LAYER_TOL["float32"])
    assert not bool(tcache[:, 6:].any())


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_matches_jax(dtype):
    jcfg, tcfg = _cfgs()
    jp, tp = _both(dtype)
    batch = _batch(jcfg, S)
    want = float(jmodel.Model(jcfg, JCTX).loss_fn(jp, batch))
    got = float(Model(tcfg, CTX, params=tp, device="cpu").loss_fn(tp, batch))
    assert np.isfinite(got) and abs(got - want) <= TOL[dtype] * abs(want), (got, want)


def test_loss_gradients_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _both("float32")
    batch = _batch(jcfg, S)
    want = jax.jit(jax.grad(jmodel.Model(jcfg, JCTX).loss_fn))(jp, batch)
    leaves, rebuild = tree_flatten(tp)
    req = [p.detach().requires_grad_(True) for p in leaves]
    model = Model(tcfg, CTX, params=tp, device="cpu")
    got = rebuild(list(torch.autograd.grad(model.loss_fn(rebuild(req), batch), req)))
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(paths) == len(leaves) == 13
    for path, w in paths:
        g = got
        for k in path:
            g = g[k.key]
        assert float(np.abs(np.asarray(w)).max()) > 0, path
        _close(g, w, GRAD_TOL)


def _prefill(model, params, tokens):
    with torch.no_grad():
        h = layers.embed_lookup(torch.from_numpy(tokens), params["embed"], model.ctx)
        h, _ = model._backbone(h, params, positions=torch.arange(tokens.shape[1]))
        h = layers.rms_norm(h, params["final_norm"], model.cfg.norm_eps)
        return layers.vocab_parallel_logits(h, params["unembed"], model.ctx)


def test_decode_steps_match_jax_and_prefill():
    jcfg, tcfg = _cfgs()
    jp, tp = _both("float32")
    jm, tm = jmodel.Model(jcfg, JCTX), Model(tcfg, CTX, params=tp, device="cpu")
    spec_kw = dict(s_total=S, cp_axis=None, cp_size=1)
    jspec, tspec = jattention.KVCacheSpec(**spec_kw), KVCacheSpec(**spec_kw)
    assert tm.cache_defs(B, tspec) == jm.cache_defs(B, jspec) == {"mla": (2, B, S, 48)}
    jcache = {k: jnp.zeros(v, jnp.float32) for k, v in jm.cache_defs(B, jspec).items()}
    tcache = {k: torch.zeros(v) for k, v in tm.cache_defs(B, tspec).items()}
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, pos: jm.decode_fn(p, c, t, pos, jspec))
    got = []
    for i in range(S):
        jl, jcache = jstep(jp, jcache, jnp.asarray(tokens[:, i:i + 1]), jnp.int32(i))
        tl, tcache = tm.decode_fn(tp, tcache, tokens[:, i:i + 1], i, tspec)
        _close(tl, jl, 1e-5)
        got.append(tl[:, 0])
    _close(tcache["mla"], jcache["mla"], 1e-5)  # written in place, row by row
    assert _rel(torch.stack(got, dim=1), _prefill(tm, tp, tokens)) < 0.05


def test_bf16_decode_matches_prefill():
    """The reference test's setup: bf16 weights from ``key(2)``, S = 24
    (at the config's own ``mla_chunk``: one chunk)."""
    s = 24
    tcfg = registry.get(ARCH, smoke=True)
    jcfg = jregistry.get(ARCH, smoke=True)
    params = jparallel.init_params(jmodel.Model(jcfg, JCTX).param_defs(), jax.random.key(2))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    tm = Model(tcfg, CTX, params=tp, device="cpu")
    spec = KVCacheSpec(s_total=s, cp_axis=None, cp_size=1)
    cache = {k: torch.zeros(v) for k, v in tm.cache_defs(B, spec).items()}
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab, (B, s)).astype(np.int32)
    with torch.no_grad():
        got = torch.stack([tm.decode_fn(tp, cache, tokens[:, i:i + 1], i, spec)[0][:, 0]
                           for i in range(s)], dim=1)
    assert _rel(got, _prefill(tm, tp, tokens)) < 0.05


def _flat_defs(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_defs(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("smoke", [True, False])
def test_param_tree_and_cache_defs_match_jax(smoke):
    jcfg, tcfg = jregistry.get(ARCH, smoke=smoke), registry.get(ARCH, smoke=smoke)
    jm = jmodel.Model(jcfg, JCTX)
    jleaves = jax.tree_util.tree_flatten_with_path(
        jm.param_defs(), is_leaf=lambda x: isinstance(x, jparallel.ParamDef))[0]
    want = {".".join(k.key for k in path): (d.shape, d.init, d.dtype, tuple(d.spec))
            for path, d in jleaves}
    model = Model(tcfg, CTX, params={}, device="cpu")
    assert {name: (d.shape, d.init, d.dtype, d.spec)
            for name, d in _flat_defs(model.param_defs())} == want
    assert "blocks.mla.wkv_b" in want and "blocks.attn.wq" not in want
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
        assert n == 4_263_272_960  # 62 layers, vocab padded 73448 -> 73728


def test_params_from_jax_round_trip_is_bit_exact():
    jcfg = jregistry.get(ARCH, smoke=True)
    params = jparallel.init_params(jmodel.Model(jcfg, JCTX).param_defs(), jax.random.key(5))
    tree = jax.tree.map(np.asarray, params)
    t = convert.params_from_jax(tree, "cpu")
    assert sorted(t["blocks"]["mla"]) == ["wkv_a", "wkv_b", "wo", "wq_a", "wq_b"]
    assert t["blocks"]["mla"]["wkv_b"].dtype == torch.bfloat16
    back = convert.params_to_numpy(t)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                            jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        bits = np.uint16 if a.dtype.itemsize == 2 else np.uint32
        np.testing.assert_array_equal(a.view(bits), b.view(bits))


# ---------------------------------------------------------------------------
# The port alone: remat, training
# ---------------------------------------------------------------------------


def _bits(t):
    t = t.detach().contiguous()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else \
        t.reshape(-1).view(torch.uint8).numpy()


def _same_bits(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and np.array_equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_is_bit_neutral(dtype, monkeypatch):
    from repro_torch.models import model as model_mod

    calls = []
    real = model_mod.checkpoint.checkpoint
    monkeypatch.setattr(model_mod.checkpoint, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _, cfg = _cfgs()
    batch = _batch(cfg, S)
    grads = {}
    for remat in ("none", "full"):
        model = Model(cfg, parallel.ParallelCtx(remat=remat), device="cpu", seed=3)
        leaves, rebuild = tree_flatten(convert.tree_map(lambda p: p.detach().to(dtype),
                                                        model.params()))
        req = [p.requires_grad_(True) for p in leaves]
        grads[remat] = torch.autograd.grad(model.loss_fn(rebuild(req), batch), req)
    assert len(calls) == cfg.n_layers  # each MLA layer checkpointed once
    assert all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(grads["none"], grads["full"]))


def test_train_step_on_two_ranks_keeps_replicas_equal():
    cfg = registry.get(ARCH, smoke=True)
    mesh = ThreadMesh((2, 1), ("data", "model"), "cpu")
    setup = training.make_setup(cfg, mesh, fsdp=False,
                                grad_gz=GZConfig(eb=1e-4, algo="ring", on_overflow="fallback"))
    _, bspecs = shapes.train_specs(cfg, shapes.InputShape("t", 64, 4, "train"), mesh)
    step = training.make_train_step(setup, bspecs)
    p0 = parallel.init_params(setup.defs, torch.Generator().manual_seed(0), "cpu")
    params = [convert.tree_map(torch.clone, p0) for _ in range(2)]
    opt = [adamw.adamw_init(p) for p in params]
    stream = SyntheticStream(cfg, 4, 64, seed=0)
    for _ in range(3):
        params, opt, m = step(params, opt, next(stream))
        assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["gnorm"]))
        assert _same_bits(params[0], params[1]) and _same_bits(opt[0], opt[1])
    assert int(opt[0]["step"]) == 3 and not _same_bits(params[0], p0)


def test_sync_plans_match_the_reference():
    """Each leaf's ring allreduce over 2 data ranks at eb 1e-4, the train
    step's sync: the same plan as the reference's at the port's hardware
    point (``make_setup``'s), at the smoke size and at full size."""
    ours = GZCommunicator("data", config=GZConfig(eb=1e-4, algo="ring"), axis_size=2,
                          device="cpu")
    ref = jcomm.GZCommunicator("data", config=JGZConfig(eb=1e-4, algo="ring"), axis_size=2,
                               hw=jcost_model.A100_SLINGSHOT)
    assert ours.hw == cost_model.A100_SLINGSHOT
    for smoke in (True, False):
        cfg = registry.get(ARCH, smoke=smoke)
        defs = tree_flatten(Model(cfg, CTX, params={}, device="cpu").param_defs())[0]
        assert len(defs) == 13
        for d in defs:
            a = convert.plan_fields(ours.plan("allreduce", d.shape, parallel.torch_dtype(d.dtype)))
            b = convert.plan_fields(ref.plan("allreduce", d.shape, jnp.dtype(d.dtype)))
            assert a == b, (d.shape, d.dtype)


def test_train_cli_loss_falls():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = train(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "12",
                        "--batch", "4", "--seq", "64", "--lr", "1e-3", "--grad-gz", "ring"])
    assert out.getvalue().splitlines()[0].startswith("arch=minicpm3-smoke ")
    assert len(losses) == 12 and np.isfinite(losses).all() and losses[-1] < losses[0]
