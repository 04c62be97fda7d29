"""The port's ssm and hybrid families against the JAX package, on the CPU.

``models/ssm.py`` (``ssm_train``, ``ssm_decode``), ``blocks.ssm_block``
and ``Model``'s ssm and hybrid branches (mamba2-780m and zamba2-2.7b at
their smoke sizes) take the same inputs, made from a seed with numpy, and
the same weights, carried across with ``convert.params_from_jax``.  The
smoke ``SSMConfig.chunk`` is cut to 16, so S = 40 runs three SSD chunks,
the last one padded; one case runs S < chunk.  ``A_log``, ``D`` and
``dt_bias`` are redrawn from a seeded normal (the init's zeros and ones
would leave the decays all alike).  Every comparison runs in this process
on one CPU device; the reference's layer functions, gradients and decode
steps run under ``jit``, its ``ssm_decode`` and ``loss_fn`` eagerly.

Tolerances, relative to the largest value of the reference's result:

  * one layer (``ssm_train``, ``ssm_block``, ``ssm_decode`` steps): f32
    1e-5 (another summation order: torch's ``cumsum`` and ``logaddexp``
    and the pairwise contractions against XLA's einsums; measured at most
    1.04e-6); bf16 ``LAYER_TOL`` = 2**-7, as ``tests/test_torch_model.py``
    (one bf16 rounding flipped by an f32 difference below it; measured
    6.94e-3, one ulp of an output near half the largest);
  * ``loss_fn``: f32 1e-5, bf16 2e-3, as the dense family's;
  * the gradients of ``loss_fn`` at f32, each leaf within 1e-4 of its
    largest value (measured at most 2.49e-6 for mamba2, 4.47e-6 for
    zamba2);
  * decode steps against the reference's (jitted) decode at f32: 1e-5
    (measured at most 1.88e-6), and against the full-sequence forward: 0.05, the bound of
    ``tests/test_prefill_decode_consistency.py``, at bf16 on its S = 24 and
    at f32 on S = 40.  (At bf16 the two paths round in other places: the
    conv is bf16 in the forward and f32 against the decode cache; the
    drift grows with depth in the reference as here,
    ``scripts/ssm_decode_drift.py``.)

Port-only: remat bit-neutral; the train step on a two-rank CPU mesh,
replicas equal by bits; the train CLI; each leaf's gradient-sync plan the
reference's.  (``serve`` for both families: ``tests/test_torch_serve.py``.)
"""
import contextlib
import dataclasses
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
from repro.models import model as jmodel
from repro.models import parallel as jparallel
from repro.models import ssm as jssm
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
from repro_torch.models import blocks, layers, parallel, ssm
from repro_torch.models.attention import KVCacheSpec
from repro_torch.models.model import Model
from repro_torch.optim import adamw

ARCHS = ["mamba2-780m", "zamba2-2.7b"]
JCTX = jparallel.ParallelCtx(tp_size=1, fsdp_size=1, remat="none")
CTX = parallel.ParallelCtx(remat="none")
TOL = {"float32": 1e-5, "bfloat16": 2e-3}
LAYER_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
GRAD_TOL = 1e-4
CHUNK, S = 16, 40  # three SSD chunks, the last one padded
B = 2


def _cfgs(arch, chunk=CHUNK):
    """(JAX config, port config): the smoke config with SSD chunk ``chunk``."""
    out = []
    for reg in (jregistry, registry):
        cfg = reg.get(arch, smoke=True)
        out.append(dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=chunk)))
    return tuple(out)


def _jparams(cfg, dtype, seed=0, a_log=(0.0, 1.0), dt_bias=(-1.0, 1.0)):
    """The reference's init, ``A_log``, ``D`` and ``dt_bias`` redrawn from
    a seeded normal (mean, std), cast to f32 for ``dtype`` f32."""
    params = jparallel.init_params(jmodel.Model(cfg, JCTX).param_defs(), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    w = params["blocks"]["ssm"]
    for name, (mean, std) in (("A_log", a_log), ("D", (1.0, 0.5)), ("dt_bias", dt_bias)):
        w[name] = jnp.asarray(rng.normal(mean, std, w[name].shape), jnp.float32)
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return params


def _both(params):
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


@pytest.mark.parametrize("s", [S, 11])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_train_and_block_match_jax(arch, dtype, s):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _both(_jparams(jcfg, dtype))
    jw, tw = _layer0(jp["blocks"]), _layer0(tp["blocks"])
    jh, th = _h(jcfg, s, dtype)
    want = jax.jit(jssm.ssm_train, static_argnums=(2, 3))(jh, jw["ssm"], jcfg, JCTX)
    got = ssm.ssm_train(th, tw["ssm"], tcfg, CTX)
    assert got.dtype == th.dtype
    _close(got, want, LAYER_TOL[dtype])
    _close(blocks.ssm_block(th, tw, tcfg, CTX),
           jax.jit(jblocks.ssm_block, static_argnums=(2, 3))(jh, jw, jcfg, JCTX),
           LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_decode_steps_match_jax(arch, dtype):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _both(_jparams(jcfg, dtype))
    jw, tw = _layer0(jp["blocks"])["ssm"], _layer0(tp["blocks"])["ssm"]
    conv_shape, state_shape = ssm.ssm_state_shapes(tcfg, 1, B)
    assert (conv_shape, state_shape) == jssm.ssm_state_shapes(jcfg, 1, B)
    jconv, jstate = jnp.zeros(conv_shape, jnp.float32), jnp.zeros(state_shape, jnp.float32)
    tconv, tstate = torch.zeros(conv_shape), torch.zeros(state_shape)
    jh, th = _h(jcfg, 6, dtype, seed=4)
    for i in range(6):
        jout, jconv, jstate = jssm.ssm_decode(jh[:, i:i + 1], jw, jconv, jstate, jcfg, JCTX)
        tout, tconv, tstate = ssm.ssm_decode(th[:, i:i + 1], tw, tconv, tstate, tcfg, CTX)
        assert tout.dtype == th.dtype and tconv.dtype == tstate.dtype == torch.float32
        _close(tout, jout, LAYER_TOL[dtype])
        _close(tconv, jconv, LAYER_TOL["float32"])
        _close(tstate, jstate, LAYER_TOL["float32"])


def test_large_decays_stay_finite_and_match_jax():
    """dt ~ 20 and A ~ -e^4 give within-chunk decays of ~1e3 a step: the
    exponent of a masked entry passes 88 (e^88 overflows f32), so masking
    after the exp would give inf * 0 = NaN.  Both packages mask first."""
    jcfg, tcfg = _cfgs("mamba2-780m")
    jp, tp = _both(_jparams(jcfg, "float32", a_log=(4.0, 0.5), dt_bias=(20.0, 1.0)))
    jw, tw = _layer0(jp["blocks"])["ssm"], _layer0(tp["blocks"])["ssm"]
    jh, th = _h(jcfg, S, "float32")
    dt = torch.logaddexp(torch.matmul(th, tw["w_dt"]) + tw["dt_bias"], torch.zeros(()))
    assert float((dt * torch.exp(tw["A_log"])).max()) * 2 > 88
    want = jssm.ssm_train(jh, jw, jcfg, JCTX)
    th.requires_grad_(True)
    got = ssm.ssm_train(th, tw, tcfg, CTX)
    assert np.isfinite(np.asarray(want)).all() and bool(torch.isfinite(got).all())
    _close(got, want, LAYER_TOL["float32"])
    (grad,) = torch.autograd.grad(got.square().sum(), th)
    assert bool(torch.isfinite(grad).all())


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch, dtype):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _both(_jparams(jcfg, dtype))
    batch = _batch(jcfg, S)
    want = float(jmodel.Model(jcfg, JCTX).loss_fn(jp, batch))
    got = float(Model(tcfg, CTX, params=tp, device="cpu").loss_fn(tp, batch))
    assert np.isfinite(got) and abs(got - want) <= TOL[dtype] * abs(want), (got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _both(_jparams(jcfg, "float32"))
    batch = _batch(jcfg, S)
    want = jax.jit(jax.grad(jmodel.Model(jcfg, JCTX).loss_fn))(jp, batch)
    leaves, rebuild = tree_flatten(tp)
    req = [p.detach().requires_grad_(True) for p in leaves]
    model = Model(tcfg, CTX, params=tp, device="cpu")
    got = rebuild(list(torch.autograd.grad(model.loss_fn(rebuild(req), batch), req)))
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(paths) == len(leaves)
    for path, w in paths:
        g = got
        for k in path:
            g = g[k.key]
        assert float(np.abs(np.asarray(w)).max()) > 0, path
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax_and_prefill(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _both(_jparams(jcfg, "float32"))
    jm, tm = jmodel.Model(jcfg, JCTX), Model(tcfg, CTX, params=tp, device="cpu")
    spec_kw = dict(s_total=S, cp_axis=None, cp_size=1)
    jspec, tspec = jattention.KVCacheSpec(**spec_kw), KVCacheSpec(**spec_kw)
    assert tm.cache_defs(B, tspec) == jm.cache_defs(B, jspec)
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
    for k in tcache:  # the caches written in place hold the reference's states
        _close(tcache[k], jcache[k], 1e-5)
    assert _rel(torch.stack(got, dim=1), _prefill(tm, tp, tokens)) < 0.05


def _prefill(model, params, tokens):
    with torch.no_grad():
        h = layers.embed_lookup(torch.from_numpy(tokens), params["embed"], model.ctx)
        h, _ = model._backbone(h, params, positions=torch.arange(tokens.shape[1]))
        h = layers.rms_norm(h, params["final_norm"], model.cfg.norm_eps)
        return layers.vocab_parallel_logits(h, params["unembed"], model.ctx)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_decode_matches_prefill(arch):
    """The reference test's setup: bf16 weights from ``key(2)``, S = 24
    (two chunks of 16, the second padded)."""
    s = 24
    jcfg, tcfg = _cfgs(arch)
    params = jparallel.init_params(jmodel.Model(jcfg, JCTX).param_defs(), jax.random.key(2))
    _, tp = _both(params)
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
@pytest.mark.parametrize("arch", ARCHS)
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
    assert ("shared_attn.mlp.wi" in want) == (arch == "zamba2-2.7b")
    for s_total, window in ((64, 0), (32768, 0), (100, 16)):
        kw = dict(s_total=s_total, cp_axis=None, cp_size=1, window=window)
        assert model.cache_defs(3, KVCacheSpec(**kw)) == \
            jm.cache_defs(3, jattention.KVCacheSpec(**kw))
    if smoke:
        state = Model(tcfg, CTX, device="cpu").state_dict()
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in state.items()} == \
            {k: (v[0], f"torch.{v[2]}") for k, v in want.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_round_trip_is_bit_exact(arch):
    jcfg = jregistry.get(arch, smoke=True)
    params = jparallel.init_params(jmodel.Model(jcfg, JCTX).param_defs(), jax.random.key(5))
    tree = jax.tree.map(np.asarray, params)
    t = convert.params_from_jax(tree, "cpu")
    assert t["blocks"]["ssm"]["A_log"].dtype == torch.float32
    assert t["blocks"]["ssm"]["w_x"].dtype == torch.bfloat16
    back = convert.params_to_numpy(t)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                            jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        bits = np.uint16 if a.dtype.itemsize == 2 else np.uint32
        np.testing.assert_array_equal(a.view(bits), b.view(bits))


# ---------------------------------------------------------------------------
# The port alone: remat, training, serving
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
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_neutral(arch, dtype, monkeypatch):
    from repro_torch.models import model as model_mod

    calls = []
    real = model_mod.checkpoint.checkpoint
    monkeypatch.setattr(model_mod.checkpoint, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _, cfg = _cfgs(arch)
    batch = _batch(cfg, S)
    grads = {}
    for remat in ("none", "full"):
        model = Model(cfg, parallel.ParallelCtx(remat=remat), device="cpu", seed=3)
        leaves, rebuild = tree_flatten(convert.tree_map(lambda p: p.detach().to(dtype),
                                                        model.params()))
        req = [p.requires_grad_(True) for p in leaves]
        grads[remat] = torch.autograd.grad(model.loss_fn(rebuild(req), batch), req)
    # each ssm layer checkpointed once; zamba2's shared block is not
    assert len(calls) == cfg.n_layers
    assert all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(grads["none"], grads["full"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_two_ranks_keeps_replicas_equal(arch):
    cfg = registry.get(arch, smoke=True)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_sync_plans_match_the_reference(arch):
    """Each leaf's ring allreduce over 2 data ranks at eb 1e-4, the train
    step's sync: the same plan as the reference's at the port's hardware
    point (``make_setup``'s), at the smoke size (whose (2, 8) f32 leaves
    ``A_log``, ``D`` and ``dt_bias`` are one padded block a chunk) and at
    full size (48 x 48 values at mamba2-780m)."""
    ours = GZCommunicator("data", config=GZConfig(eb=1e-4, algo="ring"), axis_size=2,
                          device="cpu")
    ref = jcomm.GZCommunicator("data", config=JGZConfig(eb=1e-4, algo="ring"), axis_size=2,
                               hw=jcost_model.A100_SLINGSHOT)
    assert ours.hw == cost_model.A100_SLINGSHOT
    for smoke in (True, False):
        cfg = registry.get(arch, smoke=smoke)
        defs = tree_flatten(Model(cfg, CTX, params={}, device="cpu").param_defs())[0]
        assert len(defs) == (15 if arch == "mamba2-780m" else 24)
        for d in defs:
            a = convert.plan_fields(ours.plan("allreduce", d.shape, parallel.torch_dtype(d.dtype)))
            b = convert.plan_fields(ref.plan("allreduce", d.shape, jnp.dtype(d.dtype)))
            assert a == b, (d.shape, d.dtype)


def test_train_cli_loss_falls():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = train(["--arch", "mamba2-780m", "--smoke", "--device", "cpu", "--steps",
                        "12", "--batch", "4", "--seq", "64", "--lr", "1e-3", "--grad-gz",
                        "ring"])
    assert out.getvalue().splitlines()[0].startswith("arch=mamba2-smoke ")
    assert len(losses) == 12 and np.isfinite(losses).all() and losses[-1] < losses[0]
