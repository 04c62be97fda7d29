"""The port's MoE family against the JAX package, on the CPU.

``models/moe.py`` (``moe_capacity``, ``moe_route``, ``moe_ffn``),
``blocks.moe_block`` and ``Model``'s moe branches, for both moe configs
at their smoke sizes (2 layers, d_model 128, 4 heads over 2 kv heads,
d_ff 256, 4 experts): phi3.5-moe-42b-a6.6b (top-2, the gates
renormalised) and llama4-scout-17b-a16e (top-1, head_dim 32).  Both
packages take the same inputs, made from a seed with numpy, and the same
weights, carried across with ``convert.params_from_jax``.  Every case
first asserts that the routing (each token's experts, each slot's
position and whether it fits) is the reference's, so that a routing
difference names itself, then compares values: for the layer functions
on their inputs, for ``loss_fn``, its gradients and decode on every
layer's input (the ``routing`` fixture logs both packages' routing, layer
call by layer call).  The reference runs in this process on one CPU
device: its layer functions, ``loss_fn`` and decode steps eagerly (under
``jax.disable_jit()``, so the routing can be logged), its gradients
under ``jit``.  (Compiled, XLA keeps f32 between the bf16 ops it fuses,
which moves a near-tied token to another expert now and then: the
reference's compiled bf16 loss is up to 2.5e-3 from its own eager one on
these inputs, seeds 0-2; the port rounds after each op, as the eager
reference.)

Capacities: ``capacity_factor`` 0.5 (t = 80 tokens against 24 or 16
slots an expert: slots drop), the configs' 1.25 and ``n_experts /
top_k`` (cap = t: nothing drops).

Tolerances, relative to the largest value of the reference's result:

  * one layer (``moe_ffn``, ``moe_block``; output and aux): f32 1e-5
    (another summation order: ``torch.bmm`` against XLA's einsums;
    measured at most 2.5e-7), bf16 ``LAYER_TOL`` = 2**-7 (one bf16
    rounding flipped by an f32 difference below it; measured at most
    3.7e-6);
  * ``loss_fn``: f32 1e-5, bf16 2e-3 (measured 7.0e-8 and 3.8e-5);
  * the gradients of ``loss_fn`` at f32, each leaf within 1e-4 of its
    largest value (measured at most 1.8e-6);
  * decode steps against the reference's decode at f32: 1e-5 (measured
    at most 1.4e-6, logits and cache), and against the
    full-sequence forward at ``capacity_factor = n_experts / top_k``:
    0.05, the bound of ``tests/test_prefill_decode_consistency.py``
    (measured 8.6e-7 / 6.9e-7, phi3.5 / llama4).  At the configs' 1.25
    decode is the same function (B = 2 tokens, cap 8: nothing drops) but
    the prefill drops 1 of 160 slots in one layer (phi3.5) and 6 of 80
    (llama4), and the gap is 0.448 / 0.549: recorded, not gated (the
    reference's own prefill-decode test leaves moe out).

The file takes ~75 s on one process: ~8 s is JAX's first use and most
of the rest the eager reference.  Port-only: remat bit-neutral;
``moe_dispatch_gz_eb`` at tp = 1 leaves the loss unchanged by bits; the
train step on a two-rank CPU mesh, replicas equal by bits; the train
CLI; each leaf's gradient-sync plan the reference's.  (``serve``: ``tests/test_torch_serve.py``; the train and
decode specs: ``tests/test_torch_train.py``.)
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
from jax import lax

from repro.checkpoint import checkpoint as jcheckpoint
from repro.configs import registry as jregistry
from repro.core import comm as jcomm
from repro.core import cost_model as jcost_model
from repro.core.collectives import GZConfig as JGZConfig
from repro.models import attention as jattention
from repro.models import blocks as jblocks
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import parallel as jparallel
from repro_torch import convert
from repro_torch.checkpoint import checkpoint
from repro_torch.configs import registry
from repro_torch.core import cost_model
from repro_torch.core.collectives import GZConfig
from repro_torch.core.comm import GZCommunicator
from repro_torch.core.grad_sync import tree_flatten
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.launch import shapes, training
from repro_torch.launch.mesh import ThreadMesh
from repro_torch.launch.train import train
from repro_torch.models import blocks, layers, moe, parallel
from repro_torch.models.attention import KVCacheSpec
from repro_torch.models.model import MOE_AUX_COEF, Model
from repro_torch.optim import adamw

PHI, SCOUT = "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"
ARCHS = (PHI, SCOUT)
JCTX = jparallel.ParallelCtx(tp_size=1, fsdp_size=1, remat="none")
CTX = parallel.ParallelCtx(remat="none")
TOL = {"float32": 1e-5, "bfloat16": 2e-3}
LAYER_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
GRAD_TOL = 1e-4
B, S = 2, 40
CAPACITIES = {"drops": 0.5, "config": None, "no-drop": "e/k"}


def _cfgs(arch, capacity=None, **kw):
    """(JAX config, port config): the smoke config, with
    ``capacity_factor`` ``capacity`` (None: the config's; "e/k":
    ``n_experts / top_k``) and the fields in ``kw``."""
    out = []
    for reg in (jregistry, registry):
        cfg = reg.get(arch, smoke=True)
        if capacity is not None:
            cf = cfg.n_experts / cfg.top_k if capacity == "e/k" else capacity
            kw = dict(kw, capacity_factor=cf)
        out.append(dataclasses.replace(cfg, **kw))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jparams(arch, dtype, seed=0):
    """The reference's init from ``key(seed)``, cast to f32 for ``dtype``
    f32 (cached: the tests only read it)."""
    jcfg, _ = _cfgs(arch)
    params = jparallel.init_params(jmodel.Model(jcfg, JCTX).param_defs(),
                                   jax.random.key(seed))
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return params


def _both(arch, dtype, seed=0):
    params = _jparams(arch, dtype, seed)
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


def _h(cfg, dtype, s=S, seed=1):
    x = np.random.default_rng(seed).normal(0, 1, (B, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(parallel.torch_dtype(dtype))


def _batch(cfg, s=S, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)}
    batch["labels"][:, :3] = -1
    return batch


def _jroute(x, router, cfg, cap):
    """The reference's routing, its own lines (``repro/models/moe.py``
    :77-96) on its own ops: (probs, gate_idx (t, k), pos (t*k,), keep)."""
    logits = jnp.einsum("td,de->te", x.astype(jnp.float32), router.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    _, gate_idx = lax.top_k(probs, cfg.top_k)
    e_flat = gate_idx.reshape(-1)
    pos_all = jnp.cumsum(jax.nn.one_hot(e_flat, cfg.n_experts, dtype=jnp.float32), axis=0) - 1.0
    pos = jnp.take_along_axis(pos_all, e_flat[:, None], axis=1)[:, 0]
    keep = pos < cap
    return probs, gate_idx, jnp.where(keep, pos, cap - 1).astype(jnp.int32), keep


@pytest.fixture
def routing(monkeypatch):
    """Log each moe layer call's routing in both packages: the port's
    ``moe_route`` result, and the reference's, recomputed by ``_jroute``
    on the input its ``moe_ffn`` gets when it runs eagerly (under
    ``jax.disable_jit()``; traced calls are not logged).  ``routing()``
    asserts the two logs equal, layer call by layer call, and returns
    their length."""
    port, ref = [], []
    real_route, real_ffn = moe.moe_route, jmoe.moe_ffn

    def route(x, router, cfg, cap):
        r = real_route(x, router, cfg, cap)
        port.append((r["gate_idx"].numpy(), r["keep"].numpy()))
        return r

    def ffn(h, w, cfg, ctx, dispatch_comm=None):
        if not isinstance(h, jax.core.Tracer):  # an eager call: log it
            t = h.shape[0] * h.shape[1]
            cap = jmoe.moe_capacity(t, cfg)
            _, idx, _, keep = _jroute(h.reshape(t, -1), w["router"], cfg, cap)
            ref.append((np.asarray(idx), np.asarray(keep)))
        return real_ffn(h, w, cfg, ctx, dispatch_comm=dispatch_comm)

    monkeypatch.setattr(moe, "moe_route", route)
    monkeypatch.setattr(jmoe, "moe_ffn", ffn)

    def check():
        assert len(port) == len(ref) > 0
        for (pi, pk), (ri, rk) in zip(port, ref):
            np.testing.assert_array_equal(pi, ri)
            np.testing.assert_array_equal(pk, rk)
        return len(port)

    return check


def _same_routing(jx, tx, jw, tw, jcfg, tcfg):
    """Assert the port routes as the reference; returns the keep mask."""
    t = tx.shape[0] * tx.shape[1]
    cap = moe.moe_capacity(t, tcfg)
    assert cap == jmoe.moe_capacity(t, jcfg)
    _, jidx, jpos, jkeep = _jroute(jx.reshape(t, -1), jw["router"], jcfg, cap)
    r = moe.moe_route(tx.reshape(t, -1), tw["router"], tcfg, cap)
    np.testing.assert_array_equal(r["gate_idx"].numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(r["keep"].numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(r["pos"].numpy(), np.asarray(jpos))
    return r["keep"].numpy()


# ---------------------------------------------------------------------------
# Routing and one layer
# ---------------------------------------------------------------------------


def test_capacity_matches_the_reference():
    for arch in ARCHS:
        for smoke in (True, False):
            for cf in (0.5, 1.25, 8.0, 16.0):
                j = dataclasses.replace(jregistry.get(arch, smoke=smoke), capacity_factor=cf)
                t = dataclasses.replace(registry.get(arch, smoke=smoke), capacity_factor=cf)
                for tokens in (1, 2, 7, 8, 80, 4096, 8192, 65536):
                    assert moe.moe_capacity(tokens, t) == jmoe.moe_capacity(tokens, j)
    assert moe.moe_capacity(4096, registry.get(PHI)) == 640  # B=2, S=2048 on the card


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_orders_ties_and_nans_as_lax(k):
    """Values from {0, 1/4, 1/2} (every row ties), rows of NaN, a NaN
    beside numbers, +inf: the experts ``lax.top_k`` picks, in its order."""
    rng = np.random.default_rng(k)
    p = rng.choice(np.float32([0.0, 0.25, 0.5]), size=(64, 6))
    p[3] = np.nan
    p[5, 2] = np.nan
    p[7, 4] = np.inf
    jv, ji = lax.top_k(jnp.asarray(p), k)
    tv, ti = moe._top_k(torch.from_numpy(p), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("capacity", list(CAPACITIES), ids=list(CAPACITIES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_and_block_match_jax(arch, dtype, capacity):
    jcfg, tcfg = _cfgs(arch, CAPACITIES[capacity])
    jp, tp = _both(arch, dtype)
    jw, tw = _layer0(jp["blocks"]), _layer0(tp["blocks"])
    jh, th = _h(tcfg, dtype)
    keep = _same_routing(jh, th, jw["moe"], tw["moe"], jcfg, tcfg)
    if capacity == "drops":
        assert not keep.all()
    elif capacity == "no-drop":
        assert keep.all()
    jout, jaux = jmoe.moe_ffn(jh, jw["moe"], jcfg, JCTX)
    out, aux = moe.moe_ffn(th, tw["moe"], tcfg, CTX)
    assert out.dtype == th.dtype and aux.dtype == torch.float32
    _close(out, jout, LAYER_TOL[dtype])
    _close(aux, jaux, LAYER_TOL["float32"])
    jpos, tpos = jnp.arange(S), torch.arange(S)
    jout, jaux = jblocks.moe_block(jh, jw, jcfg, JCTX, positions=jpos)
    out, aux = blocks.moe_block(th, tw, tcfg, CTX, positions=tpos)
    _close(out, jout, LAYER_TOL[dtype])
    _close(aux, jaux, LAYER_TOL["float32"])


def test_tied_router_columns_route_as_the_reference():
    """Experts 1 and 2 with equal router columns: equal probabilities for
    every token, and the lower index taken first, as ``lax.top_k``."""
    jcfg, tcfg = _cfgs(PHI, CAPACITIES["drops"])
    jp, tp = _both(PHI, "float32")
    jw = dict(_layer0(jp["blocks"])["moe"])
    jw["router"] = jw["router"].at[:, 2].set(jw["router"][:, 1])
    tw = convert.params_from_jax(jax.tree.map(np.asarray, jw), "cpu")
    jh, th = _h(tcfg, "float32")
    t = B * S
    r = moe.moe_route(th.reshape(t, -1), tw["router"], tcfg, moe.moe_capacity(t, tcfg))
    jprobs = np.asarray(_jroute(jh.reshape(t, -1), jw["router"], jcfg, 8)[0])
    np.testing.assert_array_equal(r["probs"][:, 1].numpy(), r["probs"][:, 2].numpy())
    np.testing.assert_array_equal(jprobs[:, 1], jprobs[:, 2])
    both = (r["gate_idx"] == 1).any(-1) & (r["gate_idx"] == 2).any(-1)
    assert int(both.sum()) > 0 and bool((r["gate_idx"][both] == torch.tensor([1, 2])).all())
    _same_routing(jh, th, jw, tw, jcfg, tcfg)
    jout, jaux = jmoe.moe_ffn(jh, jw, jcfg, JCTX)
    out, aux = moe.moe_ffn(th, tw, tcfg, CTX)
    _close(out, jout, LAYER_TOL["float32"])
    _close(aux, jaux, LAYER_TOL["float32"])


def test_nan_in_x_spreads_as_in_the_reference():
    """One NaN in x: its token's output, and at a dropping capacity the
    slot ``cap - 1`` its dropped slots add ``NaN * 0`` into, are NaN in
    both packages; the aux loss is NaN; every other value agrees."""
    jcfg, tcfg = _cfgs(PHI, CAPACITIES["drops"])
    jp, tp = _both(PHI, "float32")
    jw, tw = _layer0(jp["blocks"])["moe"], _layer0(tp["blocks"])["moe"]
    x = np.random.default_rng(1).normal(0, 1, (B, S, tcfg.d_model)).astype(np.float32)
    x[1, 30, 5] = np.nan  # a late token: its slots are dropped
    jh, th = jnp.asarray(x), torch.from_numpy(x)
    keep = _same_routing(jh, th, jw, tw, jcfg, tcfg)
    assert not keep.reshape(B, S, -1)[1, 30].all()
    jout, jaux = jmoe.moe_ffn(jh, jw, jcfg, JCTX)
    out, aux = moe.moe_ffn(th, tw, tcfg, CTX)
    jnan, tnan = np.isnan(np.asarray(jout)), torch.isnan(out).numpy()
    np.testing.assert_array_equal(tnan, jnan)
    assert tnan.any(-1).sum() > 1  # more than the NaN's own token
    assert np.isnan(float(jaux)) and bool(torch.isnan(aux))
    fin = ~jnan
    _close(out.numpy()[fin], np.asarray(jout)[fin], LAYER_TOL["float32"])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch, dtype, routing):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _both(arch, dtype)
    batch = _batch(tcfg)
    with jax.disable_jit():
        want = float(jmodel.Model(jcfg, JCTX).loss_fn(jp, batch))
    got = float(Model(tcfg, CTX, params=tp, device="cpu").loss_fn(tp, batch))
    assert routing() == tcfg.n_layers
    assert np.isfinite(got) and abs(got - want) <= TOL[dtype] * abs(want), (got, want)


def test_aux_loss_is_added_as_the_reference():
    """``loss_fn`` less the xent is ``MOE_AUX_COEF`` times the layers'
    mean aux, the reference's ``MOE_AUX_COEF``."""
    assert MOE_AUX_COEF == jmodel.MOE_AUX_COEF
    _, tcfg = _cfgs(PHI)
    _, tp = _both(PHI, "float32")
    model = Model(tcfg, CTX, params=tp, device="cpu")
    batch = _batch(tcfg)
    tokens, labels = torch.from_numpy(batch["tokens"]), torch.from_numpy(batch["labels"])
    h = layers.embed_lookup(tokens, tp["embed"], CTX)
    h, aux = model._backbone(h, tp, positions=torch.arange(S))
    h = layers.rms_norm(h, tp["final_norm"], tcfg.norm_eps)
    xent = layers.vocab_parallel_xent(layers.vocab_parallel_logits(h, tp["unembed"], CTX),
                                      torch.clamp(labels, min=0), CTX,
                                      mask=(labels >= 0).to(torch.float32))
    assert 0.5 * tcfg.n_layers < float(aux) < 2 * tcfg.n_layers  # each near 1 (balanced)
    assert float(model.loss_fn(tp, batch)) == float(xent + MOE_AUX_COEF * aux / tcfg.n_layers)


def test_dispatch_gz_eb_at_tp1_changes_nothing():
    jcfg, tcfg = _cfgs(PHI)
    jgz, tgz = _cfgs(PHI, moe_dispatch_gz_eb=1e-3)
    jp, tp = _both(PHI, "float32")
    batch = _batch(tcfg)
    base = Model(tcfg, CTX, params=tp, device="cpu").loss_fn(tp, batch)
    gz = Model(tgz, CTX, params=tp, device="cpu").loss_fn(tp, batch)
    assert base.view(torch.int32) == gz.view(torch.int32)
    want = float(jmodel.Model(jgz, JCTX).loss_fn(jp, batch))
    assert want == float(jmodel.Model(jcfg, JCTX).loss_fn(jp, batch))
    assert abs(float(gz) - want) <= TOL["float32"] * abs(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax(arch, routing):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _both(arch, "float32")
    batch = _batch(tcfg)
    want = jax.jit(jax.grad(jmodel.Model(jcfg, JCTX).loss_fn))(jp, batch)
    with jax.disable_jit():  # the reference's routing of the same forward
        jmodel.Model(jcfg, JCTX).loss_fn(jp, batch)
    leaves, rebuild = tree_flatten(tp)
    req = [p.detach().requires_grad_(True) for p in leaves]
    model = Model(tcfg, CTX, params=tp, device="cpu")
    got = rebuild(list(torch.autograd.grad(model.loss_fn(rebuild(req), batch), req)))
    assert routing() == tcfg.n_layers
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


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax_and_prefill(arch, routing):
    """At ``n_experts / top_k`` nothing drops, in decode (B = 2 tokens,
    cap 8) or prefill (B·S tokens, cap B·S): the same function."""
    jcfg, tcfg = _cfgs(arch, "e/k")
    jp, tp = _both(arch, "float32")
    jm, tm = jmodel.Model(jcfg, JCTX), Model(tcfg, CTX, params=tp, device="cpu")
    spec_kw = dict(s_total=S, cp_axis=None, cp_size=1)
    jspec, tspec = jattention.KVCacheSpec(**spec_kw), KVCacheSpec(**spec_kw)
    kv = (tcfg.n_layers, B, S, tcfg.n_kv_heads, tcfg.head_dim)
    assert tm.cache_defs(B, tspec) == jm.cache_defs(B, jspec) == {"k": kv, "v": kv}
    jcache = {k: jnp.zeros(v, jnp.float32) for k, v in jm.cache_defs(B, jspec).items()}
    tcache = {k: torch.zeros(v) for k, v in tm.cache_defs(B, tspec).items()}
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    got = []
    for i in range(S):
        with jax.disable_jit():
            jl, jcache = jm.decode_fn(jp, jcache, jnp.asarray(tokens[:, i:i + 1]), jnp.int32(i),
                                      jspec)
        tl, tcache = tm.decode_fn(tp, tcache, tokens[:, i:i + 1], i, tspec)
        _close(tl, jl, 1e-5)
        got.append(tl[:, 0])
    assert routing() == S * tcfg.n_layers
    for k in ("k", "v"):
        _close(tcache[k], jcache[k], 1e-5)  # written in place, row by row
    got = torch.stack(got, dim=1)
    assert _rel(got, _prefill(tm, tp, tokens)) < 0.05
    # the configs' 1.25: decode unchanged (cap 8), the prefill may drop
    _, t125 = _cfgs(arch)
    gap = _rel(got, _prefill(Model(t125, CTX, params=tp, device="cpu"), tp, tokens))
    assert np.isfinite(gap)


def _flat_defs(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_defs(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


# the full configs' parameters: phi3.5-moe 32 layers of 1,300,307,968
# (1,258,291,200 of them experts), vocab 32064 padded to 32256;
# llama4-scout 48 layers of 2,076,272,640, vocab 202048 padded to 202240
FULL_PARAMS = {PHI: 41_874_100_224, SCOUT: 101_732_029_440}


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
    assert want["blocks.moe.wi"][0] == (tcfg.n_layers, tcfg.n_experts, tcfg.d_model, tcfg.d_ff)
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


def test_init_draws_a_large_leaf_slab_by_slab(monkeypatch):
    """A leaf above ``SLAB`` elements is drawn one slab of dim 0 at a
    time, each slab as a leaf of its shape (and the whole leaf's fan-in)
    would be."""
    d = parallel.ParamDef((3, 4, 64, 32), ("model", None, "data", None), init="scaled")
    monkeypatch.setattr(parallel, "SLAB", 4 * 64 * 32)
    slabs = d.initializer(torch.Generator().manual_seed(7), "cpu")
    gen = torch.Generator().manual_seed(7)
    one = parallel.ParamDef((4, 64, 32), (None, "data", None), init="scaled")
    want = torch.stack([one.initializer(gen, "cpu") for _ in range(3)])
    assert slabs.dtype == torch.bfloat16 and torch.equal(slabs, want)
    normal = parallel.ParamDef((3, 8192), (None, None), init="normal").initializer(
        torch.Generator().manual_seed(7), "cpu").float()
    assert abs(float(normal.std()) - 0.02) < 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_checkpoint_round_trips_are_bit_exact(arch, tmp_path):
    jcfg = jregistry.get(arch, smoke=True)
    params = jparallel.init_params(jmodel.Model(jcfg, JCTX).param_defs(), jax.random.key(5))
    tree = jax.tree.map(np.asarray, params)
    t = convert.params_from_jax(tree, "cpu")
    assert sorted(t["blocks"]["moe"]) == ["router", "wg", "wi", "wo"]
    assert t["blocks"]["moe"]["wi"].dtype == torch.bfloat16
    assert t["blocks"]["moe"]["wi"].dim() == 4
    back = convert.params_to_numpy(t)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                            jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        bits = np.uint16 if a.dtype.itemsize == 2 else np.uint32
        np.testing.assert_array_equal(a.view(bits), b.view(bits))
    # the port's checkpoint restored by the reference, and the reference's by the port
    checkpoint.save(str(tmp_path / "torch"), 1, t)
    theirs = jcheckpoint.restore(str(tmp_path / "torch"), 1, params)
    jcheckpoint.save(str(tmp_path / "jax"), 1, params)
    ours = checkpoint.restore(str(tmp_path / "jax"), 1, t, device="cpu")
    assert _same_bits(ours, t)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(theirs)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


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
    """Each moe layer, which returns (h, aux), checkpointed once; the
    loss and every gradient equal by bits with and without."""
    from repro_torch.models import model as model_mod

    calls = []
    real = model_mod.checkpoint.checkpoint
    monkeypatch.setattr(model_mod.checkpoint, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _, cfg = _cfgs(PHI, CAPACITIES["drops"])
    batch = _batch(cfg)
    out = {}
    for remat in ("none", "full"):
        model = Model(cfg, parallel.ParallelCtx(remat=remat), device="cpu", seed=3)
        leaves, rebuild = tree_flatten(convert.tree_map(lambda p: p.detach().to(dtype),
                                                        model.params()))
        req = [p.requires_grad_(True) for p in leaves]
        loss = model.loss_fn(rebuild(req), batch)
        out[remat] = [loss] + list(torch.autograd.grad(loss, req))
    assert len(calls) == cfg.n_layers
    assert all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(out["none"], out["full"]))


def test_train_step_on_two_ranks_keeps_replicas_equal():
    cfg = registry.get(PHI, smoke=True)
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
    for name in ("router", "wi", "wg", "wo"):  # every expert leaf trained
        assert not torch.equal(params[0]["blocks"]["moe"][name], p0["blocks"]["moe"][name])


def test_sync_plans_match_the_reference():
    """Each leaf's ring allreduce over 2 data ranks at eb 1e-4, the train
    step's sync: the same plan as the reference's at the port's hardware
    point (``make_setup``'s), at the smoke size and at full size."""
    ours = GZCommunicator("data", config=GZConfig(eb=1e-4, algo="ring"), axis_size=2,
                          device="cpu")
    ref = jcomm.GZCommunicator("data", config=JGZConfig(eb=1e-4, algo="ring"), axis_size=2,
                               hw=jcost_model.A100_SLINGSHOT)
    assert ours.hw == cost_model.A100_SLINGSHOT
    for arch in ARCHS:
        for smoke in (True, False):
            cfg = registry.get(arch, smoke=smoke)
            defs = tree_flatten(Model(cfg, CTX, params={}, device="cpu").param_defs())[0]
            assert len(defs) == 13
            for d in defs:
                a = convert.plan_fields(ours.plan("allreduce", d.shape,
                                                  parallel.torch_dtype(d.dtype)))
                b = convert.plan_fields(ref.plan("allreduce", d.shape, jnp.dtype(d.dtype)))
                assert a == b, (arch, d.shape, d.dtype)


def test_train_cli_loss_falls():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = train(["--arch", PHI, "--smoke", "--device", "cpu", "--steps", "12",
                        "--batch", "4", "--seq", "64", "--lr", "1e-3", "--grad-gz", "ring"])
    assert out.getvalue().splitlines()[0].startswith("arch=phi3.5-moe-smoke ")
    assert len(losses) == 12 and np.isfinite(losses).all() and losses[-1] < losses[0]
