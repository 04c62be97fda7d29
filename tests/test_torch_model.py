"""The port's dense model stack against the JAX package, on the CPU.

Each layer function, ``dense_block`` (both block layouts) and
``Model.loss_fn`` for the three dense smoke configs (minitron-8b,
internlm2-20b, deepseek-67b) take the same inputs, made from a seed with
numpy, and the same weights, carried across with
``convert.params_from_jax``.  Tolerances: with f32 weights (JAX's bf16
weights cast to f32; the model code is dtype-generic) the point is the
algorithm, rel 1e-5; with the bf16 weights themselves rel 2e-3, because
bf16 rounds at other places in the two frameworks (XLA fuses and keeps
f32 between ops where torch rounds each op's result to bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jattention
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import parallel as jparallel
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import attention, blocks, layers, parallel
from repro_torch.models.model import Model

DENSE = ["minitron-8b", "internlm2-20b", "deepseek-67b"]
JCTX = jparallel.ParallelCtx(tp_size=1, fsdp_size=1, remat="none")
CTX = parallel.ParallelCtx(remat="none")
TOL = {"float32": 1e-5, "bfloat16": 2e-3}
# One layer's output, relative to its largest value: f32 sums in another
# order (1e-6); a bf16 output may differ by two units in its last place
# (2**-7 of the largest value) where the frameworks round at other points.
LAYER_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}


def _jparams(cfg, dtype, seed=0):
    params = jparallel.init_params(jmodel.Model(cfg, JCTX).param_defs(),
                                   jax.random.key(seed))
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return params


def _both(params):
    """(JAX tree, port tree on the CPU) of the same weights."""
    return params, convert.params_from_jax(jax.tree.map(np.asarray, params), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, f"rel err {err} > {rel}"


def _batch(cfg, b, s, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if masked:
        batch["labels"][:, :3] = -1
    return batch


# ---------------------------------------------------------------------------
# Layer functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 5, 64)).astype(np.float32)
    w = rng.normal(1, 0.1, (64,)).astype(np.float32)
    jd = jnp.dtype(dtype)
    want = jlayers.rms_norm(jnp.asarray(x, jd), jnp.asarray(w, jd), 1e-5)
    td = parallel.torch_dtype(dtype)
    got = layers.rms_norm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td), 1e-5)
    assert got.dtype == td
    _close(got, want, LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_and_apply_rope(dtype):
    pos = np.arange(7)
    js, jc = jlayers.rope(jnp.asarray(pos), 32, 1e4)
    ts, tc = layers.rope(torch.from_numpy(pos), 32, 1e4)
    _close(ts, js, 1e-6)
    _close(tc, jc, 1e-6)
    x = np.random.default_rng(1).normal(0, 1, (2, 7, 3, 32)).astype(np.float32)
    jd, td = jnp.dtype(dtype), parallel.torch_dtype(dtype)
    want = jlayers.apply_rope(jnp.asarray(x, jd), js, jc)
    got = layers.apply_rope(torch.from_numpy(x).to(td), ts, tc)
    assert got.dtype == td
    _close(got, want, LAYER_TOL[dtype])
    # one decode position: (1, D/2) tables against a (B, 1, H, D) input
    js1, jc1 = jlayers.rope(jnp.asarray([5]), 32, 1e4)
    ts1, tc1 = layers.rope(torch.tensor([5]), 32, 1e4)
    _close(layers.apply_rope(torch.from_numpy(x[:, :1]), ts1, tc1),
           jlayers.apply_rope(jnp.asarray(x[:, :1]), js1, jc1), 1e-5)


def test_embed_lookup_and_gather_logits():
    rng = np.random.default_rng(2)
    w = rng.normal(0, 1, (40, 16)).astype(np.float32)
    ids = rng.integers(-3, 45, (2, 9)).astype(np.int32)  # some out of range
    want = jlayers.embed_lookup(jnp.asarray(ids), jnp.asarray(w), JCTX)
    got = layers.embed_lookup(torch.from_numpy(ids), torch.from_numpy(w), CTX)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    x = torch.randn(2, 1, 40)
    assert layers.gather_logits(x, CTX) is x


@pytest.mark.parametrize("masked", [False, True])
def test_vocab_logits_and_xent(masked):
    rng = np.random.default_rng(3)
    h = rng.normal(0, 1, (2, 6, 32)).astype(np.float32)
    w = rng.normal(0, 0.2, (32, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 6)).astype(np.int32)
    jl = jlayers.vocab_parallel_logits(jnp.asarray(h, jnp.bfloat16),
                                       jnp.asarray(w, jnp.bfloat16), JCTX)
    tl = layers.vocab_parallel_logits(torch.from_numpy(h).bfloat16(),
                                      torch.from_numpy(w).bfloat16(), CTX)
    assert tl.dtype == torch.float32
    _close(tl, jl, 1e-6)
    mask = (rng.random((2, 6)) > 0.4).astype(np.float32) if masked else None
    want = jlayers.vocab_parallel_xent(jl, jnp.asarray(labels), JCTX,
                                       mask=None if mask is None else jnp.asarray(mask))
    got = layers.vocab_parallel_xent(tl, torch.from_numpy(labels), CTX,
                                     mask=None if mask is None else torch.from_numpy(mask))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("chunk", [4, 6, 64])
def test_chunked_vocab_xent(chunk):
    rng = np.random.default_rng(4)
    h = rng.normal(0, 1, (2, 10, 32)).astype(np.float32)
    w = rng.normal(0, 0.2, (32, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 10)).astype(np.int32)
    mask = (rng.random((2, 10)) > 0.3).astype(np.float32)
    want = jlayers.chunked_vocab_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels),
                                      jnp.asarray(mask), JCTX, chunk=chunk)
    got = layers.chunked_vocab_xent(torch.from_numpy(h), torch.from_numpy(w),
                                    torch.from_numpy(labels), torch.from_numpy(mask),
                                    CTX, chunk=chunk)
    _close(got, want, 1e-6)


def _block_params(cfg, dtype, seed=5):
    defs = {"ln1": jblocks.norm_def(cfg), "ln2": jblocks.norm_def(cfg),
            "attn": jblocks.attn_defs(cfg, 1), "mlp": jblocks.mlp_defs(cfg)}
    p = jparallel.init_params(defs, jax.random.key(seed))
    if dtype == "float32":
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    return _both(p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(dtype):
    cfg = jregistry.get("minitron-8b", smoke=True)
    jp, tp = _block_params(cfg, dtype)
    x = np.random.default_rng(6).normal(0, 1, (2, 5, cfg.d_model)).astype(np.float32)
    jd, td = jnp.dtype(dtype), parallel.torch_dtype(dtype)
    want = jblocks._mlp(jnp.asarray(x, jd), jp["mlp"], JCTX)
    got = blocks._mlp(torch.from_numpy(x).to(td), tp["mlp"], CTX)
    assert got.dtype == td
    _close(got, want, LAYER_TOL[dtype])


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("window", [0, 5])
def test_attention_train(flash, window):
    jcfg = dataclasses.replace(jregistry.get("minitron-8b", smoke=True),
                               use_flash_kernel=flash)
    tcfg = dataclasses.replace(registry.get("minitron-8b", smoke=True),
                               use_flash_kernel=flash)
    jp, tp = _block_params(jcfg, "float32")
    x = np.random.default_rng(7).normal(0, 1, (2, 20, jcfg.d_model)).astype(np.float32)
    pos = np.arange(20)
    want = jattention.attention_train(jnp.asarray(x), jp["attn"], jcfg, JCTX,
                                      positions=jnp.asarray(pos), window=window)
    got = attention.attention_train(torch.from_numpy(x), tp["attn"], tcfg, CTX,
                                    positions=torch.from_numpy(pos), window=window)
    _close(got, want, LAYER_TOL["float32"])


@pytest.mark.parametrize("parallel_block", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_block(parallel_block, dtype):
    jcfg = dataclasses.replace(jregistry.get("minitron-8b", smoke=True),
                               parallel_block=parallel_block)
    tcfg = dataclasses.replace(registry.get("minitron-8b", smoke=True),
                               parallel_block=parallel_block)
    jp, tp = _block_params(jcfg, dtype)
    x = np.random.default_rng(8).normal(0, 1, (2, 16, jcfg.d_model)).astype(np.float32)
    pos = np.arange(16)
    jd, td = jnp.dtype(dtype), parallel.torch_dtype(dtype)
    want = jblocks.dense_block(jnp.asarray(x, jd), jp, jcfg, JCTX,
                               positions=jnp.asarray(pos))
    got = blocks.dense_block(torch.from_numpy(x).to(td), tp, tcfg, CTX,
                             positions=torch.from_numpy(pos))
    assert got.dtype == td
    _close(got, want, LAYER_TOL[dtype])


# ---------------------------------------------------------------------------
# The loss forward
# ---------------------------------------------------------------------------


def _loss_pair(arch, dtype, **cfg_kw):
    jcfg = dataclasses.replace(jregistry.get(arch, smoke=True), **cfg_kw)
    tcfg = dataclasses.replace(registry.get(arch, smoke=True), **cfg_kw)
    jp, tp = _both(_jparams(jcfg, dtype))
    batch = _batch(jcfg, 2, 128)
    want = float(jax.jit(jmodel.Model(jcfg, JCTX).loss_fn)(jp, batch))
    model = Model(tcfg, CTX, params=tp, device="cpu")
    got = model.loss_fn(tp, batch)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(model(batch)) == float(got)
    return float(got), want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_loss_fn_matches_jax(arch, flash, dtype):
    got, want = _loss_pair(arch, dtype, use_flash_kernel=flash)
    assert np.isfinite(got)
    assert abs(got - want) <= TOL[dtype] * abs(want), (got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("loss_chunk", [48, 128])
def test_loss_fn_chunked_vocab_matches_jax(loss_chunk, dtype):
    got, want = _loss_pair("minitron-8b", dtype, loss_chunk=loss_chunk,
                           use_flash_kernel=True)
    assert abs(got - want) <= TOL[dtype] * abs(want), (got, want)


def test_flash_kernel_path_matches_chunked_path():
    """The bound of tests/test_flash_kernel.py, on the port alone."""
    cfg = registry.get("minitron-8b", smoke=True)
    model = Model(cfg, CTX, device="cpu", seed=3)
    batch = _batch(cfg, 2, 128, masked=False)
    l0 = float(model.loss_fn(model.params(), batch))
    l1 = float(Model(dataclasses.replace(cfg, use_flash_kernel=True), CTX,
                     params=model.params(), device="cpu").loss_fn(model.params(), batch))
    assert abs(l0 - l1) < 2e-3 * max(abs(l0), 1.0), (l0, l1)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def test_param_tree_names_and_shapes_match_jax():
    jcfg = jregistry.get("minitron-8b", smoke=True)
    tcfg = registry.get("minitron-8b", smoke=True)
    jdefs = jmodel.Model(jcfg, JCTX).param_defs()
    jleaves = jax.tree_util.tree_flatten_with_path(
        jdefs, is_leaf=lambda x: isinstance(x, jparallel.ParamDef))[0]
    want = {".".join(k.key for k in path): (d.shape, d.init, d.dtype, tuple(d.spec))
            for path, d in jleaves}
    model = Model(tcfg, CTX, device="cpu")
    state = model.state_dict()
    assert set(state) == set(want)
    for name, (shape, _, dtype, _) in want.items():
        assert tuple(state[name].shape) == shape and str(state[name].dtype) == f"torch.{dtype}"

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    assert {name: (d.shape, d.init, d.dtype, d.spec)
            for name, d in flat(model.param_defs())} == want
    shapes = parallel.param_shapes(model.param_defs())
    assert shapes["blocks"]["attn"]["wq"].device.type == "meta"
    assert tuple(shapes["blocks"]["attn"]["wq"].shape) == (2, 128, 128)


def test_params_from_jax_round_trip_is_bit_exact():
    params = _jparams(jregistry.get("minitron-8b", smoke=True), "bfloat16")
    params["extra_f32"] = jnp.asarray(np.random.default_rng(0).normal(size=7), jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    back = convert.params_to_numpy(convert.params_from_jax(tree, "cpu"))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                            jax.tree.leaves(back)):
        assert a.dtype == b.dtype, path
        bits = np.uint16 if a.dtype.itemsize == 2 else np.uint32
        np.testing.assert_array_equal(a.view(bits), b.view(bits))
    t = convert.params_from_jax(tree, "cpu")
    assert t["blocks"]["mlp"]["wi"].dtype == torch.bfloat16
    assert t["extra_f32"].dtype == torch.float32


@pytest.mark.parametrize("init,want_mean,want_std", [
    ("normal", 0.0, 0.02), ("scaled", 0.0, 1 / np.sqrt(64)), ("zeros", 0.0, 0.0),
    ("ones", 1.0, 0.0)])
def test_init_params_distributions(init, want_mean, want_std):
    d = parallel.ParamDef((4, 64, 512), (None, "data", "model"), init=init)
    x = parallel.init_params({"w": d}, torch.Generator().manual_seed(0), "cpu")["w"]
    assert x.dtype == torch.bfloat16 and tuple(x.shape) == (4, 64, 512)
    xf = x.to(torch.float32)
    assert abs(float(xf.mean()) - want_mean) < 2e-3 + 0.02 * want_std
    assert abs(float(xf.std()) - want_std) < 0.02 * want_std + 1e-6
    j = jparallel.ParamDef((4, 64, 512), jax.sharding.PartitionSpec(None, "data", "model"),
                           init=init).initializer(jax.random.key(0))
    jf = np.asarray(j, np.float32)
    assert abs(float(jf.std()) - float(xf.std())) < 0.03 * want_std + 1e-6


def test_model_seeds():
    cfg = registry.get("minitron-8b", smoke=True)
    a = Model(cfg, CTX, device="cpu", seed=1).state_dict()
    b = Model(cfg, CTX, device="cpu", seed=1).state_dict()
    c = Model(cfg, CTX, device="cpu", seed=2).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.attn.wq"], c["blocks.attn.wq"])


def test_unknown_family_raises():
    """Every family of the reference is ported; one it does not know raises
    ValueError, as its ``_block_defs`` does."""
    cfg = dataclasses.replace(registry.get("minitron-8b", smoke=True), family="retrieval")
    with pytest.raises(ValueError, match="retrieval"):
        Model(cfg, CTX, device="cpu")


def test_model_parallel_contexts_raise():
    # tp_size > 1 (ROADMAP A11.7) is ported for every family
    # (tests/test_torch_tp.py, tests/test_torch_tp_families.py): a model
    # of any family builds there; the context-parallel cache (A11.7b) is
    # ported too (tests/test_torch_cp_decode.py): its spec splits the context
    model = Model(registry.get("mamba2-780m", smoke=True), parallel.ParallelCtx(tp_size=2),
                  params={}, device="cpu")
    assert model.param_defs()["blocks"]["ssm"]["w_x"].spec == (None, "data", "model")
    assert attention.KVCacheSpec(s_total=64, cp_axis="data", cp_size=2).s_local == 32
    # fsdp_size > 1 (ROADMAP A11.6) is ported: each rank's shard of dim 1
    # gathers back into the whole weight (the exact gather: by bits)
    from repro_torch.core import transport

    ctx = parallel.ParallelCtx(fsdp_size=4)
    w = torch.arange(96, dtype=torch.float32).reshape(8, 12).to(torch.bfloat16)
    outs = transport.ThreadGroup(4, "cpu").run(
        lambda shard: ctx.gather(shard, dim=1), list(w.split(3, dim=1)), axis_name="data")
    assert all(torch.equal(o.view(torch.int16), w.view(torch.int16)) for o in outs)


def test_configs_match_the_reference():
    assert registry.arch_ids() == jregistry.arch_ids()
    for arch in registry.arch_ids():
        for smoke in (False, True):
            a, b = registry.get(arch, smoke=smoke), jregistry.get(arch, smoke=smoke)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert a.param_count() == b.param_count()
