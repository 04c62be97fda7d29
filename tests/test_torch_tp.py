"""Tensor and expert parallelism (ROADMAP A11.7, first half) against the
JAX package, on the CPU.

The port's ``Model.loss_fn`` and ``decode_fn`` at ``tp_size > 1`` run on
a CPU ``ThreadMesh`` of ranks, each rank on its ``training._local`` block
of the global weights, for the four smoke configs of the families that
run there: minitron-8b and internlm2-20b (dense GQA) and
phi3.5-moe-42b-a6.6b (top-2) and llama4-scout-17b-a16e (top-1).  Each
has 4 heads over 2 kv heads and the moe ones 4 experts, so at tp = 4 the
kv heads go to replication groups of 2 ranks and every rank owns one
expert (``e_local == 1``, where the dispatch may be compressed).  The moe
configs run at capacity factor 8.0, as the reference's own model-parallel
child does (``tests/_mp_model_parallel_child.py``): a rank routes only its
token slice at that slice's capacity, so a capacity that drops would drop
other slots than at tp = 1.

One JAX child, pinned to 8 host devices and started when this module's
first test runs, computes every reference value while the port-only
tests run: the weights (the reference's init from ``key(0)``, carried
across with ``convert.params_from_jax``), the reference's ``loss_fn``
under ``shard_map`` on ``(1, 4)`` and ``(2, 4)`` ``("data", "model")``
meshes (every rank's loss: the moe aux term is the rank's own), its
``decode_fn`` on ``(1, 4)`` (every rank's logits, 3 steps from an empty
cache: B = 2 tokens < tp, the moe token-padding path), the moe loss with
``moe_dispatch_gz_eb`` set (the compressed all-to-all on the dispatch),
and ``moe_ffn`` alone through a communicator that records both
all-to-alls' payloads, all in f32; and minitron's loss in bf16 at
``(1, 4)``, and in f32 with ``parallel_block`` (one shared TP reduction
a layer).  Everything there is jitted.  The port's sequence-chunked
vocab loss (``loss_chunk``) is held against the reference's one-shot
loss.

Tolerances, relative to the largest value of the reference's result:

  * f32 losses and decode logits: 1e-5 (another summation order in the
    GEMMs, as ``tests/test_torch_model.py`` and ``test_torch_moe.py``;
    measured at most 2.0e-7 for the losses, 7.0e-7 for the logits and
    1.9e-6 for the losses through the compressed dispatch);
    the port's ranks agree with each other by bits where the reference's
    do (every loss of a dense model, every decode logit);
  * the bf16 dense loss: 2e-3, the bound ``tests/test_torch_model.py``
    holds the dense bf16 loss to against the jitted reference (compiled,
    XLA keeps f32 between the bf16 ops it fuses, ROADMAP C21; the eager
    reference under ``shard_map`` would take a minute here; measured
    2.0e-4);
  * the compressed dispatch: the first all-to-all's payload (the slots,
    before and after the lossy hop) equal by bits on every rank, and its
    wire bytes; the return trip's payload is the experts' f32 output,
    another summation order, so it and ``moe_ffn``'s output are held at
    1e-5 of the largest value; every decompressed value within the eb
    of what was sent;
  * port-only, tp = 4 against tp = 1 on the same weights: within the
    reference child's own rtol, 0.02 for the dense losses and 0.05 for
    the moe ones (each rank's aux term covers its token slice only).

A gloo ``DistMesh`` at tp = 2 (two processes, no JAX) runs the dense
forward and decode, equal by bits to the ``ThreadMesh`` run, and a TP
gradient (the backward's collectives on each process's own thread).  The
refusal of ``tp_reduce``'s backward off the rank's thread (naming the
``DistMesh`` route); a context-parallel cache's ``s_local``; the train
step at tp = 2 on a CPU ``ThreadMesh`` runs (the context-parallel decode
is ``tests/test_torch_cp_decode.py``'s).  The other families at tp > 1
are ``tests/test_torch_tp_families.py``'s, the train step at tp > 1
``tests/test_torch_tp_train.py``'s.
"""
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import threading

if __name__ == "__main__" and sys.argv[1] == "jax":  # pin before JAX loads
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from _child_env import pin_device_count

    pin_device_count(8)

import dataclasses  # noqa: E402

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import transport
from repro_torch.core.comm import GZCommunicator
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.launch import shapes, training
from repro_torch.launch.mesh import ThreadMesh
from repro_torch.models import attention, blocks, moe, parallel
from repro_torch.models.model import Model
from repro_torch.optim import adamw

HERE = pathlib.Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
AXES = ("data", "model")
PHI, SCOUT = "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"
ARCHS = ("minitron-8b", "internlm2-20b", PHI, SCOUT)
MOE = (PHI, SCOUT)
MESHES = ((1, 4), (2, 4))
B, S = 4, 16
DECODE_B, DECODE_S, DECODE_STEPS = 2, 8, 3
GZ_EB = 1e-4  # the dispatch's eb (benchmarks/moe_a2a_ablation.py's)
TOL = {"float32": 1e-5, "bfloat16": 2e-3}
CHILD_RTOL = {"dense": 0.02, "moe": 0.05}  # tests/_mp_model_parallel_child.py


def cfg_of(reg, arch, eb=0.0, dtype=None):
    cfg = reg.get(arch, smoke=True)
    kw = {"moe_dispatch_gz_eb": eb}
    if cfg.family == "moe":
        kw["capacity_factor"] = 8.0
    if dtype is not None:
        kw["dtype"] = dtype
    return dataclasses.replace(cfg, **kw)


def batch_of(arch, b=B, s=S):
    rng = np.random.default_rng(ARCHS.index(arch))
    batch = {"tokens": rng.integers(0, 512, (b, s)).astype(np.int32),
             "labels": rng.integers(0, 512, (b, s)).astype(np.int32)}
    batch["labels"][:, :2] = -1
    return batch


def decode_tokens(arch):
    rng = np.random.default_rng(100 + ARCHS.index(arch))
    return rng.integers(0, 512, (DECODE_B, DECODE_STEPS)).astype(np.int32)


def moe_h(cfg):
    rng = np.random.default_rng(7)
    return rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _unflatten(flat: dict) -> dict:
    out = {}
    for path, a in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = a
    return out


# ---------------------------------------------------------------------------
# The JAX child
# ---------------------------------------------------------------------------


def _jax_child(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.configs import registry as jregistry
    from repro.core.collectives import GZConfig as JGZConfig
    from repro.core.comm import GZCommunicator as JGZCommunicator
    from repro.core.shmap import shard_map
    from repro.models import attention as jattention
    from repro.models import blocks as jblocks
    from repro.models import model as jmodel
    from repro.models import moe as jmoe
    from repro.models import parallel as jparallel

    import time

    res = {}
    devices = jax.devices()
    t0 = time.perf_counter()

    def stamp(what):
        print(f"{time.perf_counter() - t0:7.2f} s {what}", flush=True)

    def mesh_of(shape):
        return Mesh(np.array(devices[:shape[0] * shape[1]]).reshape(shape), AXES)

    def ctx_of(shape):
        return jparallel.ParallelCtx(tp_size=shape[1], fsdp_size=shape[0], dp_axes=("data",),
                                     remat="none")

    def loss(cfg, shape, params, batch):
        model = jmodel.Model(cfg, ctx_of(shape))
        specs = jparallel.param_specs(model.param_defs())
        bspecs = {k: P("data", None) for k in batch}
        f = shard_map(lambda p, b: model.loss_fn(p, b)[None], mesh=mesh_of(shape),
                      in_specs=(specs, bspecs), out_specs=P(AXES))
        return np.asarray(jax.jit(f)(params, batch))

    for arch in ARCHS:
        cfg = cfg_of(jregistry, arch)
        defs = jmodel.Model(cfg, ctx_of((1, 1))).param_defs()
        shapes4 = jax.tree.map(lambda d: d.shape, jmodel.Model(cfg, ctx_of((2, 4))).param_defs(),
                               is_leaf=lambda x: isinstance(x, jparallel.ParamDef))
        assert shapes4 == jax.tree.map(lambda d: d.shape, defs,
                                       is_leaf=lambda x: isinstance(x, jparallel.ParamDef))
        params = jparallel.init_params(defs, jax.random.key(0))
        for path, a in _paths(jax.tree.map(np.asarray, params)):
            res[f"w/{arch}/{path}"] = a.astype(np.float32)  # bf16 -> f32 is exact
        p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        batch = batch_of(arch)
        for shape in MESHES:
            res[f"loss/{arch}/{shape}"] = loss(cfg, shape, p32, batch)
        if arch == ARCHS[0]:  # PaLM-style: one shared reduction a layer
            res[f"loss_parallel_block/{arch}"] = loss(
                dataclasses.replace(cfg, parallel_block=True), (1, 4), p32, batch)
        stamp(f"{arch} losses")
        if arch in MOE:
            gz = cfg_of(jregistry, arch, eb=GZ_EB)
            res[f"loss_gz/{arch}"] = loss(gz, (1, 4), p32, batch)

            # moe_ffn alone, both all-to-alls' payloads recorded
            ctx = ctx_of((1, 4))
            dcomm = JGZCommunicator.for_config("model", JGZConfig(eb=GZ_EB, capacity_factor=0.8))
            w = jax.tree.map(lambda a: a[0], p32["blocks"]["moe"])
            wspecs = jparallel.param_specs(jblocks.moe_defs(gz))
            static = {}

            def ffn(h, w, gz=gz, ctx=ctx, dcomm=dcomm, static=static):
                rec = []

                class Recording:
                    def all_to_all(self, x):
                        r = dcomm.all_to_all(x)
                        rec.append((x, r.value))
                        static["wire"] = r.wire_bytes
                        return r

                out, aux = jmoe.moe_ffn(h, w, gz, ctx, dispatch_comm=Recording())
                return tuple(a[None] for a in (out, aux) + rec[0] + rec[1])

            f = shard_map(ffn, mesh=mesh_of((1, 4)), in_specs=(P(), wspecs),
                          out_specs=(P(AXES),) * 6)
            outs = jax.jit(f)(jnp.asarray(moe_h(gz)), w)
            for name, a in zip(("out", "aux", "in0", "out0", "in1", "out1"), outs):
                res[f"ffn/{arch}/{name}"] = np.asarray(a)
            res[f"ffn/{arch}/wire"] = np.int64(static["wire"])
            stamp(f"{arch} dispatch")

        # decode on (1, 4): every rank's logits, step by step
        ctx = ctx_of((1, 4))
        model = jmodel.Model(cfg, ctx)
        spec = jattention.KVCacheSpec(s_total=DECODE_S, cp_axis=None, cp_size=1)
        local = model.cache_defs(DECODE_B, spec)
        cache = {k: jnp.zeros(v[:3] + (v[3] * 4,) + v[4:], jnp.float32)
                 for k, v in local.items()}
        cspecs = {k: P(None, None, None, "model", None) for k in cache}
        specs = jparallel.param_specs(model.param_defs())

        def body(p, c, t, pos, model=model, spec=spec):
            logits, nc = model.decode_fn(p, c, t, pos, spec)
            return logits[None], nc

        f = jax.jit(shard_map(body, mesh=mesh_of((1, 4)), in_specs=(specs, cspecs, P(), P()),
                              out_specs=(P("model"), cspecs)))
        toks = decode_tokens(arch)
        for pos in range(DECODE_STEPS):
            logits, cache = f(p32, cache, jnp.asarray(toks[:, pos:pos + 1]), jnp.int32(pos))
            res[f"decode/{arch}/{pos}"] = np.asarray(logits)
        stamp(f"{arch} decode")

    # bf16: minitron's loss at (1, 4), jitted
    arch = ARCHS[0]
    params = _unflatten({k[len(f"w/{arch}/"):]: v for k, v in res.items()
                         if k.startswith(f"w/{arch}/")})
    p16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    res[f"loss16/{arch}"] = loss(cfg_of(jregistry, arch), (1, 4), p16, batch_of(arch))
    stamp("bf16")
    np.savez(out_path, **res)


class _Child:
    """The JAX child (``script jax OUT``), started with the module's first
    test; its results are read when a test first asks for them."""

    def __init__(self, tmp, script=__file__):
        env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
        env.pop("GZ_CHILD_DEVICES", None)
        self._out = tmp / f"{pathlib.Path(script).stem}.npz"
        self._proc = subprocess.Popen([sys.executable, script, "jax", str(self._out)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True, env=env)
        self._res = None

    def get(self) -> dict:
        if self._res is None:
            log, _ = self._proc.communicate(timeout=600)
            assert self._proc.returncode == 0, f"JAX child failed:\n{log}"
            with np.load(self._out) as z:
                self._res = {k: z[k] for k in z.files}
        return self._res

    def weights(self, arch, dtype="float32") -> dict:
        res, pre = self.get(), f"w/{arch}/"
        tree = convert.params_from_jax(
            _unflatten({k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}), "cpu")
        return convert.tree_map(lambda t: t.to(parallel.torch_dtype(dtype)), tree)

    def close(self):
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def child(tmp_path_factory):
    kid = _Child(tmp_path_factory.mktemp("jax_tp"))
    try:
        yield kid
    finally:
        kid.close()


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _f32(t) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _setup(cfg, shape, *, fsdp=None):
    mesh = ThreadMesh(shape, AXES, "cpu")
    return training.make_setup(cfg, mesh, remat="none",
                               fsdp=shape[0] > 1 if fsdp is None else fsdp)


def _blocks(setup, whole) -> list:
    """Every rank's ``_local`` block of the global tree."""
    sizes = dict(zip(setup.mesh.axis_names, setup.mesh.shape))
    return [training._local(whole, setup.specs, c, sizes) for c in training._coords(setup.mesh)]


def port_losses(cfg, shape, whole, batch) -> np.ndarray:
    """Every rank's ``loss_fn`` on its block of ``whole`` and of the batch
    (split over ``data`` on dim 0), in rank order."""
    setup = _setup(cfg, shape)
    sizes = dict(zip(setup.mesh.axis_names, setup.mesh.shape))
    bspecs = {k: ("data",) + (None,) * (v.ndim - 1) for k, v in batch.items()}
    inputs = [(p, training._local(batch, bspecs, c, sizes))
              for p, c in zip(_blocks(setup, whole), training._coords(setup.mesh))]
    with torch.no_grad():
        outs = setup.mesh.run(lambda a: setup.model.loss_fn(*a), inputs)
    return np.array([float(o) for o in outs], np.float32)


def port_decode(cfg, whole, tokens, shape=(1, 4)) -> list:
    """Every rank's logits (ranks stacked) at each of the decode steps
    from an empty cache, each rank with its own (B, S, kv_local, hd)
    cache."""
    setup = _setup(cfg, shape)
    spec = attention.KVCacheSpec(s_total=DECODE_S, cp_axis=None, cp_size=1)
    local = setup.model.cache_defs(DECODE_B, spec)
    params = _blocks(setup, whole)
    caches = [{k: torch.zeros(v) for k, v in local.items()} for _ in params]
    steps = []
    with torch.no_grad():
        for pos in range(DECODE_STEPS):
            tok = torch.from_numpy(tokens[:, pos:pos + 1])
            outs = setup.mesh.run(
                lambda a: setup.model.decode_fn(a[0], a[1], tok, pos, spec)[0],
                list(zip(params, caches)))
            steps.append(np.stack([_f32(o) for o in outs]))
    return steps


# ---------------------------------------------------------------------------
# Port-only (they run while the child works)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS + ("deepseek-67b",))
@pytest.mark.parametrize("tp", [2, 4])
def test_param_defs_have_the_same_global_shapes_at_every_tp(arch, tp):
    cfg = registry.get(arch, smoke=True)

    def shapes_at(tp):
        model = Model(cfg, parallel.ParallelCtx(tp_size=tp), params={}, device="cpu")
        return convert.tree_map(lambda d: d.shape, model.param_defs())

    assert shapes_at(tp) == shapes_at(1)


def test_q_heads_pad_to_a_multiple_of_tp():
    # llama4-scout's 40 heads become 48 at tp = 16: wq's columns and wo's
    # rows of the extra heads are their own
    cfg = registry.get(SCOUT)
    assert cfg.padded_heads(16) == 48 and cfg.padded_heads(1) == 40
    defs = blocks.attn_defs(cfg, 16)
    assert defs["wo"].shape == (48 * cfg.head_dim, cfg.d_model)
    assert defs["wq"].shape == (cfg.d_model, 48 * cfg.head_dim)


@pytest.mark.parametrize("n_kv,tp,want", [(2, 2, [[0], [1]]), (8, 4, [[0, 1], [2, 3], [4, 5],
                                                                    [6, 7]]),
                                          (2, 4, [[0], [0], [1], [1]]),
                                          (8, 16, [[h // 2] for h in range(16)])])
def test_local_kv_heads_slice_or_share(n_kv, tp, want):
    cfg = dataclasses.replace(registry.get("minitron-8b", smoke=True), n_kv_heads=n_kv)
    ctx = parallel.ParallelCtx(tp_size=tp)
    kv = torch.arange(n_kv, dtype=torch.float32).reshape(1, 1, n_kv, 1).expand(2, 3, n_kv, 4)
    outs = transport.ThreadGroup(tp, "cpu").run(
        lambda _: attention._local_kv(kv, cfg, ctx), [None] * tp, axis_name="model")
    assert [o[0, 0, :, 0].tolist() for o in outs] == [[float(h) for h in w] for w in want]
    assert all(o.shape[-2] == attention.kv_local_heads(cfg, tp) for o in outs)


def test_tp_collectives_on_a_threadgroup():
    # tp_reduce: the f32 sum in rank order, rounded once; tp_max; the
    # tiled all_gather; the all_to_all; tp_index
    ctx = parallel.ParallelCtx(tp_size=3)
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.normal(0, 1, (5, 4)).astype(np.float32)).to(torch.bfloat16)
          for _ in range(3)]

    def body(x):
        return (ctx.tp_reduce(x), ctx.tp_max(x), ctx.tp_all_gather(x, 1),
                ctx.tp_all_to_all(x[:3]), ctx.tp_index())

    outs = transport.ThreadGroup(3, "cpu").run(body, xs, axis_name="model")
    f32 = [x.to(torch.float32) for x in xs]
    want_sum = ((f32[0] + f32[1]) + f32[2]).to(torch.bfloat16)
    for r, (s, m, g, a, i) in enumerate(outs):
        assert i == r
        assert torch.equal(s.view(torch.int16), want_sum.view(torch.int16))
        assert torch.equal(m, torch.maximum(torch.maximum(xs[0], xs[1]), xs[2]))
        assert torch.equal(g, torch.cat(xs, dim=1))
        assert torch.equal(a, torch.stack([xs[q][r] for q in range(3)]))


def test_max_across_propagates_nan():
    xs = [torch.tensor([1.0, 2.0]), torch.tensor([float("nan"), 0.0])]
    outs = transport.ThreadGroup(2, "cpu").run(
        lambda x: transport.current("x").max_across(x), xs)
    assert all(np.isnan(o[0].item()) and o[1].item() == 2.0 for o in outs)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp4_forward_is_within_the_reference_childs_rtol_of_tp1(arch):
    cfg = cfg_of(registry, arch, dtype="float32")
    whole = Model(cfg, device="cpu", seed=3).params()
    whole = convert.tree_map(lambda p: p.detach().to(torch.float32), whole)
    batch = batch_of(arch)
    with torch.no_grad():
        want = float(Model(cfg, params=whole, device="cpu").loss_fn(whole, batch))
    got = port_losses(cfg, (1, 4), whole, batch)
    assert np.all(np.abs(got - want) <= CHILD_RTOL[cfg.family] * abs(want)), (got, want)
    if cfg.family == "dense":
        assert np.all(_bits(got) == _bits(got[:1]))


def test_tp_reduce_backward_is_the_psum_on_the_ranks_thread():
    # on the CPU each rank's backward runs on its own thread: the gradient
    # of sum(w_r * tp_reduce(x_r)) by x_r is the psum of the w's
    ctx = parallel.ParallelCtx(tp_size=2)
    ws = [torch.tensor([1.0, 2.0]), torch.tensor([10.0, 20.0])]

    def body(w):
        x = torch.ones(2, requires_grad=True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(torch.sum(w * ctx.tp_reduce(x)), x)
        return g

    outs = transport.ThreadGroup(2, "cpu").run(body, ws, axis_name="model")
    assert all(torch.equal(g, torch.tensor([11.0, 22.0])) for g in outs)


@pytest.mark.parametrize("what", ["tp_reduce", "tp_all_to_all", "tp_all_gather"])
def test_tp_backward_off_the_ranks_thread_raises(what):
    ctx = parallel.ParallelCtx(tp_size=2)

    def body(_):
        x = torch.ones(2, 3, requires_grad=True)
        with torch.enable_grad():
            y = {"tp_reduce": lambda: ctx.tp_reduce(x),
                 "tp_all_to_all": lambda: ctx.tp_all_to_all(x),
                 "tp_all_gather": lambda: ctx.tp_all_gather(x, 0)}[what]()
        return x, torch.sum(y)

    outs = transport.ThreadGroup(2, "cpu").run(body, [None, None], axis_name="model")
    x, loss = outs[0]
    # the main thread is not rank 0's: its exchange could never meet
    with pytest.raises(RuntimeError, match="DistMesh") as err:
        torch.autograd.grad(loss, x)
    assert "DistGroup" in str(err.value) and what in str(err.value)


def test_cp_cache_splits_s_local_and_tp_train_step_runs():
    # the context-parallel cache splits its context (or its window) over
    # cp; the train step at tp 2 runs on the CPU ThreadMesh, each rank's
    # backward on its thread
    assert attention.KVCacheSpec(s_total=64, cp_axis="data", cp_size=2).s_local == 32
    assert attention.KVCacheSpec(s_total=64, cp_axis="data", cp_size=2,
                                 window=16).s_local == 8
    cfg = registry.get("minitron-8b", smoke=True)
    mesh = ThreadMesh((1, 2), AXES, "cpu")
    setup = training.make_setup(cfg, mesh)
    assert setup.ctx.tp_size == 2
    _, bspecs = shapes.train_specs(cfg, shapes.InputShape("t", 16, 2, "train"), mesh)
    step = training.make_train_step(setup, bspecs)
    whole = parallel.init_params(setup.defs, torch.Generator().manual_seed(0), "cpu")
    params = [convert.tree_map(torch.clone, p) for p in _blocks(setup, whole)]
    opt = [adamw.adamw_init(p) for p in params]
    batch = next(SyntheticStream(cfg, 2, 16, seed=0))
    params, opt, m = step(params, opt, batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["gnorm"]))
    assert not bool(m["skipped"]) and int(opt[0]["step"]) == int(opt[1]["step"]) == 1
    # a leaf the model axis replicates (the norms) stays equal by bits on
    # both ranks; a split one (wo's rows) moved on each
    for r in range(2):
        assert torch.equal(params[r]["final_norm"], params[0]["final_norm"])
        assert not torch.equal(params[r]["blocks"]["mlp"]["wo"],
                               _blocks(setup, whole)[r]["blocks"]["mlp"]["wo"])


def test_serve_step_at_tp4_equals_tp1_decode():
    cfg = cfg_of(registry, PHI, dtype="float32")
    whole = convert.tree_map(lambda p: p.detach().to(torch.float32),
                             Model(cfg, device="cpu", seed=1).params())
    shape = shapes.InputShape("d", DECODE_S, 4, "decode")
    setup = _setup(cfg, (1, 4))
    cache, cspecs, _, tspec, plan = shapes.decode_specs(cfg, shape, setup.mesh, setup.model)
    one = Model(cfg, params=whole, device="cpu")
    cache1 = {k: torch.zeros(v) for k, v in one.cache_defs(4, plan).items()}
    step = training.make_serve_step(setup, cspecs, tspec, plan)
    cache4 = {k: torch.zeros(v.shape) for k, v in cache.items()}
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 3)).astype(np.int32)
    with torch.no_grad():
        for pos in range(3):
            t = torch.from_numpy(toks[:, pos:pos + 1])
            got, cache4 = step(_blocks(setup, whole), cache4, t, pos)
            want, _ = one.decode_fn(whole, cache1, t, pos, plan)
            assert tuple(got.shape) == tuple(want.shape) == (4, 1, cfg.padded_vocab())
            assert _rel(_f32(got), _f32(want)) <= TOL["float32"]


# ---------------------------------------------------------------------------
# gloo: one process per rank, tp = 2
# ---------------------------------------------------------------------------

DIST_ARCH = "minitron-8b"


def _dist_inputs():
    cfg = cfg_of(registry, DIST_ARCH, dtype="float32")
    whole = convert.tree_map(lambda p: p.detach().to(torch.float32),
                             Model(cfg, device="cpu", seed=2).params())
    return cfg, whole, batch_of(DIST_ARCH), decode_tokens(DIST_ARCH)


def _dist_grad(model, params, batch):
    """The gradient of this rank's loss by its block of ``wo`` of layer 0's
    MLP (row-parallel: its cotangent comes through ``tp_reduce``)."""
    leaf = params["blocks"]["mlp"]["wo"]
    x = leaf.detach().clone().requires_grad_(True)
    p = dict(params, blocks=dict(params["blocks"], mlp=dict(params["blocks"]["mlp"], wo=x)))
    with torch.enable_grad():
        (g,) = torch.autograd.grad(model.loss_fn(p, batch), x)
    return g


def _dist_child(rank: int, port: int, out_path: str) -> None:
    import torch.distributed as dist

    from repro_torch.core.transport import DistMesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    try:
        cfg, whole, batch, toks = _dist_inputs()
        mesh = DistMesh((1, 2), AXES)
        ctx = parallel.ParallelCtx(tp_size=2, remat="none")
        model = Model(cfg, ctx, params={}, device="cpu")
        specs = parallel.param_specs(model.param_defs())
        params = training._local(whole, specs, {"data": 0, "model": rank},
                                 {"data": 1, "model": 2})
        spec = attention.KVCacheSpec(s_total=DECODE_S, cp_axis=None, cp_size=1)
        cache = {k: torch.zeros(v) for k, v in model.cache_defs(DECODE_B, spec).items()}
        res = {}
        with mesh.bind(), torch.no_grad():
            res["loss"] = np.float32(model.loss_fn(params, batch))
            res["max"] = _f32(transport.current("model").max_across(
                torch.tensor([float(rank), -float(rank)])))
            for pos in range(DECODE_STEPS):
                logits, _ = model.decode_fn(params, cache, torch.from_numpy(
                    toks[:, pos:pos + 1]), pos, spec)
                res[f"decode/{pos}"] = _f32(logits)
        with mesh.bind():
            res["grad"] = _f32(_dist_grad(model, params, batch))
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_distmesh_at_tp2_equals_the_threadmesh():
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": SRC}
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, __file__, "dist", str(r), str(port),
                                   outs[r]], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True, env=env)
                 for r in range(2)]
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"gloo rank {r} failed:\n{logs[r]}"
        ranks = [dict(np.load(o)) for o in outs]
    cfg, whole, batch, toks = _dist_inputs()
    losses = port_losses(cfg, (1, 2), whole, batch)
    setup = _setup(cfg, (1, 2))
    grads = setup.mesh.run(lambda p: _f32(_dist_grad(setup.model, p, batch)),
                           _blocks(setup, whole))
    steps = port_decode(cfg, whole, toks, shape=(1, 2))
    for r in range(2):
        assert _bits(ranks[r]["loss"]) == _bits(losses[r])
        assert np.array_equal(ranks[r]["max"], np.array([1.0, 0.0], np.float32))
        assert np.array_equal(_bits(ranks[r]["grad"]), _bits(grads[r]))
        for pos in range(DECODE_STEPS):
            assert np.array_equal(_bits(ranks[r][f"decode/{pos}"]), _bits(steps[pos][r]))
    # every rank's loss is the whole loss, and the transpose of the psum
    # sums the ranks' cotangents: the TP gradient is tp times the tp = 1
    # one (the reference's train step scales the loss by 1 / tp for it),
    # each rank its rows of wo
    one = Model(cfg, params=whole, device="cpu")
    want = _f32(_dist_grad(one, whole, batch))
    got = np.concatenate([grads[0], grads[1]], axis=1) / 2  # wo (L, ff, d): ff over model
    assert _rel(got, want) <= TOL["float32"]


# ---------------------------------------------------------------------------
# Against the JAX child
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_the_references_shard_map(child, arch, shape):
    cfg = cfg_of(registry, arch)
    want = child.get()[f"loss/{arch}/{shape}"]
    got = port_losses(cfg, shape, child.weights(arch), batch_of(arch))
    assert _rel(got, want) <= TOL["float32"], (got, want)
    # the ranks that agree in the reference agree by bits here
    for i in range(len(want)):
        for j in range(len(want)):
            if want[i] == want[j]:
                assert _bits(got[i]) == _bits(got[j]), (i, j)


def test_parallel_block_loss_matches_the_reference(child):
    arch = ARCHS[0]
    cfg = dataclasses.replace(cfg_of(registry, arch), parallel_block=True)
    want = child.get()[f"loss_parallel_block/{arch}"]
    got = port_losses(cfg, (1, 4), child.weights(arch), batch_of(arch))
    assert _rel(got, want) <= TOL["float32"], (got, want)


@pytest.mark.parametrize("arch", [ARCHS[0], PHI])
def test_chunked_loss_matches_the_references_one_shot_loss(child, arch):
    # the sequence-chunked vocab loss is the same math (the reference's
    # chunked_vocab_xent): its max and partition sum over TP, chunk by chunk
    cfg = dataclasses.replace(cfg_of(registry, arch), loss_chunk=6)
    want = child.get()[f"loss/{arch}/(1, 4)"]
    got = port_losses(cfg, (1, 4), child.weights(arch), batch_of(arch))
    assert _rel(got, want) <= TOL["float32"], (got, want)


@pytest.mark.parametrize("arch", MOE)
def test_compressed_dispatch_loss_matches_the_reference(child, arch, monkeypatch):
    cfg = cfg_of(registry, arch, eb=GZ_EB)
    res = child.get()
    want = res[f"loss_gz/{arch}"]
    calls, lock = [], threading.Lock()
    real = GZCommunicator.all_to_all

    def counting(self, x, **kw):
        r = real(self, x, **kw)
        with lock:
            calls.append(bool(r.overflow))
        return r

    monkeypatch.setattr(GZCommunicator, "all_to_all", counting)
    got = port_losses(cfg, (1, 4), child.weights(arch), batch_of(arch))
    assert _rel(got, want) <= TOL["float32"], (got, want)
    # every layer's two dispatches on every rank went through the lossy hop,
    # none overflowed, and the loss stayed within what eb allows
    assert calls == [False] * (cfg.n_layers * 2 * 4)
    assert _rel(got, res[f"loss/{arch}/(1, 4)"]) <= 1e-3


@pytest.mark.parametrize("arch", MOE)
def test_compressed_dispatch_payload_is_the_references_by_bits(child, arch):
    cfg = cfg_of(registry, arch, eb=GZ_EB)
    res = child.get()
    w = convert.tree_map(lambda t: t[0], child.weights(arch)["blocks"]["moe"])
    ctx = parallel.ParallelCtx(tp_size=4)
    comm = blocks.dispatch_comm(cfg, ctx, "cpu")
    specs = blocks.moe_defs(cfg)
    wspecs = convert.tree_map(lambda d: d.spec, specs)
    h = torch.from_numpy(moe_h(cfg))

    class Recording:
        def __init__(self):
            self.rec = []

        def all_to_all(self, x):
            r = comm.all_to_all(x)
            assert not bool(r.overflow) and not bool(r.nonfinite)
            self.rec.append((x, r.value, r.wire_bytes))
            return r

    def body(r):
        recording = Recording()
        local = training._local(w, wspecs, {"data": 0, "model": r}, {"data": 1, "model": 4})
        out, aux = moe.moe_ffn(h, local, cfg, ctx, dispatch_comm=recording)
        return out, aux, recording.rec

    with torch.no_grad():
        outs = transport.ThreadGroup(4, "cpu").run(body, list(range(4)), axis_name="model")
    for r, (out, aux, rec) in enumerate(outs):
        (in0, out0, wire0), (in1, out1, wire1) = rec
        assert np.array_equal(_bits(_f32(in0)), _bits(res[f"ffn/{arch}/in0"][r])), r
        assert np.array_equal(_bits(_f32(out0)), _bits(res[f"ffn/{arch}/out0"][r])), r
        assert wire0 == wire1 == int(res[f"ffn/{arch}/wire"])
        assert _rel(_f32(in1), res[f"ffn/{arch}/in1"][r]) <= TOL["float32"]
        assert _rel(_f32(out1), res[f"ffn/{arch}/out1"][r]) <= TOL["float32"]
        assert _rel(_f32(out), res[f"ffn/{arch}/out"][r]) <= TOL["float32"]
        assert _rel(_f32(aux), res[f"ffn/{arch}/aux"][r]) <= TOL["float32"]
    # one lossy hop within its eb: what rank r received from rank q is
    # what q sent to r
    for r in range(4):
        for q in range(4):
            sent = _f32(outs[q][2][0][0])[r]
            got = _f32(outs[r][2][0][1])[q]
            # eb plus the f32 rounding of the reconstruction (ROADMAP C3)
            assert np.all(np.abs(got - sent) <= GZ_EB + np.spacing(np.abs(sent))), (r, q)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_the_references_shard_map(child, arch):
    cfg = cfg_of(registry, arch)
    steps = port_decode(cfg, child.weights(arch), decode_tokens(arch))
    for pos, got in enumerate(steps):
        want = child.get()[f"decode/{arch}/{pos}"]
        assert _rel(got, want) <= TOL["float32"], pos
        assert all(np.array_equal(_bits(got[r]), _bits(got[0])) for r in range(4))


def test_bf16_loss_matches_the_reference(child):
    arch = ARCHS[0]
    cfg = cfg_of(registry, arch)
    want = child.get()[f"loss16/{arch}"]
    got = port_losses(cfg, (1, 4), child.weights(arch, "bfloat16"), batch_of(arch))
    assert _rel(got, want) <= TOL["bfloat16"], (got, want)

if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_child(sys.argv[2])
    else:
        _dist_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
