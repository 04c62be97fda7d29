"""The port's training path against the JAX package's, on the CPU.

Inputs are made from a seed with numpy; weights and optimizer state cross
with ``convert``.  The multi-rank references run in JAX children started
when this module's first test runs (one per job, each with its device
count pinned, as in ``tests/test_torch_gradsync.py``), while the tests
that need no child run:

  * ``sync``, one child with 4 devices, for N in {2, 4}:
    ``training._sync_grads`` of per-rank trees with bf16 and f32 leaves
    over an ``(N, 1)`` ``("data", "model")`` mesh, ring, redoub, ring
    ``lorenzo+entropy`` and exact; ``_global_grad_norm`` of the result;
  * ``train``, 2 devices, one child per (config, dtype): three steps of
    ``make_train_step``, ``fsdp=False``, through the ring allreduce at eb
    1e-4 under the ``fallback`` policy: the minitron-8b and internlm2-20b
    smoke configs with f32 weights, and internlm2-20b with bf16 weights
    (the chip's configuration: bf16 leaves through the compressed sync
    inside the step).

Tolerances:

  * ``_sync_grads``: values and the degraded flag equal by bits (the
    allreduce is bitwise the reference's, bf16 leaves included);
  * ``_global_grad_norm``: rel 2e-6.  Each package sums the f32 squares
    of every leaf in its own order (XLA's CPU reduction tree, torch's
    cascade), each some ulps from the exact sum (the reference 8-10 ulps
    on a (2, 48, 40) leaf); measured up to 1.53e-6 apart, at N = 4;
  * ``adamw_update`` and ``cosine_schedule``: equal by bits against the
    reference run op by op (eager); with the same ``grad_norm`` given,
    the port's op order is the reference's (``cos`` and ``pow`` of the
    two agree on these inputs);
  * the train step, f32 weights: losses rel 1e-5.  The parameters after
    3 steps: per leaf, the L2 norm of the difference of the two packages'
    parameter updates (final minus initial) at most 1e-3 of the
    reference's update, and no element off by more than the sum of the
    three steps' learning rates.  Why: the step's gradients differ in
    their last bits (matmul and reduction orders, and the reference
    contracts multiply-adds under ``jit``), and AdamW's update
    ``lr * mhat / (sqrt(nhat) + eps)`` is a steep function of an
    element's gradient where that gradient nearly cancels, so a few
    elements per leaf may move by a different fraction of a step; an
    element moves by at most about ``lr`` per step, and the update as a
    whole is stable (measured: 1.7e-4 of the update, 5.2e-5 at most);
  * the train step, bf16 weights: losses rel 2e-3, as
    ``tests/test_torch_model.py`` (bf16 rounds at other places in the two
    frameworks).  The parameters after 3 steps by the same two measures,
    with the bounds bf16 forces: the L2 of the difference of the updates
    at most 0.25 of the reference's update, and no element off by more
    than twice the sum of the learning rates plus one bf16 ulp of the
    element.  Why: XLA keeps f32 between the bf16 ops it fuses under
    ``jit`` and the port rounds after each, so after the first step the
    gradient norms differ by about 1e-3 (measured 2.9e-5, 2.1e-3,
    3.2e-3); AdamW's first steps are nearly ``lr * sign(g)``, so an
    element whose gradient lies within that difference of zero may step
    the other way in one package (each moves an element by at most about
    ``lr`` a step, hence twice the sum), and each update lands on the
    bf16 grid, where two values a fraction of an ulp apart may round to
    neighbours (hence the ulp).  Measured: the L2 at 0.050-0.119 of the
    update per leaf, no element past 0.87 of its bound; the norm
    weights (1.0) do not move in either package (a step is below half
    an ulp).

Port-only: every rank's state equal by bits; the degraded-step skip
keeping the state by bits; remat ``"full"`` and ``"none"`` giving equal
gradients by bits; kernel 11's entry points raising under grad and
working under ``no_grad``; the checkpoint round trip and the
cross-package restore both ways; ``train_specs``, ``decode_plan`` and
``decode_specs`` against the reference's; the serve step; the CLI; the
A11.7 settings (``fsdp=True``'s sharded specs equal to the reference's,
one train step at tp 2 with the replicated leaves equal on both ranks,
the context-parallel cache's ``s_local``); the CLI on a host of two devices,
sharding the weights, its checkpoint the global trees that the reference
restores by bits.
"""
import contextlib
import dataclasses
import io
import os
import pathlib
import subprocess
import sys
import types

if __name__ == "__main__":  # a JAX child: pin its device count before JAX loads
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from _child_env import pin_device_count

    pin_device_count(int(sys.argv[1]))

import jax  # noqa: E402
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jcheckpoint
from repro.configs import registry as jregistry
from repro.launch import shapes as jshapes
from repro.models import model as jmodel
from repro.models import parallel as jparallel
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.checkpoint import checkpoint
from repro_torch.configs import registry
from repro_torch.core import faults
from repro_torch.core.collectives import GZConfig
from repro_torch.core.comm import GZCommunicator
from repro_torch.core.grad_sync import tree_flatten
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.kernels import flash_attn
from repro_torch.launch import shapes, training
from repro_torch.launch.mesh import ThreadMesh
from repro_torch.launch.train import train
from repro_torch.models import parallel
from repro_torch.models.attention import KVCacheSpec
from repro_torch.models.model import Model
from repro_torch.optim import adamw

HERE = pathlib.Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
AXES = ("data", "model")

# ---------------------------------------------------------------------------
# Shared inputs (the same in the children and here)
# ---------------------------------------------------------------------------

SYNC_NS = (2, 4)
SYNC_CASES = {
    "ring": dict(algo="ring"),
    "redoub": dict(algo="redoub"),
    "entropy": dict(algo="ring", codec="lorenzo+entropy"),
    "none": None,
}
# name -> (shape, spec, dtype): bf16 and f32 leaves, the "model" axis in
# some specs (those leaves skip it) and not in others (an exact sum over
# its one rank), one leaf past a 4,096-element tile
SYNC_TREE = {
    "embed": ((64, 48), ("model", None), "bfloat16"),
    "blocks": {"attn": {"wq": ((2, 48, 40), (None, None, "model"), "bfloat16")},
               "ln1": ((2, 48), (None, None), "float32")},
    "final_norm": ((48,), (None,), "float32"),
    "big": ((5000,), (None,), "float32"),
}
TRAIN_CASES = [("minitron-8b", "float32"), ("internlm2-20b", "float32"),
               ("internlm2-20b", "bfloat16")]
TRAIN_N, TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 2, 4, 32, 3, 1e-3
# Every step syncs through the ring.  eb 1e-4 is tight for the smoke
# model's gradients (up to 0.7) and its tiny norm leaves overflow the 0.6
# capacity, so "fallback" sums those leaves exactly (bitwise the
# reference's recovery).
TRAIN_GZ = dict(eb=1e-4, algo="ring", on_overflow="fallback")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def sync_grads(n: int, case: str):
    """{leaf: (n, *shape) f32} per-rank gradients: random walks of 1e-4
    steps, a different scale per leaf (cast to the leaf's dtype by each
    package: both round to nearest even)."""
    rng = np.random.default_rng(10 * n + sorted(SYNC_CASES).index(case))

    def leaf(entry):
        shape = entry[0]
        steps = rng.normal(0, 1e-4 * rng.uniform(0.5, 2.0), (n, int(np.prod(shape))))
        return np.cumsum(steps, axis=1).astype(np.float32).reshape((n,) + shape)

    return _map(leaf, SYNC_TREE)


def sync_specs():
    return _map(lambda e: e[1], SYNC_TREE)


def sync_dtypes():
    return _map(lambda e: e[2], SYNC_TREE)


def opt_config(cls):
    return cls(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)


def train_batches(cfg):
    stream = SyntheticStream(cfg, TRAIN_B, TRAIN_S, seed=0)
    return [next(stream) for _ in range(TRAIN_STEPS)]


# ---------------------------------------------------------------------------
# The JAX children
# ---------------------------------------------------------------------------


def _jax_sync_child(out_path: str) -> None:
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.core.collectives import GZConfig as JGZConfig
    from repro.core.comm import GZCommunicator as JGZCommunicator
    from repro.core.shmap import shard_map
    from repro.launch import training as jtraining

    specs = _map(lambda s: P(*s), sync_specs())
    dtypes = sync_dtypes()
    res = {}
    for n, (case, kw) in ((n, c) for n in SYNC_NS for c in SYNC_CASES.items()):
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(n, 1), AXES)
        sizes = {"data": n, "model": 1}
        comms = {} if kw is None else {"data": JGZCommunicator.for_config(
            "data", JGZConfig(eb=1e-4, **kw), axis_size=n)}
        tree = jax.tree.map(lambda a, dt: jnp.asarray(a, jnp.dtype(dt)),
                            sync_grads(n, case), dtypes)

        def body(g, comms=comms, sizes=sizes):
            g = jax.tree.map(lambda a: a[0], g)
            out, degraded = jtraining._sync_grads(g, specs, AXES, comms)
            norm = jtraining._global_grad_norm(out, specs, sizes)
            return jax.tree.map(lambda a: a[None], out), degraded[None], norm[None]

        rank = P(AXES)
        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(_map(lambda _: rank, tree),),
                              out_specs=(_map(lambda _: rank, tree), rank, rank)))
        out, degraded, norm = f(tree)
        for i, leaf in enumerate(jax.tree.leaves(out)):
            res[f"{n}/{case}/leaf{i}"] = np.asarray(leaf.astype(jnp.float32))
        res[f"{n}/{case}/degraded"] = np.asarray(degraded)
        res[f"{n}/{case}/norm"] = np.asarray(norm)
    np.savez(out_path, **res)


def _jax_train_child(arch: str, dtype: str, out_path: str) -> None:
    from jax.sharding import Mesh

    from repro.core.collectives import GZConfig as JGZConfig
    from repro.launch import training as jtraining

    cfg = jregistry.get(arch, smoke=True)
    mesh = Mesh(np.array(jax.devices()[:TRAIN_N]).reshape(TRAIN_N, 1), AXES)
    setup = jtraining.make_setup(cfg, mesh, opt=opt_config(jadamw.AdamWConfig),
                                 grad_gz=JGZConfig(**TRAIN_GZ), fsdp=False)
    _, bspecs = jshapes.train_specs(cfg, jshapes.InputShape("t", TRAIN_S, TRAIN_B, "train"),
                                    mesh)
    step = jtraining.make_train_step(setup, bspecs)
    params = jparallel.init_params(setup.defs, jax.random.key(0))
    params = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)), params)
    res = {f"p0/{i}": np.asarray(a.astype(jnp.float32))
           for i, a in enumerate(jax.tree.leaves(params))}
    opt = jadamw.adamw_init(params)
    for s, batch in enumerate(train_batches(cfg)):
        params, opt, m = step(params, opt, batch)
        for k, v in m.items():
            res[f"m{s}/{k}"] = np.asarray(v)
    for i, a in enumerate(jax.tree.leaves(params)):
        res[f"p/{i}"] = np.asarray(a.astype(jnp.float32))
    np.savez(out_path, **res)


class _Children:
    """The JAX children, started together; each result is read when a
    test first asks for it."""

    def __init__(self, tmp):
        env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
        env.pop("GZ_CHILD_DEVICES", None)
        # name -> (device count, mode and its arguments)
        jobs = {"sync": [str(max(SYNC_NS)), "sync"]}
        jobs.update({(a, d): [str(TRAIN_N), "train", a, d] for a, d in TRAIN_CASES})
        self._procs, self._results = {}, {}
        for name, args in jobs.items():
            out = tmp / f"{'_'.join(args[1:])}.npz"
            self._procs[name] = (out, subprocess.Popen(
                [sys.executable, __file__, *args, str(out)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, env=env))

    def get(self, name) -> dict:
        if name not in self._results:
            out, proc = self._procs[name]
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"JAX child {name} failed:\n{log}"
            with np.load(out) as z:
                self._results[name] = {k: z[k] for k in z.files}
        return self._results[name]

    def close(self):
        for _, proc in self._procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def children(tmp_path_factory):
    kids = _Children(tmp_path_factory.mktemp("jax_train"))
    try:
        yield kids
    finally:
        kids.close()


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _bits(t) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.reshape(-1).view(torch.uint8).numpy()


def _same_bits(a, b) -> bool:
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and np.array_equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _clone(tree):
    return convert.tree_map(torch.clone, tree)


def _smoke_setup(n=2, dtype=torch.float32, **kw):
    """A smoke-size setup on a CPU mesh of n data ranks, f32 weights by
    default, with per-rank replicas of the same weights and fresh state."""
    cfg = registry.get("internlm2-20b", smoke=True)
    mesh = ThreadMesh((n, 1), AXES, "cpu")
    kw = {"opt": opt_config(adamw.AdamWConfig), "fsdp": False, **kw}
    setup = training.make_setup(cfg, mesh, **kw)
    _, bspecs = shapes.train_specs(
        cfg, shapes.InputShape("t", TRAIN_S, TRAIN_B, "train"), mesh)
    params = parallel.init_params(setup.defs, torch.Generator().manual_seed(0), "cpu")
    params = convert.tree_map(lambda p: p.to(dtype), params)
    replicas = [_clone(params) for _ in range(n)]
    return setup, training.make_train_step(setup, bspecs), replicas, \
        [adamw.adamw_init(p) for p in replicas], train_batches(cfg)


# ---------------------------------------------------------------------------
# Port-only tests (they run while the children work)
# ---------------------------------------------------------------------------


def _flash_inputs(grad):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 40, 2, 32)).astype(np.float32))
               .requires_grad_(grad) for _ in range(3))
    return q, k, v


@pytest.mark.parametrize("entry", ["flash_attention", "flash_attention_bhsd",
                                   "flash_attention_kernel"])
def test_flash_kernel_raises_under_grad(entry):
    fn = getattr(flash_attn, entry)
    q, k, v = _flash_inputs(True)
    if entry == "flash_attention_bhsd":
        q, k, v = q.detach()[:, :, 0].requires_grad_(True), k[:, :, 0], v[:, :, 0]
    with pytest.raises(RuntimeError, match=r"use_flash_kernel=False.*ROADMAP A11"):
        fn(q, k, v)


@pytest.mark.parametrize("entry", ["flash_attention", "flash_attention_bhsd"])
@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no_requires_grad"])
def test_flash_kernel_unchanged_without_grad(entry, mode):
    q, k, v = _flash_inputs(mode != "no_requires_grad")
    if entry == "flash_attention_bhsd":
        q, k, v = (x.detach()[:, :, 0].requires_grad_(x.requires_grad) for x in (q, k, v))
        plain = flash_attn.flash_attention_bhsd_plain
    else:
        plain = flash_attn.flash_attention_plain
    want = plain(q.detach(), k.detach(), v.detach(), causal=True, window=16)
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "no_requires_grad": contextlib.nullcontext}[mode]
    with ctx():
        got = getattr(flash_attn, entry)(q, k, v, causal=True, window=16)
    assert np.array_equal(_bits(got), _bits(want))


def test_loss_through_kernel_11_raises_under_grad_and_chunked_trains():
    setup, step, params, opt, batches = _smoke_setup(n=1)
    cfg = setup.cfg
    kmodel = Model(dataclasses.replace(cfg, use_flash_kernel=True), setup.ctx,
                   params={}, device="cpu")
    req = convert.tree_map(lambda p: p.detach().requires_grad_(True), params[0])
    with pytest.raises(RuntimeError, match="use_flash_kernel=False"):
        kmodel.loss_fn(req, batches[0])
    with torch.no_grad():
        assert np.isfinite(float(kmodel.loss_fn(params[0], batches[0])))
    _, _, m = step(params, opt, batches[0])
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_is_bit_neutral(dtype):
    cfg = registry.get("minitron-8b", smoke=True)
    batch = train_batches(cfg)[0]
    grads = {}
    params = None
    for remat in ("none", "full", "dots"):
        model = Model(cfg, parallel.ParallelCtx(remat=remat), device="cpu", seed=3)
        if params is None:
            params = convert.tree_map(lambda p: p.detach().to(dtype), model.params())
        leaves, rebuild = tree_flatten(params)
        req = [p.detach().requires_grad_(True) for p in leaves]
        loss = model.loss_fn(rebuild(req), batch)
        grads[remat] = torch.autograd.grad(loss, req)
    for remat in ("full", "dots"):
        assert all(np.array_equal(_bits(a), _bits(b))
                   for a, b in zip(grads["none"], grads[remat])), remat


def test_remat_checkpoints_each_layer_only_under_grad(monkeypatch):
    from repro_torch.models import model as model_mod

    calls = []
    real = model_mod.checkpoint.checkpoint

    def counting(*a, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(*a, **kw)

    monkeypatch.setattr(model_mod.checkpoint, "checkpoint", counting)
    cfg = registry.get("minitron-8b", smoke=True)
    batch = train_batches(cfg)[0]
    for remat in ("full", "none"):
        model = Model(cfg, parallel.ParallelCtx(remat=remat), device="cpu", seed=3)
        leaves, rebuild = tree_flatten(model.params())
        req = [p.detach().requires_grad_(True) for p in leaves]
        torch.autograd.grad(model.loss_fn(rebuild(req), batch), req)
        with torch.no_grad():
            model.loss_fn(model.params(), batch)
    assert calls == [False] * cfg.n_layers


def test_every_rank_state_equal_by_bits_and_steps_train():
    setup, step, params, opt, batches = _smoke_setup(
        n=4, grad_gz=GZConfig(eb=1e-4, algo="ring"))
    losses = []
    for batch in batches:
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        for r in range(1, 4):
            assert _same_bits(params[0], params[r]) and _same_bits(opt[0], opt[r]), r
        assert not bool(m["skipped"]) and float(m["overlap_modeled"]) == 0.0
    assert int(opt[0]["step"]) == TRAIN_STEPS
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_skip_on_overflow_keeps_state_by_bits():
    # eb 1e-2: no bucket of these gradients overflows unless forced to
    setup, step, params, opt, batches = _smoke_setup(
        grad_gz=GZConfig(eb=1e-2, algo="ring", on_overflow="flag"), skip_on_overflow=True,
        dtype=torch.bfloat16)
    before_p, before_o = _clone(params), _clone(opt)
    with faults.inject(faults.FaultSpec("overflow", ranks=(1,))):
        params, opt, m = step(params, opt, batches[0])
    assert bool(m["skipped"])
    for r in range(2):
        assert _same_bits(params[r], before_p[r]) and _same_bits(opt[r], before_o[r])
    params, opt, m = step(params, opt, batches[1])
    assert not bool(m["skipped"]) and int(opt[0]["step"]) == 1
    assert not _same_bits(params[0], before_p[0])
    assert _same_bits(params[0], params[1]) and _same_bits(opt[0], opt[1])


def test_skip_merge_and_degraded_flags():
    new = {"a": torch.ones(3), "b": [torch.zeros((), dtype=torch.int32)]}
    old = {"a": torch.zeros(3), "b": [torch.ones((), dtype=torch.int32)]}
    assert _same_bits(training._skip_merge(torch.tensor(True), new, old), old)
    assert _same_bits(training._skip_merge(torch.tensor(False), new, old), new)
    # a non-finite leaf raises the flag even where no collective runs
    tree = {"w": torch.tensor([1.0, float("nan")]), "v": torch.ones(2)}
    mesh = ThreadMesh((1, 1), AXES, "cpu")
    _, flag = mesh.run(lambda t: training._sync_grads(
        t, {"w": (None,), "v": ("data",)}, AXES, {}), [tree])[0]
    assert bool(flag)


def test_checkpoint_round_trip_and_latest_step(tmp_path):
    setup, step, params, opt, batches = _smoke_setup(n=1, dtype=torch.bfloat16)
    params, opt, _ = step(params, opt, batches[0])
    tree = {"params": params[0], "opt": opt[0]}
    assert checkpoint.latest_step(str(tmp_path)) is None
    d = checkpoint.save(str(tmp_path), 7, tree)
    checkpoint.save(str(tmp_path), 12, tree)
    assert checkpoint.latest_step(str(tmp_path)) == 12
    assert sorted(os.listdir(d))[:3] == ["manifest.json", "opt_mu_blocks_attn_wk.npy",
                                         "opt_mu_blocks_attn_wo.npy"]
    back = checkpoint.restore(str(tmp_path), 7, tree, device="cpu")
    assert _same_bits(back, tree)
    bad = {"params": {**params[0], "embed": params[0]["embed"][:-1]}, "opt": opt[0]}
    with pytest.raises(ValueError, match="params_embed"):
        checkpoint.restore(str(tmp_path), 7, bad, device="cpu")


def _mixed_tree(rng):
    import ml_dtypes

    return {"params": {"blocks": {"attn": {"wq": rng.normal(size=(2, 3, 4)).astype(
                ml_dtypes.bfloat16)}}, "embed": rng.normal(size=(5, 2)).astype(np.float32)},
            "opt": {"step": np.int32(3), "mu": [rng.normal(size=3).astype(np.float32),
                                                (rng.normal(size=2).astype(np.float32),)]},
            "odd key!": np.arange(4, dtype=np.int32)}


def test_checkpoint_restores_across_packages_by_bits(tmp_path):
    tree = _mixed_tree(np.random.default_rng(1))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jcheckpoint.save(jdir, 3, jax.tree.map(jnp.asarray, tree))
    like = convert.params_from_jax(tree, "cpu")
    ours = checkpoint.restore(jdir, 3, like, device="cpu")
    assert _same_bits(ours, like)
    checkpoint.save(tdir, 3, like)
    assert sorted(os.listdir(os.path.join(jdir, "step_00000003"))) == \
        sorted(os.listdir(os.path.join(tdir, "step_00000003")))
    with open(os.path.join(jdir, "step_00000003", "manifest.json")) as f, \
            open(os.path.join(tdir, "step_00000003", "manifest.json")) as g:
        assert f.read() == g.read()
    theirs = jcheckpoint.restore(tdir, 3, tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(theirs)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _fake_mesh(shape):
    return types.SimpleNamespace(axis_names=AXES, shape=shape,
                                 devices=np.empty(shape, dtype=object))


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 1), (16, 16), (4, 2)])
@pytest.mark.parametrize("arch", ["minitron-8b", "internlm2-20b", "seamless-m4t-medium",
                                  "internvl2-26b", "phi3.5-moe-42b-a6.6b",
                                  "llama4-scout-17b-a16e"])
def test_train_specs_match_the_reference(arch, mesh_shape):
    for smoke in (True, False):
        mesh = _fake_mesh(mesh_shape)
        for shape in shapes.INPUT_SHAPES.values():
            tree, specs = shapes.train_specs(registry.get(arch, smoke=smoke), shape, mesh)
            jtree, jspecs = jshapes.train_specs(jregistry.get(arch, smoke=smoke),
                                                jshapes.INPUT_SHAPES[shape.name], mesh)
            assert _map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), tree) == \
                jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jtree)
            assert specs == jax.tree.map(tuple, jspecs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))
            assert all(a.device.type == "meta" for a in tree_flatten(tree)[0])
    assert shapes.INPUT_SHAPES == {k: shapes.InputShape(**vars(v))
                                   for k, v in jshapes.INPUT_SHAPES.items()}
    assert shapes.LONG_WINDOW == jshapes.LONG_WINDOW


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 1), (16, 1), (256, 1)])
@pytest.mark.parametrize("arch", ["minitron-8b", "internlm2-20b", "deepseek-67b", "mamba2-780m",
                                  "zamba2-2.7b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b",
                                  "llama4-scout-17b-a16e", "seamless-m4t-medium",
                                  "internvl2-26b"])
def test_decode_plan_and_specs_match_the_reference(arch, mesh_shape):
    mesh = _fake_mesh(mesh_shape)
    cfg, jcfg = registry.get(arch), jregistry.get(arch)
    model = Model(cfg, parallel.ParallelCtx(), params={}, device="cpu")
    jm = jmodel.Model(jcfg, jparallel.ParallelCtx())
    for shape in shapes.INPUT_SHAPES.values():
        if shape.kind != "decode":
            continue
        # the batch-sharded plans and, where the batch cannot fill the data
        # axes, the context split (jplan.cp_size > 1) alike
        jplan = jshapes.decode_plan(jcfg, jshapes.INPUT_SHAPES[shape.name], mesh)
        plan = shapes.decode_plan(cfg, shape, mesh)
        assert (plan.s_total, plan.cp_axis, plan.cp_size, plan.window) == \
            (jplan.s_total, jplan.cp_axis, jplan.cp_size, jplan.window)
        cache, cspecs, tokens, tspec, _ = shapes.decode_specs(cfg, shape, mesh, model)
        jcache, jcspecs, jtokens, jtspec, _ = jshapes.decode_specs(
            jcfg, jshapes.INPUT_SHAPES[shape.name], mesh, jm)
        assert {k: tuple(v.shape) for k, v in cache.items()} == \
            {k: tuple(v.shape) for k, v in jcache.items()}
        assert cspecs == {k: tuple(v) for k, v in jcspecs.items()}
        assert tuple(tokens.shape) == tuple(jtokens.shape) and tspec == tuple(jtspec)


def test_serve_step_matches_decode_fn():
    cfg = registry.get("minitron-8b", smoke=True)
    mesh = ThreadMesh((2, 1), AXES, "cpu")
    setup = training.make_setup(cfg, mesh, fsdp=False)
    shape = shapes.InputShape("d", 16, 4, "decode")
    cache, cspecs, tokens, tspec, plan = shapes.decode_specs(cfg, shape, mesh, setup.model)
    model = Model(cfg, setup.ctx, device="cpu", seed=5)
    params = model.params()
    step = training.make_serve_step(setup, cspecs, tspec, plan)
    caches = [{k: torch.zeros(v.shape) for k, v in cache.items()} for _ in range(2)]
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, 3)))
    with torch.no_grad():
        for pos in range(3):
            got, caches[0] = step([params, params], caches[0], toks[:, pos:pos + 1], pos)
            want, caches[1] = model.decode_fn(params, caches[1], toks[:, pos:pos + 1], pos,
                                              plan)
            assert tuple(got.shape) == tuple(want.shape)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(caches[0]["k"].numpy(), caches[1]["k"].numpy(), atol=1e-6)


def test_a11_settings_raise_with_their_names():
    cfg = registry.get("minitron-8b", smoke=True)
    # fsdp=True with data 2 (A11.6, ported) builds sharded specs equal to
    # the reference's
    from repro.launch import training as jtraining

    setup = training.make_setup(cfg, ThreadMesh((2, 1), AXES, "cpu"))
    jsetup = jtraining.make_setup(jregistry.get("minitron-8b", smoke=True), _fake_mesh((2, 1)))
    assert setup.ctx.fsdp_size == jsetup.ctx.fsdp_size == 2
    assert setup.specs == jax.tree.map(tuple, jsetup.specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    assert setup.specs["blocks"]["mlp"]["wo"] == (None, "model", "data")
    # model 2 (A11.7) builds the tensor-parallel context, and its train
    # step (A11.7b) runs on the CPU mesh: one step, the same bits on both
    # ranks where the spec replicates a leaf over model
    mesh = ThreadMesh((1, 2), AXES, "cpu")
    setup = training.make_setup(cfg, mesh, fsdp=False)
    assert setup.ctx.tp_size == 2
    _, bspecs = shapes.train_specs(cfg, shapes.InputShape("t", 16, 2, "train"), mesh)
    step = training.make_train_step(setup, bspecs)
    whole = parallel.init_params(setup.defs, torch.Generator().manual_seed(0), "cpu")
    sizes = {"data": 1, "model": 2}
    params = [convert.tree_map(torch.clone, training._local(whole, setup.specs, c, sizes))
              for c in training._coords(mesh)]
    opt = [adamw.adamw_init(p) for p in params]
    params, opt, m = step(params, opt, next(SyntheticStream(cfg, 2, 16, seed=0)))
    assert np.isfinite(float(m["loss"])) and not bool(m["skipped"])
    assert _same_bits(params[0]["final_norm"], params[1]["final_norm"])
    assert _same_bits(opt[0]["mu"]["final_norm"], opt[1]["mu"]["final_norm"])
    # the context-parallel cache (A11.7b) splits its context over cp
    assert KVCacheSpec(s_total=64, cp_axis="data", cp_size=2).s_local == 32
    setup = training.make_setup(cfg, ThreadMesh((1, 1), AXES, "cpu"))  # one rank: fine
    assert setup.ctx.fsdp_size == 1


def test_train_cli_on_the_cpu(tmp_path):
    out = io.StringIO()
    argv = ["--smoke", "--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "32",
            "--lr", "1e-3", "--log-every", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--grad-gz", "ring"]
    with contextlib.redirect_stdout(out):
        losses = train(argv)
    lines = out.getvalue().splitlines()
    assert lines[0] == ("arch=minitron-smoke params=0.4M mesh={'data': 1, 'model': 1} "
                        "grad_gz=ring")
    assert [ln.split()[1] for ln in lines if ln.startswith("step")] == ["0", "2", "3"]
    assert lines[-1] == f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})"
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert checkpoint.latest_step(str(tmp_path)) == 4
    cfg = registry.get("minitron-8b", smoke=True)
    setup = training.make_setup(cfg, ThreadMesh((1, 1), AXES, "cpu"))
    like = {"params": parallel.init_params(setup.defs, torch.Generator(), "cpu")}
    like["opt"] = adamw.adamw_init(like["params"])
    back = checkpoint.restore(str(tmp_path), 4, like, device="cpu")
    assert int(back["opt"]["step"]) == 4


def test_train_cli_replicates_over_data_on_two_devices(monkeypatch, tmp_path):
    # the mesh rule gives data 2 on a host of two devices; the CLI shards the
    # weights over it (FSDP), as the reference's does, and its checkpoint
    # holds the global trees, which the reference restores by bits
    import importlib

    monkeypatch.setattr(importlib.import_module("repro_torch.launch.train"), "_device_count",
                        lambda device: 2)
    out = io.StringIO()
    shards = {}
    real = training.make_train_step

    def keeping(setup, bspecs):
        step = real(setup, bspecs)

        def run(params, opt, batch):
            params, opt, m = step(params, opt, batch)
            shards.update(setup=setup, params=params, opt=opt)
            return params, opt, m

        return run

    monkeypatch.setattr(importlib.import_module("repro_torch.launch.train"),
                        "make_train_step", keeping)
    with contextlib.redirect_stdout(out):
        losses = train(["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
                        "--seq", "32", "--grad-gz", "ring", "--ckpt-dir", str(tmp_path),
                        "--ckpt-every", "2"])
    assert out.getvalue().splitlines()[0] == (
        "arch=minitron-smoke params=0.4M mesh={'data': 2, 'model': 1} grad_gz=ring")
    assert len(losses) == 2 and np.isfinite(losses).all()
    setup = shards["setup"]
    assert setup.ctx.fsdp_size == 2
    # each rank holds its own block: half of each sharded leaf
    embed = [p["embed"] for p in shards["params"]]
    assert tuple(embed[0].shape) == (setup.defs["embed"].shape[0],
                                     setup.defs["embed"].shape[1] // 2)
    coords, sizes = [{"data": r, "model": 0} for r in range(2)], {"data": 2, "model": 1}
    whole = {"params": training._global(shards["params"], setup.specs, coords, sizes),
             "opt": training._global(shards["opt"], {"mu": setup.specs, "nu": setup.specs,
                                                     "step": ()}, coords, sizes)}
    like = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                        convert.params_to_numpy(whole))
    theirs = jcheckpoint.restore(str(tmp_path), 2, like)
    ours = convert.params_to_numpy(whole)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    back = checkpoint.restore(str(tmp_path), 2, whole, device="cpu")
    assert _same_bits(back, whole)


def test_cosine_schedule_bitwise():
    for cfg in (dict(lr=1e-3, warmup_steps=3, total_steps=20), {}):
        for step in list(range(0, 40)) + [99, 100, 101, 5000, 10_000, 20_000]:
            want = np.asarray(jadamw.cosine_schedule(jadamw.AdamWConfig(**cfg),
                                                     jnp.int32(step)))
            got = adamw.cosine_schedule(adamw.AdamWConfig(**cfg),
                                        torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert np.array_equal(np.float32(want).view(np.int32), got.numpy().view(np.int32))


def test_adamw_update_bitwise():
    import ml_dtypes

    rng = np.random.default_rng(0)
    kw = dict(lr=1e-3, warmup_steps=3, total_steps=20, grad_clip=0.5)

    def draw(scale):
        return {"a": rng.normal(0, scale, (50, 30)).astype(np.float32),
                "b": [rng.normal(0, scale, (77,)).astype(ml_dtypes.bfloat16)]}

    p = draw(1.0)
    jp, tp = jax.tree.map(jnp.asarray, p), convert.params_from_jax(p, "cpu")
    js, ts = jadamw.adamw_init(jp), adamw.adamw_init(tp)
    for _ in range(12):
        g = draw(0.3)
        gn = np.float32(np.sqrt(sum((np.asarray(x, np.float64) ** 2).sum()
                                    for x in jax.tree.leaves(g))))
        jp, js, jm = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, g), js,
                                         jadamw.AdamWConfig(**kw), grad_norm=jnp.float32(gn))
        tp, ts, tm = adamw.adamw_update(tp, convert.params_from_jax(g, "cpu"), ts,
                                        adamw.AdamWConfig(**kw), grad_norm=torch.tensor(gn))
        assert _same_bits(tp, convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
        assert _same_bits(ts, convert.opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu"))
        assert np.float32(jm["lr"]).tobytes() == tm["lr"].numpy().tobytes()
    # without grad_norm, the norm is the f32 sum of squares (another order)
    g = draw(0.3)
    want = np.asarray(jadamw._global_norm(jax.tree.map(jnp.asarray, g)))
    got = adamw._global_norm(convert.params_from_jax(g, "cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_adamw_init_and_opt_state_from_jax():
    p = {"w": np.ones((3, 2), np.float32), "b": [np.zeros(4, np.float32)]}
    st = adamw.adamw_init(convert.params_from_jax(p, "cpu"))
    js = jadamw.adamw_init(jax.tree.map(jnp.asarray, p))
    assert _same_bits(st, convert.opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu"))
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()
    with pytest.raises(ValueError, match="0-d int32"):
        convert.opt_state_from_jax({"mu": {}, "nu": {}, "step": np.zeros(2, np.int32)},
                                   "cpu")


# ---------------------------------------------------------------------------
# Against the children
# ---------------------------------------------------------------------------


def _port_sync(n, case):
    kw = SYNC_CASES[case]
    comms = {} if kw is None else {"data": GZCommunicator.for_config(
        "data", GZConfig(eb=1e-4, **kw), axis_size=n, device="cpu")}
    grads = sync_grads(n, case)
    dtypes = sync_dtypes()
    specs = sync_specs()

    def rank_tree(r):
        return _pairs(grads, dtypes, lambda a, dt: torch.from_numpy(a[r].copy()).to(
            parallel.torch_dtype(dt)))

    def body(tree):
        out, degraded = training._sync_grads(tree, specs, AXES, comms)
        return out, degraded, training._global_grad_norm(out, specs, {"data": n, "model": 1})

    return ThreadMesh((n, 1), AXES, "cpu").run(body, [rank_tree(r) for r in range(n)])


def _pairs(a, b, fn):
    if isinstance(a, dict):
        return {k: _pairs(a[k], b[k], fn) for k in a}
    return fn(a, b)


@pytest.mark.parametrize("case", list(SYNC_CASES))
@pytest.mark.parametrize("n", SYNC_NS)
def test_sync_grads_bitwise_equals_reference(children, n, case):
    ref = children.get("sync")
    res = _port_sync(n, case)
    dtypes = tree_flatten(sync_dtypes())[0]
    for i, dtype in enumerate(dtypes):
        want = ref[f"{n}/{case}/leaf{i}"]
        for r, (out, _, _) in enumerate(res):
            leaf = tree_flatten(out)[0][i]
            assert leaf.dtype == parallel.torch_dtype(dtype)
            got = leaf.to(torch.float32).numpy()
            assert np.array_equal(got.view(np.int32), want[r].view(np.int32)), \
                f"N={n} {case} leaf {i} rank {r}"
    for r, (_, degraded, _) in enumerate(res):
        assert bool(degraded) == bool(ref[f"{n}/{case}/degraded"][r])


@pytest.mark.parametrize("case", list(SYNC_CASES))
@pytest.mark.parametrize("n", SYNC_NS)
def test_global_grad_norm_matches_reference(children, n, case):
    ref = children.get("sync")
    norms = [float(norm) for _, _, norm in _port_sync(n, case)]
    assert len(set(norms)) == 1  # every rank the same bits
    np.testing.assert_allclose(norms[0], ref[f"{n}/{case}/norm"][0], rtol=2e-6)


@pytest.mark.parametrize("arch,dtype", TRAIN_CASES)
def test_train_step_matches_reference(children, arch, dtype):
    ref = children.get((arch, dtype))
    cfg = registry.get(arch, smoke=True)
    mesh = ThreadMesh((TRAIN_N, 1), AXES, "cpu")
    setup = training.make_setup(cfg, mesh, opt=opt_config(adamw.AdamWConfig),
                                grad_gz=GZConfig(**TRAIN_GZ), fsdp=False)
    _, bspecs = shapes.train_specs(cfg, shapes.InputShape("t", TRAIN_S, TRAIN_B, "train"),
                                   mesh)
    step = training.make_train_step(setup, bspecs)
    p0 = [ref[f"p0/{i}"] for i in range(len(tree_flatten(setup.defs)[0]))]
    _, rebuild = tree_flatten(setup.defs)
    td = parallel.torch_dtype(dtype)
    params = [rebuild([torch.from_numpy(a.copy()).to(td) for a in p0])
              for _ in range(TRAIN_N)]
    opt = [adamw.adamw_init(p) for p in params]
    rel = {"float32": 1e-5, "bfloat16": 2e-3}[dtype]
    for s, batch in enumerate(train_batches(cfg)):
        params, opt, m = step(params, opt, batch)
        for r in range(1, TRAIN_N):
            assert _same_bits(params[0], params[r]) and _same_bits(opt[0], opt[r])
        np.testing.assert_allclose(float(m["loss"]), ref[f"m{s}/loss"], rtol=rel)
        if dtype == "float32":
            np.testing.assert_allclose(float(m["gnorm"]), ref[f"m{s}/gnorm"], rtol=rel)
        assert m["lr"].numpy().tobytes() == np.asarray(ref[f"m{s}/lr"], np.float32).tobytes()
        assert not bool(m["skipped"]) and not bool(ref[f"m{s}/skipped"])
    step_lrs = sum(float(ref[f"m{s}/lr"]) for s in range(TRAIN_STEPS))
    l2 = {"float32": 1e-3, "bfloat16": 0.25}[dtype]
    for i, leaf in enumerate(tree_flatten(params[0])[0]):
        init = p0[i].astype(np.float64)
        final = ref[f"p/{i}"]
        ours = leaf.float().numpy().astype(np.float64) - init
        theirs = final.astype(np.float64) - init
        slack = step_lrs
        if dtype == "bfloat16":  # one bf16 ulp of the element (f32 spacing x 2^16)
            slack = 2 * slack + np.spacing(np.abs(final)).astype(np.float64) * 2.0 ** 16
        assert np.all(np.abs(ours - theirs) <= slack), i
        assert np.linalg.norm(ours - theirs) <= l2 * np.linalg.norm(theirs), i


if __name__ == "__main__":
    if sys.argv[2] == "sync":
        _jax_sync_child(sys.argv[3])
    else:
        _jax_train_child(sys.argv[3], sys.argv[4], sys.argv[5])
