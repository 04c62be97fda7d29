"""The FSDP gather and its reduce-scatter backward (ROADMAP A11.6) against
the JAX package's, on the CPU.

Inputs are made from a seed with numpy; each package casts them to the
leaf's dtype (both round to nearest even).  One JAX child with 4 devices,
started when this module's first test runs, computes every reference
value while the port-only tests run:

  * for N in {2, 4}, exact (``sync=None``) and compressed (ring, eb 1e-5),
    f32 and bf16, a (16, 24) weight sharded along dim 0 and along dim 1:
    ``ParallelCtx.gather`` on every rank, ``fsdp_reduce_scatter_stats`` of
    per-rank cotangents (values and stats), and the shard gradient of
    ``sum((gather(w) - t) ** 2)`` (``tests/_mp_gradsync_child.py``'s loss);
  * the same gradient under a forced overflow with ``mark_degraded`` and
    ``_sync_grads``' probe of it;
  * three steps of the jitted ``make_train_step`` with ``fsdp=True`` on a
    (2, 1) mesh, the minitron-8b smoke config in f32, ``fsdp_gz`` None
    and ring at eb 1e-4, the gradient sync as in ``tests/test_torch_train.py``.

Tolerances:

  * the gather, the reduce-scatter (values, flags, wire bytes, buckets)
    and the gradient: equal by bits.  XLA's CPU reduce-scatter of a bf16
    cotangent sums in f32, in rank order, and rounds once (pinned here at
    N = 4, where rounding after each add differs), and so does the port;
  * the train step: ``tests/test_torch_train.py``'s f32 bounds (ROADMAP
    C15): losses and gradient norms rel 1e-5; per leaf, the L2 of the
    difference of the two packages' updates at most 1e-3 of the
    reference's update and no element off by more than the sum of the
    three steps' learning rates.

Port-only: the train step's route (``FsdpStep``: gathers kept for remat,
reduce-scatters after backward) against ``fsdp_all_gather``'s in-backward
route by bits, one step's shard gradients and three steps' parameters,
for minitron-8b and zamba2 (its shared block applied 2 and 3 times) in
f32 and bf16, remat "full" and "none"; every family's gathers along its
specs' dims; a gloo ``DistGroup`` at N = 2 (two processes, no JAX) equal
to the ``ThreadGroup`` run by bits; the backward on a foreign thread
raising; a recompute that finds no gathered weight raising, and one on
another thread than the rank's taking the forward's gathers; ``_global``
undoing ``_local``.
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

    pin_device_count(4)

import dataclasses  # noqa: E402

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import grad_sync, transport
from repro_torch.core.collectives import GZConfig
from repro_torch.core.grad_sync import FsdpStep, SyncConfig, tree_flatten
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.launch import shapes, training
from repro_torch.launch.mesh import ThreadMesh
from repro_torch.models import parallel
from repro_torch.optim import adamw

HERE = pathlib.Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
AXES = ("data", "model")

# ---------------------------------------------------------------------------
# Shared inputs (the same in the children and here)
# ---------------------------------------------------------------------------

NS = (2, 4)
SHAPE = (16, 24)  # the global weight
SYNCS = {"exact": None, "gz": dict(eb=1e-5, algo="ring")}
DTYPES = ("float32", "bfloat16")
DIMS = (0, 1)
CASES = [(n, s, dt, d) for n in NS for s in SYNCS for dt in DTYPES for d in DIMS]
MARK = dict(eb=1e-9, capacity_factor=0.02, on_overflow="flag")  # overflows on purpose
# tests/test_torch_train.py's train case, with the weights sharded
TRAIN_N, TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 2, 4, 32, 3, 1e-3
TRAIN_GZ = dict(eb=1e-4, algo="ring", on_overflow="fallback")
TRAIN_FSDP = {"exact": None, "gz": dict(eb=1e-4, algo="ring")}


def case_inputs(n, sync, dtype, dim):
    """(w, t, cts): the global weight and target (f32, ``SHAPE``) and the
    per-rank cotangents (n, *moved) of the gathered weight with its
    sharded dim moved to the front."""
    rng = np.random.default_rng(CASES.index((n, sync, dtype, dim)))
    w = rng.normal(0, 0.02, SHAPE).astype(np.float32)
    t = rng.normal(0, 0.02, SHAPE).astype(np.float32)
    moved = (SHAPE[dim],) + tuple(s for i, s in enumerate(SHAPE) if i != dim)
    cts = rng.normal(0, 0.05, (n,) + moved).astype(np.float32)
    return w, t, cts


def spec_of(dim):
    return ("data", None) if dim == 0 else (None, "data")


def opt_config(cls):
    return cls(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)


def train_batches(cfg):
    stream = SyntheticStream(cfg, TRAIN_B, TRAIN_S, seed=0)
    return [next(stream) for _ in range(TRAIN_STEPS)]


# ---------------------------------------------------------------------------
# The JAX child
# ---------------------------------------------------------------------------


def _jax_child(job: str, out_path: str) -> None:
    """``job`` "cases": the gather, reduce-scatter and gradient cases and
    the forced overflow; a ``TRAIN_FSDP`` name: that train step."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.configs import registry as jregistry
    from repro.core import grad_sync as jgs
    from repro.core.collectives import GZConfig as JGZConfig
    from repro.core.shmap import shard_map
    from repro.launch import shapes as jshapes
    from repro.launch import training as jtraining
    from repro.models import parallel as jparallel
    from repro.optim import adamw as jadamw

    res = {}

    def sync_of(kw, **extra):
        return None if kw is None else jgs.SyncConfig(gz=JGZConfig(**kw), relative_eb=False,
                                                      **extra)

    if job in TRAIN_FSDP:
        cfg = jregistry.get("minitron-8b", smoke=True)
        mesh = Mesh(np.array(jax.devices()[:TRAIN_N]).reshape(TRAIN_N, 1), AXES)
        _, bspecs = jshapes.train_specs(
            cfg, jshapes.InputShape("t", TRAIN_S, TRAIN_B, "train"), mesh)
        kw = TRAIN_FSDP[job]
        setup = jtraining.make_setup(cfg, mesh, opt=opt_config(jadamw.AdamWConfig),
                                     grad_gz=JGZConfig(**TRAIN_GZ),
                                     fsdp_gz=None if kw is None else JGZConfig(**kw))
        step = jtraining.make_train_step(setup, bspecs)
        params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              jparallel.init_params(setup.defs, jax.random.key(0)))
        res.update({f"p0/{i}": np.asarray(a) for i, a in enumerate(jax.tree.leaves(params))})
        opt = jadamw.adamw_init(params)
        for s, batch in enumerate(train_batches(cfg)):
            params, opt, m = step(params, opt, batch)
            for k, v in m.items():
                res[f"m{s}/{k}"] = np.asarray(v)
        for i, a in enumerate(jax.tree.leaves(params)):
            res[f"p/{i}"] = np.asarray(a)
        np.savez(out_path, **res)
        return

    for n, sname, dtype, dim in CASES:
        mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
        sync = sync_of(SYNCS[sname])
        w, t, cts = (jnp.asarray(a).astype(jnp.dtype(dtype)) for a in case_inputs(
            n, sname, dtype, dim))
        static = {}

        def body(w_local, t, ct, sync=sync, dim=dim, n=n, static=static):
            ctx = jparallel.ParallelCtx(fsdp_size=n, fsdp_sync=sync)
            full = ctx.gather(w_local, dim)
            rs, st = jgs.fsdp_reduce_scatter_stats(ct[0], "data", sync)
            static["wire"], static["buckets"] = st.wire_bytes, st.n_buckets
            grad = jax.grad(lambda v: jnp.sum((ctx.gather(v, dim) - t) ** 2))(w_local)
            flags = jnp.stack([st.overflow, st.nonfinite])
            return full[None], rs[None], flags[None], grad

        spec = P(*spec_of(dim))
        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, P(), P("data")),
                              out_specs=(P("data"), P("data"), P("data"), spec)))
        full, rs, flags, grad = (np.asarray(a.astype(jnp.float32)) if a.dtype != jnp.bool_
                                 else np.asarray(a) for a in f(w, t, cts))
        key = f"{n}/{sname}/{dtype}/{dim}"
        res.update({f"{key}/full": full, f"{key}/rs": rs, f"{key}/flags": flags,
                    f"{key}/grad": grad, f"{key}/wire": np.int64(static["wire"]),
                    f"{key}/buckets": np.int64(static["buckets"])})

    # mark_degraded under a forced overflow, and _sync_grads' probe of it
    n = 2
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    sync = sync_of(MARK, mark_degraded=True)
    w, t, _ = (jnp.asarray(a) for a in case_inputs(n, "gz", "float32", 0))

    def marked(w_local, t):
        ctx = jparallel.ParallelCtx(fsdp_size=n, fsdp_sync=sync)
        full = ctx.gather(w_local, 0)
        grad = jax.grad(lambda v: jnp.sum((ctx.gather(v, 0) - t) ** 2))(w_local)
        _, flag = jtraining._sync_grads({"w": grad}, {"w": P("data", None)}, ("data",), {})
        return full[None], grad, flag[None]

    f = jax.jit(shard_map(marked, mesh=mesh, in_specs=(P("data", None), P()),
                          out_specs=(P("data"), P("data", None), P("data"))))
    full, grad, flag = (np.asarray(a) for a in f(w, t))
    res.update({"mark/full": full, "mark/grad": grad, "mark/flag": flag})
    np.savez(out_path, **res)


class _Children:
    """The JAX children (the cases, and one per train config), started
    together with the module's first test; each result is read when a
    test first asks for it."""

    def __init__(self, tmp):
        env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
        env.pop("GZ_CHILD_DEVICES", None)
        self._procs, self._res = {}, {}
        for job in ("cases",) + tuple(TRAIN_FSDP):
            out = tmp / f"{job}.npz"
            self._procs[job] = (out, subprocess.Popen(
                [sys.executable, __file__, "jax", job, str(out)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, env=env))

    def get(self, job="cases") -> dict:
        if job not in self._res:
            out, proc = self._procs[job]
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"JAX child {job} failed:\n{log}"
            with np.load(out) as z:
                self._res[job] = {k: z[k] for k in z.files}
        return self._res[job]

    def close(self):
        for _, proc in self._procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def child(tmp_path_factory):
    kids = _Children(tmp_path_factory.mktemp("jax_fsdp"))
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
    return t.reshape(-1).view(torch.int32).numpy()


def _same_bits(a, b) -> bool:
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and np.array_equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _f32_bits(t) -> np.ndarray:
    return t.detach().to(torch.float32).contiguous().numpy().view(np.int32)


def _sync(kw, **extra):
    return None if kw is None else SyncConfig(gz=GZConfig(**kw), relative_eb=False, **extra)


def _in_backward_grads(model, ctx, params, specs, batch, scale):
    """The step's gradients through ``fsdp_all_gather`` itself: its
    reduce-scatter inside backward (on the CPU the backward runs on the
    rank's thread, so the ranks meet)."""
    leaves, rebuild = tree_flatten(params)
    req = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = model.loss_fn(rebuild(req), batch) * scale
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for g, p in zip(grads, leaves)]


def _port_case(n, sname, dtype, dim, route="in_backward", sync=None):
    """Every rank's (gathered, reduce-scattered, stats, shard gradient)."""
    sync = _sync(SYNCS[sname]) if sync is None else sync
    td = parallel.torch_dtype(dtype)
    w, t, cts = case_inputs(n, sname, dtype, dim)
    w, t = torch.from_numpy(w).to(td), torch.from_numpy(t).to(td)
    sizes = {"data": n}
    shards = [training._local([w], [spec_of(dim)], {"data": r}, sizes)[0].clone()
              for r in range(n)]
    ctx = parallel.ParallelCtx(fsdp_size=n, fsdp_sync=sync)

    def loss_of(v):
        return torch.sum((ctx.gather(v, dim) - t) ** 2)

    def body(args):
        shard, ct = args
        full = ctx.gather(shard, dim)
        rs, st = grad_sync.fsdp_reduce_scatter_stats(ct, "data", sync)
        x = shard.clone().requires_grad_(True)
        if route == "in_backward":
            with torch.enable_grad():
                (g,) = torch.autograd.grad(loss_of(x), x)
        else:
            fs = FsdpStep("data", sync, [x], [dim])
            with torch.enable_grad():
                with fs.forward():
                    loss = loss_of(x)
                grads = torch.autograd.grad(loss, [x], allow_unused=True)
            (g,) = fs.reduce_scatter(grads)
        return full, rs, st, g

    inputs = [(shards[r], torch.from_numpy(cts[r]).to(td)) for r in range(n)]
    return transport.ThreadGroup(n, "cpu").run(body, inputs, axis_name="data")


# ---------------------------------------------------------------------------
# Port-only (they run while the children work)
# ---------------------------------------------------------------------------


# the compressed gather and reduce-scatter on minitron-8b, the exact ones on
# zamba2 (the shared block's sums do not depend on the codec; the plain
# codec on the CPU would take most of this file's time there)
ROUTE_CASES = [(a, dt, remat) for a in ("minitron-8b", "zamba2-2.7b")
               for dt in DTYPES for remat in ("full", "none")]
ROUTE_CASES.append(("zamba2-2.7b@6", "float32", "full"))  # the shared block 3 times


def _route_setup(arch, dtype, remat, n=2, fsdp_gz=None, **kw):
    name, _, layers = arch.partition("@")
    cfg = registry.get(name, smoke=True)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=int(layers))
    mesh = ThreadMesh((n, 1), AXES, "cpu")
    setup = training.make_setup(cfg, mesh, opt=opt_config(adamw.AdamWConfig), remat=remat,
                                fsdp_gz=fsdp_gz, **kw)
    _, bspecs = shapes.train_specs(cfg, shapes.InputShape("t", 16, 2, "train"), mesh)
    whole = parallel.init_params(setup.defs, torch.Generator().manual_seed(0), "cpu")
    whole = convert.tree_map(lambda p: p.to(parallel.torch_dtype(dtype)), whole)
    sizes, coords = {"data": n, "model": 1}, training._coords(mesh)
    params = [convert.tree_map(torch.clone, training._local(whole, setup.specs, c, sizes))
              for c in coords]
    stream = SyntheticStream(cfg, 2, 16, seed=0)
    return cfg, mesh, setup, bspecs, params, [next(stream) for _ in range(TRAIN_STEPS)]


@pytest.mark.parametrize("arch,dtype,remat", ROUTE_CASES)
def test_deferred_route_equals_in_backward_route_by_bits(monkeypatch, arch, dtype, remat):
    fsdp_gz = GZConfig(eb=1e-4, algo="ring") if arch == "minitron-8b" else None
    cfg, mesh, setup, bspecs, params, batches = _route_setup(arch, dtype, remat,
                                                             fsdp_gz=fsdp_gz)
    sharded = [training._data_dim(s, "data") is not None
               for s in training._leaf_specs(setup.defs, setup.specs)]
    assert any(sharded) and not all(sharded)
    real_sync, real_grads = training._sync_grads, training._loss_and_grads
    runs = {}
    for name in ("deferred", "in_backward"):
        first = {}  # each rank's step-0 gradients, as _sync_grads gets them

        def sync(grads, *a, first=first):
            rank = transport.current("data").rank
            if rank not in first:
                first[rank] = [g.clone() for g in tree_flatten(grads)[0]]
            return real_sync(grads, *a)

        monkeypatch.setattr(training, "_sync_grads", sync)
        # each route forced: a CPU ThreadMesh's step takes the in-backward
        # one by itself, FsdpStep only where CUDA's ranks share a thread
        if name == "in_backward":
            monkeypatch.setattr(training, "_loss_and_grads",
                                lambda *a, deferred: _in_backward_grads(*a))
        else:
            monkeypatch.setattr(training, "_loss_and_grads",
                                lambda *a, **kw: real_grads(*a, **{**kw, "deferred": True}))
        step = training.make_train_step(setup, bspecs)
        p = [convert.tree_map(torch.clone, t) for t in params]
        o = [adamw.adamw_init(t) for t in p]
        for batch in batches:
            p, o, m = step(p, o, batch)
            assert np.isfinite(float(m["loss"])) and not bool(m["skipped"])
        runs[name] = (first, p, o)
    for r in range(2):
        for i, (a, b) in enumerate(zip(runs["deferred"][0][r], runs["in_backward"][0][r])):
            assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b)), (r, i)
        assert _same_bits(runs["deferred"][1][r], runs["in_backward"][1][r])
        assert _same_bits(runs["deferred"][2][r], runs["in_backward"][2][r])
    # the replicated leaves stay equal on both ranks
    p = runs["deferred"][1]
    for i, shard in enumerate(sharded):
        if not shard:
            assert np.array_equal(_bits(tree_flatten(p[0])[0][i]),
                                  _bits(tree_flatten(p[1])[0][i]))


@pytest.mark.parametrize("arch", ["minicpm3-4b", "phi3.5-moe-42b-a6.6b", "mamba2-780m",
                                  "seamless-m4t-medium", "internvl2-26b"])
def test_every_family_gathers_along_its_specs_dims(arch):
    # FsdpStep checks each gather's dim against the leaf's spec and raises
    # on a mismatch; here every sharded leaf must be gathered at least once
    cfg, mesh, setup, bspecs, params, batches = _route_setup(arch, "bfloat16", "full")
    sizes, coords = {"data": 2, "model": 1}, training._coords(mesh)
    seen = [set() for _ in range(2)]
    real = FsdpStep._gather

    def counting(self, x, dim, key):
        out = real(self, x, dim, key)
        seen[self.group.rank].add(self._where[key][0])
        return out

    FsdpStep._gather = counting
    try:
        res = mesh.run(lambda a: training._loss_and_grads(
            setup.model, setup.ctx, a[0], setup.specs, a[1], 0.5),
            [(params[r], training._local(batches[0], bspecs, coords[r], sizes))
             for r in range(2)])
    finally:
        FsdpStep._gather = real
    want = {i for i, s in enumerate(training._leaf_specs(setup.defs, setup.specs))
            if training._data_dim(s, "data") is not None}
    assert seen[0] == seen[1] == want
    for loss, grads in res:
        assert np.isfinite(float(loss))
        assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_gather_along_another_dim_than_the_spec_raises():
    w = torch.zeros(3, 8, 4)

    def body(_):
        fs = FsdpStep("data", None, [w], [1])
        with pytest.raises(ValueError, match="dim 1 of a layer slice"):
            fs._resolve(w[0], grad_sync._slice_key(w[0], 1))
        with pytest.raises(ValueError, match="along dim 2"):
            fs._resolve(w, grad_sync._slice_key(w, 2))
        with pytest.raises(ValueError, match="neither a sharded leaf"):
            fs._resolve(w[0, 1:], grad_sync._slice_key(w[0, 1:], 0))
        return True

    assert transport.ThreadGroup(1, "cpu").run(body, [None], axis_name="data") == [True]


def test_recompute_without_a_gathered_weight_raises():
    ws = [torch.zeros(2, 8, 4) for _ in range(2)]

    def body(w):
        fs = FsdpStep("data", None, [w], [1])
        with fs.forward():
            grad_sync.fsdp_gather(w[0], 0, "data")
            _, recompute = grad_sync.fsdp_recompute_context()
        # a recompute, bound to the step, is served from the kept result
        with recompute:
            assert tuple(grad_sync.fsdp_gather(w[0], 0, "data").shape) == (16, 4)
            with pytest.raises(RuntimeError, match="found no gathered weight"):
                grad_sync.fsdp_gather(w[1], 0, "data")
        return True

    assert transport.ThreadGroup(2, "cpu").run(body, ws, axis_name="data") == [True, True]


def test_recompute_on_another_thread_takes_the_forwards_gathers():
    # CUDA's case on the CPU: backward, and so remat's recompute, on a
    # thread that is not the rank's; it must launch no collective there
    n, dim = 2, 1
    cfg = registry.get("minitron-8b", smoke=True)
    mesh = ThreadMesh((n, 1), AXES, "cpu")
    setup = training.make_setup(cfg, mesh, remat="full")
    _, bspecs = shapes.train_specs(cfg, shapes.InputShape("t", 16, 2, "train"), mesh)
    whole = parallel.init_params(setup.defs, torch.Generator().manual_seed(0), "cpu")
    sizes, coords = {"data": n, "model": 1}, training._coords(mesh)
    batch = next(SyntheticStream(cfg, 2, 16, seed=0))
    gathers = []
    real = grad_sync._fsdp_gather_impl

    def counting(*a):
        gathers.append(threading.current_thread().name)
        return real(*a)

    def body(args):
        params, b = args
        leaves, rebuild = tree_flatten(params)
        req = [p.detach().requires_grad_(True) for p in leaves]
        dims = [training._data_dim(s, "data")
                for s in training._leaf_specs(params, setup.specs)]
        fs = FsdpStep("data", None, req, dims)
        with torch.enable_grad(), fs.forward():
            loss = setup.model.loss_fn(rebuild(req), b)
        n_forward = len(fs._memo)
        out = []
        t = threading.Thread(target=lambda: out.append(
            torch.autograd.grad(loss, req, allow_unused=True)))
        t.start()
        t.join(timeout=120)
        assert not t.is_alive() and out
        grads = fs.reduce_scatter(out[0])
        return n_forward, grads, threading.current_thread().name

    inputs = [(convert.tree_map(torch.clone, training._local(whole, setup.specs, c, sizes)),
               training._local(batch, bspecs, c, sizes)) for c in coords]
    grad_sync._fsdp_gather_impl = counting
    try:
        res = mesh.run(body, inputs)
    finally:
        grad_sync._fsdp_gather_impl = real
    # every gather ran in a forward, on a rank's thread, once a slice
    assert set(gathers) == {name for _, _, name in res}
    assert len(gathers) == sum(nf for nf, _, _ in res) > 0
    want = mesh.run(lambda a: _in_backward_grads(setup.model, setup.ctx, a[0], setup.specs,
                                                 a[1], 1.0), inputs)
    for (_, got, _), (_, ref) in zip(res, want):
        assert len(got) == len(ref)
        assert all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(got, ref))


def test_backward_on_a_foreign_thread_raises():
    n = 2
    sync = _sync(SYNCS["gz"])
    xs = [torch.linspace(0, 1, 64).reshape(8, 8).requires_grad_(True) for _ in range(n)]

    def body(x):
        with torch.enable_grad():
            return grad_sync.fsdp_all_gather(x, "data", sync).sum()

    outs = transport.ThreadGroup(n, "cpu").run(body, xs, axis_name="data")
    errors = []
    t = threading.Thread(target=lambda: errors.append(_raises(outs[0], xs[0])))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert "make_train_step" in errors[0] and "DistGroup" in errors[0]
    assert "make_train_step" in _raises(outs[1], xs[1])  # the main thread: foreign too


def _raises(out, x) -> str:
    try:
        torch.autograd.grad(out, x)
    except RuntimeError as e:
        return str(e)
    return "backward succeeded"


class _Give(torch.autograd.Function):
    """Identity forward; backward gives a preset block and notes its arrival."""

    @staticmethod
    def forward(ctx, x, block, arrivals, tag):
        ctx.block, ctx.arrivals, ctx.tag = block, arrivals, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, _):
        ctx.arrivals.append(ctx.tag)
        return ctx.block, None, None, None


@pytest.mark.parametrize("uses", [[0, 1, 2], [2], [None], [None, None, None]])
def test_sum_blocks_adds_as_autograd_does(uses):
    # a leaf's gradient through several uses (slices, or the whole leaf), each
    # giving a block with -0.0, +0.0 and NaN in it: _sum_blocks, fed the blocks
    # in autograd's arrival order, gives autograd's bits, the signs of zero too
    rng = np.random.default_rng(len(uses))
    leaf = torch.zeros(3, 4, requires_grad=True)
    blocks, arrivals, total = {}, [], 0
    for tag, i in enumerate(uses):
        shape = (4,) if i is not None else (3, 4)
        b = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        b.view(-1)[0], b.view(-1)[1] = -0.0, float("nan")
        b.view(-1)[-1] = -0.0 if tag % 2 else 0.0
        blocks[tag] = b
        x = leaf if i is None else leaf[i]
        total = total + _Give.apply(x, b, arrivals, tag).sum()
    (want,) = torch.autograd.grad(total, leaf)
    got = grad_sync._sum_blocks(leaf.detach(), [(uses[t], blocks[t]) for t in arrivals])
    assert np.array_equal(_bits(got), _bits(want))


def test_sum_blocks_refuses_a_slice_gathered_twice():
    leaf, b = torch.zeros(3, 4), torch.ones(4)
    for parts in ([(1, b), (1, b)], [(None, torch.ones(3, 4)), (0, b)]):
        with pytest.raises(ValueError, match="gathered twice"):
            grad_sync._sum_blocks(leaf, parts)


def test_global_undoes_local():
    sizes = {"data": 2, "model": 2}
    coords = [{"data": d, "model": m} for d in range(2) for m in range(2)]
    tree = {"a": torch.arange(48.0).reshape(4, 12), "b": [torch.arange(6.0)],
            "c": torch.arange(24.0).reshape(2, 3, 4)}
    specs = {"a": ("data", "model"), "b": [(None,)], "c": (None, None, ("data", "model"))}
    blocks = [training._local(tree, specs, c, sizes) for c in coords]
    assert tuple(blocks[3]["a"].shape) == (2, 6) and tuple(blocks[1]["c"].shape) == (2, 3, 1)
    assert _same_bits(training._global(blocks, specs, coords, sizes), tree)


# ---------------------------------------------------------------------------
# gloo: one process per rank
# ---------------------------------------------------------------------------

DIST_CASES = [("gz", "float32", 1), ("exact", "bfloat16", 0)]


def _dist_child(rank: int, port: int, out_path: str) -> None:
    import torch.distributed as dist

    n = 2
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        g = transport.DistGroup()
        res = {}
        for sname, dtype, dim in DIST_CASES:
            td = parallel.torch_dtype(dtype)
            w, t, _ = case_inputs(n, sname, dtype, dim)
            w, t = torch.from_numpy(w).to(td), torch.from_numpy(t).to(td)
            shard = training._local([w], [spec_of(dim)], {"data": rank}, {"data": n})[0]
            ctx = parallel.ParallelCtx(fsdp_size=n, fsdp_sync=_sync(SYNCS[sname]))
            x = shard.clone().requires_grad_(True)
            with g.bind("data"):
                full = ctx.gather(x, dim)
                (grad,) = torch.autograd.grad(torch.sum((full - t) ** 2), x)
            res[f"{sname}/full"] = _f32_bits(full)
            res[f"{sname}/grad"] = _f32_bits(grad)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_distgroup_equals_threadgroup():
    n, port = 2, _free_port()
    env = {**os.environ, "PYTHONPATH": SRC}
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(n)]
        procs = [subprocess.Popen([sys.executable, __file__, "dist", str(r), str(port),
                                   outs[r]], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True, env=env)
                 for r in range(n)]
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"gloo rank {r} failed:\n{logs[r]}"
        ranks = [dict(np.load(o)) for o in outs]
    for sname, dtype, dim in DIST_CASES:
        res = _port_case(n, sname, dtype, dim)
        for r in range(n):
            full, _, _, grad = res[r]
            assert np.array_equal(ranks[r][f"{sname}/full"], _f32_bits(full)), (sname, r)
            assert np.array_equal(ranks[r][f"{sname}/grad"], _f32_bits(grad)), (sname, r)


# ---------------------------------------------------------------------------
# Against the JAX child
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sname", list(SYNCS))
@pytest.mark.parametrize("n", NS)
def test_gather_reduce_scatter_and_gradient_bitwise_equal_reference(child, n, sname,
                                                                    dtype, dim):
    ref = child.get()
    key = f"{n}/{sname}/{dtype}/{dim}"
    for route in ("in_backward", "deferred"):
        res = _port_case(n, sname, dtype, dim, route)
        grads = []
        for r, (full, rs, st, g) in enumerate(res):
            assert full.dtype == g.dtype == rs.dtype == parallel.torch_dtype(dtype)
            assert tuple(full.shape) == SHAPE
            assert np.array_equal(_f32_bits(full), ref[f"{key}/full"][r].view(np.int32)), r
            assert np.array_equal(_f32_bits(rs), ref[f"{key}/rs"][r].view(np.int32)), r
            assert [bool(st.overflow), bool(st.nonfinite)] == list(ref[f"{key}/flags"][r])
            assert (st.wire_bytes, st.n_buckets) == (int(ref[f"{key}/wire"]),
                                                      int(ref[f"{key}/buckets"]))
            grads.append(g)
        whole = training._global([[g] for g in grads], [spec_of(dim)],
                                 [{"data": r} for r in range(n)], {"data": n})[0]
        assert np.array_equal(_f32_bits(whole), ref[f"{key}/grad"].view(np.int32)), route
    if sname == "exact":
        assert [st.n_buckets for _, _, st, _ in res] == [0] * n


def test_exact_reduce_scatter_rounds_a_bf16_sum_once(child):
    # at N = 4 the f32 sum rounded once and a sum rounded after each add
    # differ on these cotangents: the reference's is the former
    ref = child.get()
    n = 4
    _, _, cts = case_inputs(n, "exact", "bfloat16", 0)
    parts = torch.from_numpy(cts).to(torch.bfloat16)
    fold, per_add = parts[0].float(), parts[0]
    for r in range(1, n):
        fold = fold + parts[r].float()
        per_add = (per_add.float() + parts[r].float()).to(torch.bfloat16)
    once = fold.to(torch.bfloat16).reshape(n, -1)
    assert not np.array_equal(_bits(per_add.reshape(n, -1)), _bits(once))
    for r in range(n):
        want = ref[f"{n}/exact/bfloat16/0/rs"][r].reshape(-1).view(np.int32)
        assert np.array_equal(_f32_bits(once[r]), want), r


def test_mark_degraded_nan_reaches_the_sync_probe(child):
    ref = child.get()
    n = 2
    sync = _sync(MARK, mark_degraded=True)
    for route in ("in_backward", "deferred"):
        res = _port_case(n, "gz", "float32", 0, route, sync=sync)
        for r, (full, _, _, g) in enumerate(res):
            assert np.array_equal(torch.isnan(full).numpy(), np.isnan(ref["mark/full"][r]))
            assert bool(torch.isnan(g).all()) and np.isnan(ref["mark/grad"]).all()
        flags = ThreadMesh((n, 1), AXES, "cpu").run(
            lambda g: training._sync_grads({"w": g}, {"w": ("data", None)}, AXES, {})[1],
            [g for *_, g in res])
        assert all(bool(f) for f in flags) and all(bool(f) for f in ref["mark/flag"])


@pytest.mark.parametrize("fsdp_gz", list(TRAIN_FSDP))
def test_sharded_train_step_matches_reference(child, fsdp_gz):
    ref = child.get(fsdp_gz)
    cfg = registry.get("minitron-8b", smoke=True)
    mesh = ThreadMesh((TRAIN_N, 1), AXES, "cpu")
    kw = TRAIN_FSDP[fsdp_gz]
    setup = training.make_setup(cfg, mesh, opt=opt_config(adamw.AdamWConfig),
                                grad_gz=GZConfig(**TRAIN_GZ),
                                fsdp_gz=None if kw is None else GZConfig(**kw))
    assert setup.ctx.fsdp_size == TRAIN_N
    _, bspecs = shapes.train_specs(cfg, shapes.InputShape("t", TRAIN_S, TRAIN_B, "train"),
                                   mesh)
    step = training.make_train_step(setup, bspecs)
    leaves, rebuild = tree_flatten(setup.defs)
    p0 = [ref[f"p0/{i}"] for i in range(len(leaves))]
    whole = rebuild([torch.from_numpy(a.copy()) for a in p0])
    sizes, coords = {"data": TRAIN_N, "model": 1}, training._coords(mesh)
    params = [convert.tree_map(torch.clone, training._local(whole, setup.specs, c, sizes))
              for c in coords]
    opt = [adamw.adamw_init(p) for p in params]
    for s, batch in enumerate(train_batches(cfg)):
        params, opt, m = step(params, opt, batch)
        np.testing.assert_allclose(float(m["loss"]), ref[f"m{s}/loss"], rtol=1e-5)
        np.testing.assert_allclose(float(m["gnorm"]), ref[f"m{s}/gnorm"], rtol=1e-5)
        assert m["lr"].numpy().tobytes() == np.asarray(ref[f"m{s}/lr"],
                                                       np.float32).tobytes()
        assert not bool(m["skipped"]) and not bool(ref[f"m{s}/skipped"])
    final = training._global(params, setup.specs, coords, sizes)
    step_lrs = sum(float(ref[f"m{s}/lr"]) for s in range(TRAIN_STEPS))
    for i, leaf in enumerate(tree_flatten(final)[0]):
        init = p0[i].astype(np.float64)
        ours = leaf.numpy().astype(np.float64) - init
        theirs = ref[f"p/{i}"].astype(np.float64) - init
        assert np.all(np.abs(ours - theirs) <= step_lrs), i
        assert np.linalg.norm(ours - theirs) <= 1e-3 * np.linalg.norm(theirs), i



if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_child(sys.argv[2], sys.argv[3])
    else:
        _dist_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
