"""The backward-overlapped bucketed gradient sync (ROADMAP A11.8) against
the JAX package, on the CPU.

``launch.training``'s ``_install_bucket_hooks``: every parameter leaf in
a bucket hook whose backward syncs the bucket's cotangents, the health
bits on a chained token; ``make_setup(overlap_sync=True)`` and the
overlapped branch of ``make_train_step``; the FSDP route chosen by mesh.

One JAX child, pinned to 4 host devices and started when this module's
first test runs, computes every reference value while the port-only
tests run:

  * the reference's hooks under ``shard_map`` on ``("data",)`` of 4: five
    leaves (one bf16) in two buckets of ``HOOK_BUCKET`` bytes, each
    rank's cotangents given, with the exact signature and with a
    compressed ``ring`` communicator at eb 1e-4, clean and with a NaN in
    one rank's cotangent; and on ``(data 2, model 2)`` leaves replicated
    over both axes (bf16 and f32) through the hooks and through
    ``_sync_grads``;
  * the buckets ``_install_bucket_hooks`` makes (recorded by a stand-in
    for ``_bucket_hook``) and ``make_setup``'s resolved bucket size and
    ``overlap_plan.overlap_efficiency`` for every family's smoke config
    at ``(data 2, model 2)`` and the dense one replicated at ``(4, 1)``,
    at three bucket sizes;
  * two runs of the jitted ``make_train_step`` of minitron-8b's smoke
    config with ``overlap_sync=True``, ``grad_gz`` ring at eb 1e-4 and
    256 KiB buckets, 2 steps each, f32: sharded at ``(data 2, model 2)``
    and replicated at ``(data 4, model 1)``.

Tolerances: the hooks' gradients and tokens by bits (NaN where the
reference has NaN, whatever its bits: torch's vectorized cast to bf16
writes 0xFFFF for every NaN); the buckets, the bucket size and
``overlap_modeled`` equal; the train steps within
``tests/test_torch_train.py``'s bounds (ROADMAP C15), as
``tests/test_torch_tp_train.py`` holds the post-hoc step: loss and
gradient norm rel 1e-5 (measured 7.5e-8 and 5.0e-6), ``lr`` and
``overlap_modeled`` by bits, no element of a parameter's update off by
more than the sum of the learning rates (measured 0.017 of it sharded,
0.97 replicated), and the L2 of the difference of the updates at most
1e-3 of the reference's update (measured 1.2e-4 sharded) -- except in
the replicated case, at 1e-2 (``UPDATE_L2``).  Why:
there every gradient crosses the 4-rank ring (three lossy hops), whose
quantizer turns the two packages' last-bit differences into steps of
2 eb = 2e-4, and AdamW's sign-like first steps move an element whose
gradient lies within a step of zero the other way (C15): one element of
``blocks.mlp.wo`` moves 1.07e-3 apart (inside the sum of the learning
rates), 4.0e-3 of that leaf's update by L2.  The post-hoc step on the
same cell measures the same (4.0e-3), so the hooks add nothing to it.

Port-only, while the child works: the overlapped step against the
post-hoc one with exact sums over 3 steps at ``(2, 2)`` and ``(1, 1)``, in
f32 and bf16, by bits.  One case is not bitwise, in both packages: a bf16
leaf that the mesh replicates over two axes of extent > 1 (the norms at
``(2, 2)``).  ``_sync_grads`` rounds its sum to bf16 after each axis (the
reference's ``psum`` of a bf16 leaf does), the hooks sum the bucket's f32
vector over both axes and round once (the reference's hooks do; its child
case shows its own two routes differ there).  So in bf16 at ``(2, 2)``
the overlapped step is held by bits against a post-hoc step whose sync
rounds once, and its step-0 gradients within one bf16 rounding of the
plain post-hoc ones.  Also: a gloo ``DistMesh`` of four processes (no JAX),
each backward on a second thread and the staging route forced on, equal
by bits to the CPU ``ThreadMesh``; a hook's backward on a foreign thread,
finding its handles on a one-rank mesh and raising (never waiting) on a
two-rank ``ThreadMesh``; the CUDA-``ThreadMesh`` refusal and the FSDP
route, through their predicate.
"""
import json
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
import types  # noqa: E402

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import transport
from repro_torch.core.collectives import GZConfig
from repro_torch.core.comm import GZCommunicator
from repro_torch.core.grad_sync import tree_flatten
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.launch import shapes, training
from repro_torch.launch.mesh import ThreadMesh
from repro_torch.models import parallel
from repro_torch.optim import adamw

HERE = pathlib.Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
AXES = ("data", "model")
N = 4
# the hook-level case: five leaves, one bf16, in two buckets of 1 KiB
HOOK_LEAVES = {"a": ((300, 7), "float32"), "b": ((41,), "bfloat16"), "c": ((9, 9), "float32"),
               "d": ((64, 5), "float32"), "e": ((200,), "float32")}
HOOK_BUCKET = 1024
HOOK_GZ = dict(eb=1e-4, algo="ring")
HOOK_NAN = ("b", 2)  # the leaf and rank whose cotangent is NaN in the poisoned case
# replicated over both axes of (data 2, model 2): one rounding or two
TWO_AXIS_LEAVES = {"m": ((2, 128), "bfloat16"), "n": ((128,), "bfloat16"),
                   "w": ((64, 16), "float32")}
# family: (arch, ModelConfig overrides, mesh, fsdp)
PLAN_FAMILIES = {
    "dense": ("minitron-8b", {}, (2, 2), True),
    "dense-replicated": ("minitron-8b", {}, (4, 1), False),
    "moe": ("phi3.5-moe-42b-a6.6b", {}, (2, 2), True),
    "ssm": ("mamba2-780m", {}, (2, 2), True),
    "hybrid": ("zamba2-2.7b", {}, (2, 2), True),
    "mla": ("minicpm3-4b", {}, (2, 2), True),
    "encdec": ("seamless-m4t-medium", {}, (2, 2), True),
    "vlm": ("internvl2-26b", {}, (2, 2), True),
    "audio": ("internvl2-26b", {"family": "audio", "arch_id": "audio-smoke"}, (2, 2), True),
}
PLAN_BUCKETS = (64 * 1024, 1024 * 1024, 0)  # 0: the BucketPlan's size
TRAIN_ARCH = "minitron-8b"
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 4, 32, 2, 1e-3
TRAIN_GZ = dict(eb=1e-4, algo="ring", on_overflow="fallback")
TRAIN_BUCKET = 256 * 1024
TRAIN_CASES = {"fsdp": ((2, 2), True), "replicated": ((4, 1), False)}
UPDATE_L2 = {"fsdp": 1e-3, "replicated": 1e-2}  # of the reference's update (docstring)
EXACT_STEPS = 3
DIST_MESH = (2, 2)
DIST_BUCKET = 64 * 1024


def hook_inputs(leaves, seed):
    """Global f32 weights of ``leaves`` and each rank's cotangents, (N,
    ...) per leaf, rounded to the leaf's dtype (kept as f32 arrays)."""
    rng = np.random.default_rng(seed)
    params, cts = {}, {}
    for k, (shape, dtype) in leaves.items():
        params[k] = rng.normal(0, 0.02, shape).astype(np.float32)
        # small enough that the compressed ring at eb 1e-4 does not overflow
        c = torch.from_numpy(rng.normal(0, 1e-3, (N,) + shape).astype(np.float32))
        cts[k] = c.to(parallel.torch_dtype(dtype)).float().numpy()
    return params, cts


def poisoned(cts):
    out = {k: v.copy() for k, v in cts.items()}
    leaf, rank = HOOK_NAN
    out[leaf][rank] = np.nan
    return out


def cfg_of(reg, family):
    arch, kw, _, _ = PLAN_FAMILIES[family]
    return dataclasses.replace(reg.get(arch, smoke=True), **kw)


def opt_config(cls, steps=TRAIN_STEPS):
    return cls(lr=TRAIN_LR, warmup_steps=1, total_steps=steps)


def train_batches(cfg, steps=TRAIN_STEPS):
    stream = SyntheticStream(cfg, TRAIN_B, TRAIN_S, seed=0)
    return [next(stream) for _ in range(steps)]


# ---------------------------------------------------------------------------
# The JAX child
# ---------------------------------------------------------------------------


def _jax_child(out_path: str) -> None:
    import concurrent.futures
    import time

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.configs import registry as jregistry
    from repro.core.collectives import GZConfig as JGZConfig
    from repro.core.comm import GZCommunicator as JComm
    from repro.core.shmap import shard_map
    from repro.launch import shapes as jshapes
    from repro.launch import training as jtraining
    from repro.models import parallel as jparallel
    from repro.optim import adamw as jadamw

    res = {}
    t0 = time.perf_counter()
    devices = np.array(jax.devices()[:N])
    f32 = jnp.float32

    def hooked_grads(mesh, axes, leaves, comms, rank_axes):
        """The reference's hooked gradients and token, each rank's, for
        ``leaves`` replicated on every rank and each rank's cotangents."""
        specs = {k: P(*([None] * len(s))) for k, (s, _) in leaves.items()}
        cspecs = {k: P(rank_axes, *([None] * len(s))) for k, (s, _) in leaves.items()}

        def body(p, c):
            c = jax.tree.map(lambda x: x[0], c)

            def lf(p, tok):
                hooked, tok_out, _ = jtraining._install_bucket_hooks(
                    p, specs, axes, comms, HOOK_BUCKET, tok)
                loss = sum(jnp.sum(h.astype(f32) * cc.astype(f32))
                           for h, cc in zip(jax.tree.leaves(hooked), jax.tree.leaves(c)))
                return loss + 0.0 * tok_out

            g, g_tok = jax.grad(lf, argnums=(0, 1))(p, jnp.zeros((), f32))
            post, _ = jtraining._sync_grads(c, specs, axes, {})
            return (jax.tree.map(lambda x: x[None], g), g_tok[None],
                    jax.tree.map(lambda x: x[None], post))

        return jax.jit(shard_map(body, mesh=mesh, in_specs=(specs, cspecs),
                                 out_specs=(cspecs, P(rank_axes), cspecs)))

    def cast(tree, leaves):
        return {k: jnp.asarray(v).astype(jnp.dtype(leaves[k][1])) for k, v in tree.items()}

    # (a) the hooks on ("data",) of 4, exact and compressed, clean and poisoned
    mesh1 = Mesh(devices, ("data",))
    params, cts = hook_inputs(HOOK_LEAVES, 0)
    ring = JComm.for_config("data", JGZConfig(**HOOK_GZ), axis_size=N)
    for case, comms in (("exact", {}), ("ring", {"data": ring})):
        f = hooked_grads(mesh1, ("data",), HOOK_LEAVES, comms, "data")
        for tag, c in (("clean", cts), ("nan", poisoned(cts))):
            g, tok, _ = f(cast(params, HOOK_LEAVES), cast(c, HOOK_LEAVES))
            for k, v in g.items():
                res[f"hook/{case}/{tag}/g/{k}"] = np.asarray(v.astype(f32))
            res[f"hook/{case}/{tag}/tok"] = np.asarray(tok)
    # ... and on (data 2, model 2), leaves replicated over both axes
    mesh2 = Mesh(devices.reshape(2, 2), AXES)
    params2, cts2 = hook_inputs(TWO_AXIS_LEAVES, 1)
    g, tok, post = hooked_grads(mesh2, AXES, TWO_AXIS_LEAVES, {}, AXES)(
        cast(params2, TWO_AXIS_LEAVES), cast(cts2, TWO_AXIS_LEAVES))
    for k in TWO_AXIS_LEAVES:
        res[f"two/g/{k}"] = np.asarray(g[k].astype(f32))
        res[f"two/post/{k}"] = np.asarray(post[k].astype(f32))
    res["two/tok"] = np.asarray(tok)
    print(f"{time.perf_counter() - t0:7.2f} s hooks", flush=True)

    # (b) the buckets, the resolved size and overlap_modeled
    real_hook = jtraining._bucket_hook
    plans = {}
    try:
        for fam, (_, _, shape, fsdp) in PLAN_FAMILIES.items():
            cfg = cfg_of(jregistry, fam)
            mesh = Mesh(devices.reshape(shape), AXES)
            for bb in PLAN_BUCKETS:
                setup = jtraining.make_setup(cfg, mesh, grad_gz=JGZConfig(**TRAIN_GZ),
                                             overlap_sync=True, bucket_bytes=bb, fsdp=fsdp)
                tree = jparallel.param_shapes(setup.defs)
                index = {id(x): i for i, x in enumerate(jax.tree.leaves(tree))}
                buckets = []

                def record(meta, leaves, token, buckets=buckets, index=index):
                    buckets.append([[[ax, comm is not None] for ax, comm in meta.ops],
                                    [index[id(x)] for x in leaves]])
                    return leaves, token

                jtraining._bucket_hook = record
                _, _, n = jtraining._install_bucket_hooks(
                    tree, setup.specs, AXES, dict(setup.grad_comms), setup.bucket_bytes, None)
                plans[f"{fam}/{bb}"] = {
                    "n": n, "buckets": buckets, "bucket_bytes": setup.bucket_bytes,
                    "eff": (None if setup.overlap_plan is None
                            else setup.overlap_plan.overlap_efficiency)}
    finally:
        jtraining._bucket_hook = real_hook
    res["plans"] = np.array(json.dumps(plans))
    print(f"{time.perf_counter() - t0:7.2f} s plans", flush=True)

    # (d) the jitted overlapped train steps
    cfg = jregistry.get(TRAIN_ARCH, smoke=True)
    batches = train_batches(cfg)
    key = jax.random.key(0)
    jobs = []
    for name, (shape, fsdp) in TRAIN_CASES.items():
        mesh = Mesh(devices.reshape(shape), AXES)
        setup = jtraining.make_setup(cfg, mesh, opt=opt_config(jadamw.AdamWConfig),
                                     grad_gz=JGZConfig(**TRAIN_GZ), fsdp=fsdp,
                                     overlap_sync=True, bucket_bytes=TRAIN_BUCKET)
        _, bspecs = jshapes.train_specs(
            cfg, jshapes.InputShape("t", TRAIN_S, TRAIN_B, "train"), mesh)
        # drawn eagerly: a jitted draw's f32 casts differ in the last bits
        params = jax.tree.map(lambda a: a.astype(f32), jparallel.init_params(setup.defs, key))
        step = jtraining.make_train_step(setup, bspecs)
        args = (params, jax.eval_shape(jadamw.adamw_init, params), batches[0])
        jobs.append((name, step.lower(*args), params))
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        compiled = [(name, s, pool.submit(lo.compile)) for name, lo, s in jobs]
        compiled = [(name, s, c.result()) for name, s, c in compiled]
    print(f"{time.perf_counter() - t0:7.2f} s compiled", flush=True)
    for name, params, step in compiled:
        res.update({f"{name}/p0/{i}": np.asarray(a) for i, a in
                    enumerate(jax.tree.leaves(params))})
        opt = jadamw.adamw_init(params)
        for s, batch in enumerate(batches):
            params, opt, m = step(params, opt, batch)
            for k, v in m.items():
                res[f"{name}/m{s}/{k}"] = np.asarray(v)
        for i, a in enumerate(jax.tree.leaves(params)):
            res[f"{name}/p/{i}"] = np.asarray(a)
    print(f"{time.perf_counter() - t0:7.2f} s train steps", flush=True)
    np.savez(out_path, **res)


class _Child:
    """The JAX child (``script jax OUT``), started with the module's first
    test; its results are read when a test first asks for them."""

    def __init__(self, tmp):
        env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
        env.pop("GZ_CHILD_DEVICES", None)
        self._out = tmp / "overlap.npz"
        self._proc = subprocess.Popen([sys.executable, __file__, "jax", str(self._out)],
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

    def close(self):
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def child(tmp_path_factory):
    kid = _Child(tmp_path_factory.mktemp("jax_overlap"))
    try:
        yield kid
    finally:
        kid.close()


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


def _ranks(setup, whole) -> list:
    sizes = training.mesh_axis_sizes(setup.mesh)
    return [convert.tree_map(torch.clone, training._local(whole, setup.specs, c, sizes))
            for c in training._coords(setup.mesh)]


def _port_hooks(axes, shape, leaves, params, cts, comms, rank_axes=None):
    """Each rank's hooked gradients (f32 numpy) and token on a CPU
    ``ThreadGroup`` laid out as ``shape`` over ``axes``, the cotangents
    given; with the gradients ``_sync_grads`` gives the same cotangents."""
    specs = {k: (None,) * len(s) for k, (s, _) in leaves.items()}
    dts = {k: parallel.torch_dtype(d) for k, (_, d) in leaves.items()}
    weights = {k: torch.from_numpy(v).to(dts[k]) for k, v in params.items()}

    def body(r):
        c = {k: torch.from_numpy(v[r]).to(dts[k]) for k, v in cts.items()}
        p = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
        tok = torch.zeros((), dtype=torch.float32, requires_grad=True)
        with torch.enable_grad():
            hooked, tok_out, n = training._install_bucket_hooks(p, specs, axes, comms,
                                                                HOOK_BUCKET, tok)
            loss = sum((hooked[k].float() * c[k].float()).sum() for k in sorted(p))
            loss = loss + 0.0 * tok_out
            grads = torch.autograd.grad(loss, [p[k] for k in sorted(p)] + [tok])
        post, flag = training._sync_grads(c, specs, axes, comms)
        return ({k: g for k, g in zip(sorted(p), grads[:-1])}, grads[-1], n, post, flag)

    group = transport.ThreadGroup(N, "cpu")
    if len(axes) == 1:
        return group.run(body, list(range(N)), axis_name=axes[0])
    return group.run(body, list(range(N)), axis_name=axes, shape=shape)


# ---------------------------------------------------------------------------
# Port-only (they run while the child works)
# ---------------------------------------------------------------------------


def test_exact_hooks_equal_the_post_hoc_sync_by_bits():
    params, cts = hook_inputs(HOOK_LEAVES, 0)
    out = _port_hooks(("data",), None, HOOK_LEAVES, params, cts, {})
    for g, tok, n, post, flag in out:
        assert n == 2
        assert float(tok) == 0.0 and not bool(flag)
        for k in HOOK_LEAVES:
            assert g[k].dtype == post[k].dtype == parallel.torch_dtype(HOOK_LEAVES[k][1])
            assert np.array_equal(_bits(g[k]), _bits(post[k])), k
    # every rank holds the same sums
    assert all(_same_bits(o[0], out[0][0]) for o in out[1:])


def test_nan_cotangent_raises_the_token():
    params, cts = hook_inputs(HOOK_LEAVES, 0)
    out = _port_hooks(("data",), None, HOOK_LEAVES, params, poisoned(cts), {})
    leaf, rank = HOOK_NAN
    toks = [float(o[1]) for o in out]
    # the probe runs before the bucket's sum: the rank whose cotangent is
    # NaN flags it; the step's mesh-wide sum makes it every rank's
    assert toks[rank] > 0 and all(t == 0 for r, t in enumerate(toks) if r != rank)
    assert all(bool(torch.isnan(o[0][leaf]).all()) for o in out)


def test_bucket_plan_packs_whole_leaves_tail_first():
    leaves = [torch.empty(s, device="meta") for s in ((4,), (300,), (2, 3), (64,), (5,))]
    specs = [("data",), (None,), (None, None), (None,), ("model",)]
    comm = object()
    plan = training._bucket_plan(leaves, specs, AXES, {"data": comm}, 1024)
    # two signatures in order of first appearance; within one, the tail
    # first, whole leaves, a bucket closed once it reaches 1 KiB
    assert plan == [((("model", None),), [0]),
                    ((("data", comm), ("model", None)), [3, 2, 1]),
                    ((("data", comm),), [4])]
    assert training._bucket_plan(leaves, specs, AXES, {}, 4)[1][1] == [3]


def _exact_run(mesh_shape, dtype, overlap, monkeypatch=None, once=False):
    """3 steps of minitron-8b's smoke config, exact sums, remat full:
    (params, opt state, metrics, step 0's synced gradients of rank 0)."""
    cfg = dataclasses.replace(registry.get(TRAIN_ARCH, smoke=True), dtype=dtype)
    mesh = ThreadMesh(mesh_shape, AXES, "cpu")
    setup = training.make_setup(cfg, mesh, opt=opt_config(adamw.AdamWConfig, EXACT_STEPS),
                                overlap_sync=overlap, bucket_bytes=HOOK_BUCKET * 8)
    _, bspecs = shapes.train_specs(cfg, shapes.InputShape("t", 16, TRAIN_B, "train"), mesh)
    td = parallel.torch_dtype(dtype)
    whole = parallel.init_params(setup.defs, torch.Generator().manual_seed(0), "cpu")
    params = _ranks(setup, convert.tree_map(lambda p: p.to(td), whole))
    opt = [adamw.adamw_init(p) for p in params]
    first = {}
    real_norm = training._global_grad_norm

    def norm(grads, *a):
        if transport.current("data").rank == 0 and transport.current("model").rank == 0:
            first.setdefault("g", [g.clone() for g in tree_flatten(grads)[0]])
        return real_norm(grads, *a)

    patch = pytest.MonkeyPatch()
    patch.setattr(training, "_global_grad_norm", norm)
    if once:
        patch.setattr(training, "_sync_grads", _sync_grads_rounding_once)
    try:
        step = training.make_train_step(setup, bspecs)
        metrics = []
        stream = SyntheticStream(cfg, TRAIN_B, 16, seed=0)
        for _ in range(EXACT_STEPS):
            params, opt, m = step(params, opt, next(stream))
            metrics.append(m)
    finally:
        patch.undo()
    return setup, params, opt, metrics, first["g"]


def _sync_grads_rounding_once(grads, specs, mesh_axes, grad_comms):
    """``_sync_grads`` with exact sums whose f32 sum over every absent axis
    rounds once to the leaf's dtype, as the hooks' bucket vector does."""
    leaves, rebuild = tree_flatten(grads)
    flag = torch.zeros((), dtype=torch.bool)
    out = []
    for g, s in zip(leaves, training._leaf_specs(grads, specs)):
        flag = flag | ~torch.isfinite(g).all()
        v = g.to(torch.float32)
        for ax in mesh_axes:
            if ax not in training._axes_in_spec(s):
                v = transport.current(ax).sum_across(v)
        out.append(v.to(g.dtype))
    return rebuild(out), flag


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_overlapped_exact_step_equals_the_post_hoc_step_by_bits(mesh_shape, dtype):
    setup, p1, o1, m1, g1 = _exact_run(mesh_shape, dtype, True)
    assert setup.overlap_plan is None and setup.bucket_bytes == HOOK_BUCKET * 8
    sizes = training.mesh_axis_sizes(setup.mesh)
    twice = [i for i, s in enumerate(training._leaf_specs(setup.defs, setup.specs))
             if sum(sizes[ax] > 1 for ax in AXES if ax not in training._axes_in_spec(s)) > 1]
    if dtype == "bfloat16" and mesh_shape == (2, 2):
        # the norms: replicated over both axes, so the two routes round
        # differently (module docstring)
        assert twice
        _, p0, o0, m0, g0 = _exact_run(mesh_shape, dtype, False)
        for i, (a, b) in enumerate(zip(g0, g1)):
            if i in twice:  # within one bf16 ulp of the leaf's largest value
                gap = (a.double() - b.double()).abs().max()
                assert gap <= 2.0 ** -7 * a.double().abs().max(), i
            else:
                assert np.array_equal(_bits(a), _bits(b)), i
        _, p0, o0, m0, g0 = _exact_run(mesh_shape, dtype, False, once=True)
    else:
        _, p0, o0, m0, g0 = _exact_run(mesh_shape, dtype, False)
    assert all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(g0, g1))
    for r in range(len(p0)):
        assert _same_bits(p0[r], p1[r]) and _same_bits(o0[r], o1[r]), r
    for a, b in zip(m0, m1):
        assert all(np.array_equal(_bits(a[k].float()), _bits(b[k].float())) for k in a), (a, b)
        assert float(b["overlap_modeled"]) == 0.0 and not bool(b["skipped"])


def test_cuda_threadmesh_refuses_overlap_and_keeps_fsdpstep(monkeypatch):
    cfg = registry.get(TRAIN_ARCH, smoke=True)
    mesh = ThreadMesh((2, 1), AXES, "cpu")
    setup = training.make_setup(cfg, mesh, overlap_sync=True)
    _, bspecs = shapes.train_specs(cfg, shapes.InputShape("t", 16, 2, "train"), mesh)
    on_card = types.SimpleNamespace(device=torch.device("cuda"), local_ranks=(0, 1),
                                    axis_names=mesh.axis_names, shape=mesh.shape)
    assert training._ranks_share_autograd_thread(on_card)
    with pytest.raises(NotImplementedError, match="C6") as err:
        training.make_train_step(dataclasses.replace(setup, mesh=on_card), bspecs)
    assert "DistMesh" in str(err.value) and "overlap_sync" in str(err.value)
    # the route goes by the predicate: FsdpStep where the ranks share
    # CUDA's autograd thread, else the in-backward route
    routes = []
    real = training._loss_and_grads

    def noting(*a, deferred):
        routes.append(deferred)
        return real(*a, deferred=deferred)

    monkeypatch.setattr(training, "_loss_and_grads", noting)
    setup = dataclasses.replace(setup, overlap_sync=False)
    whole = parallel.init_params(setup.defs, torch.Generator().manual_seed(0), "cpu")
    batch = next(SyntheticStream(cfg, 2, 16, seed=0))
    for shared in (False, True):
        monkeypatch.setattr(training, "_ranks_share_autograd_thread", lambda m, s=shared: s)
        params = _ranks(setup, whole)
        training.make_train_step(setup, bspecs)(params, [adamw.adamw_init(p) for p in params],
                                                batch)
    assert routes == [False, False, True, True]


def _hooked_loss(mesh_shape):
    """On every rank of a CPU ``ThreadMesh``: the hooked smoke loss (its
    graph built on the rank thread), the leaves and the token."""
    cfg = dataclasses.replace(registry.get(TRAIN_ARCH, smoke=True), dtype="float32")
    mesh = ThreadMesh(mesh_shape, AXES, "cpu")
    setup = training.make_setup(cfg, mesh, fsdp=False, bucket_bytes=HOOK_BUCKET * 8)
    _, bspecs = shapes.train_specs(cfg, shapes.InputShape("t", 16, 2, "train"), mesh)
    whole = parallel.init_params(setup.defs, torch.Generator().manual_seed(0), "cpu")
    whole = convert.tree_map(lambda p: p.to(torch.float32), whole)
    batch = next(SyntheticStream(cfg, 2, 16, seed=0))
    sizes, coords = training.mesh_axis_sizes(mesh), training._coords(mesh)

    def body(args):
        params, b = args
        leaves, rebuild = tree_flatten(params)
        req = [p.detach().requires_grad_(True) for p in leaves]
        tok = torch.zeros((), dtype=torch.float32, requires_grad=True)
        with torch.enable_grad():
            hooked, tok_out, _ = training._install_bucket_hooks(
                rebuild(req), setup.specs, AXES, {}, setup.bucket_bytes, tok)
            loss = setup.model.loss_fn(hooked, b) + 0.0 * tok_out
        return loss, req, tok

    return mesh.run(body, [(p, training._local(batch, bspecs, c, sizes))
                           for p, c in zip(_ranks(setup, whole), coords)])


def _grad_on_a_thread(loss, inputs, timeout=60):
    """``torch.autograd.grad`` on a new thread, which binds no rank: what
    it returned or raised."""
    out = []

    def target():
        try:
            out.append(torch.autograd.grad(loss, inputs))
        except BaseException as e:  # noqa: BLE001 - returned below
            out.append(e)

    t = threading.Thread(target=target, name="autograd-stand-in")
    t.start()
    t.join(timeout=timeout)
    assert not t.is_alive(), "the foreign-thread backward hung"
    return out[0]


def test_hook_backward_on_a_foreign_thread_finds_its_handles_on_one_rank():
    ((loss, req, tok),) = _hooked_loss((1, 1))
    assert not transport.bindings()
    got = _grad_on_a_thread(loss, req + [tok])
    assert not isinstance(got, BaseException), got
    ((loss, req2, tok2),) = _hooked_loss((1, 1))
    with torch.enable_grad():
        want = torch.autograd.grad(loss, req2 + [tok2])
    assert all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(got, want))


def test_hook_backward_on_a_foreign_thread_raises_on_two_ranks():
    ranks = _hooked_loss((2, 1))
    for loss, req, tok in ranks:
        err = _grad_on_a_thread(loss, req + [tok])
        assert isinstance(err, RuntimeError), err
        assert "C6" in str(err) and "DistMesh" in str(err)


# ---------------------------------------------------------------------------
# gloo: one process per rank, (data 2, model 2)
# ---------------------------------------------------------------------------


def _dist_setup(mesh):
    cfg = dataclasses.replace(registry.get(TRAIN_ARCH, smoke=True), dtype="float32")
    setup = training.make_setup(cfg, mesh, opt=opt_config(adamw.AdamWConfig), remat="full",
                                fsdp_gz=GZConfig(eb=1e-4, algo="ring"),
                                grad_gz=GZConfig(**TRAIN_GZ), overlap_sync=True,
                                bucket_bytes=DIST_BUCKET)
    _, bspecs = shapes.train_specs(cfg, shapes.InputShape("t", TRAIN_S, TRAIN_B, "train"),
                                   mesh)
    whole = parallel.init_params(setup.defs, torch.Generator().manual_seed(0), "cpu")
    whole = convert.tree_map(lambda p: p.to(torch.float32), whole)
    return setup, bspecs, whole, train_batches(cfg)


def _dist_run(setup, bspecs, whole, batches):
    """Every local rank's (params, opt state) after the steps, and each
    step's metrics."""
    sizes = training.mesh_axis_sizes(setup.mesh)
    coords = training._coords(setup.mesh)
    params = [convert.tree_map(torch.clone, training._local(whole, setup.specs, coords[r],
                                                            sizes))
              for r in setup.mesh.local_ranks]
    opt = [adamw.adamw_init(p) for p in params]
    step = training.make_train_step(setup, bspecs)
    metrics = []
    for batch in batches:
        params, opt, m = step(params, opt, batch)
        metrics.append(m)
    return params, opt, metrics


def _on_another_thread(grad):
    """``grad`` run on a thread of its own, as CUDA runs backward on the
    device's autograd thread: no rank handle is bound there."""

    def run(*a, **kw):
        out = []

        def target():
            try:
                out.append(grad(*a, **kw))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                out.append(e)

        t = threading.Thread(target=target, name="autograd-stand-in")
        t.start()
        t.join()
        if isinstance(out[0], BaseException):
            raise out[0]
        return out[0]

    return run


def _dist_child(rank: int, port: int, out_path: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=N, rank=rank)
    try:
        torch.autograd.grad = _on_another_thread(torch.autograd.grad)
        # the staging route the card's tensors take over gloo, on host tensors
        transport.DistGroup._stages = lambda self, device: True
        threads = set()
        real = training._BucketHook.backward

        def noting(ctx, *gs):
            threads.add(threading.current_thread().name)
            return real(ctx, *gs)

        training._BucketHook.backward = staticmethod(noting)
        mesh = transport.DistMesh(DIST_MESH, AXES, device="cpu")
        params, opt, metrics = _dist_run(*_dist_setup(mesh))
        res = {f"p/{i}": _bits(t) for i, t in enumerate(tree_flatten(params[0])[0])}
        res.update({f"o/{i}": _bits(t) for i, t in enumerate(tree_flatten(opt[0])[0])})
        for s, m in enumerate(metrics):
            res.update({f"m{s}/{k}": _bits(v.to(torch.float32)) for k, v in m.items()})
        res["threads"] = np.array(sorted(threads))
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_distmesh_overlapped_step_equals_the_threadmesh_by_bits():
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": SRC}
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(N)]
        procs = [subprocess.Popen([sys.executable, __file__, "dist", str(r), str(port),
                                   outs[r]], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True, env=env)
                 for r in range(N)]
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"gloo rank {r} failed:\n{logs[r]}"
        ranks = [dict(np.load(o)) for o in outs]
    setup, bspecs, whole, batches = _dist_setup(ThreadMesh(DIST_MESH, AXES, "cpu"))
    assert len(training._bucket_plan(tree_flatten(parallel.param_shapes(setup.defs))[0],
                                     training._leaf_specs(setup.defs, setup.specs), AXES,
                                     dict(setup.grad_comms), DIST_BUCKET)) > 2
    params, opt, metrics = _dist_run(setup, bspecs, whole, batches)
    for r in range(N):
        got = ranks[r]
        for i, t in enumerate(tree_flatten(params[r])[0]):
            assert np.array_equal(got[f"p/{i}"], _bits(t)), (r, "param", i)
        for i, t in enumerate(tree_flatten(opt[r])[0]):
            assert np.array_equal(got[f"o/{i}"], _bits(t)), (r, "opt", i)
        for s, m in enumerate(metrics):
            for k, v in m.items():
                assert np.array_equal(got[f"m{s}/{k}"], _bits(v.to(torch.float32))), (r, s, k)
        # the hooks' backward ran on the backward's own thread
        assert set(got["threads"].tolist()) == {"autograd-stand-in"}, got["threads"]
    assert not bool(metrics[-1]["skipped"])


# ---------------------------------------------------------------------------
# Against the JAX child
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["exact", "ring"])
@pytest.mark.parametrize("tag", ["clean", "nan"])
def test_hooks_equal_the_references_by_bits(child, case, tag):
    res = child.get()
    params, cts = hook_inputs(HOOK_LEAVES, 0)
    comms = {}
    if case == "ring":
        comms = {"data": GZCommunicator.for_config("data", GZConfig(**HOOK_GZ), axis_size=N,
                                                   device="cpu")}
    out = _port_hooks(("data",), None, HOOK_LEAVES, params,
                      cts if tag == "clean" else poisoned(cts), comms)
    want_tok = res[f"hook/{case}/{tag}/tok"]
    got_tok = np.array([float(o[1]) for o in out], np.float32)
    assert got_tok.tobytes() == want_tok.astype(np.float32).tobytes(), (got_tok, want_tok)
    if tag == "clean":
        assert not want_tok.any()
    else:
        assert want_tok.any()
    for k in HOOK_LEAVES:
        want = res[f"hook/{case}/{tag}/g/{k}"]
        for r, o in enumerate(out):
            got = o[0][k].float().numpy()
            # NaN where the reference has NaN, whatever its bits (torch's
            # vectorized cast to bf16 writes 0xFFFF for every NaN), the
            # rest by bits
            nan = np.isnan(want[r])
            assert np.array_equal(np.isnan(got), nan), (k, r)
            assert np.array_equal(got[~nan].view(np.int32), want[r][~nan].view(np.int32)), (k, r)


def test_two_axis_hooks_round_once_as_the_reference(child):
    res = child.get()
    params, cts = hook_inputs(TWO_AXIS_LEAVES, 1)
    out = _port_hooks(AXES, (2, 2), TWO_AXIS_LEAVES, params, cts, {})
    differs = 0
    for k in TWO_AXIS_LEAVES:
        for r, (g, tok, n, post, flag) in enumerate(out):
            assert np.array_equal(g[k].float().numpy().view(np.int32),
                                  res[f"two/g/{k}"][r].view(np.int32)), (k, r)
            assert np.array_equal(post[k].float().numpy().view(np.int32),
                                  res[f"two/post/{k}"][r].view(np.int32)), (k, r)
            differs += int((res[f"two/g/{k}"][r] != res[f"two/post/{k}"][r]).sum())
    assert not res["two/tok"].any()
    # the reference's own hooks and post-hoc sync part in bf16
    assert differs > 0


@pytest.mark.parametrize("family", list(PLAN_FAMILIES))
def test_bucket_plans_and_overlap_modeled_equal_the_references(child, family):
    plans = json.loads(str(child.get()["plans"]))
    cfg = cfg_of(registry, family)
    _, _, shape, fsdp = PLAN_FAMILIES[family]
    mesh = ThreadMesh(shape, AXES, "cpu")
    for bb in PLAN_BUCKETS:
        want = plans[f"{family}/{bb}"]
        setup = training.make_setup(cfg, mesh, grad_gz=GZConfig(**TRAIN_GZ),
                                    overlap_sync=True, bucket_bytes=bb, fsdp=fsdp)
        assert setup.bucket_bytes == want["bucket_bytes"], bb
        assert setup.overlap_plan.overlap_efficiency == want["eff"], bb
        leaves = tree_flatten(parallel.param_shapes(setup.defs))[0]
        plan = training._bucket_plan(leaves, training._leaf_specs(setup.defs, setup.specs),
                                     AXES, dict(setup.grad_comms), setup.bucket_bytes)
        got = [[[[ax, comm is not None] for ax, comm in ops], idx] for ops, idx in plan]
        assert len(plan) == want["n"] and got == want["buckets"], bb


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_overlapped_train_step_matches_the_reference(child, case):
    shape, fsdp = TRAIN_CASES[case]
    res = child.get()
    cfg = registry.get(TRAIN_ARCH, smoke=True)
    mesh = ThreadMesh(shape, AXES, "cpu")
    setup = training.make_setup(cfg, mesh, opt=opt_config(adamw.AdamWConfig),
                                grad_gz=GZConfig(**TRAIN_GZ), fsdp=fsdp, overlap_sync=True,
                                bucket_bytes=TRAIN_BUCKET)
    _, bspecs = shapes.train_specs(cfg, shapes.InputShape("t", TRAIN_S, TRAIN_B, "train"),
                                   mesh)
    step = training.make_train_step(setup, bspecs)
    leaves, rebuild = tree_flatten(setup.defs)
    p0 = [res[f"{case}/p0/{i}"] for i in range(len(leaves))]
    params = _ranks(setup, rebuild([torch.from_numpy(a.copy()) for a in p0]))
    opt = [adamw.adamw_init(p) for p in params]
    for s, batch in enumerate(train_batches(cfg)):
        params, opt, m = step(params, opt, batch)
        np.testing.assert_allclose(float(m["loss"]), res[f"{case}/m{s}/loss"], rtol=1e-5)
        np.testing.assert_allclose(float(m["gnorm"]), res[f"{case}/m{s}/gnorm"], rtol=1e-5)
        for k in ("lr", "overlap_modeled"):
            assert m[k].numpy().tobytes() == np.asarray(res[f"{case}/m{s}/{k}"],
                                                        np.float32).tobytes(), k
        assert not bool(m["skipped"]) and not bool(res[f"{case}/m{s}/skipped"])
    sizes, coords = training.mesh_axis_sizes(mesh), training._coords(mesh)
    final = training._global(params, setup.specs, coords, sizes)
    step_lrs = sum(float(res[f"{case}/m{s}/lr"]) for s in range(TRAIN_STEPS))
    for i, leaf in enumerate(tree_flatten(final)[0]):
        init = p0[i].astype(np.float64)
        ours = leaf.numpy().astype(np.float64) - init
        theirs = res[f"{case}/p/{i}"].astype(np.float64) - init
        assert np.all(np.abs(ours - theirs) <= step_lrs), i
        assert np.linalg.norm(ours - theirs) <= UPDATE_L2[case] * np.linalg.norm(theirs), i


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_child(sys.argv[2])
    else:
        _dist_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
