"""The tensor-parallel train step (ROADMAP A11.7b, train half) against the
JAX package, on the CPU.

``launch.training.make_train_step`` at ``tp_size > 1``, with FSDP over
``data``: on a CPU ``ThreadMesh`` every rank's backward runs on its own
thread, and on a gloo ``transport.DistMesh`` each process is one rank.

One JAX child, pinned to 4 host devices and started when this module's
first test runs, computes every reference value while the port-only
tests run, on a ``(data 2, model 2)`` mesh:

  * for each family, the reference's loss and its gradients under
    ``shard_map`` (jitted), with ``fsdp_size`` 2 and ``tp_size`` 2, f32
    weights (its init from ``key(0)``, carried across with
    ``convert.params_from_jax``), the gradients synced by its own
    ``_sync_grads`` (every leaf summed over each axis absent from its
    spec): dense (minitron-8b), moe (phi3.5-moe at capacity factor 8, as
    the reference's model-parallel child), moe with the compressed
    dispatch (two experts, top-1, so that each tensor rank owns one
    expert and the dispatch is compressed; its backward is the compressed
    all-to-all of the cotangent), hybrid (zamba2-2.7b: the ssm blocks
    and the shared attention, the SSD chunk cut to 8), MLA (minicpm3-4b),
    encdec (seamless-m4t-medium: the encoder and the cross attention),
    vlm (internvl2-26b) and audio (vlm's config as the audio family: the
    reference has no audio config);
  * three runs of the jitted ``make_train_step`` of minitron-8b's smoke
    config, 2 steps each, ``grad_gz`` ring at eb 1e-4: f32 with the
    weights sharded over ``data`` and replicated, and bf16 sharded.

Tolerances:

  * each rank's loss: rel 1e-5 of the reference's (another summation
    order in the GEMMs, as ``tests/test_torch_tp.py``; measured at most
    3.0e-7, 1.2e-6 through the compressed dispatch);
  * every synced gradient leaf: within 1e-4 of that leaf's largest
    |value| (measured at most 4.4e-6, the hybrid's ``w_bc``), and within
    0.1 of it through the compressed dispatch (measured 2.0e-2, ``ln2``).
    Why the dispatch needs more: its quantizer rounds each value to a
    grid of 2 eb = 2e-4, and the two packages' dispatch inputs differ in
    their last bits (the GEMMs' summation orders; 3-5e-7 of the largest
    value in the first layer), so a few codes land one step apart (1-4
    of 16,384 a rank in the first layer, up to 336 in the second, where
    the first layer's steps have spread); the gradients follow those
    steps, the cotangent's own compressed trip adding a few more.  The
    exact dispatch on the same weights agrees to 1.3e-6, and the
    compression itself moves the gradients by 4-7 % of their largest
    values in both packages; 0.1 is the reference child's own gradient
    bound for the dense families (0.35 for moe);
  * the train steps: ``tests/test_torch_train.py``'s bounds (ROADMAP
    C15): losses rel 1e-5 in f32 and 2e-3 in bf16 (measured 6.8e-8 and
    1.5e-4); per leaf, the L2 of the difference of the two packages'
    parameter updates at most 1e-3 of the reference's update in f32
    (measured 1.4e-4 sharded, 3.3e-5 replicated) and 0.25 in bf16
    (measured 0.127), no element off by more than the sum of the steps'
    learning rates (bf16: twice that plus one bf16 ulp; measured 0.03 of
    that bound in f32 and 0.96 in bf16, where AdamW's nearly sign-like
    first steps move one element the other way, as C15 says).

Port-only: a gloo ``DistMesh`` of four processes (no JAX) runs two f32
steps of the same train step, remat full, the FSDP gathers and
reduce-scatters and the norms' sync compressed, each process's backward
on a second thread (as CUDA's autograd thread runs it: remat's recompute
there must find the forward's rank handles) and every ``DistGroup``
operation through the staging route the card takes over gloo (here host
to host), equal by bits to the CPU ``ThreadMesh`` run in parameters,
AdamW state and metrics; the refusal of a CUDA ``ThreadMesh`` at tp > 1,
through its predicate.
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
import types  # noqa: E402

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core.collectives import GZConfig
from repro_torch.core.grad_sync import tree_flatten
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.launch import shapes, training
from repro_torch.launch.mesh import ThreadMesh
from repro_torch.models import parallel
from repro_torch.optim import adamw

HERE = pathlib.Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
AXES = ("data", "model")
MESH = (2, 2)
N = MESH[0] * MESH[1]
GZ_EB = 1e-4  # the dispatch's eb (benchmarks/moe_a2a_ablation.py's)
SSM_CHUNK = 8
PHI = "phi3.5-moe-42b-a6.6b"
# family: (arch, ModelConfig overrides)
FAMILIES = {
    "dense": ("minitron-8b", {}),
    "moe": (PHI, {"capacity_factor": 8.0}),
    "moe-gz": (PHI, {"capacity_factor": 8.0, "n_experts": 2, "top_k": 1,
                     "moe_dispatch_gz_eb": GZ_EB}),
    "hybrid": ("zamba2-2.7b", {}),
    "mla": ("minicpm3-4b", {}),
    "encdec": ("seamless-m4t-medium", {}),
    "vlm": ("internvl2-26b", {}),
    "audio": ("internvl2-26b", {"family": "audio", "arch_id": "audio-smoke"}),
}
B, S = 4, 16  # text tokens; the vlm and audio batches add their prefix rows
LOSS_RTOL = 1e-5
GRAD_TOL = {"moe-gz": 0.1}  # of each leaf's largest |value|; 1e-4 for the others
TRAIN_ARCH = "minitron-8b"
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 4, 32, 2, 1e-3
TRAIN_GZ = dict(eb=1e-4, algo="ring", on_overflow="fallback")
TRAIN_CASES = {"fsdp": (True, "float32"), "replicated": (False, "float32"),
               "fsdp-bf16": (True, "bfloat16")}


def cfg_of(reg, family, dtype="float32"):
    """``family``'s smoke config in ``reg`` (either package's registry),
    with ``cfg.dtype`` ``dtype`` and the SSD chunk ``SSM_CHUNK``."""
    arch, kw = FAMILIES[family]
    cfg = reg.get(arch, smoke=True)
    kw = dict(kw, dtype=dtype)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, chunk=SSM_CHUNK)
    return dataclasses.replace(cfg, **kw)


def batch_of(cfg, family):
    rng = np.random.default_rng(list(FAMILIES).index(family))
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    batch["labels"][:, :2] = -1
    if cfg.family in ("vlm", "audio"):
        batch["prefix"] = rng.normal(0, 1, (B, cfg.n_prefix, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["enc_input"] = rng.normal(0, 1, (B, cfg.n_prefix, cfg.d_model)).astype(
            np.float32)
    return batch


def batch_specs(batch) -> dict:
    return {k: ("data",) + (None,) * (v.ndim - 1) for k, v in batch.items()}


def opt_config(cls):
    return cls(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)


def train_batches(cfg):
    stream = SyntheticStream(cfg, TRAIN_B, TRAIN_S, seed=0)
    return [next(stream) for _ in range(TRAIN_STEPS)]


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
    import concurrent.futures
    import time

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.configs import registry as jregistry
    from repro.core.collectives import GZConfig as JGZConfig
    from repro.core.shmap import shard_map
    from repro.launch import shapes as jshapes
    from repro.launch import training as jtraining
    from repro.models import model as jmodel
    from repro.models import parallel as jparallel
    from repro.optim import adamw as jadamw

    res = {}
    t0 = time.perf_counter()
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(MESH), AXES)
    scale = 1.0 / N  # 1 / (tp * n_dp), the reference's train step's

    key = jax.random.key(0)

    def init(defs, dtype):
        # one compiled draw (the same bits as the eager one), compiled on the
        # pool below with the rest; its abstract result is what gets traced
        f = jax.jit(lambda k: jax.tree.map(lambda a: a.astype(dtype),
                                           jparallel.init_params(defs, k)))
        return f, jax.eval_shape(f, key)

    # (name, jitted function, its arguments' shapes, what to run with the
    # compiled function): each traced here, all compiled at once on a pool
    # (XLA compiles off the GIL), then run in turn
    jobs = []
    for fam in FAMILIES:
        cfg = cfg_of(jregistry, fam)
        draw, shaped = init(jmodel.Model(cfg, jparallel.ParallelCtx()).param_defs(),
                            jnp.float32)
        ctx = jparallel.ParallelCtx(tp_size=MESH[1], fsdp_size=MESH[0], dp_axes=("data",),
                                    remat="none")
        model = jmodel.Model(cfg, ctx)
        specs = jparallel.param_specs(model.param_defs())
        batch = batch_of(cfg, fam)
        bspecs = {k: P(*v) for k, v in batch_specs(batch).items()}

        def body(p, b, model=model, specs=specs):
            loss, g = jax.value_and_grad(lambda q: model.loss_fn(q, b) * scale)(p)
            g, _ = jtraining._sync_grads(g, specs, AXES, {})
            return (loss / scale)[None], g

        def run(f, draw, fam=fam, batch=batch):
            p32 = draw(key)
            for path, a in _paths(jax.tree.map(np.asarray, p32)):
                res[f"w/{fam}/{path}"] = a
            loss, grads = f(p32, batch)
            res[f"loss/{fam}"] = np.asarray(loss)
            for path, a in _paths(jax.tree.map(np.asarray, grads)):
                res[f"g/{fam}/{path}"] = a

        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(specs, bspecs),
                              out_specs=(P(AXES), specs)))
        jobs.append((fam, (f, draw), ((shaped, batch), (key,)), run))

    cfg = jregistry.get(TRAIN_ARCH, smoke=True)
    _, bspecs = jshapes.train_specs(cfg, jshapes.InputShape("t", TRAIN_S, TRAIN_B, "train"),
                                    mesh)
    batches = train_batches(cfg)
    for name, (fsdp, dtype) in TRAIN_CASES.items():
        setup = jtraining.make_setup(cfg, mesh, opt=opt_config(jadamw.AdamWConfig),
                                     grad_gz=JGZConfig(**TRAIN_GZ), fsdp=fsdp)
        draw, shaped = init(setup.defs, jnp.dtype(dtype))

        def run(step, draw, name=name):
            params = draw(key)
            res.update({f"{name}/p0/{i}": np.asarray(a.astype(jnp.float32))
                        for i, a in enumerate(jax.tree.leaves(params))})
            opt = jadamw.adamw_init(params)
            for s, batch in enumerate(batches):
                params, opt, m = step(params, opt, batch)
                for k, v in m.items():
                    res[f"{name}/m{s}/{k}"] = np.asarray(v)
            for i, a in enumerate(jax.tree.leaves(params)):
                res[f"{name}/p/{i}"] = np.asarray(a.astype(jnp.float32))

        args = (shaped, jax.eval_shape(jadamw.adamw_init, shaped), batches[0])
        jobs.append((f"train {name}", (jtraining.make_train_step(setup, bspecs), draw),
                     (args, (key,)), run))

    lowered = [(name, [f.lower(*a) for f, a in zip(fs, args)], run)
               for name, fs, args, run in jobs]
    print(f"{time.perf_counter() - t0:7.2f} s traced", flush=True)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        compiled = [pool.map(lambda lo: lo.compile(), los) for _, los, _ in lowered]
        compiled = [list(c) for c in compiled]
    print(f"{time.perf_counter() - t0:7.2f} s compiled", flush=True)
    for (name, _, run), fns in zip(lowered, compiled):
        run(*fns)
        print(f"{time.perf_counter() - t0:7.2f} s {name}", flush=True)
    np.savez(out_path, **res)


class _Child:
    """The JAX child (``script jax OUT``), started with the module's first
    test; its results are read when a test first asks for them."""

    def __init__(self, tmp):
        env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
        env.pop("GZ_CHILD_DEVICES", None)
        self._out = tmp / "tp_train.npz"
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

    def tree(self, prefix) -> dict:
        """The global f32 tree stored under ``prefix/``, as torch tensors."""
        res, pre = self.get(), f"{prefix}/"
        return convert.params_from_jax(
            _unflatten({k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}), "cpu")

    def close(self):
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def child(tmp_path_factory):
    kid = _Child(tmp_path_factory.mktemp("jax_tp_train"))
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
    """Every rank's ``_local`` block of the global tree (copies)."""
    sizes = training.mesh_axis_sizes(setup.mesh)
    return [convert.tree_map(torch.clone, training._local(whole, setup.specs, c, sizes))
            for c in training._coords(setup.mesh)]


def port_loss_and_grads(cfg, whole, batch):
    """Every rank's loss (unscaled) and the global synced gradient tree, as
    the train step computes them before AdamW: ``_loss_and_grads`` (remat
    full: each layer recomputed in backward, its TP collectives too) and
    ``_sync_grads``."""
    setup = training.make_setup(cfg, ThreadMesh(MESH, AXES, "cpu"), remat="full")
    assert (setup.ctx.tp_size, setup.ctx.fsdp_size) == (MESH[1], MESH[0])
    sizes, coords = training.mesh_axis_sizes(setup.mesh), training._coords(setup.mesh)
    bspecs = batch_specs(batch)
    scale = 1.0 / N

    def body(args):
        params, b = args
        loss, grads = training._loss_and_grads(setup.model, setup.ctx, params, setup.specs,
                                               b, scale)
        grads, degraded = training._sync_grads(tree_flatten(params)[1](grads), setup.specs,
                                               AXES, {})
        assert not bool(degraded)
        return float(loss) / scale, grads

    out = setup.mesh.run(body, [(p, training._local(batch, bspecs, c, sizes))
                                for p, c in zip(_ranks(setup, whole), coords)])
    losses = np.array([o[0] for o in out], np.float32)
    return losses, training._global([o[1] for o in out], setup.specs, coords, sizes)


# ---------------------------------------------------------------------------
# Port-only (they run while the child works)
# ---------------------------------------------------------------------------


def test_cuda_threadmesh_refusal_goes_by_its_predicate():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    share = training._ranks_share_autograd_thread
    # several ranks of one process on the card: one autograd thread for all
    assert share(types.SimpleNamespace(device=cuda, local_ranks=(0, 1, 2, 3)))
    # a DistMesh process runs one rank; the CPU runs backward on each rank's thread
    assert not share(types.SimpleNamespace(device=cuda, local_ranks=(2,)))
    assert not share(types.SimpleNamespace(device=cpu, local_ranks=(0, 1, 2, 3)))
    cfg = registry.get(TRAIN_ARCH, smoke=True)
    mesh = ThreadMesh(MESH, AXES, "cpu")
    setup = training.make_setup(cfg, mesh)
    _, bspecs = shapes.train_specs(cfg, shapes.InputShape("t", 16, 2, "train"), mesh)
    training.make_train_step(setup, bspecs)  # the CPU ThreadMesh trains
    on_card = types.SimpleNamespace(device=cuda, local_ranks=mesh.local_ranks,
                                    axis_names=mesh.axis_names, shape=mesh.shape)
    with pytest.raises(NotImplementedError, match="C6") as err:
        training.make_train_step(dataclasses.replace(setup, mesh=on_card), bspecs)
    assert "DistMesh" in str(err.value)


def test_step_takes_one_tree_per_local_rank():
    cfg = registry.get(TRAIN_ARCH, smoke=True)
    mesh = ThreadMesh(MESH, AXES, "cpu")
    setup = training.make_setup(cfg, mesh)
    _, bspecs = shapes.train_specs(cfg, shapes.InputShape("t", 16, 2, "train"), mesh)
    step = training.make_train_step(setup, bspecs)
    assert mesh.local_ranks == (0, 1, 2, 3)
    with pytest.raises(ValueError, match=r"per local rank \(4\)"):
        step([{}], [{}], {})


# ---------------------------------------------------------------------------
# gloo: one process per rank, (data 2, model 2)
# ---------------------------------------------------------------------------


def _dist_setup(mesh):
    cfg = dataclasses.replace(registry.get(TRAIN_ARCH, smoke=True), dtype="float32")
    setup = training.make_setup(cfg, mesh, opt=opt_config(adamw.AdamWConfig), remat="full",
                                fsdp_gz=GZConfig(eb=1e-4, algo="ring"),
                                grad_gz=GZConfig(**TRAIN_GZ))
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

    from repro_torch.core import transport

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=N,
                            rank=rank)
    try:
        torch.autograd.grad = _on_another_thread(torch.autograd.grad)
        # the staging route the card's tensors take over gloo, on host tensors
        transport.DistGroup._stages = lambda self, device: True
        threads = set()
        real = parallel.ParallelCtx._tp_handle

        def noting(self):
            threads.add(threading.current_thread().name)
            return real(self)

        parallel.ParallelCtx._tp_handle = noting
        mesh = transport.DistMesh(MESH, AXES, device="cpu")
        assert mesh.local_ranks == (rank,)
        params, opt, metrics = _dist_run(*_dist_setup(mesh))
        res = {f"p/{i}": _bits(t) for i, t in enumerate(tree_flatten(params[0])[0])}
        res.update({f"o/{i}": _bits(t) for i, t in enumerate(tree_flatten(opt[0])[0])})
        for s, m in enumerate(metrics):
            res.update({f"m{s}/{k}": _bits(v.to(torch.float32)) for k, v in m.items()})
        res["staged"] = np.int64(mesh.staged()[0])
        res["threads"] = np.array(sorted(threads))
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_distmesh_train_step_equals_the_threadmesh_by_bits():
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
    params, opt, metrics = _dist_run(*_dist_setup(ThreadMesh(MESH, AXES, "cpu")))
    for r in range(N):
        got = ranks[r]
        for i, t in enumerate(tree_flatten(params[r])[0]):
            assert np.array_equal(got[f"p/{i}"], _bits(t)), (r, "param", i)
        for i, t in enumerate(tree_flatten(opt[r])[0]):
            assert np.array_equal(got[f"o/{i}"], _bits(t)), (r, "opt", i)
        for s, m in enumerate(metrics):
            for k, v in m.items():
                assert np.array_equal(got[f"m{s}/{k}"], _bits(v.to(torch.float32))), (r, s, k)
        assert int(got["staged"]) > 0
        # the recompute's TP collectives ran on the backward's own thread
        assert "autograd-stand-in" in set(got["threads"].tolist()), got["threads"]


# ---------------------------------------------------------------------------
# Against the JAX child
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_synced_gradients_match_the_references(child, family):
    cfg = cfg_of(registry, family)
    res = child.get()
    losses, grads = port_loss_and_grads(cfg, child.tree(f"w/{family}"), batch_of(cfg, family))
    want = res[f"loss/{family}"]
    assert np.all(np.abs(losses - want) <= LOSS_RTOL * np.abs(want)), (losses, want)
    pre = f"g/{family}/"
    ref = _unflatten({k[len(pre):]: v for k, v in res.items() if k.startswith(pre)})
    got, want = dict(_paths(grads)), dict(_paths(ref))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = want[path]
        assert tuple(g.shape) == w.shape, path
        gap = float(np.abs(g.numpy().astype(np.float64) - w).max())
        assert gap <= GRAD_TOL.get(family, 1e-4) * max(float(np.abs(w).max()), 1e-30), \
            (path, gap)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_matches_the_references(child, case):
    fsdp, dtype = TRAIN_CASES[case]
    res = child.get()
    cfg = registry.get(TRAIN_ARCH, smoke=True)
    mesh = ThreadMesh(MESH, AXES, "cpu")
    setup = training.make_setup(cfg, mesh, opt=opt_config(adamw.AdamWConfig),
                                grad_gz=GZConfig(**TRAIN_GZ), fsdp=fsdp)
    assert setup.ctx.tp_size == MESH[1] and setup.ctx.fsdp_size == (MESH[0] if fsdp else 1)
    _, bspecs = shapes.train_specs(cfg, shapes.InputShape("t", TRAIN_S, TRAIN_B, "train"),
                                   mesh)
    step = training.make_train_step(setup, bspecs)
    leaves, rebuild = tree_flatten(setup.defs)
    p0 = [res[f"{case}/p0/{i}"] for i in range(len(leaves))]
    td = parallel.torch_dtype(dtype)
    whole = rebuild([torch.from_numpy(a.copy()).to(td) for a in p0])
    params = _ranks(setup, whole)
    opt = [adamw.adamw_init(p) for p in params]
    rel = {"float32": 1e-5, "bfloat16": 2e-3}[dtype]
    for s, batch in enumerate(train_batches(cfg)):
        params, opt, m = step(params, opt, batch)
        np.testing.assert_allclose(float(m["loss"]), res[f"{case}/m{s}/loss"], rtol=rel)
        if dtype == "float32":
            np.testing.assert_allclose(float(m["gnorm"]), res[f"{case}/m{s}/gnorm"], rtol=rel)
        assert m["lr"].numpy().tobytes() == np.asarray(res[f"{case}/m{s}/lr"],
                                                       np.float32).tobytes()
        assert not bool(m["skipped"]) and not bool(res[f"{case}/m{s}/skipped"])
    sizes, coords = training.mesh_axis_sizes(mesh), training._coords(mesh)
    final = training._global(params, setup.specs, coords, sizes)
    step_lrs = sum(float(res[f"{case}/m{s}/lr"]) for s in range(TRAIN_STEPS))
    l2 = {"float32": 1e-3, "bfloat16": 0.25}[dtype]
    for i, leaf in enumerate(tree_flatten(final)[0]):
        init = p0[i].astype(np.float64)
        theirs_final = res[f"{case}/p/{i}"]
        ours = leaf.float().numpy().astype(np.float64) - init
        theirs = theirs_final.astype(np.float64) - init
        slack = step_lrs
        if dtype == "bfloat16":  # one bf16 ulp of the element (f32 spacing x 2^16)
            slack = 2 * slack + np.spacing(np.abs(theirs_final)).astype(np.float64) * 2.0 ** 16
        assert np.all(np.abs(ours - theirs) <= slack), i
        assert np.linalg.norm(ours - theirs) <= l2 * np.linalg.norm(theirs), i


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_child(sys.argv[2])
    else:
        _dist_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
