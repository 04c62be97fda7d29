"""The training CLI's ``DistMesh`` route (ROADMAP A11.8b) on the CPU.

``repro_torch.launch.train.train`` under torchrun's environment runs one
process a rank of a gloo ``transport.DistMesh``; without it, the
``ThreadMesh`` route it had.  The module's first test starts, together:

  * ``python -m torch.distributed.run --nproc-per-node 2`` on this file
    (``cli``): each process runs the CLI (smoke config, ``--device cpu``,
    ``--grad-gz ring``, 3 steps, ``--ckpt-every 2``, a relative
    ``--ckpt-dir``) and writes its stdout and losses;
  * a JAX child pinned to 2 host devices (``jax``): the reference's CLI,
    ``repro.launch.train.train``, with the same argv (but for the port's
    ``--device``), its ``init_params`` handing it the port's weights
    drawn from the same seed (each package draws its own otherwise);

and, in this process while they run, the ``ThreadMesh`` route's CLI with
the host's device count taken as 2 (as ``tests/test_torch_train.py``
takes it), from a directory of its own with the same relative
``--ckpt-dir``.  Checks: each process's losses equal by bits to the
``ThreadMesh`` route's, its stdout equal but for the wall field, the
checkpoint equal file by file, the reference's ``checkpoint.restore``
reading it by bits.

Tolerance against the reference, ``tests/test_torch_train.py``'s bf16
bounds (ROADMAP C15: the smoke config's weights are bf16, and XLA keeps
f32 between the bf16 ops it fuses under ``jit`` where the port rounds
after each eager op; C21: the losses are held against the jitted
reference): every step's loss within rel 2e-3 (measured 5.6e-5, 7.6e-5
and 7.9e-5); the checkpoint's parameters after two steps, leaf by leaf,
the update's difference from the reference CLI's checkpoint's within
0.25 of the reference's update by L2 (measured 0.125 at most), and no
element off by more than twice the steps' learning rates plus one bf16
ulp (AdamW's nearly sign-like first steps, C15; measured 0.89 of that).

In this process: the refusals (a batch the world does not split, NCCL
with two local ranks on one card, NCCL on the CPU, a partial torchrun
environment, ``--dist-backend`` without torchrun) raising before any
process group is made; the route without torchrun's environment; a
world of one process, a one-rank gloo ``DistMesh``, equal by bits to the
one-rank ``ThreadMesh`` CLI; the checkpoint's gather building the global
tree on process 0 alone.
"""
import contextlib
import importlib
import io
import json
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import types

if __name__ == "__main__" and sys.argv[1] == "jax":  # pin before JAX loads
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from _child_env import pin_device_count

    pin_device_count(2)

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.checkpoint import checkpoint
from repro_torch.configs import registry
from repro_torch.core.grad_sync import tree_flatten
from repro_torch.launch import training
from repro_torch.launch.mesh import ThreadMesh
from repro_torch.models import parallel

HERE = pathlib.Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
AXES = ("data", "model")
ARGV = ["--smoke", "--steps", "3", "--batch", "2", "--seq", "32", "--grad-gz", "ring",
        "--ckpt-every", "2", "--ckpt-dir", "ckpt"]
PORT_ARGV = ARGV + ["--device", "cpu"]
N = 2
LOSS_RTOL = 2e-3  # the bf16 loss bound against the jitted reference (module docstring)
UPDATE_L2 = 0.25  # a leaf's update against the reference's, by L2 (C15, bf16)
CKPT_STEP = 2
ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

cli = importlib.import_module("repro_torch.launch.train")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _port_weights(cfg):
    """The global tree the CLI draws from seed 0 at ``data`` 2."""
    setup = training.make_setup(cfg, ThreadMesh((N, 1), AXES, "cpu"))
    return parallel.init_params(setup.defs, torch.Generator().manual_seed(0), "cpu")


def _cli_child(out: str) -> None:
    """One torchrun process: the CLI, its stdout and losses to ``out``."""
    rank = os.environ["RANK"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        losses = cli.train(PORT_ARGV)
    pathlib.Path(out, f"stdout{rank}.txt").write_text(buf.getvalue())
    pathlib.Path(out, f"losses{rank}.json").write_text(json.dumps(losses))


def _jax_child(out: str) -> None:
    """The reference CLI on 2 host devices with the port's weights."""
    import jax
    import jax.numpy as jnp

    from repro.launch import train as jtrain
    from repro.optim import adamw

    cfg = registry.get("minitron-8b", smoke=True)
    whole = convert.params_to_numpy(_port_weights(cfg))
    jtrain.init_params = lambda defs, key: jax.tree.map(jnp.asarray, whole)
    os.chdir(out)
    losses = jtrain.train(ARGV)
    pathlib.Path(out, "losses_jax.json").write_text(json.dumps([float(x) for x in losses]))
    # the learning rate of each update before the checkpoint (the CLI's
    # AdamWConfig; update s runs at schedule step s + 1)
    opt = adamw.AdamWConfig(lr=3e-4, total_steps=3, warmup_steps=1)
    lrs = [float(adamw.cosine_schedule(opt, jnp.asarray(s + 1))) for s in range(CKPT_STEP)]
    pathlib.Path(out, "lrs_jax.json").write_text(json.dumps(lrs))


def _kill(proc):
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.communicate()


def _wait(proc, what, timeout=240):
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        _kill(proc)
        raise AssertionError(f"{what} outlived {timeout} s")
    assert proc.returncode == 0, f"{what} failed (exit {proc.returncode}):\n{log[-6000:]}"


def _child_env():
    env = {k: v for k, v in os.environ.items() if k not in ENV}
    env["PYTHONPATH"] = SRC
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("GZ_CHILD_DEVICES", None)
    return env


def _threadmesh_cli(argv, cwd, device_count):
    """The ``ThreadMesh`` route's CLI from ``cwd`` with the host's device
    count taken as ``device_count``: (stdout, losses)."""
    real_count, here = cli._device_count, os.getcwd()
    cli._device_count = lambda device: device_count
    os.chdir(cwd)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            losses = cli.train(argv)
    finally:
        os.chdir(here)
        cli._device_count = real_count
    return buf.getvalue(), losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The torchrun pair, the JAX child and the ``ThreadMesh`` route."""
    tmp = tmp_path_factory.mktemp("train_cli")
    dist_dir, thread_dir, jax_dir = (tmp / "dist", tmp / "thread", tmp / "jax")
    for d in (dist_dir, thread_dir, jax_dir):
        d.mkdir()
    env = _child_env()
    kw = dict(stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
              start_new_session=True)
    jax_proc = subprocess.Popen([sys.executable, __file__, "jax", str(jax_dir)], **kw)
    # torchrun tears the group down when a process fails, so no process
    # is left waiting in a gloo call for a peer that died
    pair = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(N),
         "--master-addr", "127.0.0.1", "--master-port", str(_free_port()), __file__, "cli",
         str(dist_dir)], cwd=dist_dir, **kw)
    try:
        thread_out, thread_losses = _threadmesh_cli(PORT_ARGV, thread_dir, N)
        _wait(pair, "the torchrun pair")
        _wait(jax_proc, "the JAX child", timeout=300)
    finally:
        _kill(pair)
        _kill(jax_proc)
    yield {
        "dist": [(pathlib.Path(dist_dir, f"stdout{r}.txt").read_text(),
                  json.loads(pathlib.Path(dist_dir, f"losses{r}.json").read_text()))
                 for r in range(N)],
        "thread": (thread_out, thread_losses),
        "jax": json.loads(pathlib.Path(jax_dir, "losses_jax.json").read_text()),
        "jax_lrs": json.loads(pathlib.Path(jax_dir, "lrs_jax.json").read_text()),
        "dist_ckpt": dist_dir / "ckpt", "thread_ckpt": thread_dir / "ckpt",
        "jax_ckpt": jax_dir / "ckpt",
    }


def _bits(losses) -> list:
    return [np.float32(x).view(np.int32).item() for x in losses]


def _no_wall(text: str) -> str:
    return re.sub(r"\(\d+\.\ds\)$", "(wall)", text, flags=re.M)


def _same_files(a: pathlib.Path, b: pathlib.Path) -> list:
    """The files under ``a`` (relative paths), each equal by bytes to its
    namesake under ``b``, and no file of ``b`` missing from ``a``."""
    names = sorted(str(p.relative_to(a)) for p in a.rglob("*") if p.is_file())
    assert names == sorted(str(p.relative_to(b)) for p in b.rglob("*") if p.is_file())
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
    return names


@pytest.mark.parametrize("rank", range(N))
def test_distmesh_losses_equal_the_threadmesh_route_by_bits(runs, rank):
    _, losses = runs["dist"][rank]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert _bits(losses) == _bits(runs["thread"][1])


@pytest.mark.parametrize("rank", range(N))
def test_distmesh_stdout_equals_the_threadmesh_route_but_for_the_wall(runs, rank):
    out, _ = runs["dist"][rank]
    lines = out.splitlines()
    assert lines[0] == ("arch=minitron-smoke params=0.4M mesh={'data': 2, 'model': 1} "
                        "grad_gz=ring")
    assert "  ckpt -> ckpt/step_00000002" in lines
    assert _no_wall(out) == _no_wall(runs["thread"][0])


def test_distmesh_checkpoint_equals_the_threadmesh_route_file_by_file(runs):
    names = _same_files(runs["dist_ckpt"], runs["thread_ckpt"])
    assert "step_00000002/manifest.json" in names and len(names) > 10


def test_reference_restores_the_distmesh_checkpoint_by_bits(runs):
    import jax

    from repro.checkpoint import checkpoint as jcheckpoint

    cfg = registry.get("minitron-8b", smoke=True)
    whole = _port_weights(cfg)
    like = {"params": whole, "opt": {"mu": whole, "nu": whole,
                                     "step": torch.zeros((), dtype=torch.int32)}}
    ours = checkpoint.restore(str(runs["dist_ckpt"]), 2, like, device="cpu")
    assert int(ours["opt"]["step"]) == 2
    ours = convert.params_to_numpy(ours)
    theirs = jcheckpoint.restore(str(runs["dist_ckpt"]), 2,
                                 jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), ours))
    a_leaves, b_leaves = jax.tree.leaves(ours), jax.tree.leaves(theirs)
    assert len(a_leaves) == len(b_leaves) > 10
    for a, b in zip(a_leaves, b_leaves):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_step0_loss_against_the_reference_cli(runs):
    ours, theirs = runs["dist"][0][1][0], runs["jax"][0]
    assert abs(ours - theirs) <= LOSS_RTOL * abs(theirs), (ours, theirs)


@pytest.mark.parametrize("step", [1, 2])
def test_later_losses_against_the_reference_cli(runs, step):
    """After the route's sync, sharded AdamW and (before step 2) its
    checkpoint gather have acted."""
    ours, theirs = runs["dist"][0][1][step], runs["jax"][step]
    assert abs(ours - theirs) <= LOSS_RTOL * abs(theirs), (ours, theirs)


def _restored_params(ckpt, like):
    import jax

    from repro.checkpoint import checkpoint as jcheckpoint

    like = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), like)
    return jax.tree.leaves(jcheckpoint.restore(str(ckpt), CKPT_STEP, {"params": like})["params"])


def test_distmesh_checkpoint_against_the_reference_cli_checkpoint(runs):
    """Each parameter's update over the two steps before the checkpoint
    against the reference CLI's (module docstring's bounds)."""
    import jax

    cfg = registry.get("minitron-8b", smoke=True)
    init = convert.params_to_numpy(_port_weights(cfg))
    ours, theirs = (_restored_params(runs[k], init) for k in ("dist_ckpt", "jax_ckpt"))
    init = [np.asarray(a).astype(np.float64) for a in jax.tree.leaves(init)]
    assert len(ours) == len(theirs) == len(init) > 10
    step_lrs = sum(runs["jax_lrs"])
    for i, (a, b, p0) in enumerate(zip(ours, theirs, init)):
        b = np.asarray(b)
        mine, ref = np.asarray(a).astype(np.float64) - p0, b.astype(np.float64) - p0
        # one bf16 ulp of the element: its f32 spacing x 2^16
        slack = 2 * step_lrs + np.spacing(np.abs(b.astype(np.float32))).astype(np.float64) \
            * 2.0 ** 16
        assert np.all(np.abs(mine - ref) <= slack), i
        assert np.linalg.norm(mine - ref) <= UPDATE_L2 * np.linalg.norm(ref), i


@pytest.mark.parametrize("rank", [0, 1])
def test_checkpoint_gather_builds_the_tree_on_process_0_alone(monkeypatch, rank):
    """Every process takes part in each leaf's gather; process 0 alone
    assembles the global tree, the others drop each gathered leaf."""
    cfg = registry.get("minitron-8b", smoke=True)
    thread = ThreadMesh((N, 1), AXES, "cpu")
    setup = training.make_setup(cfg, thread)
    whole = _port_weights(cfg)
    sizes, coords = training.mesh_axis_sizes(thread), training._coords(thread)
    blocks = [training._local(whole, setup.specs, c, sizes) for c in coords]
    leaves = [tree_flatten(b)[0] for b in blocks]
    calls = []

    class Group:  # the whole mesh's handle: every rank's block of the leaf
        def all_gather(self, xs):
            i = len(calls)
            calls.append(i)
            assert xs[0] is leaves[rank][i]
            return (torch.stack([ranks[i] for ranks in leaves]),)

    if rank:
        def no_global(*a, **k):
            raise AssertionError("a process other than 0 assembled a leaf")

        monkeypatch.setattr(cli, "_global", no_global)
    mesh = types.SimpleNamespace(rank=rank, handles={AXES: Group()}, axis_names=AXES,
                                 shape=(N, 1))
    got = cli._gathered_global(mesh, blocks[rank], setup.specs)
    assert calls == list(range(len(leaves[0])))
    if rank:
        assert got is None
        return
    for a, b in zip(tree_flatten(got)[0], tree_flatten(whole)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# In this process
# ---------------------------------------------------------------------------


@pytest.fixture
def no_group(monkeypatch):
    """No process group may be made, nor a card chosen; torchrun's
    environment cleared."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)

    def refuse(*a, **k):
        raise AssertionError("a process group was made")

    monkeypatch.setattr(cli.dist, "init_process_group", refuse)
    monkeypatch.setattr(torch.cuda, "set_device", refuse)
    yield monkeypatch
    assert not dist.is_initialized()


def _torchrun(monkeypatch, rank, world, local, local_world):
    for k, v in zip(ENV, (rank, world, local, local_world, "127.0.0.1", _free_port())):
        monkeypatch.setenv(k, str(v))


@pytest.mark.parametrize("case", ["batch", "nccl-shared-card", "nccl-cpu"])
def test_refusals_raise_before_any_process_group(no_group, case):
    argv = ["--smoke", "--batch", "2", "--steps", "1", "--seq", "32"]
    if case == "batch":  # data 2 of a world of 4
        _torchrun(no_group, 0, 4, 0, 4)
        argv += ["--device", "cpu"]
        want = r"--batch 2 splits over 2 data ranks, not over the world's 4 processes"
    elif case == "nccl-shared-card":  # nccl by default on cuda
        _torchrun(no_group, 1, 2, 1, 2)
        no_group.setattr(torch.cuda, "is_available", lambda: True)
        no_group.setattr(torch.cuda, "device_count", lambda: 1)
        want = r"nccl with 2 local ranks on 1 card.*C24.*--dist-backend gloo"
    else:
        _torchrun(no_group, 0, 2, 0, 2)
        argv += ["--device", "cpu", "--dist-backend", "nccl"]
        want = r"nccl carries CUDA tensors only.*--dist-backend gloo"
    with pytest.raises(ValueError, match=want):
        cli.train(argv)


def test_partial_torchrun_environment_raises(no_group):
    no_group.setenv("RANK", "0")
    no_group.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="incomplete.*LOCAL_RANK, LOCAL_WORLD_SIZE, "
                                         "MASTER_ADDR, MASTER_PORT missing"):
        cli.train(["--smoke", "--device", "cpu"])
    no_group.delenv("RANK")
    no_group.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="--dist-backend applies under torchrun"):
        cli.train(["--smoke", "--device", "cpu", "--dist-backend", "gloo"])


def test_without_torchrun_the_cli_builds_a_threadmesh(no_group):
    made = []

    class Recording(ThreadMesh):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    def no_distmesh(*a, **k):
        raise AssertionError("a DistMesh was built")

    no_group.setattr(cli, "ThreadMesh", Recording)
    no_group.setattr(cli, "DistMesh", no_distmesh)
    with contextlib.redirect_stdout(io.StringIO()):
        losses = cli.train(["--smoke", "--device", "cpu", "--steps", "1", "--batch", "2",
                            "--seq", "32"])
    assert len(made) == 1 and made[0].shape == (1, 1) and made[0].device.type == "cpu"
    assert len(losses) == 1 and np.isfinite(losses).all()


def test_world_of_one_process_equals_the_one_rank_threadmesh_by_bits(no_group, tmp_path):
    made = []

    class Recording(cli.DistMesh):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    argv = ["--smoke", "--steps", "2"] + PORT_ARGV[3:]
    (tmp_path / "thread").mkdir()
    (tmp_path / "dist").mkdir()
    thread_out, thread_losses = _threadmesh_cli(argv, tmp_path / "thread", 1)
    no_group.undo()  # this test makes a group of its own
    _torchrun(no_group, 0, 1, 0, 1)
    no_group.setattr(cli, "DistMesh", Recording)
    no_group.chdir(tmp_path / "dist")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        losses = cli.train(argv)
    assert not dist.is_initialized()
    assert len(made) == 1 and made[0].shape == (1, 1) and made[0].local_ranks == (0,)
    assert _bits(losses) == _bits(thread_losses)
    assert _no_wall(buf.getvalue()) == _no_wall(thread_out)
    _same_files(tmp_path / "dist" / "ckpt", tmp_path / "thread" / "ckpt")


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_child(sys.argv[2])
    else:
        _cli_child(sys.argv[2])
