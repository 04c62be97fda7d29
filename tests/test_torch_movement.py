"""The port's data-movement collectives against the JAX package's, rank by
rank.

Every case runs the same seeded per-rank inputs through
``repro.core.comm.GZCommunicator`` inside ``shard_map`` over N host
devices (the reference) and through ``repro_torch``'s communicator over a
``ThreadGroup`` of N CPU ranks.  Outputs and the global overflow and
non-finite flags must be bitwise equal:

* ``scatter`` at N in {2, 3, 5, 6, 8, 9} (the trimmed tree at 3, 5, 6, 9),
  with one and two piece exchanges per slab;
* ``broadcast`` at N in {3, 6, 8};
* ``allgather`` and ``reduce_scatter`` at N in {3, 6, 8}, sequential and
  pipelined (P = 2);
* ``all_to_all`` at N in {3, 8};
* each op once with ``fused=False`` and once overflowing;
* scatter, broadcast, allgather and all_to_all at N in {2, 3, 6, 8}
  under ``lorenzo+entropy`` (also overflowing and two-pass), and under
  ``lossless`` and ``passthrough``, the per-chunk compressor path.

Non-root scatter and broadcast inputs hold a NaN: only the root's payload
is significant, so neither package may raise the non-finite flag.  Also
here: the port's trimmed scatter equals its padded virtual-tree walk on
every real rank, the ``all_to_all`` gradient equals the JAX
``custom_vjp`` gradient (and a ThreadGroup rank's backward run on a
foreign thread raises instead of hanging, ROADMAP C6), and one gloo ``DistGroup`` run of scatter and
``all_to_all`` at N = 3 equals the ``ThreadGroup`` run.

The JAX side needs its device count set before jax is imported, so it
runs in subprocesses: this file under ``__main__`` (``jax`` mode), one
child per N, all started together and held in a module fixture.
"""
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import transport
from repro_torch.core.collectives import GZConfig, _execute_scatter
from repro_torch.core.comm import GZCommunicator

HERE = pathlib.Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")

SMOOTH = ("smooth", 1e-4, 0.6)
ROUGH = ("rough", 1e-6, 0.05)  # overflows at capacity_factor 0.05

# name -> (op, axis sizes, pipeline_chunks, fused, (data, eb, capacity_factor))
CASES = {
    "scatter": ("scatter", (2, 3, 5, 6, 8, 9), 1, True, SMOOTH),
    "scatter_p2": ("scatter", (2, 3, 5, 6, 8, 9), 2, True, SMOOTH),
    "scatter_unfused": ("scatter", (6,), 1, False, SMOOTH),
    "scatter_overflow": ("scatter", (5,), 1, True, ROUGH),
    "broadcast": ("broadcast", (3, 6, 8), 1, True, SMOOTH),
    "broadcast_unfused": ("broadcast", (6,), 1, False, SMOOTH),
    "broadcast_overflow": ("broadcast", (3,), 1, True, ROUGH),
    "allgather": ("allgather", (3, 6, 8), 1, True, SMOOTH),
    "allgather_p2": ("allgather", (3, 6, 8), 2, True, SMOOTH),
    "allgather_unfused": ("allgather", (8,), 2, False, SMOOTH),
    "allgather_overflow": ("allgather", (3,), 1, True, ROUGH),
    "reduce_scatter": ("reduce_scatter", (3, 6, 8), 1, True, SMOOTH),
    "reduce_scatter_p2": ("reduce_scatter", (3, 6, 8), 2, True, SMOOTH),
    "reduce_scatter_unfused": ("reduce_scatter", (6,), 1, False, SMOOTH),
    "reduce_scatter_overflow": ("reduce_scatter", (8,), 2, True, ROUGH),
    "all_to_all": ("all_to_all", (3, 8), 1, True, SMOOTH),
    "all_to_all_unfused": ("all_to_all", (3,), 1, False, SMOOTH),
    "all_to_all_overflow": ("all_to_all", (8,), 1, True, ROUGH),
    "scatter_entropy": ("scatter", (2, 3, 6, 8), 1, True, SMOOTH),
    "scatter_entropy_unfused": ("scatter", (3,), 2, False, SMOOTH),
    "scatter_entropy_overflow": ("scatter", (6,), 1, True, ROUGH),
    "scatter_lossless": ("scatter", (3, 8), 2, True, ROUGH),
    "scatter_passthrough": ("scatter", (6,), 1, True, SMOOTH),
    "broadcast_entropy": ("broadcast", (2, 3, 6, 8), 1, True, SMOOTH),
    "broadcast_lossless": ("broadcast", (3,), 1, True, SMOOTH),
    "broadcast_passthrough": ("broadcast", (8,), 1, True, ROUGH),
    "allgather_entropy": ("allgather", (2, 3, 6, 8), 2, True, SMOOTH),
    "allgather_lossless": ("allgather", (6,), 1, False, ROUGH),
    "allgather_passthrough": ("allgather", (3,), 2, True, SMOOTH),
    "reduce_scatter_entropy": ("reduce_scatter", (3, 8), 2, True, SMOOTH),
    "all_to_all_entropy": ("all_to_all", (2, 3, 6, 8), 1, True, SMOOTH),
    "all_to_all_entropy_overflow": ("all_to_all", (3,), 1, True, ROUGH),
    "all_to_all_lossless": ("all_to_all", (2, 8), 1, True, ROUGH),
    "all_to_all_passthrough": ("all_to_all", (6,), 1, True, SMOOTH),
}
# The wire codec of the cases that are not ``lorenzo``.
CODEC = {case: codec for case in CASES
         for key, codec in (("entropy", "lorenzo+entropy"), ("lossless", "lossless"),
                            ("passthrough", "passthrough")) if key in case}
ROOTED = ("scatter", "broadcast")
NS = sorted({n for _, ns, *_ in CASES.values() for n in ns})
PARAMS = [(n, case) for case, (_, ns, *_) in CASES.items() for n in ns]
GRAD_N = 3


def per_rank_elems(op: str, n: int) -> int:
    """Ragged per-rank payloads: no chunk, block or piece boundary aligns."""
    if op in ("scatter", "reduce_scatter", "all_to_all"):
        return n * 1537  # n chunks of 1537 elements
    return 1500 * n + 37


def config_kwargs(case: str) -> dict:
    _, _, chunks, fused, (_, eb, cf) = CASES[case]
    return dict(eb=eb, pipeline_chunks=chunks, fused=fused, capacity_factor=cf,
                codec=CODEC.get(case, "lorenzo"))


def inputs(n: int, case: str) -> np.ndarray:
    """(n, D) f32 per-rank inputs, the same in every process."""
    op, _, _, _, (kind, _, _) = CASES[case]
    rng = np.random.default_rng(1000 * n + sorted(CASES).index(case))
    d = per_rank_elems(op, n)
    if kind == "smooth":  # random-walk fields
        x = np.cumsum(rng.normal(0, 0.01, (n, d)), axis=1).astype(np.float32)
    else:
        x = rng.normal(0, 100.0, (n, d)).astype(np.float32)
    if op in ROOTED:
        x[1:, 5] = np.nan  # junk on the non-roots must not count
    return x


def grad_inputs(n: int):
    rng = np.random.default_rng(77)
    d = per_rank_elems("all_to_all", n)
    x = np.cumsum(rng.normal(0, 0.01, (n, d)), axis=1).astype(np.float32)
    w = rng.normal(0, 1.0, (n, d)).astype(np.float32)
    return x, w


# ---------------------------------------------------------------------------
# Subprocess modes
# ---------------------------------------------------------------------------


def _jax_child(n: int, out_path: str) -> None:
    sys.path.insert(0, str(HERE))
    from _child_env import pin_device_count

    pin_device_count(n)
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.core import cost_model
    from repro.core.collectives import GZConfig as JGZConfig
    from repro.core.comm import GZCommunicator as JComm
    from repro.core.shmap import shard_map

    mesh = jax.make_mesh((n,), ("x",))
    res = {}
    for case, (op, ns, *_) in CASES.items():
        if n not in ns:
            continue
        comm = JComm("x", config=JGZConfig(**config_kwargs(case)),
                     hw=cost_model.A100_SLINGSHOT, axis_size=n)

        def body(x, comm=comm, op=op):
            r = getattr(comm, op)(x[0])
            return r.value[None], r.overflow[None], r.nonfinite[None]

        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("x", None),),
                              out_specs=(P("x", None), P("x"), P("x"))))
        out, ovf, nonfinite = f(inputs(n, case))
        res[f"{case}/out"] = np.asarray(out)
        res[f"{case}/overflow"] = np.asarray(ovf)
        res[f"{case}/nonfinite"] = np.asarray(nonfinite)
    if n == GRAD_N:
        comm = JComm("x", hw=cost_model.A100_SLINGSHOT, axis_size=n)

        def grad_body(x, w):
            _, vjp = jax.vjp(lambda v: comm.all_to_all(v).value, x[0])
            return vjp(w[0])[0][None]

        f = jax.jit(shard_map(grad_body, mesh=mesh,
                              in_specs=(P("x", None), P("x", None)),
                              out_specs=P("x", None)))
        res["a2a_grad"] = np.asarray(f(*grad_inputs(n)))
    np.savez(out_path, **res)


def _dist_child(n: int, rank: int, port: int, out_path: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        g = transport.DistGroup()
        res = {}
        for case in ("scatter", "all_to_all"):
            comm = GZCommunicator("x", config=GZConfig(**config_kwargs(case)),
                                  axis_size=n, device="cpu")
            x = torch.from_numpy(inputs(n, case)[rank])
            with g.bind("x"):
                r = getattr(comm, case)(x)
            res[f"{case}/out"] = r.value.numpy()
            res[f"{case}/overflow"] = r.overflow.numpy()
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def _child_env(**extra):
    return {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu", **extra}


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """N -> the JAX package's results for every case at N (one child per
    N, all started together)."""
    tmp = tmp_path_factory.mktemp("jax_movement")
    procs = {}
    for n in NS:
        out = tmp / f"ref_{n}.npz"
        procs[n] = (out, subprocess.Popen(
            [sys.executable, __file__, "jax", str(n), str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_child_env()))
    results = {}
    for n, (out, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        assert proc.returncode == 0, f"JAX child N={n} failed:\n{log}"
        with np.load(out) as z:
            results[n] = {k: z[k] for k in z.files}
    return results


def _port(n, case, group=None):
    op = CASES[case][0]
    xs = [torch.from_numpy(x) for x in inputs(n, case)]
    comm = GZCommunicator("x", config=GZConfig(**config_kwargs(case)),
                          axis_size=n, device="cpu")
    res = (group or transport.ThreadGroup(n, "cpu")).run(getattr(comm, op), xs)
    out = np.stack([r.value.numpy() for r in res])
    ovf = np.stack([bool(r.overflow) for r in res])
    nonfinite = np.stack([bool(r.nonfinite) for r in res])
    return out, ovf, nonfinite


def _assert_bitwise(got, want, what):
    assert got.dtype == np.float32 and got.shape == want.shape, what
    mism = int((got.view(np.int32) != want.view(np.int32)).sum())
    assert mism == 0, f"{what}: {mism} elements differ"


@pytest.mark.parametrize("n,case", PARAMS)
def test_threadgroup_bitwise_equals_jax(jax_results, n, case):
    ref = jax_results[n]
    out, ovf, nonfinite = _port(n, case)
    _assert_bitwise(out, ref[f"{case}/out"], f"N={n} {case}")
    np.testing.assert_array_equal(ovf, ref[f"{case}/overflow"])
    np.testing.assert_array_equal(nonfinite, ref[f"{case}/nonfinite"])
    assert ovf.all() == case.endswith("overflow")
    assert not nonfinite.any()


@pytest.mark.parametrize("n", (3, 5, 6, 9))
def test_trimmed_scatter_equals_padded_walk(n):
    """Every real rank decodes the same bytes from the trimmed tree and
    the padded virtual tree, with one and two piece exchanges per slab."""
    xs = [torch.from_numpy(x) for x in inputs(n, "scatter")]
    group = transport.ThreadGroup(n, "cpu")
    for chunks in (1, 2):
        cfg = GZConfig(pipeline_chunks=chunks)

        def run(x, padded):
            g = transport.current("x")
            return _execute_scatter(x, g, cfg, _padded_reference=padded)[0]

        trimmed = group.run(lambda x: run(x, False), xs)
        padded = group.run(lambda x: run(x, True), xs)
        for r in range(n):
            _assert_bitwise(trimmed[r].numpy(), padded[r].numpy(), f"rank {r}")


def test_all_to_all_gradient_equals_jax(jax_results):
    n = GRAD_N
    x, w = grad_inputs(n)
    comm = GZCommunicator("x", axis_size=n, device="cpu")

    def body(args):
        xr, wr = args
        xr = xr.clone().requires_grad_()
        comm.all_to_all(xr).value.backward(wr)
        return xr.grad

    grads = transport.ThreadGroup(n, "cpu").run(
        body, [(torch.from_numpy(x[r]), torch.from_numpy(w[r])) for r in range(n)])
    _assert_bitwise(np.stack([gr.numpy() for gr in grads]),
                    jax_results[n]["a2a_grad"], "a2a gradient")


def test_all_to_all_backward_on_a_foreign_thread_raises():
    """ROADMAP C6: a ThreadGroup rank's all_to_all backward that runs on
    another thread than the rank's own (what the autograd engine does with
    CUDA tensors) raises naming DistGroup instead of waiting forever."""
    n = 2
    comm = GZCommunicator("x", config=GZConfig(), axis_size=n, device="cpu")
    xs = [torch.linspace(0, 1, 512) + r for r in range(n)]
    outs = []

    def fwd(x):
        x = x.clone().requires_grad_(True)
        outs.append(comm.all_to_all(x).value.sum())
        return True

    assert transport.ThreadGroup(n, "cpu").run(fwd, xs) == [True, True]
    errors = []

    def foreign():
        try:
            outs[0].backward()
        except RuntimeError as e:
            errors.append(str(e))

    t = threading.Thread(target=foreign)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "backward hung"
    assert errors and "DistGroup" in errors[0]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_distgroup_equals_threadgroup():
    n, port = 3, _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, __file__, "dist", str(n), str(r), str(port), outs[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_child_env()) for r in range(n)]
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"gloo rank {r} failed:\n{logs[r]}"
        ranks = [dict(np.load(o)) for o in outs]
    for case in ("scatter", "all_to_all"):
        out, ovf, _ = _port(n, case)
        for r in range(n):
            _assert_bitwise(ranks[r][f"{case}/out"], out[r], f"{case} rank {r}")
            assert bool(ranks[r][f"{case}/overflow"]) == bool(ovf[r])


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "jax":
        _jax_child(int(sys.argv[2]), sys.argv[3])
    else:
        _dist_child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                    sys.argv[5])
    sys.exit(0)
