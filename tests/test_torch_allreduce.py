"""The port's allreduce against the JAX package's, rank by rank.

Every case runs the same seeded per-rank inputs through
``repro.core.comm.GZCommunicator.allreduce`` inside ``shard_map`` over N
host devices (the reference) and through ``repro_torch``'s communicator
over a ``ThreadGroup`` of N CPU ranks.  Outputs and the global overflow
flags must be bitwise equal, at N in {2, 3, 6, 8}, for recursive
doubling (with the remainder stage at N = 3, 6), the sequential ring,
the pipelined ring and the ``auto`` policy, with and without overflow,
for the two-pass codec (``fused=False``: redoub and the pipelined ring)
and the two-kernel hop (``fused_hop=False``: the pipelined ring), and
for the ``lorenzo+entropy``, ``lossless`` and ``passthrough`` codecs
(redoub and the pipelined ring; entropy also overflowing and two-pass).
One gloo ``DistGroup`` run at N = 3 must equal the ``ThreadGroup`` run.

The JAX side needs its device count set before jax is imported, so it
runs in a subprocess: this file under ``__main__`` (``jax`` mode), one
child per N computing every case, held in a module fixture.  The
``dist`` mode is one rank of the gloo run.
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
from repro_torch.core.collectives import GZConfig
from repro_torch.core.comm import GZCommunicator
from repro_torch.kernels import lorenzo

HERE = pathlib.Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
NS = (2, 3, 6, 8)

# name -> (algo, pipeline_chunks, data, eb, capacity_factor)
CASES = {
    "redoub": ("redoub", 1, "smooth", 1e-4, 0.6),
    "ring": ("ring", 1, "smooth", 1e-4, 0.6),
    "ring_p2": ("ring", 2, "smooth", 1e-4, 0.6),
    "auto": ("auto", 1, "smooth", 1e-4, 0.6),
    "redoub_overflow": ("redoub", 1, "rough", 1e-6, 0.05),
    "ring_p2_overflow": ("ring", 2, "rough", 1e-6, 0.05),
    "redoub_unfused": ("redoub", 1, "smooth", 1e-4, 0.6),
    "ring_p2_unfused": ("ring", 2, "smooth", 1e-4, 0.6),
    "ring_p2_two_kernel_hop": ("ring", 2, "smooth", 1e-4, 0.6),
    "redoub_entropy": ("redoub", 1, "smooth", 1e-4, 0.6),
    "ring_p2_entropy": ("ring", 2, "smooth", 1e-4, 0.6),
    "redoub_entropy_unfused": ("redoub", 1, "smooth", 1e-4, 0.6),
    "ring_p2_entropy_overflow": ("ring", 2, "rough", 1e-6, 0.05),
    "redoub_lossless": ("redoub", 1, "rough", 1e-4, 0.6),
    "ring_p2_lossless": ("ring", 2, "smooth", 1e-4, 0.6),
    "redoub_passthrough": ("redoub", 1, "smooth", 1e-4, 0.6),
    "ring_p2_passthrough": ("ring", 2, "rough", 1e-4, 0.6),
}
# The two-pass knobs of the cases that set them.
TWO_PASS = {
    "redoub_unfused": dict(fused=False),
    "ring_p2_unfused": dict(fused=False),
    "ring_p2_two_kernel_hop": dict(fused_hop=False),
    "redoub_entropy_unfused": dict(fused=False),
}
# The wire codec of the cases that are not ``lorenzo``.
CODEC = {case: codec for case in CASES
         for key, codec in (("entropy", "lorenzo+entropy"), ("lossless", "lossless"),
                            ("passthrough", "passthrough")) if key in case}


def per_rank_elems(n: int) -> int:
    return 1500 * n + 37  # ragged: no chunk or piece boundary is aligned


def inputs(n: int, case: str) -> np.ndarray:
    """(n, D) f32 per-rank inputs, the same in every process."""
    kind = CASES[case][2]
    rng = np.random.default_rng(1000 * n + sorted(CASES).index(case))
    d = per_rank_elems(n)
    if kind == "smooth":  # random-walk fields, the paper's RTM-like regime
        return np.cumsum(rng.normal(0, 0.01, (n, d)), axis=1).astype(np.float32)
    return rng.normal(0, 100.0, (n, d)).astype(np.float32)


def config_kwargs(case: str) -> dict:
    algo, chunks, _, eb, cf = CASES[case]
    return dict(eb=eb, algo=algo, pipeline_chunks=chunks, capacity_factor=cf,
                codec=CODEC.get(case, "lorenzo"), **TWO_PASS.get(case, {}))


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
    from repro.core.collectives import GZConfig
    from repro.core.comm import GZCommunicator
    from repro.core.shmap import shard_map

    mesh = jax.make_mesh((n,), ("x",))
    res = {}
    for case in CASES:
        comm = GZCommunicator("x", config=GZConfig(**config_kwargs(case)),
                              hw=cost_model.A100_SLINGSHOT, axis_size=n)

        def body(x, comm=comm):
            r = comm.allreduce(x[0])
            return r.value[None], r.overflow[None]

        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("x", None),),
                              out_specs=(P("x", None), P("x"))))
        out, ovf = f(inputs(n, case))
        res[f"{case}/out"] = np.asarray(out)
        res[f"{case}/overflow"] = np.asarray(ovf)
        res[f"{case}/algo"] = np.asarray(
            comm.plan("allreduce", (per_rank_elems(n),)).algo)
    np.savez(out_path, **res)


def _dist_child(n: int, rank: int, port: int, out_path: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        g = transport.DistGroup()
        res = {}
        for case in ("redoub", "ring_p2"):
            comm = GZCommunicator("x", config=GZConfig(**config_kwargs(case)),
                                  axis_size=n, device="cpu")
            x = torch.from_numpy(inputs(n, case)[rank])
            with g.bind("x"):
                r = comm.allreduce(x)
            res[f"{case}/out"] = r.value.numpy()
            res[f"{case}/overflow"] = r.overflow.numpy()
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def _child_env(**extra):
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu", **extra}
    return env


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """N -> the JAX package's results for every case (one child per N,
    all started together)."""
    tmp = tmp_path_factory.mktemp("jax_allreduce")
    procs = {}
    for n in NS:
        out = tmp / f"ref_{n}.npz"
        procs[n] = (out, subprocess.Popen(
            [sys.executable, __file__, "jax", str(n), str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_child_env()))
    results = {}
    for n, (out, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"JAX child N={n} failed:\n{log}"
        with np.load(out) as z:
            results[n] = {k: z[k] for k in z.files}
    return results


def _port_allreduce(n, case):
    xs = [torch.from_numpy(x) for x in inputs(n, case)]
    comm = GZCommunicator("x", config=GZConfig(**config_kwargs(case)),
                          axis_size=n, device="cpu")
    res = transport.ThreadGroup(n, "cpu").run(comm.allreduce, xs, axis_name="x")
    out = np.stack([r.value.numpy() for r in res])
    ovf = np.stack([bool(r.overflow) for r in res])
    return out, ovf, comm.plan("allreduce", xs[0].shape).algo


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n", NS)
def test_threadgroup_allreduce_bitwise_equals_jax(jax_results, n, case):
    ref = jax_results[n]
    out, ovf, algo = _port_allreduce(n, case)
    assert algo == str(ref[f"{case}/algo"])
    assert out.dtype == np.float32 and out.shape == ref[f"{case}/out"].shape
    mism = int((out.view(np.int32) != ref[f"{case}/out"].view(np.int32)).sum())
    assert mism == 0, f"N={n} {case}: {mism} elements differ"
    np.testing.assert_array_equal(ovf, ref[f"{case}/overflow"])
    assert ovf.all() == case.endswith("overflow")


def test_threadgroup_stress_exchanges_and_counts():
    """More ranks than cores and a short switch interval: every exchange
    delivers exactly its sender's tensors (zeros where no pair addresses
    the rank), the flags OR across ranks, and no launch count is lost."""
    n, rounds = 16, 40

    def perm(k):
        return tuple((i, (i + 1 + k) % n) for i in range(n) if (i + k) % 3)

    def body(x):
        g = transport.current("x")
        got = []
        for k in range(rounds):
            (y,) = g.exchange((x + k,), perm(k))
            got.append(int(y[0]))
            lorenzo._count("quantize_pack")
        flag, = g.flags_across(torch.tensor(g.rank == 5))
        return got, bool(flag)

    results = []
    old = sys.getswitchinterval()
    lorenzo.reset_launch_counts()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=lambda: results.append(
            transport.ThreadGroup(n, "cpu").run(
                body, [torch.full((3,), r) for r in range(n)])))
        t.start()
        t.join(timeout=120)
        assert not t.is_alive(), "ThreadGroup deadlocked"
        assert lorenzo.LAUNCHES["quantize_pack"] == n * rounds
    finally:
        sys.setswitchinterval(old)
        lorenzo.reset_launch_counts()
    for r, (got, flag) in enumerate(results[0]):
        assert flag
        for k in range(rounds):
            s = (r - 1 - k) % n
            assert got[k] == (s + k if (s + k) % 3 else 0), (r, k)


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
    for case in ("redoub", "ring_p2"):
        out, ovf, _ = _port_allreduce(n, case)
        for r in range(n):
            np.testing.assert_array_equal(
                ranks[r][f"{case}/out"].view(np.int32), out[r].view(np.int32))
            assert bool(ranks[r][f"{case}/overflow"]) == bool(ovf[r])


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "jax":
        _jax_child(int(sys.argv[2]), sys.argv[3])
    else:
        _dist_child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                    sys.argv[5])
    sys.exit(0)
