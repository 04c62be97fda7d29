"""The port's degradation layer against the JAX package's.

The same seeded per-rank inputs and the same ``FaultSpec`` go through
``repro.core.comm.GZCommunicator`` inside ``shard_map`` over N host
devices (the reference) and through ``repro_torch``'s communicator on a
``ThreadGroup`` of N CPU ranks, at N in {3, 4, 8}.  Results and flags
must be bitwise equal, rank by rank, for:

  * the ``fallback`` policy under a forced capacity overflow: allreduce
    (redoub, ring, ring at 2 pieces, intring), reduce_scatter, allgather,
    scatter, broadcast and all_to_all;
  * ``flag`` mode on the same overflow (reports only);
  * the clean path under ``verify_streams`` (no flag, the compressed
    result);
  * NaN and Inf input poisoning and the ``overflow`` fault kind;
  * wire bitflips: silent without ``verify_streams``, detected and
    recovered with it, and aimed at schedule rounds (1,), (0, R - 1) and
    (R + 7,) of the redoub table (R rounds);
  * the health counters, and the gradient sync's fallback buckets;
  * the gradient through a degraded ``all_to_all`` under ``fallback``
    (``comm._LosslessAllToAll``): the port's ``torch.autograd.grad``
    against the reference's ``jax.grad`` through its ``lax.cond``, under a
    forced overflow of finite data and with a NaN and an Inf in one rank's
    input (their gradient 0), with the forward's value and flags.

Also here: ``_tree_checksum`` bits, ``FaultSpec`` validation and
``poison_np`` against the reference's; that the wire hook never writes
into the sender's tensor; the ``raise`` policy's message against the
reference's ``_raise_degraded`` with every rank returning; the CPU math
initialization that ``ThreadGroup.run`` does before its rank threads
start; one gloo ``DistGroup`` run at N = 3 equal to the ``ThreadGroup``
run; and the degraded ``all_to_all``'s gradient on a gloo ``DistMesh`` of
two processes equal to the ``ThreadGroup``'s.

The JAX side runs in two subprocesses per N (this file under ``__main__``,
``jax`` mode), as in ``tests/test_torch_allreduce.py``; ``dist`` mode is
one rank of the gloo run, ``dist-grad`` mode one rank of the gloo
gradient run, ``first-math`` mode the fresh process of the CPU math check.
"""
import contextlib
import json
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

from repro_torch import convert
from repro_torch.core import collectives, comm, faults, grad_sync, schedule, transport
from repro_torch.core.collectives import GZConfig
from repro_torch.core.comm import GZCommunicator
from repro_torch.core.compressor import EntropyLorenzo, ErrorBoundedLorenzo, Passthrough

HERE = pathlib.Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
NS = (3, 4, 8)
D = 512  # per-rank elements (the reference's faults child's)

# Rough data and a starved capacity overflow every stream; smooth data
# and a roomy capacity never do.
OVF = dict(eb=1e-6, capacity_factor=0.02, on_overflow="fallback")
OK = dict(eb=1e-3, capacity_factor=1.2, on_overflow="fallback")
WIRE = dict(eb=1e-3, capacity_factor=0.6, algo="redoub")

# name -> (op, GZConfig kwargs, data, FaultSpec kwargs or None)
CASES = {
    "allreduce_redoub_fallback": ("allreduce", dict(OVF, algo="redoub"), "rough", None),
    "allreduce_ring_fallback": ("allreduce", dict(OVF, algo="ring"), "rough", None),
    "allreduce_ring_p2_fallback": ("allreduce", dict(OVF, algo="ring", pipeline_chunks=2),
                                   "rough", None),
    "allreduce_intring_fallback": ("allreduce", dict(OVF, algo="intring"), "rough", None),
    "allreduce_flag": ("allreduce", dict(OVF, algo="redoub", on_overflow="flag"), "rough",
                       None),
    "allreduce_redoub_clean_verify": ("allreduce", dict(OK, algo="redoub",
                                                        verify_streams=True), "smooth", None),
    "allreduce_ring_p2_clean_verify": ("allreduce", dict(OK, algo="ring", pipeline_chunks=2,
                                                         verify_streams=True), "smooth", None),
    "reduce_scatter_fallback": ("reduce_scatter", OVF, "rough", None),
    "allgather_fallback": ("allgather", OVF, "rough", None),
    "scatter_fallback": ("scatter", OVF, "root", None),
    "broadcast_fallback": ("broadcast", OVF, "root", None),
    "all_to_all_fallback": ("all_to_all", OVF, "rough", None),
    "poison_nan": ("allreduce", dict(OK, algo="redoub"), "smooth",
                   dict(kind="nan", ranks=(1,), seed=7, n=5)),
    "poison_inf": ("allreduce", dict(OK, algo="redoub"), "smooth",
                   dict(kind="inf", ranks=(1,), seed=7, n=5)),
    "fault_kind_overflow": ("allreduce", dict(eb=1e-3, capacity_factor=0.8, algo="redoub",
                                              on_overflow="fallback"), "smooth",
                            dict(kind="overflow", ranks=(0, 2), seed=11)),
    "fault_kind_overflow_clean": ("allreduce", dict(eb=1e-3, capacity_factor=0.8,
                                                    algo="redoub", on_overflow="fallback"),
                                  "smooth", None),
}
# Cases whose flags must be (overflow, nonfinite) on every rank.  (A ring
# at N = 8 cuts D into 64-element chunks, too small for these capacities:
# the clean and poisoned cases run redoub.)
FLAGS = {
    "allreduce_redoub_clean_verify": (False, False),
    "allreduce_ring_p2_clean_verify": (False, False),
    "poison_nan": (False, True),
    "poison_inf": (False, True),
    "fault_kind_overflow_clean": (False, False),
}
# The degraded all_to_all under grad: case -> GZConfig kwargs.  Rough
# data overflows the starved capacity; smooth data with a NaN and an Inf
# on rank 1 degrades on its non-finite flag alone.
GRAD_A2A = {"a2a_grad_overflow": OVF, "a2a_grad_nonfinite": OK}
GRAD_A2A_BAD = {5: np.nan, 77: np.inf}  # rank 1's poisoned positions
BITFLIP_SEEDS = 24
GRAD_SHAPES = {"w": (64, 40), "b": [(3000,), (7,)]}  # 2 buckets of 4096
GRAD_SYNC = dict(eb=1e-9, algo="redoub", capacity_factor=0.02, on_overflow="fallback")


def _rng(n, name):
    return np.random.default_rng([n, sum(map(ord, name))])


def inputs(n: int, case: str) -> np.ndarray:
    """(n, d) f32 per-rank inputs, the same in every process."""
    op, _, kind, _ = CASES[case] if case in CASES else ("allreduce", None, case, None)
    rng = _rng(n, case)
    d = n * 128 if op in ("reduce_scatter", "scatter", "all_to_all") else \
        128 if op == "allgather" else D
    if kind == "smooth":
        return np.cumsum(rng.normal(0, 0.01, (n, d)), axis=1).astype(np.float32)
    xs = rng.normal(0, 100.0, (n, d)).astype(np.float32)
    if kind == "root":  # only the root's payload is significant
        xs[1:] = 0.0
    return xs


def grad_tree(n):
    rng = _rng(n, "grad")

    def leaf(shape):
        return rng.normal(0, 100.0, (n,) + tuple(shape)).astype(np.float32)

    return {"w": leaf(GRAD_SHAPES["w"]), "b": [leaf(s) for s in GRAD_SHAPES["b"]]}


def grad_a2a_inputs(n, case):
    """(inputs, cotangents), each (n, n * 128) f32, the same in every
    process."""
    rng = _rng(n, case)
    d = n * 128
    if case == "a2a_grad_overflow":
        xs = rng.normal(0, 100.0, (n, d)).astype(np.float32)
    else:
        xs = np.cumsum(rng.normal(0, 0.01, (n, d)), axis=1).astype(np.float32)
        for i, v in GRAD_A2A_BAD.items():
            xs[1, i] = v
    return xs, rng.normal(0, 1.0, (n, d)).astype(np.float32)


def port_grad_a2a(x, ct, n, case):
    """This rank's (gradient, value, overflow, nonfinite) of ``sum(ct *
    all_to_all(x).value)`` through the port's communicator, on the handle
    bound to ``"x"``."""
    c = GZCommunicator("x", config=GZConfig(**GRAD_A2A[case]), axis_size=n, device="cpu")
    x = x.clone().requires_grad_(True)
    with torch.enable_grad():
        r = c.all_to_all(x)
        (gx,) = torch.autograd.grad(torch.sum(r.value * ct), x)
    return gx.numpy(), r.value.detach().numpy(), bool(r.overflow), bool(r.nonfinite)


def redoub_rounds(n):
    return schedule.build("allreduce", "redoub", n).n_rounds


def round_specs(n, seed):
    r = redoub_rounds(n)
    return [dict(kind="bitflip", ranks=(1,), seed=seed, n=16, rounds=rounds)
            for rounds in ((1,), (0, r - 1), (r + 7,))]


# ---------------------------------------------------------------------------
# Subprocess modes
# ---------------------------------------------------------------------------


def _jax_child(n: int, part: int, out_path: str) -> None:
    """The reference's results at N = n: ``part`` 0 the policy cases,
    part 1 the bitflips, health counters and gradient sync (two processes
    per N, so that the compiles run side by side)."""
    sys.path.insert(0, str(HERE))
    from _child_env import pin_device_count

    pin_device_count(n)
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import comm as jcomm
    from repro.core import cost_model, faults as jfaults
    from repro.core import grad_sync as jgs
    from repro.core.collectives import GZConfig as JGZConfig
    from repro.core.shmap import shard_map

    mesh = jax.make_mesh((n,), ("x",))
    res = {}

    def run(op, cfg_kw, xs, spec_kw=None):
        c = jcomm.GZCommunicator("x", config=JGZConfig(**cfg_kw),
                                 hw=cost_model.A100_SLINGSHOT, axis_size=n)

        def body(x):
            r = getattr(c, op)(x[0])
            return r.value[None], r.overflow[None], r.nonfinite[None]

        spec = jfaults.FaultSpec(**spec_kw) if spec_kw else None
        ctx = jfaults.inject(spec) if spec else contextlib.nullcontext()
        with ctx:
            f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("x", None),),
                                  out_specs=(P("x", None), P("x"), P("x"))))
            v, o, nf = f(xs)
        return np.asarray(v), np.asarray(o), np.asarray(nf)

    def save(name, out):
        for key, a in zip(("value", "overflow", "nonfinite"), out):
            res[f"{name}/{key}"] = a

    if part == 0:
        for case, (op, cfg_kw, _, spec_kw) in CASES.items():
            save(case, run(op, cfg_kw, inputs(n, case), spec_kw))
        for case, cfg_kw in GRAD_A2A.items():
            c = jcomm.GZCommunicator("x", config=JGZConfig(**cfg_kw),
                                     hw=cost_model.A100_SLINGSHOT, axis_size=n)

            def gbody(x, ct, c=c):
                gx = jax.grad(lambda v: jnp.sum(c.all_to_all(v).value * ct[0]))(x[0])
                r = c.all_to_all(x[0])
                return gx[None], r.value[None], r.overflow[None], r.nonfinite[None]

            xs, cts = grad_a2a_inputs(n, case)
            out = jax.jit(shard_map(gbody, mesh=mesh, in_specs=(P("x", None),) * 2,
                                    out_specs=(P("x", None),) * 2 + (P("x"),) * 2))(xs, cts)
            for key, a in zip(("grad", "value", "overflow", "nonfinite"), out):
                res[f"{case}/{key}"] = np.asarray(a)
        np.savez(out_path, **res)
        return

    xs = inputs(n, "smooth")
    clean = run("allreduce", dict(WIRE, on_overflow="flag"), xs)
    save("bitflip_clean", clean)
    seed = None
    for s in range(BITFLIP_SEEDS):
        out = run("allreduce", dict(WIRE, on_overflow="flag"), xs,
                  dict(kind="bitflip", ranks=(1,), seed=s, n=16))
        if not np.array_equal(out[0], clean[0]):
            seed = s
            save("bitflip_silent", out)
            break
    res["bitflip_seed"] = np.asarray(seed)
    guarded = dict(WIRE, verify_streams=True, on_overflow="fallback")
    spec = dict(kind="bitflip", ranks=(1,), seed=seed, n=16)
    save("bitflip_detected", run("allreduce", guarded, xs, spec))
    for k, spec in enumerate(round_specs(n, seed)):
        save(f"bitflip_round{k}", run("allreduce", guarded, xs, spec))

    jcomm.clear_health_stats()
    jcomm.enable_health_tracking(True)
    run("allreduce", dict(OVF, algo="redoub"), inputs(n, "rough"))
    run("allreduce", dict(OK, algo="redoub"), inputs(n, "smooth"))
    run("reduce_scatter", OVF, inputs(n, "reduce_scatter_fallback"))
    jax.effects_barrier()
    res["health"] = np.asarray(json.dumps(sorted(
        [list(k), v] for k, v in jcomm.health_stats().items())))
    jcomm.enable_health_tracking(False)

    tree = grad_tree(n)
    sync = jgs.SyncConfig(gz=JGZConfig(**GRAD_SYNC), relative_eb=True, bucket_bytes=16384)
    specs = jax.tree.map(lambda a: P("x", *([None] * (a.ndim - 1))), tree)

    def gbody(g):
        g = jax.tree.map(lambda a: a[0], g)
        out, st = jgs.dp_allreduce_grads_stats(g, ("x",), sync)
        return jax.tree.map(lambda a: a[None], out), st.overflow[None], st.nonfinite[None]

    out, o, nf = jax.jit(shard_map(gbody, mesh=mesh, in_specs=(specs,),
                                   out_specs=(specs, P("x"), P("x"))))(tree)
    for i, leaf in enumerate(jax.tree.leaves(out)):
        res[f"grad/leaf{i}"] = np.asarray(leaf)
    res["grad/overflow"], res["grad/nonfinite"] = np.asarray(o), np.asarray(nf)
    np.savez(out_path, **res)


DIST_CASES = ("allreduce_redoub_fallback", "allgather_fallback", "reduce_scatter_fallback",
              "poison_nan")


def _dist_child(n: int, rank: int, port: int, out_path: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        g = transport.DistGroup()
        res = {}
        for case in DIST_CASES:
            op, cfg_kw, _, spec_kw = CASES[case]
            c = GZCommunicator("x", config=GZConfig(**cfg_kw), axis_size=n, device="cpu")
            x = torch.from_numpy(inputs(n, case)[rank])
            spec = faults.FaultSpec(**spec_kw) if spec_kw else None
            with g.bind("x"), (faults.inject(spec) if spec else contextlib.nullcontext()):
                r = getattr(c, op)(x)
            res[f"{case}/value"] = r.value.numpy()
            res[f"{case}/flags"] = np.array([bool(r.overflow), bool(r.nonfinite)])
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _dist_grad_child(rank: int, port: int, out_path: str) -> None:
    """One rank of a two-process gloo ``DistMesh``: the degraded
    all_to_all's gradient of every ``GRAD_A2A`` case."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    try:
        mesh = transport.DistMesh((2,), ("x",))
        res = {}
        for case in GRAD_A2A:
            xs, cts = grad_a2a_inputs(2, case)
            (out,) = mesh.run(lambda a, case=case: port_grad_a2a(*a, 2, case), [
                (torch.from_numpy(xs[rank]), torch.from_numpy(cts[rank]))])
            for key, a in zip(("grad", "value", "overflow", "nonfinite"), out):
                res[f"{case}/{key}"] = np.asarray(a)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _first_math_child() -> None:
    """In a fresh process, ranks of a ThreadGroup each call torch's CPU
    ``sqrt`` first thing; prints whether the process's first ``sqrt``
    ran on the calling (main) thread."""
    first = []
    real = torch.sqrt

    def spy(*args, **kwargs):
        if not first:
            first.append(threading.current_thread() is threading.main_thread())
        return real(*args, **kwargs)

    torch.sqrt = spy
    a = torch.tensor(978418933, dtype=torch.int32).view(torch.float32)
    got = transport.ThreadGroup(16, "cpu").run(lambda v: torch.sqrt(v), [a] * 16)
    assert all(v.view(torch.int32) == real(a).view(torch.int32) for v in got)
    print(json.dumps(first))


# ---------------------------------------------------------------------------
# Fixtures and helpers
# ---------------------------------------------------------------------------


def _child_env():
    return {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """N -> the JAX package's results for every case (two children per N,
    all started together)."""
    tmp = tmp_path_factory.mktemp("jax_faults")
    procs = {}
    for n in NS:
        for part in (0, 1):
            out = tmp / f"ref_{n}_{part}.npz"
            procs[n, part] = (out, subprocess.Popen(
                [sys.executable, __file__, "jax", str(n), str(part), str(out)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=_child_env()))
    results = {n: {} for n in NS}
    for (n, part), (out, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"JAX child N={n} part {part} failed:\n{log}"
        with np.load(out) as z:
            results[n].update({k: z[k] for k in z.files})
    return results


def _port(n, op, cfg_kw, xs, spec_kw=None):
    """(values, overflow, nonfinite) stacked over the ranks."""
    c = GZCommunicator("x", config=GZConfig(**cfg_kw), axis_size=n, device="cpu")
    spec = faults.FaultSpec(**spec_kw) if spec_kw else None
    with faults.inject(spec) if spec else contextlib.nullcontext():
        res = transport.ThreadGroup(n, "cpu").run(
            getattr(c, op), [torch.from_numpy(x) for x in xs])
    return (np.stack([r.value.numpy() for r in res]),
            np.array([bool(r.overflow) for r in res]),
            np.array([bool(r.nonfinite) for r in res]))


def _assert_bitwise(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    mism = int((got.view(np.int32) != want.view(np.int32)).sum())
    assert mism == 0, f"{what}: {mism} of {got.size} differ"


def _assert_equals_ref(out, ref, name, what):
    _assert_bitwise(out[0], ref[f"{name}/value"], what)
    np.testing.assert_array_equal(out[1], ref[f"{name}/overflow"], what)
    np.testing.assert_array_equal(out[2], ref[f"{name}/nonfinite"], what)


def _lossless_sum(xs):
    """The rank-order f32 sum of the sanitized inputs (the fallback's)."""
    san = np.where(np.isfinite(xs), xs, 0.0).astype(np.float32)
    out = san[0].copy()
    for x in san[1:]:
        out = out + x
    return out


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("n", NS)
def test_policy_cases_bitwise_equal_jax(jax_results, n, case):
    op, cfg_kw, _, spec_kw = CASES[case]
    xs = inputs(n, case)
    out = _port(n, op, cfg_kw, xs, spec_kw)
    _assert_equals_ref(out, jax_results[n], case, f"N={n} {case}")
    if case in FLAGS:
        assert all(tuple(f) == FLAGS[case] for f in zip(out[1], out[2])), (case, out[1:])
    else:  # every forced fault degrades every rank
        assert out[1].all() and not out[2].any(), (case, out[1:])
    spec = faults.FaultSpec(**spec_kw) if spec_kw else None
    twins = np.stack([faults.poison_np(x, r, spec) for r, x in enumerate(xs)])
    if op == "allreduce" and cfg_kw["on_overflow"] == "fallback" and (
            out[1].any() or out[2].any()):
        for r in range(n):
            _assert_bitwise(out[0][r], _lossless_sum(twins), f"{case} rank {r} lossless")
    if case == "scatter_fallback":
        _assert_bitwise(out[0], xs[0].reshape(n, -1), "exact root chunks")
    if case == "broadcast_fallback":
        _assert_bitwise(out[0], np.tile(xs[0], (n, 1)), "exact root payload")


def _port_grad_a2a(n, case):
    """Every rank's (gradient, value, overflow, nonfinite) on a CPU
    ``ThreadGroup``, each rank's backward on its own thread, stacked."""
    xs, cts = grad_a2a_inputs(n, case)
    outs = transport.ThreadGroup(n, "cpu").run(
        lambda a: port_grad_a2a(*a, n, case),
        [(torch.from_numpy(x), torch.from_numpy(c)) for x, c in zip(xs, cts)])
    return [np.stack([np.asarray(o[k]) for o in outs]) for k in range(4)]


@pytest.mark.parametrize("case", list(GRAD_A2A))
@pytest.mark.parametrize("n", NS)
def test_degraded_all_to_all_gradient_bitwise_equal_jax(jax_results, n, case):
    # the lossless fallback carries the gradient of the reference's
    # lax.cond branch, exchanged exactly and zero where the input was not
    # finite; the forward stays the lossless exchange of the sanitized input
    ref = jax_results[n]
    grad, value, ovf, nf = _port_grad_a2a(n, case)
    _assert_bitwise(grad, ref[f"{case}/grad"], f"N={n} {case} gradient")
    _assert_bitwise(value, ref[f"{case}/value"], f"N={n} {case} value")
    np.testing.assert_array_equal(ovf, ref[f"{case}/overflow"])
    np.testing.assert_array_equal(nf, ref[f"{case}/nonfinite"])
    xs, cts = grad_a2a_inputs(n, case)
    san = np.where(np.isfinite(xs), xs, 0.0).astype(np.float32)
    exchanged = san.reshape(n, n, -1).transpose(1, 0, 2).reshape(n, -1)
    _assert_bitwise(value, exchanged, f"N={n} {case} lossless exchange")
    if case == "a2a_grad_overflow":
        assert ovf.all() and not nf.any()
        assert np.all(grad != 0.0)
    else:
        assert nf.all()
        assert all(grad[1, i] == 0.0 for i in GRAD_A2A_BAD)
        assert np.count_nonzero(grad == 0.0) == len(GRAD_A2A_BAD)


def test_degraded_all_to_all_backward_off_the_ranks_thread_raises():
    def body(a):
        c = GZCommunicator("x", config=GZConfig(**OVF), axis_size=2, device="cpu")
        x = a.clone().requires_grad_(True)
        with torch.enable_grad():
            r = c.all_to_all(x)
        return x, torch.sum(r.value), bool(r.overflow)

    xs, _ = grad_a2a_inputs(2, "a2a_grad_overflow")
    outs = transport.ThreadGroup(2, "cpu").run(body, [torch.from_numpy(x) for x in xs])
    x, loss, overflow = outs[0]
    assert overflow
    # the main thread is not rank 0's: the exchange could never meet
    with pytest.raises(RuntimeError, match="DistMesh") as err:
        torch.autograd.grad(loss, x)
    assert "all_to_all fallback" in str(err.value) and "DistGroup" in str(err.value)


@pytest.mark.parametrize("n", NS)
def test_bitflips_bitwise_equal_jax(jax_results, n):
    """The same bitflip spec hits the same words, bits and rounds: silent
    corruption without ``verify_streams`` (the same corrupted values, no
    flag), detection and exact recovery with it, and round-targeted
    detection exactly where the reference detects."""
    ref = jax_results[n]
    xs = inputs(n, "smooth")
    flag = dict(WIRE, on_overflow="flag")
    clean = _port(n, "allreduce", flag, xs)
    _assert_equals_ref(clean, ref, "bitflip_clean", "clean")
    seed = int(ref["bitflip_seed"])
    for s in range(seed):  # the reference's search: these seeds hit no live word
        out = _port(n, "allreduce", flag, xs, dict(kind="bitflip", ranks=(1,), seed=s, n=16))
        _assert_bitwise(out[0], clean[0], f"seed {s} corrupts nothing in the reference")
    spec = dict(kind="bitflip", ranks=(1,), seed=seed, n=16)
    silent = _port(n, "allreduce", flag, xs, spec)
    _assert_equals_ref(silent, ref, "bitflip_silent", "silent")
    assert not silent[1].any() and not silent[2].any()
    guarded = dict(WIRE, verify_streams=True, on_overflow="fallback")
    detected = _port(n, "allreduce", guarded, xs, spec)
    _assert_equals_ref(detected, ref, "bitflip_detected", "detected")
    assert detected[1].all()
    for r in range(n):
        _assert_bitwise(detected[0][r], _lossless_sum(xs), "recovered")
    for k, spec in enumerate(round_specs(n, seed)):
        out = _port(n, "allreduce", guarded, xs, spec)
        _assert_equals_ref(out, ref, f"bitflip_round{k}", f"rounds={spec['rounds']}")
    # a round past the table's end can never match an exchange
    assert not out[1].any()


@pytest.mark.parametrize("n", NS)
def test_health_counters_equal_jax(jax_results, n):
    comm.clear_health_stats()
    comm.enable_health_tracking(True)
    try:
        _port(n, "allreduce", dict(OVF, algo="redoub"), inputs(n, "rough"))
        _port(n, "allreduce", dict(OK, algo="redoub"), inputs(n, "smooth"))
        _port(n, "reduce_scatter", OVF, inputs(n, "reduce_scatter_fallback"))
        got = comm.health_stats()
    finally:
        comm.enable_health_tracking(False)
        comm.clear_health_stats()
    want = {tuple(k): v for k, v in json.loads(str(jax_results[n]["health"]))}
    assert got == want
    assert got[("allreduce", "'x'")] == {"calls": 2, "overflow": 1, "nonfinite": 0,
                                         "fallbacks": 1}


@pytest.mark.parametrize("n", NS)
def test_grad_sync_fallback_bucket_bitwise_equal_jax(jax_results, n):
    """Every bucket overflows and falls back: the synced leaves are the
    reference's bits and ``SyncStats`` reports the overflow."""
    ref = jax_results[n]
    tree = grad_tree(n)
    sync = grad_sync.SyncConfig(gz=GZConfig(**GRAD_SYNC), relative_eb=True,
                                bucket_bytes=16384)

    def body(t):
        return grad_sync.dp_allreduce_grads_stats(t, ("x",), sync, device="cpu")

    trees = [convert.tree_from_numpy(convert.tree_map(lambda a: a[r], tree), "cpu")
             for r in range(n)]
    res = transport.ThreadGroup(n, "cpu").run(body, trees)
    leaves = [grad_sync.tree_flatten(convert.tree_to_numpy(out))[0] for out, _ in res]
    for i in range(len(leaves[0])):
        _assert_bitwise(np.stack([lv[i] for lv in leaves]), ref[f"grad/leaf{i}"],
                        f"N={n} leaf {i}")
    for r, (_, st) in enumerate(res):
        assert bool(st.overflow) == bool(ref["grad/overflow"][r]) is True
        assert bool(st.nonfinite) == bool(ref["grad/nonfinite"][r]) is False
        assert st.n_buckets == 2


# ---------------------------------------------------------------------------
# Against the reference's pure functions
# ---------------------------------------------------------------------------


def _containers():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(np.cumsum(rng.normal(0, 0.01, 5000)).astype(np.float32))
    return [ErrorBoundedLorenzo().compress(x, 1e-4),
            ErrorBoundedLorenzo(capacity_factor=0.05).compress(x * 1e4, 1e-6),
            EntropyLorenzo().compress(x, 1e-4), Passthrough().compress(x[:77], 0.0)]


@pytest.mark.parametrize("idx", range(4))
def test_tree_checksum_bits_equal_reference(idx):
    import jax.numpy as jnp

    from repro.core.collectives import _tree_checksum as ref_checksum
    from repro.core.compressed import Compressed as JCompressed

    c = _containers()[idx]
    d = convert.compressed_to_numpy(c)
    jc = JCompressed(packed=jnp.asarray(d["packed"]), bitwidth=jnp.asarray(d["bitwidth"]),
                     anchor=jnp.asarray(d["anchor"]), nwords=jnp.asarray(d["nwords"]),
                     eb=jnp.asarray(d["eb"]), n=d["n"], block=d["block"])
    want = np.uint32(ref_checksum(jc))
    got = collectives._tree_checksum(c.tensors())
    assert got.dtype == torch.int32 and got.dim() == 0
    assert np.int32(got.item()).view(np.uint32) == want
    # the scatter's slabs: three stacked tensors, no scalars
    slab = (c.packed.repeat(3, 1), c.bitwidth.repeat(3, 1), c.anchor.repeat(3, 1))
    want = np.uint32(ref_checksum(tuple(jnp.asarray(np.asarray(t)) for t in slab)))
    assert np.int32(collectives._tree_checksum(slab).item()).view(np.uint32) == want


def test_fault_spec_validation_and_poison_np_equal_reference():
    from repro.core import faults as jfaults

    for bad in (dict(kind="zap"), dict(kind="nan", n=0), dict(kind="nan", rounds=(1,)),
                dict(kind="bitflip", rounds=()), dict(kind="bitflip", rounds=(-1,))):
        with pytest.raises(ValueError) as ours:
            faults.FaultSpec(**bad)
        with pytest.raises(ValueError) as ref:
            jfaults.FaultSpec(**bad)
        assert str(ours.value) == str(ref.value)
    assert faults.KINDS == jfaults.KINDS and faults.OVERFLOW_SIGMA == jfaults.OVERFLOW_SIGMA
    spec = faults.FaultSpec("bitflip", ranks=[np.int64(1), 2.0], rounds=[3, np.int32(0)])
    assert (spec.ranks, spec.rounds) == ((1, 2), (3, 0))
    x = np.random.default_rng(0).normal(size=(37, 5)).astype(np.float32)
    for kw in (dict(kind="nan", ranks=(1,), seed=7, n=5), dict(kind="inf", seed=3, n=500),
               dict(kind="overflow", ranks=(0, 2), seed=11), dict(kind="bitflip")):
        for rank in range(3):
            ours = faults.poison_np(x, rank, faults.FaultSpec(**kw))
            ref = jfaults.poison_np(x, rank, jfaults.FaultSpec(**kw))
            _assert_bitwise(ours, ref, f"{kw} rank {rank}")
            hook = faults.FaultSpec(**kw)
            with faults.inject(hook):
                got = faults.maybe_poison_input(torch.from_numpy(x), _Rank(rank))
            _assert_bitwise(got.numpy(), ours, f"hook {kw} rank {rank}")
    assert faults.active() is None
    _assert_bitwise(faults.poison_np(x, 0, None), x, "no spec")


class _Rank:
    def __init__(self, rank):
        self.rank = rank


def test_corrupt_wire_never_writes_into_the_sender():
    """On a ThreadGroup the received tensors are the sender's own: the
    hook flips bits in a copy, the sender's words stay as sent, and the
    guard sees the difference."""
    packed = torch.arange(64, dtype=torch.int32)
    meta = (torch.ones(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
            torch.tensor(64, dtype=torch.int32), torch.tensor(1e-3))
    sent = [(packed.clone(),) + meta, (packed.clone() + 100,) + meta]
    perm = ((0, 1), (1, 0))

    def body(tensors):
        g = transport.current("x")
        recv, bad = collectives._exchange_tensors(g, tensors, perm, guard=True, round_idx=2)
        return recv, bool(bad)

    spec = faults.FaultSpec("bitflip", ranks=(1,), seed=5, n=3, rounds=(2,))
    with faults.inject(spec):
        res = transport.ThreadGroup(2, "cpu").run(body, sent)
    assert torch.equal(sent[0][0], packed) and torch.equal(sent[1][0], packed + 100)
    assert res[1][0][0] is not sent[0][0] and not torch.equal(res[1][0][0], packed)
    assert int((res[1][0][0] != packed).sum()) <= 3
    assert res[1][1] is True and res[0][1] is False
    assert torch.equal(res[0][0][0], packed + 100) and res[0][0][0] is sent[1][0]
    f32 = (torch.ones(8),)
    with faults.inject(faults.FaultSpec("bitflip", ranks=(0,))):
        assert faults.maybe_corrupt_wire(f32, _Rank(0)) is f32  # raw f32 is immune


@pytest.mark.parametrize("op", ["allreduce", "scatter"])
def test_raise_policy_message_and_every_rank_returns(op):
    from repro.core import comm as jcomm

    n = 4
    cfg = dict(OVF, on_overflow="raise")
    c = GZCommunicator("x", config=GZConfig(**cfg), axis_size=n, device="cpu")
    xs = [torch.from_numpy(x) for x in inputs(n, "rough" if op == "allreduce" else
                                              "scatter_fallback")]

    def body(x):
        try:
            getattr(c, op)(x)
        except RuntimeError as e:
            return str(e)
        return None

    out = []
    t = threading.Thread(target=lambda: out.append(
        transport.ThreadGroup(n, "cpu").run(body, xs)))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "a rank did not return"
    with pytest.raises(RuntimeError) as ref:
        jcomm._raise_degraded(f"{op} over 'x'", np.bool_(True), np.bool_(False))
    assert out[0] == [str(ref.value)] * n
    clean = GZCommunicator("x", config=GZConfig(**dict(OK, on_overflow="raise")),
                           axis_size=n, device="cpu")
    res = transport.ThreadGroup(n, "cpu").run(
        clean.allreduce, [torch.from_numpy(x) for x in inputs(n, "smooth")])
    assert not any(bool(r.overflow) or bool(r.nonfinite) for r in res)


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------


def test_every_op_runs_every_policy():
    """``verify_streams`` and the three policies on all six ops and the
    gradient sync, clean data: no flag, and the policies agree."""
    n = 3
    for op in ("allreduce", "reduce_scatter", "allgather", "scatter", "broadcast",
               "all_to_all"):
        case = {"allreduce": "smooth", "broadcast": "smooth"}.get(op, f"{op}_fallback")
        xs = np.cumsum(inputs(n, case) * 1e-4, axis=1).astype(np.float32)
        outs = [_port(n, op, dict(OK, on_overflow=policy, verify_streams=verify), xs)
                for policy in ("flag", "fallback", "raise") for verify in (False, True)]
        for out in outs:
            assert not out[1].any() and not out[2].any(), op
            _assert_bitwise(out[0], outs[0][0], op)
    trees = [{"w": torch.linspace(0, 1, 3000) * (r + 1)} for r in range(n)]
    for policy in ("fallback", "raise"):
        sync = grad_sync.SyncConfig(gz=GZConfig(**dict(OK, algo="ring", on_overflow=policy,
                                                       verify_streams=True)))
        res = transport.ThreadGroup(n, "cpu").run(
            lambda t: grad_sync.dp_allreduce_grads_stats(t, ("x",), sync, device="cpu"),
            trees)
        assert not bool(res[0][1].degraded)


def test_threadgroup_initializes_cpu_math_before_the_ranks_start():
    """torch's vectorized CPU math initializes itself on first use, and a
    first use from several rank threads at once can return a wrong
    ``sqrt`` on one of them (216 ulp off; the grad sync's relative-eb
    scale on one rank).  ``ThreadGroup.run`` makes that first use on the
    calling thread before it starts the ranks: in a fresh process whose
    ranks call ``sqrt`` first thing, the first call runs on the main
    thread."""
    proc = subprocess.run([sys.executable, __file__, "first-math"], capture_output=True,
                          text=True, env=_child_env(), timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [True]


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
    for case in DIST_CASES:
        op, cfg_kw, _, spec_kw = CASES[case]
        vals, ovf, nf = _port(n, op, cfg_kw, inputs(n, case), spec_kw)
        for r in range(n):
            _assert_bitwise(ranks[r][f"{case}/value"], vals[r], f"{case} rank {r}")
            assert list(ranks[r][f"{case}/flags"]) == [ovf[r], nf[r]]


def test_gloo_distmesh_degraded_all_to_all_gradient_equals_threadgroup():
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, __file__, "dist-grad", str(r), str(port), outs[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_child_env()) for r in range(2)]
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"gloo rank {r} failed:\n{logs[r]}"
        ranks = [dict(np.load(o)) for o in outs]
    for case in GRAD_A2A:
        want = _port_grad_a2a(2, case)
        assert want[2].any() or want[3].any(), case  # the call degraded
        for r in range(2):
            for k, key in enumerate(("grad", "value")):
                _assert_bitwise(ranks[r][f"{case}/{key}"], want[k][r], f"{case} {key} {r}")
            assert [bool(ranks[r][f"{case}/overflow"]), bool(ranks[r][f"{case}/nonfinite"])] \
                == [want[2][r], want[3][r]]


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "jax":
        _jax_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif mode == "dist-grad":
        _dist_grad_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif mode == "first-math":
        _first_math_child()
    else:
        _dist_child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    sys.exit(0)
