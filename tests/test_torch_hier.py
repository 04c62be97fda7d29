"""The port's integer ring and two-level (node x local) allreduce against
the JAX package's.

The same seeded per-rank inputs go through ``repro.core`` inside
``shard_map`` over N host devices (the reference) and through
``repro_torch`` on a ``ThreadGroup`` of N CPU ranks (a mesh of them for
the two-level cases).  Every comparison is bitwise, rank by rank:

  * ``algo="intring"`` at N in {3, 4, 8}: clean, under
    ``verify_streams``, and under ``fallback`` with a forced overflow
    (values and flags); ``policy="accuracy"`` resolves it and runs;
  * ``GZHierCommunicator.allreduce`` at 2x3, 3x2, 2x4, 4x2, 1x4 and 4x1
    with D = 1000 (not a multiple of L), at both hardware points passed
    explicitly (``A100_SLINGSHOT`` has a link asymmetry and resolves the
    hierarchical branch where ``L > 1``; ``TPU_V5E`` resolves flat):
    values, flags and ``wire_bytes``;
  * the hier fallback of a forced overflow at 2x4 at both points, against
    the reference and against the composite ``psum``;
  * ``dp_allreduce_grads_stats`` over ``("local", "node")`` at 2x3, at a
    flat point (the port planning at ``TPU_V5E`` against the unchanged
    reference) and at the port's default (the reference's ``_hier_comm``
    wrapped in its child to plan at ``A100_SLINGSHOT``): leaves, flags,
    wire bytes and buckets.

Also here: an error on one rank of a 2x3 mesh raises in ``run`` instead
of hanging the ranks that wait on other barriers; ``make_hier_mesh``'s
validation; one gloo ``DistMesh`` run at 2x2 (four processes) equal to
the ``ThreadGroup`` run.

The JAX side runs in one subprocess per device count (this file under
``__main__``, ``jax`` mode), all started together; ``dist`` mode is one
rank of the gloo run.
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

from repro_torch import convert
from repro_torch.core import comm, cost_model, grad_sync, transport
from repro_torch.core.collectives import GZConfig
from repro_torch.launch import mesh as tmesh

HERE = pathlib.Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
D = 1000  # per-rank elements, not a multiple of L = 3 or 4
HW = ("a100", "tpu")
PORT_HW = {"a100": cost_model.A100_SLINGSHOT, "tpu": cost_model.TPU_V5E}

INTRING_NS = (3, 4, 8)
OK = dict(eb=1e-4, capacity_factor=1.2)
OVF = dict(eb=1e-6, capacity_factor=0.02, on_overflow="fallback")
# name -> (GZConfig kwargs, data)
INTRING_CASES = {
    "clean": (dict(OK, algo="intring"), "smooth"),
    "verify": (dict(OK, algo="intring", verify_streams=True, on_overflow="fallback"),
               "smooth"),
    "fallback": (dict(OVF, algo="intring"), "rough"),
}
TOPOLOGIES = ((2, 3), (3, 2), (2, 4), (4, 2), (1, 4), (4, 1))
AXES = ("node", "local")
GRAD_SHAPES = {"w": (64, 32), "b": (32,)}
GRAD_SYNC = dict(eb=1e-5, algo="redoub", capacity_factor=1.2)
GRAD_BUCKET = 4096


def _rng(n, name):
    return np.random.default_rng([n, sum(map(ord, name))])


def inputs(n: int, kind: str, tag: str) -> np.ndarray:
    """(n, D) f32 per-rank inputs, the same in every process."""
    rng = _rng(n, f"{kind}/{tag}")
    if kind == "smooth":
        return np.cumsum(rng.normal(0, 0.01, (n, D)), axis=1).astype(np.float32)
    return rng.normal(0, 100.0, (n, D)).astype(np.float32)


def fold_inputs(n):
    """(n, 4096) f32 values over eight decades: a sum of them depends on
    its order."""
    rng = _rng(n, "fold")
    return (rng.normal(size=(n, 4096)) * 10.0 ** rng.integers(-4, 5, (n, 4096))
            ).astype(np.float32)


def grad_tree(n):
    rng = _rng(n, "grad")
    return {k: rng.normal(0, 1e-3, (n,) + s).astype(np.float32)
            for k, s in GRAD_SHAPES.items()}


def _topo_name(topo):
    return f"{topo[0]}x{topo[1]}"


def _child_ns():
    """Device count -> what its child computes."""
    ns = {n: {"intring": True, "topos": []} for n in INTRING_NS}
    for topo in TOPOLOGIES:
        n = topo[0] * topo[1]
        ns.setdefault(n, {"intring": False, "topos": []})["topos"].append(topo)
    return ns


# ---------------------------------------------------------------------------
# Subprocess modes
# ---------------------------------------------------------------------------


def _jax_child(n: int, out_path: str) -> None:
    sys.path.insert(0, str(HERE))
    from _child_env import pin_device_count

    pin_device_count(n)
    import jax
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from repro.core import comm as jcomm
    from repro.core import cost_model as jcm
    from repro.core import grad_sync as jgs
    from repro.core.collectives import GZConfig as JGZConfig
    from repro.core.shmap import shard_map

    hws = {"a100": jcm.A100_SLINGSHOT, "tpu": jcm.TPU_V5E}
    res = {}
    todo = _child_ns()[n]

    def save(name, out):
        for key, a in zip(("value", "overflow", "nonfinite"), out):
            res[f"{name}/{key}"] = np.asarray(a)

    if todo["intring"]:
        mesh = jax.make_mesh((n,), ("x",))
        for case, (cfg_kw, kind) in INTRING_CASES.items():
            c = jcomm.GZCommunicator("x", config=JGZConfig(**cfg_kw), hw=jcm.A100_SLINGSHOT,
                                     axis_size=n)

            def body(x):
                r = c.allreduce(x[0])
                return r.value[None], r.overflow[None], r.nonfinite[None]

            f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("x", None),),
                                  out_specs=(P("x", None), P("x"), P("x"))))
            save(f"intring/{n}/{case}", f(inputs(n, kind, "intring")))

    for topo in todo["topos"]:
        mesh = jax.make_mesh(topo, AXES)
        name = _topo_name(topo)

        def run(cfg_kw, hw, xs):
            c = jcomm.GZHierCommunicator.for_axes("node", "local", config=JGZConfig(**cfg_kw),
                                                  hw=hws[hw], topology=topo)
            wires = []

            def body(x):
                r = c.allreduce(x[0])
                wires.append(r.wire_bytes)
                return r.value[None], r.overflow[None], r.nonfinite[None]

            f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(AXES, None),),
                                  out_specs=(P(AXES, None), P(AXES), P(AXES))))
            out = f(xs)
            return out, wires[0]

        for hw in HW:
            out, wire = run(OK, hw, inputs(n, "smooth", name))
            save(f"hier/{name}/{hw}", out)
            res[f"hier/{name}/{hw}/wire"] = np.asarray(wire)
        if topo == (2, 4):
            xs = inputs(n, "rough", name)
            for hw in HW:
                out, _ = run(OVF, hw, xs)
                save(f"hier_fallback/{hw}", out)
            f = jax.jit(shard_map(lambda x: lax.psum(x[0], AXES)[None], mesh=mesh,
                                  in_specs=(P(AXES, None),), out_specs=P(AXES, None)))
            res["hier_fallback/psum"] = np.asarray(f(xs))
        if topo[0] * topo[1] == 6:
            for order in (AXES, AXES[::-1]):
                f = jax.jit(shard_map(lambda x: lax.psum(x[0], order)[None], mesh=mesh,
                                      in_specs=(P(AXES, None),), out_specs=P(AXES, None)))
                res[f"fold/{name}/{'_'.join(order)}"] = np.asarray(f(fold_inputs(n)))
            xs = fold_inputs(n)
            f = jax.jit(shard_map(
                lambda x: jgs._tree_scale([x[0][:1000], x[0][1000:]], ("local", "node"))[None],
                mesh=mesh, in_specs=(P(AXES, None),), out_specs=P(AXES)))
            res[f"scale/{name}"] = np.asarray(f(xs))
        if topo == (2, 3):
            tree = grad_tree(n)
            sync = jgs.SyncConfig(gz=JGZConfig(**GRAD_SYNC), relative_eb=True,
                                  bucket_bytes=GRAD_BUCKET)
            specs = jax.tree.map(lambda a: P(AXES, *([None] * (a.ndim - 1))), tree)
            orig = jgs._hier_comm

            def a100_hier_comm(axis_names, sync):
                c = orig(axis_names, sync)
                return jcomm.GZHierCommunicator.for_axes(
                    c.node_axis, c.local_axis, config=c.config, hw=jcm.A100_SLINGSHOT,
                    auto_depth=c._auto_depth)

            for hw in HW:
                jgs._hier_comm = a100_hier_comm if hw == "a100" else orig
                facts = []

                def gbody(g):
                    g = jax.tree.map(lambda a: a[0], g)
                    out, st = jgs.dp_allreduce_grads_stats(g, ("local", "node"), sync)
                    facts.append((st.wire_bytes, st.n_buckets))
                    return (jax.tree.map(lambda a: a[None], out), st.overflow[None],
                            st.nonfinite[None])

                out, o, nf = jax.jit(shard_map(gbody, mesh=mesh, in_specs=(specs,),
                                               out_specs=(specs, P(AXES), P(AXES))))(tree)
                for k in GRAD_SHAPES:
                    res[f"grad/{hw}/{k}"] = np.asarray(out[k])
                res[f"grad/{hw}/flags"] = np.stack([np.asarray(o), np.asarray(nf)])
                res[f"grad/{hw}/facts"] = np.asarray(facts[0])
            jgs._hier_comm = orig
    np.savez(out_path, **res)


DIST_TOPO = (2, 2)


def _mesh_body(xs_hier, tree):
    """What both the gloo and the thread runs of the 2x2 mesh compute on
    one rank: the hier allreduce at both points, ``intring`` over the
    composite axis, and the grad sync over ``("local", "node")``."""
    def body(r):
        out = {}
        x = torch.from_numpy(xs_hier[r])
        for hw in HW:
            c = comm.GZHierCommunicator("node", "local", config=GZConfig(**OK),
                                        hw=PORT_HW[hw], device="cpu")
            res = c.allreduce(x)
            out[f"hier/{hw}"] = res.value.numpy()
            out[f"hier/{hw}/flags"] = np.array([bool(res.overflow), bool(res.nonfinite)])
        c = comm.GZCommunicator(AXES, config=GZConfig(**OK, algo="intring"), device="cpu")
        out["intring"] = c.allreduce(x).value.numpy()
        sync = grad_sync.SyncConfig(gz=GZConfig(**GRAD_SYNC), bucket_bytes=GRAD_BUCKET)
        t = convert.tree_from_numpy({k: v[r] for k, v in tree.items()}, "cpu")
        synced, _ = grad_sync.dp_allreduce_grads_stats(t, ("local", "node"), sync,
                                                       device="cpu")
        for k, v in synced.items():
            out[f"grad/{k}"] = v.numpy()
        return out

    return body


def _dist_child(rank: int, port: int, out_path: str) -> None:
    import torch.distributed as dist

    n = DIST_TOPO[0] * DIST_TOPO[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=n,
                            rank=rank)
    try:
        m = tmesh.make_hier_mesh(*DIST_TOPO, distributed=True)
        with m.bind():
            out = _mesh_body(inputs(n, "smooth", "dist"), grad_tree(n))(rank)
        np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Fixtures and helpers
# ---------------------------------------------------------------------------


def _child_env():
    return {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """The JAX package's results: one child per device count, all started
    together."""
    tmp = tmp_path_factory.mktemp("jax_hier")
    procs = {}
    for n in sorted(_child_ns()):
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
            results.update({k: z[k] for k in z.files})
    return results


def _assert_bitwise(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    mism = int((got.view(np.int32) != want.view(np.int32)).sum())
    assert mism == 0, f"{what}: {mism} of {got.size} differ"


def _stack(res):
    return (np.stack([r.value.numpy() for r in res]),
            np.array([bool(r.overflow) for r in res]),
            np.array([bool(r.nonfinite) for r in res]))


def _assert_equals_ref(out, ref, name):
    _assert_bitwise(out[0], ref[f"{name}/value"], name)
    np.testing.assert_array_equal(out[1], ref[f"{name}/overflow"], name)
    np.testing.assert_array_equal(out[2], ref[f"{name}/nonfinite"], name)


def _lossless_sum(xs):
    out = xs[0].copy()
    for x in xs[1:]:
        out = out + x
    return out


def _run_mesh(topo, fn, inputs_):
    return transport.ThreadGroup(topo[0] * topo[1], "cpu").run(
        fn, inputs_, axis_name=AXES, shape=topo)


def _hier(topo, cfg_kw, hw, xs):
    c = comm.GZHierCommunicator("node", "local", config=GZConfig(**cfg_kw),
                                hw=PORT_HW[hw], topology=topo, device="cpu")
    res = _run_mesh(topo, c.allreduce, [torch.from_numpy(x) for x in xs])
    return c, res


def _bound(exact, hops):
    return 1e-4 * hops + np.abs(exact).max() * 1e-6


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(INTRING_CASES))
@pytest.mark.parametrize("n", INTRING_NS)
def test_intring_bitwise_equal_jax(jax_results, n, case):
    cfg_kw, kind = INTRING_CASES[case]
    xs = inputs(n, kind, "intring")
    c = comm.GZCommunicator("x", config=GZConfig(**cfg_kw), axis_size=n, device="cpu")
    assert c.plan("allreduce", (D,)).algo == "intring"
    out = _stack(transport.ThreadGroup(n, "cpu").run(
        c.allreduce, [torch.from_numpy(x) for x in xs]))
    _assert_equals_ref(out, jax_results, f"intring/{n}/{case}")
    if case == "fallback":
        assert out[1].all() and not out[2].any()
        for r in range(n):
            _assert_bitwise(out[0][r], _lossless_sum(xs), f"rank {r} lossless")
        return
    assert not out[1].any() and not out[2].any()
    _assert_bitwise(out[0], np.tile(out[0][0], (n, 1)), "every rank the same bits")
    exact = xs.astype(np.float64).sum(axis=0)
    assert np.abs(out[0][0] - exact).max() <= _bound(exact, n * 1.05)
    # the accuracy policy resolves intring on the same knobs
    acc = comm.GZCommunicator("x", config=GZConfig(**OK), policy="accuracy", axis_size=n,
                              device="cpu")
    assert acc.plan("allreduce", (D,)).algo == "intring"
    got = transport.ThreadGroup(n, "cpu").run(acc.allreduce,
                                              [torch.from_numpy(x) for x in xs])
    _assert_bitwise(np.stack([r.value.numpy() for r in got]),
                    jax_results[f"intring/{n}/clean/value"], "accuracy policy")


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("topo", TOPOLOGIES, ids=_topo_name)
def test_hier_allreduce_bitwise_equal_jax(jax_results, topo, hw):
    name = _topo_name(topo)
    n = topo[0] * topo[1]
    xs = inputs(n, "smooth", name)
    c, res = _hier(topo, OK, hw, xs)
    _assert_equals_ref(_stack(res), jax_results, f"hier/{name}/{hw}")
    assert {r.wire_bytes for r in res} == {int(jax_results[f"hier/{name}/{hw}/wire"])}
    plan = c.plan((D,))
    assert plan.flat == (hw == "tpu" or topo[1] == 1), plan
    assert res[0].wire_bytes == plan.inter_wire_bytes
    exact = xs.astype(np.float64).sum(axis=0)
    for r in res:
        assert not bool(r.overflow)
        assert np.abs(r.value.numpy() - exact).max() <= _bound(exact, 1.05)


@pytest.mark.parametrize("hw", HW)
def test_hier_fallback_bitwise_equal_jax(jax_results, hw):
    """A forced overflow at 2x4 falls back to the exact sum over the
    composite axis on both branches: the reference's bits and the
    composite ``psum``'s (a rank-order fold, node-major)."""
    topo = (2, 4)
    xs = inputs(8, "rough", _topo_name(topo))
    c, res = _hier(topo, OVF, hw, xs)
    assert c.plan((D,)).flat == (hw == "tpu")
    out = _stack(res)
    _assert_equals_ref(out, jax_results, f"hier_fallback/{hw}")
    assert out[1].all() and not out[2].any()
    _assert_bitwise(out[0], jax_results["hier_fallback/psum"], "composite psum")
    for r in range(8):
        _assert_bitwise(out[0][r], _lossless_sum(xs), f"rank {r} rank-order fold")


@pytest.mark.parametrize("hw", HW)
def test_multi_axis_grad_sync_bitwise_equal_jax(jax_results, hw, monkeypatch):
    """``dp_allreduce_grads_stats`` over ``("local", "node")`` at 2x3:
    the relative-eb scale folds local-major (the reference's ``psum``
    over that tuple), the buckets run the two-level plan.  ``tpu`` plans
    the port at the flat point the unchanged reference plans at; ``a100``
    is the port's default, held against the reference planning there."""
    topo = (2, 3)
    n = 6
    if hw == "tpu":
        orig = grad_sync._hier_comm

        def tpu_hier_comm(axis_names, sync, device):
            c = orig(axis_names, sync, device)
            return comm.GZHierCommunicator.for_axes(
                c.node_axis, c.local_axis, config=c.config, hw=cost_model.TPU_V5E,
                device=device, auto_depth=c._auto_depth)

        monkeypatch.setattr(grad_sync, "_hier_comm", tpu_hier_comm)
    tree = grad_tree(n)
    sync = grad_sync.SyncConfig(gz=GZConfig(**GRAD_SYNC), relative_eb=True,
                                bucket_bytes=GRAD_BUCKET)

    def body(t):
        hc = grad_sync._hier_comm(("local", "node"), sync, "cpu")
        out = grad_sync.dp_allreduce_grads_stats(t, ("local", "node"), sync, device="cpu")
        return out, hc.plan((GRAD_BUCKET // 4,)).flat

    trees = [convert.tree_from_numpy({k: v[r] for k, v in tree.items()}, "cpu")
             for r in range(n)]
    res = _run_mesh(topo, body, trees)
    assert {flat for _, flat in res} == {hw == "tpu"}
    for k in GRAD_SHAPES:
        _assert_bitwise(np.stack([out[k].numpy() for (out, _), _ in res]),
                        jax_results[f"grad/{hw}/{k}"], f"{hw} leaf {k}")
    want_flags = jax_results[f"grad/{hw}/flags"]
    want_wire, want_buckets = (int(v) for v in jax_results[f"grad/{hw}/facts"])
    for r, ((_, st), _) in enumerate(res):
        assert [bool(st.overflow), bool(st.nonfinite)] == list(want_flags[:, r])
        assert (st.wire_bytes, st.n_buckets) == (want_wire, want_buckets)


@pytest.mark.parametrize("topo", [(2, 3), (3, 2)], ids=_topo_name)
def test_composite_fold_order_bitwise_equal_jax(jax_results, topo):
    """The reference's ``psum`` over a tuple of axes folds in that tuple's
    order, first axis major: ``sum_across`` over the ``("node", "local")``
    and ``("local", "node")`` handles gives its bits on values whose sum
    depends on the order, and so does the relative-eb scale over
    ``("local", "node")``."""
    name = _topo_name(topo)
    xs = fold_inputs(6)

    def body(x):
        folds = {order: transport.current(order).sum_across(x).numpy()
                 for order in (AXES, AXES[::-1])}
        scale = grad_sync._tree_scale([x[:1000], x[1000:]],
                                      transport.current(("local", "node")))
        return folds, scale.numpy()

    res = _run_mesh(topo, body, [torch.from_numpy(x) for x in xs])
    for order in (AXES, AXES[::-1]):
        _assert_bitwise(np.stack([f[order] for f, _ in res]),
                        jax_results[f"fold/{name}/{'_'.join(order)}"], f"{order} fold")
    _assert_bitwise(np.stack([s for _, s in res]), jax_results[f"scale/{name}"], "scale")
    # the two orders really differ on these values
    assert not np.array_equal(res[0][0][AXES], res[0][0][AXES[::-1]])


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------


def test_error_on_one_rank_raises_and_does_not_hang():
    """Rank 1 of a 2x3 mesh fails between the two barriers of a local
    exchange while the ranks of node 1 wait on the composite barrier:
    ``run`` re-raises rank 1's error and every thread returns."""
    def body(x):
        g_all = transport.current(AXES)
        g_local = transport.current("local")
        if g_all.rank < 3:
            g_local.exchange((x,), [(0, 1), (1, 2), (2, 0)])
            if g_all.rank == 1:
                raise RuntimeError("rank 1 failed inside the local stage")
            g_local.sum_across(x)
        return g_all.sum_across(x)

    out = []

    def target():
        try:
            _run_mesh((2, 3), body, [torch.ones(4)] * 6)
        except RuntimeError as e:
            out.append(e)

    t = threading.Thread(target=target)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "a rank is still waiting on a barrier"
    assert len(out) == 1 and "rank 1 failed" in str(out[0])
    # the mesh runs again afterwards: its barriers are fresh each run
    got = _run_mesh((2, 3), lambda x: transport.current(AXES).sum_across(x),
                    [torch.full((2,), float(r)) for r in range(6)])
    assert all(torch.equal(v, torch.full((2,), 15.0)) for v in got)


def test_make_hier_mesh_layout_and_validation():
    m = tmesh.make_hier_mesh(2, n_ranks=6, device="cpu")
    assert (m.axis_names, m.shape, m.size) == (AXES, (2, 3), 6)
    assert tmesh.mesh_axis_sizes(m) == {"node": 2, "local": 3}
    assert tmesh.dp_axes_of(m) == ()
    ranks = m.run(lambda _: tuple(transport.current(k).rank
                                  for k in ("node", "local", AXES, ("local", "node"))),
                  [None] * 6)
    assert ranks == [(r // 3, r % 3, r, (r % 3) * 2 + r // 3) for r in range(6)]
    assert tmesh.make_hier_mesh(gpus_per_node=4, n_ranks=8, device="cpu").shape == (2, 4)
    assert tmesh.make_hier_mesh(4, 2, device="cpu").size == 8
    with pytest.raises(ValueError, match="give n_nodes"):
        tmesh.make_hier_mesh(n_ranks=8, device="cpu")
    with pytest.raises(ValueError, match="3 nodes x 2 gpus != 8"):
        tmesh.make_hier_mesh(3, 2, n_ranks=8, device="cpu")
    with pytest.raises(ValueError, match="product"):
        transport.ThreadGroup(6, "cpu").run(lambda x: x, [None] * 6, axis_name=AXES,
                                            shape=(2, 2))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_distmesh_equals_threadmesh():
    n, port = DIST_TOPO[0] * DIST_TOPO[1], _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, __file__, "dist", str(r), str(port), outs[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_child_env()) for r in range(n)]
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"gloo rank {r} failed:\n{logs[r]}"
        ranks = [dict(np.load(o)) for o in outs]
    want = tmesh.make_hier_mesh(*DIST_TOPO, device="cpu").run(
        _mesh_body(inputs(n, "smooth", "dist"), grad_tree(n)), list(range(n)))
    assert set(ranks[0]) == set(want[0])
    for r in range(n):
        for key, v in want[r].items():
            if key.endswith("flags"):
                np.testing.assert_array_equal(ranks[r][key], v, key)
            else:
                _assert_bitwise(ranks[r][key], v, f"{key} rank {r}")
        assert not ranks[r]["hier/a100/flags"].any()


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "jax":
        _jax_child(int(sys.argv[2]), sys.argv[3])
    else:
        _dist_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)
