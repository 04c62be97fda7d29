"""The port's data-parallel gradient sync against the JAX package's.

The same seeded per-rank gradient trees go through
``repro.core.grad_sync.dp_allreduce_grads_stats`` inside ``shard_map``
over N host devices (the reference) and through
``repro_torch.core.grad_sync.dp_allreduce_grads_stats`` on a
``ThreadGroup`` of N CPU ranks, at N in {3, 6, 8}.  Synced leaves and
``SyncStats`` (flags, wire bytes, bucket count) must be bitwise equal
for the ``lorenzo``, ``lorenzo+entropy``, ``lossless`` and
``passthrough`` codecs and for ``gz=None``, with ``relative_eb`` both
ways.  The tree nests dicts (inserted out of key order), a list and a
tuple; one leaf crosses a bucket boundary, the last bucket is ragged,
and two leaves are short enough for the reference's fused
sum-of-squares loop.

Also here: the relative-eb scale and the rank-order ``sum_across`` equal
the reference's ``psum`` bits; the bucketed path equals the port's
whole-tree reference; ledgers (slices, issue order, payload stacks)
equal ``repro.core.buckets``'s; one gloo ``DistGroup`` run at N = 3
equals the ``ThreadGroup`` run.
"""
import os
import pathlib
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import buckets, grad_sync, transport
from repro_torch.core.collectives import GZConfig

HERE = pathlib.Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
NS = (3, 6, 8)
BUCKET_BYTES = 16384  # 4096 elements: 3 buckets, the last ragged

# Inserted out of key order: the flatten order must be JAX's (sorted keys).
SHAPES = {
    "mlp": {"wo": (64, 17), "wi": (50, 50)},
    "attn": [(3000,), (5000,)],   # 5000 crosses the first bucket boundary
    "ln": (7,),                   # <= 32 elements: the fused sum of squares
    "norm": ((32,), (33,)),
}


def _gz(codec, **kw):
    return {**dict(eb=1e-4, algo="redoub", worst_case_budget=False, codec=codec), **kw}


# name -> SyncConfig keyword arguments (gz as GZConfig kwargs or None)
CASES = {
    "lorenzo": dict(gz=_gz("lorenzo")),
    "lorenzo_abs": dict(gz=_gz("lorenzo", eb=1e-7), relative_eb=False),
    "entropy": dict(gz=_gz("lorenzo+entropy")),
    "entropy_abs": dict(gz=_gz("lorenzo+entropy", eb=1e-7), relative_eb=False),
    "entropy_ring_p2": dict(gz=_gz("lorenzo+entropy", algo="ring"), pipeline_chunks=2),
    "entropy_overflow": dict(gz=_gz("lorenzo+entropy", eb=1e-12, capacity_factor=0.05)),
    "lossless": dict(gz=_gz("lossless")),
    "lossless_abs": dict(gz=_gz("lossless"), relative_eb=False),
    "passthrough": dict(gz=_gz("passthrough")),
    "none": dict(gz=None),
}


def sync_config(case, gz_cls, sync_cls):
    kw = dict(CASES[case])
    gz = kw.pop("gz")
    return sync_cls(gz=None if gz is None else gz_cls(**gz), bucket_bytes=BUCKET_BYTES,
                    **kw)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and tree and not isinstance(tree[0], int):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def grads(n: int, case: str):
    """Tree of (n, *shape) f32 per-rank gradients: random walks whose step
    scale differs per leaf, the same in every process."""
    rng = np.random.default_rng(100 * n + sorted(CASES).index(case))

    def leaf(shape):
        size = int(np.prod(shape))
        steps = rng.normal(0, 10.0 ** rng.uniform(-5, -3), (n, size))
        return np.cumsum(steps, axis=1).astype(np.float32).reshape((n,) + tuple(shape))

    return _map(leaf, SHAPES)


def _rank(tree, r):
    return _map(lambda a: a[r], tree)


def _flat(tree):
    """Leaves in JAX's flatten order, as numpy."""
    leaves, _ = grad_sync.tree_flatten(_map(np.asarray, tree))
    return leaves


def sum_across_inputs(n):
    rng = np.random.default_rng(5 + n)
    return (rng.normal(size=(n, 64)) * 10.0 ** rng.uniform(-6, 6, (n, 64))).astype(np.float32)


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

    from repro.core import grad_sync as jgs
    from repro.core.collectives import GZConfig as JGZConfig
    from repro.core.shmap import shard_map

    mesh = jax.make_mesh((n,), ("x",))
    res = {}
    for case in CASES:
        sync = sync_config(case, JGZConfig, jgs.SyncConfig)
        tree = grads(n, case)
        specs = jax.tree.map(lambda a: P("x", *([None] * (a.ndim - 1))), tree)
        side = {}

        def body(g, sync=sync, side=side):
            g = jax.tree.map(lambda a: a[0], g)
            out, st = jgs.dp_allreduce_grads_stats(g, ("x",), sync)
            side["wire"], side["n_buckets"] = st.wire_bytes, st.n_buckets
            leaves = jax.tree.leaves(g)
            scale = jgs._tree_scale([a.reshape(-1) for a in leaves], ("x",))
            return (jax.tree.map(lambda a: a[None], out), st.overflow[None],
                    st.nonfinite[None], scale[None])

        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(specs,),
                              out_specs=(specs, P("x"), P("x"), P("x"))))
        out, ovf, nf, scale = f(tree)
        for i, leaf in enumerate(jax.tree.leaves(out)):
            res[f"{case}/leaf{i}"] = np.asarray(leaf)
        res[f"{case}/overflow"] = np.asarray(ovf)
        res[f"{case}/nonfinite"] = np.asarray(nf)
        res[f"{case}/scale"] = np.asarray(scale)
        res[f"{case}/wire_bytes"] = np.asarray(side["wire"])
        res[f"{case}/n_buckets"] = np.asarray(side["n_buckets"])
    f = jax.jit(shard_map(lambda v: lax.psum(v[0], "x")[None], mesh=mesh,
                          in_specs=(P("x", None),), out_specs=P("x", None)))
    res["psum"] = np.asarray(f(sum_across_inputs(n)))
    np.savez(out_path, **res)


DIST_CASES = ("entropy", "none")


def _dist_child(n: int, rank: int, port: int, out_path: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        g = transport.DistGroup()
        res = {}
        for case in DIST_CASES:
            sync = sync_config(case, GZConfig, grad_sync.SyncConfig)
            tree = convert.tree_from_numpy(_rank(grads(n, case), rank), "cpu")
            with g.bind("x"):
                out, st = grad_sync.dp_allreduce_grads_stats(tree, ("x",), sync,
                                                             device="cpu")
            for i, leaf in enumerate(_flat(convert.tree_to_numpy(out))):
                res[f"{case}/leaf{i}"] = leaf
            res[f"{case}/flags"] = np.array([bool(st.overflow), bool(st.nonfinite)])
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def _child_env():
    return {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_gradsync")
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


def _port(n, case, fn=grad_sync.dp_allreduce_grads_stats):
    sync = sync_config(case, GZConfig, grad_sync.SyncConfig)
    tree = grads(n, case)
    trees = [convert.tree_from_numpy(_rank(tree, r), "cpu") for r in range(n)]

    def body(t):
        out, st = fn(t, ("x",), sync, device="cpu")
        flat = [a.reshape(-1) for a in grad_sync.tree_flatten(t)[0]]
        scale = grad_sync._tree_scale(flat, transport.current("x"))
        return convert.tree_to_numpy(out), st, scale

    return transport.ThreadGroup(n, "cpu").run(body, trees)


def _assert_bitwise(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    mism = int((got.view(np.int32) != want.view(np.int32)).sum())
    assert mism == 0, f"{what}: {mism} of {got.size} differ"


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("n", NS)
def test_threadgroup_grad_sync_bitwise_equals_jax(jax_results, n, case):
    ref = jax_results[n]
    res = _port(n, case)
    leaves = [_flat(out) for out, _, _ in res]
    for i in range(len(leaves[0])):
        _assert_bitwise(np.stack([lv[i] for lv in leaves]), ref[f"{case}/leaf{i}"],
                        f"N={n} {case} leaf {i}")
    for r, (_, st, scale) in enumerate(res):
        assert bool(st.overflow) == bool(ref[f"{case}/overflow"][r])
        assert bool(st.nonfinite) == bool(ref[f"{case}/nonfinite"][r])
        assert st.wire_bytes == int(ref[f"{case}/wire_bytes"])
        assert st.n_buckets == int(ref[f"{case}/n_buckets"])
        _assert_bitwise(scale.reshape(1), ref[f"{case}/scale"][r:r + 1], "scale")
    overflowed = bool(res[0][1].overflow)
    assert overflowed == case.endswith("overflow")
    assert res[0][1].n_buckets == (0 if case == "none" else 3)


@pytest.mark.parametrize("n", NS)
def test_sum_across_equals_psum(jax_results, n):
    """The rank-order fold gives the reference's CPU ``psum`` bits (wide
    dynamic range, so the order shows)."""
    xs = [torch.from_numpy(v) for v in sum_across_inputs(n)]
    got = transport.ThreadGroup(n, "cpu").run(
        lambda x: transport.current("x").sum_across(x), xs)
    for r in range(n):
        _assert_bitwise(got[r].numpy(), jax_results[n]["psum"][r], f"rank {r}")


@pytest.mark.parametrize("case", ["lorenzo", "entropy_abs", "entropy_overflow",
                                  "lossless", "none"])
def test_bucketed_equals_whole_tree_reference(case):
    n = 3
    bucketed = _port(n, case)
    whole = _port(n, case, grad_sync._dp_allreduce_whole_tree_stats)
    for (a, sa, _), (b, sb, _) in zip(bucketed, whole):
        for x, y in zip(_flat(a), _flat(b)):
            _assert_bitwise(x, y, case)
        assert (bool(sa.overflow), bool(sa.nonfinite), sa.wire_bytes, sa.n_buckets) == \
            (bool(sb.overflow), bool(sb.nonfinite), sb.wire_bytes, sb.n_buckets)


LEDGER_SHAPES = [
    [(3000,), (5000,), (7,), (2500,), (1088,)],
    [(10,)],
    [(4096,), (4096,)],
    [(1, 1), (0,), (300, 7), (5,)],
]


@pytest.mark.parametrize("bucket_bytes", [400, 64, 16384, 1 << 24])
@pytest.mark.parametrize("shapes", LEDGER_SHAPES)
def test_ledger_equals_reference(shapes, bucket_bytes):
    import jax.numpy as jnp

    from repro.core import buckets as jbuckets

    ours = buckets.build_ledger(shapes, bucket_bytes)
    ref = jbuckets.build_ledger(shapes, bucket_bytes)
    assert (ours.shapes, ours.bucket_elems, ours.total_elems) == \
        (ref.shapes, ref.bucket_elems, ref.total_elems)
    as_tuple = lambda b: (b.index, b.n_elems, tuple(  # noqa: E731
        (s.leaf, s.start, s.stop, s.offset) for s in b.slices))
    assert [as_tuple(b) for b in ours.buckets] == [as_tuple(b) for b in ref.buckets]
    assert [b.index for b in ours.issue_order()] == [b.index for b in ref.issue_order()]
    if ours.n_buckets <= 64:
        rng = np.random.default_rng(len(shapes))
        leaves = [rng.normal(size=int(np.prod(s))).astype(np.float32) for s in shapes]
        stacked = ours.stack_payloads([torch.from_numpy(a) for a in leaves])
        jstacked = ref.stack_payloads([jnp.asarray(a) for a in leaves])
        _assert_bitwise(stacked.numpy(), jstacked, "payload stack")
        for a, b in zip(ours.unstack(stacked), leaves):
            _assert_bitwise(a.numpy(), b, "unstack")


def test_ledger_cache_and_errors():
    buckets.clear_ledger_cache()
    a = buckets.ledger_for([(10,), (20,)], 64)
    assert buckets.ledger_for([(10,), (20,)], 64) is a
    assert buckets.ledger_cache_stats() == {"hits": 1, "misses": 1, "entries": 1}
    with pytest.raises(ValueError, match="zero elements"):
        buckets.build_ledger([(0,)], 64)
    with pytest.raises(ValueError, match="holds no"):
        buckets.build_ledger([(4,)], 2)


def test_flatten_order_and_errors():
    tree = {"b": [1, (2, 3)], "a": {"z": 4, "y": 5}}
    leaves, rebuild = grad_sync.tree_flatten(tree)
    assert leaves == [5, 4, 1, 2, 3]  # jax.tree.flatten's order
    assert rebuild([10, 20, 30, 40, 50]) == {"b": [30, (40, 50)], "a": {"z": 20, "y": 10}}
    for bad in (dict(pipeline_chunks=3), dict(pipeline_chunks=-1), dict(bucket_bytes=6)):
        with pytest.raises(ValueError):
            grad_sync.SyncConfig(**bad)
    with pytest.raises(ValueError, match="gz=None"):
        grad_sync.SyncConfig(gz=None).with_algo("ring")
    x = {"w": torch.ones(8)}
    group = transport.ThreadGroup(1, "cpu")
    # several axes run the two-level plan (ROADMAP A9) on a mesh binding them
    trees = [{"w": torch.linspace(-1, 1, 3000) * (r + 1)} for r in range(4)]
    res = transport.ThreadGroup(4, "cpu").run(
        lambda t: grad_sync.dp_allreduce_grads_stats(t, ("x", "y"), device="cpu"), trees,
        axis_name=("y", "x"), shape=(2, 2))
    exact = sum(t["w"].double() for t in trees)
    rms = float(torch.stack([t["w"].double() for t in trees]).pow(2).mean().sqrt())
    for out, st in res:  # one lossy hop (redoub over the 2 nodes) at eb * RMS
        assert not bool(st.degraded) and st.n_buckets == 1
        err = float((out["w"].double() - exact).abs().max())
        assert 0 < err <= 1.05 * 1e-4 * rms + 1e-6 * float(exact.abs().max())
    with pytest.raises(ValueError, match="axis_names is empty"):
        group.run(lambda t: grad_sync.dp_allreduce_grads(t, (), device="cpu"), [x])
    with pytest.raises(ValueError, match="empty gradient tree"):
        group.run(lambda t: grad_sync.dp_allreduce_grads({}, ("x",), device="cpu"), [x])


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
        res = _port(n, case)
        for r in range(n):
            for i, leaf in enumerate(_flat(res[r][0])):
                _assert_bitwise(ranks[r][f"{case}/leaf{i}"], leaf, f"{case} rank {r}")
            st = res[r][1]
            assert list(ranks[r][f"{case}/flags"]) == [bool(st.overflow), bool(st.nonfinite)]


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "jax":
        _jax_child(int(sys.argv[2]), sys.argv[3])
    else:
        _dist_child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    sys.exit(0)
