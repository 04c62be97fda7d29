"""The port's planning layer against the JAX package's.

* ``Plan`` fields, including the route table and the fallback plan, are
  equal to ``repro.core.comm``'s for N in {2, 3, 4, 6, 8}, message sizes
  on both sides of the ring/redoub crossovers, the ``auto``, ``paper``,
  ``throughput`` and ``accuracy`` policies, and both hardware points
  passed explicitly (the two packages default to different points).
* The same holds for all six ops at N in 2..13 (slab table included),
  and the 646 MB scatter plan provisions exactly the wire bytes and root
  chunk streams recorded in ``benchmarks/BENCH_scatter.json``.
* The same holds for every codec of the registry and for
  ``codec="auto"`` under every policy (the resolved codec, the
  ``fused_hop`` downgrade and the plan's notes included).
* Two-level ``HierPlan``s (every field, the sub-plans' too) are equal to
  the reference's for the topologies 1x4, 4x1, 2x3, 3x2, 2x4 and 4x2,
  every policy, every codec and both hardware points; the hier cache keys
  on the full topology tuple and counts hits and misses as the
  reference's does.
* The port's copies of ``schedule``, ``error_budget`` and ``cost_model``
  give the reference's outputs on a sweep, so the copies cannot drift.
"""
import dataclasses
import json
import pathlib

import pytest
import torch

from repro.core import comm as jcomm
from repro.core import cost_model as jcm
from repro.core import error_budget as jeb
from repro.core import schedule as jsched
from repro.core.collectives import GZConfig as JGZConfig
from repro_torch import convert
from repro_torch.core import comm, cost_model, error_budget, schedule, transport
from repro_torch.core.collectives import GZConfig

NS = (2, 3, 4, 6, 8)
SIZES = (1024, 1 << 18, 1 << 20, 4 << 20, 16 << 20, 64 << 20, 646_000_000 // 4)
HW = {"a100": (cost_model.A100_SLINGSHOT, jcm.A100_SLINGSHOT),
      "tpu": (cost_model.TPU_V5E, jcm.TPU_V5E)}


def _plans(n, n_elems, policy, hw, op="allreduce", **cfg):
    port_hw, ref_hw = HW[hw]
    ours = comm.GZCommunicator("x", config=GZConfig(**cfg), policy=policy,
                               hw=port_hw, axis_size=n, device="cpu")
    ref = jcomm.GZCommunicator("x", config=JGZConfig(**cfg), policy=policy,
                               hw=ref_hw, axis_size=n)
    return (ours.plan(op, (n_elems,), torch.float32),
            ref.plan(op, (n_elems,)))


def _assert_plans_equal(ours, ref):
    a, b = convert.plan_fields(ours), convert.plan_fields(ref)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], (k, a[k], b[k])


@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("policy", ["auto", "paper", "throughput", "accuracy"])
@pytest.mark.parametrize("n", NS)
def test_plan_fields_equal_reference(n, policy, hw):
    seen = set()
    for n_elems in SIZES:
        ours, ref = _plans(n, n_elems, policy, hw)
        _assert_plans_equal(ours, ref)
        seen.add((ours.algo, ours.pipeline_chunks))
    if policy == "auto" and hw == "a100" and n == 8:
        # both crossovers are inside the sweep: redoub, sequential and
        # pipelined ring all appear
        assert {("redoub", 1), ("ring", 1), ("ring", 2)} <= seen


@pytest.mark.parametrize("cfg", [
    dict(algo="ring", pipeline_chunks=2),
    dict(algo="ring", pipeline_chunks=4, capacity_factor=1.2),
    dict(algo="redoub", eb=1e-3, worst_case_budget=False),
    dict(algo="auto", capacity_factor=0.05),
])
@pytest.mark.parametrize("n", NS)
def test_explicit_config_plans_equal_reference(n, cfg):
    for n_elems in (5000, 1 << 20):
        _assert_plans_equal(*_plans(n, n_elems, "auto", "a100", **cfg))


@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("policy", ["auto", "paper", "throughput", "accuracy"])
@pytest.mark.parametrize("op", comm.OPS)
def test_every_op_plan_equals_reference(op, policy, hw):
    for n in range(2, 14):
        for n_elems in (1000, 5000 * n + 37, 1 << 20, 646_000_000 // 4):
            for cfg in ({}, dict(pipeline_chunks=2),
                        dict(fused=False, fused_hop=False, capacity_factor=1.2)):
                ours, ref = _plans(n, n_elems, policy, hw, op, **cfg)
                _assert_plans_equal(ours, ref)
                assert (ours.slab_table != ()) == (op in ("scatter", "broadcast"))


@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("policy", ["auto", "paper", "throughput", "accuracy"])
@pytest.mark.parametrize("codec", ["lorenzo", "lorenzo+entropy", "lossless",
                                   "passthrough", "auto"])
def test_codec_plans_equal_reference(codec, policy, hw):
    resolved = set()
    for op in comm.OPS:
        for n in range(2, 14):
            for n_elems in (1000, 5000 * n + 37, 1 << 20, 646_000_000 // 4):
                for cfg in ({}, dict(pipeline_chunks=2),
                            dict(fused=False, fused_hop=False, capacity_factor=1.2)):
                    ours, ref = _plans(n, n_elems, policy, hw, op, codec=codec, **cfg)
                    _assert_plans_equal(ours, ref)
                    resolved.add(ours.codec)
                    if ours.codec != "lorenzo" and cfg.get("fused_hop", True):
                        assert not ours.fused_hop and any(
                            "fused_hop off" in note for note in ours.notes)
                    if codec not in ("auto", ours.codec):  # intring's own wire
                        assert ours.algo == "intring" and any(
                            "intring ships" in note for note in ours.notes)
    if codec != "auto":
        assert codec in resolved
    elif policy in ("auto", "throughput"):
        assert resolved <= {"lorenzo", "lorenzo+entropy", "lossless"}
    else:
        assert resolved == {"lorenzo"}


def test_codec_auto_picks_like_reference_at_every_size():
    """``codec="auto"`` ranks the candidates by the op's modeled time; the
    pick and its note equal the reference's, and the sweep reaches more
    than one codec."""
    picks = set()
    for hw in sorted(HW):
        for n in (2, 3, 8):
            for n_elems in (256, 4096, 1 << 16, 1 << 20, 1 << 24):
                ours, ref = _plans(n, n_elems, "auto", hw, codec="auto")
                _assert_plans_equal(ours, ref)
                assert ours.notes[0].startswith(f"codec auto->{ours.codec!r}")
                picks.add(ours.codec)
    assert len(picks) > 1, picks


def test_scatter_plan_equals_bench_scatter():
    """The Fig. 12 scatter (646 MB at the root) provisions the recorded
    wire bytes and n-1 root chunk streams for every N in the file."""
    path = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / "BENCH_scatter.json"
    records = json.loads(path.read_text())["scatter"]
    assert records
    for n_str, rec in records.items():
        n = int(n_str)
        plan = comm.GZCommunicator("x", axis_size=n, device="cpu").plan(
            "scatter", (646_000_000 // 4,))
        assert (plan.algo, plan.pipeline_chunks) == ("binomial", 1)
        assert plan.wire_bytes == rec["wire_bytes"], n
        assert round(plan.ratio, 4) == rec["provisioned_ratio"], n
        root_streams = sum(h.chunk_slab[1] for rnd in plan.route_table.rounds
                           for h in rnd if h.sender == 0)
        assert root_streams == rec["chunk_streams"] == \
            cost_model.scatter_root_chunk_streams(n), n


def test_default_planning_point_is_the_papers_gpu():
    c = comm.GZCommunicator("x", axis_size=8, device="cpu")
    assert c.hw == cost_model.A100_SLINGSHOT
    p = c.plan("allreduce", (646_000_000 // 4,))
    assert (p.algo, p.pipeline_chunks) == ("ring", 2)
    assert c.plan("allreduce", (16_000_000 // 4,)).algo == "redoub"


def test_plan_cache_one_entry_per_key():
    comm.clear_plan_cache()
    c = comm.GZCommunicator("x", axis_size=4, device="cpu")
    p1 = c.plan("allreduce", (4096,))
    p2 = c.plan("allreduce", 4096)
    assert p1 is p2
    c.plan("allreduce", (8192,))
    stats = comm.plan_cache_stats()
    assert (stats["entries"], stats["hits"], stats["misses"]) == (2, 1, 2)
    assert stats["by_codec"]["lorenzo"]["entries"] == 2
    assert stats["by_op"]["allreduce"] == {"hits": 1, "misses": 2, "entries": 2,
                                           "hier_entries": 0}


TOPOLOGIES = ((1, 4), (4, 1), (2, 3), (3, 2), (2, 4), (4, 2))


def _hier_plans(topo, n_elems, policy, hw, **cfg):
    port_hw, ref_hw = HW[hw]
    ours = comm.GZHierCommunicator("node", "local", config=GZConfig(**cfg), policy=policy,
                                   hw=port_hw, topology=topo, device="cpu")
    ref = jcomm.GZHierCommunicator("node", "local", config=JGZConfig(**cfg), policy=policy,
                                   hw=ref_hw, topology=topo)
    return ours.plan((n_elems,), torch.float32), ref.plan((n_elems,))


@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("policy", ["auto", "paper", "throughput", "accuracy"])
def test_hier_plans_equal_reference(policy, hw):
    """Every ``HierPlan`` field (``flat``, ``inter``, ``flat_plan``, the
    intra and inter wire bytes, ``t_model``, ``t_flat``, ``codec``, the
    route table, the fallback) equals the reference's for every topology,
    codec and size; the hierarchical branch appears where the point has a
    link asymmetry and L > 1."""
    branches = set()
    for topo in TOPOLOGIES:
        for codec in ("lorenzo", "lorenzo+entropy", "lossless", "passthrough", "auto"):
            for n_elems in (1000, 5000 * topo[1] + 37, 1 << 20, 646_000_000 // 4):
                for cfg in ({}, dict(pipeline_chunks=2, on_overflow="fallback"),
                            dict(fused=False, fused_hop=False, capacity_factor=1.2)):
                    ours, ref = _hier_plans(topo, n_elems, policy, hw, codec=codec, **cfg)
                    _assert_plans_equal(ours, ref)
                    assert ours.ratio == ref.ratio
                    branches.add(ours.flat)
                    if hw == "tpu" or topo[1] == 1:
                        assert ours.flat
    assert branches == ({True} if hw == "tpu" else {True, False})


def test_hier_plan_cache_keys_on_the_topology_tuple():
    """2x3 and 3x2 are distinct entries (a cache keyed on the rank product
    would reuse the wrong shard size); hits and misses are counted in the
    totals, by codec and by op, as the reference counts them."""
    stats = {}
    for mod, cfg_cls, hw, kw in ((comm, GZConfig, cost_model.A100_SLINGSHOT,
                                  {"device": "cpu"}),
                                 (jcomm, JGZConfig, jcm.A100_SLINGSHOT, {})):
        mod.clear_plan_cache()
        plans = {}
        for topo in ((2, 3), (3, 2), (2, 3)):
            c = mod.GZHierCommunicator("node", "local", config=cfg_cls(codec="lossless"),
                                       hw=hw, topology=topo, **kw)
            plans.setdefault(topo, []).append(c.plan((4096,)))
        assert plans[(2, 3)][0] is plans[(2, 3)][1]
        assert plans[(2, 3)][0].inter.axis_size == 2
        assert plans[(3, 2)][0].inter.axis_size == 3
        st = mod.plan_cache_stats()
        assert {k[3] for k in st["hier_keys"]} == {(2, 3), (3, 2)}
        stats[mod.__name__] = {k: v for k, v in st.items() if k not in ("keys", "hier_keys")}
    assert stats["repro_torch.core.comm"] == stats["repro.core.comm"]
    st = stats["repro.core.comm"]
    assert (st["hier_entries"], st["by_op"]["allreduce"]["hier_entries"]) == (2, 2)
    assert st["by_codec"]["lossless"]["hier_entries"] == 2


def test_config_validation_matches_reference():
    for bad in (dict(pipeline_chunks=3), dict(pipeline_chunks=0),
                dict(capacity_factor=0.0), dict(capacity_factor=2.5),
                dict(on_overflow="ignore")):
        with pytest.raises(ValueError):
            JGZConfig(**bad)
        with pytest.raises(ValueError):
            GZConfig(**bad)
    for bad in ("zstd", "AUTO"):
        with pytest.raises(ValueError, match="unknown codec"):
            JGZConfig(codec=bad)
        with pytest.raises(ValueError, match="unknown codec"):
            GZConfig(codec=bad)
    for ok in ("lossless", "lorenzo+entropy", "passthrough", "auto"):
        assert GZConfig(codec=ok).codec == JGZConfig(codec=ok).codec == ok


@pytest.mark.parametrize("cfg,item", [
    (dict(algo="intring"), "A9"),
    (dict(fused=False), None),
    (dict(on_overflow="fallback"), None),
    (dict(verify_streams=True), None),
])
def test_outside_the_slice_raises(cfg, item):
    """Knobs once outside the port now run the allreduce and the
    reduce-scatter within the bound: ``intring`` (ported with ROADMAP
    ``item`` A9; its bound is N eb, one quantization grid for N addends,
    and every rank gets the same bits), the two-pass codec
    (``fused=False``), the ``fallback`` policy and ``verify_streams``
    (A8).  A reduce-scatter plan is always ``ring``, whatever the
    allreduce's algorithm."""
    c = comm.GZCommunicator("x", config=GZConfig(**cfg), axis_size=2, device="cpu")
    xs = [torch.linspace(0, 1, 300), torch.ones(300)]
    group = transport.ThreadGroup(2, "cpu")
    res = group.run(c.allreduce, xs)
    hops = 2 if item == "A9" else 1
    assert (res[0].value - (xs[0] + 1)).abs().max() <= hops * 1.05e-4
    assert not any(bool(r.overflow) or bool(r.nonfinite) for r in res)
    if item == "A9":
        assert c.plan("allreduce", (300,)).algo == "intring"
        assert torch.equal(res[0].value, res[1].value)
    res = group.run(c.reduce_scatter, xs)
    for r in range(2):
        want = (xs[0] + 1)[r * 150:(r + 1) * 150]
        assert (res[r].value - want).abs().max() <= 1.05e-4


# ---------------------------------------------------------------------------
# The copied pure-Python modules
# ---------------------------------------------------------------------------


def test_schedule_copy_equals_reference():
    for (op, algo) in jsched._BUILDERS:
        for n in range(2, 14):
            ours, ref = schedule.build(op, algo, n), jsched.build(op, algo, n)
            assert dataclasses.astuple(ours) == dataclasses.astuple(ref), (op, algo, n)
            schedule.validate(ours)
            assert schedule.lossy_hop_count(ours) == jsched.lossy_hop_count(ref)
            assert schedule.sender_entry_counts(ours) == jsched.sender_entry_counts(ref)
    assert set(schedule._BUILDERS) == set(jsched._BUILDERS)
    for n in range(1, 34):
        assert schedule.ring_perm(max(n, 2)) == jsched.ring_perm(max(n, 2))
        assert schedule.redoub_layout(n)[:2] == jsched.redoub_layout(n)[:2]
        p, rem, phys = schedule.redoub_layout(n)
        assert [phys(v) for v in range(p)] == [jsched.redoub_layout(n)[2](v) for v in range(p)]
        assert schedule.binomial_slab_table(n) == jsched.binomial_slab_table(n)
        assert schedule.scatter_root_chunk_streams(n) == jsched.scatter_root_chunk_streams(n)
        if n >= 2:
            assert [t[:3] for t in schedule.tree_plan(n)] == [t[:3] for t in jsched.tree_plan(n)]
    for nodes, local in ((2, 3), (3, 2), (2, 4), (4, 8)):
        for inter in ("ring", "redoub"):
            assert dataclasses.astuple(schedule.build_hier(nodes, local, inter)) == \
                dataclasses.astuple(jsched.build_hier(nodes, local, inter))


def test_error_budget_copy_equals_reference():
    for key in schedule._ALGO_KEYS:
        for n in range(1, 34):
            assert error_budget.lossy_hops(key, n) == jeb.lossy_hops(key, n)
            for wc in (True, False):
                assert error_budget.allocate(1e-4, key, n, worst_case=wc) == \
                    jeb.allocate(1e-4, key, n, worst_case=wc)
            assert error_budget.compression_events(key, n) == \
                jeb.compression_events(key, n)
    for flags in ((True,), (False, True, False), (True, True), (False,)):
        assert error_budget.split_lossy(3e-4, flags) == jeb.split_lossy(3e-4, flags)


def test_cost_model_copy_equals_reference():
    assert set(cost_model.__all__) == set(jcm.__all__)
    for name in ("A100_SLINGSHOT", "TPU_V5E"):
        assert dataclasses.asdict(getattr(cost_model, name)) == \
            dataclasses.asdict(getattr(jcm, name))
    for hw, jhw in HW.values():
        for D in (4e3, 1e6, 5e6, 64e6, 646e6):
            for fn in ("t_compress", "t_decompress", "t_hop_fused", "t_net",
                       "t_reduce", "t_net_intra"):
                assert getattr(cost_model, fn)(D, hw) == getattr(jcm, fn)(D, jhw)
            for N in (2, 3, 5, 8, 12, 64):
                for R in (1.6, 20.0):
                    for fn in ("allreduce_ring_gz", "allreduce_intring_gz",
                               "allreduce_cprp2p", "allreduce_ccoll",
                               "scatter_binomial_gz", "allgather_ring_gz",
                               "best_scatter_pipeline_chunks"):
                        assert getattr(cost_model, fn)(D, N, R, hw) == \
                            getattr(jcm, fn)(D, N, R, jhw), (fn, D, N, R)
                    for fh in (True, False):
                        assert cost_model.allreduce_redoub_gz(D, N, R, hw, fused_hop=fh) == \
                            jcm.allreduce_redoub_gz(D, N, R, jhw, fused_hop=fh)
                        assert cost_model.best_pipeline_chunks(D, N, R, hw, fused_hop=fh) == \
                            jcm.best_pipeline_chunks(D, N, R, jhw, fused_hop=fh)
                        for ch in (1, 2, 8):
                            assert cost_model.allreduce_ring_gz_chunked(
                                D, N, R, hw, ch, fused_hop=fh) == \
                                jcm.allreduce_ring_gz_chunked(D, N, R, jhw, ch, fused_hop=fh)
                    assert cost_model.scatter_binomial_gz_chunked(D, N, R, hw, 4) == \
                        jcm.scatter_binomial_gz_chunked(D, N, R, jhw, 4)
                    assert cost_model.allreduce_hier_gz(D, N, 4, R, hw) == \
                        jcm.allreduce_hier_gz(D, N, 4, R, jhw)
                assert cost_model.allreduce_uncompressed_ring(D, N, hw) == \
                    jcm.allreduce_uncompressed_ring(D, N, jhw)
                assert cost_model.scatter_uncompressed_binomial(D, N, hw) == \
                    jcm.scatter_uncompressed_binomial(D, N, jhw)
                for op in comm.OPS:
                    assert cost_model.fallback_time(op, D, N, hw) == \
                        jcm.fallback_time(op, D, N, jhw)
                assert dataclasses.astuple(cost_model.best_bucket_plan(hw, D, 1e12, N)) \
                    == dataclasses.astuple(jcm.best_bucket_plan(jhw, D, 1e12, N))
    for algo in ("redoub", "binomial", "ring", "intring", "direct"):
        for n in range(1, 20):
            assert cost_model.steps_for(algo, n) == jcm.steps_for(algo, n)
    assert cost_model.expected_collective_time(1.0, 2.0, 0.1) == \
        jcm.expected_collective_time(1.0, 2.0, 0.1)
    terms = cost_model.CodecTerms("lorenzo", ratio_scale=1.3, cmp_peak_gbps=5.0)
    jterms = jcm.CodecTerms("lorenzo", ratio_scale=1.3, cmp_peak_gbps=5.0)
    assert terms.effective_ratio(7.0) == jterms.effective_ratio(7.0)
    assert dataclasses.asdict(terms.apply(cost_model.A100_SLINGSHOT)) == \
        dataclasses.asdict(jterms.apply(jcm.A100_SLINGSHOT))


def test_select_allreduce_equals_reference():
    for hw, jhw in HW.values():
        for D in (1e5, 4e6, 16e6, 64e6, 646e6):
            for N in NS:
                assert comm.select_allreduce(D, N, 20.0, hw) == \
                    jcomm.select_allreduce(D, N, 20.0, jhw)
                for beyond in (False, True):
                    assert comm.select_allreduce_plan(
                        D, N, 20.0, hw, allow_beyond_paper=beyond) == \
                        jcomm.select_allreduce_plan(D, N, 20.0, jhw,
                                                    allow_beyond_paper=beyond)
