"""Tensor parallelism of the ssm, hybrid, MLA, encdec, vlm and audio
families (ROADMAP A11.7b, the family half) against the JAX package, on the
CPU.

The port's ``Model.loss_fn`` and ``decode_fn`` at ``tp_size > 1`` run on a
CPU ``ThreadMesh`` of ranks, each rank on its ``training._local`` block of
the global weights, for the smoke configs of mamba2-780m (ssm: 8 SSD heads
of 32, 2 a rank at tp = 4), zamba2-2.7b (hybrid: the same SSD layers and
one shared attention+MLP block of 4 heads over 4 kv heads after every 2
layers), minicpm3-4b (MLA: 4 heads, 1 a rank), seamless-m4t-medium (encdec:
2 encoder and 2 decoder layers, 4 heads over 4 kv, 16 encoder frames),
internvl2-26b (vlm: 4 heads over 2 kv, so the kv heads go to replication
groups of 2 ranks, and 16 prefix positions) and the audio family (the vlm
smoke config with ``family="audio"``: the reference has no audio config).
The SSD chunk is cut to 8 so the 16-token sequences cross a chunk
boundary.  One more case pads: minicpm3-4b's smoke config with 6 heads at
tp = 4, padded to 8 (``cfg.padded_heads``).  The padded heads' weights are
drawn like the others, in both packages (``blocks._pd`` draws every weight
``"scaled"``), so tp = 4 and tp = 1 are different functions there; the
padded case is held only against the reference at the same tp, with the
weights drawn from the tp = 4 definitions.

One JAX child, pinned to 8 host devices and started when this module's
first test runs, computes every reference value while the port-only tests
run: the weights (the reference's init from ``key(0)``, carried across
with ``convert.params_from_jax``), the reference's ``loss_fn`` under
``shard_map`` on ``(1, 4)`` and ``(2, 4)`` ``("data", "model")`` meshes
(every rank's loss), its ``decode_fn`` on ``(1, 4)`` (every rank's logits,
3 steps from an empty cache laid out by the reference's own
``launch.shapes.decode_specs``: the conv and SSD states and the kv heads
sharded over ``model``, ``conv_bc``, the MLA latent and ``enc_out``
replicated; ``enc_out`` a seeded draw), all in f32 (weights and
``cfg.dtype``), jitted; and each family's loss in bf16 at ``(1, 4)``.

Tolerances, relative to the largest value of the reference's result:

  * f32 losses and decode logits: 1e-5, as ``tests/test_torch_tp.py``: the
    GEMMs' summation order differs, and the TP reductions are the rank-order
    f32 sum here (``ParallelCtx.tp_reduce``, and ``ssm._tp_mean_sq``'s sum
    of squares) where XLA's CPU ``psum`` may add the four partials in
    another order, so these are tolerances, not bits.  The ranks of a run
    agree with each other by bits wherever the reference's do;
  * bf16 losses: 2e-3 against the jitted reference, the bound
    ``tests/test_torch_tp.py`` and the family files hold the bf16 losses
    to (measured at most 3.4e-4).  Where XLA fuses bf16 ops it keeps f32
    between them (ROADMAP C21: 1.1e-2 of the largest value of
    seamless-m4t-medium's compiled encoder output, from the eager one), so
    a bf16 layer is held against the reference under ``jax.disable_jit()``
    (``tests/test_torch_encdec.py``, ``test_torch_moe.py``); the loss is
    within 2e-3 of the compiled one in every family here, and the eager
    reference under ``shard_map`` took 70 s for the encdec loss alone;
  * port-only, tp = 4 against tp = 1 on the same weights: the reference
    child's own rtol, 0.02 (``tests/_mp_model_parallel_child.py``); the
    serve step at tp = 4 against ``decode_fn`` at tp = 1: 1e-5.

A gloo ``DistMesh`` at tp = 2 (two processes, no JAX) runs the ssm forward
and decode, equal by bits to the ``ThreadMesh`` run.
"""
import json
import os
import pathlib
import subprocess
import sys
import tempfile

if __name__ == "__main__" and sys.argv[1] == "jax":  # pin before JAX loads
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from _child_env import pin_device_count

    pin_device_count(8)

import dataclasses  # noqa: E402

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import transport
from repro_torch.launch import shapes, training
from repro_torch.models import blocks, mla, parallel, ssm
from repro_torch.models.model import Model
from test_torch_tp import (_bits, _blocks, _Child, _f32, _free_port, _paths, _rel, _setup,
                           port_losses)

HERE = pathlib.Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
AXES = ("data", "model")
ENCDEC, AUDIO, PADDED = "seamless-m4t-medium", "audio", "minicpm3-padded"
ARCHS = ("mamba2-780m", "zamba2-2.7b", "minicpm3-4b", ENCDEC, "internvl2-26b", AUDIO)
MESHES = ((1, 4), (2, 4))
B, S = 4, 16  # text tokens; the vlm and audio batches add 16 prefix rows
DECODE_B, DECODE_S, DECODE_STEPS = 2, 8, 3
SSM_CHUNK = 8
TOL = {"float32": 1e-5, "bfloat16": 2e-3}
CHILD_RTOL = 0.02  # tests/_mp_model_parallel_child.py, the non-moe families


def cfg_of(reg, arch, dtype="float32"):
    """``arch``'s smoke config in ``reg`` (either package's registry), with
    ``cfg.dtype`` ``dtype``: audio is the vlm config as the audio family,
    ``PADDED`` minicpm3-4b's with 6 heads, and the SSD chunk is
    ``SSM_CHUNK``."""
    base = {AUDIO: "internvl2-26b", PADDED: "minicpm3-4b"}.get(arch, arch)
    cfg = reg.get(base, smoke=True)
    kw = {"dtype": dtype}
    if arch == AUDIO:
        kw.update(family="audio", arch_id="audio-smoke")
    if arch == PADDED:
        kw.update(n_heads=6, n_kv_heads=6, arch_id="minicpm3-padded-smoke")
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, chunk=SSM_CHUNK)
    return dataclasses.replace(cfg, **kw)


def defs_tp(arch) -> int:
    """The tp of the definitions the weights are drawn from: the padded
    case's global shapes are its tp = 4 ones."""
    return 4 if arch == PADDED else 1


def batch_of(cfg, arch, b=B):
    rng = np.random.default_rng((ARCHS + (PADDED,)).index(arch))
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, S)).astype(np.int32)}
    batch["labels"][:, :2] = -1
    if cfg.family in ("vlm", "audio"):
        batch["prefix"] = rng.normal(0, 1, (b, cfg.n_prefix, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["enc_input"] = rng.normal(0, 1, (b, cfg.n_prefix, cfg.d_model)).astype(
            np.float32)
    return batch


def batch_specs(batch) -> dict:
    return {k: ("data",) + (None,) * (v.ndim - 1) for k, v in batch.items()}


def decode_tokens(cfg, arch):
    rng = np.random.default_rng(100 + (ARCHS + (PADDED,)).index(arch))
    return rng.integers(0, cfg.vocab, (DECODE_B, DECODE_STEPS)).astype(np.int32)


def enc_out_of(cfg):
    """The encdec cache's ``enc_out`` for the decode cases: a seeded draw."""
    rng = np.random.default_rng(200)
    return rng.normal(0, 1, (DECODE_B, cfg.n_prefix, cfg.d_model)).astype(np.float32)


def decode_shape():
    return shapes.InputShape("decode", DECODE_S, DECODE_B, "decode")


def _spec_entry(e):
    """A spec entry as the port writes it: one axis by its name."""
    if isinstance(e, tuple):
        return e[0] if len(e) == 1 else list(e) if e else None
    return e


# ---------------------------------------------------------------------------
# The JAX child
# ---------------------------------------------------------------------------


def _jax_child(out_path: str) -> None:
    import time

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.configs import registry as jregistry
    from repro.core.shmap import shard_map
    from repro.launch import shapes as jshapes
    from repro.models import model as jmodel
    from repro.models import parallel as jparallel

    res = {}
    devices = jax.devices()
    t0 = time.perf_counter()

    def stamp(what):
        print(f"{time.perf_counter() - t0:7.2f} s {what}", flush=True)

    def mesh_of(shape):
        return Mesh(np.array(devices[:shape[0] * shape[1]]).reshape(shape), AXES)

    def ctx_of(shape):
        return jparallel.ParallelCtx(tp_size=shape[1], fsdp_size=shape[0], dp_axes=("data",),
                                     remat="none")

    def loss(cfg, shape, params, batch):
        model = jmodel.Model(cfg, ctx_of(shape))
        specs = jparallel.param_specs(model.param_defs())
        bspecs = {k: P(*v) for k, v in batch_specs(batch).items()}
        f = shard_map(lambda p, b: model.loss_fn(p, b)[None], mesh=mesh_of(shape),
                      in_specs=(specs, bspecs), out_specs=P(AXES))
        return np.asarray(jax.jit(f)(params, batch))

    for arch in ARCHS + (PADDED,):
        cfg = cfg_of(jregistry, arch)
        defs = jmodel.Model(cfg, ctx_of((1, defs_tp(arch)))).param_defs()
        params = jparallel.init_params(defs, jax.random.key(0))
        for path, a in _paths(jax.tree.map(np.asarray, params)):
            res[f"w/{arch}/{path}"] = a.astype(np.float32)  # bf16 -> f32 is exact
        p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        batch = batch_of(cfg, arch)
        for shape in (MESHES if arch != PADDED else ((1, 4),)):
            res[f"loss/{arch}/{shape}"] = loss(cfg, shape, p32, batch)
        stamp(f"{arch} losses")

        # decode on (1, 4), the cache laid out by the reference's decode_specs
        mesh = mesh_of((1, 4))
        model = jmodel.Model(cfg, ctx_of((1, 4)))
        cache, cspecs, _, _, plan = jshapes.decode_specs(
            cfg, jshapes.InputShape("decode", DECODE_S, DECODE_B, "decode"), mesh, model)
        res[f"cache/{arch}"] = np.array(json.dumps(
            {k: [list(v.shape), [_spec_entry(e) for e in cspecs[k]]]
             for k, v in cache.items()}, sort_keys=True))
        cache = {k: jnp.zeros(v.shape, v.dtype) for k, v in cache.items()}
        if "enc_out" in cache:
            cache["enc_out"] = jnp.asarray(enc_out_of(cfg))
        specs = jparallel.param_specs(model.param_defs())

        def body(p, c, t, pos, model=model, plan=plan):
            logits, nc = model.decode_fn(p, c, t, pos, plan)
            return logits[None], nc

        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(specs, cspecs, P(), P()),
                              out_specs=(P("model"), cspecs)))
        toks = decode_tokens(cfg, arch)
        for pos in range(DECODE_STEPS):
            logits, cache = f(p32, cache, jnp.asarray(toks[:, pos:pos + 1]), jnp.int32(pos))
            res[f"decode/{arch}/{pos}"] = np.asarray(logits)
        stamp(f"{arch} decode")

        if arch != PADDED:  # bf16 at (1, 4)
            res[f"loss16/{arch}"] = loss(cfg_of(jregistry, arch, "bfloat16"), (1, 4), params,
                                         batch)
            stamp(f"{arch} bf16")
    np.savez(out_path, **res)


@pytest.fixture(scope="module", autouse=True)
def child(tmp_path_factory):
    kid = _Child(tmp_path_factory.mktemp("jax_tp_families"), __file__)
    try:
        yield kid
    finally:
        kid.close()


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _seeded(cfg, seed=3):
    """The port's own f32 weights for ``cfg``, drawn from ``seed``."""
    return convert.tree_map(lambda p: p.detach().to(torch.float32),
                            Model(cfg, device="cpu", seed=seed).params())


def _global_cache(cfg, setup):
    """The global decode cache of ``shapes.decode_specs`` (zeros; encdec's
    ``enc_out`` the seeded draw) and its specs and plan."""
    cache, cspecs, _, tspec, plan = shapes.decode_specs(cfg, decode_shape(), setup.mesh,
                                                        setup.model)
    cache = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in cache.items()}
    if "enc_out" in cache:
        cache["enc_out"].copy_(torch.from_numpy(enc_out_of(cfg)))
    return cache, cspecs, tspec, plan


def port_decode(cfg, whole, tokens, shape=(1, 4)) -> list:
    """Every rank's logits (ranks stacked) at each of the decode steps from
    an empty cache, each rank on its ``_local`` block (views) of the global
    cache of ``shapes.decode_specs``."""
    setup = _setup(cfg, shape)
    cache, cspecs, _, plan = _global_cache(cfg, setup)
    sizes = dict(zip(setup.mesh.axis_names, setup.mesh.shape))
    inputs = [(p, training._local(cache, cspecs, c, sizes))
              for p, c in zip(_blocks(setup, whole), training._coords(setup.mesh))]
    steps = []
    with torch.no_grad():
        for pos in range(DECODE_STEPS):
            tok = torch.from_numpy(tokens[:, pos:pos + 1])
            outs = setup.mesh.run(
                lambda a: setup.model.decode_fn(a[0], a[1], tok, pos, plan)[0], inputs)
            steps.append(np.stack([_f32(o) for o in outs]))
    return steps


# ---------------------------------------------------------------------------
# Port-only (they run while the child works)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tp", [2, 4])
def test_param_defs_have_the_same_global_shapes_at_every_tp(arch, tp):
    cfg = cfg_of(registry, arch)

    def shapes_at(tp):
        model = Model(cfg, parallel.ParallelCtx(tp_size=tp), params={}, device="cpu")
        return convert.tree_map(lambda d: d.shape, model.param_defs())

    assert shapes_at(tp) == shapes_at(1)


def test_padded_mla_heads_are_their_own_columns_and_rows():
    # 6 heads at tp = 4: 8 heads, 2 a rank; the latent projections and the
    # cache entry have no head dim
    cfg = cfg_of(registry, PADDED)
    m = cfg.mla
    defs = blocks.mla_defs(cfg, 4)
    assert cfg.padded_heads(4) == 8 and mla._heads_local(cfg, 4) == 2
    assert defs["wq_b"].shape == (m.q_lora_rank, 8 * (m.qk_nope_head_dim + m.qk_rope_head_dim))
    assert defs["wkv_b"].shape == (m.kv_lora_rank, 8 * (m.qk_nope_head_dim + m.v_head_dim))
    assert defs["wo"].shape == (8 * m.v_head_dim, cfg.d_model)
    assert blocks.mla_defs(cfg, 1)["wo"].shape == (6 * m.v_head_dim, cfg.d_model)
    assert defs["wq_a"].spec == defs["wkv_a"].spec == ("data", None)


def test_tp_mean_sq_sums_the_ranks_partials_in_rank_order():
    # the gated norm's second moment over the TP-sharded d_inner: every
    # rank's f32 sum of squares, summed over the ranks in rank order, over
    # the global count
    ctx = parallel.ParallelCtx(tp_size=4)
    rng = np.random.default_rng(0)
    ys = [torch.from_numpy(rng.normal(0, 1, (2, 3, 16)).astype(np.float32)) for _ in range(4)]
    outs = transport.ThreadGroup(4, "cpu").run(lambda y: ssm._tp_mean_sq(y, ctx), ys,
                                               axis_name="model")
    parts = [torch.sum(y * y, dim=-1, keepdim=True) for y in ys]
    want = (((parts[0] + parts[1]) + parts[2]) + parts[3]) / 64.0
    assert all(torch.equal(o, want) for o in outs)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp4_forward_is_within_the_reference_childs_rtol_of_tp1(arch):
    cfg = cfg_of(registry, arch)
    whole = _seeded(cfg)
    batch = batch_of(cfg, arch)
    with torch.no_grad():
        want = float(Model(cfg, params=whole, device="cpu").loss_fn(whole, batch))
    got = port_losses(cfg, (1, 4), whole, batch)
    assert np.all(np.abs(got - want) <= CHILD_RTOL * abs(want)), (got, want)
    assert np.all(_bits(got) == _bits(got[:1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_at_tp4_equals_tp1_decode(arch):
    cfg = cfg_of(registry, arch)
    whole = _seeded(cfg, seed=1)
    setup = _setup(cfg, (1, 4))
    cache4, cspecs, tspec, plan = _global_cache(cfg, setup)
    one = Model(cfg, params=whole, device="cpu")
    cache1 = {k: torch.zeros(v) for k, v in one.cache_defs(DECODE_B, plan).items()}
    if "enc_out" in cache1:
        cache1["enc_out"].copy_(cache4["enc_out"])
    step = training.make_serve_step(setup, cspecs, tspec, plan)
    toks = decode_tokens(cfg, arch)
    with torch.no_grad():
        for pos in range(DECODE_STEPS):
            t = torch.from_numpy(toks[:, pos:pos + 1])
            got, cache4 = step(_blocks(setup, whole), cache4, t, pos)
            want, _ = one.decode_fn(whole, cache1, t, pos, plan)
            assert tuple(got.shape) == tuple(want.shape) == (DECODE_B, 1, cfg.padded_vocab())
            assert _rel(_f32(got), _f32(want)) <= TOL["float32"], pos
    # the replicated entries hold tp = 1's values; the sharded ones its
    # values, each rank's block where the specs put it (with fewer kv heads
    # than ranks, a replication group's ranks each hold their group's head)
    for k, v in cache1.items():
        got = cache4[k]
        if k in ("k", "v") and got.shape[3] != v.shape[3]:
            rep = got.shape[3] // v.shape[3]
            assert all(torch.equal(got[:, :, :, i::rep], got[:, :, :, ::rep])
                       for i in range(rep)), k
            got = got[:, :, :, ::rep]
        assert got.shape == v.shape, k
        assert _rel(_f32(got), _f32(v)) <= TOL["float32"], k


# ---------------------------------------------------------------------------
# gloo: one process per rank, tp = 2
# ---------------------------------------------------------------------------

DIST_ARCH = "mamba2-780m"


def _dist_inputs():
    cfg = cfg_of(registry, DIST_ARCH)
    return cfg, _seeded(cfg, seed=2), batch_of(cfg, DIST_ARCH), decode_tokens(cfg, DIST_ARCH)


def _dist_child(rank: int, port: int, out_path: str) -> None:
    import torch.distributed as dist

    from repro_torch.core.transport import DistMesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    try:
        cfg, whole, batch, toks = _dist_inputs()
        mesh = DistMesh((1, 2), AXES)
        model = Model(cfg, parallel.ParallelCtx(tp_size=2, remat="none"), params={},
                      device="cpu")
        coord, sizes = {"data": 0, "model": rank}, {"data": 1, "model": 2}
        params = training._local(whole, parallel.param_specs(model.param_defs()), coord, sizes)
        cache, cspecs, _, _, plan = shapes.decode_specs(cfg, decode_shape(), mesh, model)
        cache = training._local({k: torch.zeros(v.shape) for k, v in cache.items()}, cspecs,
                                coord, sizes)
        res = {}
        with mesh.bind(), torch.no_grad():
            res["loss"] = np.float32(model.loss_fn(params, batch))
            for pos in range(DECODE_STEPS):
                logits, _ = model.decode_fn(params, cache, torch.from_numpy(
                    toks[:, pos:pos + 1]), pos, plan)
                res[f"decode/{pos}"] = _f32(logits)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def test_gloo_distmesh_ssm_at_tp2_equals_the_threadmesh():
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": SRC}
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, __file__, "dist", str(r), str(port),
                                   outs[r]], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True, env=env)
                 for r in range(2)]
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"gloo rank {r} failed:\n{logs[r]}"
        ranks = [dict(np.load(o)) for o in outs]
    cfg, whole, batch, toks = _dist_inputs()
    losses = port_losses(cfg, (1, 2), whole, batch)
    steps = port_decode(cfg, whole, toks, shape=(1, 2))
    for r in range(2):
        assert _bits(ranks[r]["loss"]) == _bits(losses[r])
        for pos in range(DECODE_STEPS):
            assert np.array_equal(_bits(ranks[r][f"decode/{pos}"]), _bits(steps[pos][r]))


# ---------------------------------------------------------------------------
# Against the JAX child
# ---------------------------------------------------------------------------


def _check_losses(got, want, tol):
    assert _rel(got, want) <= tol, (got, want)
    # the ranks that agree in the reference agree by bits here
    for i in range(len(want)):
        for j in range(len(want)):
            if want[i] == want[j]:
                assert _bits(got[i]) == _bits(got[j]), (i, j)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_the_references_shard_map(child, arch, shape):
    cfg = cfg_of(registry, arch)
    want = child.get()[f"loss/{arch}/{shape}"]
    got = port_losses(cfg, shape, child.weights(arch), batch_of(cfg, arch))
    _check_losses(got, want, TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS + (PADDED,))
def test_decode_matches_the_references_shard_map(child, arch):
    cfg = cfg_of(registry, arch)
    steps = port_decode(cfg, child.weights(arch), decode_tokens(cfg, arch))
    for pos, got in enumerate(steps):
        want = child.get()[f"decode/{arch}/{pos}"]
        assert _rel(got, want) <= TOL["float32"], pos
        assert all(np.array_equal(_bits(got[r]), _bits(got[0])) for r in range(4))


@pytest.mark.parametrize("arch", ARCHS + (PADDED,))
def test_decode_specs_match_the_references(child, arch):
    # the conv state's channels and the SSD state's heads over model, as
    # the kv heads; conv_bc, the MLA latent and enc_out replicated
    cfg = cfg_of(registry, arch)
    setup = _setup(cfg, (1, 4))
    cache, cspecs, _, _, _ = shapes.decode_specs(cfg, decode_shape(), setup.mesh, setup.model)
    got = {k: [list(v.shape), list(cspecs[k])] for k, v in cache.items()}
    assert got == json.loads(str(child.get()[f"cache/{arch}"]))


def test_padded_mla_loss_matches_the_reference(child):
    cfg = cfg_of(registry, PADDED)
    want = child.get()[f"loss/{PADDED}/(1, 4)"]
    got = port_losses(cfg, (1, 4), child.weights(PADDED), batch_of(cfg, PADDED))
    _check_losses(got, want, TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_matches_the_reference(child, arch):
    cfg = cfg_of(registry, arch, "bfloat16")
    want = child.get()[f"loss16/{arch}"]
    got = port_losses(cfg, (1, 4), child.weights(arch, "bfloat16"), batch_of(cfg, arch))
    assert _rel(got, want) <= TOL["bfloat16"], (got, want)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_child(sys.argv[2])
    else:
        _dist_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
