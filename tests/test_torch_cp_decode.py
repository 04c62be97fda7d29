"""The context-parallel decode cache (ROADMAP A11.7b, last part) against the
JAX package, on the CPU.

A decode batch that cannot fill the ``data`` axis (batch 1 on a mesh with
``data`` 2) splits the k and v caches' context over ``data``
(``KVCacheSpec.cp_size`` 2): each rank writes the new token's k and v only
where its slice holds the slot, attends over its slice, and the partial
softmaxes combine over the ``data`` handle (``attention_decode``'s
flash-decoding).  The port's ``launch.training.make_serve_step`` runs on a
CPU ``ThreadMesh((2, 2))`` of ``("data", "model")``, with the weights
replicated over ``data`` (``fsdp=False``) and split over ``model``, and
the cache laid out by ``launch.shapes.decode_specs`` for a batch-1 shape.

One JAX child, pinned to 4 host devices and started when this module's
first test runs, computes the reference's values while the port-only
tests run: the weights (the reference's init from ``key(0)``, carried
across with ``convert.params_from_jax``), and its ``decode_fn`` under
``shard_map`` on the same mesh, jitted, from a cache laid out by its own
``launch.shapes.decode_specs``, in f32 (weights and ``cfg.dtype``).  The
smoke configs: minitron-8b (dense), phi3.5-moe-42b-a6.6b (moe, capacity
factor 8 as ``tests/test_torch_tp.py``), zamba2-2.7b (hybrid: k and v in
its shared block), seamless-m4t-medium (encdec), internvl2-26b (vlm) and
audio (the vlm config with ``family="audio"``), each unwindowed (a
16-slot cache, 8 a rank) and windowed (a ring of 8 slots, 4 a rank); and
minicpm3-4b (MLA: its latent keeps ``s_total``, replicated over ``data``)
and mamba2-780m (ssm: no context dim) at cp 2.  Every cache starts from
seeded random values, as a prefill would have left them, and the decode
runs ``STEPS`` tokens from position ``START``: the slot written moves from
data rank 0's slice to rank 1's, and the window's ring wraps.

Tolerances: the f32 logits within 1e-5 of the reference's largest logit at
every step (``tests/test_torch_tp_families.py``'s bound: another summation
order in the GEMMs and the reductions); the returned caches equal by bits
wherever the reference's kept its input (every slot no step wrote, on
every rank: nothing written off its owner), the rest within 1e-5 of the
largest value.  Port-only: under the split no two data ranks' blocks of a
replicated cache leaf share storage; the four-way fold at ``(data 4,
model 1)`` against the unsplit decode at 1e-5; and at ``cp_size == 1``
``attention_decode`` equal by bits to its form before the split
(``_decode_unsplit``).
"""
import dataclasses
import json
import pathlib
import sys

if __name__ == "__main__" and sys.argv[1] == "jax":  # pin before JAX loads
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from _child_env import pin_device_count

    pin_device_count(4)

import numpy as np  # noqa: E402
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import shapes, training
from repro_torch.launch.mesh import ThreadMesh
from repro_torch.models import attention, parallel
from repro_torch.models.layers import apply_rope, rope
from repro_torch.models.model import Model
from test_torch_tp import _Child, _bits, _blocks, _f32, _paths, _rel, _setup

AXES = ("data", "model")
MESH = (2, 2)
PHI, AUDIO = "phi3.5-moe-42b-a6.6b", "audio"
KV_ARCHS = ("minitron-8b", PHI, "zamba2-2.7b", "seamless-m4t-medium", "internvl2-26b", AUDIO)
OTHER_ARCHS = ("minicpm3-4b", "mamba2-780m")  # MLA, ssm: no context split
S_TOTAL, WINDOW = 16, 8  # the unwindowed cache's slots; the ring's
START, STEPS = 4, 8  # positions 4..11: slot 8 is data rank 1's first
TOL = 1e-5
CASES = tuple(f"{a}/w{w}" for a in KV_ARCHS for w in (0, WINDOW)) + tuple(
    f"{a}/w0" for a in OTHER_ARCHS)


def cfg_of(reg, arch):
    """``arch``'s smoke config in ``reg`` (either package's registry), f32:
    audio is the vlm config as the audio family; the moe config at
    capacity factor 8."""
    cfg = reg.get("internvl2-26b" if arch == AUDIO else arch, smoke=True)
    kw = {"dtype": "float32"}
    if arch == AUDIO:
        kw.update(family="audio", arch_id="audio-smoke")
    if cfg.family == "moe":
        kw["capacity_factor"] = 8.0
    return dataclasses.replace(cfg, **kw)


def split(case):
    arch, w = case.rsplit("/w", 1)
    return arch, int(w)


def decode_shape():
    return shapes.InputShape("cp-decode", S_TOTAL, 1, "decode")


def windowed(plan, window):
    return dataclasses.replace(plan, window=window)


def global_shapes(cache, plan) -> dict:
    """The global shape of each entry of ``decode_specs``' cache under
    ``plan`` (a windowed plan's k and v hold ``window`` slots)."""
    out = {}
    for k, v in cache.items():
        shp = list(v.shape)
        if k in ("k", "v"):
            shp[2] = plan.s_local * plan.cp_size
        out[k] = tuple(shp)
    return out


def cache_np(case, shps: dict) -> dict:
    """The prefilled global cache: seeded normal draws, the same in both
    packages."""
    rng = np.random.default_rng(CASES.index(case))
    return {k: rng.normal(0, 1, shps[k]).astype(np.float32) for k in sorted(shps)}


def tokens_of(cfg, case):
    rng = np.random.default_rng(100 + CASES.index(case))
    return rng.integers(0, cfg.vocab, (1, STEPS)).astype(np.int32)


def _spec_entry(e):
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
    from repro.launch import training as jtraining
    from repro.models import parallel as jparallel

    res = {}
    t0 = time.perf_counter()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(MESH), AXES)
    weights = {}
    for case in CASES:
        arch, window = split(case)
        cfg = cfg_of(jregistry, arch)
        setup = jtraining.make_setup(cfg, mesh, fsdp=False, remat="none")
        if arch not in weights:
            params = jparallel.init_params(setup.defs, jax.random.key(0))
            weights[arch] = jax.tree.map(lambda a: a.astype(jnp.float32), params)
            for path, a in _paths(jax.tree.map(np.asarray, weights[arch])):
                res[f"w/{arch}/{path}"] = a
        cache, cspecs, _, tspec, plan = jshapes.decode_specs(
            cfg, jshapes.InputShape("cp-decode", S_TOTAL, 1, "decode"), mesh, setup.model)
        plan = windowed(plan, window)
        shps = global_shapes(cache, plan)
        res[f"layout/{case}"] = np.array(json.dumps(
            {"cache": {k: [list(shps[k]), [_spec_entry(e) for e in cspecs[k]]]
                       for k in cache},
             "tokens": [_spec_entry(e) for e in tspec],
             "plan": [plan.s_total, plan.cp_axis, plan.cp_size, plan.window]},
            sort_keys=True))
        c = {k: jnp.asarray(v) for k, v in cache_np(case, shps).items()}

        def body(p, c, t, pos, model=setup.model, plan=plan):
            logits, nc = model.decode_fn(p, c, t, pos, plan)
            return logits[None], nc

        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(setup.specs, cspecs, tspec, P()),
                              out_specs=(P(AXES), cspecs)))
        toks = tokens_of(cfg, case)
        for i in range(STEPS):
            logits, c = f(weights[arch], c, jnp.asarray(toks[:, i:i + 1]),
                          jnp.int32(START + i))
            res[f"logits/{case}/{i}"] = np.asarray(logits)
        for k, v in c.items():
            res[f"cache/{case}/{k}"] = np.asarray(v)
        print(f"{time.perf_counter() - t0:7.2f} s {case}", flush=True)
    np.savez(out_path, **res)


@pytest.fixture(scope="module", autouse=True)
def child(tmp_path_factory):
    kid = _Child(tmp_path_factory.mktemp("jax_cp_decode"), __file__)
    try:
        yield kid
    finally:
        kid.close()


# ---------------------------------------------------------------------------
# The port
# ---------------------------------------------------------------------------


def _seeded(cfg, seed=3):
    return convert.tree_map(lambda p: p.detach().to(torch.float32),
                            Model(cfg, device="cpu", seed=seed).params())


def port_layout(cfg, window, shape=MESH):
    """(setup, global cache shapes, cache specs, tokens spec, plan) at
    ``shape``, the weights replicated over ``data``."""
    setup = _setup(cfg, shape, fsdp=False)
    cache, cspecs, _, tspec, plan = shapes.decode_specs(cfg, decode_shape(), setup.mesh,
                                                        setup.model)
    plan = windowed(plan, window)
    return setup, global_shapes(cache, plan), cspecs, tspec, plan


def port_decode(case, cfg, whole, shape=MESH):
    """Each step's logits and the final global cache of ``make_serve_step``
    from the prefilled cache."""
    _, window = split(case)
    setup, shps, cspecs, tspec, plan = port_layout(cfg, window, shape)
    cache = {k: torch.from_numpy(v) for k, v in cache_np(case, shps).items()}
    step = training.make_serve_step(setup, cspecs, tspec, plan)
    params = _blocks(setup, whole)
    toks = tokens_of(cfg, case)
    logits = []
    with torch.no_grad():
        for i in range(STEPS):
            out, cache = step(params, cache, torch.from_numpy(toks[:, i:i + 1]), START + i)
            logits.append(_f32(out))
    return logits, cache


# ---------------------------------------------------------------------------
# Port-only (they run while the child works)
# ---------------------------------------------------------------------------


def test_the_split_plan_and_layout():
    cfg = cfg_of(registry, "zamba2-2.7b")
    setup, shps, cspecs, tspec, plan = port_layout(cfg, 0)
    assert (plan.cp_axis, plan.cp_size, plan.s_local) == ("data", 2, S_TOTAL // 2)
    assert tspec == (None, None)
    # the context of k and v over data, their kv heads over model; the
    # states whole over data
    assert cspecs["k"] == cspecs["v"] == (None, None, "data", "model", None)
    assert "data" not in cspecs["conv_x"] + cspecs["conv_bc"] + cspecs["ssm"]
    assert shps["k"][1:3] == (1, S_TOTAL)
    assert windowed(plan, WINDOW).s_local == WINDOW // 2


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "seamless-m4t-medium", "minicpm3-4b"])
def test_no_two_data_ranks_share_a_replicated_cache_leaf(arch, monkeypatch):
    cfg = cfg_of(registry, arch)
    setup, shps, cspecs, tspec, plan = port_layout(cfg, 0)
    cache = {k: torch.zeros(v) for k, v in shps.items()}
    seen = []
    real = type(setup.mesh).run

    def spy(mesh, fn, inputs):
        seen.append([a[1] for a in inputs])
        return real(mesh, fn, inputs)

    monkeypatch.setattr(type(setup.mesh), "run", spy)
    step = training.make_serve_step(setup, cspecs, tspec, plan)
    with torch.no_grad():
        step(_blocks(setup, _seeded(cfg)), cache, torch.zeros((1, 1), dtype=torch.int32),
             START)
    (blocks,) = seen
    coords = training._coords(setup.mesh)
    replicated = [k for k in cache if "data" not in cspecs[k]]
    assert replicated and set(replicated) <= {"mla", "conv_x", "conv_bc", "ssm", "enc_out"}

    def ptr(t):
        return t.untyped_storage().data_ptr()

    for k in cache:
        for r, cr in enumerate(coords):
            for q, cq in enumerate(coords):
                if cr["data"] != cq["data"] and k in replicated:
                    assert ptr(blocks[r][k]) != ptr(blocks[q][k]), (k, cr, cq)
            # data rank 0's blocks, and every rank's k and v, are views of
            # the global cache, so the step's writes land there
            if cr["data"] == 0 or k not in replicated:
                assert ptr(blocks[r][k]) == ptr(cache[k]), (k, cr)


def test_four_way_fold_matches_the_unsplit_decode():
    # (data 4, model 1): the slot written moves from rank 1's slice to rank
    # 2's (slots 4..11 at 4 a rank), against the unsplit decode on (1, 1)
    # of the same weights and cache
    case = "minitron-8b/w0"
    cfg = cfg_of(registry, "minitron-8b")
    whole = _seeded(cfg)
    got, gcache = port_decode(case, cfg, whole, shape=(4, 1))
    want, wcache = port_decode(case, cfg, whole, shape=(1, 1))
    for i in range(STEPS):
        assert _rel(got[i], want[i]) <= TOL, i
    written = START + np.arange(STEPS)
    for k in ("k", "v"):
        g, w = _f32(gcache[k]), _f32(wcache[k])
        keep = np.ones(g.shape[2], bool)
        keep[written] = False
        assert np.array_equal(_bits(g[:, :, keep]), _bits(w[:, :, keep])), k
        # the first layer's new rows take no combine on their way: by bits
        assert np.array_equal(_bits(g[0]), _bits(w[0])), k
        assert _rel(g, w) <= TOL, k


def _decode_unsplit(h, w, cache_k, cache_v, pos, cfg, ctx, spec):
    """``attention_decode`` as it was before the context split: every slot
    the rank's own, no combine."""
    b = h.shape[0]
    hd = cfg.head_dim
    pos = int(pos)
    dev = h.device
    h_local = cfg.padded_heads(ctx.tp_size) // ctx.tp_size
    q = torch.matmul(h, w["wq"]).reshape(b, 1, h_local, hd)
    k_new = torch.matmul(h, w["wk"]).reshape(b, 1, cfg.n_kv_heads, hd)
    v_new = torch.matmul(h, w["wv"]).reshape(b, 1, cfg.n_kv_heads, hd)
    sin, cos = rope(torch.arange(pos, pos + 1, device=dev), hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k_new = attention._local_kv(apply_rope(k_new, sin, cos), cfg, ctx)
    v_new = attention._local_kv(v_new, cfg, ctx)
    s_local = spec.s_local
    slot = pos % spec.window if spec.window else pos
    if 0 <= slot < s_local:
        cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)
    slot_ids = torch.arange(s_local, device=dev)
    if spec.window:
        cycle = (pos // spec.window) * spec.window + slot_ids
        slot_pos = torch.where(cycle <= pos, cycle, cycle - spec.window)
        valid = (slot_pos >= 0) & (slot_pos > pos - spec.window)
    else:
        valid = slot_ids <= pos
    n_rep = h_local // k_new.shape[-2]
    kk = attention._repeat_kv(cache_k, n_rep)
    vv = attention._repeat_kv(cache_v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * attention._scale(hd),
                          kk.to(torch.float32))
    logits = torch.where(valid[None, None, None, :], logits, attention._neg(dev))
    m = torch.amax(logits, dim=-1)
    p = torch.exp(logits - m[..., None])
    s = torch.sum(p, dim=-1)
    o = torch.einsum("bhqk,bkhd->bhqd", p, vv.to(torch.float32))
    out = (o / torch.clamp(s, min=1e-30)[..., None]).to(h.dtype)
    out = torch.movedim(out, 1, 2).reshape(b, 1, h_local * hd)
    return ctx.tp_reduce(torch.matmul(out, w["wo"])), cache_k, cache_v


@pytest.mark.parametrize("window", [0, WINDOW])
@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cp1_decode_is_unchanged_by_bits(tp, window, dtype):
    cfg = dataclasses.replace(registry.get("minitron-8b", smoke=True), dtype=dtype)
    ctx = parallel.ParallelCtx(tp_size=tp)
    setup = _setup(cfg, (1, tp), fsdp=False)
    dt = parallel.torch_dtype(dtype)
    whole = convert.tree_map(lambda t: t.detach().to(dt),
                             Model(cfg, device="cpu", seed=4).params())
    ws = [p["blocks"]["attn"] for p in _blocks(setup, whole)]
    ws = [convert.tree_map(lambda t: t[0], w) for w in ws]  # layer 0
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.normal(0, 1, (2, 1, cfg.d_model)).astype(np.float32)).to(dt)
    kvl = attention.kv_local_heads(cfg, tp)
    shape = (2, window or S_TOTAL, kvl, cfg.head_dim)
    caches = torch.from_numpy(rng.normal(0, 1, (2,) + shape).astype(np.float32)).to(dt)
    for spec in (attention.KVCacheSpec(S_TOTAL, None, 1, window),
                 attention.KVCacheSpec(S_TOTAL, "data", 1, window)):
        for pos in (3, S_TOTAL + 5):

            def body(w, f, spec=spec, pos=pos):
                a = f(h, w, caches[0].clone(), caches[1].clone(), pos, cfg, ctx, spec)
                return [t.to(torch.float32).numpy() for t in a]

            mesh = ThreadMesh((1, tp), AXES, "cpu")
            got = mesh.run(lambda w: body(w, attention.attention_decode), ws)
            want = mesh.run(lambda w: body(w, _decode_unsplit), ws)
            for g, w_ in zip(got, want):
                for a, b in zip(g, w_):
                    assert np.array_equal(_bits(a), _bits(b)), (spec, pos)


def test_a_spec_that_disagrees_with_the_bound_axis_raises():
    cfg = cfg_of(registry, "minitron-8b")
    setup, shps, cspecs, tspec, plan = port_layout(cfg, 0)
    wrong = dataclasses.replace(plan, cp_size=4)
    cache = {k: torch.zeros(v) for k, v in shps.items()}
    step = training.make_serve_step(setup, cspecs, tspec, wrong)
    with pytest.raises(ValueError, match="cp_size=4"), torch.no_grad():
        step(_blocks(setup, _seeded(cfg)), cache, torch.zeros((1, 1), dtype=torch.int32), 0)


# ---------------------------------------------------------------------------
# Against the JAX child
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_layout_matches_the_references(child, case):
    arch, window = split(case)
    cfg = cfg_of(registry, arch)
    _, shps, cspecs, tspec, plan = port_layout(cfg, window)
    got = {"cache": {k: [list(shps[k]), list(cspecs[k])] for k in shps},
           "tokens": list(tspec),
           "plan": [plan.s_total, plan.cp_axis, plan.cp_size, plan.window]}
    assert got == json.loads(str(child.get()[f"layout/{case}"]))


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_the_references_shard_map(child, case):
    arch, _ = split(case)
    cfg = cfg_of(registry, arch)
    res = child.get()
    logits, cache = port_decode(case, cfg, child.weights(arch))
    for i in range(STEPS):
        want = res[f"logits/{case}/{i}"]
        # every reference rank holds the whole batch's logits, the same
        assert all(np.array_equal(_bits(want[r]), _bits(want[0])) for r in range(len(want)))
        assert _rel(logits[i], want[0]) <= TOL, (case, i)
    _, window = split(case)
    _, shps, _, _, _ = port_layout(cfg, window)
    start = cache_np(case, shps)
    for k, v in cache.items():
        want, got = res[f"cache/{case}/{k}"], _f32(v)
        kept = _bits(want) == _bits(start[k])
        # nothing written where the reference kept the prefill (the slots
        # no step wrote, on every rank), the rest close
        assert np.array_equal(_bits(got)[kept], _bits(want)[kept]), (case, k)
        assert _rel(got, want) <= TOL, (case, k)
        if k in ("k", "v"):  # STEPS slots written in every layer
            assert (~kept).any(axis=(0, 1, 3, 4)).sum() == STEPS, (case, k)


if __name__ == "__main__":
    _jax_child(sys.argv[2])
