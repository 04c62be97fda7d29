"""How far token-by-token decode drifts from the full-sequence forward in
the ssm and hybrid families (or any of ``--archs``: the moe configs at a
capacity where no slot drops), in the JAX package and in the port, by
depth.

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/ssm_decode_drift.py \
        [--archs mamba2-780m,zamba2-2.7b] [--layers 2,12,48] [--seq 64] \
        [--d-model 128]

For each config's smoke version widened to ``--d-model`` and deepened to
each of ``--layers`` (a moe config's ``capacity_factor`` set to
``n_experts / top_k``: prefill and decode then route alike, and no slot
drops), weights from seed 0 (bf16, and the same cast to f32), a (2,
``--seq``) batch of tokens: the max over positions and vocab
of |decode - prefill| over the largest prefill logit, for the reference
(both paths jitted, as ``tests/test_prefill_decode_consistency.py`` runs
them) and for the port (eager, on the CPU).  One line per case.  A CPU
run: it says how the two packages' numerics behave, not how fast anything
is.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import parallel as jparallel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.attention import KVCacheSpec  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.parallel import ParallelCtx  # noqa: E402

JCTX = jparallel.ParallelCtx(tp_size=1, fsdp_size=1, remat="none")
CTX = ParallelCtx(remat="none")


def _cfg(arch, n_layers, d_model):
    cfg = jregistry.get(arch, smoke=True)
    kw = dict(n_layers=n_layers, d_model=d_model)
    if cfg.n_heads:
        kw.update(n_heads=d_model // 32, n_kv_heads=d_model // 32, head_dim=32,
                  d_ff=2 * d_model)
    if cfg.family == "moe":
        kw.update(capacity_factor=cfg.n_experts / cfg.top_k)
    return dataclasses.replace(cfg, **kw)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _reference(cfg, params, tokens):
    m = jmodel.Model(cfg, JCTX)

    def fwd(p, t):
        h = jlayers.embed_lookup(t, p["embed"], JCTX)
        h, _ = m._backbone(h, p, positions=jnp.arange(t.shape[1]))
        h = jlayers.rms_norm(h, p["final_norm"], cfg.norm_eps)
        return jlayers.vocab_parallel_logits(h, p["unembed"], JCTX)

    want = np.asarray(jax.jit(fwd)(params, tokens))
    b, s = tokens.shape
    spec = jattention.KVCacheSpec(s_total=s, cp_axis=None, cp_size=1)
    cache = {k: jnp.zeros(v, jnp.float32) for k, v in m.cache_defs(b, spec).items()}
    step = jax.jit(lambda p, c, t, pos: m.decode_fn(p, c, t, pos, spec))
    got = []
    for i in range(s):
        logits, cache = step(params, cache, jnp.asarray(tokens[:, i:i + 1]), jnp.int32(i))
        got.append(np.asarray(logits)[:, 0])
    return _rel(np.stack(got, axis=1), want)


def _port(cfg, params, tokens):
    tp = convert.params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    m = Model(cfg, CTX, params=tp, device="cpu")
    b, s = tokens.shape
    t = torch.from_numpy(tokens)
    with torch.inference_mode():
        h = layers.embed_lookup(t, tp["embed"], CTX)
        h, _ = m._backbone(h, tp, positions=torch.arange(s))
        h = layers.rms_norm(h, tp["final_norm"], cfg.norm_eps)
        want = layers.vocab_parallel_logits(h, tp["unembed"], CTX).numpy()
        spec = KVCacheSpec(s_total=s, cp_axis=None, cp_size=1)
        cache = {k: torch.zeros(v) for k, v in m.cache_defs(b, spec).items()}
        got = np.stack([m.decode_fn(tp, cache, tokens[:, i:i + 1], i, spec)[0][:, 0].numpy()
                        for i in range(s)], axis=1)
    return _rel(got, want)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="mamba2-780m,zamba2-2.7b")
    ap.add_argument("--layers", default="2,12,48")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=128)
    args = ap.parse_args(argv)
    tokens = np.random.default_rng(0).integers(0, 512, (2, args.seq)).astype(np.int32)
    for arch in args.archs.split(","):
        for n_layers in (int(x) for x in args.layers.split(",")):
            cfg = _cfg(arch, n_layers, args.d_model)
            params = jparallel.init_params(jmodel.Model(cfg, JCTX).param_defs(),
                                           jax.random.key(0))
            for dtype in ("bfloat16", "float32"):
                p = params if dtype == "bfloat16" else \
                    jax.tree.map(lambda a: a.astype(jnp.float32), params)
                print(f"{arch} layers {n_layers} d_model {args.d_model} S {args.seq} {dtype}: "
                      f"decode vs prefill rel, reference (jit) {_reference(cfg, p, tokens):.4e}, "
                      f"port {_port(cfg, p, tokens):.4e}", flush=True)


if __name__ == "__main__":
    main()
