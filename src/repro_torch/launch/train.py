"""End-to-end training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b --smoke \\
        --steps 50 --batch 8 --seq 128 [--grad-gz redoub] [--eb 1e-4]
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

The counterpart of ``repro.launch.train``: the same flags (plus
``--device``, default ``cuda``), the same mesh rule, the same printed
lines.  The ``data`` extent is the widest power-of-two factor of the
device count that divides the batch (``torch.cuda.device_count()`` on the
card, 1 with ``--device cpu``), ``model`` is 1.  On one device that is a
one-rank mesh, whose communicators are the trivial ones, as in the
reference on one device.

The weights are sharded over ``data`` (FSDP, ``make_setup``'s default, as
in the reference): each rank holds its ``_local`` block of the initialized
tree (a shard of each sharded leaf, a replica of the norms) and of the
optimizer state.  The ranks are threads of a ``ThreadMesh`` on the one
device ``--device`` names.  A checkpoint holds the global trees, put
together from the ranks' blocks (``training._global``), as the
reference's global arrays are, so either package restores the other's.
Spreading the ranks over the cards waits for a ``DistGroup`` mesh
(ROADMAP A11.8).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint
from repro_torch.configs import registry
from repro_torch.convert import tree_map
from repro_torch.core.collectives import GZConfig
from repro_torch.core.transport import resolve_device
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.launch.mesh import ThreadMesh, mesh_axis_sizes
from repro_torch.launch.shapes import InputShape, train_specs
from repro_torch.launch.training import _coords, _global, _local, make_setup, make_train_step
from repro_torch.models.parallel import init_params
from repro_torch.optim.adamw import AdamWConfig, adamw_init

__all__ = ["train"]


def _device_count(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 1


def train(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-8b", choices=registry.arch_ids())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-gz", default=None,
                    choices=["auto", "redoub", "ring", "intring"])
    ap.add_argument("--policy", default="auto",
                    choices=["auto", "paper", "throughput", "accuracy"],
                    help="communicator plan policy when --grad-gz leaves "
                         "the algorithm open (core/comm.py)")
    ap.add_argument("--eb", type=float, default=1e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch, smoke=args.smoke)
    device = resolve_device(args.device)
    n_dev = _device_count(device)
    # widest (data, model) factorization available on this host
    data = 1
    while data * 2 <= n_dev and args.batch % (data * 2) == 0 and \
            (n_dev // (data * 2)) * (data * 2) == n_dev:
        data *= 2
    mesh = ThreadMesh((data, 1), ("data", "model"), device)

    gz = GZConfig(eb=args.eb, algo=args.grad_gz) if args.grad_gz else None
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 1))
    setup = make_setup(cfg, mesh, opt=opt, grad_gz=gz, grad_policy=args.policy)
    shape = InputShape("cli", args.seq, args.batch, "train")
    _, bspecs = train_specs(cfg, shape, mesh)
    step_fn = make_train_step(setup, bspecs)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    whole = init_params(setup.defs, gen, device)
    sizes, coords = mesh_axis_sizes(mesh), _coords(mesh)
    # each rank's own block, as each process of a data-parallel job holds
    params = [tree_map(torch.clone, _local(whole, setup.specs, c, sizes)) for c in coords]
    del whole
    opt_state = [adamw_init(p) for p in params]
    stream = SyntheticStream(cfg, args.batch, args.seq, seed=args.seed)

    print(f"arch={cfg.arch_id} params={cfg.param_count()/1e6:.1f}M "
          f"mesh={mesh_axis_sizes(mesh)} "
          f"grad_gz={args.grad_gz}")
    losses = []
    t0 = time.time()
    for step, batch in zip(range(args.steps), stream):
        params, opt_state, m = step_fn(params, opt_state, batch)
        loss = float(m["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {loss:.4f} gnorm {float(m['gnorm']):.3f} "
                  f"lr {float(m['lr']):.2e} ({dt:.1f}s)")
        if args.ckpt_dir and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            opt_specs = {"mu": setup.specs, "nu": setup.specs, "step": ()}
            d = checkpoint.save(args.ckpt_dir, step + 1, {
                "params": _global(params, setup.specs, coords, sizes),
                "opt": _global(opt_state, opt_specs, coords, sizes)})
            print(f"  ckpt -> {d}")
    if not np.isfinite(losses).all():
        raise AssertionError("NaN loss")
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    train()
