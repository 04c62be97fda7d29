"""End-to-end training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b --smoke \\
        --steps 50 --batch 8 --seq 128 [--grad-gz redoub] [--eb 1e-4]
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.train --smoke --device cpu --batch 2 [--dist-backend gloo]

The counterpart of ``repro.launch.train``: the same flags (plus
``--device``, default ``cuda``, and ``--dist-backend``), the same mesh
rule, the same printed lines.  The ``data`` extent is the widest
power-of-two factor of the rank count that divides the batch, ``model``
is 1.  The weights are sharded over ``data`` (FSDP, ``make_setup``'s
default, as in the reference): each rank holds its ``_local`` block of
the tree drawn from ``--seed`` (a shard of each sharded leaf, a replica
of the norms) and of the optimizer state.  A checkpoint holds the global
trees (``training._global``), as the reference's global arrays are, so
either package restores the other's.  Two routes place the ranks:

* Without torchrun's environment, the ranks are threads of a
  ``ThreadMesh`` on the one device ``--device`` names, as many as the
  host's devices (``torch.cuda.device_count()`` on the card, 1 with
  ``--device cpu``).  On a card of several ranks FSDP takes the
  after-backward ``FsdpStep`` route (ROADMAP C6).
* Under torchrun (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` all set; a
  partial set raises), each process is one rank of a
  ``transport.DistMesh`` over the world, the counterpart of the
  reference's mesh over devices; FSDP takes the in-backward route.  The
  rule must give ``data`` equal to ``WORLD_SIZE``: a batch that does not
  split over the world raises before any process group is made.
  ``--dist-backend`` defaults to ``nccl`` on ``cuda`` and ``gloo`` on
  ``--device cpu``.  On ``cuda`` a process computes on
  ``cuda:{LOCAL_RANK % device_count}``.  NCCL puts no two ranks on one
  card, so NCCL with more local ranks (``LOCAL_WORLD_SIZE``) than cards
  raises, as does NCCL on the CPU: pass ``--dist-backend gloo`` (ROADMAP
  C24), under which several processes share a card and ``DistGroup``
  stages its tensors through the host.  Every process prints the same
  lines; for a checkpoint every process takes part in gathering the
  ranks' blocks one leaf at a time, process 0 alone keeps them (in host
  memory) and writes, and a barrier holds the others until the step is
  whole.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint
from repro_torch.configs import registry
from repro_torch.convert import tree_map
from repro_torch.core.collectives import GZConfig
from repro_torch.core.grad_sync import tree_flatten
from repro_torch.core.transport import DistMesh, resolve_device
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.launch.mesh import ThreadMesh, mesh_axis_sizes
from repro_torch.launch.shapes import InputShape, train_specs
from repro_torch.launch.training import (_coords, _global, _leaf_specs, _local, make_setup,
                                         make_train_step)
from repro_torch.models.parallel import init_params
from repro_torch.optim.adamw import AdamWConfig, adamw_init

__all__ = ["train"]

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT")
AXES = ("data", "model")


def _device_count(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _torchrun_env():
    """torchrun's variables as ``(rank, world, local_rank, local_world)``,
    or None where none of ``TORCHRUN_ENV`` is set; a partial set raises."""
    present = [k for k in TORCHRUN_ENV if k in os.environ]
    if not present:
        return None
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise ValueError(f"torchrun's environment is incomplete: {', '.join(present)} set, "
                         f"{', '.join(missing)} missing")
    return tuple(int(os.environ[k]) for k in TORCHRUN_ENV[:4])


def _data_extent(n: int, batch: int) -> int:
    """The reference's rule: the widest power of two dividing both the
    rank count ``n`` and the batch."""
    data = 1
    while data * 2 <= n and batch % (data * 2) == 0 and (n // (data * 2)) * (data * 2) == n:
        data *= 2
    return data


def _dist_placement(args, world: int, local: int, local_world: int):
    """The backend and this process's device under torchrun, after every
    refusal, all before any process group is made."""
    data = _data_extent(world, args.batch)
    if data < world:
        raise ValueError(f"--batch {args.batch} splits over {data} data ranks, not over the "
                         f"world's {world} processes (the widest power of two dividing both): "
                         f"a DistMesh covers the whole world, so run a power-of-two world "
                         f"that divides the batch")
    kind = torch.device(args.device).type
    backend = args.dist_backend or ("nccl" if kind == "cuda" else "gloo")
    if backend == "nccl" and kind != "cuda":
        raise ValueError(f"--dist-backend nccl carries CUDA tensors only, not --device "
                         f"{args.device}; pass --dist-backend gloo")
    device = resolve_device(args.device)  # CUDA without a card raises
    if kind != "cuda":
        return backend, device
    cards = torch.cuda.device_count()
    if backend == "nccl" and local_world > cards:
        raise ValueError(f"--dist-backend nccl with {local_world} local ranks on {cards} "
                         f"card(s): NCCL puts no two ranks of a group on one card (ROADMAP "
                         f"C24); pass --dist-backend gloo to share a card, its tensors staged "
                         f"through the host")
    device = torch.device("cuda", local % cards)
    torch.cuda.set_device(device)
    return backend, device


def _gathered_global(mesh: DistMesh, tree, specs):
    """On process 0, the global tree from every process's block of
    ``tree``, gathered over the whole mesh one leaf at a time, each
    gathered leaf moved to host memory at once (the card holds at most
    one of them); elsewhere None, each gathered leaf dropped as its
    collective returns."""
    group = mesh.handles[AXES]  # every rank, first axis major: _coords' order
    writer = mesh.rank == 0
    coords, sizes = (_coords(mesh), mesh_axis_sizes(mesh)) if writer else (None, None)
    leaves, rebuild = tree_flatten(tree)
    out = []
    for leaf, spec in zip(leaves, _leaf_specs(tree, specs)):
        gathered = group.all_gather((leaf,))[0]
        if writer:
            out.append(_global([[b] for b in gathered.cpu().unbind(0)], [spec], coords,
                               sizes)[0])
        del gathered
    return rebuild(out) if writer else None


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
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend under torchrun (default: nccl on "
                         "cuda, gloo on --device cpu)")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch, smoke=args.smoke)
    env = _torchrun_env()
    if env is None:
        if args.dist_backend:
            raise ValueError("--dist-backend applies under torchrun's environment only "
                             f"({', '.join(TORCHRUN_ENV)})")
        device = resolve_device(args.device)
        mesh = ThreadMesh((_data_extent(_device_count(device), args.batch), 1), AXES, device)
        return _train(args, cfg, mesh)
    rank, world, local, local_world = env
    backend, device = _dist_placement(args, world, local, local_world)
    dist.init_process_group(backend, rank=rank, world_size=world)
    try:
        # the mesh's sub-groups first, in the same order on every process
        return _train(args, cfg, DistMesh((world, 1), AXES, device=device))
    finally:
        dist.destroy_process_group()


def _train(args, cfg, mesh):
    """The training loop on ``mesh`` (a ``ThreadMesh`` or this process's
    rank of a ``DistMesh``): the lines printed and the losses returned are
    the same on either."""
    device = mesh.device
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
    params = [tree_map(torch.clone, _local(whole, setup.specs, coords[r], sizes))
              for r in mesh.local_ranks]
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
            d = _save(args.ckpt_dir, step + 1, mesh, params, opt_state, setup.specs,
                      opt_specs)
            print(f"  ckpt -> {d}")
    if not np.isfinite(losses).all():
        raise AssertionError("NaN loss")
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


def _save(ckpt_dir, step, mesh, params, opt_state, specs, opt_specs) -> str:
    """Checkpoint ``step`` of the global trees; its directory."""
    if not isinstance(mesh, DistMesh):
        sizes, coords = mesh_axis_sizes(mesh), _coords(mesh)
        return checkpoint.save(ckpt_dir, step, {
            "params": _global(params, specs, coords, sizes),
            "opt": _global(opt_state, opt_specs, coords, sizes)})
    (p,), (o,) = params, opt_state
    tree = {"params": _gathered_global(mesh, p, specs),
            "opt": _gathered_global(mesh, o, opt_specs)}
    if mesh.rank == 0:
        checkpoint.save(ckpt_dir, step, tree)
    del tree  # None elsewhere: only process 0 builds it
    # no process goes on (to read the step, or to write the next) before
    # process 0 has written the whole of this one
    dist.barrier()
    return checkpoint.step_dir(ckpt_dir, step)


if __name__ == "__main__":
    train()
