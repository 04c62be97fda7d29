"""The train step and the serve step over a mesh of ranks: where gZCCL
meets the training loop.

The counterpart of ``repro.launch.training``.  The reference's step is one
``shard_map`` body, jitted; here it is the same body run by every rank of
a ``launch.mesh.ThreadMesh`` (``mesh.run``), eagerly:

  * forward and backward (``torch.autograd.grad`` of ``loss_fn * scale``,
    ``scale = 1 / (tp * n_dp)`` as in the reference), each layer
    rematerialized when ``remat`` is not ``"none"``;
  * with FSDP (``fsdp=True``, the default, and ``data > 1``) the weights
    are sharded over ``data``: every use of a sharded leaf gathers it
    (``ParallelCtx.gather``; the compressed allgather, kernels 1 and 4,
    under ``fsdp_gz``), and its gradient is the reduce-scatter of the
    gathered weight's cotangent (kernels 1, 2 and 3 under ``fsdp_gz``),
    NaN-marked when degraded under ``skip_on_overflow``;
  * ``_sync_grads`` after backward (or the bucket hooks inside it, under
    ``overlap_sync``): every gradient leaf summed over each mesh axis absent
    from its spec (a sharded leaf's gradient is already summed over
    ``data``), through the axis's ``GZCommunicator`` (the compressed
    allreduce: TPU kernels 1-4, or 8-10 under ``codec="lorenzo+entropy"``)
    where ``grad_gz`` binds one, else by the exact rank-order
    ``sum_across``; every leaf's NaN/Inf probe and every allreduce's
    flags OR into ``degraded``;
  * the loss averaged over the data-parallel axes, ``degraded`` made global
    by an int sum over the whole mesh, the exact global gradient norm;
  * AdamW, in place (``optim/adamw.py``); under ``skip_on_overflow`` a
    degraded step keeps the old parameters and optimizer state
    (``_skip_merge``, the reference's elementwise ``where``).

Every rank holds its own block of the parameters and of the optimizer
state (``_local`` of the global tree by ``specs``: a shard of each
sharded leaf, a replica of the others), as each process of a
data-parallel job does, and the trees cross ``step`` as lists, one per
rank that this process runs (``mesh.local_ranks``: every rank of a
``ThreadMesh``, in rank order; a ``transport.DistMesh`` process's own);
``_global`` puts the blocks back together.  The reductions give every
rank the same bits, so the replicated leaves stay equal by bits; callers
that care check it rather than assume it.

The FSDP route goes by mesh.  Where each rank's backward runs where its
peers can meet it (a CPU ``ThreadMesh``, whose ranks run backward on their
own threads; a ``transport.DistMesh``, one process a rank, CUDA's
autograd thread included; any mesh of one local rank), the step takes the
reference's in-backward route: ``ParallelCtx.gather`` is
``fsdp_all_gather``, whose backward reduce-scatters the cotangent inside
backward, and remat's recompute gathers again through
``fsdp_recompute_context`` (the reference's ``jax.checkpoint`` does the
same), so each gathered weight is freed after its layer, as ZeRO-3 does.
On a CUDA ``ThreadMesh`` of several ranks every backward of the process
runs on the device's one autograd thread, where the ranks could never
meet in a collective (ROADMAP C6).  There the step runs its forward under
a ``grad_sync.FsdpStep``, whose gathers run on the rank threads and are
kept for remat's recompute; the backward only records each gathered
weight's cotangent; after ``torch.autograd.grad`` returns, each rank
reduce-scatters its records and sums each leaf's blocks in autograd's
order, which gives the in-backward route's bits.  That route holds every
gathered weight and every such cotangent until backward ends.

With ``overlap_sync`` (the reference's backward-overlapped bucketed sync)
``_sync_grads`` does not run after backward: the leaves are grouped by
their sync signature (the mesh axes absent from their specs, each with
its communicator or None), packed last-layer-first into buckets of about
``bucket_bytes`` f32 bytes, and each bucket is wrapped in an identity
``autograd.Function`` (``_BucketHook``) whose backward sums the bucket's
cotangents, flattened to one f32 vector, over those axes (the
communicator's compressed ``allreduce`` or the exact rank-order
``sum_across``) on the rank handles its forward captured.  Each hook's
health bit (a NaN/Inf probe and the allreduces' flags) leaves its
backward as the cotangent of a chained 0-d token, which also runs the
hooks' backwards in reverse order of installation on every rank, so all
ranks issue the same collectives in the same order.  The hooks are
collectives inside backward, so a CUDA ``ThreadMesh`` of several ranks
refuses them (C6); ``metrics["overlap_modeled"]`` is the cost model's
``BucketPlan.overlap_efficiency`` for the bucket size.

A mesh whose ``model`` axis is larger than 1 builds a tensor-parallel
context (``ParallelCtx.tp_size``) for every family (``Model``): each rank
runs ``model.loss_fn`` or ``make_serve_step``'s ``decode_fn`` on its
``_local`` block, and ``make_train_step`` trains it.  TP's backward
reduces activation gradients in the middle of backward, through the
handles its forward captured, so the ranks must meet where backward
runs: on a CPU ``ThreadMesh`` each rank's backward runs on its own
thread; on a ``DistMesh`` each process is one rank, and its backward
(CUDA's autograd thread included) reaches the other processes through
its ``DistGroup``s (over gloo the card's tensors stage through the host,
which is how four processes share one card).  A ``ThreadMesh`` of a CUDA
device at tp > 1 is refused (``_ranks_share_autograd_thread``, C6).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.convert import tree_map
from repro_torch.core import cost_model, transport
from repro_torch.core.collectives import GZConfig
from repro_torch.core.comm import GZCommunicator
from repro_torch.core.grad_sync import FsdpStep, SyncConfig, tree_flatten
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models.attention import KVCacheSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.models.parallel import ParallelCtx, param_shapes, param_specs
from repro_torch.optim.adamw import AdamWConfig, adamw_update

__all__ = ["TrainSetup", "make_setup", "make_train_step", "make_serve_step"]


@dataclasses.dataclass(frozen=True)
class TrainSetup:
    cfg: ModelConfig
    ctx: ParallelCtx
    model: Model
    mesh: object
    defs: dict
    specs: dict
    opt: AdamWConfig
    grad_gz: Optional[GZConfig]  # gz knobs for the dp-axis grad allreduce
    # resolve-once communicators, one per data-parallel axis, bound to the
    # mesh axis sizes at setup time; empty when gradient sync is exact
    grad_comms: tuple = ()
    # GradScaler-style degraded-step skip: a step whose gradient sync
    # reports overflow or non-finite input keeps the OLD params and opt
    # state and says so in metrics["skipped"].  Mostly useful with
    # on_overflow="flag"; with "fallback" the values are already exact.
    skip_on_overflow: bool = False
    # the bucketed overlap: sync each gradient bucket from a hook inside
    # backward (instead of one pass after it)...
    overlap_sync: bool = False
    # ...packing whole leaves last-layer-first into buckets of about this
    # many f32 bytes (make_setup resolves 0 to the BucketPlan's choice)...
    bucket_bytes: int = 16 * 1024 * 1024
    # ...with the modeled schedule for metrics["overlap_modeled"]; None
    # when the gradient sync is exact or there is one data-parallel rank
    overlap_plan: Optional[cost_model.BucketPlan] = None


def _strip_axis(spec: tuple, ax: str) -> tuple:
    def strip(entry):
        if entry == ax:
            return None
        if isinstance(entry, tuple):
            kept = tuple(e for e in entry if e != ax)
            return kept if kept else None
        return entry

    return tuple(strip(e) for e in spec)


def _tree_param_count(defs) -> int:
    """The parameters of ``defs``, counted from their shapes."""
    return sum(t.numel() for t in tree_flatten(param_shapes(defs))[0])


def make_setup(
    cfg: ModelConfig,
    mesh,
    *,
    opt: AdamWConfig = AdamWConfig(),
    fsdp_gz: Optional[GZConfig] = None,
    grad_gz: Optional[GZConfig] = None,
    grad_policy: str = "auto",
    remat: str = "full",
    fsdp: bool = True,
    skip_on_overflow: bool = False,
    overlap_sync: bool = False,
    bucket_bytes: int = 0,
    overlap_tokens: int = 4096,
    overlap_hw: Optional[cost_model.Hardware] = None,
) -> TrainSetup:
    """The reference's ``make_setup`` on a ``ThreadMesh`` or a
    ``transport.DistMesh`` over ``("data", "model")`` (or with ``"pod"``):
    ``fsdp=True`` shards the parameters over ``data`` (their specs keep
    ``"data"``), ``fsdp=False`` replicates them; ``fsdp_gz`` compresses
    the FSDP gathers and reduce-scatters (absolute eb, NaN-marked when
    degraded under ``skip_on_overflow``); ``grad_policy`` is the
    communicators' plan policy when ``grad_gz`` leaves the algorithm open.
    ``overlap_sync`` turns on the per-bucket backward hooks; ``bucket_bytes``
    0 asks ``cost_model.best_bucket_plan`` for the bucket size at
    ``overlap_hw`` (default ``A100_SLINGSHOT``) for a step of
    ``overlap_tokens`` tokens, > 0 forces it.  The model and its
    communicators run on ``mesh.device``."""
    if mesh.device is None:
        raise ValueError("make_setup needs a mesh with a device (DistMesh(..., device=...))")
    sizes = mesh_axis_sizes(mesh)
    dp_axes = tuple(ax for ax in mesh.axis_names if ax in ("pod", "data"))
    grad_comms = ()
    if grad_gz is not None:
        grad_comms = tuple(
            (ax, GZCommunicator.for_config(ax, grad_gz, policy=grad_policy,
                                           axis_size=sizes.get(ax, 1), device=mesh.device))
            for ax in dp_axes)
    fsdp_sync = None
    if fsdp_gz:
        # mark_degraded rides skip_on_overflow: the NaN mark of a degraded
        # reduce-scatter is caught by _sync_grads' per-leaf probe; without
        # a skip a NaN step would be worse than a flagged lossy one
        fsdp_sync = SyncConfig(gz=fsdp_gz, relative_eb=False,
                               mark_degraded=skip_on_overflow)
    ctx = ParallelCtx(
        tp_axis="model",
        fsdp_axis="data",
        dp_axes=dp_axes,
        tp_size=sizes.get("model", 1),
        fsdp_size=sizes.get("data", 1) if fsdp else 1,
        fsdp_sync=fsdp_sync,
        remat=remat,
    )
    # An empty tree registers no weights: the model here only defines the
    # parameters and computes with the trees the step is given.
    model = Model(cfg, ctx, params={}, device=mesh.device)
    defs = model.param_defs()
    if not fsdp:
        defs = tree_map(lambda d: dataclasses.replace(d, spec=_strip_axis(d.spec, "data")),
                        defs)
    n_dp = math.prod(sizes.get(ax, 1) for ax in dp_axes)
    overlap_plan = None
    if grad_gz is not None and n_dp > 1:
        n_params = _tree_param_count(defs)
        overlap_plan = cost_model.best_bucket_plan(
            overlap_hw or cost_model.A100_SLINGSHOT, tree_bytes=4.0 * n_params,
            backward_flops=4.0 * n_params * overlap_tokens, n=n_dp)
    if bucket_bytes <= 0:
        bucket_bytes = overlap_plan.bucket_bytes if overlap_plan else SyncConfig().bucket_bytes
    return TrainSetup(
        cfg=cfg, ctx=ctx, model=model, mesh=mesh, defs=defs, specs=param_specs(defs),
        opt=opt, grad_gz=grad_gz, grad_comms=grad_comms,
        skip_on_overflow=skip_on_overflow, overlap_sync=overlap_sync,
        bucket_bytes=bucket_bytes, overlap_plan=overlap_plan,
    )


def _axes_in_spec(spec) -> set:
    out = set()
    for entry in spec:
        if isinstance(entry, tuple):
            out.update(entry)
        elif entry is not None:
            out.add(entry)
    return out


def _leaf_specs(tree, specs) -> list:
    """The spec of each leaf of ``tree``, in flatten order (``specs``
    mirrors ``tree``, with a tuple spec where ``tree`` has a leaf)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _leaf_specs(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [s for t, sp in zip(tree, specs) for s in _leaf_specs(t, sp)]
    return [specs]


def _handle(axes):
    """This rank's handle over ``axes`` (one name, or the composite)."""
    axes = tuple(axes)
    return transport.current(axes[0] if len(axes) == 1 else axes)


def _sync_grads(grads, specs, mesh_axes, grad_comms: dict):
    """Sum each leaf over every mesh axis absent from its spec.

    Axes with a bound communicator go through its compressed
    ``allreduce`` (a bf16 leaf as the reference sends it: the
    communicator works in f32 and casts back); the others take the exact
    rank-order ``sum_across`` in f32.  Returns ``(grads, degraded)``, where
    ``degraded`` (a 0-d bool tensor) ORs every leaf's NaN/Inf probe and
    every allreduce's overflow and non-finite flags.  A leaf sharded over
    ``data`` arrives already reduce-scattered; the probe is what carries
    its NaN mark (``SyncConfig.mark_degraded``) to the skip."""
    leaves, rebuild = tree_flatten(grads)
    flag = torch.zeros((), dtype=torch.bool, device=leaves[0].device)
    out = []
    for g, s in zip(leaves, _leaf_specs(grads, specs)):
        present = _axes_in_spec(s)
        flag = flag | ~torch.isfinite(g).all()
        for ax in mesh_axes:
            if ax in present:
                continue
            comm = grad_comms.get(ax)
            if comm is not None:
                res = comm.allreduce(g)
                g = res.value
                flag = flag | res.overflow | res.nonfinite
            else:
                # the reference's psum: XLA's CPU all-reduce of a bf16
                # leaf sums in f32, in rank order, and rounds once
                g = transport.current(ax).sum_across(g.to(torch.float32)).to(g.dtype)
        out.append(g)
    return rebuild(out), flag


# ---------------------------------------------------------------------------
# The backward-overlapped bucketed sync
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _BucketMeta:
    """One bucket hook: ``ops``, the leaves' shared sync signature
    ((axis, communicator or None), ...) over the mesh axes absent from
    their specs, in mesh order (the reduction ``_sync_grads`` would apply
    after backward), and each leaf's shape and dtype."""

    ops: tuple
    shapes: tuple
    dtypes: tuple


def _check_own_thread(handle, what: str) -> None:
    """Raise if ``handle`` is a rank of a ``ThreadGroup`` of several ranks
    and this is not its thread: its peers could never meet it here."""
    thread = getattr(handle, "thread", None)
    if handle.size > 1 and thread is not None and thread is not threading.current_thread():
        raise RuntimeError(
            f"{what} of ThreadGroup rank {handle.rank} runs on thread "
            f"{threading.current_thread().name!r}, not on the rank's own thread (the "
            "autograd engine runs CUDA backward nodes on a device thread), so the ranks' "
            "collectives cannot meet (ROADMAP C6); run one process per rank on a "
            "transport.DistMesh (DistGroup handles)")


def _sync_bucket(vec: torch.Tensor, ops, handles: dict):
    """A bucket's f32 vector summed over each ``(axis, communicator or
    None)`` of ``ops`` on ``handles`` (the compressed ``allreduce``, or the
    exact rank-order ``sum_across``), and its health bit: the NaN/Inf probe
    of ``vec`` (a NaN-marked FSDP reduce-scatter shows here even when the
    bucket needs no collective of its own) ORed with every allreduce's
    flags."""
    flag = ~torch.isfinite(vec).all()
    with transport.bound(handles):
        for ax, comm in ops:
            if comm is None:
                vec = handles[ax].sum_across(vec)
            else:
                res = comm.allreduce(vec, group=handles[ax])
                vec = res.value
                flag = flag | res.overflow | res.nonfinite
    return vec, flag


class _BucketHook(torch.autograd.Function):
    """The identity on ``(token, *leaves)``; its backward syncs the bucket's
    cotangents on the rank handles the forward captured (on whatever
    thread autograd runs it) and adds the bucket's health bit to the
    token's cotangent, the one way out of a backward."""

    @staticmethod
    def forward(ctx, meta, handles, token, *leaves):
        ctx.meta, ctx.handles = meta, handles
        return (token.view_as(token),) + tuple(x.view_as(x) for x in leaves)

    @staticmethod
    def backward(ctx, g_token, *gs):
        meta, handles = ctx.meta, ctx.handles
        for ax, _ in meta.ops:
            _check_own_thread(handles[ax], "a bucket hook's backward")
        flat = [g.to(torch.float32).reshape(-1) for g in gs]
        vec, flag = _sync_bucket(flat[0] if len(flat) == 1 else torch.cat(flat), meta.ops,
                                 handles)
        outs, off = [], 0
        for shape, dt in zip(meta.shapes, meta.dtypes):
            size = math.prod(shape)
            # a tensor of its own, as the reference's: a view into ``vec``
            # would start off the allocator's alignment, and torch's CPU
            # sums (the gradient norm's) split an unaligned tensor otherwise
            outs.append(vec[off:off + size].reshape(shape).to(dt, copy=True))
            off += size
        return (None, None, g_token + flag.to(g_token.dtype), *outs)


def _bucket_plan(leaves, leaf_specs, mesh_axes, grad_comms: dict, bucket_bytes: int) -> list:
    """The buckets of ``_install_bucket_hooks``, in order of installation:
    [(ops, [leaf number, ...])].  Leaves are grouped by sync signature
    (groups in order of first appearance: one bucket must mean one
    collective), then packed greedily, whole, walking each group's flatten
    order backward (the tree's tail first, as backward completes it), up
    to ``bucket_bytes`` of f32 (``numel * 4``, whatever the dtype)."""
    groups: dict = {}
    for i, spec in enumerate(leaf_specs):
        present = _axes_in_spec(spec)
        ops = tuple((ax, grad_comms.get(ax)) for ax in mesh_axes if ax not in present)
        groups.setdefault(ops, []).append(i)
    out = []
    for ops, idxs in groups.items():
        bucket, pending = [], 0
        for i in reversed(idxs):
            bucket.append(i)
            pending += leaves[i].numel() * 4
            if pending < bucket_bytes and i != idxs[0]:
                continue
            out.append((ops, bucket))
            bucket, pending = [], 0
    return out


def _install_bucket_hooks(params, specs, mesh_axes, grad_comms: dict, bucket_bytes: int,
                          token):
    """Wrap every leaf of ``params`` in its bucket's sync hook
    (``_bucket_plan``), the 0-d f32 ``token`` chained through every hook.
    The hooks capture this thread's rank handles.  Returns
    ``(hooked_params, token_out, n_buckets)``."""
    leaves, rebuild = tree_flatten(params)
    handles = transport.bindings()
    new = list(leaves)
    plan = _bucket_plan(leaves, _leaf_specs(params, specs), mesh_axes, grad_comms,
                        bucket_bytes)
    for ops, bucket in plan:
        meta = _BucketMeta(ops=ops, shapes=tuple(tuple(leaves[j].shape) for j in bucket),
                           dtypes=tuple(leaves[j].dtype for j in bucket))
        token, *outs = _BucketHook.apply(meta, handles, token, *(new[j] for j in bucket))
        for j, o in zip(bucket, outs):
            new[j] = o
    return rebuild(new), token, len(plan)


def _skip_merge(degraded, new_tree, old_tree):
    """Keep ``old_tree`` where this step degraded (a 0-d bool tensor, the
    same on every rank), else take ``new_tree``: the GradScaler-style skip,
    elementwise as in the reference."""
    new, rebuild = tree_flatten(new_tree)
    old, _ = tree_flatten(old_tree)
    return rebuild([torch.where(degraded, o, n) for n, o in zip(new, old)])


def _global_grad_norm(grads, specs, sizes: dict) -> torch.Tensor:
    """Exact global norm of the synced (logical) gradient: each leaf's
    local f32 sum of squares over its replication factor, summed over the
    whole mesh."""
    leaves, _ = tree_flatten(grads)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    mesh_axes = list(sizes)
    for g, s in zip(leaves, _leaf_specs(grads, specs)):
        present = _axes_in_spec(s)
        rep = math.prod(sizes[ax] for ax in mesh_axes if ax not in present)
        # summed in the leaf's logical order, whatever layout autograd gave
        # it (a transposed gradient would sum in another order): the
        # post-hoc sync keeps that layout, the bucket hooks do not
        total = total + torch.sum(torch.square(g.to(torch.float32).contiguous())) / rep
    for ax in mesh_axes:
        total = transport.current(ax).sum_across(total)
    return torch.sqrt(total)


def _local(tree, specs, coord: dict, sizes: dict):
    """This rank's block of each leaf of a global ``tree`` (numpy arrays or
    tensors; views where the leaf allows), by its spec: a dim over axes
    ``(a, b)`` is split into ``sizes[a] * sizes[b]`` equal blocks and the
    rank takes block ``coord[a] * sizes[b] + coord[b]``."""
    leaves, rebuild = tree_flatten(tree)
    out = []
    for x, spec in zip(leaves, _leaf_specs(tree, specs)):
        index = []
        for dim, entry in enumerate(spec):
            if entry is None:
                index.append(slice(None))
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            n, i = 1, 0
            for ax in axes:
                n, i = n * sizes[ax], i * sizes[ax] + coord[ax]
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of a {tuple(x.shape)} leaf does not split "
                                 f"over {axes} ({n} ranks)")
            size = x.shape[dim] // n
            index.append(slice(i * size, (i + 1) * size))
        out.append(x[tuple(index)])
    return rebuild(out)


def _global(trees, specs, coords: list, sizes: dict):
    """The global tree from the ranks' blocks, the inverse of ``_local``:
    each rank's block of each leaf written where ``_local`` took it (the
    replicated dims whole; the replicas of a replicated leaf are equal,
    so the last one written is every one's)."""
    per_rank = [tree_flatten(t)[0] for t in trees]
    _, rebuild = tree_flatten(trees[0])
    out = []
    for i, spec in enumerate(_leaf_specs(trees[0], specs)):
        first = per_rank[0][i]
        shape = list(first.shape)
        for dim, entry in enumerate(spec):
            if entry is not None:
                axes = entry if isinstance(entry, tuple) else (entry,)
                shape[dim] *= math.prod(sizes[ax] for ax in axes)
        whole = torch.empty(shape, dtype=first.dtype, device=first.device)
        for r, coord in enumerate(coords):
            # _local of a tensor is a view: the block is written through it
            _local([whole], [spec], coord, sizes)[0].copy_(per_rank[r][i])
        out.append(whole)
    return rebuild(out)


def _data_dim(spec, axis: str):
    """The dim of ``spec`` that lies over ``axis``, or None."""
    for dim, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return dim
    return None


def _loss_and_grads(model, ctx: ParallelCtx, params, specs, batch, scale: float,
                    deferred: bool = True):
    """One rank's ``loss * scale`` and the gradient of each leaf of its
    ``params`` (flatten order; zeros where autograd gives none, as JAX
    does).  Under FSDP with ``deferred`` the forward runs in a
    ``FsdpStep``, whose reduce-scatters run here, on the rank thread, once
    backward has returned (the route of a mesh whose ranks share CUDA's
    autograd thread); else every gather is ``fsdp_all_gather``, whose
    reduce-scatter runs inside backward (module docstring)."""
    leaves, rebuild = tree_flatten(params)
    # Views of this rank's weights that autograd tracks; the update writes
    # the weights themselves once backward has returned.
    req = [p.detach().requires_grad_(True) for p in leaves]
    fs = None
    if deferred and ctx.fsdp_size > 1:
        dims = [_data_dim(s, ctx.fsdp_axis) for s in _leaf_specs(params, specs)]
        fs = FsdpStep(ctx.fsdp_axis, ctx.fsdp_sync, req, dims)
    with torch.enable_grad():
        with fs.forward() if fs is not None else contextlib.nullcontext():
            loss = model.loss_fn(rebuild(req), batch) * scale
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    if fs is not None:
        return loss.detach(), fs.reduce_scatter(grads)
    return loss.detach(), [torch.zeros_like(p) if g is None else g for g, p in zip(grads, req)]


def _overlapped_loss_and_grads(model, params, specs, batch, scale: float, mesh_axes,
                               grad_comms: dict, bucket_bytes: int):
    """The reference's overlapped branch on one rank: ``loss * scale``, the
    synced gradient of each leaf (flatten order) and ``degraded``, from
    ``torch.autograd.grad`` over the leaves and a 0-d f32 token chained
    through every bucket hook (``0.0 * token`` gives the chain its edge to
    the loss without changing it; each hook adds its health bit to the
    token's gradient).  FSDP takes the in-backward route."""
    leaves, rebuild = tree_flatten(params)
    req = [p.detach().requires_grad_(True) for p in leaves]
    token = torch.zeros((), dtype=torch.float32, device=req[0].device, requires_grad=True)
    with torch.enable_grad():
        hooked, tok_out, _ = _install_bucket_hooks(rebuild(req), specs, mesh_axes, grad_comms,
                                                   bucket_bytes, token)
        loss = model.loss_fn(hooked, batch) * scale + 0.0 * tok_out
        *grads, g_token = torch.autograd.grad(loss, req + [token])
    return loss.detach(), grads, g_token > 0


def _coords(mesh) -> list:
    """Each rank's coordinate per axis, ranks first-axis major."""
    return [dict(zip(mesh.axis_names, c)) for c in np.ndindex(*mesh.shape)]


def _ranks_share_autograd_thread(mesh) -> bool:
    """Whether several ranks of ``mesh`` run in this process on a CUDA
    device, whose backward nodes all run on the device's one autograd
    thread, where a collective inside backward cannot meet (ROADMAP C6):
    a ``ThreadMesh`` of the card, not a ``DistMesh``."""
    return mesh.device.type == "cuda" and len(mesh.local_ranks) > 1


def make_train_step(setup: TrainSetup, batch_specs):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``params`` and ``opt_state`` are lists of per-rank trees,
    one for each of ``mesh.local_ranks`` in that order, each rank's
    ``_local`` block of the global trees by ``setup.specs`` (each updated
    in place, as the reference donates them); ``batch`` is the global
    batch (numpy or tensors), split by ``batch_specs``.  ``metrics`` are
    the first local rank's ``loss``, ``gnorm``, ``lr``, ``skipped`` and
    ``overlap_modeled`` (0-d tensors); every rank computes the same bits
    (rank-order sums over the mesh).

    FSDP takes the in-backward route, except on a ``ThreadMesh`` of
    several ranks of a CUDA device, where it takes ``FsdpStep``; with
    ``setup.overlap_sync`` the bucket hooks sync the gradients inside
    backward in place of ``_sync_grads`` (module docstring).  At tp > 1,
    or with ``overlap_sync``, a ``ThreadMesh`` of several ranks of a CUDA
    device raises: both are collectives inside backward (C6)."""
    ctx, model, mesh = setup.ctx, setup.model, setup.mesh
    shared = _ranks_share_autograd_thread(mesh)
    if shared and (ctx.tp_size > 1 or setup.overlap_sync):
        what = (f"the train step at tp_size {ctx.tp_size}" if ctx.tp_size > 1
                else "the overlapped gradient sync (overlap_sync)")
        raise NotImplementedError(
            f"{what} on a ThreadMesh of {mesh.device}: its collectives run inside backward, "
            "which CUDA runs on the device's one autograd thread, where the mesh's rank "
            "threads cannot meet (ROADMAP C6); run one process per rank on a "
            "transport.DistMesh (over gloo the card's tensors stage through the host)")
    deferred = shared and ctx.fsdp_size > 1
    sizes = mesh_axis_sizes(mesh)
    mesh_axes = tuple(mesh.axis_names)
    n_dp = math.prod(sizes[ax] for ax in ctx.dp_axes)
    scale = 1.0 / (ctx.tp_size * n_dp)
    specs = setup.specs
    grad_comms = dict(setup.grad_comms)
    coords = _coords(mesh)
    local = list(mesh.local_ranks)
    overlap_modeled = float(setup.overlap_plan.overlap_efficiency
                            if setup.overlap_sync and setup.overlap_plan is not None else 0.0)

    def body(args):
        params, opt_state, batch = args
        rebuild = tree_flatten(params)[1]
        if setup.overlap_sync:
            loss, grads, degraded = _overlapped_loss_and_grads(
                model, params, specs, batch, scale, mesh_axes, grad_comms, setup.bucket_bytes)
            grads = rebuild(grads)
        else:
            loss, grads = _loss_and_grads(model, ctx, params, specs, batch, scale,
                                          deferred=deferred)
            grads, degraded = _sync_grads(rebuild(grads), specs, mesh_axes, grad_comms)
        loss = loss / scale
        for ax in ctx.dp_axes:
            loss = transport.current(ax).sum_across(loss) / sizes[ax]
        # Each health bit covers its own dp axis only; make the skip
        # predicate the same on every rank before it gates state.
        degraded = _handle(mesh_axes).sum_across(degraded.to(torch.int32)) > 0
        gnorm = _global_grad_norm(grads, specs, sizes)
        if setup.skip_on_overflow:
            old_params, old_opt = tree_map(torch.clone, params), tree_map(torch.clone, opt_state)
        new_params, new_opt, om = adamw_update(params, grads, opt_state, setup.opt,
                                               grad_norm=gnorm)
        skipped = torch.zeros((), dtype=torch.bool, device=loss.device)
        if setup.skip_on_overflow:
            new_params = _skip_merge(degraded, new_params, old_params)
            new_opt = _skip_merge(degraded, new_opt, old_opt)
            skipped = degraded
        metrics = {"loss": loss, "gnorm": om["gnorm"], "lr": om["lr"], "skipped": skipped,
                   "overlap_modeled": torch.full((), overlap_modeled, dtype=torch.float32,
                                                 device=loss.device)}
        return new_params, new_opt, metrics

    def step(params, opt_state, batch):
        if len(params) != len(local) or len(opt_state) != len(local):
            raise ValueError(f"step takes one params and one opt_state tree per local rank "
                             f"({len(local)}), got {len(params)} and {len(opt_state)}")
        out = mesh.run(body, [(params[i], opt_state[i],
                               _local(batch, batch_specs, coords[r], sizes))
                              for i, r in enumerate(local)])
        return [o[0] for o in out], [o[1] for o in out], out[0][2]

    return step


def _apart(block, specs, axis: str):
    """``block`` with a private clone of each leaf whose spec does not
    split ``axis`` (a leaf the ranks along ``axis`` replicate)."""
    leaves, rebuild = tree_flatten(block)
    return rebuild([x if axis in _axes_in_spec(s) else x.clone()
                    for x, s in zip(leaves, _leaf_specs(block, specs))])


def make_serve_step(setup: TrainSetup, cache_specs, tokens_spec, plan: KVCacheSpec):
    """Returns ``step(params, cache, tokens, pos) -> (logits, cache)``:
    one ``decode_fn`` step on every rank, each on its block of the global
    ``tokens`` and ``cache`` (views, so the new k and v land in the global
    cache), with ``params`` a list of per-rank trees.  The logits come back
    whole, the ranks' blocks of the batch in rank order (every rank of a
    ``model`` group holds its block's whole logits; the first one's are
    taken; under the context split every rank holds the whole batch's, and
    rank 0's are taken).

    Under the context split (``plan.cp_size > 1``) the cache entries the
    context axis replicates (the conv and SSD states, the MLA latent,
    ``enc_out``) would be one view shared by that axis's ranks, which
    ``decode_fn`` reads and rewrites in place with no collective between:
    every rank off coordinate 0 of ``plan.cp_axis`` takes a private clone
    of those blocks for the step, and the global cache keeps coordinate
    0's writes (the replicas are equal, as the reference's ``out_specs``
    take one of them)."""
    model, mesh = setup.model, setup.mesh
    sizes = mesh_axis_sizes(mesh)
    coords = _coords(mesh)
    firsts = [r for r, c in enumerate(coords) if c.get("model", 0) == 0]
    cp_axis = plan.cp_axis if plan.cp_size > 1 else None

    def body(args):
        params, cache, tokens, pos = args
        logits, _ = model.decode_fn(params, cache, tokens, pos, plan)
        return logits

    def block(cache, r):
        out = _local(cache, cache_specs, coords[r], sizes)
        if cp_axis is not None and coords[r][cp_axis] != 0:
            out = _apart(out, cache_specs, cp_axis)
        return out

    def step(params, cache, tokens, pos):
        outs = mesh.run(body, [(params[r], block(cache, r),
                                _local(tokens, tokens_spec, coords[r], sizes), pos)
                               for r in range(mesh.size)])
        logits = torch.cat([outs[r] for r in firsts], dim=0) if tokens_spec[0] is not None \
            else outs[0]
        return logits, cache

    return step
