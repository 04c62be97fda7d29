"""Rank transport: what ``lax.ppermute``/``lax.psum``/``lax.axis_index``
do for the JAX package.

Rank-centric collective code (``core/collectives.py``) sees one handle per
rank with these members:

  * ``rank`` and ``size`` (``lax.axis_index`` / the axis size);
  * ``exchange(tensors, perm)`` — ppermute semantics: every rank passes
    the same ``perm`` of ``(sender, receiver)`` pairs and its own tuple of
    tensors, and gets back what its sender passed.  A rank that no pair
    addresses receives zeros of the same shapes and dtypes (the redoub
    idle ranks rely on this);
  * ``all_to_all(tensors)`` — ``lax.all_to_all`` semantics (untiled, split
    and concat on dim 0): each tensor's leading dim has one slot per rank;
    rank r gets back, in slot i, what rank i passed in its slot r;
  * ``all_gather(tensors)`` — ``lax.all_gather`` semantics (untiled): each
    tensor comes back stacked over a new leading dim of one slot per rank,
    slot i holding what rank i passed (the lossless allgather);
  * ``flags_across(*flags)`` — the global OR of per-rank bool flags, one
    combined reduction (the ``psum(...) > 0`` of the reference);
  * ``sum_across(x)`` — the sum of every rank's f32 tensor ``x`` (the
    ``psum`` of the reference), folded in rank order,
    ``((x_0 + x_1) + x_2) + ...``: every rank gets the same bits, the
    reference's CPU ``psum`` gives them too, and no library reduction
    order plays a part;
  * ``max_across(x)`` — the elementwise max of every rank's ``x`` (the
    ``pmax`` of the reference; a NaN on any rank gives NaN).

Two groups provide handles:

  * :class:`ThreadGroup` — N ranks as N threads of one process on one
    device, exchanging through a barrier and a mailbox (``exchange`` makes
    no copies: the received tensors are the sender's, so rank code never
    writes into a tensor it sent or received; ``all_to_all`` and
    ``all_gather`` stack the slots they receive into new tensors).
    Every rank launches on the stream that was current when ``run`` was
    called, so stream order alone orders one rank's kernels before another
    rank's reads.
  * :class:`DistGroup` — one rank per process over ``torch.distributed``:
    ``batch_isend_irecv`` for the exchange and the all-to-all,
    ``all_reduce(MAX)`` for the flags, ``all_gather`` for the sum, the
    max and the gather.  NCCL on GPUs, gloo on the CPU.  A gloo group
    also carries the card's tensors, staged through host memory
    (``DistGroup``), which is how several processes that share one card
    meet: NCCL will not put two ranks of a group on one GPU.

A group is bound to an axis name per thread (``bind``); a communicator
built for that axis name finds its rank handle with ``current``.
``bindings`` snapshots a thread's handles and ``bound`` binds them on
another thread, as remat's recompute does on CUDA's autograd thread.

``ThreadGroup.run`` runs one op of torch's vectorized CPU math (a
``sqrt``) on the calling thread once per process before it starts the
rank threads.  That library initializes itself on first use, and a first
use from several threads at once can return an inexact result on one of
them (seen with torch 2.13's CPU build: ``sqrt`` 216 ulp off in about 1
process in 200 with 3 threads racing, 1 in 20 with 16), which broke the
gradient sync's relative-eb scale on one rank.

Meshes (the reference's ``jax.sharding.Mesh`` with named axes): ranks
laid out over several named axes, first axis major (``rank = node * L +
local`` on a ``("node", "local")`` mesh).  Every rank gets a handle for
every ordered tuple of distinct axes: a single name (``"node"``: the
ranks that share every other coordinate, ranked by that axis) and every
composite tuple (``("node", "local")``: ranked first-axis major, the
reference's tuple-axis ``axis_index``).  ``("local", "node")`` is a
handle of its own, local-major, so a fold over it runs in the order the
reference's ``psum`` over that tuple runs.  ``ThreadGroup.run(...,
axis_name=("node", "local"), shape=(n_nodes, L))`` binds them on the
rank threads, each (sub-)group with its own mailbox and barrier;
:class:`DistMesh` builds them over ``torch.distributed`` sub-groups
(``DistGroup(group=..., ranks=...)``) and runs this process's one rank
(``DistMesh.run``, as ``launch.mesh.ThreadMesh.run`` runs all of them).
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["resolve_device", "ThreadGroup", "DistGroup", "DistMesh", "mesh_groups",
           "bind", "current", "bindings", "bound"]

_BOUND = threading.local()


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; CUDA without a usable card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions on the CPU"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def bind(axis_name, handle):
    """Bind ``handle`` as this thread's rank for ``axis_name``."""
    stack = getattr(_BOUND, "axes", None)
    if stack is None:
        stack = _BOUND.axes = {}
    prev = stack.get(axis_name)
    stack[axis_name] = handle
    try:
        yield handle
    finally:
        if prev is None:
            stack.pop(axis_name)
        else:
            stack[axis_name] = prev


def current(axis_name):
    """This thread's rank handle for ``axis_name``."""
    handle = getattr(_BOUND, "axes", {}).get(axis_name)
    if handle is None:
        raise RuntimeError(
            f"no rank is bound to axis {axis_name!r} on this thread: call the "
            "collective inside ThreadGroup.run(..., axis_name=...) or "
            "DistGroup.bind(...)"
        )
    return handle


def bindings() -> dict:
    """A copy of this thread's bindings, ``{axis name: handle}``."""
    return dict(getattr(_BOUND, "axes", {}))


@contextlib.contextmanager
def bound(handles: dict):
    """Bind every handle of ``handles`` (``bindings()`` taken on another
    thread) on this thread, for the block."""
    with contextlib.ExitStack() as stack:
        for key, handle in handles.items():
            stack.enter_context(bind(key, handle))
        yield


_CPU_MATH_READY = False
_CPU_MATH_LOCK = threading.Lock()


def _init_cpu_math() -> None:
    """Initialize torch's vectorized CPU math on this thread, once per
    process, before any rank thread can be first to use it (module
    docstring)."""
    global _CPU_MATH_READY
    with _CPU_MATH_LOCK:
        if not _CPU_MATH_READY:
            torch.sqrt(torch.ones(8))
            _CPU_MATH_READY = True


def _zeros_like_all(tensors) -> tuple:
    return tuple(torch.zeros_like(t) for t in tensors)


def _fold(parts) -> torch.Tensor:
    """Rank-order sum of the per-rank tensors."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _sender_of(rank: int, perm):
    for snd, rcv in perm:
        if rcv == rank:
            return snd
    return None


def mesh_groups(shape, axis_names) -> dict:
    """Every handle of a mesh: ``{key: [members, ...]}`` for every ordered
    tuple of distinct axes (``key`` the axis name, or the tuple of names),
    each entry the global ranks of one group in its rank order, first
    axis of the key major (the reference's ``pxla._axis_groups``).
    Global ranks run over ``shape`` first axis major."""
    shape, names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} do not match")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh extents must be >= 1, got {shape}")
    ranks = np.arange(math.prod(shape)).reshape(shape)
    out = {}
    for k in range(1, len(names) + 1):
        for axes in itertools.permutations(range(len(names)), k):
            moved = np.moveaxis(ranks, axes, range(k)).reshape(
                math.prod(shape[a] for a in axes), -1)
            key = names[axes[0]] if k == 1 else tuple(names[a] for a in axes)
            out[key] = [tuple(int(r) for r in col) for col in moved.T]
    return out


class _Cell:
    """One (sub-)group of thread ranks: a mailbox slot per rank and a
    barrier."""

    def __init__(self, size: int):
        self.size = size
        self._slots = [None] * size
        self._barrier = threading.Barrier(size)


class _ThreadRank:
    """One rank of a :class:`ThreadGroup` (or of one of its sub-groups)."""

    def __init__(self, cell: _Cell, rank: int):
        self.group = cell
        self.rank = rank
        self.size = cell.size
        self.thread = threading.current_thread()  # the rank's own thread

    def exchange(self, tensors, perm) -> tuple:
        g = self.group
        g._slots[self.rank] = tuple(tensors)
        g._barrier.wait()
        src = _sender_of(self.rank, perm)
        out = g._slots[src] if src is not None else _zeros_like_all(tensors)
        g._barrier.wait()  # every read is done before the slots are reused
        return out

    def all_to_all(self, tensors) -> tuple:
        g = self.group
        g._slots[self.rank] = tuple(tensors)
        g._barrier.wait()
        out = tuple(torch.stack([g._slots[src][k][self.rank] for src in range(self.size)])
                    for k in range(len(tensors)))
        g._barrier.wait()
        return out

    def all_gather(self, tensors) -> tuple:
        g = self.group
        g._slots[self.rank] = tuple(tensors)
        g._barrier.wait()
        out = tuple(torch.stack([g._slots[src][k] for src in range(self.size)])
                    for k in range(len(tensors)))
        g._barrier.wait()
        return out

    def flags_across(self, *flags) -> tuple:
        g = self.group
        g._slots[self.rank] = torch.stack([f.to(torch.int32) for f in flags])
        g._barrier.wait()
        both = torch.stack(list(g._slots)).amax(dim=0) > 0
        g._barrier.wait()
        return tuple(both.unbind(0))

    def sum_across(self, x) -> torch.Tensor:
        g = self.group
        g._slots[self.rank] = x
        g._barrier.wait()
        out = _fold(list(g._slots))
        g._barrier.wait()
        return out

    def max_across(self, x) -> torch.Tensor:
        g = self.group
        g._slots[self.rank] = x
        g._barrier.wait()
        out = torch.stack(list(g._slots)).amax(dim=0)
        g._barrier.wait()
        return out


class ThreadGroup:
    """N ranks as N threads of this process on one device."""

    def __init__(self, n: int, device="cuda"):
        if int(n) < 1:
            raise ValueError(f"ThreadGroup needs n >= 1, got {n}")
        self.size = int(n)
        self.device = resolve_device(device)

    def run(self, fn, inputs, *, axis_name="x", shape=None) -> list:
        """Call ``fn(inputs[r])`` as rank r on N threads; returns the N
        results in rank order.  With one axis name the rank is bound to
        it.  With a tuple of names and their extents ``shape`` (product N)
        the ranks form a mesh, first axis major, and every rank is bound
        to every handle of ``mesh_groups`` (module docstring).  An error
        on any rank breaks every barrier for all and is re-raised here."""
        if len(inputs) != self.size:
            raise ValueError(f"need {self.size} per-rank inputs, got {len(inputs)}")
        if isinstance(axis_name, tuple):
            if shape is None or math.prod(shape) != self.size:
                raise ValueError(f"mesh {axis_name} needs extents whose product is "
                                 f"{self.size}; got shape={shape}")
            groups = mesh_groups(shape, axis_name)
        else:
            groups = {axis_name: [tuple(range(self.size))]}
        cells, where = [], [[] for _ in range(self.size)]
        for key, members in groups.items():
            for ranks in members:
                cell = _Cell(len(ranks))
                cells.append(cell)
                for i, r in enumerate(ranks):
                    where[r].append((key, cell, i))
        _init_cpu_math()
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        results = [None] * self.size
        errors = [None] * self.size

        def worker(r):
            try:
                with contextlib.ExitStack() as stack:
                    if stream is not None:
                        stack.enter_context(torch.cuda.stream(stream))
                    for key, cell, i in where[r]:
                        stack.enter_context(bind(key, _ThreadRank(cell, i)))
                    results[r] = fn(inputs[r])
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors[r] = e
                for cell in cells:  # a rank may wait in any group
                    cell._barrier.abort()

        threads = [threading.Thread(target=worker, args=(r,)) for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # A rank's own error first, before the broken barriers its abort
        # caused on the other ranks.
        errors.sort(key=lambda e: e is None or isinstance(e, threading.BrokenBarrierError))
        if errors[0] is not None:
            raise errors[0]
        return results


class DistGroup:
    """This process's rank of a ``torch.distributed`` group: the default
    group, or ``group`` (from ``dist.new_group``) with ``ranks`` the global
    rank of each of its ranks in this handle's rank order (default: the
    group's own, ascending).  Peers of every operation are handle ranks,
    mapped to global ranks here.

    Over gloo, every operation on a CUDA tensor stages it: a copy to the
    host, the gloo operation, a copy of the result back to the tensor's
    device.  That is the only way gloo can carry these tensors (it sends,
    receives and gathers host memory only), not a fallback: the caller
    chose the backend, the kernels still run on the card, and a gloo
    error raises.  The copies are exact and the folds run in the
    ``ThreadGroup``'s order, so the bits do not change.  ``staged_bytes``
    counts the bytes copied each way and ``staged_seconds`` the wall time
    of the operations that staged them (the copies and the transfers,
    from after the device work queued before them).
    NCCL groups and host tensors are not staged."""

    def __init__(self, group=None, ranks=None):
        if not dist.is_initialized():
            raise RuntimeError("DistGroup needs torch.distributed.init_process_group first")
        self._pg = group
        if ranks is None:
            ranks = (range(dist.get_world_size()) if group is None
                     else dist.get_process_group_ranks(group))
        self._ranks = [int(r) for r in ranks]
        self.rank = self._ranks.index(dist.get_rank())
        self.size = len(self._ranks)
        ascending = sorted(self._ranks)  # the group's own rank order
        self._order = [ascending.index(r) for r in self._ranks]
        self._gloo = dist.get_backend(group) == "gloo"
        self.staged_bytes = 0
        self.staged_seconds = 0.0
        # The first NCCL operation must involve every rank; the redoub
        # fold round addresses only some of them.
        dist.barrier(group=group)

    def bind(self, axis_name="x"):
        return bind(axis_name, self)

    def _stages(self, device) -> bool:
        """Whether this group's backend cannot carry ``device``'s tensors
        and must stage them through the host: gloo and a CUDA tensor."""
        return self._gloo and device.type == "cuda"

    @contextlib.contextmanager
    def _staging(self, tensors):
        """``(host, back, where)`` for an operation on ``tensors``:
        ``host(t)`` is ``t`` where the backend can carry it (a host copy of
        a CUDA tensor over gloo), ``back(t)`` returns a result to the
        tensors' device, ``where`` is the device the transfer uses; the
        operation's wall time is counted when it stages, from after the
        device work already queued on the stream (so no kernel of the
        caller's is counted as staging)."""
        dev = tensors[0].device if tensors else None
        if dev is None or not self._stages(dev):
            yield (lambda t: t), (lambda t: t), dev
            return

        def host(t):
            self.staged_bytes += t.numel() * t.element_size()
            return t.cpu()

        def back(t):
            self.staged_bytes += t.numel() * t.element_size()
            return t.to(dev)

        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        try:
            yield host, back, torch.device("cpu")
        finally:
            self.staged_seconds += time.perf_counter() - t0

    def _gather_stacked(self, t) -> torch.Tensor:
        """Every rank's ``t``, stacked in this handle's rank order."""
        with self._staging([t]) as (host, back, _):
            h = host(t.contiguous())
            parts = [torch.empty_like(h) for _ in range(self.size)]
            dist.all_gather(parts, h, group=self._pg)
            return back(torch.stack([parts[i] for i in self._order]))

    def _gather(self, t) -> list:
        """Every rank's ``t``, in this handle's rank order."""
        return list(self._gather_stacked(t).unbind(0))

    def _p2p(self, op, t, peer):
        return dist.P2POp(op, t, self._ranks[peer], group=self._pg)

    def exchange(self, tensors, perm) -> tuple:
        dst = [r for s, r in perm if s == self.rank]
        src = _sender_of(self.rank, perm)
        out = _zeros_like_all(tensors) if src is None else None
        with self._staging(list(tensors)) as (host, back, where):
            ops = []
            if dst:
                ops += [self._p2p(dist.isend, host(t.contiguous()), dst[0]) for t in tensors]
            if src is not None:
                recv = [torch.empty(t.shape, dtype=t.dtype, device=where) for t in tensors]
                ops += [self._p2p(dist.irecv, t, src) for t in recv]
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            if src is not None:
                out = tuple(back(t) for t in recv)
        return out

    def all_to_all(self, tensors) -> tuple:
        with self._staging(list(tensors)) as (host, back, _):
            ins = [host(t.contiguous()) for t in tensors]
            outs = [torch.empty_like(t) for t in ins]
            ops = []
            for t, out in zip(ins, outs):
                out[self.rank] = t[self.rank]
                for peer in range(self.size):
                    if peer != self.rank:
                        ops.append(self._p2p(dist.isend, t[peer].contiguous(), peer))
                        ops.append(self._p2p(dist.irecv, out[peer], peer))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            return tuple(back(out) for out in outs)

    def all_gather(self, tensors) -> tuple:
        return tuple(self._gather_stacked(t) for t in tensors)

    def flags_across(self, *flags) -> tuple:
        both = torch.stack([f.to(torch.int32) for f in flags])
        with self._staging([both]) as (host, back, _):
            h = host(both)
            dist.all_reduce(h, op=dist.ReduceOp.MAX, group=self._pg)
            both = back(h)
        return tuple((both > 0).unbind(0))

    def sum_across(self, x) -> torch.Tensor:
        return _fold(self._gather(x))

    def max_across(self, x) -> torch.Tensor:
        return self._gather_stacked(x).amax(dim=0)


class DistMesh:
    """This process's rank of a mesh over ``torch.distributed``: the
    world's ranks laid out over ``axis_names`` with extents ``shape``,
    first axis major, one ``DistGroup`` per handle of ``mesh_groups``.
    Every process creates every sub-group, in the same order (the
    library's rule), then its own handles in that order.  ``bind()``
    binds all of them on this thread; ``run`` runs this process's rank
    with them bound.  ``device`` is where the rank computes (None: the
    mesh carries collectives only, and a train step refuses it)."""

    def __init__(self, shape, axis_names, device=None):
        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs torch.distributed.init_process_group first")
        self.shape, self.axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        self.size = math.prod(self.shape)
        if self.size != dist.get_world_size():
            raise ValueError(f"mesh {self.shape} needs {self.size} processes, the world "
                             f"has {dist.get_world_size()}")
        self.device = None if device is None else resolve_device(device)
        me = dist.get_rank()
        mine = []
        for key, members in mesh_groups(self.shape, self.axis_names).items():
            for ranks in members:
                pg = dist.new_group(sorted(ranks))
                if me in ranks:
                    mine.append((key, pg, ranks))
        self.handles = {key: DistGroup(pg, ranks) for key, pg, ranks in mine}
        self.rank = me
        self.local_ranks = (me,)  # the mesh ranks this process runs

    @contextlib.contextmanager
    def bind(self):
        with bound(self.handles):
            yield self

    def run(self, fn, inputs) -> list:
        """``[fn(inputs[0])]``: this process's rank, with every handle of
        the mesh bound (``ThreadMesh.run``'s contract for the one rank in
        ``local_ranks``)."""
        if len(inputs) != 1:
            raise ValueError(f"a DistMesh process runs one rank, got {len(inputs)} inputs")
        _init_cpu_math()
        with self.bind():
            return [fn(inputs[0])]

    def staged(self) -> tuple:
        """(bytes, seconds) staged through the host by this process's
        handles so far (``DistGroup``)."""
        hs = self.handles.values()
        return sum(h.staged_bytes for h in hs), sum(h.staged_seconds for h in hs)
