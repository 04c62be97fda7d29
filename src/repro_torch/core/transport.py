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
    order plays a part.

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
    ``all_reduce(MAX)`` for the flags, ``all_gather`` for the sum and the
    gather.  NCCL on GPUs, gloo on the CPU.

A group is bound to an axis name per thread (``bind``); a communicator
built for that axis name finds its rank handle with ``current``.

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
(``DistGroup(group=..., ranks=...)``).
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["resolve_device", "ThreadGroup", "DistGroup", "DistMesh", "mesh_groups",
           "bind", "current"]

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
    mapped to global ranks here."""

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
        # The first NCCL operation must involve every rank; the redoub
        # fold round addresses only some of them.
        dist.barrier(group=group)

    def bind(self, axis_name="x"):
        return bind(axis_name, self)

    def _gather(self, t) -> list:
        """Every rank's ``t``, in this handle's rank order."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self._pg)
        return [parts[i] for i in self._order]

    def _p2p(self, op, t, peer):
        return dist.P2POp(op, t, self._ranks[peer], group=self._pg)

    def exchange(self, tensors, perm) -> tuple:
        dst = [r for s, r in perm if s == self.rank]
        src = _sender_of(self.rank, perm)
        ops = []
        if dst:
            ops += [self._p2p(dist.isend, t.contiguous(), dst[0]) for t in tensors]
        if src is not None:
            out = tuple(torch.empty_like(t) for t in tensors)
            ops += [self._p2p(dist.irecv, t, src) for t in out]
        else:
            out = _zeros_like_all(tensors)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def all_to_all(self, tensors) -> tuple:
        outs = tuple(torch.empty_like(t) for t in tensors)
        ops = []
        for t, out in zip(tensors, outs):
            out[self.rank] = t[self.rank]
            for peer in range(self.size):
                if peer != self.rank:
                    ops.append(self._p2p(dist.isend, t[peer].contiguous(), peer))
                    ops.append(self._p2p(dist.irecv, out[peer], peer))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return outs

    def all_gather(self, tensors) -> tuple:
        return tuple(torch.stack(self._gather(t)) for t in tensors)

    def flags_across(self, *flags) -> tuple:
        both = torch.stack([f.to(torch.int32) for f in flags])
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self._pg)
        return tuple((both > 0).unbind(0))

    def sum_across(self, x) -> torch.Tensor:
        return _fold(self._gather(x))


class DistMesh:
    """This process's ranks of a mesh over ``torch.distributed``: the
    world's ranks laid out over ``axis_names`` with extents ``shape``,
    first axis major, one ``DistGroup`` per handle of ``mesh_groups``.
    Every process creates every sub-group, in the same order (the
    library's rule), then its own handles in that order.  ``bind()``
    binds all of them on this thread."""

    def __init__(self, shape, axis_names):
        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs torch.distributed.init_process_group first")
        self.shape, self.axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        self.size = math.prod(self.shape)
        if self.size != dist.get_world_size():
            raise ValueError(f"mesh {self.shape} needs {self.size} processes, the world "
                             f"has {dist.get_world_size()}")
        me = dist.get_rank()
        mine = []
        for key, members in mesh_groups(self.shape, self.axis_names).items():
            for ranks in members:
                pg = dist.new_group(sorted(ranks))
                if me in ranks:
                    mine.append((key, pg, ranks))
        self.handles = {key: DistGroup(pg, ranks) for key, pg, ranks in mine}
        self.rank = me

    @contextlib.contextmanager
    def bind(self):
        with contextlib.ExitStack() as stack:
            for key, handle in self.handles.items():
                stack.enter_context(bind(key, handle))
            yield self
