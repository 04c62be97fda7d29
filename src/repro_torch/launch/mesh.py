"""Two-level ``node x local`` meshes of ranks.

The counterpart of ``repro.launch.mesh``'s ``make_hier_mesh``,
``mesh_axis_sizes`` and ``dp_axes_of``: the same validation and the same
node-major layout (consecutive ranks share a node: ``rank = node *
gpus_per_node + local``).  A mesh is a ``transport.ThreadMesh`` of ranks
as threads on one device, or, with ``distributed=True``, a
``transport.DistMesh`` over the processes of ``torch.distributed``; both
carry ``axis_names``, ``shape`` and ``device``, bind one handle per axis
and per composite of axes (``core/transport.py``), say which mesh ranks
this process runs (``local_ranks``: every rank of a ``ThreadMesh``, a
``DistMesh`` process's own) and run them (``run(fn, inputs)``, one input
per local rank).

``make_production_mesh`` (the reference's 256- and 512-chip meshes) waits
with the dry-run tooling (ROADMAP A14).
"""
from __future__ import annotations

import math

from repro_torch.core import transport

__all__ = ["ThreadMesh", "make_hier_mesh", "mesh_axis_sizes", "dp_axes_of"]


class ThreadMesh:
    """Ranks as threads of this process on one device, over named axes
    with extents ``shape`` (first axis major)."""

    def __init__(self, shape, axis_names, device="cuda"):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        transport.mesh_groups(self.shape, self.axis_names)  # validates
        self.group = transport.ThreadGroup(math.prod(self.shape), device)
        self.size, self.device = self.group.size, self.group.device
        self.local_ranks = tuple(range(self.size))  # every rank runs in this process

    def run(self, fn, inputs) -> list:
        """``fn(inputs[r])`` as rank r with every handle of the mesh bound
        (``ThreadGroup.run``); the results in rank order."""
        return self.group.run(fn, inputs, axis_name=self.axis_names, shape=self.shape)


def make_hier_mesh(n_nodes: int | None = None, gpus_per_node: int | None = None, *,
                   axis_names: tuple = ("node", "local"), n_ranks: int | None = None,
                   device="cuda", distributed: bool = False):
    """Carve ``n_ranks`` ranks (with ``distributed``: the world's
    processes) into a two-level ``node x local`` mesh, node-major, whose
    ranks compute on ``device``.  A missing extent is inferred from the
    rank count."""
    total = transport.dist.get_world_size() if distributed else n_ranks
    if n_nodes is None and gpus_per_node is None:
        raise ValueError("give n_nodes and/or gpus_per_node")
    if total is None and (n_nodes is None or gpus_per_node is None):
        raise ValueError("give both extents or n_ranks")
    if n_nodes is None:
        n_nodes = total // gpus_per_node
    if gpus_per_node is None:
        gpus_per_node = total // n_nodes
    if total is None:
        total = n_nodes * gpus_per_node
    if n_nodes * gpus_per_node != total:
        raise ValueError(f"{n_nodes} nodes x {gpus_per_node} gpus != {total} ranks")
    if distributed:
        return transport.DistMesh((n_nodes, gpus_per_node), axis_names, device=device)
    return ThreadMesh((n_nodes, gpus_per_node), axis_names, device)


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def dp_axes_of(mesh) -> tuple:
    return tuple(ax for ax in mesh.axis_names if ax in ("pod", "data"))
