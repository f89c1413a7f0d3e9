"""Meshes over the live ranks (the port of ``repro.launch.mesh``).

A mesh is ``cluster.bootstrap.Mesh``: the reference's geometry (axis names
and sizes) whose flat positions the ranks of ``torch.distributed``'s default
group own in contiguous blocks, in rank order (one process without a group
owns them all). Built by functions, so importing this module touches no
process group.
"""
from __future__ import annotations

import math

from repro_torch.cluster.bootstrap import Mesh, make_mesh, process_count


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 = 256 positions a pod; 2×16×16 = 512 across two pods, one rank a
    position. Refuses with fewer ranks than positions, as ``jax.make_mesh``
    does with fewer devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n, world = math.prod(shape), process_count()
    if world < n:
        raise ValueError(f"the {'multi' if multi_pod else 'single'}-pod mesh {shape} needs "
                         f"{n} ranks, but {world} are live")
    return make_mesh(shape, axes)


def make_host_mesh(n_data: int = 4, n_model: int = 2) -> Mesh:
    """A small ("data", "model") mesh over the live ranks."""
    return make_mesh((n_data, n_model), ("data", "model"))


def dp_axes_of(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def tp_axis_of(mesh) -> str | None:
    return "model" if "model" in mesh.axis_names else None
