"""Process bootstrap for multi-process ingest under the (seed, step, shard) grid.

Every batch is a pure function of (seed, step, shard), so distributing the
stream means each process generates the shards it owns. This module supplies
the pieces for that on ``torch.distributed``:

1. :func:`initialize` — ``init_process_group`` at ``tcp://coordinator``:
   gloo for CPU work, NCCL when the process's device is CUDA, or the backend
   the caller names. One process is a no-op unless a backend is named.
2. :class:`Mesh` / :func:`process_mesh` — a 1-D mesh of ``n_shards`` shard
   positions in which each process owns a contiguous block (earlier ranks
   take the remainder), the layout of the reference's process-sorted device
   mesh. Without a process group one process owns every shard.
3. :func:`local_shards` / :func:`global_shard_batch` / :func:`global_rows` —
   the shards a process owns and its block of a step's rows. The port's
   collectives (``stream.sharded.psum``) reduce each process's local block,
   so a process's block is what enters the reduction.
4. :func:`axis_group` — the process group over some axes of a mesh (the
   "model" axis of expert parallelism, ``models/moe.py``).

Single-process calls are no-ops or identities, so code written against this
module runs unchanged in one process.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None,
               device="cuda") -> bool:
    """Bring up ``torch.distributed`` for a multi-process run; returns whether
    a multi-process runtime is (now) active.

    ``num_processes in (None, 1)`` is the single-process no-op, unless
    ``backend`` is named: then a one-process group comes up (its all-reduce
    still runs, e.g. NCCL's on the card). ``backend=None`` picks "nccl" when
    ``device`` is CUDA and "gloo" otherwise. NCCL needs a card for each rank
    (rank r uses card r); two ranks on one card need ``backend="gloo"``, whose
    collectives take CUDA tensors too. Re-entry is a no-op.
    """
    if dist.is_initialized():
        return is_multiprocess()
    if num_processes in (None, 1) and backend is None:
        return False
    world = int(num_processes or 1)
    rank = int(process_id or 0)
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend 'nccl' needs device='cuda'")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"NCCL needs a card for each of the {world} ranks, but this host has "
                f"{cards}; run the ranks over gloo (--dist-backend gloo), whose "
                "collectives take CUDA tensors on a shared card")
        torch.cuda.set_device(rank)
    addr = coordinator_address or f"127.0.0.1:{free_port()}"
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=world,
                            rank=rank)
    return is_multiprocess()


def run_ranks(cmd: list[str], nproc: int) -> int:
    """Run ``cmd --process-id r`` for ranks r = 0 … nproc − 1, with this
    package on ``PYTHONPATH``, and wait for them: the first rank to fail
    stops the others. Returns 0, or the first failing rank's exit code."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=src + (os.pathsep + path if path else ""))
    procs = [subprocess.Popen(cmd + ["--process-id", str(pid)], env=env)
             for pid in range(nproc)]
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs if p.returncode not in (None, 0)]
            if failed:
                rc = failed[0]
                break
            time.sleep(0.2)
        rc = rc or next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    if rc:
        print(f"a rank failed with exit code {rc}", file=sys.stderr)
    return rc


def shutdown() -> None:
    """Tear the process group down (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multiprocess() -> bool:
    return process_count() > 1


def contiguous_blocks(n_shards: int, n_workers: int) -> list[list[int]]:
    """``n_shards`` positions split into ``n_workers`` contiguous blocks, the
    earlier blocks one longer where it does not divide."""
    base, rem = divmod(n_shards, n_workers)
    out, start = [], 0
    for w in range(n_workers):
        size = base + (1 if w < rem else 0)
        out.append(list(range(start, start + size)))
        start += size
    return out


class Mesh:
    """A mesh of shard positions over processes.

    ``axis_names`` and ``shape`` (``mesh.shape[axis]`` is an axis's size) are
    the reference's ``jax.sharding.Mesh`` geometry; ``owners[i]`` is the rank
    that owns flat position i. ``collective`` says whether the mesh reduces
    over the live process group (``torch.distributed``'s default group) or,
    in one process without a group, is its own reduction. Meshes are equal
    when their geometry and owners are.
    """

    def __init__(self, shape, axis_names, owners=None, collective: bool = False):
        self.axis_names = tuple(axis_names)
        self._sizes = tuple(int(s) for s in shape)
        if len(self._sizes) != len(self.axis_names):
            raise ValueError(f"shape {self._sizes} does not match axes {self.axis_names}")
        n = math.prod(self._sizes)
        self.owners = tuple(int(r) for r in owners) if owners is not None else (0,) * n
        if len(self.owners) != n:
            raise ValueError(f"{len(self.owners)} owners for {n} positions")
        self.collective = bool(collective)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self._sizes))

    @property
    def size(self) -> int:
        return len(self.owners)

    def _key(self):
        return (self.axis_names, self._sizes, self.owners, self.collective)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, owners={list(self.owners)}, "
                f"collective={self.collective})")


def make_mesh(shape, axis_names) -> Mesh:
    """A mesh of this geometry over the live processes: each rank owns a
    contiguous block of the flat positions (one process: all of them)."""
    n, world = math.prod(int(s) for s in shape), process_count()
    if n < world:
        raise ValueError(f"a mesh of {n} positions leaves some of the {world} processes "
                         "without a shard — raise n_shards or lower the process count")
    owners = [r for r, block in enumerate(contiguous_blocks(n, world)) for _ in block]
    return Mesh(shape, axis_names, owners, collective=dist.is_initialized())


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The ranks that share this rank's coordinates on every axis of a mesh
    but ``axes``: ``group`` (a ``torch.distributed`` group; None when the
    ranks are this one alone), ``ranks`` in order of their flat index over
    ``axes``, and this rank's ``index`` among them."""

    group: object
    ranks: tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


_AXIS_GROUPS: dict = {}


def axis_group(mesh: Mesh, axes) -> AxisGroup:
    """This rank's :class:`AxisGroup` over ``axes`` of ``mesh``, each rank
    owning one position. Without a process group (or a mesh that does not
    reduce over it) it is this process alone. The groups are made once a
    (mesh, axes, default group): every rank creates all of them, one for
    each set of coordinates on the other axes in row-major order, as
    ``torch.distributed.new_group`` requires."""
    axes = tuple(axes)
    if not (mesh.collective and dist.is_initialized()):
        return AxisGroup(None, (0,), 0)
    world = dist.get_world_size()
    if sorted(mesh.owners) != list(range(world)):
        raise ValueError(f"{mesh} has positions that share a rank: a group over its axes "
                         "needs one rank a position")
    key = (mesh, axes, id(dist.group.WORLD))
    if key not in _AXIS_GROUPS:
        sizes = [mesh.shape[a] for a in mesh.axis_names]
        coords = np.indices(sizes).reshape(len(sizes), -1).T      # row-major, one a position
        keep = [i for i, a in enumerate(mesh.axis_names) if a not in axes]
        along = [i for i, a in enumerate(mesh.axis_names) if a in axes]
        blocks: dict = {}
        for pos, c in enumerate(coords):
            blocks.setdefault(tuple(c[keep]), []).append(
                (int(np.ravel_multi_index(c[along], [sizes[i] for i in along])) if along else 0,
                 mesh.owners[pos]))
        me, mine = dist.get_rank(), None
        for other in sorted(blocks):
            ranks = tuple(r for _, r in sorted(blocks[other]))
            if list(ranks) != sorted(ranks):
                # a group's collectives order its members by rank
                raise ValueError(f"{mesh}: the ranks along {axes} do not ascend with their "
                                 "coordinates")
            if len(ranks) == 1:
                group = None
            elif len(ranks) == world:
                group = dist.group.WORLD
            else:
                group = dist.new_group(list(ranks))
            if me in ranks:
                mine = AxisGroup(group, ranks, ranks.index(me))
        _AXIS_GROUPS[key] = mine
    return _AXIS_GROUPS[key]


def process_mesh(n_shards: int | None = None, axis: str = "data") -> Mesh:
    """A 1-D ``(n_shards,)`` mesh whose positions each process owns in a
    contiguous block. ``n_shards=None`` gives one shard a process. Cached per
    (n_shards, axis) and process group, so callers share one mesh object."""
    n = process_count() if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"process_mesh needs n_shards >= 1, got {n}")
    return _process_mesh_cached(n, axis, process_count(), dist.is_initialized())


@functools.lru_cache(maxsize=None)
def _process_mesh_cached(n_shards: int, axis: str, world: int, live: bool) -> Mesh:
    return make_mesh((n_shards,), (axis,))


def local_shards(mesh: Mesh, axis: str = "data") -> list[int]:
    """The shard positions along ``axis`` this process owns. Single-process:
    every shard."""
    if len(mesh.axis_names) != 1:
        raise ValueError(f"local_shards expects a 1-D mesh, got shape {mesh.shape} "
                         f"(axes {mesh.axis_names})")
    pid = process_index()
    return [i for i, r in enumerate(mesh.owners) if r == pid]


def global_shard_batch(source, seed, step: int, mesh: Mesh, axis: str = "data",
                       device="cpu") -> torch.Tensor:
    """This process's block of one step's (n_shards, b, p) batch: the
    (n_local, b, p) rows of the shards it owns, generated through the
    (seed, step, shard) contract, on ``device``. All shards must return
    equal-shaped batches (the engine's contract)."""
    mine = local_shards(mesh, axis)
    if not mine:
        raise ValueError(f"process {process_index()} owns no shards of mesh axis "
                         f"{axis!r} — shrink n_shards or the process count")
    return stack_batches([source(seed, step, s) for s in mine], device)


def stack_batches(parts, device) -> torch.Tensor:
    """Equal-shaped float32 batches stacked on ``device`` (tensors without a
    host copy, numpy arrays through one)."""
    if all(torch.is_tensor(t) for t in parts):
        return torch.stack([t.to(device=device, dtype=torch.float32) for t in parts])
    return torch.from_numpy(np.stack([np.asarray(t, dtype=np.float32) for t in parts])).to(device)


def global_rows(arr, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """This process's block of a (rows, …) array row-sharded over ``axis``:
    the rows its positions own, as a tensor (the block the collectives
    reduce). Single process: the whole array."""
    local_shards(mesh, axis)      # a 1-D mesh
    return arr if torch.is_tensor(arr) else torch.from_numpy(np.asarray(arr))
