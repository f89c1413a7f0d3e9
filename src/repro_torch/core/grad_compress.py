"""Sketched gradient compression: the paper's estimator applied to
data-parallel training (the port of ``repro.core.grad_compress``).

Gradients are flattened to one float32 vector (``utils/tree.py``, JAX's leaf
order) and cut into ``chunk_p``-value chunks (a power of two). Each chunk gets
the block-diagonal ROS ``y = H·D·g`` (K2, ``kernels/fwht.hd_precondition``, on
a CUDA tensor), keeps ``m = γ·chunk_p`` coordinates under the step's mask and
is unmixed by ``D·Hᵀ`` (K2 with the signs after the transform). With error
feedback the dropped mass is carried to the next step in a residual, and the
rescale by ``chunk_p / m`` is left out (rand-k + EF); without it the round
trip is the paper's unbiased estimator.

Two modes across the ranks of a data-parallel run (a ``launch.mesh`` mesh
over ``torch.distributed``):

**shared-mask** (``round_trip`` / ``compress_flat`` with ``mesh=``): every
rank keeps the same m coordinates of each chunk, so the only exchange is one
all-reduce of the (n_chunks, m) float32 kept values, n_chunks·m·4 bytes a
step, from which every rank takes the mean. Each rank then scatters the
mean, unmixes it into ĝ and keeps its own residual r_i ← g_i + r_i − ĝ,
which needs no dense all-reduce. The transform, the gather and the scatter
are linear and the mask is shared, so ĝ is the round trip of the ranks'
mean of g_i + r_i: the single-device ĝ of the global batch's gradient, and
the mean of the ranks' residuals is the single-device residual, in exact
arithmetic, step after step.

**per-worker** (``perworker_mean_estimate``, the paper's Thm 4): each rank
draws its own mask under ``batch_key(spec, step, shard)``, its shard id its
flat position over the mesh axes, and the averaged estimator
(p/m)(1/n_w)Σ R_iR_iᵀ(H·D g_i) is the paper's sample mean. The ranks
all-gather each other's kept values and int32 indices (n_w·m·8 bytes), and
each rank scatter-adds them one rank at a time in rank order: a mask's
indices are distinct within a row, so each scatter is repeatable on the
card. ``compress_decompress`` and ``compress_grads`` never read ``mode``, as
the reference's do not: either mode runs the shared-mask round trip there.

**a range of chunks** (``compress_range``, the trainer's placed state,
``train/fsdp.py``): each rank holds one contiguous range of whole chunks of
the mean gradient (the ranks' mean is taken before compression) and the
residual's values in that range, and round-trips only its own rows, their
masks the rows of the one-vector draw (``sample_indices(..., row0=,
total_rows=)``). Nothing crosses ranks here; ``train/fsdp.py`` moves the
gradient into the ranges and ĝ back.

The keys are the repo's (seed, step, shard) discipline: a sketch spec over the
chunk length gives the signs key, and each step's mask is
``sample_indices(sketch.batch_key(spec, step, shard), nc, chunk_p, m)`` —
the reference's masks bit for bit.

At a billion parameters each (n_chunks, chunk_p) float32 intermediate is
gigabytes, so the round trip runs in place where it can: the kept values
are gathered and scattered back in row blocks into the transform's own
output, and the unmix's output becomes ĝ.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch import obs
from repro_torch.cluster.bootstrap import Mesh, process_index
from repro_torch.core import ros
from repro_torch.core import sketch as sketch_mod
from repro_torch.core.sampling import sample_indices
from repro_torch.utils.tree import tree_flatten_to_vector, tree_leaves

# chunk rows gathered and scattered at a time (bounds the int64 index copy)
_ROW_BLOCK = 8192


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    gamma: float = 0.1
    chunk_p: int = 1 << 14            # ROS block size (power of two)
    error_feedback: bool = True
    mode: str = "shared-mask"         # or "per-worker"

    @property
    def m(self) -> int:
        return max(1, int(round(self.gamma * self.chunk_p)))


def mask_spec(cfg: CompressConfig, key) -> sketch_mod.SketchSpec:
    """The compressor's sketch over one gradient chunk — the source of its
    signs key and per-(step, shard) mask keys (``sketch.batch_key``)."""
    return sketch_mod.make_spec(cfg.chunk_p, key, m=cfg.m, transform="hadamard")


def _to_chunks(vec: torch.Tensor, chunk_p: int):
    n = vec.shape[0]
    return torch.nn.functional.pad(vec, (0, -n % chunk_p)).reshape(-1, chunk_p), n


def padded_len(n: int, chunk_p: int) -> int:
    """Length of an n-value vector zero-padded to whole chunks."""
    return n + (-n % chunk_p)


def round_trip(chunks: torch.Tensor, key, step: int, cfg: CompressConfig,
               unbiased: bool | None = None, shard: int = 0, mesh: Mesh | None = None,
               row0: int = 0, total_rows: int | None = None):
    """ĝ and the wire payload of the zero-padded chunks (nc, chunk_p).

    ``row0`` and ``total_rows``: ``chunks`` are rows ``[row0, row0 + nc)`` of
    a vector of ``total_rows`` chunks, and take those rows' masks.

    Returns (g_hat (nc, chunk_p), vals (nc, m)). With a collective ``mesh``
    (the shared-mask exchange) ``vals`` is the ranks' mean of their kept
    values and ĝ its round trip. ``chunks`` is read only by the first
    transform, so a caller may free or overwrite it after; peak temporaries
    are two (nc, chunk_p) float32 arrays and the (nc, m) mask.
    """
    if unbiased is None:
        unbiased = not cfg.error_feedback
    spec = mask_spec(cfg, key)
    nc, cp = chunks.shape
    signs_key = spec.signs_key()
    y = ros.precondition(chunks, signs_key, "hadamard")
    idx = sample_indices(sketch_mod.batch_key(spec, step, shard), nc, cp, cfg.m,
                         device=chunks.device, row0=row0, total_rows=total_rows)
    vals = torch.empty((nc, cfg.m), dtype=y.dtype, device=y.device)
    for r0 in range(0, nc, _ROW_BLOCK):
        torch.gather(y[r0:r0 + _ROW_BLOCK], 1, idx[r0:r0 + _ROW_BLOCK].long(),
                     out=vals[r0:r0 + _ROW_BLOCK])
    vals = exchange_mean(vals, mesh)
    for r0 in range(0, nc, _ROW_BLOCK):             # y becomes ŷ in place
        rows = y[r0:r0 + _ROW_BLOCK]
        rows.zero_().scatter_(1, idx[r0:r0 + _ROW_BLOCK].long(), vals[r0:r0 + _ROW_BLOCK])
        if unbiased:
            rows.mul_(cp / cfg.m)
    del idx
    return ros.unmix(y, signs_key, "hadamard"), vals


def exchange_mean(vals: torch.Tensor, mesh: Mesh | None, mode: str = "shared-mask"
                  ) -> torch.Tensor:
    """``vals`` (float32) overwritten with the ranks' element-wise mean, in
    every rank: one all-reduce of its bytes over the mesh's process group
    (gloo's and NCCL's take CUDA tensors), counted under ``mode`` (the
    trainer's uncompressed gradient: "dense"). The identity without a mesh
    or a process group."""
    if mesh is None or not mesh.collective:
        return vals
    with record_function("grad_compress.exchange"):
        dist.all_reduce(vals)
    count_exchange(mode, vals.numel() * vals.element_size())
    return vals.div_(dist.get_world_size())


def compress_decompress(vec: torch.Tensor, key, step: int, cfg: CompressConfig,
                        unbiased: bool | None = None, shard: int = 0):
    """Shared-mask round trip g → ĝ of one (flat, float32) gradient vector.

    Returns (g_hat, kept_values): in a collective only ``kept_values`` (m a
    chunk) crosses the network; the reconstruction is local. ``shard`` folds
    into the mask key as a stream shard's id does; shared-mask mode keeps 0
    on every worker. ``unbiased`` (default: without error feedback) applies
    the paper's ``chunk_p / m`` rescale (Thm 4).
    """
    chunks, n = _to_chunks(vec, cfg.chunk_p)
    g_hat, vals = round_trip(chunks, key, int(step), cfg, unbiased, shard)
    return g_hat.reshape(-1)[:n], vals


def compress_flat(flat: torch.Tensor, key, step: int, cfg: CompressConfig, shard: int = 0,
                  mesh: Mesh | None = None):
    """The round trip of a gradient already flattened and zero-padded.

    ``flat`` is the (padded_len(n, chunk_p),) float32 vector g + r (the
    gradient plus the error-feedback residual; a rank's own under a
    collective ``mesh``). Returns (g_hat, residual, wire_floats): ``g_hat`` a
    new padded vector (the same on every rank); ``residual`` is ``flat``
    itself overwritten with g + r − ĝ under error feedback (else None). Only
    the first n values of either mean anything.
    """
    g_hat, vals = round_trip(flat.view(-1, cfg.chunk_p), key, step, cfg, shard=shard, mesh=mesh)
    g_hat = g_hat.view(-1)
    residual = flat.sub_(g_hat) if cfg.error_feedback else None
    return g_hat, residual, vals.numel()


def compress_range(rows: torch.Tensor, key, step: int, cfg: CompressConfig, row0: int,
                   total_rows: int):
    """The round trip of one rank's range of chunks of a gradient vector.

    ``rows`` is the (k·chunk_p,) float32 range g + r of chunks ``[row0, row0
    + k)`` of a zero-padded vector of ``total_rows`` chunks: the mean
    gradient plus the error-feedback residual. Returns (g_hat, residual,
    wire_floats) as :func:`compress_flat` does for the whole vector, rows for
    rows (the masks are those rows of the whole vector's): ``g_hat`` a new
    (k·chunk_p,) range, ``residual`` ``rows`` overwritten with g + r − ĝ
    under error feedback (else None), ``wire_floats`` the whole vector's
    kept values, ``total_rows`` · m.
    """
    g_hat, _ = round_trip(rows.view(-1, cfg.chunk_p), key, step, cfg, row0=row0,
                          total_rows=total_rows)
    g_hat = g_hat.view(-1)
    residual = rows.sub_(g_hat) if cfg.error_feedback else None
    return g_hat, residual, total_rows * cfg.m


def compress_grads(grads: Any, key, step: int, cfg: CompressConfig,
                   residual: Any | None = None, shard: int = 0, mesh: Mesh | None = None):
    """Apply sketch compression to a gradient tree (+ error feedback; over a
    collective ``mesh``, the shared-mask exchange of ``compress_flat``).

    Returns (g_hat tree, new_residual tree or None, wire_floats int), each
    leaf in the gradients' dtype, as the reference's.
    """
    n = sum(l.numel() for l in tree_leaves(grads))
    vec, unflatten = tree_flatten_to_vector(grads, padded_len(n, cfg.chunk_p))
    if residual is not None:
        vec[:n] += tree_flatten_to_vector(residual)[0]
    g_hat, new_residual, wire = compress_flat(vec, key, int(step), cfg, shard, mesh)
    return (unflatten(g_hat), None if new_residual is None else unflatten(new_residual),
            wire)


def perworker_mean_estimate(local_vec: torch.Tensor, key, step: int, cfg: CompressConfig,
                            mesh_or_group=None, axes=("data",)) -> torch.Tensor:
    """The paper's Thm-4 estimator across data-parallel ranks: the mean over
    the n_w ranks of (chunk_p/m)·R_iR_iᵀ(H·D g_i), unmixed, in every rank.

    ``mesh_or_group``: a ``launch.mesh`` mesh whose ranks own one position
    each (a rank's shard id is its flat position over ``axes``, the
    reference's ``widx``; the mean runs over the ranks that share its
    position on the other axes), a ``torch.distributed`` process group
    (shard id = the group rank), or None: the one-worker estimator.
    """
    spec = mask_spec(cfg, key)
    chunks, n = _to_chunks(local_vec, cfg.chunk_p)
    nc, cp = chunks.shape
    signs_key = spec.signs_key()                              # shared unitary
    y = ros.precondition(chunks, signs_key, "hadamard")
    widx, peers, group = _workers(mesh_or_group, axes)
    idx = sample_indices(sketch_mod.batch_key(spec, step, widx), nc, cp, cfg.m,
                         device=y.device)
    vals = torch.gather(y, 1, idx.long())
    payload = torch.stack([vals.view(torch.int32), idx])      # (2, nc, m) int32
    parts = _all_gather(payload, group) if group is not False else [payload]
    y.zero_()
    for r in peers:                          # rank order, so the sums repeat
        v, i = parts[r][0].view(torch.float32), parts[r][1]
        y.scatter_add_(1, i.long(), v * (cp / cfg.m))
    y.div_(len(peers))
    return ros.unmix(y, signs_key, "hadamard").reshape(-1)[:n]


def _workers(mesh_or_group, axes):
    """(this rank's shard id, the ranks of its mean in shard order, the group
    to gather over — or False for one worker)."""
    if mesh_or_group is None:
        return 0, [0], False
    if not isinstance(mesh_or_group, Mesh):
        group = mesh_or_group
        return dist.get_rank(group), list(range(dist.get_world_size(group))), group
    mesh = mesh_or_group
    if not mesh.collective:
        if mesh.size != 1:
            raise ValueError(f"{mesh} has {mesh.size} positions but no process group: "
                             "one process is one worker (pass no mesh)")
        return 0, [0], False
    world = dist.get_world_size()
    if sorted(mesh.owners) != list(range(world)):
        raise ValueError(f"perworker_mean_estimate needs one position a rank, got {mesh}")
    sizes = dict(mesh.shape)
    names = mesh.axis_names

    def coords(rank):
        pos, out = mesh.owners.index(rank), {}
        for a in reversed(names):
            pos, out[a] = divmod(pos, sizes[a])
        return out

    def shard_id(c):
        w = 0
        for a in axes:
            w = w * sizes[a] + c[a]
        return w

    mine = coords(process_index())
    others = lambda c: tuple(c[a] for a in names if a not in axes)  # noqa: E731
    peers = sorted((r for r in range(world) if others(coords(r)) == others(mine)),
                   key=lambda r: shard_id(coords(r)))
    return shard_id(mine), peers, None


def count_exchange(mode: str, nbytes: int) -> None:
    """The bytes a rank's exchange moved, as the counter
    ``grad_compress.exchange_bytes{mode=}`` of the default registry (the
    placed trainer's collectives count under modes of their own,
    ``train/fsdp.py``)."""
    obs.default_registry().counter("grad_compress.exchange_bytes", mode=mode).inc(nbytes)


def _all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t``, by group rank (gloo's and NCCL's all-gathers take
    CUDA tensors)."""
    world = dist.get_world_size(group)
    count_exchange("per-worker", world * t.numel() * t.element_size())
    parts = [torch.empty_like(t) for _ in range(world)]
    with record_function("grad_compress.exchange"):
        dist.all_gather(parts, t, group=group)
    return parts


def wire_bytes(p_total: int, cfg: CompressConfig, n_workers: int) -> dict:
    """Napkin accounting of one step's traffic, dense against compressed."""
    dense = 2 * p_total * 4                                   # ring all-reduce ≈ 2p
    if cfg.mode == "shared-mask":
        comp = 2 * int(p_total * cfg.gamma) * 4
    else:
        comp = n_workers * int(p_total * cfg.gamma) * 8       # values+indices gather
    return {"dense_bytes": dense, "compressed_bytes": comp, "ratio": comp / dense}
