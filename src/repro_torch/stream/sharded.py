"""Reductions over row-sharded sketches: one all-reduce of a fixed-size delta.

These are the batch (non-streaming) entry points of the delta/all-reduce
algebra the StreamEngine loops: each process computes its local accumulator
delta from the rows it owns, and the only collective is one :func:`psum` of
the fixed-size delta — (p,) for the mean, (p, p) for the covariance, the
(r, K, p) sums and counts for K-means — however many rows each process holds.
The reference's ``jax.lax.psum`` inside ``shard_map`` becomes :func:`psum`:
the delta's tensors packed into one flat float32 buffer, one
``torch.distributed.all_reduce`` over the mesh's process group, unpacked
again, integer fields without loss.

The ``repro_torch.api`` sharded backend streams through the same helpers: its
reducers keep one step's shard sketches, reduce them with one call, fold the
result and drop them, so host memory stays constant in the stream length.

A process's rows need no padding here: its block enters the all-reduce as its
own delta whatever its row count. Where a caller does pad (``mask=``), the
masked rows add nothing, as zero-value pad rows add nothing to the
reference's linear deltas and its mask keeps them out of the K-means sums.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.cluster.bootstrap import Mesh, contiguous_blocks, local_shards
from repro_torch.core.sampling import SparseRows
from repro_torch.lowrank import range_finder as lr_range
from repro_torch.stream import accumulators as acc

# 16-bit limbs of an integer field, each summed exactly in float32 while
# world · (2^16 − 1) < 2^24
_LIMB = 16
MAX_WORLD = 256


def _flatten(tree, out: list):
    """The tensors of a delta (a tensor, tuple/list or dataclass of them, or
    None) in a fixed order, and a function that rebuilds it from new ones."""
    if tree is None:
        return lambda it: None
    if torch.is_tensor(tree):
        out.append(tree)
        return lambda it: next(it)
    if isinstance(tree, (tuple, list)):
        subs = [_flatten(t, out) for t in tree]
        return lambda it: type(tree)(f(it) for f in subs)
    if dataclasses.is_dataclass(tree):
        names = [f.name for f in dataclasses.fields(tree)]
        subs = [_flatten(getattr(tree, n), out) for n in names]
        return lambda it: dataclasses.replace(tree, **{n: f(it) for n, f in zip(names, subs)})
    raise TypeError(f"psum cannot reduce a {type(tree).__name__}")


def _limbs(dtype: torch.dtype) -> int:
    return max(1, torch.iinfo(dtype).bits // _LIMB)


def psum_bytes(tree) -> int:
    """Bytes of the float32 buffer :func:`psum` all-reduces for ``tree``."""
    leaves: list = []
    _flatten(tree, leaves)
    return 4 * sum(t.numel() * (1 if t.is_floating_point() else _limbs(t.dtype)) for t in leaves)


def psum(tree, mesh: Mesh | None):
    """The element-wise sum of ``tree`` over the mesh's processes, in every
    process: one ``dist.all_reduce`` of one flat buffer, inside
    ``record_function("obs.psum")``.

    Float fields must be float32; an integer field travels as 16-bit limbs
    summed in float32 and comes back exactly, wrapping as the integer sum
    does. With no mesh, or a mesh with no process group, it is the identity;
    a group of world size 1 still runs its all-reduce.
    """
    if mesh is None or not mesh.collective:
        return tree
    if not dist.is_initialized():
        raise RuntimeError(f"{mesh} reduces over a process group, but none is "
                           "initialized (cluster.initialize)")
    if dist.get_world_size() > MAX_WORLD:
        raise ValueError(f"psum sums integer limbs exactly up to {MAX_WORLD} processes")
    leaves: list = []
    rebuild = _flatten(tree, leaves)
    if not leaves:
        return tree
    with record_function("obs.psum"):
        parts = []
        for t in leaves:
            if t.is_floating_point():
                if t.dtype != torch.float32:
                    raise TypeError(f"psum reduces float32 fields, got {t.dtype}")
                parts.append(t.reshape(-1))
            else:
                x = t.reshape(-1).to(torch.int64)
                n = _limbs(t.dtype)
                limbs = [(x >> (_LIMB * i)) & 0xFFFF for i in range(n - 1)]
                limbs.append(x >> (_LIMB * (n - 1)))            # the signed top limb
                parts.append(torch.stack(limbs).to(torch.float32).reshape(-1))
        buf = torch.cat(parts) if len(parts) > 1 else parts[0].clone()
        dist.all_reduce(buf)
        out, at = [], 0
        for t in leaves:
            if t.is_floating_point():
                out.append(buf[at:at + t.numel()].reshape(t.shape))
                at += t.numel()
            else:
                n = _limbs(t.dtype)
                limbs = buf[at:at + n * t.numel()].reshape(n, -1).to(torch.int64)
                at += n * t.numel()
                total = limbs[0].clone()
                for i in range(1, n):
                    total += limbs[i] << (_LIMB * i)
                out.append(total.to(t.dtype).reshape(t.shape))
    return rebuild(iter(out))


def _parts(s) -> list[SparseRows]:
    return list(s) if isinstance(s, (list, tuple)) else [s]


def _masked(s: SparseRows, mask) -> SparseRows:
    if mask is None:
        return s
    keep = torch.as_tensor(mask, device=s.values.device) != 0
    return SparseRows(s.values[keep], s.indices[keep], s.p)


def sharded_moments(s, mesh: Mesh | None, axes=("data",), track_cov: bool = True,
                    cov_path: str = "dense", impl: str = "auto") -> acc.MomentState:
    """All-reduced MomentState delta of this process's rows (every process
    gets the same). ``s`` is a SparseRows or a list of them (a step's local
    shard sketches, whose deltas are summed in order before the one
    all-reduce). ``cov_path="compact"`` uses the n·m² outer-product delta."""
    delta = None
    for part in _parts(s):
        d = acc.moment_delta(part, track_cov=track_cov, cov_path=cov_path, impl=impl)
        delta = d if delta is None else acc.moment_apply(delta, d)
    return psum(delta, mesh)


def sharded_lowrank(s, omega_mat: torch.Tensor, mesh: Mesh | None, axes=("data",),
                    impl: str = "auto") -> lr_range.RangeState:
    """All-reduced RangeState delta (the fixed (p, l) + 2·(p,) state, never
    (p, p)) of this process's rows — the low-rank analogue of
    :func:`sharded_moments`."""
    delta = None
    for part in _parts(s):
        d = lr_range.range_delta(part, omega_mat, impl=impl)
        delta = d if delta is None else lr_range.range_apply(delta, d)
    return psum(delta, mesh)


def sharded_mean(s, mesh: Mesh | None, axes=("data",), impl: str = "auto") -> torch.Tensor:
    """Thm-4 estimator with an all-reduced accumulator (traffic: (p,))."""
    st = sharded_moments(s, mesh, axes, track_cov=False, impl=impl)
    return acc.moment_finalize_mean(st, _parts(s)[0].m)


def sharded_cov(s, mesh: Mesh | None, axes=("data",), impl: str = "auto") -> torch.Tensor:
    """Thm-6 estimator with an all-reduced accumulator (traffic: (p, p))."""
    st = sharded_moments(s, mesh, axes, track_cov=True, impl=impl)
    return acc.moment_finalize_cov(st, _parts(s)[0].m)


def sharded_kmeans_step(state: acc.KMeansState, s, mesh: Mesh | None, axis: str = "data", *,
                        decay: float = 1.0, track_reassignments: bool = False, mask=None,
                        impl: str = "auto"):
    """One streaming mini-batch K-means step over this process's rows.

    Assignment stays local (K4), the only collective is one all-reduce of
    the fixed-size (sums, counts, obj, n) delta, and the Eq.-39 apply (with
    ``decay``) runs once on the replicated state. ``s`` is a SparseRows or a
    step's list of local shard sketches (their deltas summed in order).
    Returns ``(new_state, reassigned)``: with ``track_reassignments`` the
    rows are re-assigned under the new centers and the (r,) int32 counts of
    changed labels ride one more all-reduce; else ``None``. ``mask`` (one
    SparseRows only) keeps the rows where it is nonzero: masked pad rows add
    nothing to the sums, counts, objective or row count.
    """
    parts = _parts(s)
    if mask is not None:
        if len(parts) != 1:
            raise ValueError("mask= applies to a single SparseRows")
        parts = [_masked(parts[0], mask)]
    delta, pairs = None, []
    for part in parts:
        d, a0 = acc.kmeans_delta_with_assign(state, part, impl=impl)
        delta = d if delta is None else acc.kmeans_add(delta, d)
        pairs.append((part, a0))
    new = acc.kmeans_apply(state, psum(delta, mesh), decay=decay)
    if not track_reassignments:
        return new, None
    cnt = sum(acc.kmeans_reassigned(new, part, a0, impl=impl) for part, a0 in pairs)
    return new, psum(cnt, mesh)


# --------------------------------------------- distributed-data entry points --
# Place rows on the mesh (each process keeps the block it owns), sketch them
# where they are, and run the sparse Lloyd solver on the sketch.


def shard_rows(x, mesh: Mesh, axes=("data",), device=None) -> torch.Tensor:
    """This process's block of (n, …) rows row-sharded over the mesh: the
    contiguous rows of the shard positions it owns (one process: all rows)."""
    t = x if torch.is_tensor(x) else torch.as_tensor(x)
    mine = local_shards(mesh, axes[0])
    blocks = contiguous_blocks(t.shape[0], mesh.size)
    rows = [i for pos in mine for i in blocks[pos]]
    out = t[rows[0]:rows[-1] + 1] if rows else t[:0]
    return out if device is None else out.to(device)


def sketch_sharded(x, spec, mesh: Mesh, axes=("data",), impl: str = "auto") -> SparseRows:
    """One-pass compress of row-sharded data: this process's block of the
    sketch of ``x`` under the spec's one-shot mask key. Each row's mask is
    keyed by its global position, so every process sketches the rows and
    keeps its block; the union over processes is the sketch of x."""
    from repro_torch.core import sketch as sketch_mod

    t = x if torch.is_tensor(x) else torch.as_tensor(x)
    s = sketch_mod.sketch(t, spec, impl=impl)
    rows = shard_rows(torch.arange(t.shape[0]), mesh, axes)
    if rows.numel() == t.shape[0]:
        return s
    return SparseRows(s.values[rows.to(s.values.device)], s.indices[rows.to(s.values.device)], s.p)


def sharded_kmeans(s: SparseRows, k: int, key, mesh: Mesh, n_init: int = 3,
                   max_iter: int = 50, tol: float = 1e-6, impl: str = "auto"):
    """Sparsified K-means (Lloyd, Alg. 1) on the sketch; its many small
    reductions are over rows the caller holds, so one process runs the
    solver on the whole sketch (multi-process Lloyd is not offered: a
    process's block alone would not be the dataset)."""
    from repro_torch.core import kmeans
    from repro_torch.kernels import ops

    if mesh is not None and len(set(mesh.owners)) > 1:
        raise ValueError("sharded_kmeans (Lloyd) runs in one process; stream the "
                         "rows through the minibatch fold (sharded_kmeans_step) instead")
    return kmeans.sparse_kmeans_core(s.values, s.indices, s.p, k, key, n_init=n_init,
                                     max_iter=max_iter, tol=tol,
                                     assign_fn=ops.kernel_assign_fn(impl), impl=impl)
