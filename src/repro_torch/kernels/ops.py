"""The one switch between the port's kernels and their plain versions.

``mode``: "auto" and "kernel" go to the kernel wrapper, which launches the
CUDA kernel for a CUDA tensor and computes the plain version for a CPU tensor;
"ref" asks for the plain version on any device. Every call is tallied in
:data:`DISPATCH` by (op, path), where path is "kernel" when a kernel was
launched, "kernel_chunked" when the transform went to K3 (p > 2^15) or the
sketch to K3 and a gather (p > C_max·2^15), "kernel_cluster" when the sketch
went to K3's cluster kernel in its gather mode (2^15 < p ≤ C_max·2^15),
"segments" when K6 walked the compact covariance's runs, and "ref" otherwise.

The same call bumps ``obs.default_registry().counter("kernels.dispatch",
op=, path=)`` (:func:`_count_dispatch`, the reference's
``repro.kernels.ops._count_dispatch``), so a scrape of the registry shows
each op's paths and a ``path="ref"`` series where a plain version ran.
Unlike the reference, which counts once per trace (a compilation), the port
counts every call: a series is the number of dispatches, and the two agree
with :data:`DISPATCH` call for call. :func:`reset_counts` zeroes
:data:`DISPATCH` and the launch counts; the registry's series start over
with a fresh registry (``obs.set_default_registry``).

Under ``roofline.counter.OpCounter`` each call that goes to a kernel
wrapper counts once, by its ``roofline.kernels`` model, and the ops inside
it (a plain version's passes on the CPU) do not count. On the meta device
such a call returns an empty output of the kernel's shape and runs nothing.
"""
from __future__ import annotations

import collections
import threading

import torch

from repro_torch import obs
from repro_torch.core.ros import IMPLS as MODES
from repro_torch.kernels import _build
from repro_torch.kernels import fwht as _fwht
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sketch_fused as _sf
from repro_torch.kernels import sparse_assign as _sa
from repro_torch.kernels import spmm as _spmm
from repro_torch.roofline import kernels as _rl
from repro_torch.roofline.counter import kernel_call

DISPATCH: collections.Counter = collections.Counter()
_DISPATCH_LOCK = threading.Lock()

# each kernel's wrapper, which carries its launch count
WRAPPERS = {
    "sketch_fused": _sf.sketch_fused,
    "sketch_fused_cluster": _sf.sketch_fused_cluster,   # K1's function above 2^15
    "hd_precondition": _fwht.hd_precondition,
    "hd_precondition_chunked": _fwht.hd_precondition_chunked,
    "sparse_assign": _sa.sparse_assign,
    "spmm": _spmm.spmm,
    "spmm_t": _spmm.spmm_t,
    "transpose_columns": _spmm.transpose_columns,   # K6's first step
}


def _on_card(mode: str, t: torch.Tensor) -> bool:
    """Whether ``mode`` sends a CUDA tensor ``t`` to a kernel."""
    return mode in ("auto", "kernel") and t.device.type == "cuda"


def _meta(t: torch.Tensor) -> bool:
    """Whether ``t`` is a meta tensor: shapes only, for the dry-run's count."""
    return t.device.type == "meta"


def _count_dispatch(op: str, path: str) -> None:
    """Tally one dispatch of ``op`` under ``path`` in :data:`DISPATCH` and as
    ``kernels.dispatch{op=,path=}`` in the default registry (per call; the
    reference counts per trace)."""
    with _DISPATCH_LOCK:
        DISPATCH[(op, path)] += 1
    obs.default_registry().counter("kernels.dispatch", op=op, path=path).inc()


def _use_kernel(op: str, mode: str, t: torch.Tensor, path: str = "kernel") -> bool:
    """Whether ``op`` goes to its kernel wrapper, tallied under ``path`` when
    a kernel launches (see :data:`DISPATCH`)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    _count_dispatch(op, path if _on_card(mode, t) else "ref")
    return mode in ("auto", "kernel")


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_counts`, by kernel."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_counts() -> None:
    """Zero every launch counter and the dispatch tally."""
    with _build.COUNT_LOCK:
        for fn in WRAPPERS.values():
            fn.launches = 0
        _sa.sparse_assign.by_shape.clear()
    with _DISPATCH_LOCK:
        DISPATCH.clear()


def hd_precondition(x: torch.Tensor, signs: torch.Tensor, signs_after: bool = False,
                    mode: str = "auto") -> torch.Tensor:
    """y = H·(d⊙x), or d⊙(H·x) with ``signs_after`` (unmix); K2 up to
    p = 2^15, K3 above."""
    x = x.contiguous()
    p = x.shape[-1]
    chunked = p > _fwht.MAX_P_SINGLE
    if _use_kernel("hd_precondition", mode, x, "kernel_chunked" if chunked else "kernel"):
        with kernel_call("hd_precondition", lambda: _rl.fwht_roofline(x.numel() // p, p)):
            if _meta(x):
                return torch.empty_like(x)
            return _fwht.hd_precondition(x, signs, signs_after)
    return _ref.ref_hd_precondition(x, signs, signs_after)


def sketch_fused(x: torch.Tensor, signs: torch.Tensor, indices: torch.Tensor,
                 mode: str = "auto") -> torch.Tensor:
    """values (n, m) = (H·(signs⊙x))[i, indices[i]] — precondition and keep m
    values per row in one pass.

    K1 up to p = 2^15; K3's cluster kernel in its gather mode up to
    C_max·2^15 (2^19 on an H100 80GB HBM3), in one pass with no (n, p)
    intermediate; above that K3 and a gather, as the reference composes them.
    """
    x = x.contiguous()
    p = x.shape[-1]
    path = "kernel"
    if _on_card(mode, x) and p > _fwht.MAX_P_SINGLE:
        fits = p <= _fwht.max_cluster(x.device) << _fwht.CHUNK_LOG
        path = "kernel_cluster" if fits else "kernel_chunked"
    if not _use_kernel("sketch_fused", mode, x, path):
        return _ref.ref_sketch_fused(x, signs, indices)
    n, m = indices.shape
    with kernel_call("sketch_fused", lambda: _rl.sketch_fused_roofline(n, p, m)):
        if _meta(x):
            return x.new_empty((n, m))
        if path == "kernel_cluster":
            return _sf.sketch_fused_cluster(x, signs, indices.contiguous())
        if path == "kernel_chunked":
            return torch.gather(_fwht.hd_precondition_chunked(x, signs), 1, indices.long())
        return _sf.sketch_fused(x, signs, indices.contiguous())   # or the plain version on the CPU


def sparse_assign(values: torch.Tensor, indices: torch.Tensor, centers: torch.Tensor,
                  mode: str = "auto"):
    """(dists, argmin) for sparsified K-means assignment; centers (K, p) or
    (r, K, p)."""
    if _use_kernel("sparse_assign", mode, values):
        (n, m), (k, p) = values.shape, centers.shape[-2:]
        r = centers.shape[0] if centers.ndim == 3 else 1
        with kernel_call("sparse_assign", lambda: _rl.sparse_assign_roofline(n, m, r, k, p)):
            if _meta(values):
                lead = centers.shape[:-2]
                return (values.new_empty(lead + (n, k), dtype=torch.float32),
                        values.new_empty(lead + (n,), dtype=torch.int32))
            return _sa.sparse_assign(values.contiguous(), indices.contiguous(),
                                     centers.contiguous())
    return _ref.ref_sparse_assign(values, indices, centers)


def kernel_assign_fn(mode: str = "auto"):
    """Lloyd's ``assign_fn`` (``core.kmeans``): (n, K) distances by K4."""

    def fn(values, indices, centers):
        return sparse_assign(values, indices, centers, mode=mode)[0]

    return fn


def cluster_columns(values: torch.Tensor, indices: torch.Tensor, p: int, mode: str = "auto"):
    """What :func:`cluster_sums` reuses across a fit's iterations: K6's
    transposition of the rows, once (None where the plain version runs)."""
    if not _on_card(mode, values):
        return None
    n, m = values.shape
    with kernel_call("transpose_columns", lambda: _rl.spmm_t_roofline(n, m, p, 0)):
        return _spmm.transpose_columns(values.contiguous(), indices.contiguous(), p)


def cluster_sums(values: torch.Tensor, indices: torch.Tensor, labels: torch.Tensor, k: int,
                 p: int, columns=None, mode: str = "auto"):
    """(sums, counts) (K, p) of each cluster's kept values, coordinate by
    coordinate — Lloyd's center update: on the card K6's walk for the sums
    and an integer histogram for the counts (bit-identical from run to run),
    the plain scatter-add in row order elsewhere. ``labels`` (r, n) gives
    (r, K, p) each, r labellings of the rows in one walk (the streaming
    K-means hypotheses)."""
    if _use_kernel("cluster_sums", mode, values):
        (n, m), r = values.shape, labels.numel() // max(values.shape[0], 1)
        with kernel_call("cluster_sums", lambda: _rl.spmm_t_roofline(n, m, p, r * k)):
            if _meta(values):
                shape = tuple(labels.shape[:-1]) + (k, p)
                return (values.new_empty(shape, dtype=torch.float32),
                        values.new_empty(shape, dtype=torch.float32))
            return _spmm.cluster_sums(values.contiguous(), indices.contiguous(), labels, k, p,
                                      columns)
    return _ref.ref_cluster_sums(values, indices, labels, k, p)


def column_sums(values: torch.Tensor, indices: torch.Tensor, p: int, mode: str = "auto"):
    """(Σv, Σv²) (p,) float32 over each column's kept entries — the moment
    folds' Σw and the diagonal of Σ w wᵀ. On the card K6 with no product
    columns (its transposition, then a walk that only sums), bit-identical
    from run to run where a float scatter-add would add by atomics; the plain
    scatter-add elsewhere."""
    if _use_kernel("spmm_t", mode, values) and values.device.type in ("cuda", "meta"):
        n, m = values.shape
        with kernel_call("column_sums", lambda: _rl.spmm_t_roofline(n, m, p, 0, col_sums=True)):
            if _meta(values):
                return (values.new_empty((p,), dtype=torch.float32),
                        values.new_empty((p,), dtype=torch.float32))
            values = values.to(torch.float32)
            t = values.new_empty((values.shape[0], 0))
            _, sum_v, sum_v2 = _spmm.spmm_t(values.contiguous(), indices.contiguous(), t, p,
                                            col_sums=True)
            return sum_v, sum_v2
    return _ref.ref_column_sums(values, indices, p)


def segment_sums(values: torch.Tensor, order: torch.Tensor, starts: torch.Tensor,
                 mode: str = "auto") -> torch.Tensor:
    """(S,) float32 sums of ``values[order[k]]`` over each run [starts[s],
    starts[s + 1]) of a stable sort by key (the compact covariance's sum by
    key): on the card K6's walk over flat positions, bit-identical from run to
    run; the plain scatter-add in k order elsewhere."""
    if _use_kernel("spmm_t", mode, values, path="segments"):
        segs = starts.shape[0] - 1
        # K6's walk over the N flat positions into S segments, summing only
        with kernel_call("segment_sums",
                         lambda: _rl.spmm_t_roofline(1, order.shape[0], segs, 0, col_sums=True)):
            if _meta(values):
                return values.new_empty((max(segs, 0),), dtype=torch.float32)
            return _spmm.segment_sums(values.contiguous(), order.contiguous(),
                                      starts.contiguous())
    return _ref.ref_segment_sums(values, order, starts)


def spmm(values: torch.Tensor, indices: torch.Tensor, dense: torch.Tensor,
         mode: str = "auto") -> torch.Tensor:
    """T (n, l) = W @ dense — project compact sparse rows onto l columns."""
    if _use_kernel("spmm", mode, values):
        (n, m), (p, ell) = values.shape, dense.shape
        with kernel_call("spmm", lambda: _rl.spmm_roofline(n, m, p, ell)):
            if _meta(values):
                return values.new_empty((n, ell),
                                        dtype=_ref.spmm_out_dtype(values.dtype, dense.dtype))
            return _spmm.spmm(values.contiguous(), indices.contiguous(), dense.contiguous())
    return _ref.ref_spmm(values, indices, dense)


def spmm_t(values: torch.Tensor, indices: torch.Tensor, t: torch.Tensor, p: int,
           mode: str = "auto", col_sums: bool = False):
    """Y (p, l) = Wᵀ @ t — scatter sparse rows into the l-dim sketch; with
    ``col_sums``, (Y, Σv, Σv²) per column from the same pass."""
    if _use_kernel("spmm_t", mode, values):
        (n, m), ell = values.shape, t.shape[1]
        with kernel_call("spmm_t", lambda: _rl.spmm_t_roofline(n, m, p, ell, col_sums)):
            if _meta(values):
                y = values.new_empty((p, ell), dtype=_ref.spmm_out_dtype(values.dtype, t.dtype))
                if not col_sums:
                    return y
                return (y, values.new_empty((p,), dtype=torch.float32),
                        values.new_empty((p,), dtype=torch.float32))
            return _spmm.spmm_t(values.contiguous(), indices.contiguous(), t.contiguous(), p,
                                col_sums)
    return _ref.ref_spmm_t(values, indices, t, p, col_sums)
