"""Unbiased estimators recovered from sparsified data (paper §IV–V).

Mean (Thm 4):      x̄̂ = (p/m)·(1/n) Σ_i R_iR_iᵀ x_i
Covariance (Thm 6): Ĉ_emp = p(p−1)/(m(m−1))·(1/n) Σ_i w_i w_iᵀ,
                   Ĉ_n = Ĉ_emp − (p−m)/(p−1)·diag(Ĉ_emp)   (unbiased)

Both have a streaming form (constant-memory accumulators, one pass) and a
batch form. The batch covariance has two computation paths: ``dense`` (scatter
to (n, p), one fp32 product WᵀW) and ``compact`` (scatter the n·m² outer
products, no dense (n, p) intermediate).

Estimates live in the preconditioned domain when the data was sketched with a
ROS.

On the card every sum here repeats bit for bit from run to run, where a float
``index_add_`` would add by atomics, in an order that changes from run to
run: Σw is a column reduction of the dense batch on the dense path and K6's
column walk (``kernels.ops.column_sums``) elsewhere; the compact path sums
its outer products by key (a stable sort and K6's segment walk) where rows
are sparse enough, else as fp32 products of densified row chunks, in chunk
order. The CPU keeps the plain scatter-adds.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core.sampling import SparseRows


# ---------------------------------------------------------------- mean ------

def _sum_w(s: SparseRows, impl: str = "auto") -> torch.Tensor:
    """Σ_i R_iR_iᵀ x_i (p,): K6's column sums on the card (``impl`` "ref"
    takes the plain scatter-add there too), the scatter-add on the CPU."""
    from repro_torch.kernels import ops  # deferred: kernels import core

    return ops.column_sums(s.values, s.indices, s.p, mode=impl)[0]


def mean_estimator(s: SparseRows, impl: str = "auto") -> torch.Tensor:
    """Unbiased estimate of the sample mean (length p), Thm 4."""
    n, m = s.values.shape
    return _sum_w(s, impl) * (s.p / (m * n))


# ---------------------------------------------------------- covariance ------

def _cov_scale(p: int, m: int) -> float:
    if m < 2:
        raise ValueError("covariance estimator needs m >= 2 (Thm B4, Eq. 50)")
    return (p * (p - 1)) / (m * (m - 1))


def _debias_(c_emp_hat: torch.Tensor, p: int, m: int) -> torch.Tensor:
    """Ĉ_emp − (p−m)/(p−1)·diag(Ĉ_emp), in place on ``c_emp_hat`` (it is a
    fresh (p, p) temporary at every call site, and a copy would cost p² more)."""
    d = c_emp_hat.diagonal()
    d.sub_((p - m) / (p - 1) * d)
    return c_emp_hat


# The compact path on the card. At a fill m/p up to COMPACT_KEYED_FILL the
# n·m(m+1)/2 products of each row's pairs are summed by key, in chunks of at
# most KEYED_CHUNK_TERMS products; above it, chunks of rows of at most
# OUTER_CHUNK_FLOATS dense floats (64 MiB) are multiplied in fp32. The sum by
# key does n·m² work and the products n·p², so the crossover is a fill: on an
# H100 (80GB HBM3, 700 W) at p = 16384 the sum by key took 40.0 ms at
# m/p = 0.0125 and 56.6 at 0.015, the products 43.6 at both
# (repro_torch.launch.time_compact; PERF.md §6).
COMPACT_KEYED_FILL = 0.0125
KEYED_CHUNK_TERMS = 1 << 25
OUTER_CHUNK_FLOATS = 1 << 24


def _scatter_outer(values: torch.Tensor, indices: torch.Tensor, p: int) -> torch.Tensor:
    """Σ_i w_i w_iᵀ without a dense (n, p) intermediate (the compact path):
    on the CPU the n·m² outer products scatter-added; on the card summed by
    key (:func:`_outer_by_keys`) where m ≤ :data:`COMPACT_KEYED_FILL`·p, else
    by chunked products (:func:`_outer_by_products`); each repeats bit for
    bit."""
    if values.device.type != "cuda":
        return _scatter_outer_plain(values, indices, p)
    if values.shape[1] <= COMPACT_KEYED_FILL * p:
        return _outer_by_keys(values, indices, p)
    return _outer_by_products(values, indices, p)


def _outer_by_keys(values: torch.Tensor, indices: torch.Tensor, p: int) -> torch.Tensor:
    """Σ_i w_i w_iᵀ summed by key: for a chunk of rows, each row's products
    v_a·v_b of its pairs j ≤ j', keyed min(a, b)·p + max(a, b), are stably
    sorted by key and summed run by run (``ops.segment_sums``: K6's walk on
    the card, the scatter-add in row order on the CPU, where one chunk gives
    the plain path's bits); each sum goes to (a, b) and (b, a). The chunks'
    sums are added in chunk order."""
    from repro_torch.kernels import ops  # deferred: kernels import core

    n, m = values.shape
    kdt = torch.int32 if p * p < 2**31 else torch.int64
    ja, jb = torch.triu_indices(m, m, device=values.device)
    rows = max(1, KEYED_CHUNK_TERMS // max(ja.shape[0], 1))
    acc = torch.zeros((p * p,), dtype=torch.float32, device=values.device)
    for i in range(0, n, rows):
        v = values[i:i + rows].to(torch.float32)
        ia, ib = indices[i:i + rows, ja].to(kdt), indices[i:i + rows, jb].to(kdt)
        lo, hi = torch.minimum(ia, ib), torch.maximum(ia, ib)
        keys, order = torch.sort((lo * p + hi).reshape(-1), stable=True)
        keys, runs = torch.unique_consecutive(keys, return_counts=True)
        starts = torch.zeros((keys.shape[0] + 1,), dtype=torch.int32, device=values.device)
        starts[1:] = runs.cumsum(0)
        sums = ops.segment_sums((v[:, ja] * v[:, jb]).reshape(-1), order.to(torch.int32), starts)
        keys = keys.long()
        lo, hi = keys // p, keys % p
        acc[keys] += sums          # the keys are distinct: no two adds meet
        off = lo != hi
        acc[hi[off] * p + lo[off]] += sums[off]
    return acc.view(p, p)


def _outer_by_products(values: torch.Tensor, indices: torch.Tensor, p: int) -> torch.Tensor:
    """Σ_i w_i w_iᵀ as fp32 products of densified chunks of rows (at most
    :data:`OUTER_CHUNK_FLOATS` floats each), added in chunk order."""
    n = values.shape[0]
    rows = max(1, OUTER_CHUNK_FLOATS // max(p, 1))
    acc = torch.zeros((p, p), dtype=torch.float32, device=values.device)
    for i in range(0, n, rows):
        w = SparseRows(values[i:i + rows].to(torch.float32), indices[i:i + rows], p).to_dense()
        acc.addmm_(w.T, w)
    return acc


def _scatter_outer_plain(values: torch.Tensor, indices: torch.Tensor, p: int) -> torch.Tensor:
    """The n·m² outer-product scatter-add, as the reference computes it."""
    v = values.to(torch.float32)
    outer = v[:, :, None] * v[:, None, :]                     # (n, m, m)
    idx = indices.long()
    flat = (idx[:, :, None] * p + idx[:, None, :]).reshape(-1)
    acc = torch.zeros((p * p,), dtype=torch.float32, device=values.device)
    return acc.index_add_(0, flat, outer.reshape(-1)).reshape(p, p)


def cov_estimator(s: SparseRows, path: Literal["dense", "compact"] = "dense") -> torch.Tensor:
    """Unbiased estimate Ĉ_n (p×p) of the empirical covariance (1/n)·XᵀX, Thm 6."""
    n, m = s.values.shape
    scale = _cov_scale(s.p, m)
    if path == "dense":
        w = s.to_dense().to(torch.float32)
        c = w.T @ w
    elif path == "compact":
        c = _scatter_outer(s.values, s.indices, s.p)
    else:
        raise ValueError(f"path must be 'dense' or 'compact', got {path!r}")
    return _debias_(c.mul_(scale / n), s.p, m)


# ----------------------------------------------------------- streaming ------

@dataclasses.dataclass(frozen=True)
class StreamState:
    """Constant-memory accumulators for one-pass mean+covariance estimation.

    sum_w:    (p,)   Σ R_iR_iᵀ x_i
    sum_wwt:  (p, p) Σ w_i w_iᵀ       (only if track_cov)
    count:    () int32 — rows so far, exact to 2^31
    """

    sum_w: torch.Tensor
    sum_wwt: torch.Tensor | None
    count: torch.Tensor


def stream_init(p: int, track_cov: bool = True, device="cpu") -> StreamState:
    return StreamState(
        sum_w=torch.zeros((p,), dtype=torch.float32, device=device),
        sum_wwt=(torch.zeros((p, p), dtype=torch.float32, device=device)
                 if track_cov else None),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def stream_delta(batch: SparseRows, track_cov: bool = True,
                 cov_path: Literal["dense", "compact"] = "dense",
                 impl: str = "auto") -> StreamState:
    """One batch's contribution as a StreamState. Σw: on the card's dense path
    the column sums of the dense batch; elsewhere :func:`_sum_w` (``impl``
    "ref" takes the plain scatter-add on the card too)."""
    sum_w = sum_wwt = None
    if track_cov:
        if cov_path == "compact":
            sum_wwt = _scatter_outer(batch.values, batch.indices, batch.p)
        elif cov_path == "dense":
            w = batch.to_dense().to(torch.float32)
            sum_wwt = w.T @ w
            if w.device.type == "cuda" and impl != "ref":
                sum_w = w.sum(0)    # an order-fixed reduction of the batch the product reads
        else:
            raise ValueError(f"cov_path must be 'dense' or 'compact', got {cov_path!r}")
    count = torch.tensor(batch.n, dtype=torch.int32, device=batch.values.device)
    return StreamState(_sum_w(batch, impl) if sum_w is None else sum_w, sum_wwt, count)


def stream_apply(state: StreamState, delta: StreamState) -> StreamState:
    """Fold a delta into the accumulator (also sums the deltas of one step)."""
    sum_wwt = None if state.sum_wwt is None else state.sum_wwt + delta.sum_wwt
    return StreamState(state.sum_w + delta.sum_w, sum_wwt, state.count + delta.count)


def stream_update(state: StreamState, batch: SparseRows,
                  cov_path: Literal["dense", "compact"] = "dense",
                  impl: str = "auto") -> StreamState:
    """Fold one sketched batch into the accumulators."""
    return stream_apply(state, stream_delta(batch, track_cov=state.sum_wwt is not None,
                                            cov_path=cov_path, impl=impl))


def stream_finalize_mean(state: StreamState, m: int) -> torch.Tensor:
    p = state.sum_w.shape[0]
    return state.sum_w * (p / m / state.count)


def stream_finalize_cov(state: StreamState, m: int) -> torch.Tensor:
    p = state.sum_w.shape[0]
    c_emp_hat = _cov_scale(p, m) / state.count * state.sum_wwt
    return _debias_(c_emp_hat, p, m)


# ------------------------------------------------- reference quantities -----

def empirical_mean(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x.to(torch.float32), dim=0)


def empirical_cov(x: torch.Tensor) -> torch.Tensor:
    """(1/n)·XᵀX — the paper's C_emp (uncentered second moment), rows=samples."""
    x = x.to(torch.float32)
    return x.T @ x / x.shape[0]
