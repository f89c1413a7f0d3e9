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
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core.sampling import SparseRows


# ---------------------------------------------------------------- mean ------

def _sum_w(s: SparseRows) -> torch.Tensor:
    acc = torch.zeros((s.p,), dtype=torch.float32, device=s.values.device)
    return acc.index_add_(0, s.indices.reshape(-1).long(),
                          s.values.reshape(-1).to(torch.float32))


def mean_estimator(s: SparseRows) -> torch.Tensor:
    """Unbiased estimate of the sample mean (length p), Thm 4."""
    n, m = s.values.shape
    return _sum_w(s) * (s.p / (m * n))


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


def _scatter_outer(values: torch.Tensor, indices: torch.Tensor, p: int) -> torch.Tensor:
    """Σ_i w_i w_iᵀ via n·m² outer-product scatter-adds (the compact path)."""
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
                 cov_path: Literal["dense", "compact"] = "dense") -> StreamState:
    """One batch's contribution as a StreamState."""
    sum_wwt = None
    if track_cov:
        if cov_path == "compact":
            sum_wwt = _scatter_outer(batch.values, batch.indices, batch.p)
        elif cov_path == "dense":
            w = batch.to_dense().to(torch.float32)
            sum_wwt = w.T @ w
        else:
            raise ValueError(f"cov_path must be 'dense' or 'compact', got {cov_path!r}")
    count = torch.tensor(batch.n, dtype=torch.int32, device=batch.values.device)
    return StreamState(_sum_w(batch), sum_wwt, count)


def stream_apply(state: StreamState, delta: StreamState) -> StreamState:
    """Fold a delta into the accumulator (also sums the deltas of one step)."""
    sum_wwt = None if state.sum_wwt is None else state.sum_wwt + delta.sum_wwt
    return StreamState(state.sum_w + delta.sum_w, sum_wwt, state.count + delta.count)


def stream_update(state: StreamState, batch: SparseRows,
                  cov_path: Literal["dense", "compact"] = "dense") -> StreamState:
    """Fold one sketched batch into the accumulators."""
    return stream_apply(state, stream_delta(batch, track_cov=state.sum_wwt is not None,
                                            cov_path=cov_path))


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
