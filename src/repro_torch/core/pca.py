"""Sparsified PCA (paper §V application): principal components from sketched data.

The unbiased covariance estimator Ĉ_n is formed in the preconditioned domain;
its eigenvectors are unmixed by (HD)ᵀ to give components in the original domain
(HD is orthonormal, so eigenvalues are unchanged — §VI-A).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import estimators, sketch
from repro_torch.core.sampling import SparseRows


@dataclasses.dataclass(frozen=True)
class PCAResult:
    components: torch.Tensor     # (k, p) — rows are principal components, original domain
    eigenvalues: torch.Tensor    # (k,)  — descending
    mean: torch.Tensor | None    # (p,)  — unbiased mean estimate (original domain)


def _top_eig(c: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    evals, evecs = torch.linalg.eigh(c)              # ascending
    order = torch.argsort(evals, descending=True)[:k]
    return evecs[:, order].T.contiguous(), evals[order]


def pca(x: torch.Tensor, k: int) -> PCAResult:
    """Reference dense PCA of (1/n)·XᵀX, rows=samples (uncentered, as the paper)."""
    comps, evals = _top_eig(estimators.empirical_cov(x), k)
    return PCAResult(comps, evals, estimators.empirical_mean(x))


def sparsified_pca(s: SparseRows, spec: sketch.SketchSpec, k: int,
                   preconditioned: bool = True) -> PCAResult:
    """PCA from a one-pass sketch. ``s`` lives in the preconditioned domain."""
    c_hat = estimators.cov_estimator(s, path="dense")
    comps_pre, evals = _top_eig(c_hat, k)
    mean_pre = estimators.mean_estimator(s)
    if preconditioned:
        comps = sketch.unmix_dense(comps_pre, spec)
        mean = sketch.unmix_dense(mean_pre[None, :], spec)[0]
    else:
        comps, mean = comps_pre[:, : spec.p], mean_pre[: spec.p]
    return PCAResult(comps, evals, mean)


def pca_from_stream(state: estimators.StreamState, spec: sketch.SketchSpec, k: int) -> PCAResult:
    """Finalize streaming accumulators into PCs (constant memory, single pass)."""
    c_hat = estimators.stream_finalize_cov(state, spec.m)
    comps_pre, evals = _top_eig(c_hat, k)
    mean_pre = estimators.stream_finalize_mean(state, spec.m)
    comps = sketch.unmix_dense(comps_pre, spec)
    mean = sketch.unmix_dense(mean_pre[None, :], spec)[0]
    return PCAResult(comps, evals, mean)


def explained_variance(components: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Fraction tr(Uᵀ XᵀX U)/tr(XᵀX) (Fig. 1 metric). ``components``: (k, p)."""
    x = x.to(torch.float32)
    proj = x @ components.to(torch.float32).T      # (n, k)
    return torch.sum(proj**2) / torch.sum(x**2)
