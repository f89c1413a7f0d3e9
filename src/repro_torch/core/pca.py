"""Sparsified PCA (paper §V application): principal components from sketched data.

The unbiased covariance estimator Ĉ_n is formed in the preconditioned domain;
its eigenvectors are unmixed by (HD)ᵀ to give components in the original domain
(HD is orthonormal, so eigenvalues are unchanged — §VI-A).
"""
from __future__ import annotations

import dataclasses

import numpy as np
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


def recovered_components(est, true, thresh: float = 0.95) -> int:
    """Table-I metric: #true components recovered under a greedy ONE-TO-ONE match.

    Pairs the globally largest |⟨û_i, u_j⟩| first, then removes both û_i and
    u_j from contention and repeats — so one estimated component can never be
    credited for several true ones (a per-true-component ``max`` over the Gram
    matrix would double-count exactly that way and inflate the metric).
    ``est`` (ke, p) and ``true`` (kt, p): tensors on any device or arrays;
    the match runs in float32 numpy on the host.
    """
    def f32(a):
        return torch.as_tensor(a).detach().to("cpu", torch.float32).numpy()

    g = np.abs(f32(est) @ f32(true).T)                  # (ke, kt)
    recovered = 0
    for _ in range(min(g.shape)):
        i, j = np.unravel_index(np.argmax(g), g.shape)
        if g[i, j] <= thresh:
            break
        recovered += 1
        g[i, :] = -1.0  # û_i is spent …
        g[:, j] = -1.0  # … and u_j is matched
    return recovered
