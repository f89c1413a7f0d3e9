"""The paper's finite-sample bounds (Thms 4, 6, 7; Cors 2, 3, 5; Thm D6).

Carried over from the reference's ``repro.core.bounds``: scalar algebra in
numpy, with the norm helpers taking torch tensors. Used to reproduce Figs. 2,
3, 5 (bound-tightness plots) and by users to size m for a target accuracy.

NOTE on conventions: the paper's data matrix is (p, n) with samples as columns;
this codebase stores (n, p) with samples as rows. The norm helpers below are
named by *meaning*, matched to the paper's symbols:

- ``max_abs``          = ‖X‖_max            (max |entry|)
- ``max_coord_norm``   = ‖X‖_max-row        (max over coordinates of ℓ2 across samples)
- ``max_sample_norm``  = ‖X‖_max-col        (max ℓ2 norm of a sample)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.ros import ETA


# --------------------------------------------------------- norm helpers -----

def max_abs(x: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.abs(x))


def max_coord_norm(x: torch.Tensor) -> torch.Tensor:
    """Paper's ‖X‖_max-row: x is (n, p), norm taken down each column."""
    return torch.max(torch.linalg.vector_norm(x, dim=0))


def max_sample_norm(x: torch.Tensor) -> torch.Tensor:
    """Paper's ‖X‖_max-col: max ℓ2 norm over samples (rows here)."""
    return torch.max(torch.linalg.vector_norm(x, dim=1))


def max_fourth_moment(x: torch.Tensor) -> torch.Tensor:
    """max_j Σ_i X_{j,i}^4 of Eq. (26) — per-coordinate quartic sum."""
    return torch.max(torch.sum(x.to(torch.float32) ** 4, dim=0))


def tau(m: int, p: int) -> float:
    """Eq. (9)."""
    return max(p / m - 1.0, 1.0)


# --------------------------------------------------------------- Thm 4 ------

def mean_failure_prob(t: float, n: int, m: int, p: int, x_max: float, x_maxrow: float) -> float:
    """δ₁ of Eq. (10): P{‖x̄̂ − x̄‖∞ > t} ≤ δ₁."""
    num = -n * t**2 / 2.0
    den = (p / m - 1.0) * x_maxrow**2 / n + tau(m, p) * x_max * t / 3.0
    return float(2 * p * np.exp(num / den))


def mean_error_bound(delta1: float, n: int, m: int, p: int, x_max: float, x_maxrow: float) -> float:
    """t(δ₁) of Eq. (16) — the ℓ∞ error bound at failure probability δ₁."""
    L = np.log(2 * p / delta1)
    a = tau(m, p) / 3.0 * x_max * L
    return float((a + np.sqrt(a**2 + 2.0 * (p / m - 1.0) * L * x_maxrow**2)) / n)


# --------------------------------------------------------------- Cor 2/3 ----

def ros_max_entry_bound(n: int, p: int, alpha: float, transform: str = "hadamard") -> float:
    """Cor. 2 Eq. (3): w.p. ≥ 1−α, ‖Y‖_max ≤ this (for unit-norm samples)."""
    eta = ETA[transform]
    return float(np.sqrt(2.0 / eta * np.log(2 * n * p / alpha)) / np.sqrt(p))


def ros_max_coord_norm_bound(n: int, p: int, alpha: float, transform: str = "hadamard") -> float:
    """Cor. 2 Eq. (4) (for unit-norm samples)."""
    eta = ETA[transform]
    return float(np.sqrt(n / p) * np.sqrt(2.0 / eta * np.log(2 * n * p / alpha)))


def rho_bound(n: int, p: int, m: int, alpha: float = 0.01, transform: str = "hadamard") -> float:
    """Cor. 3 Eq. (7): w.p. ≥ 1−α, ‖w_i‖² ≤ ρ‖x_i‖² with ρ = (m/p)(2/η)log(2np/α).

    Clipped at 1 since ρ ≤ 1 always holds deterministically.
    """
    eta = ETA[transform]
    return float(min(1.0, m / p * 2.0 / eta * np.log(2 * n * p / alpha)))


def cor5_min_m(n: int, p: int, t: float, transform: str = "hadamard") -> float:
    """Eq. (18): m needed for δ₁ ≤ 0.001 after preconditioning (γ ≤ 0.5)."""
    eta = ETA[transform]
    return float(
        1.0 / n * 4.0 / eta * np.log(200 * n * p) * np.log(2000 * p) * (t**-2 + np.sqrt(p) / (3.0 * t))
    )


# --------------------------------------------------------------- Thm 6 ------

@dataclasses.dataclass(frozen=True)
class CovBoundTerms:
    """L (25) and σ² (26) for the matrix-Bernstein covariance bound."""

    L: float
    sigma_sq: float
    p: int

    def failure_prob(self, t: float) -> float:
        """δ₂ of Eq. (24)."""
        return float(self.p * np.exp(-(t**2) / 2.0 / (self.sigma_sq + self.L * t / 3.0)))

    def error_bound(self, delta2: float) -> float:
        """t(δ₂) — spectral-norm error bound at failure probability δ₂."""
        lg = np.log(self.p / delta2)
        a = self.L / 3.0 * lg
        return float(a + np.sqrt(a**2 + 2.0 * self.sigma_sq * lg))


def cov_bound_terms(
    n: int,
    m: int,
    p: int,
    rho: float,
    x_max: float,
    x_maxcol: float,
    x_fro_sq: float,
    cov_norm: float,
    diag_cov_norm: float,
    max_fourth: float,
) -> CovBoundTerms:
    """Compute L (25) and the σ² upper bound (26) from data statistics."""
    c1 = p * (p - 1.0) / (m * (m - 1.0))
    L = (c1 * rho + 1.0) * x_maxcol**2 + p * (p - m) / (m * (m - 1.0)) * x_max**2
    L /= n
    sigma_sq = (
        (c1 * rho - 1.0) * x_maxcol**2 * cov_norm
        + p * (p - 1.0) * (p - m) / (m * (m - 1.0) ** 2) * rho * x_maxcol**2 * diag_cov_norm
        + 2.0 * p * (p - 1.0) * (p - m) / (m * (m - 1.0) ** 2) * x_max**2 * x_fro_sq / n
        + p * (p - m) ** 2 / (m * (m - 1.0) ** 2) * max_fourth / n
    ) / n
    return CovBoundTerms(L=float(L), sigma_sq=float(sigma_sq), p=p)


def cov_bound_from_data(x: torch.Tensor, m: int, rho: float | None = None, alpha: float = 0.01,
                        transform: str = "hadamard", preconditioned: bool = True) -> CovBoundTerms:
    """Convenience: measure the data statistics of (n, p) ``x`` and build the bound."""
    from repro_torch.core.estimators import empirical_cov

    n, p = x.shape
    if rho is None:
        rho = rho_bound(n, p, m, alpha, transform) if preconditioned else 1.0
    c = empirical_cov(x)
    return cov_bound_terms(
        n=n,
        m=m,
        p=p,
        rho=rho,
        x_max=float(max_abs(x)),
        x_maxcol=float(max_sample_norm(x)),
        x_fro_sq=float(torch.sum(x.to(torch.float32) ** 2)),
        cov_norm=float(torch.linalg.matrix_norm(c, ord=2)),
        diag_cov_norm=float(torch.max(torch.abs(torch.diagonal(c)))),
        max_fourth=float(max_fourth_moment(x)),
    )


# --------------------------------------------------------------- Thm 7 ------

def hk_failure_prob(t: float, n_k: int, m: int, p: int) -> float:
    """δ₃ of Eq. (43): P{‖H_k − I‖₂ > t} ≤ δ₃."""
    num = -n_k * t**2 / 2.0
    den = (p / m - 1.0) + (p / m + 1.0) * t / 3.0
    return float(p * np.exp(num / den))


def hk_error_bound(delta3: float, n_k: int, m: int, p: int) -> float:
    """t(δ₃) for Thm 7 — inverts Eq. (43)."""
    lg = np.log(p / delta3)
    a = (p / m + 1.0) * lg / (3.0 * n_k)
    return float(a + np.sqrt(a**2 + 2.0 * (p / m - 1.0) * lg / n_k))


# --------------------------------------------------------------- Thm D6 -----

def distance_preservation_min_m(beta: float, p: int) -> float:
    """Thm D6 sampling budget: m ≥ 4(√β + √(8 log(βp)))² log β keeps pairwise
    distances within [0.40, 1.48] w.p. ≥ 1 − 3/β."""
    return float(4.0 * (np.sqrt(beta) + np.sqrt(8.0 * np.log(beta * p))) ** 2 * np.log(beta))
