"""Shared pieces of the low-rank spectral subsystem.

The range-finder accumulator (:mod:`repro_torch.lowrank.range_finder`)
finalizes to a factored object: a rank-l eigenmodel of the Thm-6 unbiased
covariance Ĉ_n, held as (eigenvalues, eigenvector rows) — O(l·p) memory,
never a (p, p) array. PCA consumers slice ``top(k)``; ``dense()`` exists only
for small-p diagnostics and tests.

The debiasing step of Thm 6 (Ĉ_n = Ĉ_emp − corr·diag(Ĉ_emp)) needs diag(S)
where S = Σ w wᵀ; the accumulator carries the exact (p,) diagonal beside its
low-rank factor, and :func:`eig_in_basis` can apply the correction inside the
captured l-dimensional basis.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils import prng


@dataclasses.dataclass(frozen=True)
class LowRankCov:
    """Rank-l factored eigenmodel of Ĉ_n in the preconditioned domain.

    eigenvalues:    (l,) descending.
    components_pre: (l, p) rows are the corresponding eigenvectors.
    """

    eigenvalues: torch.Tensor
    components_pre: torch.Tensor

    @property
    def rank(self) -> int:
        return self.components_pre.shape[0]

    def top(self, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(components_pre (k, p), eigenvalues (k,)) — the PCA consumer's slice."""
        if k > self.rank:
            raise ValueError(f"asked for top-{k} of a rank-{self.rank} model; "
                             "raise Plan.rank")
        return self.components_pre[:k], self.eigenvalues[:k]

    def dense(self) -> torch.Tensor:
        """(p, p) reconstruction V diag(λ) Vᵀ — diagnostics/tests ONLY (this is
        the very allocation the low-rank path exists to avoid)."""
        v = self.components_pre
        return (v.T * self.eigenvalues) @ v

    def nbytes(self) -> int:
        return (self.eigenvalues.numel() * self.eigenvalues.element_size()
                + self.components_pre.numel() * self.components_pre.element_size())


def omega(key, p: int, ell: int, device="cpu") -> torch.Tensor:
    """The fixed (p, l) Gaussian test matrix of the range-finder state.

    Derived from the sketch spec's root key under its own tag, as the
    reference derives it, so every run regenerates the same projection. It is
    drawn on the CPU and then copied to ``device``, so a run on the card and a
    run on the CPU use the same Ω bit for bit (``prng.normal`` states how
    close it is to the reference's).
    """
    return prng.normal(prng.fold_in_str(key, "lowrank-omega"), (p, ell)).to(device)


def eig_in_basis(q: torch.Tensor, core: torch.Tensor, *,
                 scale: torch.Tensor | float = 1.0,
                 diag_s: torch.Tensor | None = None, corr: float = 0.0) -> LowRankCov:
    """Eigendecompose Ĉ_n restricted to an l-dimensional basis.

    q:      (p, l) orthonormal columns spanning the captured range.
    core:   (l, l) ≈ qᵀ S q (S = Σ w wᵀ, any low-rank estimate of it).
    scale:  Thm-6 scale p(p−1)/(m(m−1)) divided by the row count (fold it into
            ``core`` instead and leave 1.0 if the core is already scaled).
    diag_s / corr: the EXACT (p,) diagonal of S and the Thm-6 correction factor
            (p−m)/(p−1), applied in-basis — omit when the operator was already
            debiased before the basis was found (the range-finder path).

    Ĉ_n = scale · (S − corr·diag(diag_s)); in the q basis that is
    scale · (core − corr·qᵀ(diag_s ∘ q)) — an (l, l) symmetric eigenproblem
    whose eigenvectors lift back through q. All O(p·l²) flops, O(p·l) memory.
    """
    t = core
    if diag_s is not None and corr:
        t = t - corr * (q.T @ (diag_s[:, None] * q))
    t = scale * t
    t = 0.5 * (t + t.T)
    evals, evecs = torch.linalg.eigh(t)                      # ascending
    order = torch.argsort(evals, descending=True)
    return LowRankCov(eigenvalues=evals[order], components_pre=(q @ evecs[:, order]).T)
