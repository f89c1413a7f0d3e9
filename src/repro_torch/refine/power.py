"""PCA power-iteration refinement over the regenerable source.

The one-pass range-finder's basis is orth of Y' = S'·Ω for a random Ω, so its
subspace leaks tail directions by the one-pass gap ratio. Replaying the
source with Ω replaced by the current basis Q is one power step:

    Y_r = S·Q_{r-1}          (the range-finder's K5/K6 delta, Q in Ω's place)
    Q_r = orth(Y_r − corr·(diag(S) ∘ Q_{r-1}))      (debias, then orthonormalize)

Each pass multiplies the leaked tail by another gap ratio, and the state is
the same O(l·p) :class:`~repro_torch.lowrank.range_finder.RangeState`.
Finalize is the one-pass core solve with Ω → Q_{q-1}.

Q is orthonormalized by ``torch.linalg.svd``, whose column signs need not be
LAPACK's under the reference: compare subspaces, never Q itself.
"""
from __future__ import annotations

import torch

from repro_torch.lowrank.model import LowRankCov
from repro_torch.lowrank.range_finder import RangeState, range_finalize


def debiased_action(state: RangeState, q_prev: torch.Tensor, m: int) -> torch.Tensor:
    """(p, l) — the debiased operator's action S'·Q_prev / count, in closed
    form from the exact diagonal the state carries."""
    p = state.y.shape[0]
    corr = (p - m) / (p - 1)
    return (state.y - corr * state.diag[:, None] * q_prev) / state.count


def power_orth(state: RangeState, q_prev: torch.Tensor, m: int) -> torch.Tensor:
    """The next basis: orth(S'·Q_prev), (p, l) orthonormal, fp32 and
    contiguous (K5/K6 read it as they read Ω). By SVD, so the columns come
    out ordered by singular value."""
    u, _, _ = torch.linalg.svd(debiased_action(state, q_prev, m), full_matrices=False)
    return u.to(torch.float32).contiguous()


def power_finalize(state: RangeState, q_prev: torch.Tensor, m: int,
                   rank: int | None = None) -> LowRankCov:
    """Finalize the last pass's state through the one-pass core solve, with
    Q_prev in Ω's place."""
    return range_finalize(state, m, q_prev, rank=rank)


def subspace_change(q_new: torch.Tensor, q_old: torch.Tensor) -> float:
    """Largest principal-angle sine between two orthonormal bases — the
    per-pass convergence diagnostic.

    Taken as ‖(I − Q_new Q_newᵀ) Q_old‖₂ in float64, which resolves angles
    down to the bases' float32 rounding (≈ 1e-7); the reference's
    √(1 − σ_min²) of Q_newᵀQ_old in float32 stops at ≈ 5e-4, where a
    settled pass reads 0 or that floor.
    """
    a, b = q_new.to(torch.float64), q_old.to(torch.float64)
    return float(torch.linalg.matrix_norm(b - a @ (a.T @ b), ord=2))
