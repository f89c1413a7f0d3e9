"""Randomized range-finder / co-occurrence accumulator.

The Thm-6 covariance needs S = Σ_i w_i w_iᵀ; this state never forms S, only its
action on a fixed (p, l) Gaussian test matrix Ω (:func:`repro_torch.lowrank.model.omega`):

    y    = S · Ω                    (p, l)   accumulated exactly (linear in batches)
    diag = diag(S) = Σ_i w_i∘w_i    (p,)     exact, for the Thm-6 debias
    sum_w, count                             the Thm-4 mean accumulator

Each batch's delta is Wᵀ(W·Ω) — the two sparse-times-dense kernels K5
``spmm`` and K6 ``spmm_t`` (``kernels.ops``), which never densify the (b, p)
batch. K6 also gives diag and sum_w from the same column walk, so on the card
the whole delta is bit-reproducible (no atomics). The delta is fixed-size and
additive, so it follows the ``init / delta / apply / finalize`` algebra of
``stream.accumulators``.

Finalize (single-pass randomized eigendecomposition, as the reference):

1. **Debias first, then range-find.** Y' = (S − corr·diag(d))·Ω =
   Y − corr·(d ∘ Ω), in closed form from the exact diagonal.
2. **Oversampled, truncated basis.** The basis is the top r = l/2 left
   singular vectors of Y', so Ω oversamples it 2×.
3. **Fat least-squares core.** (QᵀY') ≈ core·(QᵀΩ), solved by pseudo-inverse
   and symmetrized (Halko et al. §5.5).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.estimators import _cov_scale, stream_finalize_mean
from repro_torch.core.sampling import SparseRows
from repro_torch.kernels import ops
from repro_torch.lowrank.model import LowRankCov, eig_in_basis


@dataclasses.dataclass(frozen=True)
class RangeState:
    """Constant-memory low-rank co-occurrence accumulators (all O(p·l)).

    y:     (p, l)  Σ w_i (w_iᵀ Ω) = S·Ω
    diag:  (p,)    Σ w_i ∘ w_i = diag(S)
    sum_w: (p,)    Σ w_i (Thm-4 mean numerator)
    count: ()      rows folded (int32, exact)
    """

    y: torch.Tensor
    diag: torch.Tensor
    sum_w: torch.Tensor
    count: torch.Tensor

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.y, self.diag, self.sum_w, self.count))


def range_init(p: int, ell: int, device="cpu") -> RangeState:
    return RangeState(
        y=torch.zeros((p, ell), dtype=torch.float32, device=device),
        diag=torch.zeros((p,), dtype=torch.float32, device=device),
        sum_w=torch.zeros((p,), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def range_delta(batch: SparseRows, omega_mat: torch.Tensor, impl: str = "auto") -> RangeState:
    """One batch's contribution — local and additive.

    ``impl`` routes the sparse-times-dense products ("auto" = the CUDA kernels
    on a card, their plain versions on the CPU — the ``kernels.ops`` rule).
    """
    values, indices = batch.values, batch.indices
    t = ops.spmm(values, indices, omega_mat, mode=impl)              # (b, l)
    y, sum_w, diag = ops.spmm_t(values, indices, t, batch.p, mode=impl,
                                col_sums=True)                       # (p, l), (p,), (p,)
    count = torch.tensor(values.shape[0], dtype=torch.int32, device=values.device)
    return RangeState(y, diag, sum_w, count)


def range_apply(state: RangeState, delta: RangeState) -> RangeState:
    """Fold a delta into the accumulator (also sums the deltas of one step)."""
    return RangeState(state.y + delta.y, state.diag + delta.diag,
                      state.sum_w + delta.sum_w, state.count + delta.count)


def range_update(state: RangeState, batch: SparseRows, omega_mat: torch.Tensor,
                 impl: str = "auto") -> RangeState:
    return range_apply(state, range_delta(batch, omega_mat, impl))


# the Thm-4 mean formula of core.estimators: RangeState has the (sum_w, count)
# fields it reads
range_finalize_mean = stream_finalize_mean


def range_finalize(state: RangeState, m: int, omega_mat: torch.Tensor,
                   rank: int | None = None) -> LowRankCov:
    """Rank-r eigenmodel of Ĉ_n from (Y, diag, count) alone — O(p·l²) flops.

    Returns ``rank`` (default l/2 — Ω must oversample the basis) eigenpairs of
    the debiased estimator; consumers slice ``top(k)`` with k ≤ rank.
    """
    p, ell = state.y.shape
    if m < 2:
        raise ValueError("covariance estimator needs m >= 2 (Thm B4, Eq. 50)")
    r = max(1, ell // 2) if rank is None else int(rank)
    if not 0 < r <= ell:
        raise ValueError(f"rank must be in [1, l={ell}], got {r}")
    corr = (p - m) / (p - 1)
    # the debiased operator's sketch, scaled by 1/count (an int32 scalar: the
    # division stays in float32)
    yp = (state.y - corr * state.diag[:, None] * omega_mat) / state.count
    u, _, _ = torch.linalg.svd(yp, full_matrices=False)
    q = u[:, :r]                                             # (p, r) basis
    core = (q.T @ yp) @ torch.linalg.pinv(q.T @ omega_mat)   # r×l fat solve
    return eig_in_basis(q, _cov_scale(p, m) * core)
