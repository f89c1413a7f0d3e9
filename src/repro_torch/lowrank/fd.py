"""Frequent-Directions accumulator — the deterministic l × p sketch.

Liberty's Frequent Directions keeps an (l, p) matrix B with the guarantee
0 ≼ S − BᵀB ≼ (‖A‖_F² / (l − k)) I for every k < l, where S = Σ_i w_i w_iᵀ.
A batch of compact sparse rows is appended in chunks of at most l rows, each
scattered into an (≤ l, p) block (the (b, p) batch is never densified), and
the stacked (≤ 2l, p) buffer is SVD-shrunk back to l rows
(σ'² = max(σ² − σ²_{l+1}, 0)) by ``torch.linalg.svd``.

The shrink is not additive: FD folds are order-dependent and fold in (step,
shard) order on every backend. The side accumulators diag(S) and Σw are
column sums (``kernels.ops.column_sums``: K6 on the card, repeating bit for
bit; the scatter-add on the CPU). The SVD's signs and rotations of B's rows
differ from LAPACK's under the reference; BᵀB and the finalized eigenpairs do
not.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.estimators import _cov_scale, stream_finalize_mean
from repro_torch.core.sampling import SparseRows
from repro_torch.kernels import ops
from repro_torch.lowrank.model import LowRankCov, eig_in_basis


@dataclasses.dataclass(frozen=True)
class FDState:
    """FD sketch and the exact side accumulators (all O(p·l) or O(p)).

    sketch: (l, p) the current Frequent-Directions matrix B.
    diag:   (p,)   Σ w_i ∘ w_i (exact, for the Thm-6 debias).
    sum_w:  (p,)   Σ w_i (Thm-4 mean numerator).
    count:  ()     rows folded (int32).
    """

    sketch: torch.Tensor
    diag: torch.Tensor
    sum_w: torch.Tensor
    count: torch.Tensor

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.sketch, self.diag, self.sum_w, self.count))


def fd_init(p: int, ell: int, device="cpu") -> FDState:
    return FDState(
        sketch=torch.zeros((ell, p), dtype=torch.float32, device=device),
        diag=torch.zeros((p,), dtype=torch.float32, device=device),
        sum_w=torch.zeros((p,), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _shrink(stacked: torch.Tensor, ell: int) -> torch.Tensor:
    """SVD-shrink a (> l, p) stack back to l rows (the FD overflow step)."""
    _, s, vt = torch.linalg.svd(stacked, full_matrices=False)
    delta = s[ell] ** 2 if s.shape[0] > ell else s.new_zeros(())
    s_shrunk = torch.sqrt(torch.clamp(s[:ell] ** 2 - delta, min=0.0))
    return s_shrunk[:, None] * vt[:ell]


def fd_update(state: FDState, batch: SparseRows, impl: str = "auto") -> FDState:
    """Fold one sketched batch (sequential — the shrink is order-dependent)."""
    values, indices = batch.values, batch.indices
    n = values.shape[0]
    ell, p = state.sketch.shape
    sketch = state.sketch
    for start in range(0, n, ell):
        rows = SparseRows(values[start:start + ell].to(torch.float32),
                          indices[start:start + ell], p).to_dense()
        sketch = _shrink(torch.cat([sketch, rows]), ell)
    sum_w, diag = ops.column_sums(values, indices, p, mode=impl)
    return FDState(sketch=sketch, diag=state.diag + diag, sum_w=state.sum_w + sum_w,
                   count=state.count + n)


# the Thm-4 mean formula of core.estimators: FDState has the (sum_w, count)
# fields it reads
fd_finalize_mean = stream_finalize_mean


def fd_finalize(state: FDState, m: int) -> LowRankCov:
    """Rank-l eigenmodel of Ĉ_n: S ≈ BᵀB = V diag(σ²) Vᵀ, then the Thm-6 scale
    and the in-basis diagonal debias."""
    ell, p = state.sketch.shape
    if m < 2:
        raise ValueError("covariance estimator needs m >= 2 (Thm B4, Eq. 50)")
    _, s, vt = torch.linalg.svd(state.sketch, full_matrices=False)
    return eig_in_basis(vt.T, torch.diag(s ** 2), scale=_cov_scale(p, m) / state.count,
                        diag_s=state.diag, corr=(p - m) / (p - 1))
