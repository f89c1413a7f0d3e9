"""Element-wise uniform sampling without replacement (the R_i R_iᵀ step).

Each sample keeps exactly ``m`` of ``p`` coordinates, chosen uniformly at random
without replacement, with an independent draw per sample. Sparse rows are a
compact pair ``(values (n, m), indices (n, m))``, indices sorted ascending.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils.prng import uniform

# uniforms drawn and sorted at a time by sample_indices: 2^25 float32 draws,
# ≈ 1 GiB of temporaries with the sort's values and int64 indices
SAMPLE_BLOCK = 1 << 25


@dataclasses.dataclass(frozen=True)
class SparseRows:
    """Exactly-m-sparse rows of an (n, p) matrix in compact form.

    values:  (n, m) — the kept entries.
    indices: (n, m) int32 — their column positions, sorted ascending per row.
    p:       full dimensionality.
    """

    values: torch.Tensor
    indices: torch.Tensor
    p: int

    @property
    def n(self) -> int:
        return self.values.shape[0]

    @property
    def m(self) -> int:
        return self.values.shape[1]

    def to_dense(self) -> torch.Tensor:
        """Dense (n, p) with zeros at unsampled coordinates: R_i R_iᵀ y_i."""
        out = torch.zeros((self.n, self.p), dtype=self.values.dtype,
                          device=self.values.device)
        # indices are distinct per row, so a plain scatter equals the add
        return out.scatter_(1, self.indices.long(), self.values)


def sample_indices(key, n: int, p: int, m: int, device="cpu", row0: int = 0,
                   total_rows: int | None = None) -> torch.Tensor:
    """(n, m) int32 — m distinct columns per row, uniform without replacement.

    With ``row0`` and ``total_rows`` the rows are rows ``[row0, row0 + n)``
    of the draw of ``total_rows`` rows under ``key``, bit for bit (a rank's
    range of a gradient's chunks).

    The reference takes ``lax.top_k`` of threefry uniforms, which puts the
    lower index first among equal values; a stable descending sort does the
    same (``torch.topk`` leaves the order of ties undefined).

    Rows are drawn and sorted ``max(1, SAMPLE_BLOCK // p)`` at a time, so a
    call holds O(SAMPLE_BLOCK) temporaries whatever n is. Rows ``[r0, r1)``
    are the flat range ``[r0·p, r1·p)`` of the one (n, p) draw, in either
    threefry layout (``prng.uniform``'s ``offset`` and ``total``), so the
    blocks give the one-call result bit for bit.
    """
    if not (0 < m <= p):
        raise ValueError(f"need 0 < m <= p, got m={m}, p={p}")
    total = n if total_rows is None else total_rows
    if row0 < 0 or row0 + n > total:
        raise ValueError(f"rows [{row0}, {row0 + n}) are not rows of a draw of {total}")
    out = torch.empty((n, m), dtype=torch.int32, device=device)
    rows = max(1, SAMPLE_BLOCK // p)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        u = uniform(key, (r1 - r0, p), device=device, offset=(row0 + r0) * p, total=total * p)
        order = torch.sort(u, dim=-1, descending=True, stable=True).indices[:, :m]
        del u
        out[r0:r1] = torch.sort(order.to(torch.int32), dim=-1).values
    return out


def subsample(y: torch.Tensor, key, m: int) -> SparseRows:
    """Keep m of p entries of each row of ``y`` (n, p), independent per row."""
    n, p = y.shape
    idx = sample_indices(key, n, p, m, device=y.device)
    return SparseRows(torch.gather(y, 1, idx.long()), idx, p)


def scatter_to_dense(values: torch.Tensor, indices: torch.Tensor, p: int) -> torch.Tensor:
    """Functional form of SparseRows.to_dense for raw (values, indices)."""
    return SparseRows(values, indices, p).to_dense()


def counts_per_coordinate(indices: torch.Tensor, p: int, dtype=torch.int32) -> torch.Tensor:
    """(p,) — how many rows sampled each coordinate (the n_k^{(j)} of Eq. 39).

    Counted exactly in integers, then cast to ``dtype``.
    """
    counts = torch.bincount(indices.reshape(-1).long(), minlength=p)
    return counts.to(dtype)


def row_sampled_gather(dense_vecs: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """R_iᵀ v for a batch: gather ``dense_vecs`` (n, p) or (p,) at (n, m) indices."""
    idx = indices.long()
    if dense_vecs.ndim == 1:
        return dense_vecs[idx]
    return torch.gather(dense_vecs, 1, idx)
