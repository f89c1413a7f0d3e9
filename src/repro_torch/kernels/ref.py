"""Plain PyTorch versions of the port's kernels.

Each is the oracle its CUDA kernel is held against on the card, and the path a
wrapper takes for a tensor that lies on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core import ros


def ref_hd_precondition(x: torch.Tensor, signs: torch.Tensor,
                        signs_after: bool = False) -> torch.Tensor:
    """y = H·(d ⊙ x), or d ⊙ (H·x) with ``signs_after`` (the unmix direction),
    along the last axis — oracle for ``kernels.fwht.hd_precondition`` (K2) and
    ``kernels.fwht.hd_precondition_chunked`` (K3): the same butterfly at any p.

    ``x``: (n, p) with p a power of two; ``signs``: (p,) of ±1.
    """
    if signs_after:
        return ros.fwht(x) * signs[None, :]
    return ros.fwht(x * signs[None, :])


def ref_sketch_fused(x: torch.Tensor, signs: torch.Tensor,
                     indices: torch.Tensor) -> torch.Tensor:
    """values (n, m) = (H·(signs⊙x))[i, indices[i]] — oracle for
    ``kernels.sketch_fused`` (K1): the composed precondition → gather."""
    return torch.gather(ref_hd_precondition(x, signs), 1, indices.long())


def ref_sparse_assign(values: torch.Tensor, indices: torch.Tensor,
                      centers: torch.Tensor):
    """Sparsified K-means assignment oracle — ``kernels.sparse_assign`` (K4).

    values (n, m), indices (n, m) int32 (distinct per row), centers (K, p) or
    (r, K, p). Returns (dists, argmin) of ‖z_i − R_iᵀμ_k‖² (paper Eq. 36):
    (n, K) f32 and (n,) int32, or (r, n, K) and (r, n) for batched centers.
    """
    if centers.ndim == 3:
        out = [ref_sparse_assign(values, indices, c) for c in centers]
        return torch.stack([d for d, _ in out]), torch.stack([a for _, a in out])
    g = centers.T[indices.long()]                            # (n, m, K)
    d = torch.sum((values[..., None] - g) ** 2, dim=1)
    return d, torch.argmin(d, dim=1).to(torch.int32)


def spmm_out_dtype(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """The spmm promotion rule: operands promote jointly, and accumulation and
    output are at least float32 (the reference's ``promoted_dtypes``)."""
    return torch.promote_types(torch.promote_types(a, b), torch.float32)


def ref_spmm(values: torch.Tensor, indices: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """T (n, l) = W @ dense — oracle for ``kernels.spmm.spmm`` (K5).

    values/indices (n, m) compact sparse rows over p columns; dense (p, l).
    """
    out = spmm_out_dtype(values.dtype, dense.dtype)
    return torch.einsum("nm,nml->nl", values.to(out), dense.to(out)[indices.long()])


def ref_spmm_t(values: torch.Tensor, indices: torch.Tensor, t: torch.Tensor,
               p: int, col_sums: bool = False):
    """Y (p, l) = Wᵀ @ t — oracle for ``kernels.spmm.spmm_t`` (K6): a
    scatter-add of the rows v_ij·t_i into column idx_ij.

    With ``col_sums``, (Y, Σv, Σv²): each column's sum of its entries and of
    their squares, (p,) float32 (the range-finder's ``sum_w`` and ``diag``).
    """
    out = spmm_out_dtype(values.dtype, t.dtype)
    contrib = values.to(out)[..., None] * t.to(out)[:, None, :]
    flat_idx = indices.reshape(-1).long()
    y = torch.zeros((p, t.shape[1]), dtype=out, device=t.device)
    y.index_add_(0, flat_idx, contrib.reshape(-1, t.shape[1]))
    if not col_sums:
        return y
    v32 = values.to(torch.float32).reshape(-1)
    zeros = torch.zeros((p,), dtype=torch.float32, device=t.device)
    return y, zeros.index_add(0, flat_idx, v32), zeros.index_add(0, flat_idx, v32 * v32)
