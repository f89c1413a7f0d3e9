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
    along the last axis — oracle for ``kernels.fwht.hd_precondition`` (K2).

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
