"""Sparsified K-means pieces the streaming engine needs (paper §VI).

Shape conventions: data rows = samples; centers (K, p); assignments (n,) int32.
The distances of sparse rows to centers (Eq. 35/36) are the K4 kernel's
function (``kernels.ops.sparse_assign``); :func:`sparse_sq_dists` is the
plain gather form.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.utils import prng


def sparse_sq_dists(values: torch.Tensor, indices: torch.Tensor,
                    centers: torch.Tensor) -> torch.Tensor:
    """(n, K) sparsified distances ‖z_i − R_iᵀ μ_k‖² (Eq. 35), gather form."""
    g = centers.T[indices.long()]                            # (n, m, K)
    return torch.sum((values[..., None] - g) ** 2, dim=1)


def _kpp_init(key, dists_to: Callable[[torch.Tensor], torch.Tensor], n: int, k: int,
              gather_rows: Callable[[torch.Tensor], torch.Tensor], p: int,
              dtype, device) -> torch.Tensor:
    """Greedy K-means++ D²-seeding: ``n_cand`` trial centers per step, keeping
    the one that most reduces the potential (as in sklearn).

    dists_to(C (c, p)) -> (c, n) squared distances of every sample to each
    candidate center; gather_rows(i (c,)) -> (c, p) dense sample rows.
    """
    n_cand = 2 + int(np.ceil(np.log(max(k, 2))))
    k0, key = prng.split(key)
    first = gather_rows(prng.randint(k0, (1,), 0, n, device=device))   # (1, p)
    centers = torch.zeros((k, p), dtype=dtype, device=device)
    centers[0] = first[0]
    min_d = dists_to(first)[0]
    for j in range(1, k):
        key, kc = prng.split(key)
        logits = torch.log(torch.clamp(min_d, min=1e-30))
        idxs = prng.categorical(kc, logits, shape=(n_cand,))
        cands = gather_rows(idxs)                                       # (n_cand, p)
        new_ds = dists_to(cands)                                        # (n_cand, n)
        pots = torch.sum(torch.minimum(min_d[None, :], new_ds), dim=1)
        best = torch.argmin(pots)
        centers[j] = cands[best]
        min_d = torch.minimum(min_d, new_ds[best])
    return centers


def kpp_init_sparse(key, values: torch.Tensor, indices: torch.Tensor, p: int, k: int,
                    impl: str = "auto") -> torch.Tensor:
    """K-means++ under the sparsified metric: candidate centers are scattered
    sparse rows; distances use only each row's sampled coordinates (Eq. 35),
    through the K4 kernel (``impl`` is its dispatch mode)."""
    n, _ = values.shape

    def gather_rows(i):
        out = torch.zeros((i.shape[0], p), dtype=values.dtype, device=values.device)
        return out.scatter_(1, indices[i].long(), values[i])

    def dists_to(c):
        return ops.sparse_assign(values, indices, c, mode=impl)[0].T

    return _kpp_init(key, dists_to, n, k, gather_rows, p, values.dtype, values.device)
