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


def ref_cluster_sums(values: torch.Tensor, indices: torch.Tensor, labels: torch.Tensor,
                     k: int, p: int):
    """(sums, counts), each (K, p) float32: over the rows labelled k, the sum
    and the count of the kept values at each coordinate — Lloyd's center
    update on compact rows (paper Eq. 39), the reference's scatter-add in row
    order. ``labels`` (r, n) labels the rows under r hypotheses at once: then
    (r, K, p) each. Oracle for ``kernels.spmm.cluster_sums`` (K6's walk on the
    labels' one-hot columns)."""
    lab = labels.long().reshape(-1, values.shape[0])                 # (r, n)
    r = lab.shape[0]
    lab = lab + torch.arange(r, device=lab.device)[:, None] * k
    flat = (lab[:, :, None] * p + indices.long()[None]).reshape(-1)
    v = values.to(torch.float32)[None].expand(r, -1, -1).reshape(-1)
    sums = torch.zeros(r * k * p, dtype=torch.float32, device=values.device)
    counts = torch.zeros(r * k * p, dtype=torch.float32, device=values.device)
    sums.index_add_(0, flat, v)
    counts.index_add_(0, flat, torch.ones_like(v))
    shape = tuple(labels.shape[:-1]) + (k, p)
    return sums.reshape(shape), counts.reshape(shape)


def ref_column_sums(values: torch.Tensor, indices: torch.Tensor, p: int):
    """(Σv, Σv²) over each column's kept entries, (p,) float32 each: a
    scatter-add in row order (the reference's ``.at[].add``)."""
    flat = indices.reshape(-1).long()
    v = values.to(torch.float32).reshape(-1)
    zeros = torch.zeros((p,), dtype=torch.float32, device=values.device)
    return zeros.index_add(0, flat, v), zeros.index_add(0, flat, v * v)


def ref_segment_sums(values: torch.Tensor, order: torch.Tensor, starts: torch.Tensor):
    """(S,) float32: Σ values[order[k]] over each segment k ∈ [starts[s],
    starts[s + 1]), added in k order — oracle for
    ``kernels.spmm.segment_sums`` (K6's walk over flat positions)."""
    segs = starts.shape[0] - 1
    seg = torch.repeat_interleave(torch.arange(segs, device=values.device),
                                  (starts[1:] - starts[:-1]).long())
    out = torch.zeros((segs,), dtype=torch.float32, device=values.device)
    return out.index_add_(0, seg, values.to(torch.float32)[order.long()])


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
