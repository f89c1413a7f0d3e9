"""K4: sparsified K-means distances and argmin — the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro.kernels.sparse_assign.sparse_assign``:
``d[i, k] = Σ_j (v_ij − μ_k[idx_ij])²`` and its first-index argmin over k,
for one set of centers (K, p) or r sets (r, K, p) in one launch
(``csrc/sparse_assign.cu``). The kernel reads the centers by coordinate: it
first lays them out as (p, r·K), padded to whole float4s, in a scratch buffer
the wrapper allocates, so that all r·K center values of a kept coordinate
share one cache line.

On a CPU tensor the wrapper computes the plain version (``kernels.ref``); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref


def sparse_assign(values: torch.Tensor, indices: torch.Tensor, centers: torch.Tensor):
    """values (n, m) f32, indices (n, m) int32 in [0, p), centers (K, p) or
    (r, K, p) f32 → (dists (n, K) f32, argmin (n,) int32), with a leading r
    axis on both for batched centers."""
    if values.device.type == "cpu":
        return _ref.ref_sparse_assign(values, indices, centers)
    _build.require(values, torch.float32, 2, "values")
    _build.require(indices, torch.int32, 2, "indices", device=values.device)
    batched = centers.ndim == 3
    c3 = centers if batched else centers.unsqueeze(0)
    _build.require(c3, torch.float32, 3, "centers", device=values.device)
    n, m = values.shape
    r, k, p = c3.shape
    if indices.shape != values.shape:
        raise ValueError(f"indices {tuple(indices.shape)} != values {tuple(values.shape)}")
    if k < 1:
        raise ValueError("need at least one center")
    dists = torch.empty((r, n, k), dtype=torch.float32, device=values.device)
    amin = torch.empty((r, n), dtype=torch.int32, device=values.device)
    if n and r:
        ld = -(-r * k // 4) * 4
        ct = torch.empty((p, ld), dtype=torch.float32, device=values.device)
        lib = _build.library("sparse_assign")
        with _build.on_device(values):
            err = lib.sparse_assign_f32(values.data_ptr(), indices.data_ptr(), c3.data_ptr(),
                                        ct.data_ptr(), dists.data_ptr(), amin.data_ptr(),
                                        n, m, r, k, p, ld, _build.stream_of(values))
        _build.check(err, "sparse_assign")
        sparse_assign.launches += 1
        sparse_assign.by_shape[(r, k, m)] += 1
    if batched:
        return dists, amin
    return dists[0], amin[0]


sparse_assign.launches = 0
# launches by (r, K, m)
sparse_assign.by_shape = collections.Counter()
