"""K1: values (n, m) = (H·(d ⊙ x))[i, idx[i]] in one pass — the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro.kernels.sketch_fused.sketch_fused``: the
preconditioned row stays in shared memory and only the m kept values are
written (``csrc/hadamard.cu``, the same kernel as K2 in its gather mode).

On a CPU tensor the wrapper computes the plain version (``kernels.ref``); on a
CUDA tensor it launches the kernel or raises — above p = 2^15 it raises
(``kernels.ops.sketch_fused`` composes K3 and a gather there).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.fwht import check_p, scale_for


def sketch_fused(x: torch.Tensor, signs: torch.Tensor,
                 indices: torch.Tensor) -> torch.Tensor:
    """x (n, p) f32, p a power of two ≤ 2^15; signs (p,); indices (n, m) int32,
    each in [0, p) (sorted and distinct, as ``sample_indices`` gives them)."""
    if x.device.type == "cpu":
        return _ref.ref_sketch_fused(x, signs, indices)
    _build.require(x, torch.float32, 2, "x")
    _build.require(signs, torch.float32, 1, "signs", device=x.device)
    _build.require(indices, torch.int32, 2, "indices", device=x.device)
    n, p = x.shape
    m = indices.shape[1]
    if signs.shape[0] != p or indices.shape[0] != n:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, signs "
                         f"{tuple(signs.shape)}, indices {tuple(indices.shape)}")
    log_p = check_p(p)
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if n and m:
        lib = _build.library("hadamard")
        with torch.cuda.device(x.device):
            err = lib.sketch_fused_f32(x.data_ptr(), signs.data_ptr(), indices.data_ptr(),
                                       out.data_ptr(), n, log_p, m, scale_for(p),
                                       _build.stream_of(x))
        _build.check(err, "sketch_fused")
        sketch_fused.launches += 1
    return out


sketch_fused.launches = 0
