"""The one switch between the port's kernels and their plain versions.

``mode``: "auto" and "kernel" go to the kernel wrapper, which launches the
CUDA kernel for a CUDA tensor and computes the plain version for a CPU tensor;
"ref" asks for the plain version on any device. Every call is tallied in
:data:`DISPATCH` by (op, path), where path is "kernel" when a kernel was
launched.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.core.ros import IMPLS as MODES
from repro_torch.kernels import fwht as _fwht
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sketch_fused as _sf
from repro_torch.kernels import sparse_assign as _sa

DISPATCH: collections.Counter = collections.Counter()

# each kernel's wrapper, which carries its launch count
WRAPPERS = {
    "sketch_fused": _sf.sketch_fused,
    "hd_precondition": _fwht.hd_precondition,
    "sparse_assign": _sa.sparse_assign,
}


def _use_kernel(op: str, mode: str, t: torch.Tensor) -> bool:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    kernel = mode in ("auto", "kernel")
    DISPATCH[(op, "kernel" if kernel and t.device.type == "cuda" else "ref")] += 1
    return kernel


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_counts`, by kernel."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_counts() -> None:
    """Zero every launch counter and the dispatch tally."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    DISPATCH.clear()


def hd_precondition(x: torch.Tensor, signs: torch.Tensor, signs_after: bool = False,
                    mode: str = "auto") -> torch.Tensor:
    """y = H·(d⊙x), or d⊙(H·x) with ``signs_after`` (unmix)."""
    x = x.contiguous()
    if _use_kernel("hd_precondition", mode, x):
        return _fwht.hd_precondition(x, signs, signs_after)
    return _ref.ref_hd_precondition(x, signs, signs_after)


def sketch_fused(x: torch.Tensor, signs: torch.Tensor, indices: torch.Tensor,
                 mode: str = "auto") -> torch.Tensor:
    """values (n, m) = (H·(signs⊙x))[i, indices[i]] — precondition and keep m
    values per row in one pass."""
    x = x.contiguous()
    if _use_kernel("sketch_fused", mode, x):
        return _sf.sketch_fused(x, signs, indices.contiguous())
    return _ref.ref_sketch_fused(x, signs, indices)


def sparse_assign(values: torch.Tensor, indices: torch.Tensor, centers: torch.Tensor,
                  mode: str = "auto"):
    """(dists, argmin) for sparsified K-means assignment; centers (K, p) or
    (r, K, p)."""
    if _use_kernel("sparse_assign", mode, values):
        return _sa.sparse_assign(values.contiguous(), indices.contiguous(),
                                 centers.contiguous())
    return _ref.ref_sparse_assign(values, indices, centers)
