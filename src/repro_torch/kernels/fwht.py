"""K2: y = H·(d ⊙ x), or d ⊙ (H·x), for p ≤ 2^15 — the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro.kernels.fwht.hd_precondition``. The kernel
(``csrc/hadamard.cu``) holds one row per block in shared memory, which caps p
at 2^15. The reference's chunked three-pass schedule for larger p (K3,
``hd_precondition_chunked``) is not ported yet.

On a CPU tensor the wrapper computes the plain version (``kernels.ref``); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

MAX_P_SINGLE = 1 << 15


def scale_for(p: int) -> float:
    """The 1/√p normalization, rounded to float32 as the reference rounds it."""
    return float(np.float32(1.0 / np.sqrt(p)))


def check_p(p: int) -> int:
    """log2(p) for a power of two the single-row kernels take; raises above 2^15."""
    if p < 1 or p & (p - 1):
        raise ValueError(f"the Hadamard kernels need a power-of-two length, got {p}")
    if p > MAX_P_SINGLE:
        raise ValueError(
            f"p_pad={p} exceeds the single-row Hadamard kernels' ceiling "
            f"{MAX_P_SINGLE}; the chunked transform for larger p (K3, "
            "repro.kernels.fwht.hd_precondition_chunked) is not ported yet")
    return p.bit_length() - 1


def hd_precondition(x: torch.Tensor, signs: torch.Tensor,
                    signs_after: bool = False) -> torch.Tensor:
    """(n, p) → (n, p): H·(signs ⊙ x), or signs ⊙ (H·x) with ``signs_after``."""
    if x.device.type == "cpu":
        return _ref.ref_hd_precondition(x, signs, signs_after)
    _build.require(x, torch.float32, 2, "x")
    _build.require(signs, torch.float32, 1, "signs", device=x.device)
    n, p = x.shape
    if signs.shape[0] != p:
        raise ValueError(f"signs has length {signs.shape[0]}, rows have {p}")
    log_p = check_p(p)
    out = torch.empty_like(x)
    if n:
        lib = _build.library("hadamard")
        with torch.cuda.device(x.device):
            err = lib.hd_precondition_f32(x.data_ptr(), signs.data_ptr(), out.data_ptr(),
                                          n, log_p, int(signs_after), scale_for(p),
                                          _build.stream_of(x))
        _build.check(err, "hd_precondition")
        hd_precondition.launches += 1
    return out


hd_precondition.launches = 0
