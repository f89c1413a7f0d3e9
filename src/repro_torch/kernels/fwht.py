"""K2 and K3: y = H·(d ⊙ x), or d ⊙ (H·x) — the CUDA kernels' wrappers.

Replace the TPU kernels ``repro.kernels.fwht.hd_precondition`` (K2, one row
in one tile, p ≤ 2^15) and ``hd_precondition_chunked`` (K3, 2^15 < p ≤ 2^27).
Both kernels are in ``csrc/hadamard.cu``: K2 holds one row per block in
shared memory, which caps p at 2^15; K3 transforms each 2^15-value chunk of a
row that way, then runs the remaining butterfly stages in register passes over
device memory. :func:`hd_precondition` takes any p up to 2^27 and picks the
kernel, as the reference's does.

On a CPU tensor the wrappers compute the plain version (``kernels.ref``); on a
CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

MAX_P_SINGLE = 1 << 15
# largest p overall, the reference's limit for its chunked schedule
MAX_P = 1 << 27


def scale_for(p: int) -> float:
    """The 1/√p normalization, rounded to float32 as the reference rounds it."""
    return float(np.float32(1.0 / np.sqrt(p)))


def check_p(p: int, ceiling: int = MAX_P_SINGLE) -> int:
    """log2(p) for a power of two up to ``ceiling`` (the single-row kernels'
    2^15 by default); raises otherwise."""
    if p < 1 or p & (p - 1):
        raise ValueError(f"the Hadamard kernels need a power-of-two length, got {p}")
    if p > ceiling:
        beyond = ("; larger p takes the chunked transform (K3, hd_precondition_chunked)"
                  if ceiling == MAX_P_SINGLE else "")
        raise ValueError(f"p_pad={p} exceeds the Hadamard kernels' ceiling {ceiling}{beyond}")
    return p.bit_length() - 1


def _check(x: torch.Tensor, signs: torch.Tensor) -> None:
    _build.require(x, torch.float32, 2, "x")
    _build.require(signs, torch.float32, 1, "signs", device=x.device)
    if signs.shape[0] != x.shape[1]:
        raise ValueError(f"signs has length {signs.shape[0]}, rows have {x.shape[1]}")


def hd_precondition(x: torch.Tensor, signs: torch.Tensor,
                    signs_after: bool = False) -> torch.Tensor:
    """(n, p) → (n, p): H·(signs ⊙ x), or signs ⊙ (H·x) with ``signs_after``.

    K2 up to p = 2^15, K3 above it, up to 2^27.
    """
    if x.shape[-1] > MAX_P_SINGLE:
        return hd_precondition_chunked(x, signs, signs_after)
    if x.device.type == "cpu":
        return _ref.ref_hd_precondition(x, signs, signs_after)
    _check(x, signs)
    n, p = x.shape
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


def hd_precondition_chunked(x: torch.Tensor, signs: torch.Tensor,
                            signs_after: bool = False) -> torch.Tensor:
    """K3: the same transform for 2^15 < p ≤ 2^27, in two or more passes.

    Above 2^27 it raises on any device, as the reference does.
    """
    log_p = check_p(x.shape[-1], MAX_P)
    if x.device.type == "cpu":
        return _ref.ref_hd_precondition(x, signs, signs_after)
    _check(x, signs)
    n, p = x.shape
    if p <= MAX_P_SINGLE:
        raise ValueError(f"the chunked transform takes p > {MAX_P_SINGLE}, got {p}; "
                         "use hd_precondition")
    if n * (p // MAX_P_SINGLE) >= 1 << 31:
        raise ValueError(f"({n}, {p}) has too many 2^15 chunks for one launch; "
                         "split the rows")
    out = torch.empty_like(x)
    if n:
        lib = _build.library("hadamard")
        with torch.cuda.device(x.device):
            err = lib.hd_precondition_chunked_f32(x.data_ptr(), signs.data_ptr(),
                                                  out.data_ptr(), n, log_p, int(signs_after),
                                                  scale_for(p), _build.stream_of(x))
        _build.check(err, "hd_precondition_chunked")
        hd_precondition_chunked.launches += 1
    return out


hd_precondition.launches = 0
hd_precondition_chunked.launches = 0
