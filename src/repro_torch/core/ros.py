"""Randomized orthonormal system (ROS) preconditioning: x -> y = H D x  (paper Eq. 1).

``H`` is a fast orthonormal transform (normalized Walsh-Hadamard or orthonormal
DCT-II) and ``D`` a random ±1 diagonal. ``HD`` is orthonormal, so the adjoint
``D Hᵀ`` exactly unmixes. Rows are samples: ``X`` has shape ``(n, p)``.

Hadamard requires p a power of two; :func:`pad_len` gives the padded length and
:func:`precondition` zero-pads internally.

The Hadamard transform of a CUDA tensor runs the hand-written kernel
(``repro_torch.kernels.fwht``); this module holds the plain butterfly, which is
the kernel's oracle and the CPU path.
"""
from __future__ import annotations

import math
from typing import Literal

import numpy as np
import torch

from repro_torch.utils.prng import rademacher

Transform = Literal["hadamard", "dct"]

IMPLS = ("auto", "kernel", "ref")

# the incoherence constant η of each transform (Cor. 2: ‖HDx‖∞ ≤ √(2/η·log(2np/α)/p))
ETA = {"hadamard": 1.0, "dct": 0.5}


def pad_len(p: int, transform: Transform = "hadamard") -> int:
    """Length after padding: next power of two for Hadamard, identity for DCT."""
    if transform == "dct":
        return p
    return 1 << max(0, (p - 1).bit_length())


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Normalized fast Walsh-Hadamard transform along the last axis.

    Radix-2 butterfly with strides h = 1, 2, …, p/2 in that order, then the
    1/√p scale — the reference's order, so the kernel can match it bit for bit.
    """
    p = x.shape[-1]
    if p & (p - 1):
        raise ValueError(f"FWHT needs a power-of-two length, got {p}")
    orig_shape = x.shape
    x = x.reshape(-1, p)
    h = 1
    while h < p:
        x = x.reshape(-1, p // (2 * h), 2, h)
        a = x[:, :, 0, :]
        b = x[:, :, 1, :]
        x = torch.stack([a + b, a - b], dim=2)
        h *= 2
    x = x.reshape(orig_shape)
    return x * float(np.float32(1.0 / np.sqrt(p)))


def _dct_scale(p: int, device) -> torch.Tensor:
    scale = torch.full((p,), math.sqrt(1.0 / (2 * p)), dtype=torch.float32, device=device)
    scale[0] = math.sqrt(1.0 / (4 * p))
    return scale


def _dct_ii_ortho(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-II along the last axis via one length-p FFT (Makhoul)."""
    p = x.shape[-1]
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1)
    V = torch.fft.fft(v.to(torch.float32), dim=-1)
    k = torch.arange(p, device=x.device, dtype=torch.float32)
    phase = torch.exp(-1j * (math.pi * k / (2 * p)))
    y = 2.0 * torch.real(phase * V)
    return (y * _dct_scale(p, x.device)).to(x.dtype)


def _dct_iii_ortho(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-III (inverse of the orthonormal DCT-II) along the last axis."""
    p = x.shape[-1]
    k = torch.arange(p, device=x.device, dtype=torch.float32)
    Y = x.to(torch.float32) / (2.0 * _dct_scale(p, x.device))
    im = -torch.cat([torch.zeros_like(Y[..., :1]), Y[..., 1:].flip(-1)], dim=-1)
    V = torch.exp(1j * (math.pi * k / (2 * p))) * torch.complex(Y, im)
    v = torch.real(torch.fft.ifft(V, dim=-1))
    out = torch.empty_like(v)
    half = (p + 1) // 2
    out[..., ::2] = v[..., :half]
    out[..., 1::2] = v[..., half:].flip(-1)
    return out.to(x.dtype)


def apply_h(x: torch.Tensor, transform: Transform = "hadamard",
            adjoint: bool = False) -> torch.Tensor:
    """Apply the deterministic orthonormal H (or Hᵀ) along the last axis."""
    if transform == "hadamard":
        return fwht(x)  # symmetric & self-inverse
    if adjoint:
        return _dct_iii_ortho(x)
    return _dct_ii_ortho(x)


def signs_for(key, p_padded: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """The diagonal of D — derived deterministically from ``key``."""
    return rademacher(key, (p_padded,), dtype=dtype, device=device)


def resolve_impl(impl: str, device) -> str:
    """"auto" → the kernel for a CUDA tensor (and for a meta one, whose
    count stands for the card's), the plain version for a CPU one."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "kernel" if torch.device(device).type in ("cuda", "meta") else "ref"
    return impl


def _plain_h(x: torch.Tensor, d: torch.Tensor, signs_after: bool) -> torch.Tensor:
    """The plain Hadamard pass H·(d ⊙ x) (or d ⊙ (H·x)): K2/K3's function,
    which ``roofline.counter.OpCounter`` counts once by its model, as it
    counts the kernel."""
    from repro_torch.roofline import kernels as rl  # deferred: it imports the kernels
    from repro_torch.roofline.counter import kernel_call

    pp = x.shape[-1]
    with kernel_call("hd_precondition", lambda: rl.fwht_roofline(x.numel() // pp, pp)):
        return fwht(x) * d if signs_after else fwht(x * d)


def _pad_to(x: torch.Tensor, pp: int) -> torch.Tensor:
    if x.shape[-1] < pp:
        x = torch.nn.functional.pad(x, (0, pp - x.shape[-1]))
    return x


def precondition(x: torch.Tensor, key, transform: Transform = "hadamard",
                 p_orig: int | None = None, impl: str = "auto") -> torch.Tensor:
    """y = H D x along the last axis, zero-padding to the transform length.

    ``x``: (..., p). Returns (..., p_pad). Hadamard with the kernel impl runs
    ``kernels.ops.hd_precondition``; DCT always takes the FFT path.
    """
    p = p_orig if p_orig is not None else x.shape[-1]
    pp = pad_len(p, transform)
    x = _pad_to(x, pp)
    d = signs_for(key, pp, dtype=x.dtype, device=x.device)
    if resolve_impl(impl, x.device) == "kernel" and transform == "hadamard":
        from repro_torch.kernels import ops  # deferred: kernels import this module

        lead = x.shape[:-1]
        return ops.hd_precondition(x.reshape(-1, pp), d).reshape(*lead, pp)
    if transform == "hadamard":
        return _plain_h(x, d, signs_after=False)
    return apply_h(x * d, transform)


def unmix(y: torch.Tensor, key, transform: Transform = "hadamard",
          p_orig: int | None = None, impl: str = "auto") -> torch.Tensor:
    """x = D Hᵀ y — exact inverse of :func:`precondition` (drops any padding).

    Hadamard is its own inverse, so the kernel impl runs the same transform
    kernel with the signs applied after it.
    """
    pp = y.shape[-1]
    d = signs_for(key, pp, dtype=y.dtype, device=y.device)
    if resolve_impl(impl, y.device) == "kernel" and transform == "hadamard":
        from repro_torch.kernels import ops

        lead = y.shape[:-1]
        x = ops.hd_precondition(y.reshape(-1, pp), d, signs_after=True).reshape(*lead, pp)
    elif transform == "hadamard":
        x = _plain_h(y, d, signs_after=True)
    else:
        x = apply_h(y, transform, adjoint=True) * d
    if p_orig is not None and p_orig < pp:
        x = x[..., :p_orig]
    return x


def hadamard_matrix(p: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Dense normalized Hadamard matrix (tests / small-p fallback only)."""
    if p & (p - 1):
        raise ValueError(f"p must be a power of two, got {p}")
    h = np.array([[1.0]])
    while h.shape[0] < p:
        h = np.block([[h, h], [h, -h]])
    return torch.as_tensor(h / np.sqrt(p), dtype=dtype, device=device)
