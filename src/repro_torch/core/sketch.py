"""The one-pass sketch: precondition (HD) then subsample (R_i R_iᵀ), fused.

A :class:`SketchSpec` captures everything needed to interpret / unmix a sketch
later (transform type, D's key, original p) so that streaming consumers never
revisit raw data.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import ros
from repro_torch.core.sampling import SparseRows, sample_indices, subsample
from repro_torch.utils import prng


@dataclasses.dataclass(frozen=True)
class SketchSpec:
    """Static + key state describing a sketch stream.

    ``key`` is threefry key data, numpy uint32[2] (``jax.random.key_data`` of
    the reference's key).
    """

    p: int                      # original dimensionality
    m: int                      # kept coordinates per sample
    transform: ros.Transform = "hadamard"
    key: np.ndarray | None = None  # root key; D uses fold("signs"), R_i use fold("mask")

    @property
    def p_pad(self) -> int:
        return ros.pad_len(self.p, self.transform)

    @property
    def gamma(self) -> float:
        """The keep fraction γ = m / p_pad (sampling happens after padding)."""
        return self.m / self.p_pad

    def signs_key(self) -> np.ndarray:
        return prng.fold_in_str(self.key, "ros-signs")

    def mask_key(self) -> np.ndarray:
        return prng.fold_in_str(self.key, "sample-mask")


def make_spec(p: int, key, gamma: float | None = None, m: int | None = None,
              transform: ros.Transform = "hadamard") -> SketchSpec:
    pp = ros.pad_len(p, transform)
    if m is None:
        if gamma is None:
            raise ValueError("provide gamma or m")
        if not 0.0 < gamma <= 1.0:
            raise ValueError(f"gamma must be in (0, 1], got {gamma}")
        m = min(pp, max(1, int(round(gamma * pp))))
    m = int(m)
    if not 0 < m <= pp:
        raise ValueError(
            f"m must be in [1, p_pad={pp}] (transform={transform!r}, p={p}), got {m}")
    return SketchSpec(p=p, m=m, transform=transform,
                      key=np.asarray(key, dtype=np.uint32))


def batch_key(spec: SketchSpec, step, shard) -> np.ndarray:
    """The per-(step, shard) mask key: fold the step (as int32), then the shard,
    into the spec's mask key — any worker regenerates any batch's mask."""
    step = int(np.int32(step))
    return prng.fold_in(prng.fold_in(spec.mask_key(), step), int(shard))


def sketch(x: torch.Tensor, spec: SketchSpec, batch_key: np.ndarray | None = None,
           impl: str = "auto") -> SparseRows:
    """Compress a batch of rows (n, p) → SparseRows (n, m) in one pass.

    For Hadamard specs the kept values come from ``kernels.ops.sketch_fused``
    (the fused kernel on a CUDA tensor, its plain version on a CPU one, or the
    plain version anywhere with ``impl="ref"``): precondition and gather with
    no dense (n, p_pad) intermediate. DCT specs precondition then gather.
    """
    impl = ros.resolve_impl(impl, x.device)
    mask_key = batch_key if batch_key is not None else spec.mask_key()
    if spec.transform != "hadamard":
        y = ros.precondition(x, spec.signs_key(), spec.transform, p_orig=spec.p, impl=impl)
        return subsample(y, mask_key, spec.m)
    from repro_torch.kernels import ops  # deferred: kernels import core

    pp = spec.p_pad
    x = ros._pad_to(x, pp)
    d = ros.signs_for(spec.signs_key(), pp, dtype=x.dtype, device=x.device)
    idx = sample_indices(mask_key, x.shape[0], pp, spec.m, device=x.device)
    return SparseRows(ops.sketch_fused(x, d, idx, mode=impl), idx, pp)


def unmix_dense(w_dense: torch.Tensor, spec: SketchSpec, impl: str = "auto") -> torch.Tensor:
    """(HD)ᵀ applied to dense vectors living in the preconditioned domain."""
    return ros.unmix(w_dense, spec.signs_key(), spec.transform, p_orig=spec.p, impl=impl)


def compression_ratio(spec: SketchSpec, value_bytes: int = 4, index_bytes: int = 4) -> float:
    """Stored bytes per sample vs. dense fp32 of the ORIGINAL p."""
    dense = spec.p * 4
    sketched = spec.m * (value_bytes + index_bytes)
    return sketched / dense
