"""K1: values (n, m) = (H·(d ⊙ x))[i, idx[i]] in one pass — the CUDA kernels' wrappers.

Replace the TPU kernel ``repro.kernels.sketch_fused.sketch_fused``: the
preconditioned row stays in shared memory and only the m kept values are
written (``csrc/hadamard.cu``). :func:`sketch_fused` runs K2's kernel in its
gather mode, one row a block, up to p = 2^15; :func:`sketch_fused_cluster`
runs K3's cluster kernel in its gather mode, one row a cluster, for
2^15 < p ≤ C_max·2^15 (``fwht.max_cluster``), where the reference composes
its chunked transform with a gather because a row exceeds a TPU core's VMEM.

On a CPU tensor the wrappers compute the plain version (``kernels.ref``); on a
CUDA tensor they launch the kernel or raise outside their range of p
(``kernels.ops.sketch_fused`` composes K3 and a gather above C_max·2^15).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, fwht
from repro_torch.kernels import ref as _ref


def _check(x: torch.Tensor, signs: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """The (n, m) output for valid operands; raises on what the kernels do not take."""
    _build.require(x, torch.float32, 2, "x")
    _build.require(signs, torch.float32, 1, "signs", device=x.device)
    _build.require(indices, torch.int32, 2, "indices", device=x.device)
    if signs.shape[0] != x.shape[1] or indices.shape[0] != x.shape[0]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, signs "
                         f"{tuple(signs.shape)}, indices {tuple(indices.shape)}")
    return torch.empty(indices.shape, dtype=x.dtype, device=x.device)


def sketch_fused(x: torch.Tensor, signs: torch.Tensor,
                 indices: torch.Tensor) -> torch.Tensor:
    """x (n, p) f32, p a power of two ≤ 2^15; signs (p,); indices (n, m) int32,
    each in [0, p) (sorted and distinct, as ``sample_indices`` gives them)."""
    if x.device.type == "cpu":
        return _ref.ref_sketch_fused(x, signs, indices)
    out = _check(x, signs, indices)
    n, p = x.shape
    m = indices.shape[1]
    log_p = fwht.check_p(p)
    if n and m:
        lib = _build.library("hadamard")
        with _build.on_device(x):
            err = lib.sketch_fused_f32(x.data_ptr(), signs.data_ptr(), indices.data_ptr(),
                                       out.data_ptr(), n, log_p, m, fwht.scale_for(p),
                                       _build.stream_of(x))
        _build.check(err, "sketch_fused")
        sketch_fused.launches += 1
    return out


def sketch_fused_cluster(x: torch.Tensor, signs: torch.Tensor,
                         indices: torch.Tensor) -> torch.Tensor:
    """:func:`sketch_fused` for 2^15 < p ≤ C_max·2^15: one row a cluster
    (K3's cluster kernel in its gather mode, its blocks as
    ``fwht.chunk_plan`` gives them); indices (n, m) int32 in [0, p), in any
    order. Bit-equal to the plain version."""
    if x.device.type == "cpu":
        return _ref.ref_sketch_fused(x, signs, indices)
    p = x.shape[1]
    fwht.check_p(p, fwht.MAX_P)
    c_max = fwht.max_cluster(x.device)
    if not fwht.MAX_P_SINGLE < p <= c_max << fwht.CHUNK_LOG:
        raise ValueError(f"the cluster sketch takes {fwht.MAX_P_SINGLE} < p <= "
                         f"{c_max << fwht.CHUNK_LOG} on this card, got {p}")
    return _cluster(x, signs, indices, fwht.chunk_plan(p, c_max))


def _cluster(x: torch.Tensor, signs: torch.Tensor, indices: torch.Tensor,
             plan: tuple[int, int, int]) -> torch.Tensor:
    """The cluster sketch's launch on ``plan``, ``fwht.chunk_plan``'s schedule
    for a C_max the card places, with no register pass."""
    out = _check(x, signs, indices)
    n, m = indices.shape
    p = x.shape[1]
    cluster, chunk_log, passes = plan
    if passes:
        raise ValueError(f"the cluster sketch runs no register pass; plan {plan} has {passes}")
    if n * cluster >= 1 << 31:
        raise ValueError(f"{n} rows of {p} are too many blocks for one launch; split the rows")
    if n and m:
        lib = _build.library("hadamard")
        with _build.on_device(x):
            err = lib.sketch_cluster_f32(x.data_ptr(), signs.data_ptr(), indices.data_ptr(),
                                         out.data_ptr(), n, cluster.bit_length() - 1, chunk_log,
                                         m, fwht.scale_for(p), _build.stream_of(x))
        _build.check(err, "sketch_fused_cluster")
        sketch_fused_cluster.launches += 1
    return out


sketch_fused.launches = 0
sketch_fused_cluster.launches = 0
