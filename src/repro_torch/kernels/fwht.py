"""K2 and K3: y = H·(d ⊙ x), or d ⊙ (H·x) — the CUDA kernels' wrappers.

Replace the TPU kernels ``repro.kernels.fwht.hd_precondition`` (K2, one row
in one tile, p ≤ 2^15) and ``hd_precondition_chunked`` (K3, 2^15 < p ≤ 2^27),
both in ``csrc/hadamard.cu``. K2 holds one row per block in shared memory,
which caps p at 2^15; where a call has fewer rows than the card has SMs (the
finalize unmixes), it splits each row over a cluster of C blocks of 2^11 to
2^13 values instead, so a row's work spreads over C SMs: :func:`split_plan`
is that schedule. K3 holds a row in a thread-block cluster of C blocks,
2^14 values each (two blocks an SM) where the row fits such a cluster, else
2^15, so up to C_max·2^15 (C_max, the largest cluster the card places, is
:func:`max_cluster`: 16 on an H100 80GB HBM3) the transform is one read and
one write of the row; above that the cluster kernel transforms each
C_max·2^15 segment and register passes over device memory run the remaining
stages. :func:`chunk_plan` is that schedule.
:func:`hd_precondition` takes any p up to 2^27 and picks the kernel, as the
reference's does. A cluster launch that fails raises; nothing runs the
multi-pass schedule or the plain version in its place.

On a CPU tensor the wrappers compute the plain version (``kernels.ref``); on a
CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

MAX_P_SINGLE = 1 << 15
# largest p overall, the reference's limit for its chunked schedule
MAX_P = 1 << 27
# K3's schedule (csrc/hadamard.cu kChunkLog, kMaxClusterLog, kLogE): log2 of
# the chunk a block of a cluster holds (2^14 where a row fits a cluster of
# such blocks, two blocks an SM; else 2^15, one), the cluster sizes the kernel
# is built for, and the index bits a register pass takes
CHUNK_LOGS = (14, 15)
CHUNK_LOG = 15
CLUSTER_SIZES = (2, 4, 8, 16)
REGISTER_BITS = 5
# K2's split of a row of p <= 2^15 values (csrc/hadamard.cu, chunk_log 11 … 13):
# the chunk sizes it is built for, and the one split_plan takes where it can
SPLIT_CHUNK_LOGS = (11, 12, 13)
SPLIT_CHUNK_LOG = 11


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


def chunk_plan(p: int, max_cluster: int) -> tuple[int, int, int]:
    """(cluster, chunk_log, register_passes): K3's schedule for 2^15 < p ≤ 2^27.

    One launch of clusters of ``cluster`` blocks, each holding 2^chunk_log
    values, runs the stages of the low chunk_log + log2(cluster) index bits;
    then ``register_passes`` passes of at most five index bits each run the
    rest. ``max_cluster`` is C_max (:func:`max_cluster` on the card). Chunks
    are 2^14 values where the row fits a cluster of them, else 2^15.
    """
    log_p = check_p(p, MAX_P)
    if p <= MAX_P_SINGLE:
        raise ValueError(f"K3 takes p > {MAX_P_SINGLE}, got {p}; use hd_precondition")
    if max_cluster not in CLUSTER_SIZES:
        raise ValueError(f"max_cluster must be one of {CLUSTER_SIZES}, got {max_cluster}")
    chunk_log = CHUNK_LOGS[0] if p <= max_cluster << CHUNK_LOGS[0] else CHUNK_LOG
    cluster = min(p >> chunk_log, max_cluster)
    rest = log_p - chunk_log - (cluster.bit_length() - 1)
    return cluster, chunk_log, -(-rest // REGISTER_BITS)


def split_plan(n: int, p: int, sms: int, max_cluster: int) -> tuple[int, int] | None:
    """K2's schedule for n rows of p ≤ 2^15: None for one block a row, else
    (cluster, chunk_log), a row split over a cluster of ``cluster`` blocks of
    2^chunk_log values.

    A row is split where the call has fewer rows than the card has SMs
    (``sms``), so one block a row would leave SMs idle and run each row's
    stages serially: into chunks of 2^SPLIT_CHUNK_LOG values, or larger ones
    where that would take a cluster above ``max_cluster`` (C_max). Rows of
    at most 2^SPLIT_CHUNK_LOG values are not split.
    """
    log_p = check_p(p)
    if n >= sms or log_p <= SPLIT_CHUNK_LOG:
        return None
    chunk_log = max(SPLIT_CHUNK_LOG, log_p - (max_cluster.bit_length() - 1))
    if chunk_log not in SPLIT_CHUNK_LOGS:
        return None
    return 1 << (log_p - chunk_log), chunk_log


@functools.cache
def _max_cluster(index: int) -> int:
    with torch.cuda.device(index):
        got = _build.library("hadamard").hadamard_max_cluster()
    if got < 0:
        _build.check(-got, "hadamard_max_cluster")
    if got not in CLUSTER_SIZES:
        raise RuntimeError("the card places no cluster of two 132 KiB blocks, which K3 needs")
    return got


def max_cluster(device: torch.device) -> int:
    """C_max: the largest cluster of K3's 132 KiB blocks that the card at
    ``device`` places (cudaOccupancyMaxActiveClusters), asked once."""
    return _max_cluster(torch.device(device).index or 0)


def _check(x: torch.Tensor, signs: torch.Tensor) -> None:
    _build.require(x, torch.float32, 2, "x")
    _build.require(signs, torch.float32, 1, "signs", device=x.device)
    if signs.shape[0] != x.shape[1]:
        raise ValueError(f"signs has length {signs.shape[0]}, rows have {x.shape[1]}")


def hd_precondition(x: torch.Tensor, signs: torch.Tensor,
                    signs_after: bool = False) -> torch.Tensor:
    """(n, p) → (n, p): H·(signs ⊙ x), or signs ⊙ (H·x) with ``signs_after``.

    K2 up to p = 2^15 (on :func:`split_plan`'s schedule), K3 above it, up to 2^27.
    """
    if x.shape[-1] > MAX_P_SINGLE:
        return hd_precondition_chunked(x, signs, signs_after)
    if x.device.type == "cpu":
        return _ref.ref_hd_precondition(x, signs, signs_after)
    n, p = x.shape
    plan = split_plan(n, p, _build.sm_count(x.device), max_cluster(x.device))
    return _rows(x, signs, signs_after, plan)


def _rows(x: torch.Tensor, signs: torch.Tensor, signs_after: bool,
          plan: tuple[int, int] | None) -> torch.Tensor:
    """K2's launch on ``plan``, :func:`split_plan`'s schedule: one block a row
    (None), or each row over a cluster of (cluster, chunk_log)."""
    _check(x, signs)
    n, p = x.shape
    log_p = check_p(p)
    cluster, chunk_log = plan or (1, log_p)
    if cluster > 1 and (chunk_log not in SPLIT_CHUNK_LOGS or cluster << chunk_log != p
                        or n * cluster >= 1 << 31):
        raise ValueError(f"K2 cannot split rows of {p} into {cluster} chunks of 2^{chunk_log}")
    out = torch.empty_like(x)
    if n:
        lib = _build.library("hadamard")
        with _build.on_device(x):
            err = lib.hd_precondition_f32(x.data_ptr(), signs.data_ptr(), out.data_ptr(),
                                          n, log_p, int(signs_after), scale_for(p),
                                          cluster.bit_length() - 1,
                                          chunk_log if cluster > 1 else 0,
                                          _build.stream_of(x))
        _build.check(err, "hd_precondition")
        hd_precondition.launches += 1
    return out


def hd_precondition_chunked(x: torch.Tensor, signs: torch.Tensor,
                            signs_after: bool = False) -> torch.Tensor:
    """K3: the same transform for 2^15 < p ≤ 2^27, on :func:`chunk_plan`'s
    schedule: one cluster pass up to C_max·2^15, register passes above.

    Above 2^27 it raises on any device, as the reference does.
    """
    check_p(x.shape[-1], MAX_P)
    if x.device.type == "cpu":
        return _ref.ref_hd_precondition(x, signs, signs_after)
    return _chunked(x, signs, signs_after, chunk_plan(x.shape[-1], max_cluster(x.device)))


def _chunked(x: torch.Tensor, signs: torch.Tensor, signs_after: bool,
             plan: tuple[int, int, int]) -> torch.Tensor:
    """K3's launch on ``plan``, :func:`chunk_plan`'s schedule for a C_max
    the card places."""
    _check(x, signs)
    n, p = x.shape
    cluster, chunk_log, _ = plan
    if n * (p >> chunk_log) >= 1 << 31:
        raise ValueError(f"({n}, {p}) has too many chunks for one launch; split the rows")
    out = torch.empty_like(x)
    if n:
        lib = _build.library("hadamard")
        with _build.on_device(x):
            err = lib.hd_precondition_chunked_f32(x.data_ptr(), signs.data_ptr(),
                                                  out.data_ptr(), n, p.bit_length() - 1,
                                                  int(signs_after), scale_for(p),
                                                  cluster.bit_length() - 1, chunk_log,
                                                  _build.stream_of(x))
        _build.check(err, "hd_precondition_chunked")
        hd_precondition_chunked.launches += 1
    return out


hd_precondition.launches = 0
hd_precondition_chunked.launches = 0
