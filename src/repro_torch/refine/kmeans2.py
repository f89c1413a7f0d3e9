"""Two-pass (Alg. 2) K-means refinement over the regenerable source.

Mini-batch streaming K-means assigns each batch against the centers as they
were when it arrived, so its centers inherit one round of assignment noise. A
replay re-assigns every row against FROZEN first-pass centers and rebuilds
each center as the per-coordinate mean of its consistently assigned sparse
rows (the paper's unbiased center estimator).

A batch's delta depends only on the frozen centers, not on the accumulated
state, so folds commute. On the card the assignment is K4
(``kernels.ops.sparse_assign``), the sums K6's walk over the labels' one-hot
columns and the counts an integer histogram (``kernels.ops.cluster_sums``):
a replay repeats bit for bit. The flip count — rows whose frozen-center label
differs from their label one rebuild earlier — is a second K4 launch against
``prev``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.sampling import SparseRows
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class KMeans2State:
    """One replay pass's fixed-size accumulators (all frozen-center driven).

    sums:  (K, p) Σ of sampled values per (cluster, coordinate)
    cnts:  (K, p) per-coordinate observation counts (int32 — exact)
    obj:   ()     Σ min-distance² under the frozen centers
    flips: ()     rows whose frozen-center label ≠ their label under the
                  previous pass's centers (0 when there are none)
    count: ()     rows folded
    """

    sums: torch.Tensor
    cnts: torch.Tensor
    obj: torch.Tensor
    flips: torch.Tensor
    count: torch.Tensor


def kmeans2_init(k: int, p: int, device="cpu") -> KMeans2State:
    return KMeans2State(
        sums=torch.zeros((k, p), dtype=torch.float32, device=device),
        cnts=torch.zeros((k, p), dtype=torch.int32, device=device),
        obj=torch.zeros((), dtype=torch.float32, device=device),
        flips=torch.zeros((), dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def kmeans2_delta(batch: SparseRows, frozen: torch.Tensor, prev: torch.Tensor | None = None,
                  impl: str = "auto") -> KMeans2State:
    """One batch's contribution under FROZEN centers — local, additive, and
    independent of the accumulated state.

    ``prev`` (the centers one rebuild earlier) turns on the flip count; None
    on the first pass.
    """
    values, indices = batch.values, batch.indices
    k, p = frozen.shape
    d, a = ops.sparse_assign(values, indices, frozen, mode=impl)          # (n, K), (n,)
    sums, cnts = ops.cluster_sums(values, indices, a, k, p, mode=impl)
    if prev is None:
        flips = torch.zeros((), dtype=torch.int32, device=values.device)
    else:
        a_prev = ops.sparse_assign(values, indices, prev, mode=impl)[1]
        flips = torch.sum(a != a_prev).to(torch.int32)
    return KMeans2State(sums, cnts.to(torch.int32),
                        torch.min(d, dim=1).values.sum().to(torch.float32), flips,
                        torch.tensor(values.shape[0], dtype=torch.int32, device=values.device))


def kmeans2_apply(state: KMeans2State, delta: KMeans2State) -> KMeans2State:
    """Fold a delta into the pass accumulator (also sums a step's shard deltas)."""
    return KMeans2State(state.sums + delta.sums, state.cnts + delta.cnts,
                        state.obj + delta.obj, state.flips + delta.flips,
                        state.count + delta.count)


def kmeans2_centers(state: KMeans2State, frozen: torch.Tensor) -> torch.Tensor:
    """Rebuild: the per-coordinate mean of the consistently assigned sparse
    rows; never-sampled (cluster, coordinate) cells keep their frozen value."""
    return torch.where(state.cnts > 0,
                       state.sums / torch.clamp(state.cnts, min=1).to(torch.float32), frozen)
