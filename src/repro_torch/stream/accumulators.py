"""Constant-memory accumulators for the one-pass streaming estimators.

Every workload folds a sketched batch into a fixed-size accumulator and
finalizes once, split into

    delta(batch)  →  local, per shard, and
    apply(state, delta)  →  the only state mutation,

so the shards of one step are each taken against the step-start state, summed,
and applied once. Finalize uses the Thm-4 / Thm-6 formulas of
``repro_torch.core.estimators``.

- :class:`MomentState` — Σ R_iR_iᵀx_i (p,) and Σ w_iw_iᵀ (p,p);
- :class:`KMeansState` — mini-batch streaming sparsified K-means: per-cluster,
  per-coordinate running means in the preconditioned domain (the online form
  of Eq. 39), with ``r`` center hypotheses folded side by side and the best
  kept at finalize. The assignment is the K4 kernel (``kernels.ops``), one
  launch for all r hypotheses.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import estimators as _est
from repro_torch.core.kmeans import kpp_init_sparse
from repro_torch.core.sampling import SparseRows
from repro_torch.kernels import ops
from repro_torch.utils import prng

# ------------------------------------------------------------- moments ------

MomentState = _est.StreamState
moment_init = _est.stream_init
moment_delta = _est.stream_delta
moment_apply = _est.stream_apply
moment_finalize_mean = _est.stream_finalize_mean
moment_finalize_cov = _est.stream_finalize_cov


# -------------------------------------------- mini-batch streaming K-means --


@dataclasses.dataclass(frozen=True)
class KMeansState:
    """r parallel center hypotheses in the preconditioned domain.

    centers: (r, K, p) — per-cluster, per-coordinate running means;
    counts:  (r, K, p) — per-coordinate observation counts (Eq. 39 weights),
                         int32, or float32 under a decay factor < 1;
    obj:     (r,)      — accumulated mini-batch objective (hypothesis selector);
    count:   ()        — samples folded so far (int32).
    """

    centers: torch.Tensor
    counts: torch.Tensor
    obj: torch.Tensor
    count: torch.Tensor


def kmeans_init(key, first_batch: SparseRows, k: int, n_init: int = 3,
                decay: float = 1.0, impl: str = "auto") -> KMeansState:
    """Seed r = n_init hypotheses with K-means++ on the first sketched batch."""
    centers = torch.stack([
        kpp_init_sparse(rkey, first_batch.values, first_batch.indices,
                        first_batch.p, k, impl=impl)
        for rkey in prng.split(key, n_init)]).to(torch.float32)
    device = centers.device
    return KMeansState(
        centers=centers,
        counts=torch.zeros(centers.shape, device=device,
                           dtype=torch.int32 if decay == 1.0 else torch.float32),
        obj=torch.zeros((n_init,), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def kmeans_delta_with_assign(state: KMeansState, batch: SparseRows, impl: str = "auto"):
    """(delta, assign) for one batch under every hypothesis.

    delta = (sums (r, K, p) f32, cnts (r, K, p) int32, obj (r,), n ());
    assign (r, n) int32 are the labels under the step-start centers.
    """
    values, indices = batch.values, batch.indices
    r, k, p = state.centers.shape
    d, assign = ops.sparse_assign(values, indices, state.centers, mode=impl)   # (r, n, K)
    offs = torch.arange(r, device=values.device)[:, None, None] * (k * p)
    flat = (offs + assign.long()[:, :, None] * p + indices.long()[None]).reshape(-1)
    vals = values.to(torch.float32)[None].expand(r, -1, -1).reshape(-1)
    sums = torch.zeros(r * k * p, dtype=torch.float32, device=values.device)
    sums = sums.index_add_(0, flat, vals).reshape(r, k, p)
    cnts = torch.bincount(flat, minlength=r * k * p).to(torch.int32).reshape(r, k, p)
    obj = torch.min(d, dim=2).values.sum(dim=1).to(torch.float32)
    n = torch.tensor(values.shape[0], dtype=torch.int32, device=values.device)
    return (sums, cnts, obj, n), assign


def kmeans_delta(state: KMeansState, batch: SparseRows, impl: str = "auto"):
    """Assignment + scatter sums for one batch under every hypothesis."""
    delta, _ = kmeans_delta_with_assign(state, batch, impl)
    return delta


def kmeans_add(a, b):
    """Sum of two deltas (the shards of one step)."""
    return tuple(x + y for x, y in zip(a, b))


def kmeans_apply(state: KMeansState, delta, decay: float = 1.0) -> KMeansState:
    """Online per-coordinate mean update — the streaming form of Eq. 39.

    new_center = (count·center + batch_sum) / (count + batch_count) wherever the
    batch touched the coordinate; untouched coordinates keep their value.
    ``decay`` < 1 shrinks the accumulated counts before the delta is applied.
    """
    sums, cnts, obj, n = delta
    old_counts = state.counts if decay == 1.0 else state.counts * decay
    new_counts = old_counts + cnts.to(state.counts.dtype)
    cnts_f = cnts.to(torch.float32)
    centers = torch.where(
        cnts > 0,
        state.centers + (sums - cnts_f * state.centers)
        / torch.clamp(new_counts, min=1).to(torch.float32),
        state.centers,
    )
    return KMeansState(centers, new_counts, state.obj + obj, state.count + n)


def kmeans_finalize(state: KMeansState):
    """(best centers (K, p) in the preconditioned domain, best accumulated obj)."""
    best = torch.argmin(state.obj)
    return state.centers[best], state.obj[best]


def kmeans_assign(centers_pre: torch.Tensor, batch: SparseRows, impl: str = "auto") -> torch.Tensor:
    """Nearest-center labels for sketched rows under the sparsified metric."""
    return ops.sparse_assign(batch.values, batch.indices, centers_pre, mode=impl)[1]
