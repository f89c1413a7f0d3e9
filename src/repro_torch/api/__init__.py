"""repro_torch.api — the front door over the compression pipeline.

A :class:`Plan` picks how a sketch job runs; :func:`make_engine` builds the
streaming engine from it::

    from repro_torch.api import Plan, make_engine
    from repro_torch.data.pipeline import VectorStreamSource
    from repro_torch.stream import StreamKMeansConfig

    plan = Plan(backend="stream", gamma=0.05, batch_size=4096)
    src = VectorStreamSource(p=16384, batch=4096, seed=0)
    res = make_engine(plan, 16384, 1, src, kmeans=StreamKMeansConfig(k=10)).run(16)

and, where the (p, p) accumulator would not fit, the low-rank path::

    plan = Plan(backend="stream", gamma=0.05, batch_size=4096,
                cov_path="lowrank", rank=128)
    eng = make_engine(plan, 65536, 1, VectorStreamSource(p=65536, batch=4096),
                      kmeans=StreamKMeansConfig(k=10))
    comps_pre, evals = eng.run(8).cov_lowrank.top(8)
    comps = sketch.unmix_dense(comps_pre, eng.spec)   # repro_torch.core.sketch

The estimator classes of the reference (``SparsifiedMean/Cov/PCA/KMeans``,
``fit_many``) are not ported yet.
"""
from __future__ import annotations

import numpy as np

from repro_torch.api.plan import BACKENDS, Plan  # noqa: F401
from repro_torch.utils import prng
from repro_torch.utils.device import not_ported


def as_key(key) -> np.ndarray:
    """Accept an int seed or threefry key data (uint32[2])."""
    if isinstance(key, (int, np.integer)):
        return prng.PRNGKey(int(key))
    return np.asarray(key, dtype=np.uint32)


def make_engine(plan: Plan, p: int, key, source, *, track_cov: bool = True,
                kmeans=None, device="cuda"):
    """Construct a :class:`repro_torch.stream.StreamEngine` from a Plan.

    The engine is the fused one-pass runner (moments or the low-rank
    range-finder state, + streaming K-means, over one sketch of each batch) on
    ``device`` (the card by default). Backend "stream" folds the shards one
    after another.
    """
    from repro_torch.stream import StreamEngine

    if plan.backend == "sharded":
        raise not_ported("Plan(backend='sharded')", "Sharded backend")
    if plan.backend == "batch":
        raise not_ported("Plan(backend='batch')", "Estimator front door")
    if plan.mesh is not None:
        raise not_ported("Plan(mesh=...)", "Sharded backend")
    if plan.cov_path == "lowrank" and plan.lowrank_method == "fd":
        raise ValueError(
            "the engine's low-rank path sums the linear range-finder delta; "
            "lowrank_method='fd' (order-dependent shrink) is estimator-layer "
            "only — use lowrank_method='range'")
    if plan.refine_passes:
        raise not_ported("Plan(refine_passes=...)", "Low-rank FD and refinement")
    return StreamEngine(plan.spec(p, as_key(key)), source, n_shards=plan.n_shards,
                        track_cov=track_cov, kmeans=kmeans, impl=plan.impl,
                        cov_path=plan.cov_path, rank=plan.rank, device=device)
