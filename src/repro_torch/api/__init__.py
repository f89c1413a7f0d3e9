"""repro_torch.api — one front door over the compression pipeline.

A :class:`Plan` picks how a sketch job runs (``backend="batch" | "stream" |
"sharded"``,
kernel ``impl``, batch geometry); the estimator classes —
:class:`SparsifiedMean`, :class:`SparsifiedCov`, :class:`SparsifiedPCA`,
:class:`SparsifiedKMeans` — share one ``SketchSpec``-derived key discipline
(``sketch.batch_key(spec, step, shard)``) and a ``fit / partial_fit /
finalize / transform`` contract, on the card unless ``device="cpu"`` is
asked for. Backends fold the same per-(step, shard) sketches, so flipping
``Plan.backend`` re-runs the same job to float summation order (1e-5)::

    from repro_torch.api import Plan, SparsifiedPCA

    plan = Plan(backend="batch", gamma=0.05, batch_size=2048)
    p1 = SparsifiedPCA(8, plan, key=0).fit(x)
    p2 = SparsifiedPCA(8, plan.replace(backend="stream"), key=0).fit(x)

One compression pass can feed every consumer at once: :func:`fit_many`
sketches each (step, shard) chunk once and fans it out::

    pca = SparsifiedPCA(8, plan, key=0)
    km = SparsifiedKMeans(10, plan, key=0)
    fit_many(plan, [pca, km], x)     # one sketch pass, both fitted

For unbounded sources, :func:`make_engine` builds the streaming engine from
the same Plan::

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

A fit resumes and refines: ``est.checkpoint(dir)`` / ``est.restore(dir)``
and ``run.checkpoint(dir)`` / :func:`restore_run` continue an interrupted
pass bit for bit (either package's checkpoints), and ``fit_refine`` /
``refine`` / ``fit_many(..., refine=q)`` replay the pass to sharpen the
low-rank PCA basis (power iteration) and minibatch K-means centers (two-pass
Alg. 2)::

    plan = Plan(backend="stream", gamma=0.05, batch_size=4096,
                cov_path="lowrank", rank=24)
    pca = SparsifiedPCA(8, plan, key=0).fit_refine(x, passes=2)

``backend="sharded"`` folds over a mesh of processes
(:mod:`repro_torch.cluster`): each process sketches and folds the shards it
owns and one all-reduce of the fixed-size delta a step reduces them; in one
process it owns every shard. ``python -m repro_torch.launch.cluster`` runs
the engine over N processes. :class:`GradCompressor` compresses gradient
trees with the same sketch and keys (``repro_torch.core.grad_compress``); the
trainer (``repro_torch.train``, ``python -m repro_torch.launch.train``) runs
it on a language model's gradients.
"""
from __future__ import annotations

from repro_torch.api.estimators import (  # noqa: F401
    GradCompressor,
    SketchCursor,
    SketchedEstimator,
    SparsifiedCov,
    SparsifiedKMeans,
    SparsifiedMean,
    SparsifiedPCA,
    as_key,
)
from repro_torch.api.fused import SharedSketchRun, fit_many, restore_run  # noqa: F401
from repro_torch.api.plan import BACKENDS, Plan  # noqa: F401


def make_engine(plan: Plan, p: int, key, source, *, track_cov: bool = True,
                kmeans=None, device="cuda"):
    """Construct a :class:`repro_torch.stream.StreamEngine` from a Plan.

    The engine is the fused one-pass runner (moments or the low-rank
    range-finder state, + streaming K-means, over one sketch of each batch) on
    ``device`` (the card by default). Backend "stream" folds the shards one
    after another; "sharded" folds this process's shards of
    ``plan.resolve_mesh()`` and all-reduces each step's delta over it.
    """
    from repro_torch.stream import StreamEngine

    if plan.backend == "batch":
        raise ValueError(
            'make_engine needs backend "stream" or "sharded", got \'batch\'; '
            "for in-memory data use the estimator classes directly")
    if plan.cov_path == "lowrank" and plan.lowrank_method == "fd":
        raise ValueError(
            "the engine's low-rank path sums the linear range-finder delta; "
            "lowrank_method='fd' (order-dependent shrink) is estimator-layer "
            "only — use lowrank_method='range'")
    mesh = plan.resolve_mesh() if plan.backend == "sharded" else None
    return StreamEngine(plan.spec(p, as_key(key)), source, n_shards=plan.n_shards,
                        mesh=mesh, axis=plan.axis, track_cov=track_cov, kmeans=kmeans,
                        impl=plan.impl, cov_path=plan.cov_path, rank=plan.rank, device=device)
