"""fit_many — ONE compression pass feeds every consumer (the paper's pitch, §I).

Fitting ``SparsifiedPCA`` and ``SparsifiedKMeans`` separately on the same
:class:`Plan` sketches the data twice; :func:`fit_many` registers every
consumer on one shared :class:`~repro_torch.api.estimators.SketchCursor`, so
each per-(step, shard) sketch is computed exactly once and folded into every
consumer. The shared cursor derives the SAME spec and the SAME per-chunk mask
keys that each consumer's lone ``fit`` would, so ``fit_many`` reproduces the
separate fits on both backends while sketching once a chunk::

    from repro_torch.api import Plan, SparsifiedKMeans, SparsifiedPCA, fit_many

    plan = Plan(backend="stream", gamma=0.05, batch_size=4096)
    pca = SparsifiedPCA(8, plan, key=0)
    km = SparsifiedKMeans(10, plan, key=0)
    run = fit_many(plan, [pca, km], x)      # one sketch pass, both fitted
    pca.components_; km.centers_            # identical to separate fits
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from repro_torch.api.estimators import SketchCursor, SketchedEstimator, as_key, torch_dtype
from repro_torch.api.plan import Plan
from repro_torch.core import sketch as sketch_mod
from repro_torch.utils.device import not_ported

# Plan fields that determine WHAT the shared sketch is (spec + chunk→key
# mapping). Consumers must agree with the driving plan on these; the backend
# and the fold choices cov_path / rank / lowrank_method may differ per
# consumer: they are pure fold/execution choices.
SKETCH_FIELDS = ("gamma", "m", "transform", "impl", "batch_size", "n_shards",
                 "dtype")


@dataclasses.dataclass
class SharedSketchRun:
    """Handle over one shared compression pass and its fitted consumers.

    Iterable/indexable like the consumer sequence passed to :func:`fit_many`.
    ``partial_fit`` + ``finalize`` extend the SAME pass (every consumer folds
    the new chunks' sketches once more), mirroring the estimator contract.
    """

    consumers: tuple[SketchedEstimator, ...]
    cursor: SketchCursor

    @property
    def spec(self) -> sketch_mod.SketchSpec:
        return self.cursor.spec

    @property
    def count(self) -> int:
        """Rows folded through the shared pass."""
        return self.cursor.count

    @property
    def n_sketches(self) -> int:
        """sketch() invocations — one per (step, shard) chunk, NOT per consumer."""
        return self.cursor.n_sketches

    def __iter__(self) -> Iterator[SketchedEstimator]:
        return iter(self.consumers)

    def __getitem__(self, i: int) -> SketchedEstimator:
        return self.consumers[i]

    def __len__(self) -> int:
        return len(self.consumers)

    def partial_fit(self, x) -> "SharedSketchRun":
        self.cursor.partial_fit(x)
        return self

    def sync(self) -> "SharedSketchRun":
        """Block until the shared pass's last sketch is computed."""
        self.cursor.sync()
        return self

    def finalize(self) -> "SharedSketchRun":
        for c in self.consumers:
            if c in self.cursor.consumers:  # skip consumers detached by reset()
                c.finalize()
        return self

    def checkpoint(self, *args, **kwargs):
        raise not_ported("SharedSketchRun.checkpoint", "Engine replay, scan and checkpoints")


def restore_run(*args, **kwargs):
    raise not_ported("restore_run", "Engine replay, scan and checkpoints")


def _check_consumer(plan: Plan, c: SketchedEstimator, i: int, key0) -> None:
    for f in SKETCH_FIELDS:
        mine, theirs = getattr(plan, f), getattr(c.plan, f)
        if f == "dtype":
            mine, theirs = torch_dtype(mine), torch_dtype(theirs)  # "float32" == torch.float32
        if mine != theirs:
            raise ValueError(
                f"consumers[{i}] ({type(c).__name__}) was built with "
                f"plan.{f}={theirs!r}, but the shared pass uses {f}={mine!r}; "
                "a shared sketch requires every consumer to agree on the "
                f"sketch geometry fields {SKETCH_FIELDS}")
    if not np.array_equal(np.asarray(key0), np.asarray(c.key)):
        raise ValueError(
            f"consumers[{i}] ({type(c).__name__}) holds a different key than "
            "consumers[0] — a shared sketch means shared randomness; construct "
            "every consumer with the same key")


def fit_many(plan: Plan, consumers: Sequence[SketchedEstimator], data=None, *,
             source=None, steps: int | None = None, seed: int | None = None,
             finalize: bool = True, refine: bool | int = False,
             scan: bool = False) -> SharedSketchRun:
    """Fit every consumer from ONE ``source → sketch → fan-out`` pass.

    plan: the shared execution plan; every consumer's plan must agree with it
        on :data:`SKETCH_FIELDS` (backends may differ per consumer).
    consumers: estimators built with the SAME key and on the same device. They
        are reset, registered on one shared :class:`SketchCursor`, fed, and
        finalized in place.
    data: in-memory ``(rows, p)`` rows (numpy or torch), consumed in
        ``plan.batch_size`` chunks, exactly like ``estimator.fit``. Mutually
        exclusive with ``source``.
    source / steps / seed: a ``(seed, step, shard) → (b, p)`` source pulled for
        ``steps`` steps × ``plan.n_shards`` shards, like ``estimator.fit_stream``.
    finalize: pass False to stop after ingest (keep feeding via
        ``run.partial_fit``; call ``run.finalize()`` when done).
    refine: second-pass refinement, not ported yet (raises).
    scan: the reference's ``lax.scan`` ingest. The same validation (in-memory
        data, consumers whose folds stream); the ingest is this host loop,
        which gives the same sketches and folds.
    """
    consumers = tuple(consumers)
    if not consumers:
        raise ValueError("fit_many needs at least one consumer")
    if (data is None) == (source is None):
        raise ValueError("provide exactly one of data or source=")
    if source is not None and steps is None:
        raise ValueError("source= needs steps=")
    if refine:
        raise not_ported("fit_many(refine=...)", "Low-rank FD and refinement")
    for i, c in enumerate(consumers):
        if not isinstance(c, SketchedEstimator):
            raise TypeError(f"consumers[{i}] is {type(c).__name__}, expected a "
                            "SketchedEstimator (SparsifiedMean/Cov/PCA/KMeans)")
    key0 = as_key(consumers[0].key)
    for i, c in enumerate(consumers):
        _check_consumer(plan, c, i, key0)
    devices = {c.device for c in consumers}
    if len(devices) > 1:
        raise ValueError(f"the consumers live on {sorted(map(str, devices))}; a shared "
                         "pass sketches on one device")
    if scan:
        if data is None:
            raise ValueError("scan=True stages in-memory data; source= ingest is "
                             "host-driven — drop scan=True")
        if not all(c._scannable() for c in consumers):
            raise ValueError(
                "scan=True but a consumer cannot fold inside the reference's lax.scan "
                "(batch-backend moments and Lloyd K-means retain their sketches); drop "
                "scan=True or switch those consumers to stream/minibatch/lowrank folds")

    cursor = SketchCursor(plan, key0, consumers[0].device)
    for c in consumers:
        c.reset()
        c._cursor = cursor      # adopt the shared pass (reset() detaches again)
        cursor.register(c)
    if data is not None:
        cursor.partial_fit(data)
    else:
        from repro_torch.stream.engine import normalize_source

        cursor.fold_source(normalize_source(source), steps, seed)

    run = SharedSketchRun(consumers, cursor)
    if finalize:
        run.finalize()
    return run

