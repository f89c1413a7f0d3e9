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

``run.checkpoint(dir)`` writes every consumer's fold state and the one shared
cursor (``format: "fused-run-v1"``, the reference's layout); :func:`restore_run`
resumes the pass bit for bit. ``fit_many(..., refine=q)`` replays the pass q
times for every consumer that refines, one regenerated sketch a chunk shared
by all of them.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from repro_torch import refine as refine_mod
from repro_torch.api.estimators import SketchCursor, SketchedEstimator, as_key, torch_dtype
from repro_torch.api.plan import Plan
from repro_torch.core import sketch as sketch_mod
from repro_torch.train import checkpoint

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

    def checkpoint(self, ckpt_dir: str, *, keep_last: int = 3) -> "SharedSketchRun":
        """Checkpoint the shared pass — every consumer's fold state
        (``SketchedEstimator.state_arrays``, under ``c<i>/``) and the ONE
        shared cursor — atomically through ``train.checkpoint``;
        :func:`restore_run` resumes it bit for bit."""
        cur = self.cursor
        if cur.spec is None:
            raise RuntimeError("nothing folded yet — nothing to checkpoint")
        arrays: dict = {}
        for i, c in enumerate(self.consumers):
            for name, v in c.state_arrays().items():
                arrays[f"c{i}/{name}"] = v
        extra = {"format": "fused-run-v1", "n_consumers": len(self.consumers),
                 **cur.position()}
        checkpoint.save_arrays(ckpt_dir, cur.chunk, arrays, extra=extra, keep_last=keep_last)
        return self


def restore_run(ckpt_dir: str, plan: Plan,
                consumers: Sequence[SketchedEstimator]) -> SharedSketchRun:
    """Rebuild a :class:`SharedSketchRun` from its latest checkpoint (either
    package's).

    ``consumers`` are freshly constructed estimators in the checkpointed run's
    order, with the same plans and keys, on one device. The shared cursor
    resumes at the saved chunk, so the next ``partial_fit`` folds under the
    (step, shard) mask keys the uninterrupted pass would have used.
    """
    arrays, extra = checkpoint.load_arrays(ckpt_dir)
    if extra.get("format") != "fused-run-v1":
        raise ValueError(f"{ckpt_dir} is not a fused-run checkpoint "
                         f"(format={extra.get('format')!r})")
    consumers = tuple(consumers)
    if len(consumers) != int(extra["n_consumers"]):
        raise ValueError(f"checkpoint holds {extra['n_consumers']} consumers, "
                         f"got {len(consumers)}")
    key0 = as_key(consumers[0].key)
    for i, c in enumerate(consumers):
        _check_consumer(plan, c, i, key0)
    cursor = _shared_cursor(plan, consumers, key0)
    cursor.resume(extra)
    for i, c in enumerate(consumers):
        prefix = f"c{i}/"
        c.load_state_arrays({k[len(prefix):]: v for k, v in arrays.items()
                             if k.startswith(prefix)})
    return SharedSketchRun(consumers, cursor)


def _shared_cursor(plan: Plan, consumers, key0) -> SketchCursor:
    """One cursor on the consumers' device, every consumer reset onto it."""
    devices = {c.device for c in consumers}
    if len(devices) > 1:
        raise ValueError(f"the consumers live on {sorted(map(str, devices))}; a shared "
                         "pass sketches on one device")
    cursor = SketchCursor(plan, key0, consumers[0].device)
    for c in consumers:
        c.reset()
        c._cursor = cursor      # adopt the shared pass (reset() detaches again)
        cursor.register(c)
    return cursor


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
    refine: after finalize, replay refinement (``repro_torch.refine``) on
        every consumer that supports it — power iteration for the low-rank
        range PCA, two-pass Alg. 2 for minibatch K-means. ``True`` takes
        ``plan.refine_passes`` (or 1), an int the pass count. Each pass
        regenerates every (step, shard) sketch ONCE and fans it out to all
        refiners. Needs ``finalize=True``.
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
    if refine and not finalize:
        raise ValueError("refine= replays a FINALIZED first pass; drop "
                         "finalize=False (or refine later via estimator.refine)")
    for i, c in enumerate(consumers):
        if not isinstance(c, SketchedEstimator):
            raise TypeError(f"consumers[{i}] is {type(c).__name__}, expected a "
                            "SketchedEstimator (SparsifiedMean/Cov/PCA/KMeans)")
    key0 = as_key(consumers[0].key)
    for i, c in enumerate(consumers):
        _check_consumer(plan, c, i, key0)
    refiners: tuple[SketchedEstimator, ...] = ()
    if refine:
        refiners = tuple(c for c in consumers if c._refine_supported())
        if not refiners:
            raise ValueError(
                "refine= given but no consumer supports second-pass "
                "refinement (SparsifiedPCA with cov_path='lowrank'/"
                "lowrank_method='range', or minibatch SparsifiedKMeans)")
    if scan:
        if data is None:
            raise ValueError("scan=True stages in-memory data; source= ingest is "
                             "host-driven — drop scan=True")
        if not all(c._scannable() for c in consumers):
            raise ValueError(
                "scan=True but a consumer cannot fold inside the reference's lax.scan "
                "(batch-backend moments and Lloyd K-means retain their sketches); drop "
                "scan=True or switch those consumers to stream/minibatch/lowrank folds")

    cursor = _shared_cursor(plan, consumers, key0)
    src = None
    if data is not None:
        cursor.partial_fit(data)
    else:
        from repro_torch.stream.engine import normalize_source

        src = normalize_source(source)
        cursor.fold_source(src, steps, seed)

    run = SharedSketchRun(consumers, cursor)
    if not finalize:
        return run
    run.finalize()
    if refiners:
        passes = (plan.refine_passes or 1) if refine is True else int(refine)
        refine_mod.run_refine(plan, cursor.spec, refiners, passes, data=data, source=src,
                              steps=steps, seed=seed,
                              chunk_rows=list(cursor.chunk_rows) if data is not None else None,
                              device=cursor.device)
    return run

