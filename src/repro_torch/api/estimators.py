"""Estimator classes: fit / partial_fit / finalize over a :class:`Plan` backend.

One compression operator feeding many consumers (the paper's pitch) as one
class family: a :class:`SketchCursor` owns the ``source → sketch`` pass —
it consumes input in consecutive ``plan.batch_size`` chunks, keys chunk j's
mask with ``sketch.batch_key(spec, *plan.step_shard(j))``, sketches each
chunk EXACTLY ONCE, and fans the sketch out to every registered consumer.
Estimators are pure folders: ``_fold_sketch(s, step, shard)`` is their only
ingest point, so a lone ``fit()`` is the one-consumer case of
:func:`repro_torch.api.fit_many`'s shared pass. Each consumer's reducer hands
the folds to its plan's backend —

- ``batch``:  keep the (γ·dense) sketch, one-shot ``core.estimators``;
- ``stream``: fold constant-memory accumulator deltas
              (``stream.accumulators``, or the low-rank range-finder state)
              chunk by chunk;
- ``sharded``: keep one step's shard sketches, fold their deltas, reduce
              them with one all-reduce of the fixed-size delta over the plan's
              mesh (``stream.sharded``) and drop them. Under a multi-process
              runtime each process sketches only the shards it owns.

All fold the same per-(step, shard) sketches, so results agree to float
summation order (1e-5). The same keys, masks and folds as the reference's
``repro.api`` estimators: a state exported by either package's
``state_arrays()`` loads into the other's estimator and continues.

Estimators run on ``device`` ("cuda" by default; "cpu" on request): rows are
moved there chunk by chunk. A fit checkpoints and restores (``checkpoint`` /
``restore``, the reference's on-disk layout, so either package continues the
other's), and replays its pass to refine (``refine`` / ``fit_refine``: power
iteration for the low-rank PCA, two-pass Alg. 2 for minibatch K-means;
``repro_torch.refine``).

Fitted attributes follow the sklearn trailing-underscore convention; estimates
come back in the ORIGINAL domain (eigenvectors / means / centers unmixed by
(HD)ᵀ) unless noted.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch import lowrank as lowrank_mod
from repro_torch import refine as refine_mod
from repro_torch.api.plan import Plan
from repro_torch.cluster import bootstrap
from repro_torch.core import estimators as est
from repro_torch.core import kmeans as km
from repro_torch.core import pca as pca_mod
from repro_torch.core import sketch as sketch_mod
from repro_torch.core.grad_compress import CompressConfig, compress_grads, mask_spec
from repro_torch.core.sampling import SparseRows
from repro_torch.core.sketch import batch_key
from repro_torch.kernels import ops
from repro_torch.stream import accumulators as acc
from repro_torch.stream import sharded as sharded_mod
from repro_torch.stream import state as state_mod
from repro_torch.train import checkpoint as checkpoint_mod
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device
from repro_torch.utils.prng import fold_in_str
from repro_torch.utils.tree import tree_map

def as_key(key) -> np.ndarray:
    """Accept an int seed or threefry key data (uint32[2]) — the one
    key-normalization point."""
    if isinstance(key, (int, np.integer)):
        return prng.PRNGKey(int(key))
    return np.asarray(key, dtype=np.uint32)


def torch_dtype(dtype) -> torch.dtype:
    """``Plan.dtype`` ("float32", a numpy or a torch dtype) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _rows_on(x, device, dtype) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=dtype)


# ------------------------------------------------------------ moment core ---
# The backend registry: one reduce function per ported Plan.backend, each
# mapping a reducer's folded state to (mean_pre, cov_pre | None, count).

MOMENT_BACKENDS: dict[str, "callable"] = {}


def _moment_backend(name: str):
    def register(fn):
        MOMENT_BACKENDS[name] = fn
        return fn
    return register


@_moment_backend("batch")
def _reduce_batch(r: "_MomentReducer"):
    s_all = r.concat()
    mean = est.mean_estimator(s_all, impl=r.plan.impl)
    cov = est.cov_estimator(s_all, path=r.plan.cov_path) if r.track_cov else None
    return mean, cov, torch.tensor(s_all.n, dtype=torch.int32)


@_moment_backend("stream")
def _reduce_stream(r: "_MomentReducer"):
    st = r.state
    if int(st.count) == 0:
        raise RuntimeError("no batches folded yet — call fit()/partial_fit() first")
    cov = acc.moment_finalize_cov(st, r.spec.m) if r.track_cov else None
    return acc.moment_finalize_mean(st, r.spec.m), cov, st.count


@_moment_backend("sharded")
def _reduce_sharded(r: "_MomentReducer"):
    r.flush_step()  # a trailing partial step still needs its all-reduce
    return _reduce_stream(r)


def _sharded_mesh(plan: Plan) -> bootstrap.Mesh:
    """The mesh the sharded backend reduces over: ``plan.resolve_mesh()``;
    under a multi-process runtime the process mesh (each process owns a
    contiguous block of shard positions) whatever ``plan.mesh`` says."""
    if bootstrap.is_multiprocess():
        return bootstrap.process_mesh(plan.n_shards, plan.axis)
    return plan.resolve_mesh()


class _MomentReducer:
    """Backend-dispatched reduction of sketched batches to (mean, cov, count).

    ``fold`` ingests one per-(step, shard) sketch; ``reduce`` dispatches
    through :data:`MOMENT_BACKENDS` for the Thm-4 / Thm-6 estimates. Only the
    "batch" backend (and Lloyd K-means, which passes ``keep_sketch=True``
    because Alg. 1 clusters the retained sketch) holds sketches past their
    chunk; "stream" folds each into the constant-memory accumulator;
    "sharded" keeps ONE step's shard sketches, folds their deltas, reduces
    them with one all-reduce of the fixed-size delta and drops them, so host
    memory stays constant in the stream length. With ``cov_path="lowrank"``
    the O(rank·p) range-finder state (or, with ``lowrank_method="fd"``, the
    Frequent-Directions sketch, folded in (step, shard) order on every
    backend) replaces the (p, p) accumulator.
    """

    def __init__(self, plan: Plan, spec: sketch_mod.SketchSpec, track_cov: bool,
                 keep_sketch: bool = False, needs_moments: bool = True, device="cpu"):
        self.plan, self.spec, self.track_cov = plan, spec, track_cov
        self.lowrank = plan.cov_path == "lowrank" and track_cov and needs_moments
        self.keep_sketch = keep_sketch or (plan.backend == "batch" and needs_moments
                                           and not self.lowrank)
        self.parts: list[SparseRows] = []
        self._step_parts: list[SparseRows] = []  # sharded: the in-flight step
        self._omega = None
        if self.lowrank:
            if plan.rank > spec.p_pad:
                raise ValueError(f"rank={plan.rank} exceeds p_pad={spec.p_pad}; "
                                 "a low-rank sketch must be narrower than p")
            if plan.lowrank_method == "range":
                self._omega = lowrank_mod.omega(spec.key, spec.p_pad, plan.rank, device=device)
                self.state = lowrank_mod.range_init(spec.p_pad, plan.rank, device=device)
            else:
                self.state = lowrank_mod.fd_init(spec.p_pad, plan.rank, device=device)
        else:
            # moment state only where reduce() will read it (K-means never does)
            self.state = (acc.moment_init(spec.p_pad, track_cov=track_cov, device=device)
                          if plan.backend in ("stream", "sharded") and needs_moments else None)

    @property
    def _moment_cov_path(self) -> str:
        # mean-only folds under cov_path="lowrank" use the dense delta
        return "dense" if self.plan.cov_path == "lowrank" else self.plan.cov_path

    def fold(self, s: SparseRows, step: int, shard: int) -> None:
        if self.lowrank and self.plan.lowrank_method == "fd":
            self.state = lowrank_mod.fd_update(self.state, s, impl=self.plan.impl)
        elif self.plan.backend == "sharded" and (self.lowrank or self.state is not None):
            self._step_parts.append(s)
            if shard == self.plan.n_shards - 1:
                self.flush_step()
        elif self.lowrank:
            self.state = lowrank_mod.range_update(self.state, s, self._omega,
                                                  impl=self.plan.impl)
        elif self.state is not None:
            self.state = est.stream_update(self.state, s, cov_path=self._moment_cov_path,
                                           impl=self.plan.impl)
        if self.keep_sketch:
            self.parts.append(s)

    def flush_step(self) -> None:
        """Sharded: reduce the buffered step with one all-reduced delta, then
        drop it. Under a multi-process runtime each process buffered only its
        own shards; every process must reach this flush once a step, in step
        order (the cursor's multi-process loop drives it)."""
        if not self._step_parts:
            return
        mesh = _sharded_mesh(self.plan)
        parts, self._step_parts = self._step_parts, []
        if self.lowrank:
            delta = sharded_mod.sharded_lowrank(parts, self._omega, mesh, (self.plan.axis,),
                                                impl=self.plan.impl)
            self.state = lowrank_mod.range_apply(self.state, delta)
        else:
            delta = sharded_mod.sharded_moments(parts, mesh, (self.plan.axis,),
                                                track_cov=self.track_cov,
                                                cov_path=self._moment_cov_path,
                                                impl=self.plan.impl)
            self.state = acc.moment_apply(self.state, delta)

    def concat(self) -> SparseRows:
        if not self.parts:
            raise RuntimeError("no batches folded yet — call fit()/partial_fit() first")
        return _concat_sparse(self.parts, self.spec.p_pad)

    def reduce(self):
        """(mean_pre, cov_pre | LowRankCov | None, count) via the plan's backend."""
        if not self.lowrank:
            return MOMENT_BACKENDS[self.plan.backend](self)
        self.flush_step()  # a trailing partial step still needs its all-reduce
        st = self.state
        if int(st.count) == 0:
            raise RuntimeError("no batches folded yet — call fit()/partial_fit() first")
        if self.plan.lowrank_method == "fd":
            return (lowrank_mod.fd_finalize_mean(st, self.spec.m),
                    lowrank_mod.fd_finalize(st, self.spec.m), st.count)
        return (lowrank_mod.range_finalize_mean(st, self.spec.m),
                lowrank_mod.range_finalize(st, self.spec.m, self._omega), st.count)


def _concat_sparse(parts: list[SparseRows], p: int) -> SparseRows:
    return SparseRows(torch.cat([s.values for s in parts]),
                      torch.cat([s.indices for s in parts]), p)


# ------------------------------------------------------------ the cursor ----


class SketchCursor:
    """The shared ``source → sketch`` pass: ONE sketch per (step, shard) chunk.

    The cursor owns spec derivation from (plan, key), the chunk counter that
    maps consecutive ``plan.batch_size`` chunks to (step, shard) mask keys, and
    the ``sketch_mod.sketch`` call, and fans each sketch out to every
    registered consumer's ``_consume``.

    ``partial_fit`` / ``fold_source`` hold a lock for the whole call, so
    concurrent producers serialize and chunk indices are assigned in lock
    order; ``finalize`` is not guarded (quiesce producers first).
    """

    def __init__(self, plan: Plan, key, device="cuda"):
        self.plan = plan
        self.key = as_key(key)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self.spec: sketch_mod.SketchSpec | None = None
        self.chunk = 0           # linear chunk index → plan.step_shard(chunk)
        self.count = 0           # rows folded through this cursor
        self.chunk_rows: list[int] = []  # rows per chunk — the replay contract
        self.n_sketches = 0      # sketch_mod.sketch invocations (one per chunk)
        self.last_sketch: SparseRows | None = None
        self.consumers: list["SketchedEstimator"] = []

    def register(self, consumer: "SketchedEstimator") -> None:
        self.consumers.append(consumer)
        if self.spec is not None:
            consumer._bind_spec(self.spec)

    def ensure_spec(self, p: int) -> sketch_mod.SketchSpec:
        if self.spec is None:
            self.spec = self.plan.spec(p, self.key)
            for c in self.consumers:
                c._bind_spec(self.spec)
        elif self.spec.p != p:
            raise ValueError(
                f"batch has p={p}, but this pass was started with "
                f"p={self.spec.p}; start a new fit (estimator.fit/reset, or a "
                "fresh fit_many) to change dimensionality")
        return self.spec

    def fold_rows(self, rows: torch.Tensor) -> None:
        """Sketch one ≤batch_size chunk (on the device) under its (step,
        shard) mask key and hand the SAME SparseRows to every consumer."""
        step, shard = self.plan.step_shard(self.chunk)
        s = sketch_mod.sketch(rows, self.spec, batch_key=batch_key(self.spec, step, shard),
                              impl=self.plan.impl)
        self.n_sketches += 1
        self.last_sketch = s
        n = int(rows.shape[0])
        for c in self.consumers:
            c._consume(s, step, shard, n)
        self.chunk += 1
        self.count += n
        self.chunk_rows.append(n)

    def partial_fit(self, x) -> None:
        """Fold the rows of ``x`` (numpy or torch, on any device), moved to
        the device one chunk at a time."""
        if not torch.is_tensor(x):
            x = np.asarray(x)
        if x.ndim != 2:
            raise ValueError(f"expected (rows, p) data, got shape {tuple(x.shape)}")
        dtype = torch_dtype(self.plan.dtype)
        with self._lock:
            self.ensure_spec(int(x.shape[1]))
            bs = self.plan.batch_size
            for i in range(0, x.shape[0], bs):
                self.fold_rows(_rows_on(x[i:i + bs], self.device, dtype))

    def position(self) -> dict:
        """Where the pass stands — p, the chunk counter, rows, sketches and
        rows per chunk — as a checkpoint's JSON ``extra`` records it."""
        return {"p": int(self.spec.p), "chunk": self.chunk, "count": self.count,
                "n_sketches": self.n_sketches, "chunk_rows": list(self.chunk_rows)}

    def resume(self, extra: dict) -> None:
        """Bind the spec and continue at a recorded :meth:`position`."""
        self.ensure_spec(int(extra["p"]))
        self.chunk = int(extra["chunk"])
        self.count = int(extra["count"])
        self.n_sketches = int(extra["n_sketches"])
        self.chunk_rows = [int(r) for r in extra["chunk_rows"]]

    def sync(self) -> None:
        """Block until the last folded chunk's sketch is computed — the ingest
        barrier to time the fold pass against."""
        if self.last_sketch is not None and self.last_sketch.values.is_cuda:
            torch.cuda.synchronize(self.last_sketch.values.device)

    def fold_source(self, source, steps: int, seed: int | None = None) -> None:
        """One pass over a normalized ``(seed, step, shard) → (b, p)`` source
        (the StreamEngine contract): each (step, shard) batch is folded under
        exactly that (step, shard) mask key.

        Under a multi-process runtime with the sharded backend, each process
        generates and sketches ONLY the shards it owns; the per-step
        reduction then all-reduces across processes.
        """
        dtype = torch_dtype(self.plan.dtype)
        with self._lock:
            if bootstrap.is_multiprocess() and self.plan.backend == "sharded":
                self._fold_source_multiprocess(source, steps, seed, dtype)
                return
            for step in range(steps):
                for shard in range(self.plan.n_shards):
                    rows = _rows_on(source(seed, step, shard), self.device, dtype)
                    self.ensure_spec(int(rows.shape[1]))
                    self.fold_rows(rows)

    def _fold_source_multiprocess(self, source, steps: int, seed, dtype) -> None:
        """This process's slice of the shared (step, shard) grid: fold the
        shards it owns, skip the rest (their chunk indices still advance —
        the mask-key discipline is global), and drive every consumer's step
        flush so all processes enter each step's all-reduce exactly once, in
        step order."""
        for i, c in enumerate(self.consumers):
            why = c._multiprocess_unsupported()
            if why:
                raise ValueError(f"consumers[{i}] ({type(c).__name__}) cannot fold under a "
                                 f"multi-process runtime: {why}")
        mine = set(bootstrap.local_shards(_sharded_mesh(self.plan), self.plan.axis))
        # data-dependent inits (minibatch K-means' K-means++ seeding) must be
        # bit-identical on every process: all of them sketch chunk (0, 0)
        s0 = None
        for c in self.consumers:
            if c._needs_first_sketch():
                if s0 is None:
                    rows0 = _rows_on(source(seed, 0, 0), self.device, dtype)
                    self.ensure_spec(int(rows0.shape[1]))
                    s0 = sketch_mod.sketch(rows0, self.spec,
                                           batch_key=batch_key(self.spec, 0, 0),
                                           impl=self.plan.impl)
                c._seed_first_sketch(s0)
        for step in range(steps):
            for shard in range(self.plan.n_shards):
                if shard in mine:
                    rows = _rows_on(source(seed, step, shard), self.device, dtype)
                    self.ensure_spec(int(rows.shape[1]))
                    self.fold_rows(rows)
                else:
                    # the chunk happened on another process: its index must
                    # advance; its rows are not held here (0)
                    self.chunk += 1
                    self.chunk_rows.append(0)
            for c in self.consumers:
                c._step_flush()


# -------------------------------------------------------------- base class --


class SketchedEstimator:
    """Shared fit / partial_fit / finalize plumbing — a pure sketch FOLDER.

    Sketching lives in :class:`SketchCursor`; the estimator's only ingest
    point is ``_fold_sketch(s, step, shard)``, called by whichever cursor it
    is registered on (its own by default, a shared one under
    :func:`repro_torch.api.fit_many`). Subclasses set ``_track_cov`` /
    ``_keep_sketch`` and implement ``_finalize()`` from the reducer.
    ``fit(X)`` = reset → partial_fit(X) → finalize; a stream fed in
    batch_size pieces reproduces ``fit`` of the concatenation exactly.
    """

    _track_cov = False
    _keep_sketch = False
    _needs_moments = True  # False when _finalize never calls reducer.reduce()

    def __init__(self, plan: Plan, key=0, *, device="cuda"):
        self.plan = plan
        self.key = as_key(key)
        self.device = resolve_device(device)
        # the covariance product must be full fp32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        self.reset()

    # ------------------------------------------------------------ lifecycle --

    def reset(self) -> "SketchedEstimator":
        """Drop all folded state (spec is re-derived at the next first batch)
        and detach from any shared cursor: a fresh one-consumer cursor takes
        over, so a still-live SharedSketchRun can't fold into reset state."""
        old = getattr(self, "_cursor", None)
        if old is not None and self in old.consumers:
            old.consumers.remove(self)
        self.spec_: sketch_mod.SketchSpec | None = None
        self._reducer: _MomentReducer | None = None
        self.count_ = 0
        self._fitted = False
        self._cursor = SketchCursor(self.plan, self.key, self.device)
        self._cursor.register(self)
        return self

    def _bind_spec(self, spec: sketch_mod.SketchSpec) -> None:
        """Cursor callback: the spec exists — allocate the reducer."""
        self.spec_ = spec
        self._reducer = _MomentReducer(self.plan, spec, self._track_cov,
                                       keep_sketch=self._keep_sketch,
                                       needs_moments=self._needs_moments, device=self.device)
        self._on_spec(spec)

    def _on_spec(self, spec: sketch_mod.SketchSpec) -> None:
        """Subclass hook: validate the spec once it exists (e.g. m >= 2)."""

    def partial_fit(self, x) -> "SketchedEstimator":
        """Fold more rows. Under a shared cursor (fit_many) this extends the
        shared pass — every co-registered consumer folds the same sketches."""
        self._cursor.partial_fit(x)
        return self

    def sync(self) -> "SketchedEstimator":
        """Block until this estimator's ingest is computed on the device."""
        self._cursor.sync()
        return self

    def _consume(self, s: SparseRows, step: int, shard: int, n_rows: int) -> None:
        self._fold_sketch(s, step, shard)
        self.count_ += n_rows

    def _fold_sketch(self, s: SparseRows, step: int, shard: int) -> None:
        self._reducer.fold(s, step, shard)

    def _scannable(self) -> bool:
        """Whether the reference's ``scan=True`` takes this consumer: its
        fold streams (stream moments, the low-rank range state, minibatch
        K-means); retained sketches (batch moments, Lloyd) and the sharded
        backend's collectives do not (FD folds the same on every backend)."""
        if self._keep_sketch:
            return False
        if self.plan.cov_path == "lowrank" and self._track_cov and self._needs_moments:
            return self.plan.lowrank_method == "fd" or self.plan.backend != "sharded"
        return self._needs_moments and self.plan.backend == "stream"

    # Hooks for SketchCursor._fold_source_multiprocess: each process folds
    # only its own shards, so consumers must (a) reduce through per-step
    # collectives (the sharded backend), (b) flush when the cursor says the
    # step ended, and (c) run data-dependent inits from a sketch every process
    # regenerated identically.

    def _multiprocess_unsupported(self) -> str | None:
        """None when this consumer can fold under a multi-process runtime,
        else the reason it cannot."""
        if self.plan.backend != "sharded":
            return (f"backend={self.plan.backend!r} folds in one process — only "
                    "the sharded backend reduces across processes")
        if self._keep_sketch:
            return ("it retains its sketches (batch moments / Lloyd K-means); "
                    "a process's buffer would hold only its own shards")
        if (self.plan.cov_path == "lowrank" and self._track_cov and self._needs_moments
                and self.plan.lowrank_method == "fd"):
            return ("Frequent Directions is an order-dependent sequential fold — "
                    "its shrink cannot be all-reduced across processes")
        return None

    def _needs_first_sketch(self) -> bool:
        return False

    def _seed_first_sketch(self, s0: SparseRows) -> None:
        """Run a data-dependent init from chunk (0, 0)'s sketch (regenerated
        identically on every process)."""

    def _step_flush(self) -> None:
        """Cursor-driven step boundary: enter this step's all-reduce (once a
        process a step)."""
        if self._reducer is not None:
            self._reducer.flush_step()

    def fit(self, x) -> "SketchedEstimator":
        self.reset()
        self.partial_fit(x)
        return self.finalize()

    def fit_stream(self, source, steps: int, seed: int | None = None) -> "SketchedEstimator":
        """One pass over a ``(seed, step, shard) → (b, p)`` source (the
        ``data.pipeline`` / StreamEngine contract)."""
        from repro_torch.stream.engine import normalize_source

        self.reset()
        self._cursor.fold_source(normalize_source(source), steps, seed)
        return self.finalize()

    def finalize(self) -> "SketchedEstimator":
        if self.spec_ is None:
            raise RuntimeError("no batches folded yet — call fit()/partial_fit() first")
        self._finalize()
        self._fitted = True
        return self

    def _finalize(self) -> None:
        raise NotImplementedError

    # ---------------------------------------------------------- refinement --
    # Second-pass replay refinement (repro_torch.refine): subclasses that
    # support it override _refine_supported/_refine_check and the _refine_*
    # fold hooks of repro_torch.refine.replay; the base class owns refine().

    def _refine_supported(self) -> bool:
        return False

    def _refine_check(self) -> None:
        raise ValueError(
            f"{type(self).__name__} has no second-pass refinement: its "
            "estimator is already exact given the sketch (nothing a replay "
            "could sharpen). fit_refine applies to SparsifiedPCA on the "
            "lowrank 'range' path and to minibatch SparsifiedKMeans")

    def _refine_needs_signal(self) -> bool:
        return False

    def _refine_metric(self) -> float:
        """The latest pass's convergence measurement (smaller = settled),
        read by the ``tol=`` loop."""
        raise NotImplementedError

    def _refine_tol_check(self) -> None:
        """Subclass hook: reject ``tol=`` when the convergence signal is off."""

    def _resolve_passes(self, passes: int | None) -> int:
        if passes is None:
            passes = self.plan.refine_passes or 1
        if passes < 1:
            raise ValueError(f"refinement needs passes >= 1, got {passes}")
        return int(passes)

    def refine(self, x=None, passes: int | None = None, *, tol: float | None = None,
               max_passes: int = 16, source=None, steps: int | None = None,
               seed: int | None = None) -> "SketchedEstimator":
        """Replay the FITTED pass more times and sharpen the fit.

        ``x`` must be the array ``fit`` consumed (re-chunked at the cursor's
        recorded boundaries and re-masked identically; the row count is
        checked), or ``source`` / ``steps`` / ``seed`` the stream
        ``fit_stream`` pulled. ``passes`` defaults to ``plan.refine_passes``
        (or 1). Repeat calls resume: ``refine(x); refine(x)`` ≡
        ``refine(x, passes=2)``, with ``refine_passes_`` accumulating.

        ``tol=`` refines until converged instead: single resuming passes run
        until the per-pass measurement — ``refine_subspace_change_[-1]`` for
        PCA, ``refine_reassign_fraction_[-1]`` for minibatch K-means (which
        needs ``track_reassignments=True``) — drops to ``tol`` or
        ``max_passes`` is reached; ``refine_converged_`` says which.
        """
        self._refine_check()
        if not self._fitted:
            raise RuntimeError("refine() replays a fitted estimator — call "
                               "fit()/fit_stream() first, or use fit_refine()")
        if tol is not None:
            if passes is not None:
                raise ValueError("pass a fixed passes= OR an adaptive tol=, not both")
            if tol <= 0:
                raise ValueError(f"tol must be > 0, got {tol}")
            if max_passes < 1:
                raise ValueError(f"max_passes must be >= 1, got {max_passes}")
            self._refine_tol_check()
        chunk_rows = None
        if x is not None:
            n = int((x if torch.is_tensor(x) else np.asarray(x)).shape[0])
            if n != self.count_:
                raise ValueError(
                    f"refine(x) got {n} rows but the fitted pass folded "
                    f"{self.count_}; the replay must regenerate the SAME "
                    "chunks — pass the array fit() consumed")
            chunk_rows = list(self._cursor.chunk_rows)
        src = None
        if source is not None:
            from repro_torch.stream.engine import normalize_source

            src = normalize_source(source)
        kw = dict(data=x, source=src, steps=steps, seed=seed, chunk_rows=chunk_rows,
                  device=self.device)
        if tol is None:
            refine_mod.run_refine(self.plan, self.spec_, [self], self._resolve_passes(passes),
                                  **kw)
            return self
        # one resuming pass at a time, watching the convergence measurement
        self.refine_converged_ = False
        for _ in range(int(max_passes)):
            refine_mod.run_refine(self.plan, self.spec_, [self], 1, **kw)
            if self._refine_metric() <= tol:
                self.refine_converged_ = True
                break
        return self

    def fit_refine(self, x=None, passes: int | None = None, *, tol: float | None = None,
                   max_passes: int = 16, source=None, steps: int | None = None,
                   seed: int | None = None) -> "SketchedEstimator":
        """One-pass fit, then replay refinement (see :meth:`refine`): an
        in-memory ``x`` is fit then re-chunked a pass; a ``source`` is
        streamed once then replayed a pass."""
        self._refine_check()
        if (x is None) == (source is None):
            raise ValueError("fit_refine needs exactly one of x or source=")
        if x is not None:
            self.fit(x)
        else:
            if steps is None:
                raise ValueError("fit_refine(source=...) needs steps=")
            self.fit_stream(source, steps=steps, seed=seed)
        return self.refine(x, passes, tol=tol, max_passes=max_passes, source=source,
                           steps=steps, seed=seed)

    # ------------------------------------------------------------- utility --

    def sketch(self, x, mask_key=None) -> SparseRows:
        """The compression operator applied to new rows.

        On a fitted (or fitting) estimator this uses the fitted spec; on a
        fresh one, a THROWAWAY spec is derived from (plan, key) for this call
        only. ``mask_key=None`` reuses the spec's one-shot mask key (repeated
        calls sample the same coordinates of equal inputs); an int is folded
        into the spec's mask key, and key data is used as it is.
        """
        x = _rows_on(x, self.device, torch_dtype(self.plan.dtype))
        spec = self.spec_ if self.spec_ is not None else self.plan.spec(x.shape[-1], self.key)
        if mask_key is None:
            bk = None
        elif isinstance(mask_key, (int, np.integer)):
            bk = prng.fold_in(spec.mask_key(), int(mask_key))
        else:
            bk = np.asarray(mask_key, dtype=np.uint32)
        return sketch_mod.sketch(x, spec, batch_key=bk, impl=self.plan.impl)

    def _unmix(self, w_pre: torch.Tensor) -> torch.Tensor:
        return sketch_mod.unmix_dense(w_pre, self.spec_, impl=self.plan.impl)

    def _unmix_vec(self, v_pre: torch.Tensor) -> torch.Tensor:
        return self._unmix(v_pre[None, :])[0]

    # ------------------------------------------------------------ snapshot --
    # Everything a restarted process needs to continue THIS estimator's ingest,
    # as a flat {name: np.ndarray} dict in the reference's wire format
    # (stream.state.to_arrays). The spec re-derives from (plan, key, p);
    # import targets an estimator whose spec is already bound.

    def state_arrays(self) -> dict:
        r = self._reducer
        if r is None:
            raise RuntimeError("nothing folded yet — nothing to export")
        if r._step_parts:
            raise RuntimeError(
                "a sharded reducer is mid-step (buffered shard sketches not yet "
                "all-reduced); ingest to a step boundary before snapshotting")
        out: dict = {"count": np.int64(self.count_)}
        if r.state is not None:
            out.update(state_mod.to_arrays(r.state))
        if r.parts:            # retained sketches (batch moments / Lloyd)
            out["parts.values"] = torch.cat([s.values for s in r.parts]).cpu().numpy()
            out["parts.indices"] = torch.cat([s.indices for s in r.parts]).cpu().numpy()
            out["parts.rows"] = np.array([s.n for s in r.parts], np.int64)
        return out

    def load_state_arrays(self, arrs: dict) -> None:
        if self.spec_ is None:
            raise RuntimeError("bind the spec (cursor.ensure_spec) before "
                               "importing snapshot state")
        r = self._reducer
        self.count_ = int(arrs["count"])
        # the reducer holds a moment, range or fd state; the km kind belongs
        # to SparsifiedKMeans' own slot (its override loads it)
        st = state_mod.from_arrays(arrs, device=self.device, kinds=("moment", "range", "fd"))
        if st is not None:
            r.state = st
        if "parts.values" in arrs:
            values = torch.as_tensor(np.array(arrs["parts.values"]), device=self.device)
            indices = torch.as_tensor(np.array(arrs["parts.indices"]), device=self.device)
            r.parts = []
            i = 0
            for n in np.asarray(arrs["parts.rows"]).tolist():
                r.parts.append(SparseRows(values[i:i + n], indices[i:i + n], self.spec_.p_pad))
                i += n

    # Checkpoint/restore: the fold state plus the cursor counters, through
    # train.checkpoint. restore() rebinds the spec from (plan, key, p) and
    # resumes the chunk cursor, so partial_fit after restore() continues the
    # interrupted pass bit for bit.

    def checkpoint(self, ckpt_dir: str, *, keep_last: int = 3) -> "SketchedEstimator":
        """Write the fold state and the ingest cursor to ``ckpt_dir`` (atomic)."""
        if self.spec_ is None:
            raise RuntimeError("nothing folded yet — nothing to checkpoint")
        cur = self._cursor
        checkpoint_mod.save_arrays(ckpt_dir, cur.chunk, self.state_arrays(),
                                   extra=cur.position(), keep_last=keep_last)
        return self

    def restore(self, ckpt_dir: str) -> "SketchedEstimator":
        """Reset, rebind the spec, and load the latest checkpoint under
        ``ckpt_dir`` (either package's): ingest continues where it stopped."""
        arrs, extra = checkpoint_mod.load_arrays(ckpt_dir)
        self.reset()
        self._cursor.resume(extra)
        self.load_state_arrays(arrs)
        return self


# ----------------------------------------------------------- the estimators --


class SparsifiedMean(SketchedEstimator):
    """Thm-4 unbiased mean from the sketch alone.

    Fitted: ``mean_`` (p, original domain), ``mean_pre_`` (p_pad,
    preconditioned domain), ``count_``.
    """

    _track_cov = False

    def _finalize(self) -> None:
        mean_pre, _, n = self._reducer.reduce()
        self.mean_pre_ = mean_pre
        self.mean_ = self._unmix_vec(mean_pre)
        self.count_ = int(n)


class SparsifiedCov(SketchedEstimator):
    """Thm-6 unbiased covariance (uncentered second moment) from the sketch.

    Fitted: ``cov_`` ((p_pad, p_pad), PRECONDITIONED domain — the spectrum
    equals the original's since HD is orthonormal), ``mean_pre_``, ``mean_``,
    ``count_``. Use :meth:`cov_original` for the (p, p) original-domain matrix.
    """

    _track_cov = True

    def _on_spec(self, spec: sketch_mod.SketchSpec) -> None:
        if spec.m < 2:
            raise ValueError(f"covariance needs m >= 2 (Thm B4), got m={spec.m}; "
                             "raise gamma/m")
        if self.plan.cov_path == "lowrank":
            raise ValueError(
                "cov_path='lowrank' is a PCA-only factored path (it never forms "
                "the (p, p) matrix this estimator returns); use SparsifiedPCA, "
                "or cov_path='dense'/'compact' for the full covariance")

    def _finalize(self) -> None:
        mean_pre, cov_pre, n = self._reducer.reduce()
        self.mean_pre_ = mean_pre
        self.mean_ = self._unmix_vec(mean_pre)
        self.cov_ = cov_pre
        self.count_ = int(n)

    def cov_original(self) -> torch.Tensor:
        """(p, p) covariance in the original domain: (HD)ᵀ Ĉ_pre (HD) — two
        unmixes of p_pad rows (K2 up to p_pad = 2^15, K3 above)."""
        c1 = self._unmix(self.cov_)                 # rows still pre-domain
        return self._unmix(c1.T)


class SparsifiedPCA(SketchedEstimator):
    """Principal components from the sketched covariance (paper §V).

    With ``Plan(cov_path="lowrank", rank=l)`` the (p, p) covariance accumulator
    ``fit/finalize`` contract, and the factored eigenmodel is kept on
    ``cov_lowrank_``. Pick l ≥ 4·n_components ("range" finalizes l/2
    eigenpairs from the 2×-oversampled sketch; "fd" finalizes all l).

    Fitted: ``components_`` ((n_components, p), original domain, rows are PCs),
    ``explained_variance_`` (eigenvalues, descending), ``mean_``, ``count_``,
    ``cov_lowrank_`` (:class:`repro_torch.lowrank.LowRankCov` | None), and
    after :meth:`refine` ``refine_passes_`` and ``refine_subspace_change_``
    ((passes,) largest principal-angle sine between consecutive power bases).
    """

    _track_cov = True

    def __init__(self, n_components: int, plan: Plan, key=0, *, device="cuda"):
        self.n_components = int(n_components)
        super().__init__(plan, key, device=device)

    def _on_spec(self, spec: sketch_mod.SketchSpec) -> None:
        if spec.m < 2:
            raise ValueError(f"PCA needs m >= 2 (Thm B4 covariance), got m={spec.m}")
        if self.plan.cov_path == "lowrank":
            model_rank = (self.plan.rank // 2 if self.plan.lowrank_method == "range"
                          else self.plan.rank)
            if self.n_components > model_rank:
                raise ValueError(
                    f"n_components={self.n_components} exceeds the rank-{model_rank} "
                    f"eigenmodel of a rank={self.plan.rank} "
                    f"{self.plan.lowrank_method!r} sketch; raise Plan.rank "
                    f"(l ≥ 4·n_components recommended)")

    def _finalize(self) -> None:
        mean_pre, cov_pre, n = self._reducer.reduce()
        if isinstance(cov_pre, lowrank_mod.LowRankCov):
            self.cov_lowrank_ = cov_pre
            comps_pre, evals = cov_pre.top(self.n_components)
        else:
            self.cov_lowrank_ = None
            comps_pre, evals = pca_mod._top_eig(cov_pre, self.n_components)
        self.components_ = self._unmix(comps_pre)
        self.explained_variance_ = evals
        self.mean_ = self._unmix_vec(mean_pre)
        self.count_ = int(n)
        self.refine_passes_ = 0           # refine() overwrites after its replay
        self.refine_subspace_change_ = None

    def transform(self, x) -> torch.Tensor:
        """Project rows onto the fitted components (original domain, uncentered
        — the paper's convention)."""
        return _rows_on(x, self.device, torch_dtype(self.plan.dtype)) @ self.components_.T

    def result(self) -> pca_mod.PCAResult:
        return pca_mod.PCAResult(self.components_, self.explained_variance_, self.mean_)

    # ---------------------------------------------------------- refinement --
    # Power iteration against the regenerable source (repro_torch.refine.power):
    # each pass replays every (step, shard) sketch and accumulates Y = S·Q
    # through the same RangeState delta as the first pass (K5/K6, Q in Ω's
    # place; sharded: one all-reduce of the fixed-size delta a step).

    def _refine_supported(self) -> bool:
        return self.plan.cov_path == "lowrank" and self.plan.lowrank_method == "range"

    def _refine_check(self) -> None:
        if self.plan.cov_path != "lowrank":
            raise ValueError(
                "fit_refine sharpens the lowrank range-finder's subspace; "
                f"cov_path={self.plan.cov_path!r} accumulates the full "
                "covariance exactly, so its eigendecomposition has no "
                "refinement gap — use Plan(cov_path='lowrank', rank=l)")
        if self.plan.lowrank_method != "range":
            raise ValueError(
                "lowrank_method='fd' has no replayable linear operator (the "
                "SVD-shrink fold is order-dependent); power-iteration "
                "refinement needs lowrank_method='range'")

    def _refine_pass_begin(self, f: int) -> None:
        if f == 0 and not self.refine_passes_:
            # the first basis is orth of the already-folded first-pass state;
            # a repeat refine() resumes from self._rq instead
            self._rq = refine_mod.power_orth(self._reducer.state, self._reducer._omega,
                                             self.spec_.m)
            self._rchanges: list[float] = []
        self._rstate = lowrank_mod.range_init(self.spec_.p_pad, self.plan.rank,
                                              device=self.device)
        self._rstep_parts: list[SparseRows] = []

    def _refine_fold(self, s: SparseRows, step: int, shard: int) -> None:
        if self.plan.backend == "sharded":
            self._rstep_parts.append(s)
            if shard == self.plan.n_shards - 1:
                self._refine_flush()
        else:
            self._rstate = lowrank_mod.range_update(self._rstate, s, self._rq,
                                                    impl=self.plan.impl)

    def _refine_flush(self) -> None:
        if not self._rstep_parts:
            return
        parts, self._rstep_parts = self._rstep_parts, []
        delta = sharded_mod.sharded_lowrank(parts, self._rq, _sharded_mesh(self.plan),
                                            (self.plan.axis,), impl=self.plan.impl)
        self._rstate = lowrank_mod.range_apply(self._rstate, delta)

    def _refine_pass_end(self, f: int, last: bool, signal: bool) -> None:
        self._refine_flush()
        q_new = refine_mod.power_orth(self._rstate, self._rq, self.spec_.m)
        # watched on the top-n_components columns, the subspace kept
        r = self.n_components
        self._rchanges.append(refine_mod.subspace_change(q_new[:, :r], self._rq[:, :r]))
        self._rq_prev, self._rq = self._rq, q_new

    def _refine_end(self, passes: int) -> None:
        self.cov_lowrank_ = refine_mod.power_finalize(self._rstate, self._rq_prev, self.spec_.m)
        comps_pre, evals = self.cov_lowrank_.top(self.n_components)
        self.components_ = self._unmix(comps_pre)
        self.explained_variance_ = evals
        self.refine_passes_ += passes    # cumulative across repeat refine()s
        self.refine_subspace_change_ = np.asarray(self._rchanges)

    def _refine_metric(self) -> float:
        return float(self.refine_subspace_change_[-1])


class SparsifiedKMeans(SketchedEstimator):
    """Sparsified K-means over any backend.

    algorithm="lloyd" (default, paper Alg. 1): the sketch — the γ-compressed
    dataset — is retained, and full Lloyd (``core.kmeans.sparse_kmeans_core``,
    its distances by K4 through ``kernels.ops.kernel_assign_fn``, its center
    update by K6's walk; under the sharded backend the same solver through
    ``stream.sharded.sharded_kmeans``) runs at finalize, bit-reproducible on
    the card. Fitted ``labels_`` covers every row folded.

    algorithm="minibatch": the constant-memory streaming accumulators of
    ``stream.accumulators`` (online Eq. 39 update, r = n_init parallel
    hypotheses); every shard's delta is taken against the step-start state
    and applied once a step, as the StreamEngine does (sharded: the step's
    shard sketches reduced by ``stream.sharded.sharded_kmeans_step``, one
    all-reduce of the fixed-size delta). ``labels_`` is None
    (use :meth:`predict`). ``decay`` < 1 shrinks the accumulated counts once a
    step (a forgetting factor); unless ``track_reassignments=False``, each
    step's rows are re-assigned under the post-update centers (K4), and the
    per-step counts of label changes (best hypothesis) land on
    ``reassign_counts_`` / ``reassign_fraction_``.

    Fitted: ``centers_`` ((k, p), original domain), ``centers_pre_``,
    ``objective_``, ``labels_``, ``n_iter_`` (lloyd), ``count_``,
    ``reassign_counts_`` / ``reassign_fraction_`` ((steps,) arrays; minibatch),
    and after :meth:`refine` (minibatch, undecayed: two-pass Alg. 2)
    ``refine_passes_`` and ``refine_reassign_counts_`` /
    ``refine_reassign_fraction_`` (rows each rebuild reassigned).
    """

    _track_cov = False
    _needs_moments = False  # centers come from the solver, not Thm-4/6

    def __init__(self, k: int, plan: Plan, key=0, *, n_init: int = 3, max_iter: int = 100,
                 tol: float = 1e-6, algorithm: str = "lloyd", decay: float = 1.0,
                 track_reassignments: bool = True, device="cuda"):
        if algorithm not in ("lloyd", "minibatch"):
            raise ValueError(f"algorithm must be 'lloyd' or 'minibatch', got {algorithm!r}")
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        if decay < 1.0 and algorithm != "minibatch":
            raise ValueError("decay (forgetting) only applies to the streaming "
                             "algorithm='minibatch' accumulators")
        self.k = int(k)
        self.n_init = int(n_init)
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.algorithm = algorithm
        self.decay = float(decay)
        self.track_reassignments = bool(track_reassignments) and algorithm == "minibatch"
        self._keep_sketch = algorithm == "lloyd"  # Alg. 1 clusters the retained sketch
        super().__init__(plan, key, device=device)

    def reset(self) -> "SparsifiedKMeans":
        super().reset()
        self._km_state: acc.KMeansState | None = None
        self._km_pending = None  # summed deltas of the in-flight step
        # (sketch, pre-update labels) pairs of the in-flight step, for the
        # reassignment counts — dropped at every flush
        self._km_step_sketches: list[tuple[SparseRows, torch.Tensor]] = []
        # sharded backend: the in-flight step's shard sketches, reduced by
        # sharded_kmeans_step at each flush
        self._km_step_parts: list[SparseRows] = []
        self._reassign_history: list[tuple[np.ndarray, int]] = []
        return self

    def _scannable(self) -> bool:
        return self.algorithm == "minibatch" and self.plan.backend != "sharded"

    # --------------------------------------------------------- minibatch ----

    def _fold_sketch(self, s: SparseRows, step: int, shard: int) -> None:
        if self.algorithm == "lloyd":
            self._reducer.fold(s, step, shard)
            return
        impl = self.plan.impl
        if self._km_state is None:
            self._seed_first_sketch(s)
        if self.plan.backend == "sharded":
            self._km_step_parts.append(s)
            if shard == self.plan.n_shards - 1:
                self._flush_step()
            return
        if self.track_reassignments:
            # the pre-update labels ride along with the delta (computed once)
            d, a0 = acc.kmeans_delta_with_assign(self._km_state, s, impl=impl)
            self._km_step_sketches.append((s, a0))
        else:
            d = acc.kmeans_delta(self._km_state, s, impl=impl)
        self._km_pending = d if self._km_pending is None else acc.kmeans_add(self._km_pending, d)
        if shard == self.plan.n_shards - 1:
            self._flush_step()

    def _flush_step(self) -> None:
        if self._km_step_parts:
            parts, self._km_step_parts = self._km_step_parts, []
            old_count = int(self._km_state.count)
            new, cnt = sharded_mod.sharded_kmeans_step(
                self._km_state, parts, _sharded_mesh(self.plan), axis=self.plan.axis,
                decay=self.decay, track_reassignments=self.track_reassignments,
                impl=self.plan.impl)
            self._km_state = new
            if self.track_reassignments:
                self._reassign_history.append((cnt.cpu().numpy(), int(new.count) - old_count))
            return
        if self._km_pending is None:
            return
        self._km_state = acc.kmeans_apply(self._km_state, self._km_pending, decay=self.decay)
        self._km_pending = None
        if self.track_reassignments:
            counts = torch.zeros((self.n_init,), dtype=torch.int32, device=self.device)
            rows = 0
            for s, a0 in self._km_step_sketches:
                counts = counts + acc.kmeans_reassigned(self._km_state, s, a0,
                                                        impl=self.plan.impl)
                rows += s.n
            self._reassign_history.append((counts.cpu().numpy(), rows))
        self._km_step_sketches = []

    # --------------------------------------------------- multi-process fold --

    def _needs_first_sketch(self) -> bool:
        return self.algorithm == "minibatch" and self._km_state is None

    def _seed_first_sketch(self, s0: SparseRows) -> None:
        self._km_state = acc.kmeans_init(
            fold_in_str(self.spec_.key, "api-kmeans"), s0, self.k, self.n_init,
            decay=self.decay, impl=self.plan.impl)

    def _step_flush(self) -> None:
        super()._step_flush()
        self._flush_step()

    # ----------------------------------------------------------- finalize ---

    def _finalize(self) -> None:
        self.reassign_counts_ = None
        self.reassign_fraction_ = None
        impl = self.plan.impl
        if self.algorithm == "minibatch":
            self._flush_step()
            if self._km_state is None:
                raise RuntimeError("no batches folded yet — call fit()/partial_fit() first")
            centers_pre, obj = acc.kmeans_finalize(self._km_state)
            if self.track_reassignments and self._reassign_history:
                best = int(torch.argmin(self._km_state.obj))
                cnt = np.array([c[best] for c, _ in self._reassign_history])
                rows = np.array([max(r, 1) for _, r in self._reassign_history])
                self.reassign_counts_ = cnt
                self.reassign_fraction_ = cnt / rows
            self.labels_ = None
            self.n_iter_ = None
            self.count_ = int(self._km_state.count)
        else:
            s_all = self._reducer.concat()
            init_key = fold_in_str(self.spec_.key, "api-kmeans")
            if self.plan.backend == "sharded":
                centers_pre, a, obj, it = sharded_mod.sharded_kmeans(
                    s_all, self.k, init_key, _sharded_mesh(self.plan), n_init=self.n_init,
                    max_iter=self.max_iter, tol=self.tol, impl=impl)
            else:
                centers_pre, a, obj, it = km.sparse_kmeans_core(
                    s_all.values, s_all.indices, s_all.p, self.k, init_key,
                    n_init=self.n_init, max_iter=self.max_iter, tol=self.tol,
                    assign_fn=ops.kernel_assign_fn(impl), impl=impl)
            self.labels_ = a
            self.n_iter_ = int(it)
        self.centers_pre_ = centers_pre
        self.centers_ = self._unmix(centers_pre)
        self.objective_ = obj
        self.refine_passes_ = 0           # refine() overwrites after its replay
        self.refine_reassign_counts_ = None
        self.refine_reassign_fraction_ = None

    def predict(self, x) -> torch.Tensor:
        """Nearest-center labels for new rows (sketched with a one-shot mask)."""
        return acc.kmeans_assign(self.centers_pre_, self.sketch(x), impl=self.plan.impl)

    # ------------------------------------------------------------ snapshot --

    def state_arrays(self) -> dict:
        out = super().state_arrays()
        if self.algorithm == "minibatch":
            if self._km_pending is not None or self._km_step_sketches or self._km_step_parts:
                raise RuntimeError(
                    "the minibatch fold is mid-step (pending shard deltas); "
                    "ingest to a step boundary before snapshotting")
            if self._km_state is not None:
                out.update(state_mod.to_arrays(self._km_state))
            if self._reassign_history:
                out["km.reassign_counts"] = np.stack([c for c, _ in self._reassign_history])
                out["km.reassign_rows"] = np.array([r for _, r in self._reassign_history],
                                                   np.int64)
        return out

    def load_state_arrays(self, arrs: dict) -> None:
        super().load_state_arrays(arrs)
        if "km.centers" in arrs:
            self._km_state = state_mod.from_arrays(arrs, device=self.device, kinds=("km",))
        if "km.reassign_counts" in arrs:
            cnts = np.asarray(arrs["km.reassign_counts"])
            rows = np.asarray(arrs["km.reassign_rows"]).tolist()
            self._reassign_history = [(cnts[i], int(rows[i])) for i in range(len(rows))]

    # ---------------------------------------------------------- refinement --
    # Two-pass (Alg. 2) replay refinement (repro_torch.refine.kmeans2): each
    # pass re-assigns every replayed row against FROZEN pass-start centers
    # (the best first-pass hypothesis) and rebuilds the centers from those
    # assignments. The count of rows the LAST rebuild reassigned is only seen
    # one replay later, so with track_reassignments one trailing
    # measurement-only replay runs (its rebuild discarded; it also makes
    # objective_ the objective of the final centers).

    def _refine_supported(self) -> bool:
        return self.algorithm == "minibatch" and self.decay == 1.0

    def _refine_check(self) -> None:
        if self.algorithm != "minibatch":
            raise ValueError(
                "algorithm='lloyd' retains the sketch and already iterates "
                "assignment/update to a fixed point on it — there is no "
                "second-pass gap to close; two-pass refinement applies to "
                "the streaming algorithm='minibatch' fold")
        if self.decay < 1.0:
            raise ValueError(
                "two-pass refinement rebuilds centers as a UNIFORM mean over "
                "the whole replayed history, which would resurrect exactly the "
                "stale rows a decay= fit deliberately forgets; refine the "
                "undecayed fit, or keep the decayed one-pass centers "
                "(decay-weighted rebuilds are a ROADMAP item)")

    def _refine_needs_signal(self) -> bool:
        return self.track_reassignments

    def _refine_pass_begin(self, f: int) -> None:
        if f == 0 and not self.refine_passes_:
            # a fresh refinement freezes the best first-pass hypothesis; a
            # repeat refine() resumes from self._rc, the last rebuild
            self._rc, _ = acc.kmeans_finalize(self._km_state)
            self._rc_prev = None
            self._rflips: list[tuple[int, int]] = []
        self._r2 = refine_mod.kmeans2_init(self.k, self.spec_.p_pad, device=self.device)

    def _refine_fold(self, s: SparseRows, step: int, shard: int) -> None:
        self._r2 = refine_mod.kmeans2_apply(
            self._r2, refine_mod.kmeans2_delta(s, self._rc, self._rc_prev, impl=self.plan.impl))

    def _refine_pass_end(self, f: int, last: bool, signal: bool) -> None:
        if self._rc_prev is not None:
            # flips between c_{f-1} and c_f = rows reassigned by rebuild f
            self._rflips.append((int(self._r2.flips), int(self._r2.count)))
        self._robj = self._r2.obj
        if signal:
            # every rebuild so far is measured: a resumed refine() must not
            # count the last one again
            self._rc_prev = None
        else:
            self._rc_prev = self._rc
            self._rc = refine_mod.kmeans2_centers(self._r2, self._rc)

    def _refine_end(self, passes: int) -> None:
        self.centers_pre_ = self._rc
        self.centers_ = self._unmix(self._rc)
        self.objective_ = self._robj
        self.refine_passes_ += passes    # cumulative across repeat refine()s
        if self._rflips:
            cnt = np.array([c for c, _ in self._rflips])
            rows = np.array([max(r, 1) for _, r in self._rflips])
            self.refine_reassign_counts_ = cnt
            self.refine_reassign_fraction_ = cnt / rows

    def _refine_tol_check(self) -> None:
        if not self.track_reassignments:
            raise ValueError(
                "refine(tol=) watches the reassigned-row fraction of each "
                "rebuild, which track_reassignments=False turned off — "
                "re-construct with track_reassignments=True or use a fixed "
                "passes=")

    def _refine_metric(self) -> float:
        return float(self.refine_reassign_fraction_[-1])


class GradCompressor:
    """The paper's estimator as a stateful gradient compressor — one front door
    over ``core.grad_compress`` sharing the repo's (seed, step, shard) key
    discipline: masks are ``sketch.batch_key(mask_spec(cfg, key), step, shard)``,
    exactly as a stream shard's data masks are.

    Holds the error-feedback residual and a step cursor; ``transform`` (alias
    ``compress``) is the per-step round trip of a gradient tree (nested dicts
    of tensors) on ``device`` ("cuda" by default; "cpu" on request). The
    trainer runs the same round trip on its flattened gradients with the same
    cfg and key — the masks are identical by construction.
    """

    def __init__(self, cfg: CompressConfig = CompressConfig(), key=0, shard: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.key = as_key(key)
        self.shard = int(shard)
        self.device = resolve_device(device)
        self.spec_ = mask_spec(cfg, self.key)
        self.reset()

    def reset(self) -> "GradCompressor":
        self.residual_ = None
        self.step_ = 0
        self.wire_floats_ = 0
        return self

    def transform(self, grads, step: int | None = None):
        """Compress-decompress one gradient tree; returns ĝ (same structure).

        ``step`` defaults to the internal cursor (auto-incremented); pass the
        trainer's step to stay aligned with a resumed run.
        """
        s = self.step_ if step is None else int(step)
        grads = tree_map(lambda g: torch.as_tensor(g).to(self.device), grads)
        g_hat, self.residual_, wire = compress_grads(
            grads, self.key, s, self.cfg, residual=self.residual_, shard=self.shard)
        self.wire_floats_ = wire
        self.step_ = s + 1
        return g_hat

    compress = transform
