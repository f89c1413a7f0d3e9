"""StreamEngine — the paper's one-pass pipeline on one device.

Drives ``source → sketch → accumulate → finalize`` (paper §I's streaming
setting, §IV–V estimators, §VI K-means):

- **source** is any pure function ``(seed, step, shard) → (b, p) batch`` (or an
  object with ``batch_at``), so any batch can be regenerated;
- **sketch** applies HD then R_i per sample, with an independent mask per
  (step, shard) batch (``core.sketch.batch_key``) — the same masks as the
  reference engine for the same key;
- **accumulate** folds each sketched batch into constant-memory accumulators
  (``stream.accumulators``) — Thm-4 mean, Thm-6 covariance (or, with
  ``cov_path="lowrank"``, the O(l·p) range-finder state of ``lowrank``), and
  mini-batch streaming sparsified K-means;
- **finalize** applies the closed-form debiasing once, after the last batch.

``n_shards`` logical shards per step are folded one after another: every
shard's delta is taken against the step-start state, the deltas are summed and
applied once, as the reference's sharded engine does with a psum. With
``mesh=`` (``repro_torch.cluster``) each process builds and folds only the
shards it owns, in shard order, and one all-reduce of the summed fixed-size
delta (``stream.sharded.psum``) precedes the apply — (p,) + (p, p) + the
K-means sums and counts a step, independent of the batch size; the state is
replicated on every process.

The loop is an explicit-state fold, resumable from any step: ``run`` writes
the state every ``checkpoint_every`` steps (``save_state``), and
``restore_state`` reads it back into ``run(state=, start_step=)``; the
(seed, step, shard) contract regenerates everything else. ``run_scanned``
folds a stream already staged on the device, and ``replay`` /
``replay_scanned`` refine a finished pass (power iteration on the low-rank
basis, two-pass Alg.-2 K-means; ``repro_torch.refine``). On the card every
fold repeats bit for bit, so a resumed or replayed run equals the
uninterrupted one exactly.
"""
from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import lowrank as lowrank_mod
from repro_torch import obs
from repro_torch import refine as refine_mod
from repro_torch.core import sketch as sketch_mod
from repro_torch.core.sampling import SparseRows
from repro_torch.core.sketch import batch_key
from repro_torch.cluster import bootstrap
from repro_torch.stream import accumulators as acc
from repro_torch.stream import state as state_mod
from repro_torch.stream.sharded import psum
from repro_torch.utils.device import resolve_device
from repro_torch.utils.prng import fold_in_str

Source = Callable[[int, int, int], Any]  # (seed, step, shard) -> (b, p) array


@dataclasses.dataclass
class EngineTelemetry:
    """Opt-in per-step observability for :meth:`StreamEngine.run`.

    Observe-only: the instrumented loop folds state bit-identical to an
    uninstrumented one, on the CPU and on the card — telemetry reads timings,
    shapes and already-computed signals, never the stream, and adds no
    device synchronisation to the step. Per step it records into
    ``registry`` (the same names as the reference's ``EngineTelemetry``):

    - counters ``engine.steps`` / ``engine.rows`` / ``engine.checkpoints``
      (+ ``engine.reassigned`` when the K-means config tracks reassignments);
    - histograms ``engine.step_seconds`` / ``engine.source_seconds`` /
      ``engine.update_seconds`` / ``engine.checkpoint_seconds`` — host wall
      time of the whole step, the batch generation and its copy to the
      device, the update (on the card: the time to enqueue its kernels,
      unless something in the step waits), and checkpoint writes; the spans
      ``engine.source`` / ``engine.update`` / ``engine.checkpoint`` carry the
      same intervals, and inside the update ``record_function("obs.sketch")``
      and ``("obs.fold")`` name each shard's sketch and fold in a
      ``torch.profiler`` capture;
    - gauges ``engine.rows_per_sec`` (cumulative over this run) and
      ``engine.state_bytes`` (the accumulators' bytes — constant in stream
      length by construction, so a drift here is a leak).

    ``step_logger``/``log_every`` add a structured JSONL record per logged
    step (step, rows, rows/sec, phase seconds, reassign fraction, state
    bytes, checkpoint timestamps); ``on_step`` receives the same record dict.
    """

    registry: obs.MetricsRegistry | None = None
    step_logger: obs.StepLogger | None = None
    log_every: int = 1
    on_step: Callable[[dict], None] | None = None

    def _reg(self) -> obs.MetricsRegistry:
        return self.registry if self.registry is not None else obs.default_registry()

    def emit(self, record: dict) -> None:
        if self.step_logger is not None and record["step"] % self.log_every == 0:
            self.step_logger.log(**record)
        if self.on_step is not None:
            self.on_step(record)


@dataclasses.dataclass(frozen=True)
class StreamKMeansConfig:
    """Mini-batch streaming sparsified K-means: K clusters, r parallel seeds.

    ``decay`` < 1 is the forgetting factor for non-stationary streams (the
    per-coordinate counts shrink by ``decay`` once per step).
    """

    k: int
    n_init: int = 3
    decay: float = 1.0
    track_reassignments: bool = False

    def __post_init__(self):
        if not 0.0 < self.decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {self.decay}")


@dataclasses.dataclass(frozen=True)
class EngineState:
    """Everything the engine carries between batches.

    Exactly one of ``moments`` / ``lowrank`` accumulates the second moment and
    the Thm-4 mean (RangeState carries sum_w and count itself).

    ``reassign`` (present iff ``StreamKMeansConfig.track_reassignments``) is a
    ``(total, last)`` pair of (r,) int32 counters: rows whose nearest center
    changed across an apply, over the run and in the last folded step.
    Serialization and merge: ``stream.state.engine_to_arrays`` /
    ``engine_from_arrays`` / ``engine_merge``.
    """

    moments: acc.MomentState | None
    kmeans: acc.KMeansState | None
    lowrank: lowrank_mod.RangeState | None = None
    reassign: tuple | None = None  # ((r,) int32 total, (r,) int32 last step)


@dataclasses.dataclass(frozen=True)
class StreamResult:
    """Finalized one-pass estimates (mean/cov in the preconditioned domain;
    K-means centers in both domains)."""

    mean: torch.Tensor | None
    cov: torch.Tensor | None
    count: torch.Tensor
    centers: torch.Tensor | None = None        # original domain, (K, p)
    centers_pre: torch.Tensor | None = None    # preconditioned domain, (K, p_pad)
    kmeans_obj: torch.Tensor | None = None
    cov_lowrank: lowrank_mod.LowRankCov | None = None  # cov_path="lowrank"
    refine_passes: int = 0                  # replay() passes folded into this
    refine_reassigned: tuple | None = None  # rows reassigned by rebuilds 1..q-1
    # the K-means drift signal (StreamKMeansConfig.track_reassignments):
    reassign_total: np.ndarray | None = None   # (r,) over the run
    reassign_last: np.ndarray | None = None    # (r,) of the last folded step
    reassign_counts: np.ndarray | None = None  # (steps, r) a step (run() only)


def normalize_source(source) -> Source:
    """Adapt a source to (seed, step, shard) → batch. seed=None means "the
    source's own default" (0 for plain callables); an explicit seed must not be
    silently ignored, so batch_at objects that can't take one reject it."""
    if callable(source):
        return lambda seed, step, shard: source(0 if seed is None else seed, step, shard)
    if hasattr(source, "batch_at"):
        accepts_seed = "seed" in inspect.signature(source.batch_at).parameters

        def from_obj(seed, step, shard):
            if seed is None:
                return source.batch_at(step, shard)
            if not accepts_seed:
                raise ValueError(
                    "run(seed=...) given, but this source's batch_at() has no seed "
                    "parameter — it streams its constructed seed; pass seed=None")
            return source.batch_at(step, shard, seed=seed)

        return from_obj
    raise TypeError(f"source must be callable or expose batch_at, got {type(source)}")


class StreamEngine:
    """One-pass estimation over a (seed, step, shard) batch stream on one device.

    Parameters
    ----------
    spec: the sketch (p, m, transform, key) — see ``core.sketch``.
    source: ``(seed, step, shard) → (b, p)`` array, or an object with
        ``batch_at(step, shard)`` (e.g. ``data.pipeline.VectorStreamSource``).
    n_shards: logical shards per step, folded one after another.
    mesh / axis: optional ``repro_torch.cluster.Mesh`` and its data axis,
        whose size must equal ``n_shards``: each process folds the shards it
        owns and the step's summed delta is all-reduced before the apply.
    track_cov: accumulate the (p, p) second moment (Thm-6).
    kmeans: optional :class:`StreamKMeansConfig` for mini-batch streaming
        sparsified K-means alongside the moment estimators.
    impl: kernel dispatch ("auto" = the CUDA kernels on a card, their plain
        versions on the CPU; "ref" = the plain versions anywhere).
    cov_path: "dense" (scatter the batch to (b, p), one fp32 product),
        "compact" (scatter b·m² outer products) or "lowrank" (the range-finder
        state of ``repro_torch.lowrank``: the second moment shrinks from (p, p)
        to the (p, rank) projection S·Ω, fed by the K5/K6 kernels; finalize
        returns the factored eigenmodel on ``StreamResult.cov_lowrank``
        instead of ``cov``).
    rank: sketch width l of the "lowrank" path (required there).
    device: where the state lives and the work runs ("cuda" by default).
    """

    def __init__(self, spec: sketch_mod.SketchSpec, source, *, n_shards: int = 1,
                 mesh=None, axis: str = "data", track_cov: bool = True,
                 kmeans: StreamKMeansConfig | None = None, impl: str = "auto",
                 cov_path: str = "dense", rank: int | None = None, device="cuda"):
        if mesh is not None and mesh.shape[axis] != int(n_shards):
            raise ValueError(
                f"mesh axis {axis!r} has size {mesh.shape[axis]}, need n_shards={n_shards}")
        if cov_path not in ("dense", "compact", "lowrank"):
            raise ValueError(
                f"cov_path must be 'dense', 'compact' or 'lowrank', got {cov_path!r}")
        if track_cov and spec.m < 2:
            raise ValueError(f"track_cov needs m >= 2, got m={spec.m}; "
                             "raise gamma/m or pass track_cov=False")
        self.device = resolve_device(device)
        # the covariance product must be full fp32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        self.spec = spec
        self.source = normalize_source(source)
        self.n_shards = int(n_shards)
        self.mesh, self.axis = mesh, axis
        # the shards this process builds and folds, in shard order
        self._local = (bootstrap.local_shards(mesh, axis) if mesh is not None
                       else list(range(self.n_shards)))
        if not self._local:
            raise ValueError(f"process {bootstrap.process_index()} owns no shards of "
                             f"{mesh} — shrink the process count")
        self.track_cov = track_cov
        self.kmeans = kmeans
        self.impl = impl
        self.cov_path = cov_path
        self.lowrank = cov_path == "lowrank" and track_cov
        self._omega = None
        if self.lowrank:
            if rank is None or not 2 <= rank <= spec.p_pad:
                raise ValueError(f"cov_path='lowrank' needs 2 <= rank <= "
                                 f"p_pad={spec.p_pad}, got rank={rank}")
            self.rank = int(rank)
            self._omega = lowrank_mod.omega(spec.key, spec.p_pad, self.rank,
                                            device=self.device)
        self.state: EngineState | None = None  # set by run()

    # ------------------------------------------------------------ plumbing --

    @property
    def _track(self) -> bool:
        return self.kmeans is not None and self.kmeans.track_reassignments

    def _sketch_local(self, x: torch.Tensor, step: int, shard: int) -> SparseRows:
        return sketch_mod.sketch(x, self.spec, batch_key=batch_key(self.spec, step, shard),
                                 impl=self.impl)

    def _deltas(self, state: EngineState, batch: SparseRows):
        """((md, kd, ld), pre-update K-means labels or None) for one shard."""
        md = (None if self.lowrank
              else acc.moment_delta(batch, track_cov=self.track_cov, cov_path=self.cov_path,
                                    impl=self.impl))
        kd = a0 = None
        if state.kmeans is not None:
            kd, a0 = acc.kmeans_delta_with_assign(state.kmeans, batch, impl=self.impl)
        ld = (lowrank_mod.range_delta(batch, self._omega, impl=self.impl)
              if self.lowrank else None)
        return (md, kd, ld), a0

    @staticmethod
    def _add(d1, d2):
        md, kd, ld = d1
        md2, kd2, ld2 = d2
        return (acc.moment_apply(md, md2) if md is not None else None,
                acc.kmeans_add(kd, kd2) if kd is not None else None,
                lowrank_mod.range_apply(ld, ld2) if ld is not None else None)

    def _apply(self, state: EngineState, deltas) -> EngineState:
        md, kd, ld = deltas
        return EngineState(
            moments=(acc.moment_apply(state.moments, md)
                     if md is not None else state.moments),
            kmeans=(acc.kmeans_apply(state.kmeans, kd, decay=self.kmeans.decay)
                    if kd is not None else state.kmeans),
            lowrank=(lowrank_mod.range_apply(state.lowrank, ld)
                     if ld is not None else state.lowrank),
            reassign=state.reassign,
        )

    def host_global_batch(self, seed, step: int, local: bool = True) -> torch.Tensor:
        """The step's (n_shards, b, p) batch from the source, on the device (a
        source that returns tensors is stacked without a host copy). Under a
        mesh, with ``local``, only the (n_local, b, p) shards this process
        owns."""
        shards = self._local if local else range(self.n_shards)
        return bootstrap.stack_batches([self.source(seed, step, s) for s in shards], self.device)

    # ------------------------------------------------------------- running --

    def init_state(self, seed: int | None = None) -> EngineState:
        """Fresh accumulators; K-means hypotheses seed from the step-0 global
        batch under the mask of shard id ``n_shards``, which the stream never
        uses."""
        km = None
        if self.kmeans is not None:
            # every process seeds from the whole step-0 batch: the same state
            km = self._kmeans_init(self.host_global_batch(seed, 0, local=False))
        return self._fresh_state(km)

    def init_from_array(self, xs: torch.Tensor) -> EngineState:
        """Fresh accumulators for a stream staged as ``xs (steps, n_shards, b,
        p)``, K-means seeded from ``xs[0]`` as :meth:`init_state` seeds it."""
        km = self._kmeans_init(xs[0]) if self.kmeans is not None else None
        return self._fresh_state(km)

    def _kmeans_init(self, x0: torch.Tensor) -> acc.KMeansState:
        s0 = self._sketch_local(x0.reshape(-1, x0.shape[-1]), 0, self.n_shards)
        return acc.kmeans_init(fold_in_str(self.spec.key, "stream-kmeans"), s0,
                               self.kmeans.k, self.kmeans.n_init,
                               decay=self.kmeans.decay, impl=self.impl)

    def _fresh_state(self, km) -> EngineState:
        reassign = None
        if self._track:
            z = torch.zeros((self.kmeans.n_init,), dtype=torch.int32, device=self.device)
            reassign = (z, z)
        return EngineState(
            moments=(None if self.lowrank
                     else acc.moment_init(self.spec.p_pad, track_cov=self.track_cov,
                                          device=self.device)),
            kmeans=km,
            lowrank=(lowrank_mod.range_init(self.spec.p_pad, self.rank, device=self.device)
                     if self.lowrank else None),
            reassign=reassign)

    def update(self, state: EngineState, x: torch.Tensor, step: int) -> EngineState:
        """Fold one global batch x (n_shards, b, p) — under a mesh this
        process's (n_local, b, p) shards: every shard's delta is taken against
        the step-start state, summed (and all-reduced over the mesh), and
        applied once. With ``track_reassignments`` each shard's rows are then
        re-assigned under the new centers (K4) and compared with their
        pre-update labels; the counts ride one more all-reduce."""
        deltas, pairs = None, []
        for i, shard in enumerate(self._local):
            with record_function("obs.sketch"):
                s = self._sketch_local(x[i], step, shard)
            with record_function("obs.fold"):
                d, a0 = self._deltas(state, s)
            deltas = d if deltas is None else self._add(deltas, d)
            if self._track:
                pairs.append((s, a0))
        new = self._apply(state, psum(deltas, self.mesh))
        if not self._track:
            return new
        cnt = torch.zeros_like(state.reassign[1])
        for s, a0 in pairs:
            cnt = cnt + acc.kmeans_reassigned(new.kmeans, s, a0, impl=self.impl)
        cnt = psum(cnt, self.mesh)
        return dataclasses.replace(new, reassign=(state.reassign[0] + cnt, cnt))

    def run(self, steps: int, seed: int | None = None,
            state: EngineState | None = None, *, start_step: int = 0,
            checkpoint_dir: str | None = None, checkpoint_every: int = 0,
            telemetry: EngineTelemetry | None = None) -> StreamResult:
        """Fold global batches ``start_step .. steps-1`` from the source.

        ``seed`` is forwarded to the source (None = the source's own default);
        sketch masks key off the spec. Passing ``state=`` and ``start_step=``
        (from :meth:`restore_state`, or a state carried over from the
        reference with ``stream.state.engine_from_arrays``) continues an
        earlier run bit for bit. ``checkpoint_every=t`` writes the state to
        ``checkpoint_dir`` every t folded steps (:meth:`save_state`).
        ``telemetry=`` opts into per-step observability
        (:class:`EngineTelemetry`); the fold stays bit-identical. Under a
        mesh every process runs this loop over its own shards; the rows a
        step counts are the whole step's.
        """
        if checkpoint_every and not checkpoint_dir:
            raise ValueError("checkpoint_every needs checkpoint_dir=")
        if state is None:
            if start_step != 0:
                raise ValueError("start_step > 0 needs the state that was "
                                 "current at that step (restore_state)")
            state = self.init_state(seed)
        history: list[torch.Tensor] = []
        tel = telemetry
        # without telemetry the spans still annotate the profiler, and their
        # metrics are the shared no-ops
        reg = tel._reg() if tel is not None else obs.NULL_REGISTRY
        c_steps, c_rows = reg.counter("engine.steps"), reg.counter("engine.rows")
        h_step = reg.histogram("engine.step_seconds")
        h_source = reg.histogram("engine.source_seconds")
        h_update = reg.histogram("engine.update_seconds")
        g_rate = reg.gauge("engine.rows_per_sec")
        g_bytes = reg.gauge("engine.state_bytes")
        rows_run, run_t0 = 0, time.perf_counter()
        for step in range(start_step, steps):
            t0 = time.perf_counter()
            with obs.span("engine.source", reg):
                x = self.host_global_batch(seed, step)
            t1 = time.perf_counter()
            with obs.span("engine.update", reg):
                state = self.update(state, x, step)
            t2 = time.perf_counter()
            if self._track:
                history.append(state.reassign[1])
            ckpt_s = None
            if checkpoint_every and (step + 1 - start_step) % checkpoint_every == 0:
                t3 = time.perf_counter()
                with obs.span("engine.checkpoint", reg):
                    self.save_state(checkpoint_dir, step + 1, state, seed=seed)
                ckpt_s = time.perf_counter() - t3
                reg.counter("engine.checkpoints").inc()
                reg.histogram("engine.checkpoint_seconds").observe(ckpt_s)
            if tel is not None:
                rows_step = self.n_shards * int(x.shape[1])
                rows_run += rows_step
                elapsed = time.perf_counter() - run_t0
                state_bytes = state_mod.state_nbytes(state)
                c_steps.inc()
                c_rows.inc(rows_step)
                h_step.observe(t2 - t0)
                h_source.observe(t1 - t0)
                h_update.observe(t2 - t1)
                g_rate.set(rows_run / max(elapsed, 1e-9))
                g_bytes.set(state_bytes)
                record = {"step": step, "rows": rows_step, "rows_total": rows_run,
                          "rows_per_sec": round(rows_run / max(elapsed, 1e-9), 1),
                          "source_s": round(t1 - t0, 6),
                          "update_s": round(t2 - t1, 6),
                          "state_bytes": state_bytes}
                if ckpt_s is not None:
                    record["checkpoint_s"] = round(ckpt_s, 6)
                    record["checkpoint_step"] = step + 1
                if self._track and history:
                    # reads the step's (r,) counts back: the one wait telemetry
                    # adds, after the step's spans have closed
                    re_last = history[-1].cpu().numpy()
                    reg.counter("engine.reassigned").inc(int(re_last.sum()))
                    record["reassign_frac"] = round(
                        float(re_last.mean()) / max(rows_step, 1), 6)
                tel.emit(record)
        self.state = state
        result = self.finalize(state)
        if history:
            result = dataclasses.replace(result,
                                         reassign_counts=torch.stack(history).cpu().numpy())
        return result

    def run_scanned(self, xs: torch.Tensor) -> StreamResult:
        """Fold a stream staged on the device, ``xs (steps, n_shards, b, p)``,
        from a fresh state: the reference's ``lax.scan`` over the steps is
        this host loop over ``xs[step]``, with the same sketches and folds as
        :meth:`run` (bit-equal to it over the same rows). A numpy ``xs`` is
        moved to the device once."""
        xs = torch.as_tensor(xs).to(device=self.device, dtype=torch.float32)
        state = self.init_from_array(xs)
        for step in range(xs.shape[0]):
            state = self.update(state, self._local_of(xs[step]), step)
        self.state = state
        return self.finalize(state)

    def _local_of(self, x: torch.Tensor) -> torch.Tensor:
        """This process's shards of a staged (n_shards, b, p) step."""
        if len(self._local) == self.n_shards:
            return x
        return x[self._local[0]:self._local[-1] + 1]

    # ---------------------------------------------------- checkpoint/restore --

    def save_state(self, ckpt_dir: str, step: int, state: EngineState | None = None,
                   seed: int | None = None) -> None:
        """Checkpoint ``state`` (default: the engine's current one) as step
        ``step`` — the number of steps already folded, the step a restored run
        resumes at — in the reference's layout (``stream.state.save_engine``).
        One writer: under a process group only process 0 writes (the state
        is replicated)."""
        state = state if state is not None else self.state
        if state is None:
            raise RuntimeError("no state to checkpoint — run() first or pass state=")
        if bootstrap.process_index() != 0:
            return
        state_mod.save_engine(ckpt_dir, step, state, extra={
            "p_pad": int(self.spec.p_pad), "n_shards": self.n_shards, "seed": seed})

    def restore_state(self, ckpt_dir: str) -> tuple[EngineState, int]:
        """(state on this engine's device, next_step) from the latest
        checkpoint under ``ckpt_dir`` (either package's) — for
        ``run(steps, state=state, start_step=next_step)`` or ``replay(state=)``."""
        state, next_step, extra = state_mod.load_engine(ckpt_dir, device=self.device)
        p_pad = extra.get("p_pad")
        if p_pad is not None and int(p_pad) != int(self.spec.p_pad):
            raise ValueError(f"checkpoint was written at p_pad={p_pad}, this "
                             f"engine has p_pad={self.spec.p_pad}")
        self.state = state
        return state, next_step

    # ------------------------------------------------------------ replaying --
    # Second-pass refinement (repro_torch.refine): the (seed, step, shard)
    # contract regenerates every batch and its mask, so extra passes store
    # nothing. Each pass folds a fixed-size carry — a RangeState of Y = S·Q
    # (power iteration) and/or a KMeans2State of frozen-center sums (Alg. 2) —
    # one step at a time, every shard's delta summed and applied once.

    def _refine_update(self, carry, x: torch.Tensor, step: int, q_mat, frozen, prev):
        """carry → carry for one global batch x (n_shards, b, p), under a mesh
        this process's shards: the shards' deltas summed, all-reduced over the
        mesh, then applied once."""
        ld = kd = None
        for i, shard in enumerate(self._local):
            s = self._sketch_local(x[i], step, shard)
            if self.lowrank:
                d = lowrank_mod.range_delta(s, q_mat, impl=self.impl)
                ld = d if ld is None else lowrank_mod.range_apply(ld, d)
            if self.kmeans is not None:
                d = refine_mod.kmeans2_delta(s, frozen, prev, impl=self.impl)
                kd = d if kd is None else refine_mod.kmeans2_apply(kd, d)
        ld, kd = psum((ld, kd), self.mesh)
        cl, ck = carry
        return (lowrank_mod.range_apply(cl, ld) if ld is not None else cl,
                refine_mod.kmeans2_apply(ck, kd) if kd is not None else ck)

    def _init_refine_carry(self):
        return (lowrank_mod.range_init(self.spec.p_pad, self.rank, device=self.device)
                if self.lowrank else None,
                refine_mod.kmeans2_init(self.kmeans.k, self.spec.p_pad, device=self.device)
                if self.kmeans is not None else None)

    def _replay_passes(self, fold_pass, passes: int, state: EngineState | None) -> StreamResult:
        """The head and tail of replay()/replay_scanned(): the per-pass basis
        orthonormalization / center rebuild around ``fold_pass(carry, q,
        frozen, prev) → carry``, then the refined finalize."""
        state = state if state is not None else self.state
        if state is None:
            raise RuntimeError("no stream folded yet — run()/run_scanned() "
                               "first; replay() refines a finished pass")
        if not (self.lowrank or self.kmeans is not None):
            raise ValueError(
                "replay() refines the low-rank PCA basis and/or streaming "
                "K-means centers; this engine tracks neither (dense moment "
                "accumulators are already exact in one pass)")
        if self.kmeans is not None and self.kmeans.decay < 1.0:
            raise ValueError(
                "replay()'s uniform Alg.-2 rebuild would un-forget the "
                "history a decay= stream deliberately down-weights; refine "
                "an undecayed engine (decay-weighted rebuilds are a ROADMAP "
                "item)")
        if passes < 1:
            raise ValueError(f"replay needs passes >= 1, got {passes}")
        m = self.spec.m
        q = q_prev = frozen = prev = obj = lr_state = None
        if self.lowrank:
            q = refine_mod.power_orth(state.lowrank, self._omega, m)
        if self.kmeans is not None:
            # the best first-pass hypothesis is the frozen Alg.-2 start
            frozen, _ = acc.kmeans_finalize(state.kmeans)
        flips: list[int] = []
        for r in range(passes):
            lr_state, km_state = fold_pass(self._init_refine_carry(), q, frozen, prev)
            if self.lowrank:
                q_prev, q = q, refine_mod.power_orth(lr_state, q, m)
            if self.kmeans is not None:
                if r > 0:
                    flips.append(int(km_state.flips))
                obj = km_state.obj
                prev = frozen
                frozen = refine_mod.kmeans2_centers(km_state, frozen)

        if self.lowrank:
            mean = lowrank_mod.range_finalize_mean(lr_state, m)
            count, cov = lr_state.count, None
            cov_lowrank = refine_mod.power_finalize(lr_state, q_prev, m)
        else:
            base = self.finalize(state)
            mean, cov, count, cov_lowrank = base.mean, base.cov, base.count, None
        centers = centers_pre = None
        if self.kmeans is not None:
            centers_pre = frozen
            centers = sketch_mod.unmix_dense(centers_pre, self.spec, impl=self.impl)
        return StreamResult(mean=mean, cov=cov, count=count, centers=centers,
                            centers_pre=centers_pre, kmeans_obj=obj, cov_lowrank=cov_lowrank,
                            refine_passes=passes, refine_reassigned=tuple(flips))

    def replay(self, steps: int, seed: int | None = None, passes: int = 1,
               state: EngineState | None = None) -> StreamResult:
        """Refine a finished run() by ``passes`` replays of the same source.

        PCA (cov_path="lowrank"): each pass is one power iteration — the
        replayed action S·Q replaces S·Ω — finalized through the same core
        solve. K-means: each pass re-assigns every row against frozen
        pass-start centers and rebuilds them from those assignments (Alg. 2);
        ``refine_reassigned[r]`` counts the rows rebuild r+1 reassigned (seen
        one replay later, so the last rebuild's count needs a further replay,
        which the estimators' ``track_reassignments`` runs). ``kmeans_obj`` is
        the objective under the last pass's frozen centers.
        """
        def fold_pass(carry, q, frozen, prev):
            for step in range(steps):
                carry = self._refine_update(carry, self.host_global_batch(seed, step), step,
                                            q, frozen, prev)
            return carry

        return self._replay_passes(fold_pass, passes, state)

    def replay_scanned(self, xs: torch.Tensor, passes: int = 1,
                       state: EngineState | None = None) -> StreamResult:
        """replay() over a stream staged on the device, ``xs (steps, n_shards,
        b, p)`` (the reference folds each pass as one ``lax.scan``; here the
        host loop over ``xs[step]``, with no host copy)."""
        xs = torch.as_tensor(xs).to(device=self.device, dtype=torch.float32)

        def fold_pass(carry, q, frozen, prev):
            for step in range(xs.shape[0]):
                carry = self._refine_update(carry, self._local_of(xs[step]), step, q, frozen,
                                            prev)
            return carry

        return self._replay_passes(fold_pass, passes, state)

    # ---------------------------------------------------------- finalizing --

    def finalize(self, state: EngineState | None = None) -> StreamResult:
        state = state if state is not None else self.state
        if state is None:
            raise RuntimeError("no stream folded yet — call run()/run_scanned(), "
                               "or pass an EngineState explicitly")
        cov = cov_lowrank = None
        if state.lowrank is not None:
            # RangeState carries the Thm-4 accumulators itself (see EngineState)
            mean = lowrank_mod.range_finalize_mean(state.lowrank, self.spec.m)
            count = state.lowrank.count
            cov_lowrank = lowrank_mod.range_finalize(state.lowrank, self.spec.m, self._omega)
        else:
            mean = acc.moment_finalize_mean(state.moments, self.spec.m)
            count = state.moments.count
            if self.track_cov:
                cov = acc.moment_finalize_cov(state.moments, self.spec.m)
        centers = centers_pre = obj = None
        if state.kmeans is not None:
            centers_pre, obj = acc.kmeans_finalize(state.kmeans)
            centers = sketch_mod.unmix_dense(centers_pre, self.spec, impl=self.impl)
        r_total = r_last = None
        if state.reassign is not None:
            r_total = state.reassign[0].cpu().numpy()
            r_last = state.reassign[1].cpu().numpy()
        return StreamResult(mean=mean, cov=cov, count=count, centers=centers,
                            centers_pre=centers_pre, kmeans_obj=obj, cov_lowrank=cov_lowrank,
                            reassign_total=r_total, reassign_last=r_last)

    def assign(self, batch: SparseRows, state: EngineState | None = None) -> torch.Tensor:
        """Labels for already-sketched rows under the best hypothesis' centers."""
        state = state if state is not None else self.state
        if state is None or state.kmeans is None:
            raise RuntimeError("no K-means state — construct the engine with a "
                               "StreamKMeansConfig and run() a stream first")
        centers_pre, _ = acc.kmeans_finalize(state.kmeans)
        return acc.kmeans_assign(centers_pre, batch, impl=self.impl)
