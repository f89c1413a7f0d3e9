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
applied once, as the reference's sharded engine does with a psum.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import lowrank as lowrank_mod
from repro_torch.core import sketch as sketch_mod
from repro_torch.core.sampling import SparseRows
from repro_torch.core.sketch import batch_key
from repro_torch.stream import accumulators as acc
from repro_torch.utils.device import not_ported, resolve_device
from repro_torch.utils.prng import fold_in_str

Source = Callable[[int, int, int], Any]  # (seed, step, shard) -> (b, p) array

_ENGINE_ITEM = "Engine replay, scan and checkpoints"


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
    """

    moments: acc.MomentState | None
    kmeans: acc.KMeansState | None
    lowrank: lowrank_mod.RangeState | None = None


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

    ``mesh`` and K-means reassignment tracking are not ported yet and raise
    ``NotImplementedError``.
    """

    def __init__(self, spec: sketch_mod.SketchSpec, source, *, n_shards: int = 1,
                 mesh=None, track_cov: bool = True,
                 kmeans: StreamKMeansConfig | None = None, impl: str = "auto",
                 cov_path: str = "dense", rank: int | None = None, device="cuda"):
        if mesh is not None:
            raise not_ported("StreamEngine(mesh=...)", "Sharded backend")
        if cov_path not in ("dense", "compact", "lowrank"):
            raise ValueError(
                f"cov_path must be 'dense', 'compact' or 'lowrank', got {cov_path!r}")
        if kmeans is not None and kmeans.track_reassignments:
            raise not_ported("StreamKMeansConfig(track_reassignments=True)", _ENGINE_ITEM)
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

    def _sketch_local(self, x: torch.Tensor, step: int, shard: int) -> SparseRows:
        return sketch_mod.sketch(x, self.spec, batch_key=batch_key(self.spec, step, shard),
                                 impl=self.impl)

    def _deltas(self, state: EngineState, batch: SparseRows):
        md = (None if self.lowrank
              else acc.moment_delta(batch, track_cov=self.track_cov, cov_path=self.cov_path))
        kd = (acc.kmeans_delta(state.kmeans, batch, impl=self.impl)
              if state.kmeans is not None else None)
        ld = (lowrank_mod.range_delta(batch, self._omega, impl=self.impl)
              if self.lowrank else None)
        return md, kd, ld

    def _apply(self, state: EngineState, deltas) -> EngineState:
        md, kd, ld = deltas
        return EngineState(
            moments=(acc.moment_apply(state.moments, md)
                     if md is not None else state.moments),
            kmeans=(acc.kmeans_apply(state.kmeans, kd, decay=self.kmeans.decay)
                    if kd is not None else state.kmeans),
            lowrank=(lowrank_mod.range_apply(state.lowrank, ld)
                     if ld is not None else state.lowrank),
        )

    def host_global_batch(self, seed, step: int) -> torch.Tensor:
        """The step's (n_shards, b, p) batch from the source, on the device."""
        x = np.stack([np.asarray(self.source(seed, step, s), dtype=np.float32)
                      for s in range(self.n_shards)])
        return torch.from_numpy(x).to(self.device)

    # ------------------------------------------------------------- running --

    def init_state(self, seed: int | None = None) -> EngineState:
        """Fresh accumulators; K-means hypotheses seed from the step-0 global
        batch under the mask of shard id ``n_shards``, which the stream never
        uses."""
        km = None
        if self.kmeans is not None:
            x0 = self.host_global_batch(seed, 0)
            s0 = self._sketch_local(x0.reshape(-1, x0.shape[-1]), 0, self.n_shards)
            km = acc.kmeans_init(fold_in_str(self.spec.key, "stream-kmeans"), s0,
                                 self.kmeans.k, self.kmeans.n_init,
                                 decay=self.kmeans.decay, impl=self.impl)
        return EngineState(
            moments=(None if self.lowrank
                     else acc.moment_init(self.spec.p_pad, track_cov=self.track_cov,
                                          device=self.device)),
            kmeans=km,
            lowrank=(lowrank_mod.range_init(self.spec.p_pad, self.rank, device=self.device)
                     if self.lowrank else None))

    def update(self, state: EngineState, x: torch.Tensor, step: int) -> EngineState:
        """Fold one global batch x (n_shards, b, p): every shard's delta is
        taken against the step-start state, summed, and applied once."""
        md, kd, ld = self._deltas(state, self._sketch_local(x[0], step, 0))
        for shard in range(1, self.n_shards):
            md2, kd2, ld2 = self._deltas(state, self._sketch_local(x[shard], step, shard))
            md = acc.moment_apply(md, md2) if md is not None else None
            kd = acc.kmeans_add(kd, kd2) if kd is not None else None
            ld = lowrank_mod.range_apply(ld, ld2) if ld is not None else None
        return self._apply(state, (md, kd, ld))

    def run(self, steps: int, seed: int | None = None,
            state: EngineState | None = None, *, start_step: int = 0,
            checkpoint_dir: str | None = None, checkpoint_every: int = 0,
            telemetry=None) -> StreamResult:
        """Fold global batches ``start_step .. steps-1`` from the source.

        ``seed`` is forwarded to the source (None = the source's own default);
        sketch masks key off the spec. Passing ``state=`` and ``start_step=``
        continues an earlier run (or a state carried over from the reference
        with ``stream.state.engine_from_arrays``).
        """
        if checkpoint_dir is not None or checkpoint_every:
            raise not_ported("run(checkpoint_dir=..., checkpoint_every=...)", _ENGINE_ITEM)
        if telemetry is not None:
            raise not_ported("run(telemetry=...)", "Observability")
        if state is None:
            if start_step != 0:
                raise ValueError("start_step > 0 needs the state that was "
                                 "current at that step")
            state = self.init_state(seed)
        for step in range(start_step, steps):
            state = self.update(state, self.host_global_batch(seed, step), step)
        self.state = state
        return self.finalize(state)

    def run_scanned(self, *args, **kwargs):
        raise not_ported("StreamEngine.run_scanned", _ENGINE_ITEM)

    def replay(self, *args, **kwargs):
        raise not_ported("StreamEngine.replay", _ENGINE_ITEM)

    def save_state(self, *args, **kwargs):
        raise not_ported("StreamEngine.save_state", _ENGINE_ITEM)

    def restore_state(self, *args, **kwargs):
        raise not_ported("StreamEngine.restore_state", _ENGINE_ITEM)

    # ---------------------------------------------------------- finalizing --

    def finalize(self, state: EngineState | None = None) -> StreamResult:
        state = state if state is not None else self.state
        if state is None:
            raise RuntimeError("no stream folded yet — call run(), or pass an "
                               "EngineState explicitly")
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
        return StreamResult(mean=mean, cov=cov, count=count, centers=centers,
                            centers_pre=centers_pre, kmeans_obj=obj, cov_lowrank=cov_lowrank)

    def assign(self, batch: SparseRows, state: EngineState | None = None) -> torch.Tensor:
        """Labels for already-sketched rows under the best hypothesis' centers."""
        state = state if state is not None else self.state
        if state is None or state.kmeans is None:
            raise RuntimeError("no K-means state — construct the engine with a "
                               "StreamKMeansConfig and run() a stream first")
        centers_pre, _ = acc.kmeans_finalize(state.kmeans)
        return acc.kmeans_assign(centers_pre, batch, impl=self.impl)
