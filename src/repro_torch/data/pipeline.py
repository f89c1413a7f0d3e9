"""Deterministic, shard-aware vector streams (host-side numpy).

Every batch is a pure function of (seed, step, shard), so any worker can
regenerate any batch. The sources are numpy-seeded and byte-identical to the
reference's ``repro.data.pipeline`` sources of the same seed.
:class:`SketchingPipeline` pulls a source's batches through the one-pass
compression; its state is the source's one integer cursor and seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import sketch as sketch_mod
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int = 0

    def to_json(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_json(cls, d: dict) -> "PipelineState":
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class VectorStreamSource:
    """Deterministic stream of p-dimensional samples (for PCA/K-means at scale).

    Rows are ``κ·diag(λ)·Uᵀ + 0.05·ε`` with a planted orthonormal ``U`` (p, k)
    (``_u``) and ``λ`` linearly from 10 down to 2 (``_lam``), so the second
    moment's top-k eigenpairs are ``(λ_i² + 0.0025, u_i)``.
    """

    def __init__(self, p: int, batch: int, seed: int = 0, mode: str = "lowrank", k: int = 8):
        self.p, self.batch, self.mode, self.k = p, batch, mode, k
        self.state = PipelineState(seed=seed)
        rng = np.random.default_rng(seed)
        u, _ = np.linalg.qr(rng.normal(size=(p, k)))
        self._u = u.astype(np.float32)
        self._lam = np.linspace(10, 2, k).astype(np.float32)

    def batch_at(self, step: int, shard: int = 0, seed: int | None = None) -> np.ndarray:
        """Regenerate the (step, shard) batch on any worker — (batch, p) f32.

        ``seed`` overrides the constructed stream seed; None keeps
        ``self.state.seed``.
        """
        rng = np.random.default_rng((self.state.seed if seed is None else seed, step, shard))
        kappa = rng.normal(size=(self.batch, self.k)).astype(np.float32)
        x = (kappa * self._lam) @ self._u.T
        x += 0.05 * rng.normal(size=(self.batch, self.p)).astype(np.float32)
        return x

    def next_batch(self) -> np.ndarray:
        x = self.batch_at(self.state.step)
        self.state.step += 1
        return x


class SketchingPipeline:
    """Wraps a vector source with the paper's one-pass compression.

    Emits SparseRows batches on ``device``; every batch gets an independent
    mask key (``fold_in`` of the spec's mask key and the step) — the paper's
    per-sample R_i property, the same masks as the reference's pipeline.

    This is the minimal pull-based wrapper; the streaming subsystem is
    ``repro_torch.stream.StreamEngine``, which consumes the same sources via
    their (seed, step, shard) ``batch_at`` contract.
    """

    def __init__(self, source: VectorStreamSource, spec: sketch_mod.SketchSpec,
                 impl: str = "auto", device="cuda"):
        self.source = source
        self.spec = spec
        self.impl = impl
        self.device = resolve_device(device)

    def next_batch(self):
        step = self.source.state.step
        x = torch.from_numpy(self.source.next_batch()).to(self.device)
        bk = prng.fold_in(self.spec.mask_key(), step)
        return sketch_mod.sketch(x, self.spec, batch_key=bk, impl=self.impl)

    @property
    def state(self) -> PipelineState:
        return self.source.state
