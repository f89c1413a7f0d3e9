"""Deterministic, shard-aware vector streams (host-side numpy).

Every batch is a pure function of (seed, step, shard), so any worker can
regenerate any batch. The sources are numpy-seeded and byte-identical to the
reference's ``repro.data.pipeline`` sources of the same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int = 0


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
