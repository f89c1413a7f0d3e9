"""The execution :class:`Plan` — one config object selecting how a sketch job runs.

The same fields and validation as the reference's ``repro.api.Plan``. This
package runs ``backend="batch"`` and ``"stream"`` through the estimators of
:mod:`repro_torch.api`, and ``"stream"`` through
:func:`repro_torch.api.make_engine`, with the dense, compact or low-rank
(``lowrank_method="range"``; the estimators also ``"fd"``) covariance path,
and ``refine_passes`` for ``fit_refine`` / ``fit_many(refine=True)``; the
sharded backend raises ``NotImplementedError`` until it is ported.
:func:`mesh_spec` / :func:`mesh_from_spec` are the snapshot codec's mesh
fields: the null mesh only, until the sharded backend brings meshes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Literal

from repro_torch.core import ros, sketch
from repro_torch.utils.device import not_ported

Backend = Literal["batch", "stream", "sharded"]

BACKENDS: tuple[str, ...] = ("batch", "stream", "sharded")


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a sketched-estimation job executes.

    backend:    "batch", "stream" or "sharded" ("sharded" is not ported yet).
    gamma / m:  sketch size — fraction kept (validated to (0, 1]) or absolute
                coordinate count; exactly one is required.
    transform:  ROS preconditioner ("hadamard" or "dct").
    impl:       kernel dispatch ("auto" = CUDA kernels on a card, the plain
                versions on the CPU; "ref" = the plain versions anywhere).
    batch_size: rows per (step, shard) batch.
    n_shards:   logical shards per step (the shard axis of the key discipline).
    axis:       mesh axis name for the sharded backend.
    mesh:       device mesh for the sharded backend.
    cov_path:   "dense", "compact" or "lowrank".
    rank:       sketch width of the low-rank path (required there).
    lowrank_method: "range" or "fd" (the engine takes "range" only, as the
                reference's does).
    refine_passes: the default number of replay refinements of
                ``fit_refine`` / ``fit_many(refine=True)`` (0: one-pass fits;
                ``fit_refine`` then runs 1).
    dtype:      input rows are cast to this before sketching.
    """

    backend: Backend = "batch"
    gamma: float | None = None
    m: int | None = None
    transform: ros.Transform = "hadamard"
    impl: str = "auto"
    batch_size: int = 4096
    n_shards: int = 1
    axis: str = "data"
    mesh: Any | None = None
    cov_path: Literal["dense", "compact", "lowrank"] = "dense"
    rank: int | None = None
    lowrank_method: Literal["range", "fd"] = "range"
    refine_passes: int = 0
    dtype: Any = "float32"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.cov_path not in ("dense", "compact", "lowrank"):
            raise ValueError(
                f"cov_path must be 'dense', 'compact' or 'lowrank', got {self.cov_path!r}")
        if self.lowrank_method not in ("range", "fd"):
            raise ValueError(
                f"lowrank_method must be 'range' or 'fd', got {self.lowrank_method!r}")
        if self.cov_path == "lowrank":
            if self.rank is None or self.rank < 2:
                raise ValueError(
                    f"cov_path='lowrank' needs rank >= 2 (the l of the (l, p) "
                    f"sketch), got rank={self.rank}")
        elif self.rank is not None:
            raise ValueError("rank= only applies to cov_path='lowrank'")
        if self.refine_passes < 0:
            raise ValueError(f"refine_passes must be >= 0, got {self.refine_passes}")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.impl not in ros.IMPLS:
            raise ValueError(f"impl must be one of {ros.IMPLS}, got {self.impl!r}")

    def replace(self, **kw) -> "Plan":
        """A copy with fields overridden — e.g. ``plan.replace(gamma=0.1)``."""
        return dataclasses.replace(self, **kw)

    def spec(self, p: int, key) -> sketch.SketchSpec:
        """The SketchSpec this plan induces at dimensionality ``p``."""
        return sketch.make_spec(p, key, gamma=self.gamma, m=self.m,
                                transform=self.transform)

    def step_shard(self, chunk: int) -> tuple[int, int]:
        """Map a linear chunk index to its (step, shard) key coordinates."""
        return divmod(chunk, self.n_shards)


# ----------------------------------------------------------- mesh (de)spec --
# The reference serializes a Plan's mesh as its geometry (axis names and
# shape) in snapshots. The port has no mesh yet: only None round-trips.


def mesh_spec(mesh) -> dict | None:
    """The JSON-safe geometry of a mesh; None stays None (any mesh raises:
    meshes come with the sharded backend)."""
    if mesh is None:
        return None
    raise not_ported("mesh_spec(mesh)", "Sharded backend")


def mesh_from_spec(spec: dict | None):
    """The mesh a snapshot's geometry describes; None stays None (a mesh
    geometry raises until the sharded backend is ported)."""
    if spec is None:
        return None
    raise not_ported(f"a snapshot plan with mesh {spec}", "Sharded backend")
