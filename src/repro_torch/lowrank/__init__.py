"""Low-rank spectral subsystem: streaming PCA without the (p, p) accumulator.

- :mod:`repro_torch.lowrank.range_finder` — the randomized range-finder state:
  Y = S·Ω accumulated exactly through the K5/K6 sparse-times-dense kernels;
  linear, so shard deltas add. Finalized by single-pass Nyström and the
  in-basis Thm-6 debias.
- :mod:`repro_torch.lowrank.fd` — the Frequent-Directions (l, p) sketch,
  SVD-shrunk on overflow: a deterministic guarantee and a sequential fold
  (the estimators' ``Plan(lowrank_method="fd")``).
- :mod:`repro_torch.lowrank.model` — the :class:`LowRankCov` factored
  eigenmodel, the fixed test matrix :func:`omega`, and the in-basis
  eigensolve.

Front door: ``Plan(cov_path="lowrank", rank=l)`` through ``api.make_engine``
(the range-finder) and the estimators (either method).
"""
from repro_torch.lowrank.fd import (  # noqa: F401
    FDState,
    fd_finalize,
    fd_finalize_mean,
    fd_init,
    fd_update,
)
from repro_torch.lowrank.model import LowRankCov, eig_in_basis, omega  # noqa: F401
from repro_torch.lowrank.range_finder import (  # noqa: F401
    RangeState,
    range_apply,
    range_delta,
    range_finalize,
    range_finalize_mean,
    range_init,
    range_update,
)
