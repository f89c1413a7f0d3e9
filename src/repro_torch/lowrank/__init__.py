"""Low-rank spectral subsystem: streaming PCA without the (p, p) accumulator.

- :mod:`repro_torch.lowrank.range_finder` — the randomized range-finder state:
  Y = S·Ω accumulated exactly through the K5/K6 sparse-times-dense kernels;
  linear, so shard deltas add. Finalized by single-pass Nyström and the
  in-basis Thm-6 debias.
- :mod:`repro_torch.lowrank.model` — the :class:`LowRankCov` factored
  eigenmodel, the fixed test matrix :func:`omega`, and the in-basis
  eigensolve.

Front door: ``Plan(cov_path="lowrank", rank=l)`` through ``api.make_engine``.
The reference's Frequent-Directions accumulator (``repro.lowrank.fd``) is not
ported yet: its names here raise ``NotImplementedError``.
"""
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
from repro_torch.utils.device import not_ported


def _fd_not_ported(*args, **kwargs):
    raise not_ported("repro.lowrank.fd (Frequent Directions)", "Low-rank FD and refinement")


FDState = fd_init = fd_update = fd_finalize = fd_finalize_mean = _fd_not_ported
