"""Second-pass refinement over the regenerable source — nothing stored.

Every backend regenerates a batch's mask from the ``(seed, step, shard)``
contract (``core.sketch.batch_key``), so a replay of the source reproduces
every sketch bit for bit, and extra passes cost no stored data.

- :mod:`repro_torch.refine.power` — PCA power iteration: replay with Ω
  replaced by the current basis Q, Y = S·Q accumulated by the range-finder's
  K5/K6 delta, finalized through the one-pass core solve.
- :mod:`repro_torch.refine.kmeans2` — two-pass (Alg. 2) K-means: re-assign
  every row against frozen centers (K4) and rebuild them from those
  assignments (K6's walk and an integer histogram); reassignment counts are
  the convergence signal.
- :mod:`repro_torch.refine.replay` — the shared replay loop: one
  regenerated sketch per (step, shard) chunk per pass, fanned out to every
  refiner.

Front doors: ``Plan(refine_passes=q)`` with ``SparsifiedPCA.fit_refine`` /
``SparsifiedKMeans.fit_refine``, ``StreamEngine.replay()`` /
``replay_scanned()``, and ``fit_many(..., refine=True)``.
"""
from repro_torch.refine.kmeans2 import (  # noqa: F401
    KMeans2State,
    kmeans2_apply,
    kmeans2_centers,
    kmeans2_delta,
    kmeans2_init,
)
from repro_torch.refine.power import (  # noqa: F401
    debiased_action,
    power_finalize,
    power_orth,
    subspace_change,
)
from repro_torch.refine.replay import replay_sketches, run_refine  # noqa: F401
