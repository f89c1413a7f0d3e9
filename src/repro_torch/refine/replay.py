"""Replay of the regenerable source — the second-pass loop.

Every backend keys chunk j's mask with ``sketch.batch_key(spec, step, shard)``
where ``(step, shard) = plan.step_shard(j)``, so a finished pass's sketches
regenerate bit for bit from (plan, spec) and the original data (an in-memory
array or a ``(seed, step, shard)`` source). :func:`replay_sketches` is that
regeneration as a generator; :func:`run_refine` walks it once per refinement
pass and fans each sketch out to every refiner — one sketch per chunk per
pass, shared by all refiners as the forward
:class:`~repro_torch.api.estimators.SketchCursor` pass shares it.

Refiner protocol (implemented by ``SparsifiedPCA`` / ``SparsifiedKMeans``):

- ``_refine_pass_begin(f)``        — allocate the pass-f fold state;
- ``_refine_fold(s, step, shard)`` — fold one replayed sketch;
- ``_refine_pass_end(f, last, signal)`` — rebuild (orthonormalize the power
  basis / rebuild the frozen-assignment centers);
- ``_refine_end(passes)``          — finalize the fitted attributes;
- ``_refine_needs_signal()``       — True to ask for ONE trailing
  measurement-only replay (fold ``f == passes``, its rebuild discarded), which
  prices the last rebuild's reassignment count.
"""
from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.cluster import bootstrap
from repro_torch.core import sketch as sketch_mod
from repro_torch.core.sampling import SparseRows
from repro_torch.core.sketch import batch_key


def replay_sketches(plan, spec: sketch_mod.SketchSpec, data=None, *, source=None,
                    steps: int | None = None, seed: int | None = None,
                    chunk_rows: Sequence[int] | None = None, device="cuda",
                    ) -> Iterator[tuple[SparseRows, int, int]]:
    """Yield ``(sketch, step, shard)``, regenerating a finished pass exactly.

    ``data``: the SAME (rows, p) array (numpy or torch) the pass ingested,
    re-chunked at the recorded ``chunk_rows`` boundaries (the cursor's rows
    per chunk, so ragged ``partial_fit`` histories replay under their original
    (step, shard) mask keys), or in ``plan.batch_size`` chunks when
    ``chunk_rows`` is None; each chunk is moved to ``device`` on its own.
    ``source``: the pass's normalized ``(seed, step, shard) → (b, p)`` source,
    pulled for ``steps`` × ``plan.n_shards`` batches.
    """
    from repro_torch.api.estimators import torch_dtype  # deferred: api imports refine

    if (data is None) == (source is None):
        raise ValueError("replay needs exactly one of data or source=")
    dtype = torch_dtype(plan.dtype)
    if data is not None:
        x = data if torch.is_tensor(data) else np.asarray(data)
        if x.ndim != 2 or x.shape[1] != spec.p:
            raise ValueError(f"replay data has shape {tuple(x.shape)}, but the fitted "
                             f"pass was p={spec.p}")
        n = int(x.shape[0])
        bs = plan.batch_size
        if chunk_rows is None:
            chunk_rows = [min(bs, n - i) for i in range(0, n, bs)]
        elif sum(chunk_rows) != n:
            raise ValueError(
                f"chunk_rows sums to {sum(chunk_rows)} but the replay data "
                f"has {n} rows — pass the array the fitted pass consumed")
        i = 0
        for j, rows in enumerate(chunk_rows):
            step, shard = plan.step_shard(j)
            chunk = torch.as_tensor(x[i:i + rows]).to(device=device, dtype=dtype)
            yield (sketch_mod.sketch(chunk, spec, batch_key=batch_key(spec, step, shard),
                                     impl=plan.impl), step, shard)
            i += rows
    else:
        if steps is None:
            raise ValueError("source= replay needs steps=")
        for step in range(steps):
            for shard in range(plan.n_shards):
                rows = torch.as_tensor(source(seed, step, shard)).to(device=device, dtype=dtype)
                if rows.shape[-1] != spec.p:
                    raise ValueError(f"source batch has p={rows.shape[-1]}, "
                                     f"fitted pass was p={spec.p}")
                yield (sketch_mod.sketch(rows, spec, batch_key=batch_key(spec, step, shard),
                                         impl=plan.impl), step, shard)


def run_refine(plan, spec: sketch_mod.SketchSpec, refiners: Sequence, passes: int,
               data=None, *, source=None, steps: int | None = None,
               seed: int | None = None, chunk_rows: Sequence[int] | None = None,
               device="cuda") -> None:
    """Drive ``passes`` refinement passes over the regenerated sketch stream.

    Each pass regenerates every (step, shard) sketch ONCE and fans it out to
    every refiner. A trailing measurement-only fold runs iff some refiner asks
    for it; the others are not fed during it.
    """
    if passes < 1:
        raise ValueError(f"refinement needs passes >= 1, got {passes}")
    if bootstrap.is_multiprocess():
        # every process would replay every chunk, and the sharded refiners'
        # all-reduce would count each chunk once a process
        raise ValueError("refinement replays every (step, shard) chunk in this process; "
                         "under a multi-process runtime refine through the engine's "
                         "replay(), which folds each process's own shards")
    refiners = list(refiners)
    signal = [r for r in refiners if r._refine_needs_signal()]
    for f in range(passes + (1 if signal else 0)):
        is_signal = f >= passes
        active = signal if is_signal else refiners
        for r in active:
            r._refine_pass_begin(f)
        for s, step, shard in replay_sketches(plan, spec, data, source=source, steps=steps,
                                              seed=seed, chunk_rows=chunk_rows, device=device):
            for r in active:
                r._refine_fold(s, step, shard)
        for r in active:
            r._refine_pass_end(f, last=(f == passes - 1), signal=is_signal)
    for r in refiners:
        r._refine_end(passes)
