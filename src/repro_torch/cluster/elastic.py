"""Elastic re-sharding: survive worker-count changes by remapping the grid.

The logical (step, shard) grid is fixed by the sketch-mask key discipline —
shard s of step t always folds the same rows under the same mask, whichever
worker computes it. A worker-count change is therefore a pure remap:
:func:`worker_shards` gives each of ``n_workers`` a contiguous block of the
``n_shards`` logical shards, and each worker replays only the shards its new
block owns (a lost shard is a replayable (seed, step, shard) key, not lost
data).

Per step, every worker's :func:`partial_step_delta` is taken against the same
replicated step-start state; the fixed-size deltas are :func:`merge_deltas`'d
(element-wise add — the engine's within-step sum) and applied once by
:func:`apply_step`. The per-shard deltas are the original layout's and the
apply happens once a step either way, so a 4-worker run, its 2-worker
continuation and the one-process run agree to float-summation order (and bit
for bit where the sums keep their order, as 2 → 1 workers does).

:func:`continue_elastic` runs that protocol in one process; across
processes each worker runs its ``partial_step_delta`` and the deltas meet in
one all-reduce (``stream.sharded.psum``).
"""
from __future__ import annotations

import functools

from repro_torch.cluster.bootstrap import contiguous_blocks, stack_batches
from repro_torch.stream.engine import EngineState, StreamEngine


def worker_shards(n_shards: int, n_workers: int, worker: int) -> list[int]:
    """The contiguous block of logical shards worker ``worker`` owns under an
    ``n_workers``-worker layout (earlier workers take the remainder)."""
    if not 0 <= worker < n_workers:
        raise ValueError(f"worker must be in [0, {n_workers}), got {worker}")
    if n_workers > n_shards:
        raise ValueError(f"{n_workers} workers over {n_shards} logical shards "
                         "leaves workers idle — lower n_workers")
    return contiguous_blocks(n_shards, n_workers)[worker]


def partial_step_delta(engine: StreamEngine, state: EngineState, step: int,
                       shards: list[int], seed: int | None = None):
    """One worker's summed delta for ``step``: fold ONLY ``shards``' batches
    — regenerated from the (seed, step, shard) contract and sketched under
    their grid-fixed mask keys — against the step-start ``state``."""
    if not shards:
        raise ValueError("partial_step_delta needs at least one shard")
    deltas = None
    for sh in shards:
        x = stack_batches([engine.source(seed, step, sh)], engine.device)[0]
        d, _ = engine._deltas(state, engine._sketch_local(x, step, sh))
        deltas = d if deltas is None else engine._add(deltas, d)
    return deltas


def merge_deltas(a, b):
    """Combine two workers' partial deltas — element-wise add, the same sum
    the engine takes within a step."""
    return StreamEngine._add(a, b)


def apply_step(engine: StreamEngine, state: EngineState, delta) -> EngineState:
    """Apply one step's merged delta ONCE — the engine's per-step discipline
    (K-means decay and the Eq.-39 mean update happen here, exactly once)."""
    return engine._apply(state, delta)


def continue_elastic(engine: StreamEngine, steps: int, *, state: EngineState,
                     start_step: int, n_workers: int,
                     seed: int | None = None) -> EngineState:
    """Continue a (restored) run to ``steps`` under a NEW worker count.

    The elastic protocol in one process: per remaining step, each of
    the ``n_workers`` simulated workers folds its :func:`worker_shards` block
    against the shared step-start state; the deltas merge and apply once.
    Reassignment counters (if tracked) are frozen — they need the per-shard
    sketches the protocol does not ship.
    """
    for step in range(start_step, steps):
        deltas = [partial_step_delta(engine, state, step,
                                     worker_shards(engine.n_shards, n_workers, w), seed)
                  for w in range(n_workers)]
        state = apply_step(engine, state, functools.reduce(merge_deltas, deltas))
    engine.state = state
    return state
