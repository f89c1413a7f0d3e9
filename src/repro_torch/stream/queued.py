"""QueueSource — live pushed chunks behind the (seed, step, shard) contract.

The StreamEngine / ``fit_stream`` / ``fit_many(source=)`` contract is a pure
function ``(seed, step, shard) → (b, p)``; a serving loop instead receives
chunks *pushed* at it. :class:`QueueSource` bridges the two: producers
``push()`` (b, p) arrays in arrival order, and the source hands chunk
``j = step · n_shards + shard`` to whoever pulls it — blocking (with a
timeout) until the producer catches up, so an engine pass can run concurrently
with ingestion.

A queue cannot *regenerate* chunks the way the contract's pure sources can, so
by default each chunk is retained after being served (``retain=True``): replay
— second-pass :mod:`repro_torch.refine` refinement, or a restarted pass — re-reads
the buffer. ``retain=False`` drops each chunk once pulled (true constant
memory); pulling a dropped chunk then raises, which is the honest answer for a
one-shot stream.

``close()`` marks the stream complete: pulls past the last pushed chunk fail
fast instead of blocking out the timeout, and ``steps(n_shards)`` reports how
many FULL steps the buffer covers (what you pass to ``engine.run`` /
``fit_stream``).
"""
from __future__ import annotations

import threading

import numpy as np


class QueueSource:
    """Thread-safe push-side adapter to the ``(seed, step, shard)`` contract.

    Producers call :meth:`push`; consumers hand the object itself to
    ``normalize_source`` / ``StreamEngine`` / ``fit_stream`` (it exposes the
    ``batch_at(step, shard)`` protocol). Chunks map to (step, shard) in push
    order: the j-th pushed chunk serves ``(step, shard) = divmod(j, n_shards)``.
    """

    def __init__(self, n_shards: int = 1, retain: bool = True,
                 timeout: float = 30.0):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.retain = bool(retain)
        self.timeout = float(timeout)
        self._chunks: dict[int, np.ndarray] = {}
        self._pushed = 0
        self._closed = False
        self._cond = threading.Condition()

    # ------------------------------------------------------------ producer --

    def push(self, rows) -> int:
        """Append one (b, p) chunk; returns its linear chunk index."""
        rows = np.asarray(rows)
        if rows.ndim != 2:
            raise ValueError(f"expected a (rows, p) chunk, got shape {rows.shape}")
        with self._cond:
            if self._closed:
                raise RuntimeError("push() after close(): the stream is complete")
            j = self._pushed
            self._chunks[j] = rows
            self._pushed += 1
            self._cond.notify_all()
            return j

    def close(self) -> None:
        """No more chunks will arrive — blocked pulls past the end fail fast."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # ------------------------------------------------------------ consumer --

    def steps(self, n_shards: int | None = None) -> int:
        """Full (step × n_shards) blocks currently buffered."""
        with self._cond:
            return self._pushed // (n_shards or self.n_shards)

    def batch_at(self, step: int, shard: int):
        """The chunk at (step, shard) — blocks until pushed, or raises if the
        stream closed short / the chunk was already dropped (retain=False)."""
        j = step * self.n_shards + shard
        with self._cond:
            while j >= self._pushed:
                if self._closed:
                    raise RuntimeError(
                        f"chunk (step={step}, shard={shard}) is past the end of "
                        f"a closed QueueSource ({self._pushed} chunks pushed)")
                if not self._cond.wait(timeout=self.timeout):
                    raise TimeoutError(
                        f"no chunk for (step={step}, shard={shard}) after "
                        f"{self.timeout}s — producer stalled? (push() more or "
                        "close())")
            if j not in self._chunks:
                raise RuntimeError(
                    f"chunk (step={step}, shard={shard}) was already served and "
                    "dropped (retain=False); a replayable stream needs "
                    "retain=True")
            rows = self._chunks[j]
            if not self.retain:
                del self._chunks[j]
            return rows
