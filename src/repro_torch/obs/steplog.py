"""StepLogger — structured JSONL progress output for step loops.

One JSON object per line, append-only, machine-parseable — the levanter-style
hook-driven step log, minus the wandb dependency. Every record carries the
step index, a wall-clock timestamp, and whatever fields the caller passes;
numpy scalars/arrays coerce to plain JSON so engine metrics log without
ceremony. ``every=N`` downsamples at the logger (callers log every step and
the logger decides), which keeps call sites free of modulo logic.

:func:`read_jsonl` is the inverse — the round-trip the tests pin.
"""
from __future__ import annotations

import io
import json
import os
import time
from typing import Any, IO


def _jsonable(v: Any):
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:  # numpy scalar
        return v.item()
    if hasattr(v, "tolist"):                               # numpy array
        return v.tolist()
    return str(v)


class StepLogger:
    """Write structured per-step JSONL records to a path or stream.

    Parameters
    ----------
    path: file to append to (created, parent dirs made). Mutually exclusive
        with ``stream``.
    stream: an open text stream (e.g. ``sys.stderr``) — not closed on exit.
    every: emit only steps where ``step % every == 0`` (step 0 always logs;
        pass force=True to log an off-cadence record, e.g. the final step).
    static: fields stamped into every record (run id, host, config).
    """

    def __init__(self, path: str | None = None, stream: IO | None = None,
                 every: int = 1, static: dict | None = None):
        if (path is None) == (stream is None):
            raise ValueError("StepLogger needs exactly one of path= / stream=")
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.every = int(every)
        self.static = dict(static or {})
        self.path = path
        self._owns = path is not None
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f: IO = open(path, "a")
        else:
            self._f = stream
        self.emitted = 0

    def log(self, step: int, force: bool = False, **fields) -> bool:
        """Emit one record (subject to ``every``); returns whether it wrote."""
        if not force and step % self.every != 0:
            return False
        rec = {"step": int(step), "t": round(time.time(), 6), **self.static}
        for k, v in fields.items():
            rec[k] = v if isinstance(v, (int, float, str, bool, type(None),
                                         list, dict)) else _jsonable(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        self.emitted += 1
        return True

    def close(self) -> None:
        if self._owns and not self._f.closed:
            self._f.close()

    def __enter__(self) -> "StepLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path_or_stream) -> list[dict]:
    """Parse a JSONL file (or open stream) back into a list of records."""
    if isinstance(path_or_stream, (str, os.PathLike)):
        with open(path_or_stream) as f:
            return [json.loads(line) for line in f if line.strip()]
    if isinstance(path_or_stream, io.StringIO):
        path_or_stream.seek(0)
    return [json.loads(line) for line in path_or_stream if line.strip()]
