"""Request/response types of the sketch-serving queue.

Three request families, one response shape:

- :class:`IngestRequest` — rows for a tenant (or a whole co-registered
  group); the worker loop coalesces contiguous same-group ingests into one
  sketch+fold step (micro-batching).
- :class:`QueryRequest` — read against live estimator state: ``transform`` /
  ``predict`` (row payloads), ``components`` / ``centers`` / ``mean`` /
  ``cov`` / ``stats`` (fitted attributes). Queries trigger lazy finalization.
- :class:`AdminRequest` — tenant lifecycle (``create_tenant`` /
  ``delete_tenant``), ``snapshot``, and ``refine``.

Every request resolves to a :class:`Response` with ``status`` ∈
{"ok", "rejected", "error"} — "rejected" is admission-control backpressure
(full queue or per-group pending-row cap: resubmit later), "error" is a
request that was admitted but failed (unknown tenant, no data yet, bad op).

The same three statuses ARE the wire protocol: :func:`response_to_json`
flattens a Response (numpy payloads → nested lists) for the HTTP frontend
in :mod:`repro_torch.sketchserve.http`, and :data:`HTTP_STATUS` fixes the
status-code mapping — ok → 200, rejected → 429 (backpressure: Retry-After
and resubmit), error → 400.

A carried-over copy of ``repro.sketchserve.protocol`` (stdlib and numpy), so
the two packages speak one wire format.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

#: Response.status → HTTP status code (the http.py frontend contract).
HTTP_STATUS = {"ok": 200, "rejected": 429, "error": 400}


@dataclasses.dataclass
class IngestRequest:
    """Rows for ``target`` (a tenant id or a group id — a tenant id addresses
    its whole group: co-registered tenants fold the same shared sketches)."""

    target: str
    rows: Any                      # (b, p) array-like


@dataclasses.dataclass
class QueryRequest:
    tenant: str
    op: str                        # transform|predict|components|centers|mean|cov|stats
    x: Any | None = None           # row payload for transform/predict


@dataclasses.dataclass
class AdminRequest:
    op: str                        # create_tenant|delete_tenant|snapshot|refine
    params: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Response:
    status: str                    # ok | rejected | error
    result: Any = None
    error: str | None = None
    info: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def unwrap(self) -> Any:
        """``result`` if ok, else raise (rejected and failed requests alike)."""
        if not self.ok:
            raise RuntimeError(f"request {self.status}: {self.error}")
        return self.result


def _jsonable(v):
    """Payload values → JSON-encodable: arrays nest as lists, numpy scalars
    unbox, dicts/sequences recurse."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def response_to_json(resp: Response) -> dict:
    """Response → JSON-safe dict (the HTTP response body)."""
    return {"status": resp.status, "result": _jsonable(resp.result),
            "error": resp.error, "info": _jsonable(resp.info)}
