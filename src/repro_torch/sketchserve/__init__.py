"""Sketch-as-a-service: online multi-tenant estimator serving, on the card.

The subsystem that turns the one-shot ``fit`` APIs into a long-lived server:
an async request queue (:class:`SketchService`) accepting ingest / query /
admin requests, a pool of micro-batching worker loops over disjoint group
partitions (each coalescing same-group ingest into one sketch+fold pass),
per-tenant execution :class:`~repro_torch.api.Plan`\\ s with admission
control, lazy finalization, crash-safe snapshot/restore over
:mod:`repro_torch.train.checkpoint` with an auto-snapshot
:class:`SnapshotPolicy`,
tenant TTL/LRU eviction to snapshot, and a stdlib HTTP frontend
(:class:`HttpFrontend`) that carries backpressure as 429s.

The port of ``repro.sketchserve`` with the same public names; the service
takes ``device=`` ("cuda" by default) for every estimator it creates, and a
snapshot either package writes restores in the other.

Start here: :mod:`repro_torch.sketchserve.service` (the model and the loop),
:mod:`repro_torch.sketchserve.protocol` (the request/response types and the
wire mapping), :mod:`repro_torch.sketchserve.snapshot` (what persists and
why restore is bit-identical), :mod:`repro_torch.sketchserve.http` (the wire
layer). ``python -m repro_torch.launch.sketch_serve`` drives a synthetic
workload end to end (``--supervise`` adds crash-restart).
"""
from repro_torch.sketchserve.http import HttpFrontend, serve_http
from repro_torch.sketchserve.protocol import (AdminRequest, IngestRequest,
                                              QueryRequest, Response,
                                              response_to_json)
from repro_torch.sketchserve.service import ESTIMATORS, SketchService, SnapshotPolicy
from repro_torch.sketchserve.snapshot import restore_group, restore_service, save_service

__all__ = [
    "AdminRequest",
    "ESTIMATORS",
    "HttpFrontend",
    "IngestRequest",
    "QueryRequest",
    "Response",
    "SketchService",
    "SnapshotPolicy",
    "response_to_json",
    "restore_group",
    "restore_service",
    "save_service",
    "serve_http",
]
