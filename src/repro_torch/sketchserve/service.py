"""SketchService — the online estimator-serving loop, on the card.

The port of ``repro.sketchserve.service``: callers ``submit()`` requests
into a bounded ``queue.Queue`` and get back a ``concurrent.futures.Future``;
worker threads drain the queues in micro-batches and coalesce *ingest*:
contiguous same-group
:class:`~repro_torch.sketchserve.protocol.IngestRequest` rows drained in one
sweep are concatenated and folded through ONE ``SketchCursor.partial_fit``
call — one sketch+fold pass instead of one per request. Coalescing changes
chunk boundaries (hence which (step, shard) mask key covers which rows)
relative to one-request-per-fold, which the estimator contract explicitly
permits — every chunking is a valid estimate; the batching is pure
throughput.

Tenancy. A *tenant* is one estimator (mean / cov / pca / kmeans) with an id.
Tenants created with the same ``group=`` co-register on one shared
:class:`~repro_torch.api.estimators.SketchCursor` — the
:func:`repro_torch.api.fit_many` discipline — so an ingest addressed to the group compresses rows ONCE and
fans the sketch to every member (their plans must agree on the sketch
geometry fields and share a key, enforced by the same check ``fit_many``
runs). A tenant created without ``group=`` gets a private one-member group
under its own id. Per-tenant live state is sketch-sized — the reducer's
moment/lowrank state plus any retained sketch parts — never the (p, p)
accumulator on the lowrank path, which is what lets thousands of tenants
stay resident.

Workers and ordering. ``workers=N`` runs N worker loops over DISJOINT group
partitions: a group hashes to exactly one worker (stable crc32, so the
assignment survives restarts), every request for that group — ingest,
queries against its tenants, its admin ops — lands in that worker's queue,
and the queue is FIFO. Per group there is therefore still exactly ONE
producer into the cursor and the fold order is exactly submission order, so
per-group results are bit-identical to the single-worker service on the same
request sequence (whenever chunk boundaries agree, e.g. batch_size-multiple
requests; the per-cursor lock contract in
:class:`~repro_torch.api.estimators.SketchCursor` is what permits the pool).
Every worker launches on the card's default stream, so the kernels of
different groups run one after another in launch order, and a snapshot
taken on worker 0 after a quiesce reads state no other worker is still
writing.
Cross-group interleaving is whatever the partition yields — groups are
independent streams, so that was never observable anyway.

Admission control. Two bounds, both answered with a ``status="rejected"``
Response instead of unbounded buffering: each worker queue (``max_queue``
requests per worker; ``submit`` never blocks) and a per-group cap on rows
admitted but not yet folded (``max_pending_rows``). Rejected ingest is the
backpressure signal — the producer resubmits later (the HTTP frontend in
:mod:`repro_torch.sketchserve.http` surfaces it as a 429).

Supervision. A :class:`SnapshotPolicy` plus ``snapshot_dir=`` auto-snapshots
the whole service on worker 0 at fold boundaries (every N folded rows and/or
every T seconds, skipped while no new rows folded). Multi-worker snapshots
quiesce the pool first — every worker parks between folds — so the written
state is a global fold boundary; ``launch/sketch_serve.py --supervise``
closes the loop by restarting a crashed process from the latest snapshot and
replaying the continuation bit-identically.

Tenant eviction. ``ttl_s=`` / ``max_tenants=`` bound the registry in
long-lived deployments: a group idle past its TTL (or the least-recently
used groups while over the tenant bound) is *evicted to snapshot* — its
cursor+tenant state is written under ``evict_dir`` before removal — and
lazily restored on the next ingest/query/admin that touches it, resuming
bit-identically (same snapshot format as ``snapshot()``). Groups with queued
ingest are never evicted; eviction runs on each group's owner worker, so it
can never race a fold.

Liveness. A worker thread never dies on a bad request: per-run fold failures
answer error responses, and anything that still escapes a sweep is caught in
the loop, failing the batch's unresolved futures instead of hanging every
caller. ``stop()`` resolves every already-submitted request, then fails
stragglers and all later submissions with an error response — no Future
ever dangles, across every worker.

Lazy finalization. Ingest only folds; ``finalize()`` (eigendecompositions,
Lloyd iterations) runs when a query arrives for a tenant whose folded row
count moved since it last finalized. A tenant that is written often and read
rarely never pays finalize on the write path.

Device. ``device=`` ("cuda" by default) is where every estimator the service
creates lives and folds. Ingest rows may be numpy arrays, as the reference
takes them, or tensors, as the port's front door takes them; a tensor on the
card is folded where it is, with no copy to the host. Answers come back as
numpy arrays (the wire format). The reference's ``scan="auto"`` sends a
burst of full steps through its ``lax.scan`` ingest; the port has no scan
ingest (``fit_many(scan=True)`` runs the host loop too), so both settings
run the host fold loop and give the same bits.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import re
import tempfile
import threading
import time
import zlib
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.estimators import (SketchCursor, SparsifiedCov, SparsifiedKMeans,
                                        SparsifiedMean, SparsifiedPCA, as_key, torch_dtype)
from repro_torch.api.fused import _check_consumer
from repro_torch.api.plan import Plan
from repro_torch.sketchserve.protocol import (AdminRequest, IngestRequest,
                                              QueryRequest, Response)
from repro_torch.stream.state import state_nbytes
from repro_torch.utils.device import resolve_device
from repro_torch.utils.host import to_host

ESTIMATORS = {
    "mean": SparsifiedMean,
    "cov": SparsifiedCov,
    "pca": SparsifiedPCA,
    "kmeans": SparsifiedKMeans,
}

_ID_RE = re.compile(r"^[A-Za-z0-9._-]+$")
_STOP = object()
#: idle poll period of a worker's queue.get — bounds how late a parked-worker
#: snapshot quiesce, an every_s auto-snapshot, or a TTL sweep can fire.
_IDLE_TICK = 0.1
#: how long a snapshot waits for the other workers to reach a fold boundary.
_QUIESCE_TIMEOUT = 120.0


@dataclasses.dataclass(frozen=True)
class SnapshotPolicy:
    """Auto-snapshot cadence for a long-lived service.

    ``every_rows``: snapshot once that many NEW rows have folded since the
    last snapshot. ``every_s``: snapshot at most that often — and only when
    new rows folded since the last one, so an idle service never rewrites
    identical checkpoints. Both may be set; either firing triggers. Checks
    run on worker 0 at fold boundaries (after each drained batch and on idle
    ticks), so a snapshot never lands mid-fold.
    """

    every_rows: int | None = None
    every_s: float | None = None

    def __post_init__(self):
        if self.every_rows is None and self.every_s is None:
            raise ValueError("SnapshotPolicy needs every_rows and/or every_s")
        if self.every_rows is not None and self.every_rows <= 0:
            raise ValueError(f"every_rows must be > 0, got {self.every_rows}")
        if self.every_s is not None and self.every_s <= 0:
            raise ValueError(f"every_s must be > 0, got {self.every_s}")


def _ok(result=None, **info) -> Response:
    return Response("ok", result=result, info=info)


def _err(msg: str) -> Response:
    return Response("error", error=msg)


def _rejected(msg: str) -> Response:
    return Response("rejected", error=msg)


def _resolve(fut: Future, resp: Response) -> None:
    """Deliver a response unless the caller already cancelled the Future —
    set_result on a cancelled future raises, and nothing raised on the worker
    thread may kill the loop."""
    if fut.set_running_or_notify_cancel():
        fut.set_result(resp)


class _Quiesce:
    """Worker-0's stop-the-world for cross-worker snapshots.

    The initiator raises ``want``; every OTHER live worker parks at its next
    fold boundary (between drained batches, or on an idle tick); the
    ``held()`` block then runs with no fold in flight anywhere; releasing
    wakes the parked workers. Workers that exit (``stop()``) decrement
    ``live``, so a shutdown racing a snapshot can never strand the initiator.
    """

    def __init__(self, n: int):
        self._cv = threading.Condition()
        self._live = n
        self._want = False
        self._parked = 0
        self._gen = 0

    def worker_exit(self) -> None:
        with self._cv:
            self._live -= 1
            self._cv.notify_all()

    def park_if_wanted(self, timeout: float = _QUIESCE_TIMEOUT) -> None:
        with self._cv:
            if not self._want:
                return
            gen = self._gen
            self._parked += 1
            self._cv.notify_all()
            self._cv.wait_for(lambda: not self._want or self._gen != gen,
                              timeout)
            self._parked -= 1
            self._cv.notify_all()

    def held(self, timeout: float = _QUIESCE_TIMEOUT):
        q = self

        class _Held:
            def __enter__(self):
                with q._cv:
                    q._want = True
                    ok = q._cv.wait_for(lambda: q._parked >= q._live - 1,
                                        timeout)
                if not ok:
                    self.__exit__(None, None, None)
                    raise RuntimeError(
                        "snapshot quiesce timed out waiting for workers to "
                        "reach a fold boundary")
                return self

            def __exit__(self, *exc):
                with q._cv:
                    q._want = False
                    q._gen += 1
                    q._cv.notify_all()

        return _Held()


def _as_rows(rows):
    """Ingest or query rows as given: a tensor stays a tensor (on its device),
    anything else becomes a numpy array, as the reference coerces it."""
    return rows if torch.is_tensor(rows) else np.asarray(rows)


def _concat_rows(blocks: list, device: torch.device, dtype: torch.dtype):
    """One block of rows from several: numpy blocks concatenate on the host;
    where any block is a tensor, all move to ``device`` as ``dtype`` (what the
    cursor casts each chunk to) and concatenate there."""
    if len(blocks) == 1:
        return blocks[0]
    if not any(torch.is_tensor(b) for b in blocks):
        return np.concatenate(blocks)
    return torch.cat([torch.as_tensor(b).to(device=device, dtype=dtype) for b in blocks])


class _Ingest:
    """Internal queue record for an admitted ingest. The caller's
    :class:`IngestRequest` is never mutated: rows are coerced and the target
    is normalized to the group id here instead, so a retained request object
    can be logged or resubmitted unchanged."""

    __slots__ = ("gid", "rows")

    def __init__(self, gid: str, rows):
        self.gid, self.rows = gid, rows


class _Tenant:
    __slots__ = ("tid", "kind", "params", "est", "group", "finalized_rows",
                 "finalize_count")

    def __init__(self, tid, kind, params, est, group):
        self.tid, self.kind, self.params = tid, kind, params
        self.est, self.group = est, group
        self.finalized_rows = -1     # cursor.count at last finalize (lazy)
        self.finalize_count = 0


class _Group:
    """One shared compression pass + the tenants riding it."""

    __slots__ = ("gid", "plan", "key", "cursor", "tenants", "pending_rows",
                 "retain_ingest", "retained", "last_access")

    def __init__(self, gid: str, plan: Plan, key, retain_ingest: bool, device):
        self.gid = gid
        self.plan = plan
        self.key = as_key(key)
        self.cursor = SketchCursor(plan, self.key, device)
        self.tenants: dict[str, _Tenant] = {}
        self.pending_rows = 0        # admitted but not yet folded (admission cap)
        self.retain_ingest = bool(retain_ingest)
        self.retained: list = []     # fold-order chunks (numpy or tensors), for refine replay
        self.last_access = time.monotonic()   # TTL / LRU eviction stamp

    def fold(self, rows) -> None:
        """One sketch+fold pass over a coalesced row block, by the host fold
        loop (the port has no scan ingest; see the module docstring)."""
        self.cursor.partial_fit(rows)
        if self.retain_ingest:
            self.retained.append(rows)


def _state_nbytes(t: _Tenant) -> int:
    """Resident fold-state bytes of one tenant (reducer moment/lowrank state,
    retained sketch parts, K-means state) — sketch-sized and
    row-count-independent on the stream backend, never (p, p) on the low-rank
    path; equal to the reference's count for the same tenant."""
    r = t.est._reducer
    trees = []
    if r is not None:
        trees.append(r.state)
        trees.append(list(r.parts))
    trees.append(getattr(t.est, "_km_state", None))
    return state_nbytes(trees)


class SketchService:
    """Async multi-tenant sketch server. See the module docstring for the
    model; the short version:

    >>> with SketchService(workers=4, device="cuda") as svc:
    ...     svc.create_tenant("p", "pca", plan=plan, key=7, n_components=4,
    ...                       group="g")
    ...     svc.create_tenant("k", "kmeans", plan=plan, key=7, k=8, group="g")
    ...     svc.ingest("g", rows).result()          # one pass feeds both
    ...     parts = svc.query("p", "components").unwrap()

    ``submit`` is the non-blocking core (returns a Future); ``call`` /
    ``query`` / ``ingest`` / ``create_tenant`` / ... are sugar over it. All
    state mutation happens on the owning worker thread; admin helpers block
    until their request is processed so a subsequent ingest always sees the
    tenant.

    ``scan=`` is accepted only so that the reference's callers run unchanged:
    it is checked for the values the reference takes and otherwise ignored,
    since both settings run the one host fold loop (module docstring).
    """

    #: legacy ``stats`` keys ↔ their registry counter names (``serve.<key>``)
    STAT_KEYS = ("requests", "ingest_requests", "ingest_folds", "ingest_rows",
                 "rejected", "queries", "finalizes", "snapshots", "evictions",
                 "evict_restores")

    def __init__(self, *, max_queue: int = 1024, max_batch: int = 64,
                 max_pending_rows: int = 1_000_000, scan: str = "auto",
                 registry: "obs.MetricsRegistry | None" = None,
                 workers: int = 1,
                 snapshot_policy: SnapshotPolicy | None = None,
                 snapshot_dir: str | None = None,
                 max_tenants: int | None = None, ttl_s: float | None = None,
                 evict_dir: str | None = None, device="cuda"):
        if scan not in ("auto", "never"):      # ignored past this check (class docstring)
            raise ValueError(f"scan must be 'auto' or 'never', got {scan!r}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if snapshot_policy is not None and snapshot_dir is None:
            raise ValueError("snapshot_policy needs snapshot_dir= to write to")
        if max_tenants is not None and max_tenants < 1:
            raise ValueError(f"max_tenants must be >= 1, got {max_tenants}")
        if ttl_s is not None and ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.max_pending_rows = int(max_pending_rows)
        self.n_workers = int(workers)
        self._queues: list[queue.Queue] = [
            queue.Queue(maxsize=int(max_queue)) for _ in range(self.n_workers)]
        self._groups: dict[str, _Group] = {}
        self._tenants: dict[str, _Tenant] = {}
        # Guards tenant/group-registry reads, admission accounting, the
        # stopped flag, and the metric updates submit threads make; the
        # worker-thread metrics are single-writer per series (each counter is
        # itself atomic, so readers never see torn values either way).
        self._reg_lock = threading.Lock()
        # Serializes eviction/restore transitions against each other AND
        # against snapshot's registry copy. Lock order: _evict_lock before
        # _reg_lock, everywhere.
        self._evict_lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._stopped = False
        self._quiesce = _Quiesce(self.n_workers)
        # snapshot supervision
        self.snapshot_policy = snapshot_policy
        self.snapshot_dir = snapshot_dir
        self._snap_step = 0
        self._folded_rows = 0            # under _reg_lock; feeds every_rows
        self._last_snap_rows = 0
        self._last_snap_t = time.monotonic()
        # tenant TTL / LRU eviction
        self.max_tenants = max_tenants
        self.ttl_s = ttl_s
        self.evict_dir = evict_dir
        self._evicted: dict[str, dict] = {}          # gid -> {path, tenants}
        self._evicted_tenants: dict[str, str] = {}   # tid -> gid
        self._evict_steps: dict[str, int] = {}
        self._sweep_every = min(1.0, ttl_s / 4) if ttl_s else 1.0
        self._last_sweep = [0.0] * self.n_workers
        # All service observability lives in one MetricsRegistry (pass a
        # shared one to aggregate several services / the engine into a single
        # exposition endpoint).
        self.registry = registry if registry is not None else obs.MetricsRegistry()
        self._c = {k: self.registry.counter(f"serve.{k}") for k in self.STAT_KEYS}
        self._g_queue_depth = self.registry.gauge("serve.queue_depth")
        self._g_wq = [self.registry.gauge("serve.worker_queue_depth",
                                          worker=str(i))
                      for i in range(self.n_workers)]
        self._g_pending = self.registry.gauge("serve.pending_rows")
        self._h_coalesce = self.registry.histogram("serve.coalesced_requests")
        self._h_latency = self.registry.histogram("serve.request_seconds")
        self._h_snapshot = self.registry.histogram("serve.snapshot_seconds")

    @property
    def stats(self) -> dict:
        """Legacy counter view, snapshotted under ``_reg_lock`` so a reader
        can never observe counts torn against a concurrent submit (the old
        bare-dict copy could). The keys are :attr:`STAT_KEYS`; richer series
        (queue depth, latency quantiles, per-group folds) live on
        :attr:`registry`."""
        with self._reg_lock:
            return {k: self._c[k].value for k in self.STAT_KEYS}

    # back-compat views of the single-worker attributes (tests, tooling)
    @property
    def _queue(self) -> queue.Queue:
        return self._queues[0]

    @property
    def _thread(self) -> threading.Thread | None:
        return self._threads[0] if self._threads else None

    def _worker_of(self, gid: str) -> int:
        """Stable group → worker partition (crc32, survives restarts)."""
        return zlib.crc32(gid.encode()) % self.n_workers

    # ------------------------------------------------------------ lifecycle --

    def start(self) -> "SketchService":
        if self._stopped:
            raise RuntimeError("service already stopped")
        if self._threads:
            raise RuntimeError("service already started")
        self._threads = [
            threading.Thread(target=self._loop, args=(i,), daemon=True,
                             name=f"sketchserve-worker-{i}")
            for i in range(self.n_workers)]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        """Resolve every already-submitted request, then stop the workers.
        Requests racing with (or arriving after) stop() resolve to an error
        response instead of hanging on a dead queue; a stopped service cannot
        be restarted."""
        with self._reg_lock:
            self._stopped = True
            threads, self._threads = self._threads, []
        if threads:
            for q in self._queues:
                q.put((_STOP, None))
            for t in threads:
                t.join()
        # Safety net: anything still queued (enqueued before _stopped was
        # observable, or never drained because the service was not started)
        # must not leave its Future unresolved forever.
        self._fail_queued("service stopped")

    def __enter__(self) -> "SketchService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------------------------------------------- submit --

    def submit(self, req) -> Future:
        """Enqueue one request; never blocks and never mutates ``req``. The
        Future resolves to a :class:`Response` — ``status="rejected"`` when
        admission control (full queue / per-group pending-row cap) turns it
        away, ``status="error"`` once the service has stopped. Every
        resolution — accepted, rejected, or failed at submit — lands in the
        ``serve.request_seconds`` histogram."""
        fut: Future = Future()
        fut._obs_t0 = time.perf_counter()   # submit→resolve latency, ALL paths
        if isinstance(req, IngestRequest):
            return self._submit_ingest(req, fut)
        if isinstance(req, AdminRequest):
            with self._reg_lock:
                stopped, setup = self._stopped, not self._threads
            if stopped:
                self._resolve_fut(fut, _err("service stopped"))
                return fut
            if setup:   # setup phase: no worker to serialize on
                self._resolve_fut(fut, self._handle_admin(req))
                return fut
            wid = self._route_admin(req)
        elif isinstance(req, QueryRequest):
            wid = self._route_target(req.tenant)
        else:
            self._resolve_fut(fut, _err(f"unknown request type "
                                        f"{type(req).__name__}"))
            return fut
        with self._reg_lock:
            if self._stopped:
                self._resolve_fut(fut, _err("service stopped"))
                return fut
            try:
                self._queues[wid].put_nowait((req, fut))
                self._note_queue_depth(wid)
            except queue.Full:
                self._c["rejected"].inc()
                self._resolve_fut(fut, _rejected(
                    f"request queue full ({self._queues[wid].maxsize}); "
                    "retry later"))
        return fut

    def _submit_ingest(self, req: IngestRequest, fut: Future) -> Future:
        rows = _as_rows(req.rows)
        if rows.ndim != 2:
            self._resolve_fut(fut, _err(f"ingest rows must be (b, p), got "
                                        f"shape {rows.shape}"))
            return fut
        n = int(rows.shape[0])
        for attempt in (0, 1):
            with self._reg_lock:
                if self._stopped:
                    self._resolve_fut(fut, _err("service stopped"))
                    return fut
                group = self._resolve_group(req.target)
                if group is not None:
                    spec = group.cursor.spec
                    if spec is not None and rows.shape[1] != spec.p:
                        self._resolve_fut(fut, _err(
                            f"group {group.gid!r} ingests p={spec.p} columns, "
                            f"got {rows.shape[1]}"))
                        return fut
                    if group.pending_rows + n > self.max_pending_rows:
                        self._c["rejected"].inc()
                        self._resolve_fut(fut, _rejected(
                            f"group {group.gid!r} has {group.pending_rows} "
                            f"rows pending (cap {self.max_pending_rows}); "
                            "retry after the backlog folds"))
                        return fut
                    group.pending_rows += n
                    group.last_access = time.monotonic()
                    wid = self._worker_of(group.gid)
                    try:
                        # target normalized to the gid on the internal record
                        # (not on req): maximal worker coalescing
                        self._queues[wid].put_nowait(
                            (_Ingest(group.gid, rows), fut))
                        self._g_pending.inc(n)
                        self._note_queue_depth(wid)
                    except queue.Full:
                        group.pending_rows -= n
                        self._c["rejected"].inc()
                        self._resolve_fut(fut, _rejected(
                            f"request queue full "
                            f"({self._queues[wid].maxsize}); retry later"))
                    return fut
            if attempt == 0:
                # unknown target: restore it if it was evicted, retry once
                try:
                    if not self._ensure_live(req.target):
                        break
                except Exception as e:  # noqa: BLE001
                    self._resolve_fut(fut, _err(
                        f"restore of evicted {req.target!r} failed: {e}"))
                    return fut
        self._resolve_fut(fut, _err(f"unknown tenant/group {req.target!r}"))
        return fut

    def call(self, req, timeout: float | None = 60.0) -> Response:
        """submit + wait."""
        return self.submit(req).result(timeout)

    # sugar ------------------------------------------------------------------

    def ingest(self, target: str, rows) -> Future:
        return self.submit(IngestRequest(target, rows))

    def query(self, tenant: str, op: str, x=None,
              timeout: float | None = 60.0) -> Response:
        return self.call(QueryRequest(tenant, op, x), timeout)

    def create_tenant(self, tid: str, kind: str, *, plan: Plan | None = None,
                      key=0, group: str | None = None,
                      retain_ingest: bool = False, **params) -> Response:
        resp = self.call(AdminRequest("create_tenant", dict(
            tid=tid, kind=kind, plan=plan, key=key, group=group,
            retain_ingest=retain_ingest, params=params)))
        resp.unwrap()   # raise on error — creation must not fail silently
        return resp

    def delete_tenant(self, tid: str) -> None:
        self.call(AdminRequest("delete_tenant", dict(tid=tid))).unwrap()

    def snapshot(self, path: str) -> int:
        """Checkpoint every live group/tenant (atomic-rename protocol of
        :mod:`repro_torch.train.checkpoint`); returns the snapshot step. A
        multi-worker service quiesces the pool first, so the snapshot is a
        global fold boundary."""
        return self.call(AdminRequest("snapshot", dict(path=path)),
                         timeout=None).unwrap()

    def refine(self, tenant: str, x=None, passes: int | None = None, *,
               tol: float | None = None, max_passes: int = 16) -> Response:
        """Second-pass replay refinement on one tenant, in the worker loop (so
        it serializes against ingest). ``x=None`` replays the group's retained
        ingest — requires ``retain_ingest=True`` at tenant creation."""
        return self.call(AdminRequest("refine", dict(
            tenant=tenant, x=x, passes=passes, tol=tol,
            max_passes=max_passes)), timeout=None)

    def tenants(self) -> list[str]:
        with self._reg_lock:
            return sorted(self._tenants)

    def evicted(self) -> list[str]:
        """Group ids currently evicted to snapshot (lazily restored on touch)."""
        with self._evict_lock:
            return sorted(self._evicted)

    # -------------------------------------------------------------- routing --

    def _route_target(self, target: str) -> int:
        """Tenant/group id → owning worker. Unknown ids fall back to the id's
        own hash (covers evicted groups, whose gid keeps its partition; a
        truly unknown id just gets its error answered by whichever worker)."""
        with self._reg_lock:
            t = self._tenants.get(target)
            if t is not None:
                return self._worker_of(t.group.gid)
            if target in self._groups:
                return self._worker_of(target)
        return self._worker_of(self._evicted_tenants.get(target, target))

    def _route_admin(self, req: AdminRequest) -> int:
        p = req.params
        if req.op == "create_tenant":
            return self._worker_of(p.get("group") or p.get("tid") or "")
        if req.op in ("delete_tenant", "refine"):
            return self._route_target(p.get("tid") or p.get("tenant") or "")
        return 0    # snapshot (and unknown ops) run on the snapshot initiator

    def _note_queue_depth(self, wid: int) -> None:
        self._g_wq[wid].set(self._queues[wid].qsize())
        self._g_queue_depth.set(sum(q.qsize() for q in self._queues))

    # ---------------------------------------------------------- worker loop --

    def _resolve_fut(self, fut: Future, resp: Response) -> None:
        """_resolve plus submit→resolve latency accounting (the ``_obs_t0``
        stamp placed at submit). Every resolution — worker-side or submit-side
        fast path — funnels through here, so rejected and failed requests
        show up in ``serve.request_seconds`` too."""
        t0 = getattr(fut, "_obs_t0", None)
        if t0 is not None:
            self._h_latency.observe(time.perf_counter() - t0)
        _resolve(fut, resp)

    def _loop(self, wid: int) -> None:
        q = self._queues[wid]
        stop = False
        try:
            while not stop:
                try:
                    items = [q.get(timeout=_IDLE_TICK)]
                except queue.Empty:
                    self._tick(wid)
                    continue
                while len(items) < self.max_batch:
                    try:
                        items.append(q.get_nowait())
                    except queue.Empty:
                        break
                self._note_queue_depth(wid)
                batch = []
                for req, fut in items:
                    if req is _STOP:
                        stop = True   # drain this batch, fail later arrivals
                    elif stop:
                        self._resolve_fut(fut, _err("service stopped"))
                    else:
                        batch.append((req, fut))
                if batch:
                    try:
                        self._process(batch)
                    except Exception as e:  # noqa: BLE001 — the worker must live
                        self._fail_batch(batch, e)
                for _ in items:
                    q.task_done()
                if not stop:
                    self._tick(wid)
        finally:
            self._quiesce.worker_exit()

    def _tick(self, wid: int) -> None:
        """Fold-boundary housekeeping: worker 0 drives the auto-snapshot
        policy; every other worker answers a pending quiesce; each worker
        sweeps its OWN groups for TTL/LRU eviction (so eviction never races a
        fold — the evicting thread is the only one that folds the group)."""
        if wid == 0:
            self._maybe_auto_snapshot()
        else:
            self._quiesce.park_if_wanted()
        self._maybe_evict(wid)

    def _fail_batch(self, batch, exc: Exception) -> None:
        """Last-resort guard around one _process sweep: resolve whatever the
        crashed sweep left unresolved (releasing its ingest reservations) so
        one bad batch can never hang every in-flight and future caller."""
        for req, fut in batch:
            if fut.done():
                continue
            if isinstance(req, _Ingest):
                # an unresolved ingest never reached _flush_ingest's
                # accounting, so its reservation is still held
                with self._reg_lock:
                    g = self._groups.get(req.gid)
                    if g is not None:
                        g.pending_rows -= int(req.rows.shape[0])
                self._g_pending.inc(-int(req.rows.shape[0]))
            self._resolve_fut(fut, _err(f"internal service error: {exc!r}"))

    def _fail_queued(self, msg: str) -> None:
        """Fail everything still sitting in the (dead) queues — stop() path."""
        for wid, q in enumerate(self._queues):
            while True:
                try:
                    req, fut = q.get_nowait()
                except queue.Empty:
                    break
                if isinstance(req, _Ingest):
                    with self._reg_lock:
                        g = self._groups.get(req.gid)
                        if g is not None:
                            g.pending_rows -= int(req.rows.shape[0])
                    self._g_pending.inc(-int(req.rows.shape[0]))
                if fut is not None and not fut.done():
                    self._resolve_fut(fut, _err(msg))
                q.task_done()
            self._g_wq[wid].set(0)
        self._g_queue_depth.set(sum(q.qsize() for q in self._queues))

    def _process(self, batch) -> None:
        """Serve one drained micro-batch in queue order, coalescing each
        contiguous run of same-group ingests into one fold. (Exposed for
        tests: drives the same path the worker thread runs.)"""
        pending: dict[str, list] = {}
        for req, fut in batch:
            if isinstance(req, _Ingest):
                pending.setdefault(req.gid, []).append((req, fut))
                continue
            self._flush_ingest(pending)   # queries/admin see all prior ingest
            pending = {}
            self._c["requests"].inc()
            if isinstance(req, QueryRequest):
                self._resolve_fut(fut, self._handle_query(req))
            else:
                self._resolve_fut(fut, self._handle_admin(req))
        self._flush_ingest(pending)

    def _flush_ingest(self, pending: dict[str, list]) -> None:
        for gid, items in pending.items():
            self._c["requests"].inc(len(items))
            self._c["ingest_requests"].inc(len(items))
            blocks = [req.rows for req, _ in items]
            n = sum(int(b.shape[0]) for b in blocks)
            with self._reg_lock:
                group = self._groups.get(gid)
            if group is None:   # deleted between submit and drain
                self._g_pending.inc(-n)
                for _, fut in items:
                    self._resolve_fut(fut, _err(f"unknown tenant/group {gid!r}"))
                continue
            try:
                # concatenate inside the try: column counts mismatched across
                # a coalesced run must answer error responses, not raise
                rows = _concat_rows(blocks, self.device, torch_dtype(group.plan.dtype))
                group.fold(rows)
                self._c["ingest_folds"].inc()
                self._c["ingest_rows"].inc(n)
                self._h_coalesce.observe(len(items))
                with self._reg_lock:
                    self._folded_rows += n   # feeds SnapshotPolicy.every_rows
                for tid in group.tenants:
                    self.registry.counter("serve.tenant_folds",
                                          tenant=tid).inc()
                resp = [_ok(int(b.shape[0]), group=group.gid,
                            coalesced=len(items), count=group.cursor.count)
                        for b in blocks]
            except Exception as e:  # a bad block poisons its whole coalesced run
                resp = [_err(f"ingest failed: {e}")] * len(items)
            finally:
                with self._reg_lock:
                    group.pending_rows -= n
                self._g_pending.inc(-n)
            for (_, fut), r in zip(items, resp):
                self._resolve_fut(fut, r)

    # ----------------------------------------------------------- supervision --

    def _maybe_auto_snapshot(self) -> None:
        """Worker-0 fold-boundary check of the SnapshotPolicy."""
        pol = self.snapshot_policy
        if pol is None or self._stopped:
            return
        with self._reg_lock:
            rows = self._folded_rows
        if rows == self._last_snap_rows:
            return   # nothing new folded — never rewrite identical snapshots
        now = time.monotonic()
        due = ((pol.every_rows is not None
                and rows - self._last_snap_rows >= pol.every_rows)
               or (pol.every_s is not None
                   and now - self._last_snap_t >= pol.every_s))
        if not due:
            return
        try:
            self._do_snapshot(self.snapshot_dir)
        except Exception:  # noqa: BLE001 — a failed snapshot must not kill serving
            self.registry.counter("serve.snapshot_errors").inc()

    def _do_snapshot(self, path: str) -> int:
        """One snapshot step. On a live multi-worker service, quiesce the
        pool first so no fold is in flight anywhere; on a single worker (or
        before start) the caller IS the only folder."""
        from repro_torch.sketchserve import snapshot as snap_mod

        self._snap_step += 1
        step = self._snap_step
        t0 = time.perf_counter()
        if self._threads and self.n_workers > 1:
            with self._quiesce.held():
                snap_mod.save_service(self, path, step=step)
        else:
            snap_mod.save_service(self, path, step=step)
        self._h_snapshot.observe(time.perf_counter() - t0)
        with self._reg_lock:
            self._last_snap_rows = self._folded_rows
        self._last_snap_t = time.monotonic()
        self._c["snapshots"].inc()
        return step

    # -------------------------------------------------------------- eviction --

    def _evict_base(self) -> str:
        with self._evict_lock:
            if self.evict_dir is None:
                self.evict_dir = tempfile.mkdtemp(prefix="sketchserve-evict-")
            return self.evict_dir

    def _maybe_evict(self, wid: int) -> None:
        """TTL / LRU sweep over THIS worker's groups (rate-limited)."""
        if self.max_tenants is None and self.ttl_s is None:
            return
        now = time.monotonic()
        if now - self._last_sweep[wid] < self._sweep_every:
            return
        self._last_sweep[wid] = now
        with self._reg_lock:
            mine = [g for gid, g in self._groups.items()
                    if self._worker_of(gid) == wid]
            over = (0 if self.max_tenants is None
                    else len(self._tenants) - self.max_tenants)
        mine.sort(key=lambda g: g.last_access)
        for g in mine:
            expired = (self.ttl_s is not None
                       and now - g.last_access >= self.ttl_s)
            if not expired and over <= 0:
                break   # sorted oldest-first: nothing older follows
            if g.pending_rows:
                continue   # queued ingest — never evict under a reservation
            if self._evict_group(g):
                over -= len(g.tenants)

    def _evict_group(self, g: _Group) -> bool:
        """Evict one idle group to snapshot: write its cursor+tenant state
        under ``evict_dir/<gid>``, then drop it from the live registry. Runs
        on the group's owner worker, so no fold can be in flight."""
        from repro_torch.sketchserve import snapshot as snap_mod

        path = os.path.join(self._evict_base(), g.gid)
        self._evict_steps[g.gid] = self._evict_steps.get(g.gid, 0) + 1
        try:
            snap_mod.save_service(self, path, step=self._evict_steps[g.gid],
                                  gids=[g.gid])
        except Exception:  # noqa: BLE001 — e.g. mid-step sharded state
            return False   # keep it live; retry at a later sweep
        with self._evict_lock:
            with self._reg_lock:
                if g.pending_rows or self._groups.get(g.gid) is not g:
                    return False   # raced with new ingest / delete — keep live
                for tid in list(g.tenants):
                    del self._tenants[tid]
                del self._groups[g.gid]
                self._evicted[g.gid] = {"path": path,
                                        "tenants": sorted(g.tenants)}
                for tid in g.tenants:
                    self._evicted_tenants[tid] = g.gid
        self._c["evictions"].inc()
        return True

    def _ensure_live(self, target: str) -> bool:
        """Restore an evicted tenant/group on first touch. Returns True if a
        restore happened (the caller should re-resolve the target), False if
        the target was never evicted. Raises if the restore itself fails (the
        eviction record is put back so a later touch can retry)."""
        with self._evict_lock:
            gid = (target if target in self._evicted
                   else self._evicted_tenants.get(target))
            if gid is None:
                return False
            ev = self._evicted.pop(gid)
            for tid in ev["tenants"]:
                self._evicted_tenants.pop(tid, None)
            try:
                from repro_torch.sketchserve import snapshot as snap_mod
                snap_mod.restore_group(self, gid, ev["path"])
            except Exception:
                self._evicted[gid] = ev
                for tid in ev["tenants"]:
                    self._evicted_tenants[tid] = gid
                raise
        self._c["evict_restores"].inc()
        return True

    # -------------------------------------------------------------- queries --

    def _handle_query(self, req: QueryRequest) -> Response:
        self._c["queries"].inc()
        t = self._tenants.get(req.tenant)
        if t is None:
            try:
                if self._ensure_live(req.tenant):
                    t = self._tenants.get(req.tenant)
            except Exception as e:  # noqa: BLE001
                return _err(f"restore of evicted tenant {req.tenant!r} "
                            f"failed: {e}")
        if t is None:
            return _err(f"unknown tenant {req.tenant!r}")
        t.group.last_access = time.monotonic()
        cur = t.group.cursor
        if req.op == "stats":
            return _ok({"kind": t.kind, "group": t.group.gid,
                        "rows": cur.count, "chunks": cur.chunk,
                        "n_sketches": cur.n_sketches,
                        "pending_rows": t.group.pending_rows,
                        "finalized_rows": t.finalized_rows,
                        "finalize_count": t.finalize_count,
                        "state_bytes": _state_nbytes(t)})
        if cur.count == 0:
            return _err(f"tenant {req.tenant!r} has no ingested rows yet")
        if t.finalized_rows != cur.count:   # lazy: only when state moved
            try:
                t.est.finalize()
            except Exception as e:
                return _err(f"finalize failed: {e}")
            t.finalized_rows = cur.count
            t.finalize_count += 1
            self._c["finalizes"].inc()
        try:
            return self._read_fitted(t, req.op, req.x)
        except AttributeError:
            return _err(f"op {req.op!r} does not apply to a {t.kind!r} tenant")
        except Exception as e:
            return _err(f"query {req.op!r} failed: {e}")

    def _read_fitted(self, t: _Tenant, op: str, x) -> Response:
        est = t.est
        if op == "mean":
            return _ok(to_host(est.mean_))
        if op == "cov":
            return _ok(to_host(est.cov_))
        if op == "components":
            return _ok({"components": to_host(est.components_),
                        "explained_variance": to_host(est.explained_variance_)})
        if op == "centers":
            return _ok(to_host(est.centers_))
        if op == "transform":
            if x is None:
                return _err("transform needs an x payload")
            return _ok(to_host(est.transform(_as_rows(x))))
        if op == "predict":
            if x is None:
                return _err("predict needs an x payload")
            return _ok(to_host(est.predict(_as_rows(x))))
        return _err(f"unknown query op {op!r} (transform|predict|components|"
                    "centers|mean|cov|stats)")

    # ---------------------------------------------------------------- admin --

    def _handle_admin(self, req: AdminRequest) -> Response:
        p = req.params
        try:
            if req.op == "create_tenant":
                return self._create_tenant(**p)
            if req.op == "delete_tenant":
                return self._delete_tenant(p["tid"])
            if req.op == "snapshot":
                return _ok(self._do_snapshot(p["path"]))
            if req.op == "refine":
                return self._refine(**p)
            return _err(f"unknown admin op {req.op!r}")
        except Exception as e:
            return _err(f"admin {req.op!r} failed: {e}")

    def _create_tenant(self, tid, kind, plan, key, group, retain_ingest,
                       params) -> Response:
        if not _ID_RE.match(tid or ""):
            return _err(f"tenant id {tid!r} must match {_ID_RE.pattern}")
        if tid in self._tenants or tid in self._groups:
            return _err(f"id {tid!r} already exists")
        if tid in self._evicted_tenants or tid in self._evicted:
            return _err(f"id {tid!r} already exists (evicted to snapshot)")
        if kind not in ESTIMATORS:
            return _err(f"unknown kind {kind!r} (one of {sorted(ESTIMATORS)})")
        gid = group if group is not None else tid
        if not _ID_RE.match(gid):
            return _err(f"group id {gid!r} must match {_ID_RE.pattern}")
        if gid in self._tenants and gid not in self._groups:
            return _err(f"group id {gid!r} collides with a tenant id")
        g = self._groups.get(gid)
        if g is None:
            if plan is None:
                return _err(f"first tenant of group {gid!r} must carry a plan")
            g = _Group(gid, plan, key, retain_ingest, self.device)
        est = ESTIMATORS[kind](plan=plan or g.plan, key=key, device=self.device, **params)
        # the fit_many co-registration check: shared sketch ⇒ shared geometry+key
        _check_consumer(g.plan, est, len(g.tenants), g.key)
        if g.cursor.count > 0:
            return _err(f"group {gid!r} already ingested {g.cursor.count} rows;"
                        " tenants must co-register before ingest starts (a late"
                        " joiner would silently miss them)")
        est._cursor = g.cursor
        g.cursor.register(est)
        t = _Tenant(tid, kind, dict(params), est, g)
        with self._reg_lock:
            if tid in self._tenants:   # raced a same-tid create on another worker
                g.cursor.consumers.remove(est)
                return _err(f"id {tid!r} already exists")
            g.tenants[tid] = t
            self._groups[gid] = g
            self._tenants[tid] = t
        return _ok(tid, group=gid)

    def _delete_tenant(self, tid) -> Response:
        t = self._tenants.get(tid)
        if t is None:
            # deleting an evicted tenant: restore first, then drop normally
            if self._ensure_live(tid):
                t = self._tenants.get(tid)
        if t is None:
            return _err(f"unknown tenant {tid!r}")
        g = t.group
        with self._reg_lock:
            del self._tenants[tid]
            del g.tenants[tid]
            if t.est in g.cursor.consumers:
                g.cursor.consumers.remove(t.est)
            if not g.tenants:
                del self._groups[g.gid]
        return _ok(tid, group_deleted=not g.tenants)

    def _refine(self, tenant, x, passes, tol, max_passes) -> Response:
        t = self._tenants.get(tenant)
        if t is None and self._ensure_live(tenant):
            t = self._tenants.get(tenant)
        if t is None:
            return _err(f"unknown tenant {tenant!r}")
        g = t.group
        g.last_access = time.monotonic()
        if x is None:
            if not g.retain_ingest:
                return _err(f"group {g.gid!r} was created with "
                            "retain_ingest=False and no x payload was given — "
                            "nothing to replay")
            if not g.retained:
                return _err("no ingested rows to replay yet")
            x = _concat_rows(g.retained, self.device, torch_dtype(g.plan.dtype))
        if t.finalized_rows != g.cursor.count:
            t.est.finalize()
            t.finalized_rows = g.cursor.count
            t.finalize_count += 1
        t.est.refine(_as_rows(x), passes, tol=tol, max_passes=max_passes)
        return _ok({"passes": int(getattr(t.est, "refine_passes_", 0)),
                    "converged": bool(getattr(t.est, "refine_converged_", False))})

    # -------------------------------------------------------------- helpers --

    def _resolve_group(self, target: str) -> _Group | None:
        """Tenant id or group id → group (caller holds _reg_lock)."""
        t = self._tenants.get(target)
        if t is not None:
            return t.group
        return self._groups.get(target)
