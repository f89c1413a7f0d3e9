"""Sketch-serving launcher: drive a synthetic multi-tenant workload through
:class:`repro_torch.sketchserve.SketchService` and report throughput/latency.

``python -m repro_torch.launch.sketch_serve --tenants 32 --groups 8 --requests 512``
(on the card; ``--device cpu`` runs it on the CPU)

Spins up the service (``--workers`` worker loops over the group partition),
creates ``--tenants`` tenants round-robin over ``--groups`` shared-sketch
groups (each group gets one PCA + one K-means co-registered on one
compression pass; extra members are means), fires ``--requests`` small
ingest requests with a query mixed in every ``--query-every``, then prints
requests/sec, fold coalescing, query p50/p99 (via
:func:`repro_torch.obs.quantiles`), the service's submit→resolve latency
distribution, and (optionally) snapshots to ``--snapshot``.
``--metrics-port`` serves the live registry as a Prometheus-style
``/metrics`` endpoint and ``--http-port`` the full
:mod:`repro_torch.sketchserve.http` frontend for the duration of the run.

Supervision. ``--snapshot-every-rows`` / ``--snapshot-every-s`` arm a
:class:`~repro_torch.sketchserve.SnapshotPolicy` writing to ``--snapshot``;
``--supervise`` turns the launcher into a supervisor: it runs the same
workload in a child process and, whenever the child dies mid-run, restarts
it with ``--resume`` — the child restores from the latest snapshot, derives
how many requests each group already folded, and replays only the
remainder. The workload in these modes is deterministic (request ``r``'s
rows come from ``default_rng(f(seed, r))`` and folds are serialized), so
the crashed-and-resumed run ends bit-identical to an uninterrupted one —
``--out`` writes the final per-group PCA components as JSON so two runs can
be diffed (``--crash-after K`` makes the first child attempt die after K
acked requests: ``tests/test_torch_sketchserve.py`` and ``chip_smoke.py``
phase 11 run that crash and resume).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", type=int, default=32)
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--p", type=int, default=64)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--rows-per-request", type=int, default=32)
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--query-every", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--workers", type=int, default=1,
                    help="worker loops over the group partition")
    ap.add_argument("--snapshot", default=None, help="checkpoint dir (optional)")
    ap.add_argument("--snapshot-every-rows", type=int, default=None,
                    help="auto-snapshot to --snapshot every N folded rows")
    ap.add_argument("--snapshot-every-s", type=float, default=None,
                    help="auto-snapshot to --snapshot at most every T seconds")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics on this port while the run lasts")
    ap.add_argument("--http-port", type=int, default=None,
                    help="serve the HTTP frontend on this port for the run")
    ap.add_argument("--supervise", action="store_true",
                    help="run the workload in a child process; restart it "
                         "from the latest snapshot if it crashes")
    ap.add_argument("--max-restarts", type=int, default=5)
    ap.add_argument("--crash-after", type=int, default=None,
                    help="die (exit 7) after this many acked ingest requests "
                         "— crash-injection for the --supervise smoke")
    ap.add_argument("--resume", action="store_true",
                    help="restore from --snapshot and replay only the "
                         "requests not yet folded")
    ap.add_argument("--out", default=None,
                    help="write final per-group PCA components as JSON "
                         "(deterministic mode; lets two runs be diffed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the service's estimators fold (default: the card)")
    return ap


def _supervise(args) -> int:
    """Parent loop: run the workload as a child process, restarting a crashed
    child from the latest snapshot (``--resume``) up to --max-restarts times.
    The first attempt carries --crash-after if given; retries never do — the
    injected crash fires once."""
    import subprocess

    if not args.snapshot:
        raise SystemExit("--supervise needs --snapshot (the restart source)")
    base = [sys.executable, "-m", "repro_torch.launch.sketch_serve",
            "--tenants", str(args.tenants), "--groups", str(args.groups),
            "--p", str(args.p), "--rank", str(args.rank),
            "--rows-per-request", str(args.rows_per_request),
            "--requests", str(args.requests),
            "--query-every", str(args.query_every),
            "--batch-size", str(args.batch_size),
            "--max-batch", str(args.max_batch),
            "--workers", str(args.workers),
            "--snapshot", args.snapshot, "--seed", str(args.seed),
            "--device", args.device]
    if args.snapshot_every_rows is not None:
        base += ["--snapshot-every-rows", str(args.snapshot_every_rows)]
    if args.snapshot_every_s is not None:
        base += ["--snapshot-every-s", str(args.snapshot_every_s)]
    if args.out:
        base += ["--out", args.out]
    for attempt in range(args.max_restarts + 1):
        cmd = list(base)
        if attempt == 0 and args.crash_after is not None:
            cmd += ["--crash-after", str(args.crash_after)]
        if attempt > 0:
            cmd += ["--resume"]
        rc = subprocess.call(cmd)
        if rc == 0:
            print(f"supervise: workload completed after {attempt} restart(s)")
            return 0
        print(f"supervise: child exited rc={rc} (attempt {attempt}); "
              "restarting from latest snapshot")
    print(f"supervise: giving up after {args.max_restarts} restarts")
    return 1


def _block(seed: int, r: int, rows: int, p: int):
    """Request r's rows, derived from (seed, r) alone — a crashed-and-resumed
    run regenerates exactly the blocks it skips and the ones it replays."""
    import numpy as np

    return np.random.default_rng((seed + 1) * 1_000_003 + r) \
             .normal(size=(rows, p)).astype(np.float32)


def main(argv=None):
    args = _build_parser().parse_args(argv)
    if args.supervise:
        return _supervise(args)
    if (args.snapshot_every_rows or args.snapshot_every_s) and not args.snapshot:
        raise SystemExit("--snapshot-every-* needs --snapshot")

    import numpy as np

    from repro_torch import obs
    from repro_torch.api import Plan
    from repro_torch.sketchserve import (SketchService, SnapshotPolicy,
                                         restore_service, serve_http)

    # deterministic mode: crash/resume parity needs per-request seeding and
    # serialized folds (fold boundaries = request boundaries)
    det = bool(args.crash_after is not None or args.resume or args.out)
    policy = (SnapshotPolicy(every_rows=args.snapshot_every_rows,
                             every_s=args.snapshot_every_s)
              if (args.snapshot_every_rows or args.snapshot_every_s) else None)
    svc_kw = dict(max_batch=args.max_batch, workers=args.workers,
                  snapshot_policy=policy,
                  snapshot_dir=args.snapshot if policy else None,
                  device=args.device)

    rng = np.random.default_rng(args.seed)
    plan = Plan(backend="stream", gamma=0.25, batch_size=args.batch_size,
                cov_path="lowrank", rank=args.rank)
    kinds = ("pca", "kmeans", "mean")
    t0 = time.time()
    done = {g: 0 for g in range(args.groups)}   # requests already folded
    if args.resume:
        try:
            svc = restore_service(args.snapshot, **svc_kw)
        except FileNotFoundError:
            print(f"resume: no snapshot under {args.snapshot}; starting fresh")
            svc = SketchService(**svc_kw)
    else:
        svc = SketchService(**svc_kw)
    with svc:
        server = (obs.serve_metrics(svc.registry, port=args.metrics_port)
                  if args.metrics_port is not None else None)
        if server is not None:
            print(f"metrics at {server.url}")
        frontend = (serve_http(svc, port=args.http_port)
                    if args.http_port is not None else None)
        if frontend is not None:
            print(f"http frontend at {frontend.url}")
        have = set(svc.tenants())
        for i in range(args.tenants):
            gid, kind = f"g{i % args.groups}", kinds[min(i // args.groups, 2)]
            if f"t{i}" in have:   # resume: restored with the snapshot
                continue
            extra = ({"n_components": 4} if kind == "pca"
                     else {"k": 4, "algorithm": "minibatch"} if kind == "kmeans"
                     else {})
            svc.create_tenant(f"t{i}", kind, plan=plan, key=args.seed,
                              group=gid, **extra)
        if args.resume:
            for g in range(args.groups):
                rows = svc.query(f"t{g}", "stats").unwrap()["rows"]
                done[g] = rows // args.rows_per_request
            print(f"resume: {sum(done.values())}/{args.requests} requests "
                  "already folded; replaying the remainder")
        t_create = time.time() - t0

        lat: list[float] = []
        futs = []
        acked = 0
        t0 = time.time()
        for r in range(args.requests):
            g = r % args.groups
            if done[g] > 0:         # folded before the crash — skip, don't refold
                done[g] -= 1
                continue
            if det:
                rows = _block(args.seed, r, args.rows_per_request, args.p)
                svc.ingest(f"g{g}", rows).result(60).unwrap()
                acked += 1
                if args.crash_after is not None and acked >= args.crash_after:
                    print(f"crash-after: dying with {acked} acked requests",
                          flush=True)
                    os._exit(7)
            else:
                rows = rng.normal(size=(args.rows_per_request, args.p)
                                  ).astype(np.float32)
                futs.append(svc.ingest(f"g{g}", rows))
                if (r + 1) % args.query_every == 0:
                    tq = time.time()
                    svc.query(f"t{g}", "components").unwrap()
                    lat.append(time.time() - tq)
        rejected = sum(f.result().status == "rejected" for f in futs)
        dt = time.time() - t0
        if args.out:
            comps = {f"g{g}": np.asarray(
                         svc.query(f"t{g}", "components").unwrap()["components"]
                     ).tolist() for g in range(args.groups)}
            with open(args.out, "w") as f:
                json.dump(comps, f)
            print(f"per-group components -> {args.out}")
        stats = svc.stats
        lat_summary = svc.registry.histogram("serve.request_seconds").summary()
        if args.snapshot and policy is None:
            step = svc.snapshot(args.snapshot)
            print(f"snapshot step {step} -> {args.snapshot}")
        if frontend is not None:
            frontend.close()
        if server is not None:
            server.close()

    folds = max(stats["ingest_folds"], 1)
    print(f"tenants={args.tenants} groups={args.groups} "
          f"workers={args.workers} created in {t_create:.2f}s")
    print(f"{stats['ingest_requests']} ingest requests "
          f"({stats['ingest_rows']} rows) in "
          f"{dt:.2f}s = {stats['ingest_requests'] / max(dt, 1e-9):.0f} req/s, "
          f"{stats['ingest_rows'] / max(dt, 1e-9):.0f} rows/s; "
          f"{stats['ingest_requests'] / folds:.1f} requests/fold "
          f"(micro-batching), {rejected} rejected, "
          f"{stats['snapshots']} snapshots")
    if lat:
        p50, p99 = obs.quantiles((v * 1e3 for v in lat), (0.5, 0.99))
        print(f"{len(lat)} queries (lazy finalize): p50={p50:.1f}ms "
              f"p99={p99:.1f}ms")
    if lat_summary.get("count"):
        print(f"submit→resolve latency over {lat_summary['count']} requests: "
              f"p50={lat_summary['p50'] * 1e3:.2f}ms "
              f"p99={lat_summary['p99'] * 1e3:.2f}ms "
              f"max={lat_summary['max'] * 1e3:.2f}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
