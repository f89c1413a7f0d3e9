"""Multi-process streaming launcher: ``python -m repro_torch.launch.cluster``.

The multi-process twin of ``repro_torch.launch.stream``: N OS processes bring
up ``torch.distributed`` (``repro_torch.cluster.initialize``), build the
process mesh and fold the same (seed, step, shard) stream through
``make_engine(Plan(backend="sharded"))`` — each process generates and folds
ONLY the shards it owns, and one all-reduce of the step's fixed-size delta is
the only traffic between them. With ``--ckpt-dir`` process 0 checkpoints the
replicated state every ``--ckpt-every`` steps, and ``--resume`` continues from
the latest checkpoint bit for bit.

    # on the CPU: 2 processes over gloo
    PYTHONPATH=src python -m repro_torch.launch.cluster --nproc 2 --device cpu --p 256 --steps 4

    # on one card: 2 processes share it, so their collectives go over gloo
    # (NCCL takes one card a rank); checkpoint every 4 steps, then resume
    PYTHONPATH=src python -m repro_torch.launch.cluster --nproc 2 --device cuda \\
        --dist-backend gloo --p 16384 --gamma 0.05 --batch 2048 --shards 2 --steps 8 \\
        --kmeans-k 10 --ckpt-dir ck --ckpt-every 4
    PYTHONPATH=src python -m repro_torch.launch.cluster ... --ckpt-dir ck --resume

Without ``--process-id`` the command is the coordinator: it builds the CUDA
kernels once (``--device cuda``), picks a free port, spawns ``--nproc`` copies
of itself as workers and exits non-zero if any of them fails (the others are
stopped). On several hosts start one worker a process with ``--process-id``
and ``--coordinator`` set and skip the coordinator.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

_SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=2, help="number of processes")
    ap.add_argument("--process-id", type=int, default=None,
                    help="worker mode: this process's rank (the coordinator spawns these)")
    ap.add_argument("--coordinator", type=str, default=None,
                    help="host:port of rank 0's rendezvous (worker mode)")
    ap.add_argument("--device", default="cuda", help="torch device of every rank")
    ap.add_argument("--dist-backend", default=None, choices=("gloo", "nccl"),
                    help="collectives backend (default: nccl on cuda, gloo on cpu)")
    ap.add_argument("--p", type=int, default=1024)
    ap.add_argument("--gamma", type=float, default=0.1)
    ap.add_argument("--batch", type=int, default=256, help="rows per shard per step")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--shards", type=int, default=0,
                    help="logical shards (default: nproc, one per process)")
    ap.add_argument("--kmeans-k", type=int, default=0, help="0 disables K-means")
    ap.add_argument("--track-reassignments", action="store_true",
                    help="count the rows whose K-means center changes each step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint the EngineState every N steps")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--log-every", type=int, default=0,
                    help="every N steps: process 0 emits a JSONL progress record and "
                         "publishes the merged cluster heartbeat (0 = telemetry off)")
    ap.add_argument("--time-allreduce", type=int, default=0,
                    help="after the run, time N all-reduces of the step's delta")
    ap.add_argument("--out", type=str, default=None,
                    help="process 0 writes the finalized estimates here (.npz)")
    return ap


def _spawn(args) -> int:
    """Coordinator: build the kernels once, then one worker a rank; the
    first rank to fail stops the others."""
    from repro_torch.cluster.bootstrap import free_port

    if args.device.startswith("cuda"):
        from repro_torch.kernels import _build

        _build.build_all()
    cmd = [sys.executable, "-m", "repro_torch.launch.cluster",
           "--coordinator", f"127.0.0.1:{free_port()}"]
    for flag in ("nproc", "device", "p", "batch", "steps", "shards", "kmeans_k", "seed",
                 "ckpt_every", "log_every", "time_allreduce", "gamma"):
        cmd += [f"--{flag.replace('_', '-')}", str(getattr(args, flag))]
    for flag in ("dist_backend", "ckpt_dir", "out"):
        if getattr(args, flag):
            cmd += [f"--{flag.replace('_', '-')}", getattr(args, flag)]
    for flag in ("resume", "track_reassignments"):
        if getattr(args, flag):
            cmd += [f"--{flag.replace('_', '-')}"]
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=_SRC + (os.pathsep + path if path else ""))
    procs = [subprocess.Popen(cmd + ["--process-id", str(pid)], env=env)
             for pid in range(args.nproc)]
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs if p.returncode not in (None, 0)]
            if failed:
                rc = failed[0]
                break
            time.sleep(0.2)
        rc = rc or next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    if rc:
        print(f"a rank failed with exit code {rc}", file=sys.stderr)
    return rc


def _write_out(path: str, res) -> None:
    import hashlib

    import numpy as np

    arrs = {"mean": res.mean.cpu().numpy(), "count": np.int64(int(res.count))}
    if res.cov is not None:
        cov = res.cov.cpu().numpy()
        arrs.update(cov_diag=np.diagonal(cov).copy(), cov_trace=np.trace(cov.astype(np.float64)),
                    cov_sha256=np.array(hashlib.sha256(cov.tobytes()).hexdigest()))
    if res.centers is not None:
        arrs.update(centers=res.centers.cpu().numpy(), kmeans_obj=res.kmeans_obj.cpu().numpy())
    if res.reassign_total is not None:
        arrs.update(reassign_total=res.reassign_total)
    np.savez(path, **arrs)


def _worker(args) -> int:
    import torch

    from repro_torch import api, cluster
    from repro_torch.data.pipeline import VectorStreamSource
    from repro_torch.stream import StreamKMeansConfig

    cluster.initialize(args.coordinator, args.nproc, args.process_id,
                       backend=args.dist_backend, device=args.device)
    import torch.distributed as dist

    rank = cluster.process_index()
    shards = args.shards or args.nproc
    plan = api.Plan(backend="sharded", gamma=args.gamma, batch_size=args.batch,
                    n_shards=shards)
    source = VectorStreamSource(p=args.p, batch=args.batch, seed=args.seed)
    km = (StreamKMeansConfig(k=args.kmeans_k, track_reassignments=args.track_reassignments)
          if args.kmeans_k else None)
    device = (torch.device("cuda", torch.cuda.current_device())
              if args.device.startswith("cuda") else torch.device(args.device))
    if device.type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.nproc))
    engine = api.make_engine(plan, args.p, args.seed + 1, source, kmeans=km, device=device)
    backend = dist.get_backend() if dist.is_initialized() else "none (one process)"
    if rank == 0:
        print(f"dist backend: {backend}, world {cluster.process_count()}, "
              f"device {device}, shards {shards} (rank 0 owns {engine._local})", flush=True)

    state, start = None, 0
    if args.resume:
        if not args.ckpt_dir:
            raise SystemExit("--resume needs --ckpt-dir")
        state, start = engine.restore_state(args.ckpt_dir)

    tel = logger = None
    if args.log_every:
        from repro_torch import obs
        from repro_torch.stream import EngineTelemetry

        reg = obs.MetricsRegistry()
        log_every = args.log_every

        def _on_step(rec, _reg=reg):
            # every process stamps and gathers at the SAME steps (the gather
            # is a collective); process 0 publishes the merged view
            if (rec["step"] + 1) % log_every:
                return
            hb = cluster.beat(rec["step"] + 1, rows=rec["rows_total"])
            cluster.publish_local(hb, registry=_reg)
            view = cluster.gather(hb)
            if rank == 0:
                cluster.publish(view, registry=_reg)

        logger = (obs.StepLogger(stream=sys.stderr,
                                 static={"p": args.p, "shards": shards, "nproc": args.nproc})
                  if rank == 0 else None)
        tel = EngineTelemetry(registry=reg, step_logger=logger, log_every=log_every,
                              on_step=_on_step)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    res = engine.run(args.steps, seed=args.seed, state=state, start_step=start,
                     checkpoint_dir=args.ckpt_dir,
                     checkpoint_every=args.ckpt_every if args.ckpt_dir else 0, telemetry=tel)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    if logger is not None:
        logger.close()
    peak = (f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB on the card"
            if device.type == "cuda" else "n/a on the CPU")
    launched = ""
    if device.type == "cuda":
        import json

        from repro_torch.kernels import ops

        launched = f"; launches {json.dumps(ops.launch_counts(), sort_keys=True)}"
    print(f"rank {rank}: folded steps {start}..{args.steps - 1} in {dt:.2f}s; peak memory "
          f"{peak}{launched}", flush=True)

    if args.time_allreduce:
        from repro_torch.stream.sharded import psum, psum_bytes

        delta, _ = engine._deltas(engine.state, engine._sketch_local(
            engine.host_global_batch(args.seed, 0)[0], 0, engine._local[0]))
        psum(delta, engine.mesh)                                  # warm-up
        ms = []
        for _ in range(args.time_allreduce):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if dist.is_initialized():
                dist.barrier()
            t1 = time.perf_counter()
            psum(delta, engine.mesh)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            ms.append((time.perf_counter() - t1) * 1e3)
        if rank == 0:
            print(f"allreduce: {min(ms):.3f} ms (min of {len(ms)}, median "
                  f"{sorted(ms)[len(ms) // 2]:.3f}) a step's delta of {psum_bytes(delta):,} "
                  f"bytes over {backend}", flush=True)

    if rank == 0:
        folded = (args.steps - start) * shards * args.batch
        print(f"p={args.p} gamma={engine.spec.gamma:.3f} shards={shards} "
              f"processes={cluster.process_count()} "
              f"(this run folded steps {start}..{args.steps - 1})")
        print(f"total rows in state: {int(res.count):,}; folded {folded:,} rows in "
              f"{dt:.2f}s ({folded / dt:,.0f} rows/s incl. set-up)")
        print(f"mean[:4] = {[round(float(v), 4) for v in res.mean[:4]]}")
        if res.centers is not None:
            print(f"kmeans: K={args.kmeans_k}, best accumulated obj = {float(res.kmeans_obj):.2f}")
        if tel is not None:
            hbv = {m.name: m.value for m in tel.registry.metrics()
                   if m.name.startswith("cluster.") and not m.labels}
            if hbv:
                print(f"heartbeat: hosts={hbv.get('cluster.hosts', 0):.0f} "
                      f"step={hbv.get('cluster.step', 0):.0f} "
                      f"straggler_lag={hbv.get('cluster.straggler_lag_s', 0):.3f}s")
        if args.out:
            _write_out(args.out, res)
    if dist.is_initialized():
        dist.barrier()
    cluster.shutdown()
    return 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.process_id is None:
        return _spawn(args)
    if not args.coordinator:
        raise SystemExit("worker mode (--process-id) needs --coordinator")
    return _worker(args)


if __name__ == "__main__":
    raise SystemExit(main())
