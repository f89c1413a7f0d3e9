"""Streaming-estimation launcher: ``python -m repro_torch.launch.stream [flags]``.

Thin shim over ``repro_torch.api``: flags build a :class:`repro_torch.api.Plan`
(backend "stream") and ``api.make_engine`` constructs the streaming engine —
synthetic (seed, step, shard) vector source → per-batch-mask sketch →
constant-memory accumulators → finalized mean / covariance / streaming K-means.

    # on the card: mean+cov at p=4096, 5% sketch
    PYTHONPATH=src python -m repro_torch.launch.stream --p 4096 --gamma 0.05 --steps 20

    # on the CPU, with streaming K-means over 2 shards a step
    PYTHONPATH=src python -m repro_torch.launch.stream --device cpu --shards 2 --kmeans-k 8

    # a JSONL progress record every 5 steps, and /metrics while the run lasts
    PYTHONPATH=src python -m repro_torch.launch.stream --log-every 5 \
        --log-file run.jsonl --metrics-port 9100
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--p", type=int, default=4096)
    ap.add_argument("--gamma", type=float, default=0.05)
    ap.add_argument("--batch", type=int, default=512, help="rows per shard per step")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--shards", type=int, default=1, help="shards per step, folded in turn")
    ap.add_argument("--no-cov", action="store_true", help="mean-only accumulator")
    ap.add_argument("--cov-path", choices=("dense", "compact"), default="dense",
                    help="covariance delta path (compact = the γ ≪ 1 memory fix)")
    ap.add_argument("--kmeans-k", type=int, default=0, help="0 disables streaming K-means")
    ap.add_argument("--kmeans-ninit", type=int, default=3)
    ap.add_argument("--log-every", type=int, default=0,
                    help="emit a structured JSONL progress record every N steps "
                         "(0 = telemetry off)")
    ap.add_argument("--log-file", default=None,
                    help="JSONL destination for --log-every (default: stderr)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the live registry at /metrics on this port")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import api
    from repro_torch.data.pipeline import VectorStreamSource
    from repro_torch.stream import StreamKMeansConfig

    plan = api.Plan(backend="stream", gamma=args.gamma, batch_size=args.batch,
                    n_shards=args.shards, cov_path=args.cov_path)
    source = VectorStreamSource(p=args.p, batch=args.batch, seed=args.seed)
    km = (StreamKMeansConfig(k=args.kmeans_k, n_init=args.kmeans_ninit)
          if args.kmeans_k else None)
    engine = api.make_engine(plan, args.p, args.seed + 1, source,
                             track_cov=not args.no_cov, kmeans=km, device=args.device)
    spec = engine.spec
    dev = engine.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    tel, server, logger = None, None, None
    if args.log_every or args.metrics_port is not None:
        import sys

        from repro_torch import obs
        from repro_torch.stream import EngineTelemetry

        reg = obs.MetricsRegistry()
        logger = obs.StepLogger(
            path=args.log_file, stream=None if args.log_file else sys.stderr,
            static={"p": args.p, "shards": args.shards, "backend": plan.backend,
                    "device": str(dev)})
        tel = EngineTelemetry(registry=reg, step_logger=logger,
                              log_every=max(args.log_every, 1))
        if args.metrics_port is not None:
            server = obs.serve_metrics(reg, port=args.metrics_port)
            print(f"metrics at {server.url}")

    t0 = time.time()
    try:
        res = engine.run(args.steps, seed=args.seed, telemetry=tel)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        if server is not None:
            server.close()
        if logger is not None:
            logger.close()
    dt = time.time() - t0
    rows = int(res.count)
    acc_floats = spec.p_pad + (0 if args.no_cov else spec.p_pad**2)
    if km:
        acc_floats += 2 * args.kmeans_ninit * args.kmeans_k * spec.p_pad
    print(f"device: {dev} ({name})")
    print(f"p={args.p} gamma={spec.gamma:.3f} (m={spec.m}) shards={args.shards} "
          f"backend={plan.backend}")
    print(f"streamed {rows:,} rows in {dt:.2f}s ({rows/dt:,.0f} rows/s incl. set-up); "
          f"accumulator state: {acc_floats:,} floats (constant in stream length)")
    print(f"mean[:4] = {[round(float(v), 4) for v in res.mean[:4]]}")
    if res.cov is not None:
        print(f"cov trace = {float(res.cov.trace()):.4f}")
    if res.centers is not None:
        print(f"kmeans: K={args.kmeans_k}, best accumulated obj = {float(res.kmeans_obj):.2f}")


if __name__ == "__main__":
    main()
