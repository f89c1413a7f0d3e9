"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [--reduced] ...``

End to end: config → mesh → state → synthetic token pipeline → train loop
with checkpoints and restart, and optional sketched gradient compression
(the paper's technique as a distributed-optimization feature). The flags are
the reference's (``python -m repro.launch.train``) plus ``--device``,
``--dist-backend``, ``--layers``, ``--final-ckpt`` and ``--time-exchange``;
its log line and its checkpoints too, so either launcher resumes the other's
``--ckpt-dir``.

    # on the CPU: a smoke-scale gemma3-1b, compressed, checkpointed every 2 steps
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch gemma3-1b \\
        --reduced --steps 4 --grad-compress-gamma 0.1 --ckpt-dir run --ckpt-every 2
    # data parallel: 2 ranks on the CPU (gloo), then 2 ranks sharing one card
    PYTHONPATH=src python -m repro_torch.launch.train --devices 2 --device cpu --arch gemma3-1b \\
        --reduced --steps 4 --grad-compress-gamma 0.1
    PYTHONPATH=src python -m repro_torch.launch.train --devices 2 --dist-backend gloo \\
        --arch gemma3-1b --layers 6 --seq 4096 --batch 4 --accum 2 --steps 4 \\
        --grad-compress-gamma 0.1

``--devices N`` starts N ranks (this command is their coordinator: it builds
the CUDA kernels once, spawns N copies of itself, and fails if a rank
fails, the others stopped). The collectives go over ``--dist-backend``:
NCCL (the default on the card) takes one card a rank and refuses more ranks
than cards, naming gloo; gloo serves ranks that share a card or run on the
CPU. ``--mesh host`` puts the N ranks on the reference's host mesh
``(max(1, N // 2), min(2, N))``, ``single`` and ``multi`` on the pod meshes
(16 × 16, 2 × 16 × 16: one rank a position). Every mesh axis carries data
(``dp_only``): each rank takes its block of the ``--batch`` rows, and the
state is placed over the ranks as the reference's launcher places it (FSDP,
``trainer.init_placed_state``: only the parameters are drawn whole, so a
model whose whole state exceeds a card trains): each rank holds its block of
the parameters and moments and its range of chunks of the one residual, and
compresses its own chunks. Rank 0 prints the log line and writes the
checkpoints (the reference's tree, each leaf gathered to it). Each rank
prints a ``rank-summary`` JSON line at the end: its losses, step times, peak memory,
kernel launches, the bytes its collectives sent by kind and a SHA-256 of the
final parameters (gathered whole, a leaf at a time); with
``--time-exchange K`` also the times of a rank's two all-to-alls of the
gradient's chunks and of its masks. ``--no-final-ckpt`` writes only the
``--ckpt-every`` checkpoints.

Every family runs (the moe family with its aux loss in the loss and
``nll``/``aux`` among the metrics; its experts are placed like every
parameter and gathered a layer at a time, so ``--devices`` splits the
batch, not the experts: the routers' load-balance statistics are averaged
over the ranks, each bucket's capacity is a rank's block's). A vlm batch
carries the positions broadcast to the three M-RoPE streams and zero vision
embeddings, an audio batch the frames ``0.1 · normal(fold_in(key, step), (B,
S, d_model))`` in the config's dtype, both as the reference's do (the frames
bit for bit, ``prng.normal``).

    # on the CPU, a smoke-scale kimi-k2-1t-a32b (a leading dense layer, MoE with a shared expert)
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch kimi-k2-1t-a32b \\
        --reduced --steps 4 --grad-compress-gamma 0.1
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--devices", type=int, default=0, help="data-parallel ranks (0: one process)")
    ap.add_argument("--mesh", default="host", choices=["host", "single", "multi"],
                    help="host: the ranks' host mesh; single/multi: the pod meshes")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--grad-compress-gamma", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--dist-backend", default=None, choices=("gloo", "nccl"),
                    help="collectives backend of --devices (default: nccl on cuda, gloo on cpu)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config's depth to this many layers (0: its own)")
    ap.add_argument("--final-ckpt", action=argparse.BooleanOptionalAction, default=True,
                    help="with --ckpt-dir, checkpoint the last step's state too")
    ap.add_argument("--time-exchange", type=int, default=0,
                    help="after the run, time K exchanges of a step's kept values and K masks")
    ap.add_argument("--process-id", type=int, default=None,
                    help="rank mode: this process's rank (the coordinator spawns these)")
    ap.add_argument("--coordinator", default=None, help="host:port of rank 0's rendezvous")
    return ap


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.devices and args.process_id is None:
        return _spawn(args, argv)
    return _train(args)


def _spawn(args, argv) -> int:
    """Coordinator: build the kernels once, then one process a rank."""
    from repro_torch.cluster.bootstrap import free_port, run_ranks

    if args.device.startswith("cuda"):
        from repro_torch.kernels import _build

        _build.build_all()
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *argv,
           "--coordinator", f"127.0.0.1:{free_port()}"]
    rc = run_ranks(cmd, args.devices)
    if rc:
        raise SystemExit(rc)
    return 0


def _train(args):
    t_main = time.perf_counter()
    import dataclasses

    import torch

    from repro_torch import cluster, obs
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.grad_compress import CompressConfig
    from repro_torch.data.pipeline import SyntheticLMSource
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models.api import get_api
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import (TrainerConfig, init_placed_state, init_state,
                                           make_dist, make_train_fn)
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.prng import PRNGKey, fold_in, normal

    if args.process_id is not None:
        if not args.coordinator:
            raise SystemExit("rank mode (--process-id) needs --coordinator")
        # named, so that one rank still gets its (one-process) group
        backend = args.dist_backend or ("nccl" if args.device.startswith("cuda") else "gloo")
        cluster.initialize(args.coordinator, args.devices, args.process_id, backend=backend,
                           device=args.device)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    elif args.devices:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.devices))
    rank, world = cluster.process_index(), cluster.process_count()

    cfg = get_arch(args.arch, reduced=args.reduced)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    api = get_api(cfg)
    if args.mesh == "host":
        mesh = make_host_mesh(max(1, world // 2), min(2, world)) if world > 1 else None
    else:
        mesh = make_production_mesh(multi_pod=(args.mesh == "multi"))

    compress = None
    if args.grad_compress_gamma > 0:
        compress = CompressConfig(gamma=args.grad_compress_gamma)
    tcfg = TrainerConfig(
        opt=OptConfig(peak_lr=args.lr, warmup_steps=max(1, args.steps // 20),
                      total_steps=args.steps),
        accum_steps=args.accum, compress=compress,
        q_chunk=min(512, args.seq), kv_chunk=min(1024, args.seq),
        sp=mesh is not None, dp_only=True,
    )
    key = PRNGKey(args.seed)
    dist = make_dist(mesh, cfg, sp=tcfg.sp, dp_only=tcfg.dp_only)
    step_fn = make_train_fn(api, tcfg, dist, key, device=device)
    if mesh is None:
        state = init_state(api, tcfg, key, device=device)
    else:
        state = init_placed_state(api, tcfg, key, dist, device=device)

    source = SyntheticLMSource(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    start_step = 0
    if args.ckpt_dir:
        try:
            state, extra = checkpoint.restore(args.ckpt_dir, state)
            start_step = int(extra.get("pipeline", {}).get("step", 0))
            source.state.step = start_step
            if rank == 0:
                print(f"restored checkpoint at step {start_step}")
        except FileNotFoundError:
            pass

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, step_s, saved = [], [], None
    t_ready = time.perf_counter() - t_main
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = source.next_batch()
        if cfg.family == "vlm":
            B, S = batch["tokens"].shape
            pos = torch.arange(S)[None].expand(B, S)
            batch["positions"] = pos[None].expand(3, B, S)
            batch["vision_embeds"] = torch.zeros((B, cfg.n_vision_tokens, cfg.d_model),
                                                 dtype=getattr(torch, cfg.dtype))
        if cfg.family == "audio":
            B, S = batch["tokens"].shape
            dtype = getattr(torch, cfg.dtype)
            frames = normal(fold_in(key, step), (B, S, cfg.d_model), device=device, dtype=dtype)
            batch["frames"] = torch.tensor(0.1, dtype=dtype, device=frames.device) * frames
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t1)
        if rank == 0 and (step % args.log_every == 0 or step == args.steps - 1):
            print(f"step {step:5d} loss {losses[-1]:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({(time.time()-t0):.1f}s)", flush=True)
        last = step + 1 == args.steps
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0 and (args.final_ckpt or not last):
            checkpoint.save(args.ckpt_dir, step + 1, state,
                            extra={"pipeline": source.state.to_json()})
            saved = step + 1
    if args.ckpt_dir and args.final_ckpt and saved != args.steps:
        checkpoint.save(args.ckpt_dir, args.steps, state,
                        extra={"pipeline": source.state.to_json()}, async_=False)
    checkpoint.wait_for_pending()
    if args.process_id is not None:
        summary = dict(rank=rank, world=world, backend=torch.distributed.get_backend(),
                       device=str(device), steps=[start_step, args.steps], losses=losses,
                       step_s=step_s, tokens_a_step=args.batch * args.seq,
                       exchange_bytes=_exchanged(obs), params_sha256=_digest(state),
                       ready_s=t_ready)
        if device.type == "cuda":
            from repro_torch.kernels import ops

            torch.cuda.synchronize(device)
            summary.update(peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
                           launches=ops.launch_counts(),
                           dispatch={f"{op}/{path}": n for (op, path), n in ops.DISPATCH.items()})
        if args.time_exchange and compress is not None and mesh is not None:
            summary.update(_time_exchange(state, compress, device, args.time_exchange))
        summary["wall_s"] = time.perf_counter() - t_main
        # one write of the whole line: the ranks share the coordinator's stdout
        print(f"rank-summary {json.dumps(summary)}\n", end="", flush=True)
        torch.distributed.barrier()
        cluster.shutdown()
    if rank == 0:
        print("done")


def _digest(state) -> str:
    """SHA-256 of the parameters' bytes, whole, in their leaf order (a
    placed state's gathered a leaf at a time)."""
    import hashlib

    import numpy as np

    from repro_torch.train import fsdp
    from repro_torch.utils.host import to_host
    from repro_torch.utils.tree import tree_leaves_with_path

    h = hashlib.sha256()
    for name, leaf in tree_leaves_with_path(state["params"]):
        if isinstance(state, fsdp.PlacedState):
            leaf = fsdp.gather_leaf(leaf, state.layout.places["['params']" + name])
        h.update(np.ascontiguousarray(to_host(leaf)).reshape(-1).view(np.uint8).data)
    return h.hexdigest()


def _exchanged(obs) -> dict:
    """The exchange's bytes by mode, from the default registry."""
    return {m.labels["mode"]: m.value for m in obs.default_registry().metrics()
            if m.name == "grad_compress.exchange_bytes"}


def _time_exchange(state, compress, device, reps: int) -> dict:
    """Each rank of a placed state: ``reps`` moves of a step's gradient
    into the chunk ranges and of ĝ back (``fsdp.to_chunks`` /
    ``from_chunks``, one all-to-all each) and ``reps`` masks of the rank's
    chunks, timed by the host clock around a synchronised call (the least
    and the median, ms), beside the dense gradient's bytes."""
    import numpy as np
    import torch

    from repro_torch.core import grad_compress as gc
    from repro_torch.core import sketch as sketch_mod
    from repro_torch.core.sampling import sample_indices
    from repro_torch.train import fsdp
    from repro_torch.utils.prng import PRNGKey
    from repro_torch.utils.tree import tree_leaves

    layout = state.layout
    grads = [torch.zeros(leaf.shape, dtype=torch.float32, device=device)
             for leaf in tree_leaves(state["params"])]
    nc, m = layout.n_chunks, compress.m
    c0, c1 = layout.chunk_ranges[layout.rank]
    spec = gc.mask_spec(compress, PRNGKey(0))

    def timed(fn):
        out = []
        for i in range(reps):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            torch.distributed.barrier()
            t = time.perf_counter()
            fn(i)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            out.append((time.perf_counter() - t) * 1e3)
        return [min(out), float(np.median(out))]

    rng = fsdp.to_chunks(grads, layout)
    to_ms = timed(lambda i: fsdp.to_chunks(grads, layout))
    from_ms = timed(lambda i: fsdp.from_chunks(rng, layout))
    mask = timed(lambda i: sample_indices(sketch_mod.batch_key(spec, i, 0), c1 - c0,
                                          compress.chunk_p, m, device=device, row0=c0,
                                          total_rows=nc))
    return dict(params=layout.n, chunks=nc, rows=[c0, c1], m=m, dense_bytes=4 * layout.n,
                to_chunks_ms=to_ms, from_chunks_ms=from_ms, mask_ms=mask)


if __name__ == "__main__":
    raise SystemExit(main())
