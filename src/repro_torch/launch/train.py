"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [--reduced] ...``

End to end on one device: config → state → synthetic token pipeline
→ train loop with checkpoints and restart, and optional sketched gradient
compression (the paper's technique as a distributed-optimization feature).
The flags are the reference's (``python -m repro.launch.train``) plus
``--device``; its log line and its checkpoints too, so either launcher
resumes the other's ``--ckpt-dir``.

    # on the CPU: a smoke-scale gemma3-1b, compressed, checkpointed every 2 steps
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch gemma3-1b \\
        --reduced --steps 4 --grad-compress-gamma 0.1 --ckpt-dir run --ckpt-every 2
    # the ssm, hybrid and audio families the same way
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch mamba2-1.3b \\
        --reduced --steps 4 --grad-compress-gamma 0.1

The dense, vlm, ssm, hybrid and audio families run, on one device. A vlm
batch carries the positions broadcast to the three M-RoPE streams and zero
vision embeddings, an audio batch the frames ``0.1 · normal(fold_in(key,
step), (B, S, d_model))`` in the config's dtype, both as the reference's do
(the frames bit for bit, ``prng.normal``). The moe family, ``--devices``
and the production meshes (``--mesh single|multi``) raise
``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--devices", type=int, default=0, help="force N host devices (not ported)")
    ap.add_argument("--mesh", default="host", choices=["host", "single", "multi"],
                    help="host: the one device; single/multi: pod meshes (not ported)")
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
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.grad_compress import CompressConfig
    from repro_torch.data.pipeline import SyntheticLMSource
    from repro_torch.models.api import get_api
    from repro_torch.models.transformer import NO_DIST
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import TrainerConfig, init_state, make_train_fn
    from repro_torch.utils.device import not_ported
    from repro_torch.utils.prng import PRNGKey, fold_in, normal

    if args.devices or args.mesh != "host":
        raise not_ported("training over several devices (--devices, --mesh single|multi)",
                         "LM side, last")
    cfg = get_arch(args.arch, reduced=args.reduced)
    api = get_api(cfg)
    compress = None
    if args.grad_compress_gamma > 0:
        compress = CompressConfig(gamma=args.grad_compress_gamma)
    tcfg = TrainerConfig(
        opt=OptConfig(peak_lr=args.lr, warmup_steps=max(1, args.steps // 20),
                      total_steps=args.steps),
        accum_steps=args.accum, compress=compress,
        q_chunk=min(512, args.seq), kv_chunk=min(1024, args.seq),
    )
    key = PRNGKey(args.seed)
    step_fn = make_train_fn(api, tcfg, NO_DIST, key, device=args.device)
    state = init_state(api, tcfg, key, device=args.device)

    source = SyntheticLMSource(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    start_step = 0
    if args.ckpt_dir:
        try:
            state, extra = checkpoint.restore(args.ckpt_dir, state)
            start_step = int(extra.get("pipeline", {}).get("step", 0))
            source.state.step = start_step
            print(f"restored checkpoint at step {start_step}")
        except FileNotFoundError:
            pass

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
            frames = normal(fold_in(key, step), (B, S, cfg.d_model), device=args.device,
                            dtype=dtype)
            batch["frames"] = torch.tensor(0.1, dtype=dtype, device=frames.device) * frames
        state, metrics = step_fn(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            print(f"step {step:5d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({(time.time()-t0):.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, step + 1, state,
                            extra={"pipeline": source.state.to_json()})
    if args.ckpt_dir:
        checkpoint.save(args.ckpt_dir, args.steps, state,
                        extra={"pipeline": source.state.to_json()}, async_=False)
    print("done")


if __name__ == "__main__":
    main()
