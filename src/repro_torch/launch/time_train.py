"""Card time of a training step across micro-batch counts and attention chunks.

    PYTHONPATH=src python -m repro_torch.launch.time_train [--arch gemma3-1b] [--seq 4096]
        [--batch 8] [--steps 3] [--cases ACCUM:Q_CHUNK:KV_CHUNK ...]

For each case, a fresh training state of the config at full width (AdamW,
``CompressConfig(gamma=0.1)`` with error feedback) takes ``--steps`` steps of
``SyntheticLMSource(seed=0)`` through ``make_train_fn`` with ``accum_steps``
micro-batches and ``flash_attention`` chunks of ``q_chunk`` × ``kv_chunk``;
it prints each step's seconds (synchronised host clock), the losses and the
peak memory. A case that runs out of device memory says so and the next one
runs.
"""
from __future__ import annotations

import argparse
import gc
import subprocess
import time

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.grad_compress import CompressConfig
from repro_torch.data.pipeline import SyntheticLMSource
from repro_torch.models.api import get_api
from repro_torch.models.transformer import NO_DIST
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import TrainerConfig, init_state, make_train_fn
from repro_torch.utils import prng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--cases", nargs="+",
                    default=["4:512:1024", "2:512:1024", "2:1024:1024", "2:2048:2048",
                             "1:1024:1024"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_train needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    model = get_api(get_arch(args.arch))
    src = SyntheticLMSource(model.cfg.vocab_size, args.seq, args.batch, seed=0)
    batches = [src.batch_for(s) for s in range(args.steps)]
    print(f"{args.arch}, {args.batch} × {args.seq} tokens a step, {args.steps} steps a case; {card}",
          flush=True)
    for case in args.cases:
        accum, q_chunk, kv_chunk = (int(w) for w in case.split(":"))
        tcfg = TrainerConfig(opt=OptConfig(peak_lr=1e-3, warmup_steps=1, total_steps=args.steps),
                             accum_steps=accum, compress=CompressConfig(gamma=0.1),
                             q_chunk=q_chunk, kv_chunk=kv_chunk)
        label = f"accum {accum}, chunks {q_chunk} × {kv_chunk}"
        try:
            state = init_state(model, tcfg, prng.PRNGKey(0), device="cuda")
            fn = make_train_fn(model, tcfg, NO_DIST, prng.PRNGKey(0), device="cuda")
            torch.cuda.reset_peak_memory_stats()
            secs, losses = [], []
            for batch in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = fn(state, batch)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(float(met["loss"]))
            print(f"{label}: steps {[round(s, 3) for s in secs]} s, losses {losses}, peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        except torch.OutOfMemoryError:
            print(f"{label}: out of device memory", flush=True)
        state = fn = None
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
