"""Serving launcher: batched prefill + greedy decode loop (the port of
``python -m repro.launch.serve``).

    # on the CPU, a smoke-scale glm4-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch glm4-9b --reduced
    # on the card (the default device), gemma3-1b at full width
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --prompt-len 512 --gen 32

The flags are the reference's plus ``--device``, and so are the two output
lines. The prompt is ``jax.random.randint(PRNGKey(seed), (batch,
prompt_len), 0, vocab)`` bit for bit (``prng.randint``); the weights come
from a ``torch.Generator`` seeded with ``--seed`` (not the reference's
draws). Per family, as the reference's branches:

- dense, moe, vlm: the prompt is prefilled into a float32 cache padded by
  ``--gen``, then decoded greedily, the generated token ``t`` at ``cur_len =
  prompt_len + t + 1``;
- ssm, hybrid: the prompt is decoded token by token into
  ``init_decode_state(batch, prompt_len + gen)``, then greedily as above;
- audio: the frames ``0.1 · normal(PRNGKey(seed), (batch, prompt_len,
  d_model))`` (float32, bit for bit) are encoded into a float32 cache
  (``init_decode_cache``) and ``--gen`` tokens decoded from token 0, the
  step ``t`` at ``cur_len = t + 1``. The frames take the parameters' dtype
  first: torch's matmul does not promote a bfloat16 weight to float32, as
  JAX's does, so a bfloat16 model encodes bfloat16 frames.

``--devices N`` is the reference's: it serves on one device all the same
(the reference only forces N host devices); on the card it refuses more than
the host's cards.

    # on the CPU, the other families
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch qwen3-moe-235b-a22b \\
        --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch mamba2-1.3b --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch seamless-m4t-large-v2 \\
        --reduced
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="devices the host must have (serving runs on one)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import encdec
    from repro_torch.models.api import get_api
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.prng import PRNGKey, normal, randint

    cfg = get_arch(args.arch, reduced=args.reduced)
    api = get_api(cfg)
    device = resolve_device(args.device)
    if device.type == "cuda" and args.devices > torch.cuda.device_count():
        raise ValueError(f"--devices {args.devices}, but this host has "
                         f"{torch.cuda.device_count()} cards")
    params = api.init_params(args.seed, device)
    B = args.batch
    prompt = randint(PRNGKey(args.seed), (B, args.prompt_len), 0, cfg.vocab_size, device=device)

    t0 = time.time()
    max_len = args.prompt_len + args.gen
    if cfg.family == "audio":
        frames = 0.1 * normal(PRNGKey(args.seed), (B, args.prompt_len, cfg.d_model), device=device)
        # float32 frames: the encoder runs in float32 whatever the weights' dtype
        cache = encdec.init_decode_cache(params, frames, cfg, max_len, dtype=torch.float32)
        cur = torch.zeros((B, 1), dtype=torch.int32, device=device)
        toks = []
        for t in range(args.gen):
            logits, cache = api.decode_fn(params, cur, cache, t + 1, device=device)
            cur = torch.argmax(logits, -1).to(torch.int32)[:, None]
            toks.append(cur)
    else:
        if cfg.family in ("dense", "moe", "vlm"):
            logits, cache = api.prefill_fn(params, {"tokens": prompt}, cache_dtype=torch.float32,
                                           device=device)
            cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, args.gen))
                     for k, v in cache.items()}
        else:
            cache = api.init_decode_state(B, max_len, device=device)
            for t in range(args.prompt_len):
                logits, cache = api.decode_fn(params, prompt[:, t:t + 1], cache, t + 1,
                                              device=device)
        cur = torch.argmax(logits, -1).to(torch.int32)[:, None]
        toks = [cur]
        for t in range(args.gen - 1):
            logits, cache = api.decode_fn(params, cur, cache, args.prompt_len + t + 1,
                                          device=device)
            cur = torch.argmax(logits, -1).to(torch.int32)[:, None]
            toks.append(cur)
    out = torch.cat(toks, 1)
    dt = time.time() - t0
    print(f"arch={cfg.name} generated {tuple(out.shape)} in {dt:.2f}s "
          f"({B*args.gen/dt:.1f} tok/s incl. compile)")
    print("sample tokens:", out[0].tolist())


if __name__ == "__main__":
    main()
