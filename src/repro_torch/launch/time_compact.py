"""Card time of the compact covariance's two routes across fills m/p.

    PYTHONPATH=src python -m repro_torch.launch.time_compact [--p P] [--n N] [--gammas G ...]

For each γ, one batch of n sketched rows (m = round(γ·p) random distinct
coordinates a row, normal values) goes through the compact path's sum by key
(``core.estimators._outer_by_keys``), its chunked products
(``_outer_by_products``) and the n·m² float scatter-add they replace
(``_scatter_outer_plain``, which adds by atomics on the card). Each prints
its median over ``--reps`` calls (CUDA events); the scatter-add is timed on at
most 2^28 products' rows and scaled to n. Both routes are checked to repeat
bit for bit and to agree with the scatter-add within 1e-5 of its largest
entry. ``COMPACT_KEYED_FILL`` is read from where the two routes cross.
"""
from __future__ import annotations

import argparse
import subprocess

import torch

from repro_torch.core import estimators


def median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--p", type=int, default=16384)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--gammas", type=float, nargs="+",
                    default=[0.0025, 0.005, 0.01, 0.0125, 0.015, 0.02, 0.03, 0.05])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_compact needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    p, n = args.p, args.n
    print(f"compact covariance, {n} rows of p={p}; {card}; the current rule takes the sum by key "
          f"where m/p <= {estimators.COMPACT_KEYED_FILL}")
    gen = torch.Generator(device=dev).manual_seed(0)
    for gamma in args.gammas:
        m = max(2, round(gamma * p))
        idx = torch.sort(torch.rand((n, p), generator=gen, device=dev).argsort(1)[:, :m], 1)[0]
        idx = idx.to(torch.int32).contiguous()
        vals = torch.randn((n, m), generator=gen, device=dev)
        keyed = estimators._outer_by_keys(vals, idx, p)
        prods = estimators._outer_by_products(vals, idx, p)
        rows = max(1, min(n, (1 << 28) // (m * m)))
        plain = estimators._scatter_outer_plain(vals[:rows], idx[:rows], p)
        if rows < n:
            plain_part = estimators._outer_by_products(vals[:rows], idx[:rows], p)
            top = plain_part.abs().max().item()
            keyed_part = estimators._outer_by_keys(vals[:rows], idx[:rows], p)
            err = {"keys": (keyed_part - plain).abs().max().item() / top,
                   "products": (plain_part - plain).abs().max().item() / top}
            del keyed_part
            del plain_part
        else:
            top = plain.abs().max().item()
            err = {"keys": (keyed - plain).abs().max().item() / top,
                   "products": (prods - plain).abs().max().item() / top}
        repeat = {"keys": torch.equal(keyed, estimators._outer_by_keys(vals, idx, p)),
                  "products": torch.equal(prods, estimators._outer_by_products(vals, idx, p))}
        del keyed, prods, plain
        torch.cuda.empty_cache()
        t_keys = median_ms(lambda: estimators._outer_by_keys(vals, idx, p), args.reps)
        t_prod = median_ms(lambda: estimators._outer_by_products(vals, idx, p), args.reps)
        t_plain = median_ms(lambda: estimators._scatter_outer_plain(vals[:rows], idx[:rows], p),
                            args.reps) * n / rows
        print(f"  gamma={gamma} m={m} (m/p={m / p:.4f}): by key {t_keys:.3f} ms, by products "
              f"{t_prod:.3f} ms, scatter-add {t_plain:.3f} ms"
              f"{'' if rows == n else f' (timed on {rows} rows, scaled)'}; faster route: "
              f"{'keys' if t_keys < t_prod else 'products'}; repeat bit for bit {repeat}; "
              f"|err|/max against the scatter-add {err}")
        del vals, idx
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
