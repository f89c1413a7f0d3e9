"""Host time of ``prng.normal`` at the low-rank path's Ω shape (p = 65536, l = 128).

    PYTHONPATH=src python -m repro_torch.launch.time_normal [SRC ...]

``make_engine`` draws Ω on the host, so this is part of the low-rank path's
set-up. Each SRC is a source tree holding ``repro_torch/utils/prng.py`` (the
default is this checkout's ``src``); its module is loaded by path, so two
checkouts compare in one process. The trees take turns, ``--reps`` rounds,
and each prints its seconds a draw and the share of its draws bit-equal to
the first tree's.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import time

import torch


def load_prng(src: str):
    path = os.path.join(src, "repro_torch", "utils", "prng.py")
    spec = importlib.util.spec_from_file_location(f"prng_{len(path)}_{abs(hash(path))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser()
    ap.add_argument("srcs", nargs="*", default=[here])
    ap.add_argument("--shape", type=int, nargs=2, default=(65536, 128))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    mods = [load_prng(s) for s in args.srcs]
    times = {s: [] for s in args.srcs}
    first = None
    same = {}
    for _ in range(args.reps):
        for src, prng in zip(args.srcs, mods):
            key = prng.fold_in_str(prng.PRNGKey(0), "lowrank-omega")
            t0 = time.perf_counter()
            draw = prng.normal(key, tuple(args.shape))
            times[src].append(time.perf_counter() - t0)
            first = draw if first is None else first
            same[src] = (draw.view(torch.int32) == first.view(torch.int32)).double().mean().item()
    print(f"prng.normal {tuple(args.shape)} on the host, {torch.get_num_threads()} torch threads")
    for src in args.srcs:
        ts = sorted(times[src])
        print(f"  {src}: {' '.join(f'{t:.3f}' for t in times[src])} s (median {ts[len(ts) // 2]:.3f} s); "
              f"share bit-equal to the first tree's draw {same[src]:.6f}")


if __name__ == "__main__":
    main()
