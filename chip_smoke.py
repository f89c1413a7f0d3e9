#!/usr/bin/env python3
"""Build and drive the PyTorch port (src/repro_torch) on one NVIDIA card, and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device   — require a card; print its name and power limit (nvidia-smi).
2. build    — compile every CUDA source for sm_90a; print registers, shared
              memory and spills from ptxas.
3. kernels  — each kernel against its plain PyTorch version on the card, at the
              shapes the streaming path gives it (and at its edges), with its
              time over repeated launches beside its bound.
4. parity   — a small stream run on the card with the kernels against the same
              run on the CPU with the plain versions (same seed, same masks).
5. main     — the full-size stream: Plan(backend="stream", gamma=0.05,
              batch_size=4096), p = 16384, 16 steps, streaming K-means
              (K = 10, r = 3), then pca_from_stream(k=8); every kernel must have
              launched, the outputs must be finite, and the top-8 subspace and
              eigenvalues must match the source's planted ones.
6. costs    — the step's largest costs that are not kernels.

Then one JSON line listing every kernel, the card's line again, and the result
line ``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, 700 W): device memory and fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

P, BATCH, STEPS, GAMMA, K, N_INIT, PCA_K = 16384, 4096, 16, 0.05, 10, 3, 8


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call on the card, from CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least milliseconds, what bounds it) on the published peaks."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    import torch

    # ---------------------------------------------------------------- 1 device
    print("== 1 device", flush=True)
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: this needs an NVIDIA card")
    check(os.path.isdir(os.path.join(SRC, "repro_torch")),
          "src/repro_torch is not beside chip_smoke.py: run it from a checkout of the repo")
    sys.path.insert(0, SRC)
    card = card_line()
    print(card)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")

    from repro_torch import api
    from repro_torch.core import pca as pca_mod
    from repro_torch.core import estimators
    from repro_torch.core.sampling import sample_indices
    from repro_torch.data.pipeline import VectorStreamSource
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.stream import StreamKMeansConfig
    from repro_torch.utils import prng

    # ----------------------------------------------------------------- 2 build
    print("== 2 build", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s with nvcc {' '.join(_build.NVCC_FLAGS)}")
    for name in sorted(libs):
        report = _build.ptxas_report(name)
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", report)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores", report))
        print(f"  {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers a thread, "
              f"{spills} bytes of spill stores in all")
    print(f"  hadamard: dynamic shared memory a block {4 * (P + P // 32 + 1)} bytes at p={P}, "
          f"{4 * (2 * P + P // 16 + 1)} at p={2 * P}; sparse_assign: none")

    # --------------------------------------------------------------- 3 kernels
    print("== 3 kernels against their plain versions", flush=True)
    rng = np.random.default_rng(0)
    key = prng.PRNGKey(0)
    m = round(GAMMA * P)
    entries = {}

    def sketch_case(n, p, mm, seed):
        x = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32)).to(dev)
        s = prng.rademacher(prng.fold_in(key, seed), (p,), device=dev)
        idx = sample_indices(prng.fold_in(key, seed + 1), n, p, mm, device=dev)
        return x, s, idx

    def report(name, err, tol, ms, plain_ms, b, lib_ms=None):
        check(err <= tol, f"{name}: error {err:.3g} above tolerance {tol:g}")
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"  {name}: err {err:.3g} (tol {tol:g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"one library call {lib}, bound {b[0]:.4f} ms ({b[1]})")

    # K1 sketch_fused at the stream's shape, at its p = 2^15 ceiling, and at a ragged n
    for n, p, mm in [(BATCH, P, m), (1024, 1 << 15, round(GAMMA * (1 << 15))), (777, P, m)]:
        x, s, idx = sketch_case(n, p, mm, seed=n)
        got = ops.sketch_fused(x, s, idx)
        torch.cuda.synchronize()
        err = (got - ref.ref_sketch_fused(x, s, idx)).abs().max().item()
        ms = time_ms(lambda: ops.sketch_fused(x, s, idx), 20)
        plain_ms = time_ms(lambda: ref.ref_sketch_fused(x, s, idx), 5)
        b = bound(4 * (n * p + p + 2 * n * mm), n * p * (math.log2(p) + 1) + n * mm)
        report(f"K1 sketch_fused ({n}, {p}, m={mm})", err, 1e-5, ms, plain_ms, b)
        if (n, p) == (BATCH, P):
            entries["sketch_fused"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                           bound_ms=b[0], bound_by=b[1], library_ms=None)
    del x, s, idx, got

    # K2 hd_precondition: a batch of rows, and the unmix shape of finalize, both sign modes
    eye = torch.eye(P, device=dev)
    hmat = ref.ref_hd_precondition(eye, torch.ones(P, device=dev))   # H, symmetric
    del eye
    for n in (BATCH, K):
        x, s, _ = sketch_case(n, P, 1, seed=7 + n)
        for after in (False, True):
            got = ops.hd_precondition(x, s, signs_after=after)
            torch.cuda.synchronize()
            err = (got - ref.ref_hd_precondition(x, s, after)).abs().max().item()
            ms = time_ms(lambda: ops.hd_precondition(x, s, signs_after=after), 20)
            plain_ms = time_ms(lambda: ref.ref_hd_precondition(x, s, after), 5)
            dense = hmat * s[None, :] if after else s[:, None] * hmat     # H·D or D·H
            lib_ms = time_ms(lambda: torch.matmul(x, dense), 5)
            del dense
            b = bound(4 * (2 * n * P + P), n * P * (math.log2(P) + 2))
            report(f"K2 hd_precondition ({n}, {P}) signs_after={after}", err, 1e-5, ms,
                   plain_ms, b, lib_ms)
            if n == K and after:
                entries["hd_precondition"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                                  bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)
    del x, s, got, hmat

    # K4 sparse_assign: the stream's batch against r sets of K centers, then planted ties
    x, _, idx = sketch_case(BATCH, P, m, seed=11)
    vals = torch.from_numpy(rng.normal(size=(BATCH, m)).astype(np.float32)).to(dev)
    centers = torch.from_numpy(rng.normal(size=(N_INIT, K, P)).astype(np.float32)).to(dev)
    centers[:, 7] = centers[:, 3]
    vals[:256] = centers[0, 3][idx[:256].long()]     # distance 0 to centers 3 and 7
    d, a = ops.sparse_assign(vals, idx, centers)
    torch.cuda.synchronize()
    d_ref, a_ref = ref.ref_sparse_assign(vals, idx, centers)
    rel = ((d - d_ref).abs() / d_ref.abs().clamp(min=1e-30)).max().item()
    err = (d - d_ref).abs().max().item()
    top2 = torch.topk(d_ref, 2, dim=-1, largest=False).values
    clear = (top2[..., 1] - top2[..., 0]) > 1e-5 * top2[..., 0].abs()
    check(torch.equal(a[clear], a_ref[clear]), "K4: argmin differs from the plain version")
    check(bool(torch.all(a[0, :256] == 3)), "K4: a tie did not go to the first index")
    ms = time_ms(lambda: ops.sparse_assign(vals, idx, centers), 20)
    plain_ms = time_ms(lambda: ref.ref_sparse_assign(vals, idx, centers), 3)
    b = bound(4 * (2 * BATCH * m + N_INIT * K * P + N_INIT * BATCH * (K + 1)),
              3 * BATCH * m * K * N_INIT)
    report(f"K4 sparse_assign (n={BATCH}, m={m}, r={N_INIT}, K={K}, p={P}), ties planted, "
           f"relative distance", rel, 1e-5, ms, plain_ms, b)
    entries["sparse_assign"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=b[0], bound_by=b[1], library_ms=None)
    del x, idx, vals, centers, d, a, d_ref, a_ref
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 4 parity
    print("== 4 small run on the card against the same run on the CPU", flush=True)

    def small(device):
        plan = api.Plan(backend="stream", gamma=0.1, batch_size=64, n_shards=2)
        eng = api.make_engine(plan, 1000, prng.PRNGKey(3), VectorStreamSource(p=1000, batch=64, seed=0),
                              kmeans=StreamKMeansConfig(k=4, n_init=2), device=device)
        return eng.run(3)

    ops.reset_counts()
    on_card, on_cpu = small("cuda"), small("cpu")
    check(all(v > 0 for v in ops.launch_counts().values()),
          f"small run on the card did not launch every kernel: {ops.launch_counts()}")
    check(int(on_card.count) == int(on_cpu.count) == 384, "row counts differ")
    for name, tol in [("mean", 1e-5), ("cov", 1e-5), ("centers_pre", 1e-4), ("centers", 1e-4),
                      ("kmeans_obj", 1e-4)]:
        a, b_ = getattr(on_card, name).cpu().numpy(), getattr(on_cpu, name).numpy()
        ok = np.allclose(a, b_, rtol=tol, atol=tol)
        print(f"  {name}: max |card - cpu| {np.abs(a - b_).max():.3g} (rtol = atol = {tol:g})")
        check(ok, f"{name} differs between the card and the CPU beyond {tol:g}")

    # ------------------------------------------------------------------ 5 main
    print(f"== 5 main path: p={P}, {BATCH} rows a step, {STEPS} steps, K={K}, r={N_INIT}", flush=True)
    src = VectorStreamSource(p=P, batch=BATCH, seed=0)
    plan = api.Plan(backend="stream", gamma=GAMMA, batch_size=BATCH)
    eng = api.make_engine(plan, P, prng.PRNGKey(1), src, kmeans=StreamKMeansConfig(k=K, n_init=N_INIT))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    res = eng.run(STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    pca = pca_mod.pca_from_stream(eng.state.moments, eng.spec, PCA_K)
    torch.cuda.synchronize()
    t_pca = time.perf_counter() - t0 - t_run
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rows = int(res.count)
    print(f"  streamed {rows} rows in {t_run:.2f} s ({rows / t_run:.0f} rows/s, K-means++ "
          f"seeding included); pca_from_stream {t_pca:.2f} s; peak memory {peak / 2**30:.2f} GiB")
    print(f"  launches on the main path: {launches}")
    check(rows == STEPS * BATCH, f"count {rows} != {STEPS * BATCH}")
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    for name in ("mean", "cov", "centers", "centers_pre", "kmeans_obj"):
        check(bool(torch.isfinite(getattr(res, name)).all()), f"{name} is not finite")
    check(tuple(res.centers.shape) == (K, P), f"centers shape {tuple(res.centers.shape)}")
    check(bool(torch.isfinite(pca.components).all() and torch.isfinite(pca.eigenvalues).all()),
          "PCA output is not finite")
    comps = pca.components.double().cpu().numpy()
    q, _ = np.linalg.qr(comps.T)
    cosines = np.linalg.svd(q.T @ src._u.astype(np.float64), compute_uv=False)
    sine = float(np.sqrt(max(0.0, 1.0 - cosines.min() ** 2)))
    evals = pca.eigenvalues.cpu().numpy()
    planted = src._lam.astype(np.float64) ** 2
    print(f"  top-{PCA_K} subspace vs planted: sine of largest principal angle {sine:.4f} (< 0.35)")
    print(f"  eigenvalues {np.round(evals, 2).tolist()} vs planted {np.round(planted, 2).tolist()}")
    check(sine < 0.35, f"top-{PCA_K} subspace is off the planted one: sine {sine:.3f}")
    check(bool(np.all(np.abs(evals - planted) <= 0.1 * planted)),
          "an eigenvalue is more than 10% off its planted value")

    # the step's split between the host source and the device, on synchronised clocks
    state, t_src, t_dev = eng.state, 0.0, 0.0
    for step in range(STEPS, STEPS + 3):
        t0 = time.perf_counter()
        x = eng.host_global_batch(None, step)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = eng.update(state, x, step)
        torch.cuda.synchronize()
        t_src, t_dev = t_src + t1 - t0, t_dev + time.perf_counter() - t1
    print(f"  a step: host source + copy {t_src / 3 * 1e3:.1f} ms, device update {t_dev / 3 * 1e3:.1f} ms; "
          f"device share {t_dev / (t_src + t_dev):.3f}")
    del state, x

    # ----------------------------------------------------------------- 6 costs
    print("== 6 the step's costs outside the kernels", flush=True)
    c = estimators.stream_finalize_cov(eng.state.moments, eng.spec.m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.linalg.eigh(c)
    torch.cuda.synchronize()
    print(f"  eigh at p={P}: {time.perf_counter() - t0:.2f} s")
    del c
    w = torch.zeros((BATCH, P), device=dev)
    w.scatter_(1, sample_indices(key, BATCH, P, m, device=dev).long(),
               torch.randn((BATCH, m), device=dev))
    gemm = time_ms(lambda: w.T @ w, 3, warmup=1)
    print(f"  covariance product w.T @ w ({BATCH}x{P}, fp32): {gemm:.2f} ms "
          f"({2 * BATCH * P * P / gemm / 1e9:.1f} TFLOP/s)")
    del w
    print(f"  threefry uniforms ({BATCH}, {P}): "
          f"{time_ms(lambda: prng.uniform(key, (BATCH, P), device=dev), 3, 1):.2f} ms")
    print(f"  sample_indices (threefry + stable sort + sort): "
          f"{time_ms(lambda: sample_indices(key, BATCH, P, m, device=dev), 3, 1):.2f} ms")
    t0 = time.perf_counter()
    for step in range(3):
        src.batch_at(step)
    print(f"  host source batch_at ({BATCH}, {P}): {(time.perf_counter() - t0) / 3 * 1e3:.1f} ms")

    # ---------------------------------------------------------------- summary
    sources = {"sketch_fused": ("src/repro_torch/kernels/csrc/hadamard.cu",
                                "src/repro/kernels/sketch_fused.py:80"),
               "hd_precondition": ("src/repro_torch/kernels/csrc/hadamard.cu",
                                   "src/repro/kernels/fwht.py:205"),
               "sparse_assign": ("src/repro_torch/kernels/csrc/sparse_assign.cu",
                                 "src/repro/kernels/sparse_assign.py:75")}
    kernels = [dict(name=name, route="cuda", source=sources[name][0], replaces=sources[name][1],
                    launches=launches[name], **entries[name]) for name in sources]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
