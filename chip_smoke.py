#!/usr/bin/env python3
"""Build and drive the PyTorch port (src/repro_torch) on one NVIDIA card, and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device   — require a card; print its name and power limit (nvidia-smi).
2. build    — compile every CUDA source for sm_90a; print registers, shared
              memory and spills from ptxas.
3. kernels  — each kernel against its plain PyTorch version on the card, at the
              shapes the two streaming paths give it (and at its edges), with
              its time over repeated launches beside its bound: K4 at every
              (r, K) the paths launch and one with r·K > 32, at both paths' m;
              K3 bit-equal at every cluster size (p = 2^16 … 2^19) and on its
              multi-pass schedule (2^20, 2^21), timed by cluster size; the
              sketch at p = 2^16 and 2^18 through K3's cluster gather mode,
              bit-equal, timed beside the composition it replaces (K3 +
              torch.gather); K5's windowed kernel within 1e-5, bit-identical
              across launches, bit-equal to its row kernel with one split,
              its splits probed, timed against the row kernel also at
              m/p = 0.01 (where the plan takes that), and rows that do not
              increase sent to the row kernel;
              K6's transposition bit-equal to column_buckets' stable sort and
              timed alone, K6 bit-equal to its walk fed by column_buckets, and
              no slower than torch.sparse.mm(Wᵀ, T) (whose CSR build is timed
              beside it); K6 and its transposition at p = 2^25 by both kinds
              of passes, bit-equal to column_buckets.
4. parity   — small runs on the card with the kernels against the same runs on
              the CPU with the plain versions (same seed, same masks): the
              dense path at p = 1000 and the low-rank path at p = 40000.
5. main     — the full-size stream: Plan(backend="stream", gamma=0.05,
              batch_size=4096), p = 16384, 16 steps, streaming K-means
              (K = 10, r = 3), then pca_from_stream(k=8); every kernel of the
              path (K1, K2, K4) must have launched, the outputs must be finite,
              and the top-8 subspace and eigenvalues must match the source's
              planted ones.
6. costs    — the step's largest costs that are not kernels.
7. lowrank  — the second path at full width: Plan(cov_path="lowrank",
              rank=128), p = 65536, 8 steps of 4096 rows, streaming K-means
              (K = 10, r = 3), then cov_lowrank.top(8) unmixed; every kernel of
              the path (the sketch in K3's cluster gather mode, K3 in the
              unmixes, K4, K5, K6) must have launched, the outputs must be
              finite, the state O(l·p); read after 2, 4 and 8 steps of the one
              stream, the subspace of the planted directions that the
              range-finder resolves at each n must match the planted one, and
              after 8 steps their eigenvalues too.

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
# the low-rank path: p, sketch width l, steps, and the steps after which its gates are read
P_LR, ELL, STEPS_LR = 65536, 128, 8
# columns of K6's check past the grid's y limit
P_BIG = 1 << 25
READ_LR = (2, 4, STEPS_LR)
PATH1 = ("sketch_fused", "hd_precondition", "sparse_assign")
PATH2 = ("sketch_fused_cluster", "hd_precondition_chunked", "sparse_assign", "spmm", "spmm_t",
         "transpose_columns")


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    from repro_torch import lowrank
    from repro_torch.core.sampling import SparseRows, sample_indices
    from repro_torch.data.pipeline import VectorStreamSource
    from repro_torch.core import sketch as sketch_mod
    from repro_torch.kernels import _build, fwht, ops, ref
    from repro_torch.kernels import sparse_assign as sa_mod
    from repro_torch.kernels import spmm as spmm_mod
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
    c_max = fwht.max_cluster(dev)
    print(f"  hadamard: dynamic shared memory a block {4 * (P + P // 32 + 1)} bytes at p={P}, "
          f"{4 * (2 * P + P // 16 + 1)} at p={2 * P} and a block of K3's clusters; the largest "
          f"cluster the card places (C_max) {c_max}, so one pass up to p = {c_max << 15}; "
          f"sparse_assign: a 4224-byte tile for the centers' layout; spmm: two windows of Ω "
          f"and the rows' rings of pairs, {spmm_mod.spmm_plan(BATCH, P_LR, ELL, 1).smem} bytes a "
          f"block at l={ELL}, on {spmm_mod.sm_count(dev)} SMs; its "
          f"transposition: 64 KB of staged pairs a placement block, 128 KB of cursors a block "
          f"of its general passes")

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

    # K4 sparse_assign at every launch shape of both paths (each path's p and
    # m): a step's r = 3 sets of K = 10; K-means++'s candidates (r = 1,
    # K = 2 + ⌈ln 10⌉ = 5) and first center (r = 1, K = 1); and r·K = 48 > 32
    # slots. Ties planted where K > 1: two equal centers, rows on them
    m_lr = round(GAMMA * P_LR)
    for p, mm in [(P, m), (P_LR, m_lr)]:
        idx = sample_indices(prng.fold_in(key, 12 + p), BATCH, p, mm, device=dev)
        vals0 = torch.from_numpy(rng.normal(size=(BATCH, mm)).astype(np.float32)).to(dev)
        for r, kk in [(N_INIT, K), (1, 5), (1, 1), (3, 16)]:
            vals = vals0.clone()
            centers = torch.from_numpy(rng.normal(size=(r, kk, p)).astype(np.float32)).to(dev)
            tie = (3, 7) if kk >= 8 else (1, kk - 1)
            if kk > 1:
                centers[:, tie[1]] = centers[:, tie[0]]
                vals[:256] = centers[0, tie[0]][idx[:256].long()]     # distance 0 to both
            d, a = ops.sparse_assign(vals, idx, centers)
            torch.cuda.synchronize()
            d_ref, a_ref = ref.ref_sparse_assign(vals, idx, centers)
            rel = ((d - d_ref).abs() / d_ref.abs().clamp(min=1e-30)).max().item()
            err = (d - d_ref).abs().max().item()
            if kk > 1:
                top2 = torch.topk(d_ref, 2, dim=-1, largest=False).values
                clear = (top2[..., 1] - top2[..., 0]) > 1e-5 * top2[..., 0].abs()
                check(bool(torch.all(a[0, :256] == tie[0])),
                      f"K4 at p={p}, r={r}, K={kk}: a tie did not go to the first index")
            else:
                clear = torch.ones_like(a, dtype=torch.bool)
            check(torch.equal(a[clear], a_ref[clear]),
                  f"K4 at p={p}, r={r}, K={kk}: argmin differs from the plain version")
            again = ops.sparse_assign(vals, idx, centers)
            check(torch.equal(again[0], d) and torch.equal(again[1], a),
                  f"K4 at p={p}, r={r}, K={kk}: repeated launches differ")
            ms = time_ms(lambda: ops.sparse_assign(vals, idx, centers), 20)
            plain_ms = time_ms(lambda: ref.ref_sparse_assign(vals, idx, centers), 3)
            b = bound(4 * (2 * BATCH * mm + r * kk * p + r * BATCH * (kk + 1)),
                      3 * BATCH * mm * kk * r)
            report(f"K4 sparse_assign (n={BATCH}, m={mm}, r={r}, K={kk}, p={p}), ties planted, "
                   f"relative distance", rel, 1e-5, ms, plain_ms, b)
            if (p, r, kk) == (P, N_INIT, K):
                entries["sparse_assign"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                                bound_ms=b[0], bound_by=b[1], library_ms=None)
            del vals, centers, d, a, d_ref, a_ref, again
        del idx, vals0
        torch.cuda.empty_cache()

    # K3 hd_precondition above 2^15: a batch of the low-rank path in both sign
    # modes, the unmix shapes of its finalize, a 1 GiB batch at every other
    # cluster size (p = 2^17 … 2^19), and the multi-pass schedule at 2^20, 2^21.
    # Bit-equal to the plain butterfly. One PyTorch call for the same function
    # at p = 2^16 is x @ (D·H) or x @ (H·D): H (16 GiB) is built once, from the
    # plain transform of the identity's rows
    hmat = torch.empty((P_LR, P_LR), device=dev)
    ones = torch.ones(P_LR, device=dev)
    for r0 in range(0, P_LR, BATCH):
        rows = torch.zeros((BATCH, P_LR), device=dev)
        rows[:, r0:r0 + BATCH] = torch.eye(BATCH, device=dev)
        hmat[r0:r0 + BATCH] = ref.ref_hd_precondition(rows, ones)
    del rows, ones
    by_cluster = []
    for n, p, modes in [(BATCH, P_LR, (False, True)), (PCA_K, P_LR, (True,)), (K, P_LR, (True,)),
                        (2048, 1 << 17, (False, True)), (1024, 1 << 18, (False, True)),
                        (512, 1 << 19, (False, True)), (256, 1 << 20, (False, True)),
                        (64, 1 << 21, (False,))]:
        gen = torch.Generator(device=dev).manual_seed(n + p)
        x = torch.randn((n, p), device=dev, generator=gen)
        s = prng.rademacher(prng.fold_in(key, n + p), (p,), device=dev)
        plan = fwht.chunk_plan(p, c_max)
        for after in modes:
            ops.reset_counts()
            got = ops.hd_precondition(x, s, signs_after=after)
            torch.cuda.synchronize()
            check(ops.launch_counts()["hd_precondition_chunked"] == 1, f"K3 at p={p} did not launch")
            want = ref.ref_hd_precondition(x, s, after)
            check(torch.equal(got, want), f"K3 at ({n}, {p}) signs_after={after} is not bit-equal "
                                          f"to the plain butterfly")
            err = (got - want).abs().max().item()
            del want
            ms = time_ms(lambda: ops.hd_precondition(x, s, signs_after=after), 20)
            plain_ms = time_ms(lambda: ref.ref_hd_precondition(x, s, after), 3)
            b = bound(4 * (2 * n * p + p), n * p * (math.log2(p) + 2))
            lib_ms = None
            if p == P_LR:     # H·D or D·H in place, exactly (signs ±1), and back after
                signs = s[None, :] if after else s[:, None]
                hmat.mul_(signs)
                lib_ms = time_ms(lambda: torch.matmul(x, hmat), 3 if n == BATCH else 10, warmup=1)
                lib_err = (torch.matmul(x, hmat) - got).abs().max().item()
                hmat.mul_(signs)
                print(f"  x @ (H·D) at ({n}, {p}): max |library - kernel| {lib_err:.3g}")
                check(lib_err <= 1e-2 * got.abs().max().item(), "K3: the library call is not its function")
            report(f"K3 hd_precondition ({n}, {p}) signs_after={after}, cluster {plan[0]} of "
                   f"2^{plan[1]}-value blocks, {plan[2]} register passes, bit-equal", err, 0.0, ms,
                   plain_ms, b, lib_ms)
            if not after and n * p == BATCH * P_LR:
                by_cluster.append(f"C={plan[0]}{f' + {plan[2]} register passes' if plan[2] else ''} "
                                  f"(p={p}) {ms:.4f} ms, {b[0] / ms:.2f} of its bound")
            if (n, p, after) == (PCA_K, P_LR, True):     # the unmix that phase 7 launches
                entries["hd_precondition_chunked"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                    library_ms=lib_ms)
        del x, s, got
    del hmat
    print(f"  K3 by cluster size, 1 GiB batches: {'; '.join(by_cluster)}")
    torch.cuda.empty_cache()

    # K1's function above 2^15 in one pass: K3's cluster kernel in its gather
    # mode, at the low-rank path's shape, at p = 2^18 (C = 8) with a ragged n,
    # and with m = 1; bit-equal to the plain composition, timed beside the
    # composition it replaces (K3, then torch.gather on the (n, p) result)
    for n, p, mm in [(BATCH, P_LR, m_lr), (777, 1 << 18, round(GAMMA * (1 << 18))), (333, P_LR, 1)]:
        x, s, idx = sketch_case(n, p, mm, seed=n + p)
        ops.reset_counts()
        got = ops.sketch_fused(x, s, idx)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check(counts["sketch_fused_cluster"] == 1 and counts["hd_precondition_chunked"] == 0
              and ops.DISPATCH[("sketch_fused", "kernel_cluster")] == 1,
              f"the sketch at p={p} did not take K3's cluster gather: {counts}")
        want = ref.ref_sketch_fused(x, s, idx)
        check(torch.equal(got, want), f"the cluster sketch ({n}, {p}, m={mm}) is not bit-equal")
        err = (got - want).abs().max().item()
        del want
        again = ops.sketch_fused(x, s, idx)
        check(torch.equal(again, got), "the cluster sketch differs between launches")
        ms = time_ms(lambda: ops.sketch_fused(x, s, idx), 20)
        plain_ms = time_ms(lambda: ref.ref_sketch_fused(x, s, idx), 3)
        old_ms = time_ms(lambda: torch.gather(fwht.hd_precondition_chunked(x, s), 1, idx.long()), 20)
        b = bound(4 * (n * p + p + 2 * n * mm), n * p * (math.log2(p) + 1) + n * mm)
        report(f"K1 sketch above 2^15, K3's cluster gather ({n}, {p}, m={mm}), bit-equal", err, 0.0,
               ms, plain_ms, b)
        if (n, p) == (BATCH, P_LR):     # device memory a call adds to what its inputs hold
            peaks = []
            for fn in (lambda: ops.sketch_fused(x, s, idx),
                       lambda: torch.gather(fwht.hd_precondition_chunked(x, s), 1, idx.long()),
                       lambda: sample_indices(key, n, p, mm, device=dev)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                fn()
                torch.cuda.synchronize()
                peaks.append((torch.cuda.max_memory_allocated() - base) / 2**30)
            print(f"    peak device memory a call adds: the cluster sketch {peaks[0]:.3f} GiB, "
                  f"K3 + torch.gather {peaks[1]:.3f} GiB, sample_indices at this shape "
                  f"{peaks[2]:.3f} GiB")
        print(f"    the composition it replaces, K3 + torch.gather: {old_ms:.4f} ms")
        if (n, p) == (BATCH, P_LR):
            entries["sketch_fused_cluster"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                                   bound_ms=b[0], bound_by=b[1], library_ms=None)
        del x, s, idx, got, again
    torch.cuda.empty_cache()

    def transposed_as_buckets(vals, idx, p):
        """K6's transposition is column_buckets' stable sort, bit for bit."""
        pairs, starts = spmm_mod.transpose_columns(vals, idx, p)
        order, want_starts = spmm_mod.column_buckets(idx, p)
        return (torch.equal(starts, want_starts) and torch.equal(pairs[:, 0], order // idx.shape[1])
                and torch.equal(pairs[:, 1].view(torch.float32), vals.reshape(-1)[order.long()]))

    def by_pass(fn, reps):
        """Device ms a call of each kernel ``fn`` launches, by torch.profiler."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        passes = {}
        for e in prof.key_averages():
            name = re.search(r"::(\w+)[(<]", e.key)
            if e.device_type == DeviceType.CUDA and name:
                passes[name.group(1)] = e.self_device_time_total / reps / 1e3
        return ", ".join(f"{k} {v:.4f}" for k, v in sorted(passes.items(), key=lambda kv: -kv[1]))

    # K5 spmm and K6 spmm_t at the low-rank path's shapes, at a ragged n, and at
    # an l that is not a multiple of 32 (float4 lanes) or of 4 (one float a lane)
    def csr(vals, idx, n_rows, n_cols, transpose=False):
        rows = torch.arange(vals.shape[0], device=dev).repeat_interleave(vals.shape[1])
        cols = idx.reshape(-1).long()
        ij = torch.stack([cols, rows]) if transpose else torch.stack([rows, cols])
        return torch.sparse_coo_tensor(ij, vals.reshape(-1), (n_rows, n_cols)).coalesce().to_sparse_csr()

    for n, ell in [(BATCH, ELL), (777, ELL), (BATCH, 100), (1000, 13)]:
        idx = sample_indices(prng.fold_in(key, n + ell), n, P_LR, m_lr, device=dev)
        vals = torch.from_numpy(rng.normal(size=(n, m_lr)).astype(np.float32)).to(dev)
        om = prng.normal(prng.fold_in(key, ell), (P_LR, ell), device=dev)
        t = ops.spmm(vals, idx, om)
        y = ops.spmm_t(vals, idx, t, P_LR)
        ys = ops.spmm_t(vals, idx, t, P_LR, col_sums=True)       # as the range-finder calls it
        torch.cuda.synchronize()
        t_ref, y_ref = ref.ref_spmm(vals, idx, om), ref.ref_spmm_t(vals, idx, t, P_LR)
        err_t = (t - t_ref).abs().max().item()
        err_y = (y - y_ref).abs().max().item()
        check(torch.equal(ys[0], y), "K6: Y with the column sums differs from Y alone")
        for what, got, want in zip(("Σv", "Σv²"), ys[1:],
                                   ref.ref_spmm_t(vals, idx, t, P_LR, col_sums=True)[1:]):
            err_s, tol_s = (got - want).abs().max().item(), 1e-5 * want.abs().max().item()
            print(f"  K6 column sums {what} (n={n}): err {err_s:.3g} (tol {tol_s:.3g}, 1e-5 of max |plain|)")
            check(err_s <= tol_s, f"K6: column sums {what} off the plain version")
        flops = 2 * n * m_lr * ell
        main = (n, ell) == (BATCH, ELL)
        reps = 10 if main else 3
        ms_t = time_ms(lambda: ops.spmm(vals, idx, om), reps)
        ms_y = time_ms(lambda: ops.spmm_t(vals, idx, t, P_LR), reps)
        plain_t = time_ms(lambda: ref.ref_spmm(vals, idx, om), 2, warmup=1)
        plain_y = time_ms(lambda: ref.ref_spmm_t(vals, idx, t, P_LR), 2, warmup=1)
        lib_t = lib_y = None
        if main:
            w, wt = csr(vals, idx, n, P_LR), csr(vals, idx, P_LR, n, transpose=True)
            lib_t = time_ms(lambda: torch.sparse.mm(w, om), reps)
            lib_y = time_ms(lambda: torch.sparse.mm(wt, t), reps)
            del w, wt
            csr_ms = time_ms(lambda: csr(vals, idx, P_LR, n, transpose=True), reps)
            # the transposition against its plain version, the stable sort of column_buckets
            check(transposed_as_buckets(vals, idx, P_LR),
                  "K6: the transposition is not the stable sort of column_buckets")
            trans = time_ms(lambda: spmm_mod.transpose_columns(vals, idx, P_LR), reps)
            print(f"  K6 transposition by pass (torch.profiler, ms a call): "
                  f"{by_pass(lambda: spmm_mod.transpose_columns(vals, idx, P_LR), reps)}")
            prep = time_ms(lambda: spmm_mod.column_buckets(idx, P_LR), reps)
            ms_ys = time_ms(lambda: ops.spmm_t(vals, idx, t, P_LR, col_sums=True), reps)
            old = spmm_mod.spmm_t_from_buckets(vals, idx, t, P_LR, col_sums=True)
            check(all(torch.equal(a, b_) for a, b_ in zip(ys, old)),
                  "K6: Y and the column sums differ from the walk fed by column_buckets")
            old_ms = time_ms(lambda: spmm_mod.spmm_t_from_buckets(vals, idx, t, P_LR, col_sums=True),
                             reps)
            b_ys = bound(4 * (2 * n * m_lr + n * ell + P_LR * ell + 2 * P_LR),
                         flops + 3 * n * m_lr)
            again = [ops.spmm_t(vals, idx, t, P_LR, col_sums=True) for _ in range(2)]
            check(all(torch.equal(a, b_) for a2 in again for a, b_ in zip(a2, ys)),
                  "K6: repeated launches are not bit-identical")
            rows = SparseRows(vals, idx, P_LR)
            d1, d2 = lowrank.range_delta(rows, om), lowrank.range_delta(rows, om)
            check(all(torch.equal(getattr(d1, f), getattr(d2, f)) for f in ("y", "diag", "sum_w")),
                  "range_delta is not bit-reproducible on the card")
            print(f"  K6 transposition alone {trans:.4f} ms of the {ms_y:.4f} ms (the stable sort + "
                  f"searchsorted of column_buckets: {prep:.4f} ms), bit-equal to column_buckets; "
                  f"with the column sums, as the range-finder calls it, {ms_ys:.4f} ms (bound "
                  f"{b_ys[0]:.4f} ms, {b_ys[1]}); the walk fed by column_buckets {old_ms:.4f} ms, "
                  f"bit-equal in Y and the sums; repeated launches, and the whole range_delta, "
                  f"bit-identical")
            print(f"  K6's library yardstick torch.sparse.mm(Wᵀ, T) {lib_y:.4f} ms leaves out building "
                  f"Wᵀ's CSR from the compact rows: {csr_ms:.4f} ms")
            print(f"  K6 with the column sums against torch.sparse.mm(Wᵀ, T): {ms_ys:.4f} against "
                  f"{lib_y:.4f} ms ({'not ' if ms_ys > lib_y else ''}within it)")
            del rows, d1, d2, again, old
            # K5: the windowed kernel, which the path's m/p takes, against
            # its row kernel (bit-equal with one split), across launches, by
            # pass and over splits; at m/p = 0.01, where the plan takes the
            # row kernel, both timed; rows that do not increase strictly go
            # to the row kernel
            sms = spmm_mod.sm_count(dev)
            check(spmm_mod.windows_pay(m_lr, P_LR), "K5: the path's m/p does not take the windows")
            plan = spmm_mod.spmm_plan(n, P_LR, ell, sms)
            by_rows = spmm_mod._launch(vals, idx, om, None)[0]
            one = spmm_mod._launch(vals, idx, om, spmm_mod.spmm_plan(n, P_LR, ell, sms, 1))[0]
            check(torch.equal(one, by_rows), "K5 with one split is not bit-equal to its row kernel")
            check(all(torch.equal(ops.spmm(vals, idx, om), t) for _ in range(2)),
                  "K5: repeated launches are not bit-identical")
            rows_ms = time_ms(lambda: spmm_mod._launch(vals, idx, om, None), reps)
            probes = []
            for splits in sorted({1, 2, 4, 8, 16, plan.splits}):
                pl = spmm_mod.spmm_plan(n, P_LR, ell, sms, splits)
                probes.append(f"S={pl.splits} "
                              f"{time_ms(lambda: spmm_mod._launch(vals, idx, om, pl), reps):.4f}")
            m_low = P_LR // 100
            check(not spmm_mod.windows_pay(m_low, P_LR), "K5: m/p = 0.01 takes the windows")
            idx_low = sample_indices(prng.fold_in(key, 99), n, P_LR, m_low, device=dev)
            vals_low = vals[:, :m_low].contiguous()
            plan_low = spmm_mod.spmm_plan(n, P_LR, ell, sms)
            check(torch.equal(ops.spmm(vals_low, idx_low, om),
                              spmm_mod._launch(vals_low, idx_low, om, None)[0]),
                  "K5 at m/p = 0.01 did not take the row kernel")
            low_rows = time_ms(lambda: spmm_mod._launch(vals_low, idx_low, om, None), reps)
            low_win = time_ms(lambda: spmm_mod._launch(vals_low, idx_low, om, plan_low), reps)
            idx_rep = idx.clone()
            idx_rep[::97, 1] = idx_rep[::97, 0]              # a repeat in every 97th row
            t_rep = ops.spmm(vals, idx_rep, om)
            rows_rep = spmm_mod._launch(vals, idx_rep, om, None)[0]
            torch.cuda.synchronize()
            err_rep = (t_rep - ref.ref_spmm(vals, idx_rep, om)).abs().max().item()
            check(err_rep <= 1e-5 * t_ref.abs().max().item() and torch.equal(t_rep[::97], rows_rep[::97]),
                  "K5: rows with a repeated index did not take the row kernel")
            rep_ms = time_ms(lambda: ops.spmm(vals, idx_rep, om), reps)
            print(f"  K5 windowed on its plan (R={spmm_mod.WIN_ROWS}, W={spmm_mod.WINDOW}, "
                  f"S={plan.splits}, {plan.blocks} blocks, {plan.smem} bytes of shared memory a "
                  f"block): {ms_t:.4f} ms against its row kernel {rows_ms:.4f} ms and "
                  f"torch.sparse.mm {lib_t:.4f} ms; with one split bit-equal to the row kernel, "
                  f"repeated launches bit-identical; Ω's L2 reads {(n * m_lr * ell * 4) / 1e9:.2f} "
                  f"GB by rows, {-(-n // spmm_mod.WIN_ROWS) * P_LR * ell * 4 / 1e9:.2f} GB by "
                  f"windows")
            print(f"  K5 by pass (torch.profiler, ms a call): "
                  f"{by_pass(lambda: ops.spmm(vals, idx, om), reps)}")
            print(f"  K5 over splits (ms): {'; '.join(probes)}")
            print(f"  K5 at m/p = 0.01 (m={m_low}), where the plan takes the row kernel: row kernel "
                  f"{low_rows:.4f} ms, windows (S={plan_low.splits}) {low_win:.4f} ms")
            print(f"  K5 with a repeated index in every 97th row: those rows bit-equal to the row "
                  f"kernel, err {err_rep:.3g}; {rep_ms:.4f} ms")
            del idx_low, vals_low
            del by_rows, one, idx_rep, t_rep, rows_rep
        b_t = bound(4 * (2 * n * m_lr + P_LR * ell + n * ell), flops)
        b_y = bound(4 * (2 * n * m_lr + n * ell + P_LR * ell), flops)
        tol_t, tol_y = 1e-5 * t_ref.abs().max().item(), 1e-5 * y_ref.abs().max().item()
        report(f"K5 spmm (n={n}, m={m_lr}, p={P_LR}, l={ell}), tol 1e-5 of max |plain|",
               err_t, tol_t, ms_t, plain_t, b_t, lib_t)
        report(f"K6 spmm_t (n={n}, m={m_lr}, p={P_LR}, l={ell}), tol 1e-5 of max |plain|",
               err_y, tol_y, ms_y, plain_y, b_y, lib_y)
        if main:
            entries["spmm"] = dict(max_abs_err=err_t, ms=ms_t, plain_ms=plain_t, bound_ms=b_t[0],
                                   bound_by=b_t[1], library_ms=lib_t)
            entries["spmm_t"] = dict(max_abs_err=err_y, ms=ms_y, plain_ms=plain_y,
                                     bound_ms=b_y[0], bound_by=b_y[1], library_ms=lib_y)
        del idx, vals, om, t, y, ys, t_ref, y_ref
        torch.cuda.empty_cache()

    # K6 past 2^24 columns (the low-rank path takes p_pad up to 2^27): 64 rows at
    # p = 2^25, kept at m/p = 0.05 (the fast passes) and at m = 3000 (general
    # passes), against column_buckets and the walk fed by it
    gen = torch.Generator(device=dev).manual_seed(0)
    for m_big in (round(GAMMA * P_BIG), 3000):
        fast = spmm_mod.transpose_plan(64, m_big, P_BIG)[0]
        idx = torch.stack([torch.randperm(P_BIG, generator=gen, device=dev)[:m_big].sort().values
                           for _ in range(64)]).int()
        vals = torch.randn(idx.shape, generator=gen, device=dev)
        t = torch.randn((64, 8), generator=gen, device=dev)
        check(transposed_as_buckets(vals, idx, P_BIG),
              f"K6: the transposition at p={P_BIG}, m={m_big} is not the stable sort of column_buckets")
        got = ops.spmm_t(vals, idx, t, P_BIG, col_sums=True)
        old = spmm_mod.spmm_t_from_buckets(vals, idx, t, P_BIG, col_sums=True)
        check(all(torch.equal(a, b_) for a, b_ in zip(got, old)),
              f"K6 at p={P_BIG}, m={m_big}: Y and the sums differ from the walk fed by column_buckets")
        ms = time_ms(lambda: spmm_mod.transpose_columns(vals, idx, P_BIG), 3, warmup=1)
        prep = time_ms(lambda: spmm_mod.column_buckets(idx, P_BIG), 3, warmup=1)
        print(f"  K6 at (n=64, m={m_big}, p={P_BIG}, l=8), the {'fast' if fast else 'general'} "
              f"passes: transposition {ms:.4f} ms (column_buckets' sort + searchsorted "
              f"{prep:.4f} ms), bit-equal to column_buckets; Y and the sums "
              f"bit-equal to the walk fed by column_buckets. By pass (ms a call): "
              f"{by_pass(lambda: spmm_mod.transpose_columns(vals, idx, P_BIG), 3)}")
        del idx, vals, t, got, old
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
    check(all(ops.launch_counts()[name] > 0 for name in PATH1),
          f"small run on the card did not launch every kernel of its path: {ops.launch_counts()}")
    check(int(on_card.count) == int(on_cpu.count) == 384, "row counts differ")
    for name, tol in [("mean", 1e-5), ("cov", 1e-5), ("centers_pre", 1e-4), ("centers", 1e-4),
                      ("kmeans_obj", 1e-4)]:
        a, b_ = getattr(on_card, name).cpu().numpy(), getattr(on_cpu, name).numpy()
        ok = np.allclose(a, b_, rtol=tol, atol=tol)
        print(f"  {name}: max |card - cpu| {np.abs(a - b_).max():.3g} (rtol = atol = {tol:g})")
        check(ok, f"{name} differs between the card and the CPU beyond {tol:g}")

    # the low-rank path: p = 40000 pads to 65536 (K3), l = 16, K-means K = 4, r = 2
    def small_lowrank(device):
        plan = api.Plan(backend="stream", gamma=GAMMA, batch_size=64, cov_path="lowrank", rank=16)
        eng = api.make_engine(plan, 40000, prng.PRNGKey(3),
                              VectorStreamSource(p=40000, batch=64, seed=0),
                              kmeans=StreamKMeansConfig(k=4, n_init=2), device=device)
        return eng, eng.run(3)

    ops.reset_counts()
    (eng_card, lr_card), (eng_cpu, lr_cpu) = small_lowrank("cuda"), small_lowrank("cpu")
    check(all(ops.launch_counts()[name] > 0 for name in PATH2),
          f"small low-rank run on the card did not launch every kernel of its path: "
          f"{ops.launch_counts()}")
    check(torch.equal(eng_card._omega.cpu(), eng_cpu._omega), "the card and the CPU drew another Ω")
    check(int(lr_card.count) == int(lr_cpu.count) == 192, "low-rank row counts differ")
    st_card, st_cpu = eng_card.state.lowrank, eng_cpu.state.lowrank
    # sums in another order (K5/K6 against the CPU's sequential sums):
    # relative to the largest entry; centers as on the dense path
    for name, a, b_, tol in [("mean", lr_card.mean, lr_cpu.mean, 1e-5),
                             ("RangeState.y", st_card.y, st_cpu.y, 1e-5),
                             ("RangeState.diag", st_card.diag, st_cpu.diag, 1e-5),
                             ("centers", lr_card.centers, lr_cpu.centers, 1e-4)]:
        diff = (a.cpu() - b_).abs().max().item()
        scale = b_.abs().max().item()
        print(f"  low-rank {name}: max |card - cpu| {diff:.3g} (tol {tol:g} of max |cpu| {scale:.3g})")
        check(diff <= tol * scale, f"low-rank {name} differs between the card and the CPU")
    ev_card = lr_card.cov_lowrank.eigenvalues.cpu().double().numpy()
    ev_cpu = lr_cpu.cov_lowrank.eigenvalues.double().numpy()
    rel = np.abs(ev_card - ev_cpu) / np.abs(ev_cpu)
    cos = np.abs(np.sum(lr_card.cov_lowrank.components_pre.cpu().double().numpy()
                        * lr_cpu.cov_lowrank.components_pre.double().numpy(), axis=1))
    print(f"  low-rank eigenvalues {np.round(ev_cpu, 3).tolist()}: relative |card - cpu| "
          f"{rel.max():.3g}; |cos| of components card vs cpu {np.round(cos, 6).tolist()}")
    # the top 4 of the 8: at 192 rows the lower ones sit at the noise floor,
    # where the basis boundary is not well separated
    check(rel[:4].max() <= 1e-4, "low-rank eigenvalues differ between the card and the CPU")
    check(cos[:4].min() >= 1 - 1e-4, "low-rank components differ between the card and the CPU")
    del eng_card, eng_cpu, lr_card, lr_cpu, st_card, st_cpu

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
    print(f"  launches on the main path: {launches}; K4's by (r, K, m): {dict(sa_mod.sparse_assign.by_shape)}")
    check(rows == STEPS * BATCH, f"count {rows} != {STEPS * BATCH}")
    check(all(launches[name] > 0 for name in PATH1), f"a kernel of the path never launched: {launches}")
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
    del eng, res, pca, src
    torch.cuda.empty_cache()

    # -------------------------------------------------------------- 7 lowrank
    print(f"== 7 the low-rank path: p={P_LR}, l={ELL}, {BATCH} rows a step, {STEPS_LR} steps, "
          f"K={K}, r={N_INIT}", flush=True)
    src = VectorStreamSource(p=P_LR, batch=BATCH, seed=0)
    plan = api.Plan(backend="stream", gamma=GAMMA, batch_size=BATCH, cov_path="lowrank", rank=ELL)
    t0 = time.perf_counter()
    eng = api.make_engine(plan, P_LR, prng.PRNGKey(1), src,
                          kmeans=StreamKMeansConfig(k=K, n_init=N_INIT))
    t_make = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    readings, done = [], 0     # the estimates after 2, 4 and 8 steps of the one stream
    for steps in READ_LR:
        res = eng.run(steps, state=eng.state if done else None, start_step=done)
        comps_pre, evals = res.cov_lowrank.top(PCA_K)
        readings.append((int(res.count), sketch_mod.unmix_dense(comps_pre, eng.spec), evals))
        done = steps
    comps = readings[-1][1]
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches_lr = ops.launch_counts()
    k4_shapes_lr = dict(sa_mod.sparse_assign.by_shape)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    eng.finalize()
    torch.cuda.synchronize()
    t_fin = time.perf_counter() - t0
    rows = int(res.count)
    state_bytes = eng.state.lowrank.nbytes()
    print(f"  make_engine (Ω drawn on the host) {t_make:.2f} s; streamed {rows} rows in {t_run:.2f} s "
          f"({rows / t_run:.0f} rows/s, K-means++ seeding, {len(READ_LR)} finalizes and unmixes "
          f"included); "
          f"finalize alone {t_fin:.2f} s; peak memory {peak / 2**30:.2f} GiB")
    print(f"  low-rank state {state_bytes} bytes (the (p, p) accumulator would be {4 * P_LR**2} bytes)")
    print(f"  launches on the low-rank path: {launches_lr}; K4's by (r, K, m): {k4_shapes_lr}")
    check(rows == STEPS_LR * BATCH, f"count {rows} != {STEPS_LR * BATCH}")
    check(all(launches_lr[name] > 0 for name in PATH2),
          f"a kernel of the low-rank path never launched: {launches_lr}")
    check(eng.state.moments is None, "the low-rank path also ran the dense moments")
    check(state_bytes <= (ELL + 3) * P_LR * 4 + 64, f"low-rank state of {state_bytes} bytes is not O(l·p)")
    check(tuple(res.cov_lowrank.eigenvalues.shape) == (ELL // 2,),
          f"{tuple(res.cov_lowrank.eigenvalues.shape)} eigenpairs, expected {ELL // 2}")
    for name in ("mean", "centers", "centers_pre", "kmeans_obj"):
        check(bool(torch.isfinite(getattr(res, name)).all()), f"low-rank {name} is not finite")
    check(bool(torch.isfinite(comps).all() and torch.isfinite(res.cov_lowrank.eigenvalues).all()),
          "low-rank PCA output is not finite")
    check(tuple(comps.shape) == (PCA_K, P_LR) and tuple(res.centers.shape) == (K, P_LR),
          f"shapes {tuple(comps.shape)}, {tuple(res.centers.shape)}")
    # Which planted directions the range-finder can resolve after n rows: one
    # entry of the Thm-6 estimate has std σ = v/(γ√n), v = tr(C)/p; the sketch
    # Y' = S'·Ω then carries a noise bulk with singular values near
    # σ√p(√p + √l), against λ²√l for a planted direction, so the edge in λ²
    # units falls as 1/√n. At each reading, gate the subspace of the directions
    # whose λ² is at least 5× that edge. Their eigenvalues' errors are of the
    # edge's own size, not a fraction of λ², so the 10 % eigenvalue gate is
    # read at the full n only (PERF.md, §6).
    planted = src._lam.astype(np.float64) ** 2
    u = src._u.astype(np.float64)
    v = (planted.sum() + 0.05 ** 2 * P_LR) / P_LR
    for n_rows, comps_n, evals_n in readings:
        sigma = v / (GAMMA * math.sqrt(n_rows))
        edge = sigma * math.sqrt(P_LR) * (math.sqrt(P_LR) + math.sqrt(ELL)) / math.sqrt(ELL)
        k_res = int(np.sum(planted >= 5 * edge))
        comps_np = comps_n.double().cpu().numpy()
        comps_np /= np.linalg.norm(comps_np, axis=1, keepdims=True)
        best = np.abs(comps_np @ u).max(axis=0)
        q, _ = np.linalg.qr(comps_np[:k_res].T)
        cosines = np.linalg.svd(q.T @ u[:, :k_res], compute_uv=False)
        sine = float(np.sqrt(max(0.0, 1.0 - cosines.min() ** 2)))
        ev = evals_n.cpu().numpy()
        print(f"  n={n_rows}: range-finder noise edge λ² ≈ {edge:.2f}; gating on the {k_res} "
              f"planted directions with λ² ≥ {5 * edge:.1f}")
        print(f"    λ²/edge of each planted direction {np.round(planted / edge, 2).tolist()}; its best "
              f"|cos| with the top-{PCA_K} components {np.round(best, 4).tolist()}")
        print(f"    top-{k_res} subspace vs planted: sine of largest principal angle {sine:.4f} (< 0.35)")
        print(f"    eigenvalues {np.round(ev, 2).tolist()} vs planted {np.round(planted, 2).tolist()}; "
              f"|error|/edge of the gated ones {np.round(np.abs(ev - planted)[:k_res] / edge, 2).tolist()}")
        check(k_res >= 3, f"only {k_res} planted directions are resolvable at n={n_rows}")
        check(sine < 0.35, f"low-rank top-{k_res} subspace at n={n_rows} is off the planted one: "
                           f"sine {sine:.3f}")
    # ev and k_res are the last reading's, after all STEPS_LR steps
    check(bool(np.all(np.abs(ev[:k_res] - planted[:k_res]) <= 0.1 * planted[:k_res])),
          f"a resolvable low-rank eigenvalue at n={rows} is more than 10% off its planted value")
    state, t_src, t_dev = eng.state, 0.0, 0.0
    for step in range(STEPS_LR, STEPS_LR + 2):
        t0 = time.perf_counter()
        x = eng.host_global_batch(None, step)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = eng.update(state, x, step)
        torch.cuda.synchronize()
        t_src, t_dev = t_src + t1 - t0, t_dev + time.perf_counter() - t1
    print(f"  a step: host source + copy {t_src / 2 * 1e3:.1f} ms, device update {t_dev / 2 * 1e3:.1f} ms; "
          f"device share {t_dev / (t_src + t_dev):.3f}")
    print(f"  sample_indices ({BATCH}, {P_LR}, m={m_lr}): "
          f"{time_ms(lambda: sample_indices(key, BATCH, P_LR, m_lr, device=dev), 2, 1):.2f} ms")
    # one device update under the profiler: device time by kernel, copy and set
    # (every entry that ran on the card, not the host ops that launched them)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.update(state, x, STEPS_LR + 2)
        torch.cuda.synchronize()
    kernel_rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in kernel_rows)
    print(f"  one device update under torch.profiler: {len(kernel_rows)} kernels, copies and sets, "
          f"{sum(e.count for e in kernel_rows)} launches, {total / 1e3:.1f} ms of device time; the "
          f"largest:")
    for e in kernel_rows[:10]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d}x  {e.key[:100]}")
    del state, x

    # ---------------------------------------------------------------- summary
    hadamard = "src/repro_torch/kernels/csrc/hadamard.cu"
    sources = {"sketch_fused": (hadamard, "src/repro/kernels/sketch_fused.py:80", launches),
               # K1's function above 2^15: K3's cluster kernel in its gather mode
               "sketch_fused_cluster": (hadamard, "src/repro/kernels/sketch_fused.py:80", launches_lr),
               "hd_precondition": (hadamard, "src/repro/kernels/fwht.py:205", launches),
               "hd_precondition_chunked": (hadamard, "src/repro/kernels/fwht.py:132", launches_lr),
               "sparse_assign": ("src/repro_torch/kernels/csrc/sparse_assign.cu",
                                 "src/repro/kernels/sparse_assign.py:75", launches),
               "spmm": ("src/repro_torch/kernels/csrc/spmm.cu", "src/repro/kernels/spmm.py:183",
                        launches_lr),
               "spmm_t": ("src/repro_torch/kernels/csrc/spmm.cu", "src/repro/kernels/spmm.py:219",
                          launches_lr)}
    # launches: each kernel's count on its own path's run (phase 5 or phase 7)
    kernels = [dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=counts[name], **entries[name])
               for name, (source, replaces, counts) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
