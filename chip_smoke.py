#!/usr/bin/env python3
"""Build and drive the PyTorch port (src/repro_torch) on one NVIDIA card, and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device   — require a card; print its name and power limit (nvidia-smi).
2. build    — compile every CUDA source for sm_90a; print registers, shared
              memory and spills from ptxas.
3. kernels  — each kernel against its plain PyTorch version on the card, at the
              shapes the two streaming paths give it (and at its edges), with
              its time over repeated launches beside its bound: K2 bit-equal
              at (10, 16384), (4096, 16384) and (16384, 16384) in both sign
              modes, on split_plan's schedule and the others it can take,
              each back to back and by its device time alone; K4 at every
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
              dense path at p = 1000, the low-rank path at p = 40000, and the
              front door, fit_many(Plan(backend="batch", gamma=0.1), [mean,
              PCA(4), K-means(4)]) at p = 1000 (Lloyd's labels equal); the
              engine's replay(passes=2) (low-rank with K-means) and fit_refine
              (PCA, minibatch K-means) at p = 1000: refined subspaces within a
              principal-angle sine of 1e-5, refined labels equal; the trainer
              (train_parity): 3 steps of a reduced gemma3-1b with
              CompressConfig(gamma=0.1), K2 twice a step, within 1e-5 of the
              CPU's losses, grad_norm and residual; serving (serve_parity):
              a reduced gemma3-1b in float32 prefilled with 24 tokens and
              decoded 8 steps, within 1e-5 of the CPU's logits, and one
              sample_indices draw in JAX's original threefry layout (4100
              rows of p = 16384, three row blocks) bit-equal to the CPU's
              rows at the blocks' edges; the other families (family_parity):
              reduced mamba2-1.3b (ssm_prefill of 24 tokens, 8 decode steps),
              zamba2-1.2b (32 tokens decoded one by one into a float32 state)
              and seamless-m4t-large-v2 (a cache over 24 frames, 8 decode
              steps) in float32, within 1e-5 of the CPU's logits; data
              parallel (dp_parity): two gloo ranks on the card (this script
              with --dp-worker) train the reduced gemma3-1b in float32 for 3
              steps with CompressConfig(gamma=0.1), each on 2 of the 4 rows,
              within 1e-5 of one process on the 4 rows (losses, grad_norm,
              the ranks' mean residual), K2 twice a step on each rank, and
              perworker_mean_estimate on the 2 ranks within 1e-5 of max
              |value| of the single-process formula.
5. main     — the full-size stream: Plan(backend="stream", gamma=0.05,
              batch_size=4096), p = 16384, 16 steps, streaming K-means
              (K = 10, r = 3), then pca_from_stream(k=8); every kernel of the
              path (K1, K2, K4) must have launched, the outputs must be finite,
              and the top-8 subspace and eigenvalues must match the source's
              planted ones.
6. costs    — the step's largest costs that are not kernels, and what each
              fold's repeatable form costs a step against the float
              scatter-add it replaces on the card (Σw, the K-means sums, the
              compact covariance at m/p = 0.005, summed by key, and at 0.05,
              by chunked products), each held against its plain version and
              the compact routes repeated bit for bit.
7. lowrank  — the second path at full width: Plan(cov_path="lowrank",
              rank=128), p = 65536, 4 steps of 4096 rows (cut from 8),
              streaming K-means (K = 10, r = 3), then cov_lowrank.top(8)
              unmixed; every kernel of the path (the sketch in K3's cluster
              gather mode, K3 in the unmixes, K4, K5, K6) must have launched,
              the outputs must be finite, the state O(l·p); read after 2 and
              4 steps of the one stream, the subspace of the planted
              directions that the range-finder resolves at each n must match
              the planted one, and after 4 steps their eigenvalues too.
8. front    — the estimator front door at phase 5's width: 65,536 rows of
              p = 16384 on the card (the phase-5 source's planted U and λ),
              fit_many over SparsifiedMean, SparsifiedCov, SparsifiedPCA(8) and
              SparsifiedKMeans(10) (Lloyd, n_init = 3) on the batch and then the
              stream backend (16 sketches; phase 5's PCA gates; the backends
              agree to 1e-5); cov_original (two K2 launches of (16384, 16384));
              Lloyd on a planted mixture of 10 Gaussians (accuracy ≥ 0.95, the
              dense K-means ≥ 0.99, a second fit bit-identical); every kernel of
              the path (K1, K2, K4, K6) must have launched; Lloyd's center
              update bit-equal to the CPU's scatter-add and K4 at (r = 1, K = 10)
              against its plain version, both on the mixture's 65,536 retained
              rows; and the low-rank
              SparsifiedPCA at p = 65536, whose RangeState and top-8 must be
              bit-equal to make_engine(...).run(2) on the same source.
9. resume   — phase 5's Plan, source (its batches kept on the host since
              phase 5: the same (seed, step)s, not made again) and K-means
              with track_reassignments:
              one step folded twice from the same state and batch is
              bit-identical (cov_path "dense" and "compact"); run(8) with a
              checkpoint every 4 steps, restore_state in a fresh engine,
              run(16, state=, start_step=8): mean, cov and centers bit-equal to
              phase 5's run, reassign_total the sum of both legs' counts; the
              checkpoint's bytes, write and restore seconds; fit_many over
              SparsifiedPCA(8) and minibatch SparsifiedKMeans(10) on phase 8's
              rows, checkpointed after 8 of 16 chunks, restore_run into fresh
              consumers and continued: bit-equal to the uninterrupted run.
10. refine  — fit_many(Plan(stream, cov_path="lowrank", rank=24), [PCA(8),
              minibatch K-means(10)], phase 8's rows, refine=2): 16 sketches
              a pass, the refined subspace no farther from phase 8's dense
              components than the one-pass one, the K-means objective under
              each pass's frozen centers not increasing, a repeat
              bit-identical; at p = 65536, l = 128, 8 steps staged on the card
              (phase 7's planted U and λ): the fold-twice probe at this shape,
              run_scanned bit-equal to run over 2 steps, run_scanned then
              replay_scanned(passes=2) with K-means (K = 10, r = 3) under
              phase 7's gates, a repeat bit-identical, every kernel launched;
              SparsifiedPCA(8) with lowrank_method="fd", rank=32 on 16,384 of
              phase 8's rows: its sketch against the port's FD on the CPU
              and a float64 FD on the same sketches, and FD's deterministic
              bound; each of phase 10's three paths gated on its kernels.
11. serve   — SketchService(workers=4, device="cuda") at phase 5's width
              (p = 16384, γ = 0.05, batch_size = 4096) on phase 8's planted
              generator: one dense group (SparsifiedMean, SparsifiedPCA(8) on
              the (p, p) moment, minibatch SparsifiedKMeans(10)) and three
              low-rank groups (SparsifiedPCA(8), rank = 64, and minibatch
              K-means), 16,384 rows a group in requests of 4096 interleaved
              across groups; every answer (components, explained variance,
              centers, mean, predict on 4096 rows) bit-identical to fit_many
              over the same rows, plan and key, and to the same sequence
              through workers=1; K5 and K6 on one low-rank group's first
              chunk (4096 rows, m = 819, p = 16384, its Ω of width 64)
              against their plain versions within 1e-5 of max |plain|;
              a snapshot after 2 of 4 requests a group,
              restored into a fresh service and continued, bit-identical to
              the uninterrupted service (bytes, write and restore seconds);
              the HTTP frontend (256-row requests) equal to the in-process
              answers and a 429 with Retry-After past the admission cap; one
              scrape of serve_metrics whose serve.* counters reconcile with
              the requests sent, with a kernels.dispatch{path="kernel"}
              series for K1, K2, K4, K5 and K6 and no path="ref" series;
              phase 5's engine for 4 steps with EngineTelemetry bit-identical
              to the same run without it (the spans' host times beside the
              update's device time, the instrumentation's cost, the
              record_function names in a torch.profiler capture); and
              python -m repro_torch.launch.sketch_serve --device cuda with
              --supervise --crash-after against an uninterrupted run, their
              --out files equal.

12. sharded — the paper's distributed setting at phase 5's width:
              Plan(backend="sharded", n_shards=2, batch_size=2048), p = 16384,
              γ = 0.05, 2 steps with streaming K-means (K = 10, r = 3,
              reassignments tracked). (a) one process in a one-rank NCCL
              group: the engine against backend="stream" (mean and centers
              within 1e-5, the covariance trace 1e-5 relative, count and
              reassignments equal), a rerun bit-identical, the obs.psum spans
              and NCCL in a torch.profiler capture, K1, K4 and K6 at the
              step's shapes against their plain versions, the all-reduce of
              a step's delta timed with its bytes, rows/s and peak memory;
              (c) continue_elastic from 2 workers to 1 bit-equal to the
              uninterrupted run, the sharded low-rank path at p = 65536,
              l = 128, 2 steps, within 1e-5 of max |value| of the stream
              engine's RangeState (the cluster sketch, K5, K6 held against
              their plain versions), and fit_many([SparsifiedCov,
              SparsifiedKMeans(10, minibatch)]) on phase 8's rows against
              the stream backend; (b) python -m repro_torch.launch.cluster
              with 2 processes on the one card over gloo: equal to (a), each
              rank launching K1, K4 and K6, cluster.hosts == 2 from
              --log-every, the all-reduce timed, a checkpoint after step 1
              and --resume to step 2 bit-equal to the uninterrupted run.

13. train  — gemma3-1b at full width, its depth cut to DEPTH13 = 6 of
              26 layers, one of its 5:1 local/global groups (765,016,704
              bf16 parameters), CompressConfig(gamma=0.1) with error feedback,
              AdamW in float32, SyntheticLMSource(seed=0) at seq 4096, a
              global batch of 8 as ACCUM13 micro-batches, 6 steps through
              make_train_fn: every loss finite and the last two below the
              first; K2 on its kernel path twice a step at (46,693, 16384)
              and no plain version; wire_floats = 46,693 × 1638 in float32
              (76,483,136); peak memory under 70 GiB; a checkpoint of the
              state after step 3, written
              by save's thread while steps 4-6 run, restored bit-equal and
              continued to step 6 with the uninterrupted run's losses and
              final parameters, bit for bit; at the final parameters K2 on a
              real gradient's chunks bit-equal to its plain version in both
              modes (timed beside its bound and x @ (H·D)), the step's mask
              bit-equal to the CPU's draws, the error-feedback identity
              ĝ + r' = g + r, and a step's time split into forward+backward
              (one micro-batch's, with its largest kernels), compression and
              the optimizer.

14. lm-serve — LM serving at full width through get_api's prefill_fn,
              decode_fn and init_decode_state and ServeEngine, in bf16
              unless stated, random weights from a seeded torch.Generator:
              (a) gemma3-1b on launch.serve's path, prefill of 2 × 32768
              (prefill_32k's sequence, batch 32 → 2) into a float32 cache
              padded by 16, then 16 greedy decode steps; (b) decode_32k's
              cache length: init_kv_cache(32, 32768) in bf16 (27.9 GB,
              batch 128 → 32) filled from a seeded generator, 16 decode
              steps from cur_len = 32753; (c) glm4-9b (18.8 GB of weights)
              prefill of 8 × 4096 (train_4k's sequence), 32 decode steps;
              (d) qwen2-vl-2b prefill of 4 × 4096 with 256 seeded vision
              embeddings on a 16 × 16 M-RoPE grid, 16 decode steps; (e)
              ServeEngine(n_slots=4, max_len=128) over 8 requests of 8–64
              prompt tokens, max_new=8 (2 waves), gemma3-1b in float32 with
              TF32 off, every request's tokens equal to its one-by-one
              greedy decoding (each alone in its slot of its wave). Gates:
              every logit finite; peak memory under 70 GiB a case; for (a)
              at 4096 tokens, (c) and (d), prefill then one decode_step
              against forward over one more token within TOL14 of max
              |logit|, argmax equal where the top-2 margin exceeds it. It
              prints prefill tokens/s, decode ms a step and tokens/s beside
              the step's byte bound (the cache and the weights read, over
              3.35 TB/s) and peak memory. No kernel of the repo serves a
              model, so the phase's launches are 0.

15. lm-families — the ssm, hybrid and audio families at full width and depth in
              bf16, random weights from a seeded torch.Generator: (a) training:
              mamba2-1.3b, zamba2-1.2b and seamless-m4t-large-v2 each through
              make_train_fn, AdamW and CompressConfig(gamma=0.1) with error
              feedback on SyntheticLMSource(seed=0), 2 steps of 4 × 4096 (the
              audio batch's frames as launch.train draws them), each as 2
              micro-batches of 2: every loss finite, K2 twice a step on its kernel
              path at (88,301 | 71,441 | 124,194, 16384), wire_floats = chunks
              × 1638 (a float32 metric, so rounded to float32; the round
              trip's own count exactly), ĝ + r' = g + r on a real gradient,
              peak memory under 70 GiB; s a step, tokens/s, peak GiB and a
              step's parts (a micro-batch's forward and backward, the
              compression) printed; K2 on the real chunks, its first and last
              row blocks bit-equal to its plain version, timed beside its
              bound. (b) serving:
              mamba2-1.3b ssm_prefill of 4 × 4096, then 16 decode steps from
              its states; zamba2-1.2b 16 steps from cur_len 4081 of a 4 × 4096
              state whose KV sites a seeded generator fills, and a 64-token
              prompt decoded token by token; seamless-m4t-large-v2's
              init_decode_cache over 4 × 4096 frames, then 16 steps; gates:
              prefill and decode steps within TOL14 of max |logit| of forward
              over the same tokens, argmax equal where the top-2 margin
              exceeds it; ServeEngine (float32, TF32 off) equal to one-by-one
              decoding for mamba2-1.3b and zamba2-1.2b; decode ms a step
              beside its byte bound (the weights but the embedding, and the
              state or cache, read once over 3.35 TB/s).

16. dp-train — data-parallel training: python -m repro_torch.launch.train
              --devices 2 --dist-backend gloo on the one card, gemma3-1b at
              full width, its depth cut to DEPTH16 = 6 of 26 layers (one
              5:1 local/global group; two ranks share the 80 GB), bf16,
              AdamW, CompressConfig(gamma=0.1) with error feedback, seq
              4096, a global batch of 4 (2 rows a rank as one
              micro-batch), 2 steps with a checkpoint after step 1; the
              launcher places the state (FSDP, train/fsdp.py). Gates: every
              loss finite; K2 on its kernel path twice a step on each rank
              (on its range of the chunks); each step's two all-to-alls
              exactly the bytes the layout gives (counted by the trainer,
              printed beside the dense 4·p); the launcher again, resuming at
              2 ranks from step 1, bit-equal in losses and final parameters
              (their SHA-256, gathered whole); one process restored from the
              step-1 checkpoint (the elastic path, 2 → 1: the one residual)
              continuing to step 2 with finite losses within 0.05 of the 2
              ranks'; peak memory under 35 GiB a rank. It prints s a step,
              tokens/s, the all-to-alls' ms and bytes a step and the mask's
              share of a step.

17. moe — the moe family at full width in bf16, random weights from a seeded
              torch.Generator: (a) qwen3-moe-235b-a22b cut to DEPTH17A = 4 of
              94 layers (≈ 22.4 GB): prefill of 2 × 4096, 16 greedy decode
              steps beside their byte bound (every expert's weights and the
              cache read once over 3.35 TB/s); (b) kimi-k2-1t-a32b cut to its
              dense layer and one MoE layer with its shared expert (≈ 39.8
              GB): prefill of 1 × 4096, 8 decode steps. Gates for both:
              phase 14's prefill-then-decode gate at TOL14 over 512 tokens at
              capacity factor E/k, where no slot drops (at the config's 1.25
              the forward over one more token drops that token's slots where
              a bucket overflows, and a decode step never does); ServeEngine (bf16)
              equal to one-by-one decoding; the first MoE layer on 64 float32
              tokens, the card (TF32 off) against moe_apply_local on the CPU
              on the same float32 weights (its first 16 experts), ids equal,
              y and aux within 1e-5; peak under 70 GiB. Decode's byte bound
              twice: every expert's weights read (what the reference's
              einsum reads too), and only the experts a step routes to
              (each layer's distinct ids in this run).
              (c) qwen3-moe-235b-a22b trained at full width cut to 1 layer and
              32 of its 128 experts (the trainer keeps ≈ 18 B a parameter),
              CompressConfig(gamma=0.1) with error feedback, 3 steps of 2 ×
              4096 as 2 micro-batches: finite losses, K2 twice a step on its
              kernel path, wire_floats = chunks × m, the loss function's aux
              in its loss, peak under 70 GiB. (d) moe_apply_ep on 2 gloo
              ranks of the card (this script with --moe-worker, started
              with the phase so that their start-up overlaps (a)–(c); they
              wait for (c) to end), mesh (1, 2): qwen3-moe-235b-a22b at full width cut to 1 layer, each rank
              with the whole tree and its 64 experts, lm_loss and its
              backward over 1 × 4096 tokens at capacity factor 4, where
              nothing drops (every expert's load fits the second grouping's
              4096 slots), against the rank's own one-process run
              (moe_apply_local at capacity factor E/k):
              the loss within 1e-3 relative, aux 1e-5, the logits and the
              rank's block of the expert gradients within 0.03 of their
              largest entry (bf16 sums in other orders), zero outside the
              block; the all-to-all's bytes a layer and its ms over gloo.

18. roofline — the dry-run's yardstick (``repro_torch.roofline``) on the
              card: (a) the card is an H100 with roofline.hw's 132 SMs and
              its device memory within 5 % of hw's; (b) three gemma3-1b
              cells at full width, each at the two depth probes
              (analysis.probe_depths): phase 13's training step (8 × 4096
              as 2 micro-batches, CompressConfig(gamma=0.1)), prefill of
              2 × 32768 and decode against a 32 × 32768 bf16 cache. Each
              runs trainer.lower_cell's step once on the meta device and
              once on the card under one counter.OpCounter: flops by dtype,
              bytes and kernel counts equal (K2 twice a training step, by
              its model), the meta high-water mark within 10 % of
              torch.cuda.max_memory_allocated (reset before each); then
              the step again, timed by CUDA events outside the counting mode
              (once for training, the median of 3 for prefill and decode),
              beside its roofline bound and its mfu (model_flops over 989
              TFLOP/s × the step); and each cell's extrapolation to the
              full 26 layers (t_compute, t_memory, dominant, model_flops).
              Phase 3's bounds come from roofline.kernels too.

19. fsdp — FSDP placement against the replicated path: two gloo ranks on the
              one card (this script with --fsdp-worker), phase 16's model and
              trainer (gemma3-1b at full width cut to DEPTH16 layers, bf16,
              CompressConfig(gamma=0.1) with error feedback, a global batch
              of 4 × 4096, a rank's 2 rows as ACCUM19 = 2 micro-batches, so
              each micro-batch's reduce-scatter adds into the placed float32
              accumulator and the replicated path accumulates over ranks),
              STEPS19 steps placed (trainer.place_state) and STEPS19 steps
              replicated (the state init_state builds) from the same
              weights. Gates: every loss finite; the first step's losses
              equal in both paths (the same weights and batch), the later
              steps' within LOSS19 (the placed residual is the ranks' mean,
              the replicated one each rank's own), and their parameters
              (the placed ones gathered) within the bf16 bound of
              tests/test_torch_dp.py (at most 3 % of
              the coordinates more than one unit apart, each within 2·lr a
              step plus 2^-7 of its value); each rank's masks of its chunk
              range bit-equal to those rows of the replicated step's; each
              rank's state on the card within 2 % of the layout's bytes (its
              blocks, the leaves that stay whole, its range of the
              residual); K2 on its kernel path twice a placed step on each
              rank. It prints both paths' s a step, K2's launches and shape,
              the bytes each rank's collectives moved by kind and each
              rank's peak memory.

Then one JSON line listing every kernel (launches: its path's run in phase 5
or 7; launches_by_phase: that count and phase 9's, 10's, 11's, 12's, 13's, 14's,
15's, 16's, 17's, 18's and 19's paths' own),
the card's line again, and the result line
``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

P, BATCH, STEPS, GAMMA, K, N_INIT, PCA_K = 16384, 4096, 16, 0.05, 10, 3, 8
# the low-rank path: p, sketch width l, steps (cut from 8 to 4 since phase 16
# came: its host source takes ≈ 8 s a step), and the steps after which its
# gates are read; phase 10's replay at p = 65536 keeps 8 steps, staged on
# the card
P_LR, ELL, STEPS_LR, STEPS10_LR = 65536, 128, 4, 8
# columns of K6's check past the grid's y limit
P_BIG = 1 << 25
READ_LR = (2, STEPS_LR)
# the dense stream: the sketch, the unmixes, the K-means assignment (K4) and
# the K-means sums (K6's transposition and walk)
PATH1 = ("sketch_fused", "hd_precondition", "sparse_assign", "spmm_t", "transpose_columns")
PATH2 = ("sketch_fused_cluster", "hd_precondition_chunked", "sparse_assign", "spmm", "spmm_t",
         "transpose_columns")
# the front door (phase 8): the sketch, the unmixes (cov_original's two of
# (16384, 16384) among them), Lloyd's assignment (K4) and its center update (K6)
PATH8 = ("sketch_fused", "hd_precondition", "sparse_assign", "spmm_t", "transpose_columns")
# phases 9 and 10 together run every kernel: K1 and K2 at p = 16384; the
# cluster sketch, K3, K5 at p = 65536; K4 and K6 at both. Phase 9 resumes the
# dense stream
PATH9 = PATH1
# phase 10: fit_many(refine=2) at p = 16384 (low-rank PCA and minibatch
# K-means), Frequent Directions; the p = 65536 replay takes PATH2
PATH10_REFINE = PATH1 + ("spmm",)
PATH_FD = ("sketch_fused", "hd_precondition", "spmm_t", "transpose_columns")
# phase 11: rows a group, requests of HTTP rows, the engine's steps under
# telemetry, rounds of steady queries, and how long a request may take
GROUP_ROWS, HTTP_ROWS, TEL_STEPS, QUERY_ROUNDS, TIMEOUT_S = 4 * BATCH, 256, 4, 20, 300.0
# the serving path at p = 16384: K1, K2 (the finalize's unmix), K4, K5, K6
PATH11 = ("sketch_fused", "hd_precondition", "sparse_assign", "spmm", "spmm_t",
          "transpose_columns")
# phase 12: rows a shard a step and steps of the dense sharded stream (cut
# from 8 to 4 since phase 16 came and to 2 since phase 17 came, to keep the
# whole script inside its time); the low-rank sharded path's rows a shard
# and steps (cut from 4 to 2 since phase 17 came)
B12, STEPS12, B12_LR, STEPS12_LR = 2048, 2, 1024, 2
# phase 13: gemma3-1b trained at full width: the config's train_4k sequence
# length, a global batch of 8 sequences as ACCUM13 micro-batches, its steps and
# the step after which it checkpoints, its peak-memory ceiling, AdamW's peak
# lr, and flash_attention's query and KV chunks
SEQ13, BATCH13, ACCUM13, STEPS13, CKPT13, PEAK13_GIB, LR13 = 4096, 8, 2, 6, 3, 70.0, 1e-3
# its depth: 6 of gemma3-1b's 26 layers (one 5:1 local/global group), cut
# so that the whole script, phases 15 and 16 added, stays inside its time
# (cut from 26, then 12)
DEPTH13 = 6
Q13, KV13 = 1024, 1024
# phase 14: LM serving at full width in bf16. (a) gemma3-1b at prefill_32k's
# sequence, batch 2 (of 32), a float32 cache, and its prefill-then-decode gate
# at GATE14 tokens; (b) decode_32k's cache length at batch 32 (of 128); (c)
# glm4-9b prefill at train_4k's sequence, batch 8; (d) qwen2-vl-2b prefill at
# 4096, batch 4, with its 256 vision tokens on a 16 × 16 grid; (e) gemma3-1b in
# float32 through ServeEngine: 8 requests over 4 slots, max_len 128, 16 new
# tokens each. The gates' logit tolerance is TOL14 of max |logit| (below); the
# ceiling on peak memory PEAK14_GIB
S14A, B14A, GEN14A, GATE14 = 32768, 2, 16, 4096
B14B, GEN14B = 32, 16
S14C, B14C, GEN14C = 4096, 8, 32
S14D, B14D, GEN14D, GRID14 = 4096, 4, 16, 16
SLOTS14, MAXLEN14, REQS14, NEW14 = 4, 128, 8, 8       # NEW14 16 → 8 since phase 16 came
PEAK14_GIB = 70.0
# prefill then one decode_step against forward over one more token, in bf16:
# the port against the reference (each rounding its bf16 matmuls its own way)
# differs by up to 0.034 of max |logit| on the CPU at reduced width and full
# depth (gemma3-1b's 26 layers; glm4-9b's 40: 0.022; qwen2-vl-2b's 28: 0.020),
# so 0.08 (2.3× that); argmax equal wherever the top-2 margin exceeds it
TOL14 = 0.08
# phase 15: the ssm, hybrid and audio families at full width and depth in
# bf16. Training: SyntheticLMSource(seed=0) at train_4k's sequence, a global
# batch of B15 sequences as ACCUM15[arch] micro-batches (sized so the peak
# stays under PEAK15_GIB), STEPS15 steps, CompressConfig(gamma=0.1) with error
# feedback, AdamW's peak lr LR13 and attention chunks Q13 × KV13; the
# gradient's chunks of 16384 each model must have. Serving: B15S × S15
# (train_4k's sequence) and GEN15 decode steps; zamba2's prompt of PROMPT15
# tokens decoded token by token; ServeEngine over REQS15 requests of NEW15
# new tokens in SLOTS15 slots of MAXLEN15, in float32 with TF32 off. The
# training steps were cut from 4 to 3 since phase 16 came and to 2 since
# phase 17 came
SEQ15, B15, STEPS15, PEAK15_GIB = 4096, 4, 2, 70.0
ACCUM15 = {"mamba2-1.3b": 2, "zamba2-1.2b": 2, "seamless-m4t-large-v2": 2}
CHUNKS15 = {"mamba2-1.3b": 88_301, "zamba2-1.2b": 71_441, "seamless-m4t-large-v2": 124_194}
B15S, S15, GEN15, PROMPT15 = 4, 4096, 16, 64
SLOTS15, MAXLEN15, REQS15, NEW15 = 4, 64, 4, 8
# phase 16: data-parallel training through launch.train --devices 2 over gloo
# on the one card: gemma3-1b at full width cut to DEPTH16 layers (one 5:1
# local/global group; two ranks share the 80 GB), train_4k's sequence, a
# global batch of B16 (B16 / 2 rows a rank as ACCUM16 micro-batch: placed,
# gloo moves every micro-batch's gathers through the host), STEPS16
# steps with a checkpoint after CKPT16; a rank's peak-memory ceiling; how
# far the one-process continuation from the checkpoint (2 → 1 ranks) may
# stray from the 2 ranks' losses
SEQ16, B16, ACCUM16, STEPS16, CKPT16, DEPTH16 = 4096, 4, 1, 2, 1, 6
PEAK16_GIB, ELASTIC16 = 35.0, 0.05
# phase 17: the moe family in bf16. (a) qwen3-moe-235b-a22b at full width cut
# to DEPTH17A of its 94 layers, prefill of B17A × S17 then GEN17A decode
# steps; (b) kimi-k2-1t-a32b cut to DEPTH17B of 61 (its dense layer and one
# MoE layer), prefill of B17B × S17 then GEN17B steps; for both the
# prefill-then-decode gate at TOL14 over GATE17 tokens at a capacity where no
# slot drops, ServeEngine over REQS17 requests of
# NEW17 new tokens in SLOTS17 slots of MAXLEN17 against one-by-one decoding,
# and the first MoE layer on CPU17 float32 tokens on the card against
# moe_apply_local on the CPU, within TOL17 of max |y|, with its first
# CPU17_EXPERTS experts (and kimi's shared expert): a float32 copy of a whole
# kimi layer is 68 GB of the host's 96 GiB, and the copy is the gate's cost. (c) qwen3-moe-235b-a22b
# trained at full width but DEPTH17C layer and EXPERTS17C of its 128
# experts, a global batch of B17C × S17 as ACCUM17C micro-batches, STEPS17C
# steps, CompressConfig(gamma=0.1) with error feedback. (d) moe_apply_ep on
# 2 gloo ranks of the card (this script with --moe-worker), mesh (1, 2):
# qwen3-moe-235b-a22b at full width cut to DEPTH17D layer, lm_loss and its
# backward over 1 × S17 tokens with nothing dropped — at capacity factor
# CF17D_EP (a rank bucket holds all its tokens' slots from 2 on, the second
# grouping 256·cf² slots an expert; the random router sends ≈ 3880 of the
# 4096 tokens to one expert) — against the same rank's one-process
# moe_apply_local run at capacity factor E/k (room for every token): the loss within
# TOL17D_LOSS relative, the logits and each rank's block of the expert
# gradients within TOL17D of their largest entry (bf16 sums in other orders)
S17, GATE17, PEAK17_GIB = 4096, 512, 70.0
DEPTH17A, B17A, GEN17A = 4, 2, 16
DEPTH17B, B17B, GEN17B = 2, 1, 8
SLOTS17, MAXLEN17, REQS17, NEW17 = 4, 48, 4, 4
CPU17, CPU17_EXPERTS, TOL17 = 64, 16, 1e-5
DEPTH17C, EXPERTS17C, B17C, ACCUM17C, STEPS17C = 1, 32, 2, 2, 3
DEPTH17D, CF17D_EP, TOL17D, TOL17D_LOSS, A2A17_REPS = 1, 4.0, 0.03, 1e-3, 3
# phase 19: phase 16's model and trainer on 2 gloo ranks of the card, STEPS19
# steps placed (FSDP) and STEPS19 replicated from the same weights, each
# rank's 2 rows as ACCUM19 micro-batches (gloo moves every micro-batch's
# gathers and reduce-scatters through the host: a placed step took 14.5 s
# at 2 micro-batches on an H100); the first step's losses equal, a later
# step's within LOSS19 (7.44e-05 apart at one micro-batch, while a step
# moves the loss by ≈ 1.9); at most FLIP19 of the parameters more than one
# bf16 unit apart (tests/test_torch_dp.py's bf16 bound), each rank's state
# within MEM19 of its layout's bytes
STEPS19, ACCUM19, FLIP19, MEM19, LR19, LOSS19 = 2, 2, 3e-2, 0.02, 3e-4, 1e-3
# phase 8's mixture: K Gaussians of unit noise whose means are drawn N(0, SEP²/p·I),
# so two means lie ≈ SEP·√2 apart; in the sparsified metric a row's margin is
# ≈ √γ·SEP·√2 / 2 = 6.3 noise σ at γ = 0.05 (dense: ≈ 28 σ)
SEP = 40.0


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


def same_bits(a, b) -> list[str]:
    """The fields in which two engine states differ in any bit."""
    import torch

    out = []
    for slot in ("moments", "kmeans", "lowrank"):
        x, y = getattr(a, slot), getattr(b, slot)
        for f in dataclasses.fields(x) if x is not None else ():
            u, v = getattr(x, f.name), getattr(y, f.name)
            if u is not None and not torch.equal(u, v):
                out.append(f"{slot}.{f.name}")
    for i, (u, v) in enumerate(zip(a.reassign or (), b.reassign or ())):
        if not torch.equal(u, v):
            out.append(f"reassign[{i}]")
    return out


def subspace_sine(a, b) -> float:
    """Largest principal-angle sine between the row spaces of a and b, as
    ‖(I − QaQaᵀ)Qb‖₂ over float64 orthonormal bases (it resolves angles near
    1e-7, where √(1 − cos²) of float32 rows stops near 1e-3)."""
    qa = np.linalg.qr(np.asarray(a.cpu(), np.float64).T)[0]
    qb = np.linalg.qr(np.asarray(b.cpu(), np.float64).T)[0]
    return float(np.linalg.norm(qb - qa @ (qa.T @ qb), 2))


def planted_gates(comps, evals, n_rows, p, u, lam, ell, what: str, eigenvalues: bool = True) -> None:
    """Which planted directions a range-finder of width ``ell`` resolves
    after ``n_rows`` rows, and the gates on them: one entry of the Thm-6
    estimate has std σ = v/(γ√n), v = tr(C)/p; the sketch Y' = S'·Ω then
    carries a noise bulk with singular values near σ√p(√p + √l), against
    λ²√l for a planted direction, so the edge in λ² units falls as 1/√n. The
    subspace of the directions whose λ² is at least 5× that edge must match
    the planted one (sine < 0.35) and, with ``eigenvalues``, their
    eigenvalues be within 10 % (PERF.md, §6)."""
    planted = lam.astype(np.float64) ** 2
    u = u.astype(np.float64)
    v = (planted.sum() + 0.05 ** 2 * p) / p
    sigma = v / (GAMMA * math.sqrt(n_rows))
    edge = sigma * math.sqrt(p) * (math.sqrt(p) + math.sqrt(ell)) / math.sqrt(ell)
    k_res = int(np.sum(planted >= 5 * edge))
    check(k_res >= 3, f"{what}: only {k_res} planted directions are resolvable at n={n_rows}")
    comps_np = comps.double().cpu().numpy()
    comps_np /= np.linalg.norm(comps_np, axis=1, keepdims=True)
    best = np.abs(comps_np @ u).max(axis=0)
    q, _ = np.linalg.qr(comps_np[:k_res].T)
    s = float(np.sqrt(max(0.0, 1.0 - np.linalg.svd(q.T @ u[:, :k_res], compute_uv=False).min() ** 2)))
    ev = evals.cpu().numpy()
    print(f"  {what}, n={n_rows}: range-finder noise edge λ² ≈ {edge:.2f}; gating on the {k_res} "
          f"planted directions with λ² ≥ {5 * edge:.1f}")
    print(f"    λ²/edge of each planted direction {np.round(planted / edge, 2).tolist()}; its best "
          f"|cos| with the top-{len(comps_np)} components {np.round(best, 4).tolist()}")
    print(f"    top-{k_res} subspace vs planted: sine of largest principal angle {s:.4f} (< 0.35)")
    print(f"    eigenvalues {np.round(ev, 2).tolist()} vs planted {np.round(planted, 2).tolist()}; "
          f"|error|/edge of the gated ones {np.round(np.abs(ev[:len(planted)] - planted)[:k_res] / edge, 2).tolist()}")
    check(s < 0.35, f"{what}: the top-{k_res} subspace at n={n_rows} is off the planted one: sine {s:.3f}")
    if eigenvalues:
        check(bool(np.all(np.abs(ev[:k_res] - planted[:k_res]) <= 0.1 * planted[:k_res])),
              f"{what}: a resolvable eigenvalue at n={n_rows} is more than 10% off its planted value")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class _Memo:
    """A source's batches, each generated once and kept (phase 11 runs one
    engine on the source, then another over the same batches)."""

    def __init__(self, source):
        self.source, self.cache = source, {}

    def batch_at(self, step: int, shard: int = 0):
        if (step, shard) not in self.cache:
            self.cache[step, shard] = self.source.batch_at(step, shard)
        return self.cache[step, shard]


def _http(url: str, body=None):
    """(code, JSON body, headers) of a GET (body None) or a JSON POST; HTTP
    error codes are answers here, not failures."""
    import urllib.error
    import urllib.request

    req = (urllib.request.Request(url) if body is None else
           urllib.request.Request(url, json.dumps(body).encode(),
                                  {"Content-Type": "application/json"}))
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _scrape(url: str) -> dict[str, float]:
    """One /metrics scrape as {sample name with labels: value}."""
    import urllib.request

    text = urllib.request.urlopen(url, timeout=TIMEOUT_S).read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def phase11_serve(card: str) -> dict[str, int]:
    """Phase 11 (module docstring): the sketch service on the card. Returns
    the kernels' launches in the 4-worker service's run."""
    import signal

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api, obs
    from repro_torch.core import sketch as sketch_mod
    from repro_torch.data.pipeline import VectorStreamSource
    from repro_torch.kernels import ops, ref
    from repro_torch.sketchserve import ESTIMATORS, SketchService, restore_service, serve_http
    from repro_torch.sketchserve.snapshot import plan_to_json
    from repro_torch.stream import EngineTelemetry, StreamKMeansConfig
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.utils import prng

    groups = ("dense", "lr1", "lr2", "lr3")
    print(f"== 11 serve: SketchService at p={P}, gamma={GAMMA}, batch_size={BATCH}: groups "
          f"{list(groups)}, {GROUP_ROWS} rows a group in requests of {BATCH}", flush=True)
    t11 = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base11 = torch.cuda.memory_allocated()      # what earlier phases still hold
    reg = obs.MetricsRegistry()
    prev_reg = obs.set_default_registry(reg)     # this phase's kernels.dispatch alone
    src = VectorStreamSource(p=P, batch=BATCH, seed=0)      # phase 8's planted U and λ
    gen = torch.Generator(device=dev).manual_seed(11)
    u, lam = torch.from_numpy(src._u).to(dev), torch.from_numpy(src._lam).to(dev)

    def planted(n):
        x = (torch.randn((n, src.k), generator=gen, device=dev) * lam) @ u.T
        return x.add_(torch.randn((n, P), generator=gen, device=dev), alpha=0.05)

    rows = {g: planted(GROUP_ROWS) for g in groups}
    x_pred = planted(BATCH)
    plan_d = api.Plan(backend="stream", gamma=GAMMA, batch_size=BATCH)
    plans = {g: plan_d if g == "dense" else plan_d.replace(cov_path="lowrank", rank=64)
             for g in groups}
    keys = {g: 21 + i for i, g in enumerate(groups)}
    km = {"k": K, "algorithm": "minibatch"}
    tenants = {g: ([(f"{g}.mean", "mean", {})] if g == "dense" else [])
               + [(f"{g}.pca", "pca", {"n_components": PCA_K}), (f"{g}.km", "kmeans", km)]
               for g in groups}
    n_tenants = sum(len(t) for t in tenants.values())
    n_req = GROUP_ROWS // BATCH
    order = [(g, r) for r in range(n_req) for g in groups]       # interleaved across groups

    def create(svc):
        for g in groups:
            for tid, kind, params in tenants[g]:
                svc.create_tenant(tid, kind, plan=plans[g], key=keys[g], group=g, **params)

    def ingest(svc, reqs) -> float:
        t0 = time.perf_counter()
        futs = [svc.ingest(g, rows[g][r * BATCH:(r + 1) * BATCH]) for g, r in reqs]
        acks = [f.result(TIMEOUT_S) for f in futs]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(all(a.ok for a in acks), f"serve: ingest failed: {[a.error for a in acks][:2]}")
        return dt

    def answers(svc, first=None) -> dict:
        """Every tenant's answers; ``first`` gets each tenant's first query
        seconds (its lazy finalize)."""
        out = {}
        for g in groups:
            for tid, kind, _ in tenants[g]:
                t0 = time.perf_counter()
                if kind == "mean":
                    out[tid] = svc.query(tid, "mean", timeout=TIMEOUT_S).unwrap()
                elif kind == "pca":
                    got = svc.query(tid, "components", timeout=TIMEOUT_S).unwrap()
                    out[tid], out[f"{tid}/ev"] = got["components"], got["explained_variance"]
                else:
                    out[tid] = svc.query(tid, "centers", timeout=TIMEOUT_S).unwrap()
                if first is not None:
                    first[tid] = time.perf_counter() - t0
                if kind == "kmeans":
                    out[f"{tid}/predict"] = svc.query(tid, "predict", x_pred,
                                                      timeout=TIMEOUT_S).unwrap()
        return out

    def differ(a, b) -> list[str]:
        check(sorted(a) == sorted(b), f"serve: answer sets differ: {sorted(a)} {sorted(b)}")
        return [k for k in sorted(a) if a[k].shape != b[k].shape or not np.array_equal(a[k], b[k])]

    # 1-2: 4 workers, every answer against fit_many; 6: one scrape
    svc4 = SketchService(workers=4, device="cuda", registry=reg)
    with svc4:
        create(svc4)
        ops.reset_counts()
        t_ing4 = ingest(svc4, order)
        first = {}
        ans4 = answers(svc4, first)
        launches11 = ops.launch_counts()
        lat = []
        steady = ("dense.pca", "lr1.pca", "dense.km", "dense.mean")
        for _ in range(QUERY_ROUNDS):
            for tid in steady:
                t0 = time.perf_counter()
                svc4.query(tid, "stats", timeout=TIMEOUT_S).unwrap()
                lat.append(time.perf_counter() - t0)
        n_queries = sum(2 if kind == "kmeans" else 1 for t in tenants.values()
                        for _, kind, _ in t) + QUERY_ROUNDS * len(steady)
        h = reg.histogram("serve.request_seconds").summary()
        with obs.serve_metrics(reg) as server:
            scraped = _scrape(server.url)
        fin = [svc4.query(tid, "stats", timeout=TIMEOUT_S).unwrap()["finalize_count"]
               for t in tenants.values() for tid, _, _ in t]
        st_bytes = {g: svc4.query(tenants[g][-2][0], "stats", timeout=TIMEOUT_S).unwrap()
                    ["state_bytes"] for g in ("dense", "lr1")}
    print(f"  4 workers: {len(order)} requests ({len(groups) * GROUP_ROWS} rows) ingested in "
          f"{t_ing4:.3f} s = {len(groups) * GROUP_ROWS / t_ing4:.0f} rows/s; first query (lazy "
          f"finalize) s: {', '.join(f'{k} {v:.3f}' for k, v in first.items())}")
    print(f"  launches in the service's run: {launches11}; state bytes of a PCA tenant: "
          f"{st_bytes}")
    p50, p99 = obs.quantiles(lat, (0.5, 0.99))
    print(f"  steady stats queries (client clock, {len(lat)}): p50 {p50 * 1e3:.3f} ms, p99 "
          f"{p99 * 1e3:.3f} ms; serve.request_seconds over all {h['count']} requests (ingest, "
          f"admin, queries): p50 {h['p50'] * 1e3:.3f} ms, p99 {h['p99'] * 1e3:.3f} ms, max "
          f"{h['max'] * 1e3:.3f} ms")
    check(all(launches11[name] > 0 for name in PATH11),
          f"serve: a kernel of the serving path never launched: {launches11}")
    check(fin == [1] * n_tenants, f"serve: lazy finalize ran {fin} times a tenant")

    # 6: the scrape reconciles with what was sent
    n_admin = n_tenants
    want = {"serve_ingest_requests": len(order), "serve_ingest_rows": len(groups) * GROUP_ROWS,
            "serve_queries": n_queries, "serve_requests": len(order) + n_queries + n_admin,
            "serve_finalizes": n_tenants, "serve_rejected": 0,
            "serve_coalesced_requests_sum": len(order),
            "serve_coalesced_requests_count": scraped.get("serve_ingest_folds", -1),
            "serve_pending_rows": 0}
    bad = {k: (scraped.get(k), v) for k, v in want.items() if scraped.get(k) != v}
    check(not bad, f"serve: the scrape does not reconcile with the requests sent: {bad}")
    dispatch = {k: v for k, v in scraped.items() if k.startswith("kernels_dispatch")}
    print(f"  scrape: {want}; kernels.dispatch: {dispatch}")
    for op in ("sketch_fused", "hd_precondition", "sparse_assign", "spmm", "spmm_t"):
        check(scraped.get(f'kernels_dispatch{{op="{op}",path="kernel"}}', 0) > 0,
              f'serve: no kernels.dispatch{{op="{op}",path="kernel"}} series')
    check(not any('path="ref"' in k for k in dispatch),
          f"serve: a plain version ran on the card: {dispatch}")

    direct = {}
    for g in groups:
        cons = [ESTIMATORS[kind](plan=plans[g], key=keys[g], device=dev, **params)
                for _, kind, params in tenants[g]]
        api.fit_many(plans[g], cons, rows[g])
        for (tid, kind, _), c in zip(tenants[g], cons):
            if kind == "mean":
                direct[tid] = c.mean_.cpu().numpy()
            elif kind == "pca":
                direct[tid] = c.components_.cpu().numpy()
                direct[f"{tid}/ev"] = c.explained_variance_.cpu().numpy()
            else:
                direct[tid] = c.centers_.cpu().numpy()
                direct[f"{tid}/predict"] = c.predict(x_pred).cpu().numpy()
        if g == "lr1":      # K5 and K6 on the group's first chunk, its Ω and its shapes
            pca = cons[[kind for _, kind, _ in tenants[g]].index("pca")]
            s0 = sketch_mod.sketch(rows[g][:BATCH], pca.spec_,
                                   batch_key=sketch_mod.batch_key(pca.spec_, 0, 0))
            om = pca._reducer._omega
            t_k = ops.spmm(s0.values, s0.indices, om)
            y_k = ops.spmm_t(s0.values, s0.indices, t_k, P, col_sums=True)   # as range_delta
            torch.cuda.synchronize()
            t_p = ref.ref_spmm(s0.values, s0.indices, om)
            y_p = ref.ref_spmm_t(s0.values, s0.indices, t_k, P, col_sums=True)
            errs = []
            for what, got, want in [("K5 spmm", t_k, t_p)] + list(zip(
                    ("K6 spmm_t Y", "K6 Σv", "K6 Σv²"), y_k, y_p)):
                err, tol = (got - want).abs().max().item(), 1e-5 * want.abs().max().item()
                errs.append(f"{what} {err:.3g} (tol {tol:.3g})")
                check(err <= tol, f"serve: {what} at p={P} off its plain version: {err} > {tol}")
            print(f"  the lr1 group's first chunk ({s0.values.shape[0]} rows, m="
                  f"{s0.values.shape[1]}, p={P}, Ω {tuple(om.shape)}), kernels against their "
                  f"plain versions (1e-5 of max |plain|): {'; '.join(errs)}")
            del s0, om, t_k, y_k, t_p, y_p
        del cons
    off = differ(ans4, direct)
    print(f"  served against fit_many over the same rows, plans and keys: "
          f"{len(ans4) - len(off)} of {len(ans4)} answers bit-identical")
    check(not off, f"serve: answers differ from fit_many: {off}")
    del svc4
    torch.cuda.empty_cache()

    # 3-4: 1 worker, a snapshot after 2 of 4 requests a group, restore and continue
    snap = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        half = [(g, r) for g, r in order if r < n_req // 2]
        rest = [(g, r) for g, r in order if r >= n_req // 2]
        svc1 = SketchService(workers=1, device="cuda")
        with svc1:
            create(svc1)
            t_half1 = ingest(svc1, half)
            t0 = time.perf_counter()
            svc1.snapshot(snap)
            t_write = time.perf_counter() - t0
            t_rest1 = ingest(svc1, rest)
            ans1 = answers(svc1)
        del svc1
        torch.cuda.empty_cache()
        off = differ(ans1, ans4)
        check(not off, f"serve: 1 worker differs from 4 workers in {off}")
        step_dir = ckpt_mod.latest_step_dir(snap)
        snap_bytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
        t0 = time.perf_counter()
        svc_r = restore_service(snap, workers=4, device="cuda")
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        with svc_r:
            t_rest4 = ingest(svc_r, rest)
            ans_r = answers(svc_r)
        del svc_r
        off = differ(ans_r, ans4)
        check(not off, f"serve: the restored service differs from the uninterrupted one in {off}")
    finally:
        shutil.rmtree(snap, ignore_errors=True)
    torch.cuda.empty_cache()
    n_half = len(groups) * GROUP_ROWS // 2
    print(f"  1 worker: {len(groups) * GROUP_ROWS / (t_half1 + t_rest1):.0f} rows/s (two bursts "
          f"of {len(half)} requests, the snapshot between: {t_half1:.3f} + {t_rest1:.3f} s); "
          f"every answer bit-identical to 4 workers'; the second burst through the restored "
          f"4-worker service {t_rest4:.3f} s ({n_half / t_rest4:.0f} rows/s against 1 worker's "
          f"{n_half / t_rest1:.0f})")
    print(f"  snapshot after {n_req // 2} of {n_req} requests a group: {snap_bytes} bytes, "
          f"written in {t_write:.3f} s, restored in {t_restore:.3f} s; the restored service, "
          f"continued, bit-identical to the uninterrupted one")

    # 5: HTTP, 256-row requests of integer-valued rows (short JSON), and the cap
    hsvc = SketchService(device="cuda", max_pending_rows=HTTP_ROWS)
    plan_h = api.Plan(backend="stream", gamma=GAMMA, batch_size=HTTP_ROWS)
    xh = torch.round(planted(2 * HTTP_ROWS) * 8)
    xh_np = xh.cpu().numpy()
    t0 = time.perf_counter()
    with hsvc:
        fe = serve_http(hsvc)
        try:
            code, body, _ = _http(fe.url + "/admin", {"op": "create_tenant", "params": {
                "tid": "h", "kind": "mean", "key": 5, "plan": plan_to_json(plan_h)}})
            check(code == 200, f"serve: HTTP create_tenant answered {code}: {body}")
            for i in range(2):
                code, body, _ = _http(fe.url + "/ingest", {
                    "target": "h", "rows": xh_np[i * HTTP_ROWS:(i + 1) * HTTP_ROWS].tolist()})
                check(code == 200, f"serve: HTTP ingest answered {code}: {body.get('error')}")
            code, body, _ = _http(fe.url + "/query?tenant=h&op=mean")
            check(code == 200, f"serve: HTTP query answered {code}")
            got = np.asarray(body["result"], np.float32)
            in_proc = hsvc.query("h", "mean", timeout=TIMEOUT_S).unwrap()
            code429, body, hdrs = _http(fe.url + "/ingest", {
                "target": "h", "rows": xh_np[:HTTP_ROWS + 1].tolist()})
        finally:
            fe.close()
    t_http = time.perf_counter() - t0
    want_h = api.SparsifiedMean(plan_h, key=5, device=dev).fit(xh).mean_.cpu().numpy()
    check(np.array_equal(got, in_proc) and np.array_equal(got, want_h),
          "serve: the HTTP answer differs from the in-process one")
    check(code429 == 429 and body["status"] == "rejected" and "Retry-After" in hdrs,
          f"serve: {HTTP_ROWS + 1} rows past a cap of {HTTP_ROWS} answered {code429}, {hdrs}")
    print(f"  HTTP: 2 requests of {HTTP_ROWS} rows and a query equal to the in-process answer "
          f"and to a direct fit; {HTTP_ROWS + 1} rows past the cap: 429, Retry-After "
          f"{hdrs['Retry-After']}; {t_http:.2f} s (JSON of {HTTP_ROWS}×{P} rows)")

    # 7: phase 5's engine with and without telemetry, over the same batches
    memo = _Memo(VectorStreamSource(p=P, batch=BATCH, seed=0))

    def engine5():
        return api.make_engine(plan_d, P, prng.PRNGKey(1), memo,
                               kmeans=StreamKMeansConfig(k=K, n_init=N_INIT), device=dev)

    treg = obs.MetricsRegistry()
    eng_t = engine5()
    t0 = time.perf_counter()
    res_t = eng_t.run(TEL_STEPS, telemetry=EngineTelemetry(registry=treg))
    torch.cuda.synchronize()
    t_tel = time.perf_counter() - t0
    eng_p = engine5()
    res_p = eng_p.run(TEL_STEPS)          # the same batches, from the cache
    torch.cuda.synchronize()
    diff = same_bits(eng_t.state, eng_p.state) + [
        f for f in ("mean", "cov", "centers", "kmeans_obj")
        if not torch.equal(getattr(res_t, f), getattr(res_p, f))]
    check(not diff, f"serve: telemetry changed the fold: {diff}")
    totals = obs.span_totals(treg)
    # the instrumentation's own host cost a step: three spans and the records
    probe = obs.MetricsRegistry()
    t0 = time.perf_counter()
    for _ in range(1000):
        with obs.span("engine.source", probe):
            pass
        with obs.span("engine.update", probe):
            pass
    t_span = (time.perf_counter() - t0) / 2000
    # what runs with telemetry off too: the dispatch tally and record_function
    # with no profiler, each priced against the dispatches of one step
    obs.set_default_registry(probe)
    t0 = time.perf_counter()
    for _ in range(10000):
        ops._count_dispatch("spmm", "kernel")
    t_count = (time.perf_counter() - t0) / 10000
    obs.set_default_registry(reg)
    t0 = time.perf_counter()
    for _ in range(10000):
        with torch.profiler.record_function("obs.fold"):
            pass
    t_rf = (time.perf_counter() - t0) / 10000
    # one more step: its device time by CUDA events, and a profiler capture
    x = eng_p.host_global_batch(None, TEL_STEPS)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    n_disp = sum(ops.DISPATCH.values())
    torch.cuda.synchronize()
    ev0.record()
    eng_p.update(eng_p.state, x, TEL_STEPS)
    ev1.record()
    torch.cuda.synchronize()
    n_disp = sum(ops.DISPATCH.values()) - n_disp
    always = n_disp * t_count + 2 * eng_p.n_shards * t_rf + 2 * t_span
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng_t.run(TEL_STEPS + 1, state=eng_t.state, start_step=TEL_STEPS,
                  telemetry=EngineTelemetry(registry=obs.MetricsRegistry()))
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    spans = ("engine.source", "engine.update", "obs.sketch", "obs.fold")
    src_s, upd_s = totals["engine.source"], totals["engine.update"]
    print(f"  engine, {TEL_STEPS} steps of phase 5 with EngineTelemetry: {t_tel:.2f} s, state "
          f"bit-identical to the run without it; spans: engine.source {src_s['total_s']:.3f} s "
          f"(p50 {src_s['p50'] * 1e3:.1f} ms a step), engine.update {upd_s['total_s']:.3f} s "
          f"(p50 {upd_s['p50'] * 1e3:.1f} ms, host enqueue); the update's device time "
          f"{ev0.elapsed_time(ev1):.1f} ms (CUDA events); host share of the spans "
          f"{src_s['total_s'] / (src_s['total_s'] + upd_s['total_s']):.3f}")
    print(f"  telemetry's cost: {t_span * 1e6:.1f} µs a span (record_function and NVTX), "
          f"{treg.histogram('engine.step_seconds').count} steps recorded; profiler names found "
          f"{sorted(n for n in spans if n in names)}")
    print(f"  always on, telemetry or not: {t_count * 1e6:.2f} µs a dispatch tally, "
          f"{t_rf * 1e6:.2f} µs a record_function with no profiler; a step's {n_disp} "
          f"dispatches, {2 * eng_p.n_shards} record_functions and 2 spans: {always * 1e6:.1f} µs "
          f"of host time against the update's {ev0.elapsed_time(ev1):.1f} ms on the card")
    check(all(n in names for n in spans), f"serve: span names missing from the profile: {spans}")
    del eng_t, eng_p, res_t, res_p, x, memo

    # 8: the launcher, crashed and resumed under --supervise, against an uninterrupted run
    tmp = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    env = dict(os.environ, PYTHONPATH=SRC)
    base = [sys.executable, "-m", "repro_torch.launch.sketch_serve", "--device", "cuda",
            "--tenants", "12", "--groups", "4", "--requests", "96", "--p", "64"]
    procs = []
    try:
        t0 = time.perf_counter()
        for extra in (["--supervise", "--crash-after", "40", "--snapshot",
                       os.path.join(tmp, "snap"), "--snapshot-every-rows", "256",
                       "--out", os.path.join(tmp, "a.json")],
                      ["--out", os.path.join(tmp, "b.json")]):
            procs.append(subprocess.Popen(base + extra, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True, env=env,
                                          cwd=ROOT, start_new_session=True))
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
        t_launch = time.perf_counter() - t0
        for p, out in zip(procs, outs):
            check(p.returncode == 0, f"serve: the launcher exited {p.returncode}:\n{out[-2000:]}")
        check("workload completed after 1 restart(s)" in outs[0],
              f"serve: the supervised launcher did not crash and resume once:\n{outs[0][-2000:]}")
        with open(os.path.join(tmp, "a.json")) as fa, open(os.path.join(tmp, "b.json")) as fb:
            check(fa.read() == fb.read(), "serve: the resumed launcher's --out differs")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  launcher: --supervise --crash-after 40 (one crash, one resume) and an "
          f"uninterrupted run, side by side in {t_launch:.1f} s: --out files equal")
    obs.set_default_registry(prev_reg)
    print(f"  phase 11: {time.perf_counter() - t11:.1f} s, peak memory "
          f"{(torch.cuda.max_memory_allocated() - base11) / 2**30:.2f} GiB above the "
          f"{base11 / 2**30:.2f} GiB that earlier phases still held; {card}")
    return launches11


def phase12_sharded(card: str, x8) -> dict[str, int]:
    """Phase 12 (module docstring): the sharded backend on the card. Returns
    the kernels' launches on its paths (12(a)'s sharded engine run and
    12(c)'s low-rank sharded run), each read just after its reset."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api, cluster
    from repro_torch.core import sketch as sketch_mod
    from repro_torch.data.pipeline import VectorStreamSource
    from repro_torch.kernels import ops, ref
    from repro_torch.stream import StreamKMeansConfig
    from repro_torch.stream.sharded import psum, psum_bytes

    dev = torch.device("cuda")
    t12 = time.perf_counter()
    plan = api.Plan(backend="stream", gamma=GAMMA, batch_size=B12, n_shards=2)
    km = StreamKMeansConfig(k=K, n_init=N_INIT, track_reassignments=True)
    src = _Memo(VectorStreamSource(p=P, batch=B12, seed=0))
    rows12 = STEPS12 * 2 * B12
    print(f"== 12 sharded: Plan(backend='sharded', n_shards=2, batch_size={B12}), p={P}, "
          f"gamma={GAMMA}, {STEPS12} steps, K-means K={K}, r={N_INIT} with reassignments", flush=True)
    torch.cuda.empty_cache()
    base12 = torch.cuda.memory_allocated()

    # (a) one process in a one-rank NCCL group
    cluster.initialize(num_processes=1, backend="nccl", device="cuda")
    import torch.distributed as dist
    check(dist.get_backend() == "nccl" and cluster.process_count() == 1,
          "sharded: the one-rank NCCL group did not come up")
    t0 = time.perf_counter()
    psum(torch.ones(4, device=dev), cluster.process_mesh(2))     # NCCL's communicator
    torch.cuda.synchronize()
    t_comm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for step in range(STEPS12):
        for shard in range(2):
            src.batch_at(step, shard)
    t_src = time.perf_counter() - t0
    stream = api.make_engine(plan, P, 1, src, kmeans=km)
    res_s = stream.run(STEPS12)
    torch.cuda.synchronize()

    def sharded_run():
        eng = api.make_engine(plan.replace(backend="sharded"), P, 1, src, kmeans=km)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run(STEPS12)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return eng, res, ops.launch_counts(), dt, torch.cuda.max_memory_allocated()

    eng_a, res_a, launches_a, t_a, peak_a = sharded_run()
    check(eng_a.mesh.collective and eng_a._local == [0, 1], f"sharded: mesh {eng_a.mesh}")
    print(f"  (a) one process, NCCL group of world size 1 (its communicator set up in "
          f"{t_comm:.2f} s): {STEPS12} steps in {t_a:.2f} s ({rows12 / t_a:,.0f} rows/s at 1 rank, "
          f"the batches generated beforehand in {t_src:.1f} s), peak memory "
          f"{(peak_a - base12) / 2**30:.3f} GiB above the {base12 / 2**30:.2f} GiB earlier phases "
          f"hold; {card}")
    for name in ("sketch_fused", "hd_precondition", "sparse_assign", "spmm_t"):
        check(launches_a[name] > 0, f"sharded: {name} did not launch on the sharded run: {launches_a}")
    tr = lambda r: float(r.cov.double().trace())   # noqa: E731
    d_mean = (res_a.mean - res_s.mean).abs().max().item()
    d_cent = (res_a.centers - res_s.centers).abs().max().item()
    d_tr = abs(tr(res_a) - tr(res_s)) / abs(tr(res_s))
    same_a = same_bits(eng_a.state, stream.state)
    print(f"    against backend='stream': mean {d_mean:.3g}, centers {d_cent:.3g} (≤ 1e-5), cov "
          f"trace {d_tr:.3g} relative (≤ 1e-5), count {int(res_a.count)} = {int(res_s.count)}, "
          f"reassignments {res_a.reassign_total.tolist()} = {res_s.reassign_total.tolist()}; "
          f"fields not bit-equal to stream: {same_a}")
    check(d_mean <= 1e-5 and d_cent <= 1e-5 and d_tr <= 1e-5, "sharded: (a) off the stream run")
    check(int(res_a.count) == int(res_s.count) == rows12, "sharded: (a) count")
    check(np.array_equal(res_a.reassign_counts, res_s.reassign_counts), "sharded: (a) reassignments")
    eng_b, res_b, _, t_b, _ = sharded_run()
    rerun = same_bits(eng_a.state, eng_b.state)
    print(f"    a second sharded run: {t_b:.2f} s, fields that differ in any bit {rerun}")
    check(not rerun, f"sharded: a rerun is not bit-equal: {rerun}")
    # one more step of the second engine under the profiler: its spans and NCCL
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng_b.update(eng_b.state, eng_b.host_global_batch(None, 0), 0)
        torch.cuda.synchronize()
    events = prof.key_averages()
    nccl_dev = sorted({e.key for e in events if e.device_type == DeviceType.CUDA
                       and "nccl" in e.key.lower()})
    nccl_host = sorted({e.key for e in events if e.device_type == DeviceType.CPU
                        and "nccl" in e.key.lower()})
    psum_spans = sum(e.count for e in events if e.key == "obs.psum"
                     and e.device_type == DeviceType.CPU)
    print(f"    one step under torch.profiler: obs.psum spans {psum_spans}; NCCL on the host "
          f"{nccl_host}; NCCL kernels on the device {nccl_dev} (NCCL leaves a one-rank in-place "
          f"sum to the buffer it is given)")
    check(psum_spans == 2, f"sharded: {psum_spans} obs.psum spans in one tracked step")
    check(bool(nccl_host), "sharded: the profiler saw no NCCL all-reduce call")
    del eng_b, res_b, stream, prof, events

    # the all-reduce of one step's delta: (p, p) + (p,) floats and the K-means
    # sums, counts, objective and rows; the kernels of the path held against
    # their plain versions on the step's first shard
    x0 = torch.from_numpy(src.batch_at(0, 0)).to(dev)
    spec = eng_a.spec
    bk = sketch_mod.batch_key(spec, 0, 0)
    s_k = sketch_mod.sketch(x0, spec, batch_key=bk)
    s_r = sketch_mod.sketch(x0, spec, batch_key=bk, impl="ref")
    err_k1 = (s_k.values - s_r.values).abs().max().item()
    centers = eng_a.state.kmeans.centers
    d_k, a_k = ops.sparse_assign(s_k.values, s_k.indices, centers, mode="kernel")
    d_r, a_r = ops.sparse_assign(s_k.values, s_k.indices, centers, mode="ref")
    err_k4 = ((d_k - d_r).abs() / d_r.abs().clamp(min=1.0)).max().item()
    top2 = torch.topk(d_r, 2, dim=2, largest=False).values
    clear = (top2[..., 1] - top2[..., 0]) > 1e-5 * top2[..., 0].abs().clamp(min=1.0)
    sums_k, cnts_k = ops.cluster_sums(s_k.values, s_k.indices, a_k, K, P, mode="kernel")
    sums_r, cnts_r = ops.cluster_sums(s_k.values, s_k.indices, a_k, K, P, mode="ref")
    err_k6 = (sums_k - sums_r).abs().max().item() / max(sums_r.abs().max().item(), 1e-30)
    print(f"    held against their plain versions at ({B12}, {P}), m={spec.m}, r={N_INIT}, K={K}: "
          f"K1 {err_k1:.3g} (bit-equal), K4 distances {err_k4:.3g} relative (≤ 1e-5, labels "
          f"equal where the top two differ), K6 sums {err_k6:.3g} of max (≤ 1e-5), counts equal")
    check(err_k1 == 0.0, "sharded: K1 off its plain version")
    check(err_k4 <= 1e-5 and torch.equal(a_k[clear], a_r[clear]), "sharded: K4 off its plain version")
    check(err_k6 <= 1e-5 and torch.equal(cnts_k, cnts_r), "sharded: K6 off its plain version")
    delta, _ = eng_a._deltas(eng_a.state, s_k)
    nbytes = psum_bytes(delta)
    ar_ms = time_ms(lambda: psum(delta, eng_a.mesh), 5)
    print(f"    all-reduce of a step's delta: {nbytes:,} bytes ((p, p) + (p,) floats "
          f"{4 * (P * P + P):,}, the K-means sums, counts as 2 limbs, objective, rows), "
          f"{ar_ms:.3f} ms a step by CUDA events over NCCL at world size 1; {card}")
    del delta, s_k, s_r, d_k, d_r, sums_k, sums_r, x0

    # (c) continue_elastic from 2 workers to 1, against (a)'s run
    eng_e = api.make_engine(plan.replace(backend="sharded"), P, 1, src, kmeans=km)
    eng_e.run(STEPS12 // 2)
    cluster.continue_elastic(eng_e, STEPS12, state=eng_e.state, start_step=STEPS12 // 2,
                             n_workers=1)
    elastic = [f for f in same_bits(eng_e.state, eng_a.state) if not f.startswith("reassign")]
    print(f"  (c) continue_elastic 2 → 1 workers after {STEPS12 // 2} steps: fields not bit-equal "
          f"to the uninterrupted run {elastic}")
    check(not elastic, f"sharded: the elastic continuation differs: {elastic}")
    ref_a = {"mean": res_a.mean.cpu().numpy(), "centers": res_a.centers.cpu().numpy(),
             "trace": tr(res_a), "diag": res_a.cov.diagonal().cpu().numpy(),
             "count": int(res_a.count), "reassign": res_a.reassign_total.copy()}
    del eng_a, res_a, res_s, eng_e
    src.cache.clear()
    torch.cuda.empty_cache()

    # (c) the sharded low-rank path at p = 65536, l = 128, STEPS12_LR steps, at one rank
    lr_plan = api.Plan(backend="stream", gamma=GAMMA, batch_size=B12_LR, n_shards=2,
                       cov_path="lowrank", rank=ELL)
    src_lr = _Memo(VectorStreamSource(p=P_LR, batch=B12_LR, seed=0))
    st_lr = api.make_engine(lr_plan, P_LR, 1, src_lr)
    st_lr.run(STEPS12_LR)
    eng_lr = api.make_engine(lr_plan.replace(backend="sharded"), P_LR, 1, src_lr)
    ops.reset_counts()
    res_lr = eng_lr.run(STEPS12_LR)
    comps, _ = res_lr.cov_lowrank.top(PCA_K)
    sketch_mod.unmix_dense(comps, eng_lr.spec)
    torch.cuda.synchronize()
    launches_c = ops.launch_counts()
    errs = {f: (getattr(eng_lr.state.lowrank, f) - getattr(st_lr.state.lowrank, f)).abs().max().item()
            / max(getattr(st_lr.state.lowrank, f).abs().max().item(), 1e-30)
            for f in ("y", "diag", "sum_w")}
    print(f"  (c) low-rank, p={P_LR}, l={ELL}, {STEPS12_LR} steps of 2 × {B12_LR} rows: RangeState "
          f"against the stream engine's, of max |value|: {errs} (≤ 1e-5); launches {launches_c}")
    check(all(v <= 1e-5 for v in errs.values()), f"sharded: the low-rank state is off: {errs}")
    check(int(eng_lr.state.lowrank.count) == int(st_lr.state.lowrank.count), "sharded: low-rank count")
    for name in ("sketch_fused_cluster", "hd_precondition_chunked", "spmm", "spmm_t"):
        check(launches_c[name] > 0, f"sharded: {name} did not launch on the low-rank run")
    x_lr = torch.from_numpy(src_lr.batch_at(0, 0)).to(dev)
    bk = sketch_mod.batch_key(eng_lr.spec, 0, 0)
    s_k = sketch_mod.sketch(x_lr, eng_lr.spec, batch_key=bk)
    s_r = sketch_mod.sketch(x_lr, eng_lr.spec, batch_key=bk, impl="ref")
    err_c = (s_k.values - s_r.values).abs().max().item()
    om = eng_lr._omega
    t_k, t_r = ops.spmm(s_k.values, s_k.indices, om, mode="kernel"), ops.spmm(s_k.values, s_k.indices, om, mode="ref")
    y_k, y_r = (ops.spmm_t(s_k.values, s_k.indices, t_r, P_LR, mode=m_) for m_ in ("kernel", "ref"))
    err_k5 = (t_k - t_r).abs().max().item() / t_r.abs().max().item()
    err_y = (y_k - y_r).abs().max().item() / y_r.abs().max().item()
    print(f"    held against their plain versions at ({B12_LR}, {P_LR}), m={eng_lr.spec.m}, l={ELL}: "
          f"the cluster sketch {err_c:.3g} (bit-equal), K5 {err_k5:.3g}, K6 {err_y:.3g} of max (≤ 1e-5)")
    check(err_c == 0.0 and err_k5 <= 1e-5 and err_y <= 1e-5, "sharded: a low-rank kernel is off")
    del st_lr, eng_lr, res_lr, comps, x_lr, s_k, s_r, t_k, t_r, y_k, y_r, src_lr
    torch.cuda.empty_cache()

    # (c) fit_many on phase 8's rows, sharded against stream
    plan8 = api.Plan(backend="stream", gamma=GAMMA, batch_size=BATCH, n_shards=2)
    fits = {}
    for backend in ("stream", "sharded"):
        pl = plan8.replace(backend=backend)
        cons = [api.SparsifiedCov(pl, key=1), api.SparsifiedKMeans(K, pl, key=1, algorithm="minibatch")]
        t0 = time.perf_counter()
        api.fit_many(pl, cons, x8)
        torch.cuda.synchronize()
        fits[backend] = (cons, time.perf_counter() - t0)
    (cs, ks), t_st = fits["stream"]
    (ch, kh), t_sh = fits["sharded"]
    d_cov = ((ch.cov_.double().trace() - cs.cov_.double().trace()).abs() / cs.cov_.double().trace().abs()).item()
    d_mean = (ch.mean_ - cs.mean_).abs().max().item()
    d_cent = (kh.centers_ - ks.centers_).abs().max().item()
    print(f"  (c) fit_many([SparsifiedCov, SparsifiedKMeans({K}, minibatch)]) on phase 8's {x8.shape[0]:,} "
          f"rows, n_shards=2: sharded {t_sh:.2f} s, stream {t_st:.2f} s; mean {d_mean:.3g}, centers "
          f"{d_cent:.3g} (≤ 1e-5), cov trace {d_cov:.3g} relative (≤ 1e-5), counts {ch.count_} = "
          f"{cs.count_}, reassignments equal {np.array_equal(kh.reassign_counts_, ks.reassign_counts_)}")
    check(d_mean <= 1e-5 and d_cent <= 1e-5 and d_cov <= 1e-5 and ch.count_ == cs.count_,
          "sharded: fit_many off the stream backend")
    check(np.array_equal(kh.reassign_counts_, ks.reassign_counts_), "sharded: fit_many reassignments")
    del fits, cs, ks, ch, kh
    torch.cuda.empty_cache()
    cluster.shutdown()

    # (b) two processes on the one card over gloo, through the launcher
    tmp = tempfile.mkdtemp(prefix="sharded12-")
    try:
        base = [sys.executable, "-m", "repro_torch.launch.cluster", "--nproc", "2", "--device", "cuda",
                "--dist-backend", "gloo", "--p", str(P), "--gamma", str(GAMMA), "--batch", str(B12),
                "--shards", "2", "--kmeans-k", str(K), "--track-reassignments"]
        env = dict(os.environ, PYTHONPATH=SRC)

        def launch(*runs):
            """Launcher runs side by side (4 ranks share the card); their
            stdouts and the wall time."""
            t0 = time.perf_counter()
            procs = [subprocess.Popen(base + list(extra), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
                     for extra in runs]
            outs = [p.communicate(timeout=600) for p in procs]
            for p, (o, e) in zip(procs, outs):
                check(p.returncode == 0, f"sharded: the launcher exited {p.returncode}:\n"
                                         f"{o[-2000:]}\n{e[-3000:]}")
            return [o for o, _ in outs], time.perf_counter() - t0

        ck = os.path.join(tmp, "ck")
        (out_full, _), t_first = launch(
            ["--steps", str(STEPS12), "--out", os.path.join(tmp, "full.npz"), "--log-every",
             str(STEPS12 // 2), "--time-allreduce", "2"],
            ["--steps", str(STEPS12 // 2), "--ckpt-dir", ck, "--ckpt-every", str(STEPS12 // 2)])
        _, t_res = launch(["--steps", str(STEPS12), "--ckpt-dir", ck, "--resume",
                           "--out", os.path.join(tmp, "resumed.npz")])
        for line in out_full.splitlines():
            if line.startswith(("dist backend", "rank ", "allreduce", "total rows", "heartbeat")):
                print(f"    {line}; {card}")
        check("dist backend: gloo, world 2, device cuda" in out_full, "sharded: (b) not 2 gloo ranks")
        check("heartbeat: hosts=2" in out_full, "sharded: (b) --log-every did not show cluster.hosts == 2")
        for rank in (0, 1):
            found = re.search(rf"rank {rank}: folded [^\n]*?launches (\{{[^}}]*\}})", out_full)
            check(found is not None, f"sharded: rank {rank} printed no launch counts")
            counts = json.loads(found.group(1))
            for name in ("sketch_fused", "sparse_assign", "spmm_t"):
                check(counts[name] > 0, f"sharded: {name} did not launch on rank {rank}")
        full = np.load(os.path.join(tmp, "full.npz"))
        resumed = np.load(os.path.join(tmp, "resumed.npz"))
        d_mean = float(np.abs(full["mean"] - ref_a["mean"]).max())
        d_cent = float(np.abs(full["centers"] - ref_a["centers"]).max())
        d_tr = abs(float(full["cov_trace"]) - ref_a["trace"]) / abs(ref_a["trace"])
        diag_same = np.array_equal(full["cov_diag"], ref_a["diag"])
        diff = [k for k in ("mean", "centers", "cov_diag", "cov_sha256", "count", "reassign_total")
                if not np.array_equal(full[k], resumed[k])]
        print(f"  (b) two processes on one card over gloo, the uninterrupted run and {STEPS12 // 2} "
              f"steps + checkpoint side by side {t_first:.1f} s, --resume to {STEPS12} {t_res:.1f} s "
              f"(process start and the source included); against (a): mean {d_mean:.3g}, centers "
              f"{d_cent:.3g}, cov trace {d_tr:.3g} relative, its diagonal bit-equal {diag_same}, "
              f"count {int(full['count'])}, reassignments {full['reassign_total'].tolist()}; fields "
              f"of the resumed run not bit-equal to the uninterrupted one {diff}; {card}")
        check(d_mean <= 1e-5 and d_cent <= 1e-5 and d_tr <= 1e-5, "sharded: (b) off (a)")
        check(int(full["count"]) == ref_a["count"] and np.array_equal(full["reassign_total"], ref_a["reassign"]),
              "sharded: (b) count or reassignments differ from (a)")
        check(not diff, f"sharded: the resumed two-process run differs: {diff}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches12 = {name: launches_a.get(name, 0) + launches_c.get(name, 0)
                  for name in set(launches_a) | set(launches_c)}
    print(f"  launches in phase 12: {launches12}")
    print(f"  phase 12: {time.perf_counter() - t12:.1f} s; {card}")
    return launches12


def params_match(got, want) -> tuple[int, int, float]:
    """(coordinates more than 1e-6 apart, all coordinates, the largest
    difference) of two parameter trees. Adam's first step divides a gradient
    entry near its ε by its own magnitude, so there an entry's last bits set
    an update of up to lr: the caller holds the count to 1e-4 of all and the
    largest difference to 2·lr."""
    from repro_torch.utils.tree import tree_leaves

    apart, total, worst = 0, 0, 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        d = (a.detach().float() - b.detach().to(a.device).float()).abs()
        apart += int((d > 1e-6).sum())
        total += d.numel()
        worst = max(worst, float(d.max()))
    return apart, total, worst


def train_parity() -> None:
    """Phase 4's trainer case: 3 compressed steps of a reduced gemma3-1b on
    the card (K2 twice a step) against the same steps on the CPU, from the
    CPU's weights: losses, grad_norm and lr within 1e-5 relative, the
    residual within 1e-5 of its largest entry, the parameters as
    :func:`params_match` counts them."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.grad_compress import CompressConfig
    from repro_torch.data.pipeline import SyntheticLMSource
    from repro_torch.kernels import ops
    from repro_torch.models.api import get_api
    from repro_torch.models.transformer import NO_DIST
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import TrainerConfig, init_state, make_train_fn
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_leaves, tree_map

    lm = get_api(get_arch("gemma3-1b", reduced=True))
    tcfg4 = TrainerConfig(opt=OptConfig(peak_lr=1e-3, warmup_steps=1, total_steps=3),
                          compress=CompressConfig(gamma=0.1), q_chunk=16, kv_chunk=16)
    w4 = lm.init_params(0, "cpu")
    batches4 = [SyntheticLMSource(lm.cfg.vocab_size, 64, 4, seed=0).batch_for(s) for s in range(3)]

    def small_train(device):
        st = init_state(lm, tcfg4, prng.PRNGKey(0), device=device)
        st["params"] = tree_map(lambda t: t.clone().to(device), w4)
        fn4 = make_train_fn(lm, tcfg4, NO_DIST, prng.PRNGKey(0), device=device)
        mets = []
        for b4 in batches4:
            st, met = fn4(st, b4)
            mets.append({k: float(v) for k, v in met.items()})
        return st, mets

    ops.reset_counts()
    (st_g, met_g), (st_c, met_c) = small_train("cuda"), small_train("cpu")
    counts = ops.launch_counts()
    apart, total, worst = params_match(st_g["params"], st_c["params"])
    res_err = max(float((a.cpu() - b).abs().max() / b.abs().max())
                  for a, b in zip(tree_leaves(st_g["residual"]), tree_leaves(st_c["residual"])))
    rel = {k: max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for a, b in zip(met_g, met_c))
           for k in ("loss", "grad_norm", "lr")}
    print(f"  trainer, gemma3-1b reduced, 3 steps with CompressConfig(gamma=0.1): losses card "
          f"{[m_['loss'] for m_ in met_g]} / cpu {[m_['loss'] for m_ in met_c]}; relative |card - cpu| "
          f"{rel} (≤ 1e-5); residual ≤ {res_err:.3g} of its largest (≤ 1e-5); parameters {apart} of "
          f"{total} more than 1e-6 apart (≤ 1e-4 of them), largest {worst:.3g} (≤ 2·lr); "
          f"launches {counts}")
    check(counts["hd_precondition"] == 6, f"K2 did not launch twice a step: {counts}")
    check(max(rel.values()) <= 1e-5 and res_err <= 1e-5 and apart <= 1e-4 * total
          and worst <= 2e-3, "the trainer on the card differs from the CPU's")
    check(all(a["wire_floats"] == b["wire_floats"] == 11 * 1638 for a, b in zip(met_g, met_c)),
          "wire_floats differ")
    del st_g, st_c, w4


def phase13_train(card: str) -> dict[str, int]:
    """Phase 13 (module docstring): gemma3-1b trained at full width on the
    card with sketched gradient compression. Returns the kernels' launches on
    the training run, read just after its reset."""
    t13 = time.perf_counter()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import grad_compress as gc
    from repro_torch.core import ros
    from repro_torch.core import sketch as sketch_mod
    from repro_torch.core.sampling import sample_indices
    from repro_torch.data.pipeline import SyntheticLMSource
    from repro_torch.kernels import ops, ref
    from repro_torch.models.api import get_api
    from repro_torch.models.transformer import NO_DIST
    from repro_torch.roofline import kernels as rk
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.trainer import TrainerConfig, init_state, make_train_fn
    from repro_torch.utils import prng
    from repro_torch.utils.host import from_host, to_host
    from repro_torch.utils.tree import (tree_count_params, tree_leaves, tree_leaves_with_path,
                                        tree_map, tree_size_bytes, tree_unflatten)

    cfg = dataclasses.replace(get_arch("gemma3-1b"), n_layers=DEPTH13)
    model = get_api(cfg)
    comp = gc.CompressConfig(gamma=0.1)
    cp, m = comp.chunk_p, comp.m
    tcfg = TrainerConfig(opt=opt_mod.OptConfig(peak_lr=LR13, warmup_steps=1, total_steps=STEPS13),
                         accum_steps=ACCUM13, compress=comp, q_chunk=Q13, kv_chunk=KV13)
    key = prng.PRNGKey(0)
    print(f"== 13 train: {cfg.name} at full width, {cfg.n_layers} of its 26 layers (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV head of {cfg.hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.local_global_ratio}:1 local/global, window "
          f"{cfg.sliding_window}), {cfg.dtype} parameters; CompressConfig(gamma={comp.gamma}): "
          f"chunk_p {cp}, m {m}, error feedback; AdamW, float32 moments, peak lr {LR13}; "
          f"SyntheticLMSource(seed=0), seq {SEQ13}, a global batch of {BATCH13} as {ACCUM13} "
          f"micro-batches; flash_attention chunks {Q13} × {KV13}; {STEPS13} steps", flush=True)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = init_state(model, tcfg, key, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n = tree_count_params(state["params"])
    nc = -(-n // cp)
    check(n == 765_016_704 and nc == 46_693,
          f"gemma3-1b at {DEPTH13} layers has {n:,} parameters, {nc:,} chunks")
    gib = lambda b: b / 2**30  # noqa: E731
    print(f"  state: {n:,} parameters, {nc:,} chunks of {cp}: params "
          f"{gib(tree_size_bytes(state['params'])):.2f} GiB, moments "
          f"{gib(tree_size_bytes(state['opt'])):.2f} GiB, residual "
          f"{gib(tree_size_bytes(state['residual'])):.2f} GiB; drawn on the card in {t_init:.2f} s")
    fn = make_train_fn(model, tcfg, NO_DIST, key, device="cuda")
    src = SyntheticLMSource(cfg.vocab_size, SEQ13, BATCH13, seed=0)
    batches = [src.batch_for(s) for s in range(STEPS13)]
    tokens = BATCH13 * SEQ13

    def run(st, steps, label):
        out = []
        for s in steps:
            k2 = ops.DISPATCH[("hd_precondition", "kernel")]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, met = fn(st, batches[s])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rec = dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                       lr=float(met["lr"]), wire=int(met["wire_floats"]), s=dt,
                       k2=ops.DISPATCH[("hd_precondition", "kernel")] - k2)
            out.append(rec)
            print(f"  {label} step {s}: loss {rec['loss']!r}, grad_norm {rec['grad_norm']:.4f}, lr "
                  f"{rec['lr']:.3g}, wire_floats {rec['wire']:,}, {dt:.3f} s ({tokens / dt:,.0f} "
                  f"tokens/s), K2 launches {rec['k2']}", flush=True)
        return st, out

    # the main path: steps 0 … CKPT13-1; a checkpoint of the state, written
    # by save's thread while steps CKPT13 … run on; the saved state is kept
    # on the host for the restore's check
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    state, recs = run(state, range(CKPT13), "run")
    peak_run = torch.cuda.max_memory_allocated()
    ckdir = tempfile.mkdtemp(prefix="phase13_")
    t0 = time.perf_counter()
    saved = tree_map(to_host, state)                    # numpy; bf16 leaves as |V2 words
    ckpt_mod.save(ckdir, CKPT13, saved, extra={"pipeline": {"seed": 0, "step": CKPT13}},
                  async_=True)
    t_host = time.perf_counter() - t0
    state, more = run(state, range(CKPT13, STEPS13), "run")
    recs += more
    torch.cuda.synchronize()
    peak_run = max(peak_run, torch.cuda.max_memory_allocated())
    launches13 = ops.launch_counts()
    dispatch = dict(ops.DISPATCH)

    losses = [r["loss"] for r in recs]
    step_s = [r["s"] for r in recs]
    print(f"  losses {losses}; step {np.median(step_s[1:]):.3f} s (median of steps 1-{STEPS13 - 1}; "
          f"step 0 {step_s[0]:.3f} s), {tokens / np.median(step_s[1:]):,.0f} tokens/s; peak memory "
          f"{gib(peak_run):.2f} GiB ({gib(base):.2f} GiB held before the phase); dispatch "
          f"{dispatch}; launches {launches13}", flush=True)
    check(all(math.isfinite(v) for v in losses), f"a loss is not finite: {losses}")
    check(np.mean(losses[-2:]) < losses[0],
          f"the loss did not fall: last two {losses[-2:]} against the first {losses[0]}")
    check(all(r["k2"] == 2 for r in recs) and dispatch.get(("hd_precondition", "kernel")) == 2 * STEPS13
          and launches13["hd_precondition"] == 2 * STEPS13,
          f"K2 did not launch twice a step on the kernel path: {dispatch}")
    check(not [k for k in dispatch if k[1] == "ref"], f"a plain version ran: {dispatch}")
    # the metric is a float32 scalar, as the reference's: nc × m rounded to float32
    check(all(r["wire"] == int(np.float32(nc * m)) for r in recs),
          f"wire_floats is not {nc} × {m} in float32")
    check(peak_run < PEAK13_GIB * 2**30, f"peak memory {gib(peak_run):.2f} GiB ≥ {PEAK13_GIB} GiB")

    # a step's parts at the final parameters, timed alone: one micro-batch's
    # forward+backward, then the compressor's parts on its gradient plus the
    # real residual
    params = state["params"]
    leaves = tree_leaves(params)
    flat = torch.zeros((nc * cp,), dtype=torch.float32, device="cuda")
    mb = BATCH13 // ACCUM13
    part = {k: v[:mb].cuda() for k, v in batches[STEPS13 - 1].items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    loss, _ = model.loss_fn(params, part, NO_DIST, q_chunk=tcfg.q_chunk, kv_chunk=tcfg.kv_chunk)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        off = 0
        for g in grads:
            flat[off:off + g.numel()].add_(g.reshape(-1))
            off += g.numel()
    ev[1].record()
    torch.cuda.synchronize()
    ms_fb = ev[0].elapsed_time(ev[1]) * ACCUM13
    del grads, loss
    # the same micro-batch's forward+backward under torch.profiler: its
    # kernels' device time against the wall time, and the largest kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, _ = model.loss_fn(params, part, NO_DIST, q_chunk=tcfg.q_chunk, kv_chunk=tcfg.kv_chunk)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        wall_mb = (time.perf_counter() - t0) * 1e3
    del grads, loss
    kern = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.self_device_time_total, reverse=True)
    busy_mb = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"  one micro-batch's forward+backward: {wall_mb:.0f} ms wall, kernels {busy_mb:.0f} ms "
          f"(device busy {busy_mb / wall_mb:.2f}), {sum(e.count for e in kern):,} launches; the "
          f"largest:", flush=True)
    for e in kern[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.1f} ms  {e.count:6d}x  {e.key[:90]}")
    with torch.no_grad():
        off = 0
        for r in tree_leaves(state["residual"]):
            flat[off:off + r.numel()].add_(r.reshape(-1))
            off += r.numel()
        v0 = flat.clone()                               # g + r
        x = flat.view(nc, cp)
        spec = gc.mask_spec(comp, prng.fold_in_str(key, "grad-compress"))
        signs = ros.signs_for(spec.signs_key(), cp, device="cuda")
        # K2 on the real chunks in both modes, against its plain version
        # (row blocks on the card), its time beside its bound and x @ (H·D)
        # each value read and written once; per value log2(p) butterfly
        # additions, the sign and the scale
        bound13 = rk.fwht_roofline(nc, cp)
        k2 = {}
        for after in (False, True):
            got = ops.hd_precondition(x, signs, signs_after=after)
            same = all(torch.equal(got[r0:r0 + 4096], ref.ref_hd_precondition(x[r0:r0 + 4096], signs,
                                                                              after))
                       for r0 in range(0, nc, 4096))
            check(same, f"K2 at ({nc}, {cp}) signs_after={after} is not bit-equal to its plain version")
            del got
            ms = time_ms(lambda: ops.hd_precondition(x, signs, signs_after=after), 3, warmup=1)
            plain = time_ms(lambda: [ref.ref_hd_precondition(x[r0:r0 + 4096], signs, after)
                                     for r0 in range(0, nc, 4096)], 1, warmup=0)
            k2[after] = ms
            print(f"  K2 hd_precondition ({nc:,}, {cp}) signs_after={after}: bit-equal to its plain "
                  f"version; {ms:.4f} ms, bound {bound13.ms:.4f} ms ({bound13.bound}; "
                  f"{bound13.ms / ms:.2f} of it), plain version {plain:.2f} ms", flush=True)
        prev_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        hmat = ros.hadamard_matrix(cp, device="cuda") * signs[None, :]          # H·D
        rows = x[:4096]
        lib = time_ms(lambda: torch.matmul(rows, hmat), 3) * nc / 4096
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
        del hmat, rows
        scaled = {arch: round(lib / nc * c, 2) for arch, c in CHUNKS15.items()}
        print(f"  x @ (H·D) on 4096 of the rows (TF32 off), scaled to {nc:,} (phase 16's shape "
              f"too): {lib:.2f} ms; to phase 15's: {scaled} ms", flush=True)
        # the step's mask: the row blocks against one-call draws on the CPU
        step = STEPS13
        mk = sketch_mod.batch_key(spec, step, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = sample_indices(mk, nc, cp, m, device="cuda")
        torch.cuda.synchronize()
        ms_mask = (time.perf_counter() - t0) * 1e3
        head = min(256, nc)
        cpu_head = sample_indices(mk, head, cp, m, device="cpu")
        check(torch.equal(idx[:head].cpu(), cpu_head), "the mask's first rows differ from the CPU's")
        edge_rows = [r for r in (2047, 2048, 4095, 4096) if r < nc] + [nc - 1]
        for r in edge_rows:
            u = prng.uniform(mk, (1, cp), offset=r * cp, total=nc * cp)
            want = torch.sort(torch.sort(u, dim=-1, descending=True, stable=True).indices[:, :m]
                              .to(torch.int32), dim=-1).values
            check(torch.equal(idx[r:r + 1].cpu(), want), f"mask row {r} differs from the CPU's")
        del idx
        print(f"  the mask ({nc:,} × {m}): sample_indices {ms_mask:.1f} ms (threefry and sort, in "
              f"row blocks); rows 0-{head - 1} and {edge_rows} bit-equal to the CPU's", flush=True)
        # the whole round trip (K2 ×2, the mask, gather and scatter), then
        # the error-feedback identity ĝ + r' = g + r
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g_hat, res_flat, wire = gc.compress_flat(flat, prng.fold_in_str(key, "grad-compress"), step,
                                                 comp)
        torch.cuda.synchronize()
        ms_comp = (time.perf_counter() - t0) * 1e3
        check(wire == nc * m, f"wire floats {wire}")
        err = float((g_hat[:n] + res_flat[:n] - v0[:n]).abs().max())
        scale = float(v0[:n].abs().max())
        print(f"  compress_flat: {ms_comp:.1f} ms (mask {ms_mask:.1f}, K2 {k2[False]:.2f} + "
              f"{k2[True]:.2f}, gather and scatter and the rest {ms_comp - ms_mask - k2[False] - k2[True]:.1f}); "
              f"max |ĝ + r' − (g + r)| {err:.3g} of max |g + r| {scale:.3g}", flush=True)
        check(err <= 1e-6 * scale, "the error-feedback identity ĝ + r' = g + r does not hold")
        del v0, res_flat, flat, x
        g_leaves, off = [], 0
        for p in leaves:
            g_leaves.append(g_hat[off:off + p.numel()].view(p.shape))
            off += p.numel()
        final_params = tree_map(lambda t: t.detach().to("cpu", copy=True), params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt_mod.adamw_update(tree_unflatten(params, g_leaves), params, state["opt"], tcfg.opt)
        torch.cuda.synchronize()
        ms_opt = (time.perf_counter() - t0) * 1e3
        del g_hat, g_leaves
    step_med = np.median(step_s[1:]) * 1e3
    print(f"  a step's parts, each timed alone: forward+backward of {ACCUM13} micro-batches "
          f"{ms_fb:.0f} ms ({ACCUM13} × one), compression {ms_comp:.0f} ms, optimizer {ms_opt:.0f} "
          f"ms; together {ms_fb + ms_comp + ms_opt:.0f} ms against the step's {step_med:.0f} ms",
          flush=True)

    # resume: the checkpoint restored to the host in the state's dtypes, held
    # against the saved state, then moved to the card as a fresh state
    t0 = time.perf_counter()
    ckpt_mod.wait_for_pending()
    t_wait = time.perf_counter() - t0
    npz = os.path.join(ckpt_mod.latest_step_dir(ckdir), "arrays.npz")
    ck_bytes = os.path.getsize(npz)
    t0 = time.perf_counter()
    restored, extra = ckpt_mod.restore(ckdir, state, device="cpu")
    t_restore = time.perf_counter() - t0
    shutil.rmtree(ckdir)
    del state, params, leaves, part
    torch.cuda.empty_cache()
    differ = [name for (name, a), (_, b) in zip(tree_leaves_with_path(restored),
                                                tree_leaves_with_path(saved))
              if not torch.equal(a, from_host(b))]
    del saved
    print(f"  checkpoint after step {CKPT13}: {ck_bytes:,} bytes; copied to the host in "
          f"{t_host:.2f} s, written by save's thread under steps {CKPT13}-{STEPS13 - 1} and the "
          f"parts above ({t_wait:.2f} s waited for it after them), restored to the host in "
          f"{t_restore:.2f} s; restored state bit-equal to the saved one: {not differ}", flush=True)
    check(not differ and extra == {"pipeline": {"seed": 0, "step": CKPT13}},
          f"the restored state differs from the saved one in {differ[:5]}")
    restored = tree_map(lambda t: t.cuda(), restored)
    restored, resumed = run(restored, range(CKPT13, STEPS13), "resumed")
    same_loss = [a["loss"] == b["loss"] for a, b in zip(resumed, recs[CKPT13:])]
    apart, total, worst = params_match(restored["params"], final_params)
    print(f"  resumed losses {[r['loss'] for r in resumed]} against {losses[CKPT13:]}: equal "
          f"{same_loss}; final parameters: {apart:,} of {total:,} more than 1e-6 apart (largest "
          f"{worst:.3g})", flush=True)
    check(all(same_loss) and apart == 0 and worst == 0,
          "the resumed run's losses or final parameters differ from the uninterrupted run's")
    del restored, final_params
    torch.cuda.empty_cache()
    print(f"  phase 13: {time.perf_counter() - t13:.1f} s; {card}", flush=True)
    return launches13


def serve_parity() -> None:
    """Phase 4's serving cases: a reduced gemma3-1b in float32 (windowed and
    global layers) prefilled with 24 tokens and decoded 8 steps on the card
    and on the CPU from the CPU's weights, every step's logits within 1e-5 of
    max |logit|; and one sample_indices draw in JAX's original threefry
    layout (4100 rows of p = 16384: three row blocks, pairs across the
    draw's halves), bit-equal to the CPU's rows at the blocks' edges."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.sampling import sample_indices
    from repro_torch.models.api import get_api
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_map

    lm = get_api(get_arch("gemma3-1b", reduced=True))
    w = lm.init_params(0, "cpu")
    toks = prng.randint(prng.PRNGKey(5), (2, 32), 0, lm.cfg.vocab_size)

    def run(device):
        params = tree_map(lambda t: t.to(device), w)
        logits, cache = lm.prefill_fn(params, {"tokens": toks[:, :24]}, q_chunk=8, kv_chunk=8,
                                      cache_dtype=torch.float32, device=device)
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 8)) for k, v in cache.items()}
        out = [logits]
        for t in range(8):
            logits, cache = lm.decode_fn(params, toks[:, 24 + t:25 + t], cache, 25 + t,
                                         device=device)
            out.append(logits)
        return torch.stack(out).cpu()

    got, want = run("cuda"), run("cpu")
    err = float((got - want).abs().max() / want.abs().max())
    print(f"  serving, gemma3-1b reduced in float32: prefill of 24 tokens and 8 decode steps, "
          f"|card - cpu| ≤ {err:.3g} of max |logit| (≤ 1e-5)")
    check(err <= 1e-5, "prefill or decode_step on the card differs from the CPU")
    n, p_, m_ = 4100, P, round(GAMMA * P)
    key = prng.fold_in(prng.PRNGKey(6), 3)
    with prng.threefry_partitionable(False):
        idx = sample_indices(key, n, p_, m_, device="cuda").cpu()
        rows = [(0, 8), (2044, 2052), (4092, 4100)]
        same = []
        for r0, r1 in rows:
            u = prng.uniform(key, (r1 - r0, p_), offset=r0 * p_, total=n * p_)
            top = torch.sort(u, dim=-1, descending=True, stable=True).indices[:, :m_]
            same.append(torch.equal(idx[r0:r1], torch.sort(top.to(torch.int32), dim=-1).values))
    print(f"  sample_indices in the original threefry layout, ({n}, {p_}, m = {m_}) on the card "
          f"in row blocks: rows {rows} bit-equal to the CPU's: {same}")
    check(all(same), "the original layout's mask on the card differs from the CPU's")


def family_parity() -> None:
    """Phase 4's cases of the ssm, hybrid and audio families: each reduced
    model in float32 on the card and on the CPU from the CPU's weights,
    every logit within 1e-5 of max |logit|: mamba2-1.3b prefilled with 24
    tokens (ssm_prefill's states) and decoded 8 steps; zamba2-1.2b decoding
    32 tokens one by one into a float32 state (the shared block at its 2
    sites); seamless-m4t-large-v2's cache over 24 frames and 8 decode steps."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import hybrid
    from repro_torch.models.api import get_api
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_map

    for arch in ("mamba2-1.3b", "zamba2-1.2b", "seamless-m4t-large-v2"):
        lm = get_api(get_arch(arch, reduced=True))
        cfg = lm.cfg
        w = lm.init_params(0, "cpu")
        toks = prng.randint(prng.PRNGKey(7), (2, 32), 0, cfg.vocab_size)
        frames = 0.1 * prng.normal(prng.PRNGKey(8), (2, 24, cfg.d_model))

        def run(device):
            params = tree_map(lambda t: t.to(device), w)
            out = []
            if cfg.family == "ssm":
                logits, state = lm.prefill_fn(params, {"tokens": toks[:, :24]}, device=device)
                out.append(logits)
                for t in range(8):
                    logits, state = lm.decode_fn(params, toks[:, 24 + t:25 + t], state, 25 + t,
                                                 device=device)
                    out.append(logits)
            elif cfg.family == "hybrid":
                state = hybrid.init_decode_state(cfg, 2, 32, torch.float32, device=device)
                for t in range(32):
                    logits, state = lm.decode_fn(params, toks[:, t:t + 1], state, t + 1,
                                                 device=device)
                    out.append(logits)
            else:
                _, cache = lm.prefill_fn(params, {"frames": frames}, max_len=8,
                                         cache_dtype=torch.float32, device=device)
                for t in range(8):
                    logits, cache = lm.decode_fn(params, toks[:, t:t + 1], cache, t + 1,
                                                 device=device)
                    out.append(logits)
            return torch.stack(out).cpu()

        got, want = run("cuda"), run("cpu")
        err = float((got - want).abs().max() / want.abs().max())
        print(f"  {arch} reduced in float32 ({cfg.family}): {got.shape[0]} steps' logits, |card - "
              f"cpu| ≤ {err:.3g} of max |logit| (≤ 1e-5)")
        check(err <= 1e-5, f"{arch}: serving on the card differs from the CPU")


def _dp_setup():
    """dp_parity's model, trainer config, weights and 3 global batches: a
    reduced gemma3-1b in float32 (weights from a seeded CPU generator),
    CompressConfig(gamma=0.1) with error feedback, 4 rows of 64 tokens a
    step, every mesh axis carrying data."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.grad_compress import CompressConfig
    from repro_torch.data.pipeline import SyntheticLMSource
    from repro_torch.models.api import get_api
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import TrainerConfig

    lm = get_api(get_arch("gemma3-1b", reduced=True))
    tcfg = TrainerConfig(opt=OptConfig(peak_lr=1e-3, warmup_steps=1, total_steps=3),
                         compress=CompressConfig(gamma=0.1), q_chunk=16, kv_chunk=16, dp_only=True)
    src = SyntheticLMSource(lm.cfg.vocab_size, 64, 4, seed=0)
    return lm, tcfg, lm.init_params(0, "cpu"), [src.batch_for(s) for s in range(3)]


def _dp_start(lm, tcfg, weights) -> dict:
    """dp_parity's initial state on the card: ``weights`` and zero moments."""
    from repro_torch.train.trainer import init_state
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_map

    st = init_state(lm, tcfg, prng.PRNGKey(0), device="cuda")
    st["params"] = tree_map(lambda t: t.clone().to("cuda"), weights)
    return st


# dp_parity's per-worker estimate: a vector of P_PW values a rank (padded to
# whole chunks of PW_CHUNK), its key's seed and step
P_PW, PW_CHUNK, PW_STEP = 200_000, 1 << 14, 5


def _dp_worker(argv) -> None:
    """``python3 chip_smoke.py --dp-worker --coordinator HOST:PORT --out DIR
    --process-id R``: rank R of dp_parity's two gloo ranks on the card. It
    runs the data-parallel trainer over make_host_mesh(1, 2) and the
    per-worker estimate of its row of a seeded (2, P_PW) matrix, and writes
    what it got to DIR/rank{R}.pt."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dp-worker", action="store_true")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--process-id", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, SRC)
    import torch

    from repro_torch import cluster
    from repro_torch.cluster.bootstrap import make_mesh
    from repro_torch.core import grad_compress as gc
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.trainer import make_dist, make_train_fn
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_map

    cluster.initialize(args.coordinator, 2, args.process_id, backend="gloo", device="cuda")
    lm, tcfg, weights, batches = _dp_setup()
    st = _dp_start(lm, tcfg, weights)
    fn = make_train_fn(lm, tcfg, make_dist(make_host_mesh(1, 2), lm.cfg, dp_only=True),
                       prng.PRNGKey(0), device="cuda")
    ops.reset_counts()
    steps = []
    for b in batches:
        st, met = fn(st, b)
        steps.append({"metrics": {k: float(v) for k, v in met.items()},
                      "state": tree_map(lambda t: t.detach().to("cpu", copy=True), st)})
    counts, dispatch = ops.launch_counts(), {f"{k[0]}/{k[1]}": v for k, v in ops.DISPATCH.items()}
    grads = np.random.default_rng(16).normal(size=(2, P_PW)).astype(np.float32)
    cfg = gc.CompressConfig(gamma=0.1, chunk_p=PW_CHUNK, error_feedback=False, mode="per-worker")
    est = gc.perworker_mean_estimate(torch.from_numpy(grads[args.process_id]).cuda(),
                                     prng.PRNGKey(3), PW_STEP, cfg, make_mesh((2,), ("data",)),
                                     ("data",))
    torch.save({"steps": steps, "counts": counts, "dispatch": dispatch, "est": est.cpu()},
               os.path.join(args.out, f"rank{args.process_id}.pt"))
    torch.distributed.barrier()
    cluster.shutdown()


def dp_parity() -> None:
    """Phase 4's data-parallel case: two gloo ranks on the one card
    (_dp_worker) train a reduced gemma3-1b for 3 compressed steps, each step
    held against one process's step on the same global batch from the
    ranks' state before it (their parameters and moments, their mean
    residual): loss and grad_norm within 1e-5 of their largest value, the
    ranks' mean residual after it within 1e-5 of the single process's
    largest entry; the ranks' parameters and moments bit-equal, K2 twice a
    step on each rank. (Runs left apart for 3 steps differ by more: Adam's
    first step moves a parameter whose gradient is near its ε by up to lr
    either way, as ``train_parity`` counts.) And perworker_mean_estimate on
    the 2 ranks against the single-process formula, within 1e-5 of max
    |value|."""
    import torch

    from repro_torch.cluster.bootstrap import free_port, run_ranks
    from repro_torch.core import grad_compress as gc
    from repro_torch.core import ros
    from repro_torch.core import sketch as sketch_mod
    from repro_torch.core.sampling import sample_indices
    from repro_torch.models.transformer import NO_DIST
    from repro_torch.train.trainer import make_train_fn
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path, tree_map

    tmp = tempfile.mkdtemp(prefix="dp4-")
    try:
        t0 = time.perf_counter()
        rc = run_ranks([sys.executable, os.path.abspath(__file__), "--dp-worker", "--coordinator",
                        f"127.0.0.1:{free_port()}", "--out", tmp], 2)
        t_ranks = time.perf_counter() - t0
        check(rc == 0, f"dp_parity: a rank exited {rc}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in (0, 1)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lm, tcfg, weights, batches = _dp_setup()
    fn = make_train_fn(lm, tcfg, NO_DIST, prng.PRNGKey(0), device="cuda")
    start, rel, res_err, same = _dp_start(lm, tcfg, weights), [], [], True
    for step, b in enumerate(batches):
        one, met = fn(start, b)
        dp = [r["steps"][step] for r in ranks]
        same &= dp[0]["metrics"] == dp[1]["metrics"] and all(
            torch.equal(x, y) for (n, x), (_, y) in zip(tree_leaves_with_path(dp[0]["state"]),
                                                        tree_leaves_with_path(dp[1]["state"]))
            if not n.startswith("['residual']"))
        rel.append({k: abs(dp[0]["metrics"][k] - float(met[k]))
                    / max(abs(dp[0]["metrics"][k]), abs(float(met[k])), 1e-30)
                    for k in ("loss", "grad_norm")})
        mean = tree_map(lambda a, c: (a + c) / 2, dp[0]["state"]["residual"],
                        dp[1]["state"]["residual"])
        res_err.append(max(float((a - c.cpu()).abs().max() / c.abs().max())
                           for a, c in zip(tree_leaves(mean), tree_leaves(one["residual"]))))
        start = tree_map(lambda t: t.to("cuda", copy=True), dict(dp[0]["state"], residual=mean))
    worst = max(max(r.values()) for r in rel)
    print(f"  data parallel, gemma3-1b reduced, 3 steps with CompressConfig(gamma=0.1) on 2 gloo "
          f"ranks of the card ({t_ranks:.1f} s with their start), each step against one process's "
          f"from the ranks' state: losses {[d['metrics']['loss'] for d in ranks[0]['steps']]}; "
          f"relative |2 ranks − 1| by step {rel} (≤ 1e-5); the ranks' mean residual by step "
          f"{[f'{e:.3g}' for e in res_err]} of its largest (≤ 1e-5); the ranks' parameters and "
          f"moments bit-equal {same}; K2 launches by rank "
          f"{[r['counts']['hd_precondition'] for r in ranks]}", flush=True)
    check(same, "dp_parity: the ranks differ")
    check(worst <= 1e-5 and max(res_err) <= 1e-5,
          "dp_parity: the 2 ranks differ from one process on the global batch")
    check(all(r["counts"]["hd_precondition"] == 6 and "hd_precondition/ref" not in r["dispatch"]
              for r in ranks), "dp_parity: K2 did not launch twice a step on each rank")
    # the per-worker estimate against the single-process formula on the card
    cfg = gc.CompressConfig(gamma=0.1, chunk_p=PW_CHUNK, error_feedback=False, mode="per-worker")
    grads = torch.from_numpy(np.random.default_rng(16).normal(size=(2, P_PW)).astype(np.float32))
    spec = gc.mask_spec(cfg, prng.PRNGKey(3))
    signs_key = spec.signs_key()
    acc = 0.0
    for w in (0, 1):
        v = torch.nn.functional.pad(grads[w].cuda(), (0, -P_PW % PW_CHUNK)).view(-1, PW_CHUNK)
        y = ros.precondition(v, signs_key, "hadamard")
        idx = sample_indices(sketch_mod.batch_key(spec, PW_STEP, w), y.shape[0], PW_CHUNK, cfg.m,
                             device="cuda").long()
        scat = torch.zeros_like(y).scatter_(1, idx, torch.gather(y, 1, idx))
        acc = acc + scat * (PW_CHUNK / cfg.m)
    want = ros.unmix(acc / 2, signs_key, "hadamard").reshape(-1)[:P_PW].cpu()
    err = float((ranks[0]["est"] - want).abs().max() / want.abs().max())
    print(f"  perworker_mean_estimate on 2 gloo ranks, {P_PW:,} values in chunks of {PW_CHUNK} "
          f"(m = {cfg.m}): {err:.3g} of max |value| from the single-process formula (≤ 1e-5); "
          f"the ranks bit-equal {torch.equal(ranks[0]['est'], ranks[1]['est'])}", flush=True)
    check(err <= 1e-5 and torch.equal(ranks[0]["est"], ranks[1]["est"]),
          "dp_parity: the per-worker estimate differs from the single-process formula")
    del start, one, ranks


def timed(fn):
    """(fn's result, its seconds on a host clock synchronised with the card)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def decode_greedy(lm, params, state, first, start: int, steps: int, label: str):
    """Greedy decode from token ``first`` (B, 1) at cur_len ``start``, every
    step timed and its logits checked finite; returns (the state or cache,
    the step times)."""
    import torch

    cur, times = first, []
    for t in range(steps):
        (logits, state), dt = timed(lambda: lm.decode_fn(params, cur, state, start + t))
        check(bool(torch.isfinite(logits).all()), f"{label} decode step {t}: a logit is not finite")
        cur = torch.argmax(logits, -1).to(torch.int32)[:, None]
        times.append(dt)
    return state, times


def report_decode(label: str, b: int, times, state, params, card: str) -> tuple[float, float]:
    """Print decode ms a step (the median) beside its byte bound
    (``roofline.analysis.decode_bytes``: the state or cache and the weights a
    step reads, once, over 3.35 TB/s)."""
    from repro_torch.roofline import analysis, hw
    from repro_torch.utils.tree import tree_size_bytes

    ms = float(np.median(times)) * 1e3
    b_state, b_w = tree_size_bytes(state), analysis.weights_read(params)
    bound_ms = analysis.decode_bytes(params, state) / hw.HBM_BW * 1e3
    print(f"  {label}: decode {ms:.2f} ms a step (median of {len(times)}; first "
          f"{times[0] * 1e3:.2f}), {b / (ms / 1e3):,.0f} tokens/s; byte bound {bound_ms:.3f} ms "
          f"(state or cache {b_state / 1e9:.3f} GB + weights {b_w / 1e9:.2f} GB over 3.35 TB/s; "
          f"{bound_ms / ms:.3f} of it); {card}", flush=True)
    return ms, bound_ms


def serve_gate(label: str, lm, params, tokens, nxt, kw: dict, cache_dtype, card: str) -> None:
    """prefill(S) then one decode_step against forward over S + 1 tokens:
    within TOL14 of max |logit|, argmax equal where the top-2 margin exceeds
    TOL14·max |logit|. ``kw``: the vlm inputs over S + 1."""
    import torch

    from repro_torch.models import transformer as tr

    S = tokens.shape[1]
    short = {k: (v[:, :, :S] if k == "positions" else v) for k, v in kw.items()}
    logits, cache = lm.prefill_fn(params, {"tokens": tokens, **short}, cache_dtype=cache_dtype)
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1)) for k, v in cache.items()}
    dec, cache = lm.decode_fn(params, nxt, cache, S + 1)
    del cache
    q_chunk = max(d for d in range(1, 513) if (S + 1) % d == 0)
    with torch.inference_mode():
        full, _ = tr.forward(params, torch.cat([tokens, nxt], 1), lm.cfg, q_chunk=q_chunk,
                             kv_chunk=S + 1, **kw)
    errs = []
    for got, want in ((logits, full[:, S - 1]), (dec, full[:, S])):
        got, want = got.float(), want.float()
        scale = float(want.abs().max())
        top2 = torch.topk(want, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > TOL14 * scale
        same = bool((torch.argmax(got, -1) == torch.argmax(want, -1))[clear].all())
        errs.append((float((got - want).abs().max()) / scale, int(clear.sum()), same))
    del full
    print(f"  {label} gate at {S} tokens: prefill's logits against forward's row {S - 1}: "
          f"{errs[0][0]:.4f} of max |logit|; prefill then decode_step against forward over "
          f"{S + 1} tokens (q_chunk {q_chunk}): {errs[1][0]:.4f} (≤ {TOL14}); argmax equal in "
          f"the {errs[0][1]} and {errs[1][1]} of {tokens.shape[0]} rows whose top-2 margin "
          f"exceeds it: {errs[0][2] and errs[1][2]}; {card}", flush=True)
    check(all(e <= TOL14 and same for e, _, same in errs),
          f"{label}: prefill then decode_step differs from forward beyond {TOL14}")


def engine_gate(label: str, lm, params, prompts, slots: int, max_len: int, new: int,
                card: str) -> None:
    """ServeEngine(n_slots=slots, max_len=max_len) over ``prompts`` with
    max_new=new, each request's tokens against its one-by-one greedy
    decoding: alone in its slot of its wave, with the wave's right-aligned
    padding and the other slots' prompts all zeros (the engine's shapes, so
    a row's arithmetic is the engine's)."""
    import torch

    from repro_torch.serve import Request, ServeEngine

    dev = params["embed"].device
    eng = ServeEngine(lm, params, n_slots=slots, max_len=max_len)
    for i, pr in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=pr, max_new=new))
    done, dt = timed(eng.run)
    n_out = sum(len(r.out) for r in done)
    seq_ok, t_seq = [], time.perf_counter()
    for w0 in range(0, len(prompts), slots):
        wave = prompts[w0:w0 + slots]
        plen = max(len(pr) for pr in wave)
        for s, pr in enumerate(wave):
            toks = np.zeros((slots, plen), np.int32)
            toks[s, plen - len(pr):] = pr
            toks = torch.from_numpy(toks).to(dev)
            cache = lm.init_decode_state(slots, max_len)
            for t in range(plen):
                logits, cache = lm.decode_fn(params, toks[:, t:t + 1], cache, t + 1)
            outs = [int(torch.argmax(logits[s]))]
            for k in range(new - 1):
                cur = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
                cur[s, 0] = outs[-1]
                logits, cache = lm.decode_fn(params, cur, cache, plen + k + 2)
                outs.append(int(torch.argmax(logits[s])))
            seq_ok.append(outs == done[w0 + s].out)
            del cache
    t_seq = time.perf_counter() - t_seq
    print(f"  {label} ServeEngine(n_slots={slots}, max_len={max_len}): {len(prompts)} requests of "
          f"{[len(p) for p in prompts]} prompt tokens, max_new={new}, in "
          f"{-(-len(prompts) // slots)} waves: {n_out} tokens in {dt:.2f} s ({n_out / dt:,.1f} "
          f"tokens/s); each request equal to its one-by-one greedy decoding (first token at "
          f"cur_len = plen + 2, caveat R5): {seq_ok} ({t_seq:.1f} s); {card}", flush=True)
    check(len(done) == len(prompts) and all(r.done and len(r.out) == new for r in done),
          f"{label}: the engine did not finish every request")
    check(all(seq_ok), f"{label}: the engine's tokens differ from one-by-one decoding")


def phase14_serve(card: str) -> dict[str, int]:
    """Phase 14 (module docstring): LM serving at full width. Returns the
    kernels' launches over the phase (the repo's kernels serve no model)."""
    t14 = time.perf_counter()
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.api import get_api
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_size_bytes

    gib = lambda b: b / 2**30  # noqa: E731
    dev = torch.device("cuda")
    print(f"== 14 lm-serve: prefill, the KV cache, decode_step and ServeEngine at full width "
          f"(random weights from torch.Generator(seed 0); logit tolerance {TOL14} of max |logit|)",
          flush=True)
    torch.cuda.empty_cache()
    ops.reset_counts()

    def finite(t, what):
        check(bool(torch.isfinite(t).all()), f"{what}: a logit is not finite")

    def peak_gate(label):
        peak = torch.cuda.max_memory_allocated()
        print(f"  {label}: peak memory {gib(peak):.2f} GiB (< {PEAK14_GIB}); {card}", flush=True)
        check(peak < PEAK14_GIB * 2**30, f"{label}: peak memory {gib(peak):.2f} GiB")

    # (a) gemma3-1b, launch.serve's path: prefill_32k's sequence into a float32 cache
    cfg = get_arch("gemma3-1b")
    lm = get_api(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(0)
    prompt = prng.randint(prng.PRNGKey(0), (B14A, S14A), 0, cfg.vocab_size, device=dev)
    (logits, cache), dt = timed(lambda: lm.prefill_fn(params, {"tokens": prompt},
                                                      cache_dtype=torch.float32))
    finite(logits, "(a) prefill")
    print(f"  (a) {cfg.name} ({cfg.n_layers} layers, {tree_size_bytes(params) / 1e9:.2f} GB of "
          f"{cfg.dtype} weights), launch.serve's path: prefill of {B14A} × {S14A:,} tokens "
          f"(prefill_32k's sequence; batch 32 → {B14A}) into a float32 cache in {dt:.2f} s, "
          f"{B14A * S14A / dt:,.0f} tokens/s; {card}", flush=True)
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, GEN14A)) for k, v in cache.items()}
    first = torch.argmax(logits, -1).to(torch.int32)[:, None]
    _, times = decode_greedy(lm, params, cache, first, S14A + 1, GEN14A, "(a)")
    report_decode(f"(a) {cfg.name} at a {S14A + GEN14A:,}-long float32 cache, batch {B14A}",
                  B14A, times, cache, params, card)
    del cache, logits
    serve_gate(f"(a) {cfg.name}", lm, params, prompt[:, :GATE14], prompt[:, GATE14:GATE14 + 1], {},
               torch.float32, card)
    peak_gate("(a)")

    # (b) decode_32k's cache length: a bf16 cache of 32 × 32768 filled from a
    # seeded generator (N(0, 1) keys and values, as no prompt was prefilled)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cache, dt = timed(lambda: lm.init_decode_state(B14B, S14A))
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    for name in ("k", "v"):
        for i in range(cfg.n_layers):
            cache[name][i].normal_(generator=gen)
    start = S14A - GEN14B + 1
    first = prng.randint(prng.PRNGKey(1), (B14B, 1), 0, cfg.vocab_size, device=dev)
    print(f"  (b) {cfg.name}: init_kv_cache({B14B}, {S14A:,}) in bf16, {tree_size_bytes(cache) / 1e9:.2f} "
          f"GB (decode_32k's cache length; batch 128 → {B14B}), filled from a seeded generator "
          f"(N(0, 1)); {GEN14B} decode steps from cur_len = {start}; {card}", flush=True)
    _, times = decode_greedy(lm, params, cache, first, start, GEN14B, "(b)")
    report_decode(f"(b) {cfg.name} at a {S14A:,}-long bf16 cache, batch {B14B}", B14B, times, cache,
                  params, card)
    del cache
    peak_gate("(b)")

    # (e) the engine: gemma3-1b in float32, TF32 off, 8 requests over 4 slots
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    lm32 = get_api(dataclasses.replace(cfg, dtype="float32"))
    params = lm32.init_params(0)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(8, 65, REQS14)]
    engine_gate(f"(e) {cfg.name} in float32, TF32 off,", lm32, params, prompts, SLOTS14, MAXLEN14,
                NEW14, card)
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    peak_gate("(e)")
    del params

    # (c) glm4-9b: prefill at train_4k's sequence, batch 8, then 32 steps
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch("glm4-9b")
    lm = get_api(cfg)
    params, dt_init = timed(lambda: lm.init_params(0))
    prompt = prng.randint(prng.PRNGKey(2), (B14C, S14C), 0, cfg.vocab_size, device=dev)
    (logits, cache), dt = timed(lambda: lm.prefill_fn(params, {"tokens": prompt}))
    finite(logits, "(c) prefill")
    print(f"  (c) {cfg.name} ({cfg.n_layers} layers, {tree_size_bytes(params) / 1e9:.2f} GB of "
          f"{cfg.dtype} weights drawn in {dt_init:.1f} s): prefill of {B14C} × {S14C:,} tokens "
          f"(train_4k's sequence) into a bf16 cache in {dt:.2f} s, {B14C * S14C / dt:,.0f} tokens/s; "
          f"{card}", flush=True)
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, GEN14C)) for k, v in cache.items()}
    nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
    _, times = decode_greedy(lm, params, cache, nxt, S14C + 1, GEN14C, "(c)")
    report_decode(f"(c) {cfg.name} at a {S14C + GEN14C:,}-long bf16 cache, batch {B14C}", B14C,
                  times, cache, params, card)
    del cache, logits
    serve_gate(f"(c) {cfg.name}", lm, params, prompt, nxt, {}, torch.bfloat16, card)
    peak_gate("(c)")
    del params, prompt

    # (d) qwen2-vl-2b: 256 seeded vision embeddings over tokens 1 … 256, their
    # M-RoPE positions on a 16 × 16 (h, w) grid at t = 1; text tokens at
    # their index in all three streams (what decode_step's cur_len − 1 continues)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch("qwen2-vl-2b")
    lm = get_api(cfg)
    params = lm.init_params(0)
    nv = cfg.n_vision_tokens
    check(nv == GRID14 * GRID14, f"{cfg.name} has {nv} vision tokens")
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    vis = (torch.randn((B14D, nv, cfg.d_model), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    pos = torch.arange(S14D + 1, device=dev)[None, None].repeat(3, B14D, 1)
    cell = torch.arange(nv, device=dev)
    pos[0, :, 1:1 + nv] = 1
    pos[1, :, 1:1 + nv] = 1 + cell // GRID14
    pos[2, :, 1:1 + nv] = 1 + cell % GRID14
    prompt = prng.randint(prng.PRNGKey(3), (B14D, S14D), 0, cfg.vocab_size, device=dev)
    batch = {"tokens": prompt, "positions": pos[:, :, :S14D], "vision_embeds": vis}
    (logits, cache), dt = timed(lambda: lm.prefill_fn(params, batch))
    finite(logits, "(d) prefill")
    print(f"  (d) {cfg.name} ({cfg.n_layers} layers, {tree_size_bytes(params) / 1e9:.2f} GB of "
          f"{cfg.dtype} weights, M-RoPE sections {cfg.mrope_sections}): prefill of {B14D} × "
          f"{S14D:,} tokens with {nv} vision embeddings on a {GRID14} × {GRID14} grid into a bf16 "
          f"cache in {dt:.2f} s, {B14D * S14D / dt:,.0f} tokens/s; {card}", flush=True)
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, GEN14D)) for k, v in cache.items()}
    nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
    _, times = decode_greedy(lm, params, cache, nxt, S14D + 1, GEN14D, "(d)")
    report_decode(f"(d) {cfg.name} at a {S14D + GEN14D:,}-long bf16 cache, batch {B14D}", B14D,
                  times, cache, params, card)
    del cache, logits
    serve_gate(f"(d) {cfg.name}", lm, params, prompt, nxt, {"positions": pos, "vision_embeds": vis},
               torch.bfloat16, card)
    peak_gate("(d)")
    del params, prompt, vis, pos, batch
    torch.cuda.empty_cache()
    launches14 = ops.launch_counts()
    print(f"  launches in phase 14: {launches14} (no kernel of the repo serves a model); {card}")
    print(f"  phase 14: {time.perf_counter() - t14:.1f} s; {card}", flush=True)
    return launches14


def _rows_gate(label: str, got, want, card: str) -> float:
    """Logits (..., V) against the reference rows ``want``: within TOL14 of
    max |logit| and argmax equal where the top-2 margin exceeds that;
    returns the error."""
    import torch

    got, want = got.float().reshape(-1, want.shape[-1]), want.float().reshape(-1, want.shape[-1])
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > TOL14 * scale
    same = bool((torch.argmax(got, -1) == torch.argmax(want, -1))[clear].all())
    print(f"  {label}: {err:.4f} of max |logit| (≤ {TOL14}); argmax equal in the {int(clear.sum())} "
          f"of {want.shape[0]} rows whose top-2 margin exceeds it: {same}; {card}", flush=True)
    check(err <= TOL14 and same, f"{label}: beyond {TOL14} of the forward's logits")
    return err


def phase15_families(card: str) -> dict[str, int]:
    """Phase 15 (module docstring): the ssm, hybrid and audio families
    trained with K2 gradient compression and served at full width. Returns
    the kernels' launches summed over the three training runs, each read
    just after its reset."""
    t15 = time.perf_counter()
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import grad_compress as gc
    from repro_torch.core import ros
    from repro_torch.data.pipeline import SyntheticLMSource
    from repro_torch.kernels import ops, ref
    from repro_torch.models import encdec, hybrid, mamba_lm
    from repro_torch.models.api import get_api
    from repro_torch.models.transformer import NO_DIST
    from repro_torch.roofline import kernels as rk
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.trainer import TrainerConfig, init_state, make_train_fn
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_count_params, tree_leaves, tree_size_bytes

    gib = lambda b: b / 2**30  # noqa: E731
    dev = torch.device("cuda")
    comp = gc.CompressConfig(gamma=0.1)
    cp, m = comp.chunk_p, comp.m
    key = prng.PRNGKey(0)
    print(f"== 15 lm-families: mamba2-1.3b, zamba2-1.2b and seamless-m4t-large-v2 at full width "
          f"and depth in bf16 (random weights from torch.Generator), trained {STEPS15} steps of "
          f"{B15} × {SEQ15} with CompressConfig(gamma={comp.gamma}) and served at {B15S} × {S15} "
          f"(logit tolerance {TOL14} of max |logit|)", flush=True)

    def audio_frames(step, cfg, b, s):
        """launch.train's frames: 0.1 · normal(fold_in(key, step), (b, s, d)) in
        the config's dtype."""
        dtype = getattr(torch, cfg.dtype)
        x = prng.normal(prng.fold_in(key, step), (b, s, cfg.d_model), device=dev, dtype=dtype)
        return torch.tensor(0.1, dtype=dtype, device=dev) * x

    # ------------------------------------------------------------ training
    launches15, k2_15 = {}, {}
    for arch in ("mamba2-1.3b", "zamba2-1.2b", "seamless-m4t-large-v2"):
        cfg = get_arch(arch)
        model = get_api(cfg)
        accum = ACCUM15[arch]
        tcfg = TrainerConfig(opt=opt_mod.OptConfig(peak_lr=LR13, warmup_steps=1,
                                                   total_steps=STEPS15),
                             accum_steps=accum, compress=comp, q_chunk=Q13, kv_chunk=KV13)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        state, t_init = timed(lambda: init_state(model, tcfg, key, device="cuda"))
        n = tree_count_params(state["params"])
        nc = -(-n // cp)
        check(nc == CHUNKS15[arch], f"{arch}: {n:,} parameters in {nc:,} chunks, not "
                                    f"{CHUNKS15[arch]:,}")
        fn = make_train_fn(model, tcfg, NO_DIST, key, device="cuda")
        src = SyntheticLMSource(cfg.vocab_size, SEQ15, B15, seed=0)
        print(f"  {arch} ({cfg.family}; {cfg.n_layers} layers{f' + {cfg.n_enc_layers} encoder' if cfg.n_enc_layers else ''}, "
              f"d_model {cfg.d_model}, vocab {cfg.vocab_size}): {n:,} parameters, {nc:,} chunks of "
              f"{cp}; state {gib(tree_size_bytes(state)):.2f} GiB drawn in {t_init:.2f} s; "
              f"{B15} × {SEQ15} a step as {accum} micro-batches", flush=True)
        ops.reset_counts()
        recs = []
        for step in range(STEPS15):
            batch = {k: v.to(dev) for k, v in src.batch_for(step).items()}
            if cfg.family == "audio":
                batch["frames"] = audio_frames(step, cfg, B15, SEQ15)
            k2 = ops.DISPATCH[("hd_precondition", "kernel")]
            (state, met), dt = timed(lambda: fn(state, batch))
            rec = dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                       wire=int(met["wire_floats"]), s=dt,
                       k2=ops.DISPATCH[("hd_precondition", "kernel")] - k2)
            recs.append(rec)
            print(f"    step {step}: loss {rec['loss']!r}, grad_norm {rec['grad_norm']:.4f}, "
                  f"wire_floats {rec['wire']:,}, {dt:.3f} s ({B15 * SEQ15 / dt:,.0f} tokens/s), K2 "
                  f"launches {rec['k2']}", flush=True)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = ops.launch_counts()
        dispatch = dict(ops.DISPATCH)
        for name, c in launches.items():
            launches15[name] = launches15.get(name, 0) + c
        step_s = float(np.median([r["s"] for r in recs[1:]]))
        print(f"  {arch}: {step_s:.3f} s a step (median of steps 1-{STEPS15 - 1}; step 0 "
              f"{recs[0]['s']:.3f} s), {B15 * SEQ15 / step_s:,.0f} tokens/s; peak memory "
              f"{gib(peak):.2f} GiB ({gib(base):.2f} GiB held before); launches {launches}; {card}",
              flush=True)
        losses = [r["loss"] for r in recs]
        check(all(math.isfinite(v) for v in losses), f"{arch}: a loss is not finite: {losses}")
        check(all(r["k2"] == 2 for r in recs) and launches["hd_precondition"] == 2 * STEPS15,
              f"{arch}: K2 did not launch twice a step on the kernel path: {dispatch}")
        check(not [k for k in dispatch if k[1] == "ref"], f"{arch}: a plain version ran: {dispatch}")
        # the metric is a float32 scalar, as the reference's: nc × m rounded to float32
        check(all(r["wire"] == int(np.float32(nc * m)) for r in recs),
              f"{arch}: wire_floats is not {nc} × {m} in float32")
        check(peak < PEAK15_GIB * 2**30, f"{arch}: peak memory {gib(peak):.2f} GiB ≥ {PEAK15_GIB}")
        # the error-feedback identity on one micro-batch's gradient plus the residual
        params = state["params"]
        leaves = tree_leaves(params)
        mb = {k: v[:B15 // accum] for k, v in batch.items()}
        (loss, _), t_fwd = timed(lambda: model.loss_fn(params, mb, NO_DIST, q_chunk=Q13,
                                                       kv_chunk=KV13))
        grads, t_bwd = timed(lambda: torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            flat = torch.zeros((nc * cp,), dtype=torch.float32, device=dev)
            off = 0
            for g, r in zip(grads, tree_leaves(state["residual"])):
                flat[off:off + g.numel()].add_(g.reshape(-1)).add_(r.reshape(-1))
                off += g.numel()
            del grads, loss
            v0 = flat.clone()
            (g_hat, res_flat, wire), t_comp = timed(lambda: gc.compress_flat(
                flat, prng.fold_in_str(key, "grad-compress"), STEPS15, comp))
            err = float((g_hat[:n] + res_flat[:n] - v0[:n]).abs().max())
            scale = float(v0[:n].abs().max())
        print(f"  {arch}: max |ĝ + r' − (g + r)| {err:.3g} of max |g + r| {scale:.3g}; wire "
              f"{wire:,}; a step's parts, each timed alone: one micro-batch's forward "
              f"{t_fwd:.3f} s and backward {t_bwd:.3f} s (× {accum}), compression {t_comp:.3f} s, "
              f"against the step's {step_s:.3f} s; {card}", flush=True)
        check(wire == nc * m and err <= 1e-6 * scale,
              f"{arch}: the error-feedback identity ĝ + r' = g + r does not hold")
        # K2 at this gradient's shape on its real chunks (g + r): its first and
        # last row blocks bit-equal to the plain version, its time beside its
        # bound (each value read and written once)
        del g_hat, res_flat, flat
        with torch.no_grad():
            x = v0.view(nc, cp)
            signs = ros.signs_for(gc.mask_spec(comp, prng.fold_in_str(key, "grad-compress"))
                                  .signs_key(), cp, device="cuda")
            got = ops.hd_precondition(x, signs)
            same = all(torch.equal(got[r0:r0 + 4096], ref.ref_hd_precondition(x[r0:r0 + 4096],
                                                                              signs, False))
                       for r0 in (0, nc - 4096))
            del got
            ms = time_ms(lambda: ops.hd_precondition(x, signs), 3, warmup=1)
        b_k2 = rk.fwht_roofline(nc, cp)
        k2_15[arch] = (nc, ms, b_k2.ms)
        print(f"  {arch}: K2 hd_precondition ({nc:,}, {cp}): first and last 4096 rows bit-equal to "
              f"its plain version: {same}; {ms:.4f} ms, bound {b_k2.ms:.4f} ms ({b_k2.bound}; "
              f"{b_k2.ms / ms:.2f} of it); {card}", flush=True)
        check(same, f"{arch}: K2 at ({nc}, {cp}) is not bit-equal to its plain version")
        del state, params, leaves, v0, x, fn, batch, mb
        torch.cuda.empty_cache()

    # ------------------------------------------------------------- serving
    # (a) mamba2-1.3b: ssm_prefill of B15S × S15, then GEN15 steps from its states
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch("mamba2-1.3b")
    lm = get_api(cfg)
    params = lm.init_params(0)
    prompt = prng.randint(prng.PRNGKey(4), (B15S, S15), 0, cfg.vocab_size, device=dev)
    (logits, states), dt = timed(lambda: lm.prefill_fn(params, {"tokens": prompt}))
    check(bool(torch.isfinite(logits).all()), "(a) prefill: a logit is not finite")
    print(f"  (a) {cfg.name}: ssm_prefill of {B15S} × {S15:,} tokens in {dt:.2f} s, "
          f"{B15S * S15 / dt:,.0f} tokens/s; states {tree_size_bytes(states) / 1e9:.3f} GB; {card}",
          flush=True)
    with torch.inference_mode():
        full = mamba_lm.forward(params, prompt, cfg)
    _rows_gate(f"(a) {cfg.name} ssm_prefill's logits against forward's row {S15 - 1}", logits,
               full[:, -1], card)
    first = torch.argmax(logits, -1).to(torch.int32)[:, None]
    states, times = decode_greedy(lm, params, states, first, S15 + 1, GEN15, "(a)")
    report_decode(f"(a) {cfg.name} from ssm_prefill's states, batch {B15S}", B15S, times, states,
                  params, card)
    cut = S15 - cfg.ssm_chunk
    _, st = lm.prefill_fn(params, {"tokens": prompt[:, :cut]})
    dec, _ = lm.decode_fn(params, prompt[:, cut:cut + 1], st, cut + 1)
    _rows_gate(f"(a) {cfg.name} ssm_prefill of {cut} tokens then one decode_step against forward's "
               f"row {cut}", dec, full[:, cut], card)
    del full, states, st, logits
    peak = torch.cuda.max_memory_allocated()
    print(f"  (a): peak memory {gib(peak):.2f} GiB; {card}", flush=True)
    check(peak < PEAK15_GIB * 2**30, f"(a): peak memory {gib(peak):.2f} GiB")
    del params

    # (b) zamba2-1.2b: a B15S × S15 state whose KV sites hold seeded N(0, 1)
    # keys and values, GEN15 steps from cur_len S15 − GEN15 + 1; then a
    # PROMPT15-token prompt decoded token by token against forward
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch("zamba2-1.2b")
    lm = get_api(cfg)
    params = lm.init_params(0)
    state = lm.init_decode_state(B15S, S15)
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    for name in ("k", "v"):
        for i in range(hybrid.n_shared_sites(cfg)):
            state[name][i].normal_(generator=gen)
    start = S15 - GEN15 + 1
    first = prng.randint(prng.PRNGKey(5), (B15S, 1), 0, cfg.vocab_size, device=dev)
    print(f"  (b) {cfg.name}: init_decode_state({B15S}, {S15:,}) in bf16 "
          f"({hybrid.n_shared_sites(cfg)} KV sites, {tree_size_bytes(state) / 1e9:.3f} GB), the "
          f"sites filled from a seeded generator; {GEN15} decode steps from cur_len = {start}; "
          f"{card}", flush=True)
    state, times = decode_greedy(lm, params, state, first, start, GEN15, "(b)")
    report_decode(f"(b) {cfg.name} at a {S15:,}-long cache, batch {B15S}", B15S, times, state,
                  params, card)
    del state
    toks = prng.randint(prng.PRNGKey(6), (B15S, PROMPT15), 0, cfg.vocab_size, device=dev)
    state = lm.init_decode_state(B15S, PROMPT15)
    outs, t0 = [], time.perf_counter()
    for t in range(PROMPT15):
        logits, state = lm.decode_fn(params, toks[:, t:t + 1], state, t + 1)
        outs.append(logits)
    torch.cuda.synchronize()
    t_prompt = time.perf_counter() - t0
    with torch.inference_mode():
        full = hybrid.forward(params, toks, cfg, q_chunk=PROMPT15, kv_chunk=PROMPT15)
    _rows_gate(f"(b) {cfg.name} a {PROMPT15}-token prompt decoded token by token ({t_prompt:.2f} s) "
               f"against forward over it, every row", torch.stack(outs, 1), full, card)
    pre = lm.prefill_fn(params, {"tokens": toks})[0]
    _rows_gate(f"(b) {cfg.name} hyb_prefill's logits against forward's last row", pre, full[:, -1],
               card)
    del full, outs, state, params, pre
    peak = torch.cuda.max_memory_allocated()
    print(f"  (b): peak memory {gib(peak):.2f} GiB; {card}", flush=True)
    check(peak < PEAK15_GIB * 2**30, f"(b): peak memory {gib(peak):.2f} GiB")

    # (c) seamless-m4t-large-v2: init_decode_cache over B15S × S15 frames,
    # then GEN15 teacher-forced steps against forward over the same tokens
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch("seamless-m4t-large-v2")
    lm = get_api(cfg)
    params = lm.init_params(0)
    frames = audio_frames(1000, cfg, B15S, S15)
    (none, cache), dt = timed(lambda: lm.prefill_fn(params, {"frames": frames}, max_len=GEN15))
    check(none is None, "the audio prefill returned logits")
    print(f"  (c) {cfg.name}: init_decode_cache over {B15S} × {S15:,} frames (the encoder once, "
          f"the cross K/V of {cfg.n_layers} layers, {tree_size_bytes(cache) / 1e9:.3f} GB) in "
          f"{dt:.2f} s, {B15S * S15 / dt:,.0f} frames/s; {card}", flush=True)
    toks = prng.randint(prng.PRNGKey(7), (B15S, GEN15), 0, cfg.vocab_size, device=dev)
    outs, times = [], []
    for t in range(GEN15):
        (logits, cache), dts = timed(lambda: lm.decode_fn(params, toks[:, t:t + 1], cache, t + 1))
        outs.append(logits)
        times.append(dts)
    report_decode(f"(c) {cfg.name} over {S15:,} frames, batch {B15S}", B15S, times, cache, params, card)
    with torch.inference_mode():
        full = encdec.forward(params, frames, toks, cfg)
    _rows_gate(f"(c) {cfg.name} {GEN15} decode steps against forward over the same tokens, every "
               f"row", torch.stack(outs, 1), full, card)
    del full, outs, cache, params, frames
    peak = torch.cuda.max_memory_allocated()
    print(f"  (c): peak memory {gib(peak):.2f} GiB; {card}", flush=True)
    check(peak < PEAK15_GIB * 2**30, f"(c): peak memory {gib(peak):.2f} GiB")

    # (d) ServeEngine for ssm and hybrid, in float32 with TF32 off: each
    # request's tokens equal to its one-by-one greedy decoding, alone in its
    # slot with the wave's right-aligned padding (the engine's shapes)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ("mamba2-1.3b", "zamba2-1.2b"):
        torch.cuda.empty_cache()
        lm32 = get_api(dataclasses.replace(get_arch(arch), dtype="float32"))
        rng = np.random.default_rng(15)
        prompts = [rng.integers(0, lm32.cfg.vocab_size, int(n)).astype(np.int32)
                   for n in rng.integers(8, 25, REQS15)]
        params = lm32.init_params(0)
        engine_gate(f"(d) {arch} in float32, TF32 off,", lm32, params, prompts, SLOTS15, MAXLEN15,
                    NEW15, card)
        del params
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    torch.cuda.empty_cache()
    print(f"  K2 at the gradients' shapes (rows, ms, bound ms): {k2_15}; {card}")
    print(f"  launches in phase 15's training runs: {launches15}; {card}")
    print(f"  phase 15: {time.perf_counter() - t15:.1f} s; {card}", flush=True)
    return launches15


def _summaries(out: str) -> list[dict]:
    """The launcher's rank-summary lines, by rank."""
    return sorted((json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
                   if line.startswith("rank-summary ")), key=lambda s: s["rank"])


def phase16_dp_train(card: str) -> dict[str, int]:
    """Phase 16 (module docstring): data-parallel training of gemma3-1b at
    full width through ``python -m repro_torch.launch.train --devices 2
    --dist-backend gloo`` on the one card. Returns the kernels' launches of
    the uninterrupted 2-rank run, summed over its ranks (each rank's counts
    start at 0 in its own process)."""
    t16 = time.perf_counter()
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import grad_compress as gc
    from repro_torch.data.pipeline import SyntheticLMSource
    from repro_torch.kernels import ops
    from repro_torch.models.api import get_api
    from repro_torch.models.transformer import NO_DIST
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.cluster.bootstrap import Mesh
    from repro_torch.train import fsdp
    from repro_torch.train.trainer import (TrainerConfig, abstract_params, abstract_state,
                                           init_state, make_train_fn)
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_count_params

    cfg = dataclasses.replace(get_arch("gemma3-1b"), n_layers=DEPTH16)
    model = get_api(cfg)
    comp = gc.CompressConfig(gamma=0.1)
    # the launcher's state, placed on its host mesh of the 2 ranks
    tcfg16 = TrainerConfig(compress=comp)
    mesh16 = Mesh((1, 2), ("data", "model"), owners=(0, 1), collective=True)
    cp, m = comp.chunk_p, comp.m
    n = tree_count_params(abstract_params(model))
    nc = -(-n // cp)
    tokens = B16 * SEQ16
    print(f"== 16 dp-train: python -m repro_torch.launch.train --devices 2 --dist-backend gloo on "
          f"the one card: {cfg.name} at full width, {DEPTH16} of its 26 layers ({n:,} bf16 "
          f"parameters, {nc:,} chunks of {cp}, m {m}), AdamW, CompressConfig(gamma={comp.gamma}) "
          f"with error feedback, seq {SEQ16}, a global batch of {B16} ({B16 // 2} rows a rank in "
          f"{ACCUM16} micro-batch), {STEPS16} steps, a checkpoint after step {CKPT16}", flush=True)
    base = [sys.executable, "-m", "repro_torch.launch.train", "--devices", "2", "--dist-backend",
            "gloo", "--device", "cuda", "--arch", cfg.name, "--layers", str(DEPTH16), "--seq",
            str(SEQ16), "--batch", str(B16), "--accum", str(ACCUM16), "--steps", str(STEPS16),
            "--grad-compress-gamma", str(comp.gamma), "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=SRC)

    def launch(*extra):
        t0 = time.perf_counter()
        out = subprocess.run(base + list(extra), capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=900)
        check(out.returncode == 0, f"dp-train: the launcher exited {out.returncode}:\n"
                                   f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
        return out.stdout, time.perf_counter() - t0

    # a checkpoint holds the bf16 parameters, the float32 moments and the
    # one residual: 14 bytes a parameter, kept in host memory (/dev/shm), as
    # the phases before write theirs to the machine's disk. Only the
    # step-CKPT16 checkpoint is written (--no-final-ckpt)
    ck_bytes = 14 * n
    free = shutil.disk_usage("/dev/shm").free
    check(free > 1.2 * ck_bytes, f"dp-train: /dev/shm has {free / 1e9:.1f} GB free, the phase's "
                                 f"checkpoint needs {1.2 * ck_bytes / 1e9:.1f}")
    tmp = tempfile.mkdtemp(prefix="phase16_", dir="/dev/shm")
    try:
        run_dir = os.path.join(tmp, "run")
        out, t_run = launch("--ckpt-dir", run_dir, "--ckpt-every", str(CKPT16), "--no-final-ckpt",
                            "--time-exchange", "1")
        for line in out.splitlines():
            if line.startswith("step "):
                print(f"    {line}")
        runs = _summaries(out)
        check([r["rank"] for r in runs] == [0, 1] and all(r["world"] == 2 and r["backend"] == "gloo"
                                                          and r["device"].startswith("cuda")
                                                          for r in runs),
              f"dp-train: not 2 gloo ranks on the card: {runs}")
        losses = runs[0]["losses"]
        step_s = float(np.median(runs[0]["step_s"][1:]))
        to_ms, from_ms, mask = (runs[0]["to_chunks_ms"], runs[0]["from_chunks_ms"],
                                runs[0]["mask_ms"])
        layouts = [dataclasses.replace(fsdp.Layout.of(abstract_state(model, tcfg16), mesh16),
                                       rank=r) for r in (0, 1)]
        moves = [lay.chunk_bytes() for lay in layouts]
        ck_size = os.path.getsize(os.path.join(ckpt_mod.latest_step_dir(run_dir), "arrays.npz"))
        print(f"  2 ranks, uninterrupted with a checkpoint after step {CKPT16} ({ck_size:,} bytes): "
              f"{t_run:.1f} s with the processes' start (rank 0: {runs[0]['ready_s']:.1f} s to its "
              f"first step, {runs[0]['wall_s']:.1f} s to its summary); losses {losses}; {step_s:.3f} s a step "
              f"(median of rank 0's steps 1-{STEPS16 - 1}; step 0 {runs[0]['step_s'][0]:.3f} s), "
              f"{tokens / step_s:,.0f} tokens/s; peak memory "
              f"{[round(r['peak_gib'], 2) for r in runs]} GiB a rank; {card}", flush=True)
        rows = [r["rows"][1] - r["rows"][0] for r in runs]
        print(f"  placed (FSDP): each rank's chunks {[r['rows'] for r in runs]} of {nc:,}; the "
              f"all-to-alls a step move {moves} bytes a rank (the dense gradient's 4·p = "
              f"{runs[0]['dense_bytes']:,}); over gloo into the ranges {to_ms[0]:.1f} ms, back "
              f"{from_ms[0]:.1f} ms (one timed call each); counted over the run "
              f"{[r['exchange_bytes'] for r in runs]}; rank 0's mask (sample_indices, "
              f"{rows[0]:,} × {m}) {mask[0]:.1f} ms, {mask[0] / 1e3 / step_s:.3f} of a step; "
              f"launches {[r['launches'] for r in runs]}; "
              f"{card}", flush=True)
        check(all(math.isfinite(v) for v in losses) and len(losses) == STEPS16,
              f"dp-train: a loss is not finite: {losses}")
        check(all(r["losses"] == losses and r["params_sha256"] == runs[0]["params_sha256"]
                  for r in runs), "dp-train: the ranks' losses or parameters differ")
        check(all(r["launches"]["hd_precondition"] == 2 * STEPS16
                  and r["dispatch"].get("hd_precondition/kernel") == 2 * STEPS16
                  and not [k for k in r["dispatch"] if k.endswith("/ref")] for r in runs),
              "dp-train: K2 did not launch twice a step on each rank's kernel path")
        check(runs[0]["params"] == n and all(r["chunks"] == nc for r in runs)
              and all({k: r["exchange_bytes"].get(k) for k in mv} == {k: STEPS16 * v
                                                                       for k, v in mv.items()}
                      for r, mv in zip(runs, moves)),
              f"dp-train: the all-to-alls did not move the layout's bytes {moves} a step")
        check(all(r["peak_gib"] < PEAK16_GIB for r in runs),
              f"dp-train: peak memory ≥ {PEAK16_GIB} GiB a rank")

        # --resume at 2 ranks from the step-CKPT16 checkpoint: bit for bit
        out_r, t_res = launch("--ckpt-dir", run_dir, "--no-final-ckpt")
        check(f"restored checkpoint at step {CKPT16}" in out_r, "dp-train: the resume did not restore")
        res_runs = _summaries(out_r)
        print(f"  --resume at 2 ranks from step {CKPT16}: {t_res:.1f} s with the start (rank 0: "
              f"{res_runs[0]['ready_s']:.1f} s to its first step, the restore among them); losses "
              f"{res_runs[0]['losses']} against {losses[CKPT16:]}; final parameters' SHA-256 "
              f"{res_runs[0]['params_sha256'][:16]}… against {runs[0]['params_sha256'][:16]}…; "
              f"{card}", flush=True)
        check(all(r["losses"] == losses[CKPT16:] and r["params_sha256"] == runs[0]["params_sha256"]
                  for r in res_runs), "dp-train: the resumed run differs from the uninterrupted one")

        # the elastic path 2 → 1: this process restores the step-2 checkpoint
        # (the one residual) and continues on the global batch
        tcfg = TrainerConfig(opt=opt_mod.OptConfig(peak_lr=3e-4, warmup_steps=max(1, STEPS16 // 20),
                                                   total_steps=STEPS16),
                             accum_steps=ACCUM16, compress=comp, q_chunk=min(512, SEQ16),
                             kv_chunk=min(1024, SEQ16))
        key = prng.PRNGKey(0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_state(model, tcfg, key, device="cuda")
        (state, extra), t_restore = timed(lambda: ckpt_mod.restore(run_dir, state))
        fn = make_train_fn(model, tcfg, NO_DIST, key, device="cuda")
        src = SyntheticLMSource(cfg.vocab_size, SEQ16, B16, seed=0)
        ops.reset_counts()
        elastic = []
        for s in range(CKPT16, STEPS16):
            state, met = fn(state, src.batch_for(s))
            elastic.append(float(met["loss"]))
        k2_one = ops.launch_counts()["hd_precondition"]
        gap = max(abs(a - b) for a, b in zip(elastic, losses[CKPT16:]))
        print(f"  elastic 2 → 1: one process restored the step-{CKPT16} checkpoint (the one "
              f"residual) in {t_restore:.2f} s and continued: losses {elastic} against the 2 ranks' "
              f"{losses[CKPT16:]}, {gap:.3g} apart (≤ {ELASTIC16}); K2 launches {k2_one}; peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}", flush=True)
        check(extra["pipeline"]["step"] == CKPT16 and all(math.isfinite(v) for v in elastic)
              and gap <= ELASTIC16, "dp-train: the elastic restore at one process is off")

        del state, fn
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches16 = {name: sum(r["launches"][name] for r in runs) for name in runs[0]["launches"]}
    print(f"  launches in phase 16 (both ranks' uninterrupted run): {launches16}")
    print(f"  phase 16: {time.perf_counter() - t16:.1f} s; {card}", flush=True)
    return launches16


def _fsdp_worker(argv) -> None:
    """``python3 chip_smoke.py --fsdp-worker --coordinator HOST:PORT --out DIR
    --process-id R``: rank R of phase 19's two gloo ranks on the card. It
    trains phase 16's model STEPS19 steps placed, then STEPS19 steps
    replicated from the same weights, and writes to DIR/rank{R}.pt each
    path's losses, step times, peak memory and masks' agreement, the placed
    state's bytes beside its layout's, K2's launches and rows, the bytes its
    collectives moved and how far the two paths' parameters lie apart."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--fsdp-worker", action="store_true")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--process-id", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, SRC)
    import torch

    from repro_torch import cluster, obs
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import grad_compress as gc
    from repro_torch.data.pipeline import SyntheticLMSource
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import get_api
    from repro_torch.train import fsdp
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.trainer import (TrainerConfig, abstract_state, init_state, make_dist,
                                           make_train_fn, place_state)
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

    cluster.initialize(args.coordinator, 2, args.process_id, backend="gloo", device="cuda")
    cfg = dataclasses.replace(get_arch("gemma3-1b"), n_layers=DEPTH16)
    model = get_api(cfg)
    tcfg = TrainerConfig(opt=opt_mod.OptConfig(peak_lr=LR19, warmup_steps=1, total_steps=STEPS19),
                         accum_steps=ACCUM19, compress=gc.CompressConfig(gamma=0.1),
                         q_chunk=512, kv_chunk=1024, dp_only=True)
    key = prng.PRNGKey(0)
    dist = make_dist(make_host_mesh(1, 2), cfg, dp_only=True)
    fn = make_train_fn(model, tcfg, dist, key, device="cuda")
    src = SyntheticLMSource(cfg.vocab_size, SEQ16, B16, seed=0)
    batches = [src.batch_for(s) for s in range(STEPS19)]
    drawn, draw = [], gc.sample_indices

    def recording(*a, **kw):
        idx = draw(*a, **kw)
        drawn.append(idx)
        return idx

    gc.sample_indices = recording

    def moved() -> dict:
        return {m.labels["mode"]: m.value for m in obs.default_registry().metrics()
                if m.name == "grad_compress.exchange_bytes"}

    def run(state):
        losses, times, masks = [], [], []
        torch.cuda.reset_peak_memory_stats()
        for b in batches:
            drawn.clear()
            torch.cuda.synchronize()
            torch.distributed.barrier()
            t = time.perf_counter()
            state, met = fn(state, b)
            losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            masks.append(drawn[0])
        return state, losses, times, masks, torch.cuda.max_memory_allocated() / 2**30

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    placed = place_state(init_state(model, tcfg, key, device="cuda"), dist)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    layout = placed.layout
    reckoned = layout.state_bytes(abstract_state(model, tcfg))
    before = moved()
    ops.reset_counts()
    placed, p_losses, p_times, p_masks, p_peak = run(placed)
    counts = ops.launch_counts()
    dispatch = {f"{k[0]}/{k[1]}": v for k, v in ops.DISPATCH.items()}
    after = moved()
    bytes_by_kind = {k: v - before.get(k, 0) for k, v in after.items() if v > before.get(k, 0)}
    p_params = [fsdp.gather_leaf(leaf, layout.places["['params']" + name])
                for name, leaf in tree_leaves_with_path(placed["params"])]
    del placed
    torch.cuda.empty_cache()
    rep, r_losses, r_times, r_masks, r_peak = run(init_state(model, tcfg, key, device="cuda"))
    c0, c1 = layout.chunk_ranges[layout.rank]
    masks_equal = all(torch.equal(pm, rm[c0:c1]) for pm, rm in zip(p_masks, r_masks))
    flipped = total = 0
    within = True
    for p, q in zip(p_params, tree_leaves(rep["params"])):
        p, q = p.detach(), q.detach()
        d = (p.float() - q.float()).abs()
        total += d.numel()
        if p.dtype == torch.bfloat16:
            ulps = (p.view(torch.int16).int() - q.view(torch.int16).int()).abs()
            flipped += int(((ulps > 1) | (p.float() * q.float() < 0)).sum())
            within &= bool((d <= 2 * LR19 * STEPS19 + q.float().abs() * 2.0**-7).all())
        else:
            flipped += int((d > 1e-6).sum())
            within &= float(d.max()) <= 2 * LR19 * STEPS19
        del d
    torch.save(dict(placed_losses=p_losses, placed_s=p_times, placed_peak_gib=p_peak,
                    replicated_losses=r_losses, replicated_s=r_times, replicated_peak_gib=r_peak,
                    masks_equal=masks_equal, mask_rows=[c0, c1], n_chunks=layout.n_chunks,
                    state_bytes=held, layout_bytes=reckoned, counts=counts, dispatch=dispatch,
                    bytes_by_kind=bytes_by_kind, flipped=flipped, coords=total, within=within),
               os.path.join(args.out, f"rank{args.process_id}.pt"))
    torch.distributed.barrier()
    cluster.shutdown()


def phase19_fsdp(card: str) -> dict[str, int]:
    """Phase 19 (module docstring): FSDP placement against the replicated
    path on two gloo ranks of the card (``_fsdp_worker``). Returns the
    kernels' launches of the placed steps, summed over the ranks."""
    t19 = time.perf_counter()
    import torch

    from repro_torch.cluster.bootstrap import free_port, run_ranks

    tokens = B16 * SEQ16
    print(f"== 19 fsdp: gemma3-1b at full width, {DEPTH16} of its 26 layers, bf16, on 2 gloo ranks "
          f"of the card: {STEPS19} steps with the state placed (FSDP) and {STEPS19} replicated from "
          f"the same weights, CompressConfig(gamma=0.1) with error feedback, a global batch of "
          f"{B16} × {SEQ16} ({ACCUM19} micro-batches of {B16 // 2 // ACCUM19} row a rank)",
          flush=True)
    tmp = tempfile.mkdtemp(prefix="fsdp19-")
    try:
        rc = run_ranks([sys.executable, os.path.abspath(__file__), "--fsdp-worker",
                        "--coordinator", f"127.0.0.1:{free_port()}", "--out", tmp], 2)
        check(rc == 0, f"fsdp: a rank exited {rc}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in (0, 1)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    p_s, r_s = float(np.median(r0["placed_s"][1:] or r0["placed_s"])), \
        float(np.median(r0["replicated_s"][1:] or r0["replicated_s"]))
    gap = max(abs(a - b) for a, b in zip(r0["placed_losses"][1:], r0["replicated_losses"][1:]))
    moved = max(abs(a - b) for a, b in zip(r0["replicated_losses"][1:], r0["replicated_losses"]))
    print(f"  placed: losses {r0['placed_losses']}, {p_s:.3f} s a step (rank 0's steps "
          f"{[round(t, 3) for t in r0['placed_s']]}), {tokens / p_s:,.0f} tokens/s; replicated: "
          f"losses {r0['replicated_losses']}, {r_s:.3f} s a step ({[round(t, 3) for t in r0['replicated_s']]}); "
          f"step 0 equal {r0['placed_losses'][0] == r0['replicated_losses'][0]}, steps 1– "
          f"{gap:.3g} apart (≤ {LOSS19}; a step moves the loss by {moved:.3g}); {card}", flush=True)
    for r, x in enumerate(ranks):
        rows = x["mask_rows"][1] - x["mask_rows"][0]
        print(f"  rank {r}: state on the card {x['state_bytes']:,} bytes against the layout's "
              f"{x['layout_bytes']:,} ({x['state_bytes'] / x['layout_bytes']:.4f}); K2 launches "
              f"{x['counts']['hd_precondition']} at ({rows:,}, 16384), chunks {x['mask_rows']} of "
              f"{x['n_chunks']:,}; masks bit-equal to the replicated step's rows {x['masks_equal']}; "
              f"bytes sent by kind over {STEPS19} steps {x['bytes_by_kind']}; peak memory placed "
              f"{x['placed_peak_gib']:.2f} GiB, replicated {x['replicated_peak_gib']:.2f} GiB; "
              f"parameters more than one bf16 unit apart {x['flipped']:,} of {x['coords']:,} "
              f"(≤ {FLIP19:g}), each within its bound {x['within']}; {card}", flush=True)
    check(all(math.isfinite(v) for x in ranks for v in x["placed_losses"] + x["replicated_losses"]),
          "fsdp: a loss is not finite")
    check(ranks[0]["placed_losses"] == ranks[1]["placed_losses"]
          and all(x["placed_losses"][0] == x["replicated_losses"][0] for x in ranks)
          and gap <= LOSS19, f"fsdp: the placed and replicated losses differ: "
                             f"{r0['placed_losses']} against {r0['replicated_losses']}")
    check(all(x["masks_equal"] for x in ranks), "fsdp: a placed mask differs from the replicated")
    check(ranks[0]["mask_rows"][1] == ranks[1]["mask_rows"][0]
          and ranks[1]["mask_rows"][1] == ranks[0]["n_chunks"], "fsdp: the ranks' chunks overlap")
    check(all(abs(x["state_bytes"] / x["layout_bytes"] - 1) <= MEM19 for x in ranks),
          "fsdp: a rank's state on the card is off its layout's bytes")
    check(all(x["flipped"] <= FLIP19 * x["coords"] and x["within"] for x in ranks),
          "fsdp: the placed parameters are off the replicated ones")
    check(all(x["counts"]["hd_precondition"] == 2 * STEPS19
              and x["dispatch"].get("hd_precondition/kernel") == 2 * STEPS19
              and not [k for k in x["dispatch"] if k.endswith("/ref")] for x in ranks),
          "fsdp: K2 did not launch twice a placed step on each rank's kernel path")
    launches19 = {name: sum(x["counts"][name] for x in ranks) for name in r0["counts"]}
    print(f"  launches in phase 19 (both ranks' placed steps): {launches19}")
    print(f"  phase 19: {time.perf_counter() - t19:.1f} s; {card}", flush=True)
    return launches19


def _moe_layer_gate(label: str, moe_p: dict, n_experts: int, cfg, card: str) -> None:
    """An MoE layer's FFN (``moe_p``, on the card; its first ``n_experts``
    experts) on CPU17 seeded float32 tokens: moe_apply_local on the card in
    float32 (TF32 off) against the CPU's on the same float32 weights —
    routed ids equal, y and aux within TOL17 of their largest value."""
    import torch

    from repro_torch.models import moe as moe_mod
    from repro_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    sub = {"router": moe_p["router"][:, :n_experts],
           **{w: moe_p[w][:n_experts] for w in ("w_gate", "w_up", "w_down")}}
    if "shared" in moe_p:
        sub["shared"] = moe_p["shared"]
    host = tree_map(lambda t: t.to("cpu").float(), sub)
    card32 = tree_map(lambda t: t.float(), sub)
    x = torch.randn((CPU17, cfg.d_model), generator=torch.Generator().manual_seed(17))
    k, cf = cfg.experts_per_token, cfg.capacity_factor
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        ids_c = moe_mod.route(card32["router"], x.cuda(), k)[0].cpu()
        y_c, aux_c = moe_mod.moe_apply_local(card32, x.cuda(), k, cf)
        ids_h = moe_mod.route(host["router"], x, k)[0]
        y_h, aux_h = moe_mod.moe_apply_local(host, x, k, cf)
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    err = float((y_c.cpu() - y_h).abs().max() / y_h.abs().max())
    err_aux = abs(float(aux_c) - float(aux_h)) / abs(float(aux_h))
    cap = moe_mod.capacity(CPU17, k, n_experts, cf)
    drops = int(torch.clamp(torch.bincount(ids_h.reshape(-1), minlength=n_experts) - cap,
                            min=0).sum())
    same = torch.equal(ids_c, ids_h)
    print(f"  {label} first MoE layer ({n_experts} experts{' + shared' if 'shared' in sub else ''}, "
          f"top-{k}, capacity {cap}: {drops} of {CPU17 * k} slots dropped) on {CPU17} float32 tokens, "
          f"the card (TF32 off) against moe_apply_local on the CPU: ids equal {same}, y "
          f"{err:.3g} of max |y|, aux {err_aux:.3g} relative (≤ {TOL17}); "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
    check(same and err <= TOL17 and err_aux <= TOL17,
          f"{label}: the MoE layer on the card differs from moe_apply_local on the CPU")
    del host, card32


def _serve_moe(label: str, arch: str, depth: int, batch: int, gen: int, seed: int,
               card: str) -> tuple[float, float, float]:
    """Phase 17 (a)/(b): ``arch`` at full width cut to ``depth`` layers, in
    bf16 — prefill of ``batch`` × S17, ``gen`` greedy decode steps timed
    beside their byte bound, the prefill-then-decode gate, ServeEngine
    against one-by-one decoding and the first MoE layer against the CPU.
    Returns (prefill tokens/s, decode ms a step, its bound ms)."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.api import get_api
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_count_params, tree_map, tree_size_bytes

    gib = lambda b: b / 2**30  # noqa: E731
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_arch(arch)
    cfg = dataclasses.replace(full, n_layers=depth)
    lm = get_api(cfg)
    params, dt_init = timed(lambda: lm.init_params(0))
    prompt = prng.randint(prng.PRNGKey(seed), (batch, S17), 0, cfg.vocab_size, device="cuda")
    (logits, cache), dt = timed(lambda: lm.prefill_fn(params, {"tokens": prompt}))
    check(bool(torch.isfinite(logits).all()), f"{label} prefill: a logit is not finite")
    tps = batch * S17 / dt
    print(f"  {label} {cfg.name} at full width, {depth} of its {full.n_layers} layers "
          f"({cfg.first_k_dense} dense; {cfg.n_experts} experts of d_ff {cfg.moe_d_ff}, top-"
          f"{cfg.experts_per_token}, {cfg.n_shared_experts} shared; "
          f"{tree_count_params(params):,} parameters, {tree_size_bytes(params) / 1e9:.2f} GB of "
          f"{cfg.dtype} weights drawn in {dt_init:.1f} s): prefill of {batch} × {S17:,} tokens "
          f"into a bf16 cache in {dt:.2f} s, {tps:,.0f} tokens/s; {card}", flush=True)
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, gen)) for k, v in cache.items()}
    nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
    # each MoE layer's routed ids, a step's layers in order (kept, not read,
    # while the steps run: no sync is added)
    routed, route = [], moe_mod.route

    def logged(*args):
        routed.append(route(*args))
        return routed[-1]

    moe_mod.route = logged
    try:
        _, times = decode_greedy(lm, params, cache, nxt, S17 + 1, gen, label)
    finally:
        moe_mod.route = route
    ms, bound_ms = report_decode(f"{label} {cfg.name} at a {S17 + gen:,}-long bf16 cache, batch "
                                 f"{batch} (every expert's weights read)", batch, times, cache,
                                 params, card)
    routed_ms = _routed_bound(label, cfg, params, cache, [r[0] for r in routed], batch, gen, ms,
                              bound_ms, card)
    del cache, logits, routed
    # prefill then decode against forward over one more token: the forward's
    # capacity is its own token count's, so where a bucket overflows it drops
    # the last token's slots first, which a decode step (cap 8 ≥ B) never
    # does; at capacity factor E/k no slot can drop
    nodrop = get_api(dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token))
    serve_gate(f"{label} {cfg.name} at capacity factor {nodrop.cfg.capacity_factor:g}", nodrop,
               params, prompt[:, :GATE17], prompt[:, GATE17:GATE17 + 1], {}, torch.bfloat16, card)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(8, 33, REQS17)]
    engine_gate(f"{label} {cfg.name} in bf16,", lm, params, prompts, SLOTS17, MAXLEN17, NEW17, card)
    _moe_layer_gate(label, tree_map(lambda t: t[0], params["layers"]["moe"]),
                    min(cfg.n_experts, CPU17_EXPERTS), cfg, card)
    peak = torch.cuda.max_memory_allocated()
    print(f"  {label}: peak memory {gib(peak):.2f} GiB (< {PEAK17_GIB}); {card}", flush=True)
    check(peak < PEAK17_GIB * 2**30, f"{label}: peak memory {gib(peak):.2f} GiB")
    del params, prompt
    torch.cuda.empty_cache()
    return tps, ms, bound_ms, routed_ms


def _routed_bound(label: str, cfg, params, cache, routed, batch: int, gen: int, ms: float,
                  bound_ms: float, card: str) -> float:
    """Decode's byte bound from the experts its steps route to: the cache and
    the weights a step reads once, less each MoE layer's experts that none
    of the step's tokens chose (``routed``: every layer's ids, step by
    step); the median over the steps, in ms."""
    import torch

    from repro_torch.roofline import analysis, hw

    n_moe = cfg.n_layers - cfg.first_k_dense
    check(len(routed) == gen * n_moe, f"{label}: {len(routed)} routings in {gen} decode steps")
    moe_w = params["layers"]["moe"]
    b_expert = sum(moe_w[w][0, 0].numel() * moe_w[w].element_size()
                   for w in ("w_gate", "w_up", "w_down"))
    distinct = [int(torch.unique(ids).numel()) for ids in routed]
    bounds = [analysis.decode_bytes(params, cache, cfg, distinct[t * n_moe:(t + 1) * n_moe])
              / hw.HBM_BW * 1e3 for t in range(gen)]
    routed_ms = float(np.median(bounds))
    print(f"  {label} the experts a decode step routes to: {np.mean(distinct):.2f} distinct of "
          f"{cfg.n_experts} a layer (mean over {gen} steps × {n_moe} MoE layers; at most B·k = "
          f"{batch * cfg.experts_per_token}), {b_expert / 1e6:.2f} MB an expert; byte bound "
          f"reading only those {routed_ms:.3f} ms (median over the steps), {routed_ms / ms:.3f} "
          f"of the step's {ms:.2f} ms (reading every expert: {bound_ms:.3f} ms, "
          f"{bound_ms / ms:.3f}); {card}", flush=True)
    return routed_ms


def _moe_worker(argv) -> None:
    """``python3 chip_smoke.py --moe-worker --coordinator HOST:PORT --out DIR
    [--dist-backend gloo|nccl] --process-id R``: rank R of phase 17 (d)'s
    two ranks (gloo: both on the one card; nccl: card R). Once its group is
    up it warms up on the reduced config and waits for the file DIR/go
    (DIR/stop: it leaves). It runs lm_loss
    and its backward with expert parallelism over make_host_mesh(1, 2),
    then the same on its own (moe_apply_local), and writes the errors, times
    and all-to-all figures to DIR/rank{R}.json."""
    import argparse

    t_start = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--moe-worker", action="store_true")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--dist-backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--process-id", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, SRC)
    import torch

    from repro_torch import cluster
    from repro_torch.cluster.bootstrap import axis_group
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import SyntheticLMSource
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tr
    from repro_torch.models.api import get_api
    from repro_torch.train.trainer import make_dist
    from repro_torch.utils.host import on_device
    from repro_torch.utils.tree import tree_leaves

    cluster.initialize(args.coordinator, 2, args.process_id, backend=args.dist_backend,
                       device="cuda")
    mesh = make_host_mesh(1, 2)
    # a process's first forward+backward carries its one-time costs (≈ 10 s
    # on the card): the reduced config's in bf16, with EP and alone, takes
    # them before the wait, so the timed runs below are warm
    t_ready = time.perf_counter()
    warm_cfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b", reduced=True),
                                   dtype="bfloat16")
    warm = get_api(warm_cfg)
    warm_p = warm.init_params(0)
    warm_b = {k: on_device(v, "cuda") for k, v in
              SyntheticLMSource(warm_cfg.vocab_size, 64, 2, seed=0).batch_for(0).items()}
    warm_leaves = [leaf.requires_grad_(True) for leaf in tree_leaves(warm_p)]
    for d in (make_dist(mesh, warm_cfg), tr.NO_DIST):
        torch.autograd.grad(warm.loss_fn(warm_p, warm_b, d, q_chunk=32, kv_chunk=32)[0],
                            warm_leaves)
    torch.cuda.synchronize()
    del warm_p, warm_b, warm_leaves
    torch.cuda.empty_cache()
    t_warm = time.perf_counter()
    while not os.path.exists(os.path.join(args.out, "go")):
        if os.path.exists(os.path.join(args.out, "stop")):
            cluster.shutdown()
            return
        time.sleep(0.05)
    t_go = time.perf_counter()
    cfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b"), n_layers=DEPTH17D,
                              capacity_factor=CF17D_EP)
    lm = get_api(cfg)
    lm_1 = get_api(dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token))
    params = lm.init_params(0)                 # the same seeded draw on each rank
    batch = {k: on_device(v, "cuda")
             for k, v in SyntheticLMSource(cfg.vocab_size, S17, 1, seed=0).batch_for(0).items()}
    ep = axis_group(mesh, ("model",))
    moe_p = params["layers"]["moe"]
    leaves = [moe_p["w_gate"], moe_p["w_up"], moe_p["w_down"]]

    e_loc = cfg.n_experts // ep.size
    lo, hi = ep.index * e_loc, (ep.index + 1) * e_loc

    def run(d):
        """(loss, aux, the rank's block of each expert leaf's gradient,
        whether the gradient is zero outside it, the logits, s)."""
        for leaf in leaves:
            leaf.requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = lm if d.mesh is not None else lm_1
        loss, met = model.loss_fn(params, batch, d, q_chunk=Q13, kv_chunk=KV13)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for leaf in leaves:
            leaf.requires_grad_(False)
        blocks = [g[:, lo:hi].clone() for g in grads]
        outside = not any(bool(g[:, :lo].any() or g[:, hi:].any()) for g in grads)
        del grads
        with torch.no_grad():
            logits, _ = tr.forward(params, batch["tokens"], model.cfg, d, q_chunk=Q13,
                                   kv_chunk=KV13)
        return float(loss.detach()), float(met["aux"]), blocks, outside, logits, dt

    torch.cuda.reset_peak_memory_stats()
    loss_ep, aux_ep, g_ep, outside, logits_ep, t_ep = run(make_dist(mesh, cfg))
    # then the one-process run (moe_apply_local at capacity factor E/k), each
    # layer's largest expert load counted, one rank at a time: their peaks
    # would add up
    loads, local = [], moe_mod.moe_apply_local

    def counted(p, x, k, cf, stats=None):
        ids = moe_mod.route(p["router"], x, k)[0]
        e = p["router"].shape[1]
        loads.append((int(torch.bincount(ids.reshape(-1), minlength=e).max()),
                      moe_mod.capacity(x.shape[0], k, e, cf)))
        return local(p, x, k, cf, stats)

    moe_mod.moe_apply_local = counted
    for r in range(ep.size):
        if r == ep.index:
            loss_1, aux_1, g_1, _, logits_1, t_1 = run(tr.NO_DIST)
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    moe_mod.moe_apply_local = local
    # the second grouping's capacity, which every expert's load must fit
    tl = S17 // ep.size
    cap_s = moe_mod.capacity(tl, cfg.experts_per_token, ep.size, cfg.capacity_factor)
    cap_e = moe_mod.capacity(ep.size * cap_s, 1, e_loc, cfg.capacity_factor)
    errs = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
            for a, b in zip(g_ep, g_1)]
    scale = float(logits_1.abs().max())
    err_logits = max(float((a.float() - b.float()).abs().max())
                     for a, b in zip(logits_ep.split(512, 1), logits_1.split(512, 1))) / scale
    # the all-to-all of a layer's dispatch: its buffer, timed over gloo
    send = torch.randn((ep.size, cap_s, cfg.d_model), device="cuda").to(torch.bfloat16)
    meta = torch.zeros((ep.size, cap_s, 2), device="cuda")
    times = {}
    for name, buf in (("x", send), ("meta", meta)):
        ts = []
        for _ in range(A2A17_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            moe_mod._a2a(buf, ep.group)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        times[name] = min(ts) * 1e3
    out = dict(rank=args.process_id, index=ep.index, loss_ep=loss_ep, loss_1=loss_1, aux_ep=aux_ep,
               aux_1=aux_1, err_logits=err_logits, err_grads=errs, zero_outside=outside,
               finite=bool(torch.isfinite(logits_ep).all()), t_ep=t_ep, t_1=t_1, loads=loads,
               cap_s=cap_s, cap_e=cap_e, bytes_x=send.numel() * send.element_size(),
               bytes_meta=meta.numel() * meta.element_size(), ms_x=times["x"],
               ms_meta=times["meta"], peak=torch.cuda.max_memory_allocated(),
               ready_s=t_ready - t_start, warm_s=t_warm - t_ready, waited_s=t_go - t_warm,
               run_s=time.perf_counter() - t_go, backend=args.dist_backend)
    with open(os.path.join(args.out, f"rank{args.process_id}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.barrier()
    cluster.shutdown()


def phase17_moe(card: str) -> dict[str, int]:
    """Phase 17 (module docstring): the moe family on the card. Returns the
    kernels' launches on (c)'s training run, read just after its reset."""
    t17 = time.perf_counter()
    print(f"== 17 moe: qwen3-moe-235b-a22b and kimi-k2-1t-a32b served at full width in bf16 "
          f"(random weights from torch.Generator(seed 0); logit tolerance {TOL14} of max |logit|), "
          f"qwen3-moe-235b-a22b trained with CompressConfig(gamma=0.1), moe_apply_ep on 2 gloo "
          f"ranks", flush=True)
    ranks = start_ep_ranks()
    try:
        _serve_moe("(a)", "qwen3-moe-235b-a22b", DEPTH17A, B17A, GEN17A, 4, card)
        _serve_moe("(b)", "kimi-k2-1t-a32b", DEPTH17B, B17B, GEN17B, 5, card)
        launches17 = _train_moe(card)
        _ep_moe(card, ranks)
    finally:
        stop_ep_ranks(ranks)
    print(f"  phase 17: {time.perf_counter() - t17:.1f} s; {card}", flush=True)
    return launches17


def _train_moe(card: str) -> dict[str, int]:
    """Phase 17 (c): qwen3-moe-235b-a22b trained with compression on one
    card; the kernels' launches on its training run."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.grad_compress import CompressConfig
    from repro_torch.data.pipeline import SyntheticLMSource
    from repro_torch.kernels import ops
    from repro_torch.models.api import get_api
    from repro_torch.models.transformer import NO_DIST
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.trainer import TrainerConfig, init_state, make_train_fn
    from repro_torch.utils import prng
    from repro_torch.utils.host import on_device
    from repro_torch.utils.tree import tree_count_params

    gib = lambda b: b / 2**30  # noqa: E731
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_arch("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(full, n_layers=DEPTH17C, n_experts=EXPERTS17C)
    model = get_api(cfg)
    comp = CompressConfig(gamma=0.1)
    tcfg = TrainerConfig(opt=opt_mod.OptConfig(peak_lr=LR13, warmup_steps=1, total_steps=STEPS17C),
                         accum_steps=ACCUM17C, compress=comp, q_chunk=Q13, kv_chunk=KV13)
    state, dt_init = timed(lambda: init_state(model, tcfg, prng.PRNGKey(0), device="cuda"))
    n = tree_count_params(state["params"])
    nc = -(-n // comp.chunk_p)
    fn = make_train_fn(model, tcfg, NO_DIST, prng.PRNGKey(0), device="cuda")
    src = SyntheticLMSource(cfg.vocab_size, S17, B17C, seed=0)
    print(f"  (c) {cfg.name} at full width (d_model {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} KV heads of {cfg.hd}, experts of d_ff {cfg.moe_d_ff}, top-"
          f"{cfg.experts_per_token}, vocab {cfg.vocab_size}) cut to {DEPTH17C} of {full.n_layers} "
          f"layers and {EXPERTS17C} of {full.n_experts} experts: {n:,} {cfg.dtype} parameters, "
          f"{nc:,} chunks of {comp.chunk_p} (m {comp.m}), state drawn in {dt_init:.1f} s; AdamW, "
          f"error feedback; a global batch of {B17C} × {S17} as {ACCUM17C} micro-batches; "
          f"{STEPS17C} steps; {card}", flush=True)
    ops.reset_counts()
    recs = []
    for step in range(STEPS17C):
        k2 = ops.DISPATCH[("hd_precondition", "kernel")]
        (state, met), dt = timed(lambda: fn(state, src.batch_for(step)))
        rec = dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                   wire=float(met["wire_floats"]), s=dt,
                   k2=ops.DISPATCH[("hd_precondition", "kernel")] - k2)
        recs.append(rec)
        print(f"  (c) step {step}: loss {rec['loss']!r}, grad_norm {rec['grad_norm']:.4f}, "
              f"wire_floats {rec['wire']:,.0f}, {dt:.3f} s ({B17C * S17 / dt:,.0f} tokens/s), K2 "
              f"launches {rec['k2']}; {card}", flush=True)
    launches17 = ops.launch_counts()
    # aux is not among a step's metrics under accumulation (the reference
    # returns none there either): read it from the loss function's metrics
    mb = {k: on_device(v[:B17C // ACCUM17C], "cuda") for k, v in src.batch_for(0).items()}
    with torch.no_grad():
        loss, m = model.loss_fn(state["params"], mb, NO_DIST, q_chunk=Q13, kv_chunk=KV13)
    peak = torch.cuda.max_memory_allocated()
    parts = float(m["nll"]) + cfg.router_aux_coef * float(m["aux"])
    print(f"  (c) the loss function's metrics at the last state on a micro-batch of step 0: nll "
          f"{float(m['nll'])!r}, aux {float(m['aux'])!r} (loss {float(loss)!r} = nll + "
          f"{cfg.router_aux_coef}·aux: {parts!r}); s a step {[round(r['s'], 3) for r in recs]}; "
          f"peak memory {gib(peak):.2f} GiB (< {PEAK17_GIB}); launches {launches17}; {card}",
          flush=True)
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in recs),
          "(c): a loss is not finite")
    check(all(r["k2"] == 2 for r in recs) and ("hd_precondition", "ref") not in ops.DISPATCH,
          "(c): K2 did not launch twice a step on its kernel path")
    check(all(r["wire"] == float(np.float32(nc * comp.m)) for r in recs),
          f"(c): wire_floats is not {nc} × {comp.m}")
    check(math.isfinite(float(m["aux"])) and float(m["aux"]) > 0
          and abs(parts - float(loss)) <= 1e-5 * abs(float(loss)),
          "(c): the loss function's aux metric is missing from its loss")
    check(peak < PEAK17_GIB * 2**30, f"(c): peak memory {gib(peak):.2f} GiB")
    del state, fn, mb
    gc.collect()                       # a reference cycle can keep the state past del
    torch.cuda.empty_cache()
    return launches17


def start_ep_ranks(backend: str = "gloo") -> dict:
    """Phase 17 (d)'s two ranks (``_moe_worker``), started in a thread of
    this process: they come up, join their group over ``backend`` and wait
    for :func:`_ep_moe` (or :func:`stop_ep_ranks`)."""
    import threading

    from repro_torch.cluster.bootstrap import free_port, run_ranks

    ranks = {"dir": tempfile.mkdtemp(prefix="moe17-"), "rc": None, "backend": backend}
    cmd = [sys.executable, os.path.abspath(__file__), "--moe-worker", "--coordinator",
           f"127.0.0.1:{free_port()}", "--out", ranks["dir"], "--dist-backend", backend]
    ranks["thread"] = threading.Thread(target=lambda: ranks.update(rc=run_ranks(cmd, 2)))
    ranks["thread"].start()
    return ranks


def stop_ep_ranks(ranks: dict) -> None:
    """Let ranks that still wait leave, wait for them and remove their
    directory."""
    if not os.path.exists(os.path.join(ranks["dir"], "go")):
        open(os.path.join(ranks["dir"], "stop"), "w").close()
    ranks["thread"].join()
    shutil.rmtree(ranks["dir"], ignore_errors=True)


def _ep_moe(card: str, ranks: dict) -> None:
    """Phase 17 (d): moe_apply_ep on the 2 ranks of :func:`start_ep_ranks`
    (``_moe_worker``), released once this process has freed the card."""
    import torch

    gib = lambda b: b / 2**30  # noqa: E731
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  (d) this process holds {gib(torch.cuda.memory_reserved()):.2f} GiB of the card "
          f"({gib(torch.cuda.memory_allocated()):.2f} GiB allocated) while its 2 ranks run",
          flush=True)
    t0 = time.perf_counter()
    open(os.path.join(ranks["dir"], "go"), "w").close()
    ranks["thread"].join()
    t_ranks = time.perf_counter() - t0
    check(ranks["rc"] == 0, f"(d): a rank exited {ranks['rc']}")
    outs = [json.load(open(os.path.join(ranks["dir"], f"rank{r}.json"))) for r in (0, 1)]
    for r in outs:
        err_loss = abs(r["loss_ep"] - r["loss_1"]) / abs(r["loss_1"])
        err_aux = abs(r["aux_ep"] - r["aux_1"]) / abs(r["aux_1"])
        print(f"  (d) rank {r['rank']} (experts {r['index'] * 64}–{r['index'] * 64 + 63}): "
              f"lm_loss with expert parallelism {r['loss_ep']!r} against one process's "
              f"{r['loss_1']!r} ({err_loss:.3g} relative, ≤ {TOL17D_LOSS}), aux {err_aux:.3g}; "
              f"logits {r['err_logits']:.4f} of max |logit|, the rank's block of w_gate/w_up/"
              f"w_down's gradients {[round(e, 5) for e in r['err_grads']]} of their largest "
              f"(≤ {TOL17D}), zero outside it {r['zero_outside']}; the largest expert load of "
              f"the {S17} tokens' slots and the one process's capacity (capacity factor "
              f"E/k) {r['loads']}, EP's second grouping's capacity {r['cap_e']} (capacity factor "
              f"{CF17D_EP}, its first {r['cap_s']}); forward+backward {r['t_ep']:.2f} s with EP, "
              f"{r['t_1']:.2f} s alone; "
              f"the dispatch's all-to-all of ({2}, {r['cap_s']}, 4096) bf16 over "
              f"{r['backend']}, {r['bytes_x']:,} bytes a rank ({r['bytes_x'] // 2:,} cross), "
              f"{r['ms_x']:.1f} ms; its metadata {r['bytes_meta']:,} bytes, {r['ms_meta']:.1f} ms "
              f"(min of {A2A17_REPS}); peak {gib(r['peak']):.2f} GiB; up {r['ready_s']:.1f} s after "
              f"its start, warmed up in {r['warm_s']:.1f} s, waited {r['waited_s']:.1f} s, "
              f"ran {r['run_s']:.1f} s; {card}", flush=True)
        check(r["finite"] and err_loss <= TOL17D_LOSS and err_aux <= 1e-5
              and r["err_logits"] <= TOL17D and max(r["err_grads"]) <= TOL17D
              and r["zero_outside"] and all(mx <= min(cap, r["cap_e"]) for mx, cap in r["loads"]),
              f"(d): rank {r['rank']}'s expert-parallel run differs from one process's")
    # the half of each buffer that leaves the rank: dispatch, metadata, return
    a_layer = outs[0]["bytes_x"] + outs[0]["bytes_meta"] // 2
    print(f"  (d) a layer's forward all-to-alls send {a_layer:,} bytes a rank to the other "
          f"(dispatch, metadata, return; the backward and the recomputation as many again); the 2 "
          f"ranks took {t_ranks:.1f} s after their release (their start overlapped (a)–(c)); "
          f"{card}", flush=True)


def _cells18():
    """Phase 18's gemma3-1b cells: (label, ShapeConfig, TrainerConfig)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.grad_compress import CompressConfig
    from repro_torch.train.trainer import TrainerConfig

    return [("train", ShapeConfig("train", SEQ13, BATCH13, "train"),
             TrainerConfig(accum_steps=ACCUM13, compress=CompressConfig(gamma=0.1), q_chunk=Q13,
                           kv_chunk=KV13)),
            ("prefill", ShapeConfig("prefill", S14A, B14A, "prefill"), TrainerConfig()),
            ("decode", ShapeConfig("decode", S14A, B14B, "decode"), TrainerConfig())]


def count18(cfg, shape, tcfg, device: str):
    """The cell's step run once on ``device`` under an OpCounter: (its
    summary, the step, its inputs) — ``trainer.lower_cell``'s step and
    inputs, the inputs' storages counted live from the start."""
    from repro_torch.roofline.counter import OpCounter
    from repro_torch.train.trainer import lower_cell

    step, args, _ = lower_cell(cfg, shape, None, tcfg, device=device)
    with OpCounter(device) as c:
        c.track(args)
        step(*args)
    return c.summary(), step, args


def phase18_roofline(card: str) -> dict[str, int]:
    """Phase 18 (module docstring): the dry-run's yardstick on the card.
    Returns the kernels' launches over the phase's runs on the card."""
    t18 = time.perf_counter()
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.roofline import analysis, hw

    print("== 18 roofline: the meta device's count against the card's", flush=True)
    props = torch.cuda.get_device_properties(0)
    print(f"  (a) {props.name}: {props.multi_processor_count} SMs, {props.total_memory:,} bytes "
          f"({props.total_memory / hw.HBM_BYTES:.4f} of roofline.hw's {hw.HBM_BYTES:,}); hw: "
          f"{hw.SM_COUNT} SMs, bf16 {hw.PEAK_FLOPS_BF16:.3g}, float32 {hw.PEAK_FLOPS_FP32:.3g} "
          f"FLOP/s, {hw.HBM_BW:.3g} B/s; {card}", flush=True)
    check("H100" in props.name, f"the card is {props.name}, not an H100: roofline.hw is the H100's")
    check(props.multi_processor_count == hw.SM_COUNT,
          f"{props.multi_processor_count} SMs, roofline.hw says {hw.SM_COUNT}")
    check(abs(props.total_memory - hw.HBM_BYTES) <= 0.05 * hw.HBM_BYTES,
          f"{props.total_memory:,} bytes of device memory, roofline.hw says {hw.HBM_BYTES:,}")

    cfg = get_arch("gemma3-1b")
    depths = analysis.probe_depths(cfg)
    launches = {name: 0 for name in ops.WRAPPERS}
    for label, shape, tcfg in _cells18():
        probes = []
        for d in depths:
            cd = analysis._probe_cfg(cfg, d)
            t0 = time.perf_counter()
            on_meta = count18(cd, shape, tcfg, "meta")[0]
            t_meta = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_counts()
            t0 = time.perf_counter()
            on_card, step, args = count18(cd, shape, tcfg, "cuda")
            torch.cuda.synchronize()
            t_card = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            # the step again outside the counting mode (the counted run warmed it
            # up), timed by CUDA events: once for training, the median of 3
            # for prefill and decode, whose single steps vary by 20-40 %
            times = []
            for _ in range(1 if label == "train" else 3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                step(*args)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            ms = float(np.median(times))
            for name, c in ops.launch_counts().items():
                launches[name] += c
            del step, args
            terms = analysis.roofline_terms({**on_card, "wire_bytes": 0.0}, 1, cd, shape)
            t_bound = max(terms["t_compute_s"], terms["t_memory_s"])
            mfu = terms["model_flops"] / (hw.PEAK_FLOPS_BF16 * ms / 1e3)
            print(f"  (b) {label} {shape.global_batch} × {shape.seq_len} at depth {d}: flops by dtype "
                  f"{on_meta['flops_by_dtype']} on meta, the card's equal: "
                  f"{on_card['flops_by_dtype'] == on_meta['flops_by_dtype']}; bytes "
                  f"{on_meta['bytes']:,} (equal: {on_card['bytes'] == on_meta['bytes']}); kernels "
                  f"{on_meta['kernels']} (equal: {on_card['kernels'] == on_meta['kernels']}); peak on "
                  f"meta {on_meta['peak_bytes'] / 2**30:.3f} GiB, the card's counter "
                  f"{on_card['peak_bytes'] / 2**30:.3f} GiB, torch.cuda.max_memory_allocated "
                  f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held before "
                  f"({on_meta['peak_bytes'] / peak:.4f} of it); counted in {t_meta:.1f} s on meta, "
                  f"{t_card:.1f} s on the card", flush=True)
            print(f"      the step {ms:.2f} ms (CUDA events, outside the counting mode; "
                  f"{len(times)} run(s): {np.round(times, 2).tolist()}): bound "
                  f"{t_bound * 1e3:.2f} ms (compute {terms['t_compute_s'] * 1e3:.2f}, memory "
                  f"{terms['t_memory_s'] * 1e3:.2f}; {terms['dominant']}), {t_bound * 1e3 / ms:.4f} "
                  f"of it; model_flops {terms['model_flops']:.4g}, mfu {mfu:.4f} (over "
                  f"{hw.PEAK_FLOPS_BF16:.3g} FLOP/s × the step); {card}", flush=True)
            check(on_card["flops_by_dtype"] == on_meta["flops_by_dtype"],
                  f"18 {label} depth {d}: flops by dtype differ between meta and the card")
            check(on_card["bytes"] == on_meta["bytes"],
                  f"18 {label} depth {d}: bytes differ between meta and the card")
            check(on_card["kernels"] == on_meta["kernels"],
                  f"18 {label} depth {d}: kernel counts differ between meta and the card")
            check(abs(on_meta["peak_bytes"] - peak) <= 0.1 * peak,
                  f"18 {label} depth {d}: the meta high-water mark {on_meta['peak_bytes']:,} is "
                  f"more than 10 % off the card's {peak:,}")
            if label == "train":
                check(on_meta["kernels"] == {"hd_precondition": 2},
                      f"18 train depth {d}: K2 is not counted twice a step: {on_meta['kernels']}")
            probes.append(on_meta)
            gc.collect()
            torch.cuda.empty_cache()
        full = cfg.n_layers - cfg.first_k_dense
        per_dev = {k: analysis.extrapolate(probes, *depths, full, k)[0] for k in ("flops", "bytes")}
        per_dev["flops_by_dtype"] = {
            dt: analysis.extrapolate([p["flops_by_dtype"] for p in probes], *depths, full, dt)[0]
            for dt in probes[0]["flops_by_dtype"]}
        per_dev["wire_bytes"] = 0.0
        terms = analysis.roofline_terms(per_dev, 1, cfg, shape)
        print(f"  (b) {label} extrapolated to {cfg.n_layers} layers: t_compute "
              f"{terms['t_compute_s'] * 1e3:.2f} ms, t_memory {terms['t_memory_s'] * 1e3:.2f} ms, "
              f"dominant {terms['dominant']}, model_flops {terms['model_flops']:.4g}", flush=True)
    print(f"  launches in phase 18: {launches}")
    print(f"  phase 18: {time.perf_counter() - t18:.1f} s; {card}", flush=True)
    return launches


def main() -> None:
    t_script = time.perf_counter()
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
    from repro_torch.core import kmeans as kmeans_mod
    from repro_torch import lowrank
    from repro_torch.core.sampling import SparseRows, sample_indices
    from repro_torch.data.pipeline import VectorStreamSource
    from repro_torch.core import sketch as sketch_mod
    from repro_torch.kernels import _build, fwht, ops, ref
    from repro_torch.kernels import sparse_assign as sa_mod
    from repro_torch.kernels import spmm as spmm_mod
    from repro_torch.roofline import kernels as rk
    from repro_torch.stream import StreamKMeansConfig
    from repro_torch.stream import accumulators as kmeans_acc
    from repro_torch.train import checkpoint as ckpt_mod
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
        """``b``: the function's ``roofline.kernels`` model, its bound and
        (a diagnostic) the bytes the current schedule moves."""
        check(err <= tol, f"{name}: error {err:.3g} above tolerance {tol:g}")
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"  {name}: err {err:.3g} (tol {tol:g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"one library call {lib}, bound {b.ms:.4f} ms ({b.bound}; {b.name} model; the "
              f"schedule moves {b.schedule_bytes / b.hbm_bytes:.2f}× its {b.hbm_bytes / 1e6:.1f} MB)")

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

    def by_pass_total(fn, reps):
        """Device ms a call of ``fn`` takes on the card, by torch.profiler: each
        kernel's mean over the launches the trace kept (it can drop some, which
        a sum over ``reps`` calls would count as zero), summed over the
        kernels; for calls that launch each of their kernels once. NaN (not
        measured) where two traces in turn kept no launch at all."""
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            kept = [e.self_device_time_total / e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.count]
            if kept:
                return sum(kept) / 1e3
        return math.nan

    # K1 sketch_fused at the stream's shape, at its p = 2^15 ceiling, and at a ragged n
    for n, p, mm in [(BATCH, P, m), (1024, 1 << 15, round(GAMMA * (1 << 15))), (777, P, m)]:
        x, s, idx = sketch_case(n, p, mm, seed=n)
        got = ops.sketch_fused(x, s, idx)
        torch.cuda.synchronize()
        err = (got - ref.ref_sketch_fused(x, s, idx)).abs().max().item()
        ms = time_ms(lambda: ops.sketch_fused(x, s, idx), 20)
        plain_ms = time_ms(lambda: ref.ref_sketch_fused(x, s, idx), 5)
        b = rk.sketch_fused_roofline(n, p, mm)
        report(f"K1 sketch_fused ({n}, {p}, m={mm})", err, 1e-5, ms, plain_ms, b)
        if (n, p) == (BATCH, P):
            print(f"    device time alone (torch.profiler) "
                  f"{by_pass_total(lambda: ops.sketch_fused(x, s, idx), 20):.4f} ms")
            entries["sketch_fused"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                           bound_ms=b.ms, bound_by=b.bound, library_ms=None)
    del x, s, idx, got

    # K2 hd_precondition, both sign modes, at the finalize's unmix (10, 16384),
    # a batch (4096, 16384) and cov_original's (16384, 16384): bit-equal to the
    # plain butterfly on the schedule split_plan picks and on the others it
    # could; each timed back to back (CUDA events around many calls: host and
    # device) and by its device time alone (torch.profiler). One PyTorch call
    # for the same function is x @ (H·D) or x @ (D·H)
    eye = torch.eye(P, device=dev)
    hmat = ref.ref_hd_precondition(eye, torch.ones(P, device=dev))   # H, symmetric
    del eye
    sms = spmm_mod.sm_count(dev)
    for n in (K, BATCH, P):
        gen = torch.Generator(device=dev).manual_seed(n)
        x = torch.randn((n, P), device=dev, generator=gen)
        s = prng.rademacher(prng.fold_in(key, 7 + n), (P,), device=dev)
        chosen = fwht.split_plan(n, P, sms, c_max)
        others = [c for c in ([(8, 11), (4, 12), (2, 13)] if n < sms else [(2, 13), (4, 12)])
                  if c[0] <= c_max]
        b = rk.fwht_roofline(n, P)
        for after in (False, True):
            ops.reset_counts()
            got = ops.hd_precondition(x, s, signs_after=after)
            torch.cuda.synchronize()
            check(ops.launch_counts()["hd_precondition"] == 1, f"K2 at ({n}, {P}) did not launch")
            want = ref.ref_hd_precondition(x, s, after)
            check(torch.equal(got, want), f"K2 at ({n}, {P}) signs_after={after} on its plan "
                                          f"{chosen} is not bit-equal to the plain butterfly")
            err = (got - want).abs().max().item()
            del want
            # back to back: each way of calling it, in 5 interleaved rounds,
            # the median (a shared host's share moves from round to round):
            # the wrapper on its plan, then every plan through fwht._rows
            plans = [chosen] + [pl for pl in [None] + others if pl != chosen]
            calls = {"ops": lambda: ops.hd_precondition(x, s, signs_after=after)}
            for pl in plans:
                alt = fwht._rows(x, s, after, pl)
                check(torch.equal(alt, got), f"K2 at ({n}, {P}) on plan {pl} is not bit-equal")
                calls[pl] = (lambda pl=pl: fwht._rows(x, s, after, pl))
            if n < sms and after:
                # the host's layers: the C entry point alone with its arguments
                # ready, the launcher, the kernel wrapper, the dispatch
                lib = _build.library("hadamard")
                out = torch.empty_like(x)
                raw = (x.data_ptr(), s.data_ptr(), out.data_ptr(), n, P.bit_length() - 1, 1,
                       fwht.scale_for(P), chosen[0].bit_length() - 1, chosen[1],
                       _build.stream_of(x))
                calls["raw"] = lambda: lib.hd_precondition_f32(*raw)
                calls["fwht"] = lambda: fwht.hd_precondition(x, s, signs_after=after)
            reps = 200 if n < sms else 20
            rounds = {k_: [] for k_ in calls}
            for _ in range(5):
                for k_, fn in calls.items():
                    rounds[k_].append(time_ms(fn, reps))
            med = {k_: float(np.median(v)) for k_, v in rounds.items()}
            ms = med["ops"]
            dev_ms = by_pass_total(calls["ops"], 20)
            plain_ms = time_ms(lambda: ref.ref_hd_precondition(x, s, after), 3)
            dense = hmat * s[None, :] if after else s[:, None] * hmat     # H·D or D·H
            lib_ms = time_ms(lambda: torch.matmul(x, dense), 3)
            del dense
            report(f"K2 hd_precondition ({n}, {P}) signs_after={after}, plan {chosen}, bit-equal",
                   err, 0.0, ms, plain_ms, b, lib_ms)
            setter = ("not measured" if math.isnan(dev_ms)
                      else "the host" if ms > 1.5 * dev_ms else "the device")
            print(f"    device time alone (torch.profiler) {dev_ms:.4f} ms, back to back {ms:.4f} ms "
                  f"(median of 5 rounds of {reps}; rounds {np.round(rounds['ops'], 4).tolist()}): "
                  f"what sets the time: {setter}; {b.ms / dev_ms:.2f} of its bound on the device")
            probes = [f"{pl}: {med[pl]:.4f} / {by_pass_total(calls[pl], 20):.4f}" for pl in plans]
            print(f"    every schedule, bit-equal; back to back (median) / device ms: {'; '.join(probes)}")
            if "raw" in med:
                print(f"    the host's layers, back to back (median ms a call): the C entry point "
                      f"alone {med['raw']:.4f}, fwht._rows {med[chosen]:.4f}, fwht.hd_precondition "
                      f"{med['fwht']:.4f}, ops.hd_precondition {med['ops']:.4f}")
                del out
            if n == K and after:
                entries["hd_precondition"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                                  bound_ms=b.ms, bound_by=b.bound, library_ms=lib_ms)
            del got
        del x, s
    del hmat
    torch.cuda.empty_cache()

    # K4 sparse_assign at every launch shape of both paths (each path's p and
    # m): a step's r = 3 sets of K = 10; K-means++'s candidates (r = 1,
    # K = 2 + ⌈ln 10⌉ = 5) and first center (r = 1, K = 1); and r·K = 48 > 32
    # slots. Ties planted where K > 1: two equal centers, rows on them
    m_lr = round(GAMMA * P_LR)
    for p, mm in [(P, m), (P_LR, m_lr)]:
        idx = sample_indices(prng.fold_in(key, 12 + p), BATCH, p, mm, device=dev)
        vals0 = torch.from_numpy(rng.normal(size=(BATCH, mm)).astype(np.float32)).to(dev)
        for r, kk in [(N_INIT, K), (1, K), (1, 5), (1, 1), (3, 16)]:
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
            b = rk.sparse_assign_roofline(BATCH, mm, r, kk, p)
            report(f"K4 sparse_assign (n={BATCH}, m={mm}, r={r}, K={kk}, p={p}), ties planted, "
                   f"relative distance", rel, 1e-5, ms, plain_ms, b)
            if (p, r, kk) == (P, N_INIT, K):
                entries["sparse_assign"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                                bound_ms=b.ms, bound_by=b.bound, library_ms=None)
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
            b = rk.fwht_roofline(n, p)
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
                                  f"(p={p}) {ms:.4f} ms, {b.ms / ms:.2f} of its bound")
            if (n, p, after) == (PCA_K, P_LR, True):     # the unmix that phase 7 launches
                print(f"    device time alone (torch.profiler) "
                      f"{by_pass_total(lambda: ops.hd_precondition(x, s, signs_after=after), 20):.4f} ms")
                entries["hd_precondition_chunked"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b.ms, bound_by=b.bound,
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
        b = rk.sketch_fused_roofline(n, p, mm)
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
                                                   bound_ms=b.ms, bound_by=b.bound, library_ms=None)
        del x, s, idx, got, again
    torch.cuda.empty_cache()

    def transposed_as_buckets(vals, idx, p):
        """K6's transposition is column_buckets' stable sort, bit for bit."""
        pairs, starts = spmm_mod.transpose_columns(vals, idx, p)
        order, want_starts = spmm_mod.column_buckets(idx, p)
        return (torch.equal(starts, want_starts) and torch.equal(pairs[:, 0], order // idx.shape[1])
                and torch.equal(pairs[:, 1].view(torch.float32), vals.reshape(-1)[order.long()]))

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
            b_ys = rk.spmm_t_roofline(n, m_lr, P_LR, ell, col_sums=True)
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
                  f"{b_ys.ms:.4f} ms, {b_ys.bound}); the walk fed by column_buckets {old_ms:.4f} ms, "
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
        b_t = rk.spmm_roofline(n, m_lr, P_LR, ell)
        b_y = rk.spmm_t_roofline(n, m_lr, P_LR, ell)
        tol_t, tol_y = 1e-5 * t_ref.abs().max().item(), 1e-5 * y_ref.abs().max().item()
        report(f"K5 spmm (n={n}, m={m_lr}, p={P_LR}, l={ell}), tol 1e-5 of max |plain|",
               err_t, tol_t, ms_t, plain_t, b_t, lib_t)
        report(f"K6 spmm_t (n={n}, m={m_lr}, p={P_LR}, l={ell}), tol 1e-5 of max |plain|",
               err_y, tol_y, ms_y, plain_y, b_y, lib_y)
        if main:
            entries["spmm"] = dict(max_abs_err=err_t, ms=ms_t, plain_ms=plain_t, bound_ms=b_t.ms,
                                   bound_by=b_t.bound, library_ms=lib_t)
            entries["spmm_t"] = dict(max_abs_err=err_y, ms=ms_y, plain_ms=plain_y,
                                     bound_ms=b_y.ms, bound_by=b_y.bound, library_ms=lib_y)
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

    # the front door: fit_many(Plan(backend="batch", gamma=0.1), [mean, PCA(4),
    # K-means(4)]) on 2000 rows of p = 1000 near 4 centers along planted
    # directions of distinct weight (so the top eigenpairs are well apart)
    rng4 = np.random.default_rng(4)
    u4, _ = np.linalg.qr(rng4.normal(size=(1000, 4)))
    lab4 = rng4.integers(0, 4, 2000)
    x4 = (5 * np.array([9.0, 6.0, 4.0, 2.5])[lab4, None] * u4.T[lab4]
          + 0.5 * rng4.normal(size=(2000, 1000))).astype(np.float32)

    def front(device):
        plan = api.Plan(backend="batch", gamma=0.1)
        cons = [api.SparsifiedMean(plan, key=3, device=device),
                api.SparsifiedPCA(4, plan, key=3, device=device),
                api.SparsifiedKMeans(4, plan, key=3, device=device)]
        api.fit_many(plan, cons, x4)
        return cons

    ops.reset_counts()
    (mean_g, pca_g, km_g), (mean_c, pca_c, km_c) = front("cuda"), front("cpu")
    counts = ops.launch_counts()
    check(all(counts[name] > 0 for name in PATH8),
          f"the front door on the card did not launch every kernel of its path: {counts}")
    check(torch.equal(km_g.labels_.cpu(), km_c.labels_) and km_g.n_iter_ == km_c.n_iter_,
          "Lloyd's labels or iterations differ between the card and the CPU")
    comps_g, comps_c = pca_g.components_.cpu().numpy(), pca_c.components_.numpy()
    comps_g = comps_g * np.sign(np.sum(comps_g * comps_c, axis=1, keepdims=True))
    for name, a, b_, rtol in [("mean", mean_g.mean_, mean_c.mean_, 1e-5),
                              ("PCA eigenvalues", pca_g.explained_variance_,
                               pca_c.explained_variance_, 1e-5),
                              ("PCA components (signs aligned)", comps_g, comps_c, 0),
                              ("K-means centers", km_g.centers_, km_c.centers_, 1e-5)]:
        a = a.cpu().numpy() if torch.is_tensor(a) else a
        b_ = b_.numpy() if torch.is_tensor(b_) else b_
        print(f"  front door {name}: max |card - cpu| {np.abs(a - b_).max():.3g} "
              f"(rtol {rtol:g}, atol 1e-5)")
        check(np.allclose(a, b_, rtol=rtol, atol=1e-5), f"front door {name} differs between the "
                                                         f"card and the CPU")
    print(f"  front door: Lloyd's labels equal on the card and the CPU, {km_g.n_iter_} iterations; "
          f"launches on the card {counts}")
    del mean_g, pca_g, km_g, mean_c, pca_c, km_c

    # refinement: the engine's replay (low-rank with K-means) and fit_refine
    # (PCA, minibatch K-means) on the card against the same on the CPU
    def small_refine(device):
        plan = api.Plan(backend="stream", gamma=0.1, batch_size=64, cov_path="lowrank", rank=16)
        eng = api.make_engine(plan, 1000, prng.PRNGKey(3), VectorStreamSource(p=1000, batch=64, seed=0),
                              kmeans=StreamKMeansConfig(k=4, n_init=2), device=device)
        eng.run(3)
        res = eng.replay(3, passes=2)
        s = eng._sketch_local(torch.from_numpy(VectorStreamSource(p=1000, batch=64, seed=0).batch_at(9))
                              .to(device), 9, 0)
        labels = kmeans_acc.kmeans_assign(res.centers_pre, s)
        plan_e = plan.replace(batch_size=200)
        pca = api.SparsifiedPCA(4, plan_e, key=3, device=device).fit_refine(x4, passes=2)
        km = api.SparsifiedKMeans(4, plan_e.replace(cov_path="dense", rank=None), key=3,
                                  algorithm="minibatch", device=device).fit_refine(x4, passes=2)
        return res, labels, pca, km

    ops.reset_counts()
    (res_g, lab_g, pca_g, km_g), (res_c, lab_c, pca_c, km_c) = small_refine("cuda"), small_refine("cpu")
    counts = ops.launch_counts()
    check(all(counts[name] > 0 for name in ("sketch_fused", "hd_precondition", "sparse_assign",
                                            "spmm", "spmm_t", "transpose_columns")),
          f"the refinement on the card did not launch every kernel of its path: {counts}")
    s_replay = subspace_sine(res_g.cov_lowrank.top(4)[0], res_c.cov_lowrank.top(4)[0])
    s_pca = subspace_sine(pca_g.components_, pca_c.components_)
    print(f"  replay(passes=2) at p=1000: refined top-4 subspace card vs cpu, sine {s_replay:.3g}; "
          f"fit_refine(passes=2): PCA sine {s_pca:.3g} (both ≤ 1e-5); refined labels equal: replay "
          f"{torch.equal(lab_g.cpu(), lab_c)}, minibatch K-means "
          f"{torch.equal(km_g.predict(x4).cpu(), km_c.predict(x4))}; reassigned by the rebuilds "
          f"{km_g.refine_reassign_counts_.tolist()} (cpu {km_c.refine_reassign_counts_.tolist()})")
    check(s_replay <= 1e-5 and s_pca <= 1e-5, "refined subspaces differ between the card and the CPU")
    check(torch.equal(lab_g.cpu(), lab_c) and torch.equal(km_g.predict(x4).cpu(), km_c.predict(x4)),
          "refined labels differ between the card and the CPU")
    check(res_g.refine_reassigned == res_c.refine_reassigned and np.array_equal(
        km_g.refine_reassign_counts_, km_c.refine_reassign_counts_),
        "refinement reassignment counts differ between the card and the CPU")
    del res_g, lab_g, pca_g, km_g, res_c, lab_c, pca_c, km_c

    train_parity()
    serve_parity()
    family_parity()
    dp_parity()

    # ------------------------------------------------------------------ 5 main
    print(f"== 5 main path: p={P}, {BATCH} rows a step, {STEPS} steps, K={K}, r={N_INIT}", flush=True)
    # its batches are kept for phase 9, which streams the same (seed, step)s
    src = _Memo(VectorStreamSource(p=P, batch=BATCH, seed=0))
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
    cosines = np.linalg.svd(q.T @ src.source._u.astype(np.float64), compute_uv=False)
    sine = float(np.sqrt(max(0.0, 1.0 - cosines.min() ** 2)))
    evals = pca.eigenvalues.cpu().numpy()
    planted = src.source._lam.astype(np.float64) ** 2
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
    t_update = t_dev / 3 * 1e3
    del state, x
    res5 = {name: getattr(res, name) for name in ("mean", "cov", "centers")}   # phase 9's reference

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
        src.source.batch_at(step)
    print(f"  host source batch_at ({BATCH}, {P}): {(time.perf_counter() - t0) / 3 * 1e3:.1f} ms")
    # the folds that repeat bit for bit, a step at phase 5's shapes, against
    # the float scatter-adds (index_add_, atomics on the card) they replace;
    # each held against its plain version on the same inputs
    idx5 = sample_indices(key, BATCH, P, m, device=dev)
    vals5 = torch.randn((BATCH, m), device=dev)
    lab5 = torch.randint(0, K, (N_INIT, BATCH), device=dev, dtype=torch.int32)
    w5 = SparseRows(vals5, idx5, P).to_dense()
    cs, cs_plain = ops.column_sums(vals5, idx5, P), ref.ref_column_sums(vals5.cpu(), idx5.cpu(), P)
    err_cs = max((a.cpu() - b).abs().max().item() / b.abs().max().item() for a, b in zip(cs, cs_plain))
    err_ws = (w5.sum(0).cpu() - cs_plain[0]).abs().max().item() / cs_plain[0].abs().max().item()
    km, km_plain = (ops.cluster_sums(vals5, idx5, lab5, K, P),
                    ref.ref_cluster_sums(vals5.cpu(), idx5.cpu(), lab5.cpu(), K, P))
    km_same = all(torch.equal(a.cpu(), b) for a, b in zip(km, km_plain))
    print(f"  K6's column sums (Σv, Σv²) at ({BATCH}, {m}, p={P}): |err|/max against the CPU's "
          f"scatter-add {err_cs:.3g} (1e-5); the dense batch's column sums {err_ws:.3g} (1e-5); the "
          f"r={N_INIT} K-means sums and counts bit-equal to the CPU's scatter-add: {km_same}")
    check(err_cs <= 1e-5 and err_ws <= 1e-5, "a column sum is off its plain version")
    check(km_same, "the r-hypothesis K-means sums differ from their plain version")
    del cs, cs_plain, km, km_plain
    costs = [("Σw on the dense path: the dense batch's column sums",
              time_ms(lambda: w5.sum(0), 10), "index_add_",
              time_ms(lambda: ref.ref_column_sums(vals5, idx5, P), 10)),
             ("Σw elsewhere (compact path, FD): K6's column sums",
              time_ms(lambda: ops.column_sums(vals5, idx5, P), 10), "index_add_",
              time_ms(lambda: ref.ref_column_sums(vals5, idx5, P), 10)),
             (f"the K-means sums of r={N_INIT} hypotheses: K6's walk over {N_INIT * K} label "
              f"columns and the integer histogram",
              time_ms(lambda: ops.cluster_sums(vals5, idx5, lab5, K, P), 10),
              "index_add_ of sums and counts",
              time_ms(lambda: ref.ref_cluster_sums(vals5, idx5, lab5, K, P), 10))]
    del w5
    print(f"  the repeatable folds a step ({BATCH} rows, m={m}, p={P}) beside the device update "
          f"({t_update:.1f} ms; 1 % = {t_update / 100:.2f} ms):")
    for name, t_new, old, t_old in costs:
        flag = "  ABOVE 1 % of the update" if t_new - t_old > t_update / 100 else ""
        print(f"    {name}: {t_new:.3f} ms, against {old} {t_old:.3f} ms: {t_new - t_old:+.3f} ms{flag}")
    # the compact covariance on each side of COMPACT_KEYED_FILL: the sum by
    # key at a fill the path exists for, the chunked products at phase 5's;
    # each repeated bit for bit and against the n·m² scatter-add it replaces
    # (timed on at most 1024 rows and scaled)
    for gamma_c in (0.005, GAMMA):
        m_c = round(gamma_c * P)
        idx_c = sample_indices(key, BATCH, P, m_c, device=dev)
        vals_c = torch.randn((BATCH, m_c), device=dev)
        keyed = m_c <= estimators.COMPACT_KEYED_FILL * P
        route = "summed by key (sort, K6's segment walk)" if keyed else "chunked fp32 products"
        k6 = spmm_mod.spmm_t.launches
        first = estimators._scatter_outer(vals_c, idx_c, P)
        walked = spmm_mod.spmm_t.launches > k6
        again = estimators._scatter_outer(vals_c, idx_c, P)
        rows_p = min(BATCH, 1024)
        plain_c = estimators._scatter_outer_plain(vals_c[:rows_p], idx_c[:rows_p], P)
        part = estimators._scatter_outer(vals_c[:rows_p], idx_c[:rows_p], P)
        err_c = (part - plain_c).abs().max().item() / plain_c.abs().max().item()
        del part, plain_c
        t_c = time_ms(lambda: estimators._scatter_outer(vals_c, idx_c, P), 3, warmup=1)
        t_c_plain = time_ms(lambda: estimators._scatter_outer_plain(vals_c[:rows_p], idx_c[:rows_p], P),
                            2, warmup=1) * BATCH / rows_p
        same_c = torch.equal(first, again)
        print(f"    the compact covariance at m={m_c} (m/p={m_c / P:.4f}), {route}: {t_c:.2f} ms "
              f"(the dense path's product {gemm:.2f} ms); the n·m² scatter-add it replaces "
              f"{t_c_plain:.2f} ms (timed on {rows_p} rows, scaled); repeats bit for bit {same_c}; "
              f"|err|/max against the scatter-add on {rows_p} rows {err_c:.3g} (1e-5)")
        check(same_c, f"the compact covariance at m={m_c} does not repeat bit for bit")
        check(err_c <= 1e-5, f"the compact covariance at m={m_c} is off its plain version")
        check(walked == keyed, f"the compact covariance at m={m_c} took the wrong route")
        del idx_c, vals_c, first, again
    del idx5, vals5, lab5
    memo5 = src          # phase 5's batches, for phase 9
    del eng, res, pca, src
    torch.cuda.empty_cache()

    # -------------------------------------------------------------- 7 lowrank
    print(f"== 7 the low-rank path: p={P_LR}, l={ELL}, {BATCH} rows a step, {STEPS_LR} steps, "
          f"K={K}, r={N_INIT}", flush=True)
    # its first two batches are kept for phase 8's low-rank estimator
    src = _Memo(VectorStreamSource(p=P_LR, batch=BATCH, seed=0))
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
    # the planted directions the range-finder resolves at each reading; their
    # eigenvalues' errors are of the noise edge's own size, not a fraction of
    # λ², so the 10 % eigenvalue gate is read at the full n only
    for n_rows, comps_n, evals_n in readings:
        planted_gates(comps_n, evals_n, n_rows, P_LR, src.source._u, src.source._lam, ELL, "low-rank",
                      eigenvalues=n_rows == rows)
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

    # ------------------------------------------------------------ 8 front door
    print(f"== 8 the front door at full width: p={P}, {STEPS * BATCH} rows on the card, "
          f"Plan(gamma={GAMMA}, batch_size={BATCH}), batch then stream", flush=True)
    memo7 = src
    memo7.cache = {k: v for k, v in memo7.cache.items() if k[0] < 2}
    del src
    t8 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n8, m = STEPS * BATCH, round(GAMMA * P)
    src = VectorStreamSource(p=P, batch=BATCH, seed=0)      # its planted U and λ
    gen = torch.Generator(device=dev).manual_seed(8)
    u8, lam8 = torch.from_numpy(src._u).to(dev), torch.from_numpy(src._lam).to(dev)
    x8 = (torch.randn((n8, src.k), generator=gen, device=dev) * lam8) @ u8.T
    x8.add_(torch.randn((n8, P), generator=gen, device=dev), alpha=0.05)
    mix_means = torch.randn((K, P), generator=gen, device=dev) * (SEP / math.sqrt(P))
    mix_labels = torch.randint(0, K, (n8,), generator=gen, device=dev)
    xm = mix_means[mix_labels]
    xm.add_(torch.randn((n8, P), generator=gen, device=dev))
    del u8, lam8, mix_means
    torch.cuda.synchronize()
    plan8 = api.Plan(backend="batch", gamma=GAMMA, batch_size=BATCH)
    planted = src._lam.astype(np.float64) ** 2
    fits = {}
    ops.reset_counts()
    sa_mod.sparse_assign.by_shape.clear()
    for backend in ("batch", "stream"):
        pl = plan8.replace(backend=backend)
        cons = [api.SparsifiedMean(pl, key=1), api.SparsifiedCov(pl, key=1),
                api.SparsifiedPCA(PCA_K, pl, key=1),
                api.SparsifiedKMeans(K, pl, key=1, n_init=N_INIT, max_iter=100)]
        t0 = time.perf_counter()
        run = api.fit_many(pl, cons, x8, finalize=False).sync()
        t_fit = time.perf_counter() - t0
        times = []
        for c in cons:        # K-means last: the launches after ``before`` are Lloyd's
            before = dict(ops.launch_counts())
            k4_before = sa_mod.sparse_assign.by_shape[(1, K, m)]
            t0 = time.perf_counter()
            c.finalize()
            torch.cuda.synchronize()
            times.append(f"{type(c).__name__} {time.perf_counter() - t0:.3f}")
        km8 = cons[3]
        lloyd = {k_: v - before[k_] for k_, v in ops.launch_counts().items() if v > before[k_]}
        k4_lloyd = sa_mod.sparse_assign.by_shape[(1, K, m)] - k4_before
        print(f"  {backend}: ingest ({run.n_sketches} sketches shared by 4 consumers) {t_fit:.3f} s; "
              f"finalize (s): "
              f"{', '.join(times)}; Lloyd {km8.n_iter_} iterations in the best of {N_INIT} restarts, "
              f"{k4_lloyd} K4 launches at (r=1, K={K}) over the {n8} retained rows; the K-means "
              f"finalize launched {lloyd}")
        check(run.n_sketches == STEPS and run.count == n8, f"{backend}: {run.n_sketches} sketches "
                                                           f"of {run.count} rows")
        check(k4_lloyd >= km8.n_iter_ + 1, f"{backend}: K4 did not run Lloyd's assignment")
        check(lloyd.get("spmm_t", 0) >= km8.n_iter_, f"{backend}: K6 did not run Lloyd's update")
        for name, t in [("mean", cons[0].mean_), ("cov", cons[1].cov_),
                        ("components", cons[2].components_), ("eigenvalues", cons[2].explained_variance_),
                        ("centers", km8.centers_), ("objective", km8.objective_)]:
            check(bool(torch.isfinite(t).all()), f"{backend}: {name} is not finite")
        comps = cons[2].components_.double().cpu().numpy()
        q, _ = np.linalg.qr(comps.T)
        sine = float(np.sqrt(max(0.0, 1.0 - np.linalg.svd(q.T @ src._u.astype(np.float64),
                                                          compute_uv=False).min() ** 2)))
        evals = cons[2].explained_variance_.cpu().numpy()
        print(f"    top-{PCA_K} subspace vs planted: sine {sine:.4f} (< 0.35); eigenvalues "
              f"{np.round(evals, 2).tolist()} vs planted {np.round(planted, 2).tolist()} (10 %)")
        check(sine < 0.35, f"{backend}: the top-{PCA_K} subspace is off the planted one")
        check(bool(np.all(np.abs(evals - planted) <= 0.1 * planted)),
              f"{backend}: an eigenvalue is more than 10% off its planted value")
        fits[backend] = cons
    (mb, cb, pb, kb), (ms_, cs, ps, ks) = fits["batch"], fits["stream"]
    comps_b, comps_s = pb.components_, ps.components_
    comps_s = comps_s * torch.sign(torch.sum(comps_s * comps_b, dim=1, keepdim=True))
    for name, a, b_ in [("mean", ms_.mean_, mb.mean_), ("covariance", cs.cov_, cb.cov_),
                        ("components (signs aligned)", comps_s, comps_b),
                        ("eigenvalues", ps.explained_variance_, pb.explained_variance_)]:
        rel = ((a - b_).abs().max() / b_.abs().max()).item()
        print(f"  stream against batch, {name}: max |stream - batch| / max |batch| {rel:.3g} (1e-5)")
        check(rel <= 1e-5, f"stream and batch disagree on the {name}")
    check(torch.equal(ks.centers_, kb.centers_) and torch.equal(ks.labels_, kb.labels_),
          "Lloyd on the same sketches gave other centers or labels on the two backends")
    # where a Lloyd iteration's time goes: one restart of 20 iterations on the
    # retained sketch under torch.profiler, device time by entry against the
    # host's clock
    s_km = kb._reducer.concat()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        it20 = kmeans_mod.sparse_kmeans_core(s_km.values, s_km.indices, s_km.p, K, prng.PRNGKey(5),
                                             n_init=1, max_iter=20,
                                             assign_fn=ops.kernel_assign_fn())[3]
        torch.cuda.synchronize()
        t_lloyd = time.perf_counter() - t0
    rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"  one Lloyd restart ({int(it20)} iterations, K-means++ seeding and the transposition "
          f"included) under torch.profiler: {t_lloyd * 1e3:.1f} ms on the host's clock, {total:.1f} ms "
          f"of device time (device share {total / (t_lloyd * 1e3):.3f}); the largest:")
    for e in rows[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d}x  {e.key[:100]}")
    del s_km, prof, rows
    comps8 = pb.components_.clone()     # phase 10's dense reference (key 1, the same sketches)
    del fits, ms_, cs, ps, ks, mb, pb, kb, comps_b, comps_s
    torch.cuda.empty_cache()

    # cov_original: two K2 unmixes of (16384, 16384) and the 1 GiB transpose
    # between them; bit-equal to the same two unmixes by the plain butterfly,
    # and near the rows' empirical second moment (spectral norms by 30 steps of
    # power iteration on the symmetric matrices)
    def spectral(a):
        v = torch.randn(a.shape[0], generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        for _ in range(30):
            v = a @ v
            v /= v.norm()
        return (a @ v).norm().item()

    k2_before = fwht.hd_precondition.launches
    t0 = time.perf_counter()
    c_orig = cb.cov_original()
    torch.cuda.synchronize()
    t_orig = time.perf_counter() - t0
    k2_orig = fwht.hd_precondition.launches - k2_before
    plain = sketch_mod.unmix_dense(sketch_mod.unmix_dense(cb.cov_, cb.spec_, impl="ref").T,
                                   cb.spec_, impl="ref")
    check(torch.equal(c_orig, plain), "cov_original is not bit-equal to the plain unmixes")
    del plain
    c_emp = x8.T @ x8 / n8
    rel = spectral(c_orig - c_emp) / spectral(c_emp)
    print(f"  cov_original {t_orig:.3f} s ({k2_orig} K2 launches of ({P}, {P})), bit-equal to the "
          f"plain unmixes; spectral distance to the rows' empirical second moment {rel:.4f} of its "
          f"norm (< 0.15)")
    check(k2_orig == 2 and tuple(c_orig.shape) == (P, P), "cov_original did not take two K2 launches")
    check(bool(torch.isfinite(c_orig).all()) and rel < 0.15, "cov_original is off the empirical one")
    del c_orig, c_emp, cb        # x8 stays for phases 9 and 10
    torch.cuda.empty_cache()

    # Lloyd on the mixture: accuracy, and a second fit bit for bit; the dense
    # K-means on the same rows shows the separation is what SEP says
    km_fits = []
    for _ in range(2):
        t0 = time.perf_counter()
        km_fits.append(api.SparsifiedKMeans(K, plan8, key=2, n_init=N_INIT, max_iter=100).fit(xm))
        torch.cuda.synchronize()
        t_km = time.perf_counter() - t0
    acc_sparse = kmeans_mod.clustering_accuracy(km_fits[0].labels_, mix_labels, K)
    t0 = time.perf_counter()
    dense = kmeans_mod.kmeans(xm, K, prng.PRNGKey(2), n_init=N_INIT, max_iter=100)
    torch.cuda.synchronize()
    t_dense = time.perf_counter() - t0
    acc_dense = kmeans_mod.clustering_accuracy(dense.assignments, mix_labels, K)
    print(f"  mixture of {K} Gaussians (means ≈ {SEP * math.sqrt(2):.1f} σ apart): Lloyd on the sketch "
          f"{t_km:.3f} s a fit, {km_fits[0].n_iter_} iterations, accuracy {acc_sparse:.4f} (≥ 0.95); "
          f"dense K-means {t_dense:.3f} s, accuracy {acc_dense:.4f} (≥ 0.99)")
    check(acc_dense >= 0.99, "the mixture is not separated as SEP says: dense K-means misses")
    check(acc_sparse >= 0.95, "Lloyd on the sketch misses the mixture")
    a_, b_ = km_fits
    check(torch.equal(a_.centers_, b_.centers_) and torch.equal(a_.labels_, b_.labels_)
          and a_.n_iter_ == b_.n_iter_, "two Lloyd fits on the card are not bit-identical")
    del b_, dense, xm, mix_labels
    launches8 = ops.launch_counts()
    peak8 = torch.cuda.max_memory_allocated()
    print(f"  launches on the front door: {launches8}; K4's by (r, K, m): "
          f"{dict(sa_mod.sparse_assign.by_shape)}; peak memory {peak8 / 2**30:.2f} GiB")
    check(all(launches8[name] > 0 for name in PATH8),
          f"a kernel of the front door never launched: {launches8}")

    # Lloyd's two kernels at the shape they ran at, against their plain
    # versions (these launches are not the path's): on the mixture's retained
    # sketch (n8 rows of m), its fitted labels and centers, the center update
    # (K6's walk and the integer counts) bit-equal to the CPU's scatter-add in
    # row order, and K4 at (r = 1, K) over every row, with a tie planted as in
    # phase 3 (two equal centers, 256 rows on them)
    s_mx = a_._reducer.concat()
    labels_mx = a_.labels_.to(torch.int32)
    t0 = time.perf_counter()
    sums, counts = ops.cluster_sums(s_mx.values, s_mx.indices, labels_mx, K, s_mx.p)
    torch.cuda.synchronize()
    t_upd = time.perf_counter() - t0
    sums_ref, counts_ref = ref.ref_cluster_sums(s_mx.values.cpu(), s_mx.indices.cpu(),
                                                labels_mx.cpu(), K, s_mx.p)
    check(torch.equal(sums.cpu(), sums_ref) and torch.equal(counts.cpu(), counts_ref),
          f"Lloyd's update at ({n8} rows, m={m}, K={K}) is not bit-equal to the CPU's scatter-add")
    check(int(counts_ref.sum()) == n8 * m, "the update's counts do not add up to n·m")
    del sums, counts, sums_ref, counts_ref
    vals = s_mx.values.clone()
    centers = a_.centers_pre_.clone()
    tie = (3, 7)
    centers[tie[1]] = centers[tie[0]]
    vals[:256] = centers[tie[0]][s_mx.indices[:256].long()]
    d, a4 = ops.sparse_assign(vals, s_mx.indices, centers)
    torch.cuda.synchronize()
    d_ref, a_ref = ref.ref_sparse_assign(vals, s_mx.indices, centers)
    rel = ((d - d_ref).abs() / d_ref.abs().clamp(min=1e-30)).max().item()
    top2 = torch.topk(d_ref, 2, dim=-1, largest=False).values
    clear = (top2[..., 1] - top2[..., 0]) > 1e-5 * top2[..., 0].abs()
    check(bool(torch.all(a4[:256] == tie[0])), "K4 in Lloyd's shape: a tie did not go to the first index")
    check(torch.equal(a4[clear], a_ref[clear]), "K4 in Lloyd's shape: argmin differs from the plain version")
    check(rel <= 1e-5, f"K4 in Lloyd's shape: relative distance error {rel:.3g} above 1e-5")
    print(f"  Lloyd's kernels at their shape on the mixture's sketch ({n8} rows, m={m}, K={K}): the "
          f"center update ({t_upd * 1e3:.1f} ms, the transposition included) bit-equal to the CPU's "
          f"scatter-add; K4 (r=1) relative distance error {rel:.3g} (1e-5), argmin equal on "
          f"{int(clear.sum())} rows without a near-tie, the planted tie to the first index")
    del s_mx, labels_mx, vals, centers, d, a4, d_ref, a_ref, top2, clear, km_fits, a_
    torch.cuda.empty_cache()

    # the low-rank estimator folds the sketches the engine folds: the same
    # RangeState and top-8, bit for bit
    plan_lr8 = api.Plan(backend="stream", gamma=GAMMA, batch_size=BATCH, cov_path="lowrank",
                        rank=ELL)
    src_lr = memo7       # phase 7's first two batches, the same (seed, step)s
    t0 = time.perf_counter()
    est_lr = api.SparsifiedPCA(PCA_K, plan_lr8, key=1).fit_stream(src_lr, 2)
    torch.cuda.synchronize()
    t_est = time.perf_counter() - t0
    eng = api.make_engine(plan_lr8, P_LR, 1, src_lr)
    res_lr = eng.run(2)
    st_e, st_k = est_lr._reducer.state, eng.state.lowrank
    check(isinstance(st_e, lowrank.RangeState), "the low-rank estimator holds no RangeState")
    check(all(torch.equal(getattr(st_e, f), getattr(st_k, f)) for f in ("y", "diag", "sum_w", "count")),
          "the low-rank estimator's RangeState differs from the engine's")
    top_e, top_k = est_lr.cov_lowrank_.top(PCA_K), res_lr.cov_lowrank.top(PCA_K)
    check(all(torch.equal(a, b_) for a, b_ in zip(top_e, top_k)),
          "the low-rank estimator's top-8 differs from the engine's")
    print(f"  low-rank SparsifiedPCA(8, rank={ELL}).fit_stream at p={P_LR}, 2 steps (phase 7's "
          f"batches, kept): {t_est:.2f} s; RangeState and top-{PCA_K} bit-equal to "
          f"make_engine(...).run(2); phase 8 took {time.perf_counter() - t8:.1f} s")
    del est_lr, eng, res_lr, st_e, st_k, top_e, top_k, src_lr, memo7

    # ---------------------------------------------------------------- 9 resume
    print(f"== 9 resume: phase 5's Plan and source, p={P}, K={K}, r={N_INIT}, "
          f"track_reassignments=True", flush=True)
    t9 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plan9 = api.Plan(backend="stream", gamma=GAMMA, batch_size=BATCH)
    src9 = memo5        # phase 5's batches (a pure function of seed and step), not made again

    def engine9(cov_path="dense"):
        return api.make_engine(plan9.replace(cov_path=cov_path), P, prng.PRNGKey(1), src9,
                               kmeans=StreamKMeansConfig(k=K, n_init=N_INIT, track_reassignments=True))

    # the probe: one step folded twice from the same state and batch, the
    # same bits (Σw by the dense batch's column sums or K6, the K-means sums
    # on K6, the compact covariance at m/p = 0.05 by chunked products); the
    # compact path folds into the same state layout
    eng9 = engine9()
    st0 = eng9.init_state()
    x9 = eng9.host_global_batch(None, 0)
    for cov_path, e in (("dense", eng9), ("compact", engine9("compact"))):
        diff = same_bits(e.update(st0, x9, 0), e.update(st0, x9, 0))
        print(f"  one step ({BATCH}, {P}), m={m}, cov_path={cov_path!r}, folded twice from the same "
              f"state and batch: {'bit-identical' if not diff else 'DIFFERS in ' + str(diff)}")
        check(not diff, f"a {cov_path} fold does not repeat bit for bit: {diff}")
    del st0, x9
    tmp9 = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ops.reset_counts()
        t0 = time.perf_counter()
        leg1 = eng9.run(STEPS // 2, checkpoint_dir=os.path.join(tmp9, "engine"),
                        checkpoint_every=STEPS // 4)
        torch.cuda.synchronize()
        t_leg1 = time.perf_counter() - t0
        eng9b = engine9()
        t0 = time.perf_counter()
        state, next_step = eng9b.restore_state(os.path.join(tmp9, "engine"))
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        check(next_step == STEPS // 2, f"restore_state resumed at step {next_step}")
        t0 = time.perf_counter()
        leg2 = eng9b.run(STEPS, state=state, start_step=next_step)
        torch.cuda.synchronize()
        t_leg2 = time.perf_counter() - t0
        launches9 = ops.launch_counts()
        ck_dir = ckpt_mod.latest_step_dir(os.path.join(tmp9, "engine"))
        ck_bytes = sum(os.path.getsize(os.path.join(ck_dir, f)) for f in os.listdir(ck_dir))
        t0 = time.perf_counter()
        eng9b.save_state(os.path.join(tmp9, "again"), STEPS)
        t_write = time.perf_counter() - t0
        same = {name: torch.equal(getattr(leg2, name), res5[name]) for name in res5}
        total = leg1.reassign_counts.sum(0) + leg2.reassign_counts.sum(0)
        print(f"  (phase 5's batches, kept on the host) run({STEPS // 2}) with a checkpoint every "
              f"{STEPS // 4} steps {t_leg1:.2f} s; "
              f"restore_state {t_restore:.2f} s (next_step {next_step}); run({STEPS}, "
              f"start_step={next_step}) {t_leg2:.2f} s; bit-equal to phase 5's run: {same}")
        print(f"  reassign_total {leg2.reassign_total.tolist()} = leg 1's {leg1.reassign_counts.sum(0).tolist()}"
              f" + leg 2's {leg2.reassign_counts.sum(0).tolist()}; per step (best of r) "
              f"{np.concatenate([leg1.reassign_counts, leg2.reassign_counts]).min(1).tolist()}")
        print(f"  the checkpoint: {ck_bytes} bytes ({ck_bytes / 2**30:.3f} GiB), written in "
              f"{t_write:.2f} s, restored in {t_restore:.2f} s")
        print(f"  launches on the resume path: {launches9}")
        check(all(same.values()), f"the resumed run is not bit-equal to phase 5's: {same}")
        check(np.array_equal(leg2.reassign_total, total), "reassign_total is not the legs' sum")
        check(all(launches9[name] > 0 for name in PATH9), f"a kernel of the path never launched: "
                                                          f"{launches9}")
        del eng9, eng9b, state, leg1, leg2, res5, src9, memo5

        # the fused run over phase 8's rows, stopped after 8 of 16 chunks
        def consumers9():
            return [api.SparsifiedPCA(PCA_K, plan9, key=1),
                    api.SparsifiedKMeans(K, plan9, key=1, algorithm="minibatch")]

        t0 = time.perf_counter()
        full = consumers9()
        api.fit_many(plan9, full, x8)
        torch.cuda.synchronize()
        t_full = time.perf_counter() - t0
        t0 = time.perf_counter()
        run = api.fit_many(plan9, consumers9(), x8[:STEPS // 2 * BATCH], finalize=False)
        run.checkpoint(os.path.join(tmp9, "fused"))
        t_ck = time.perf_counter() - t0
        resumed = consumers9()
        t0 = time.perf_counter()
        run = api.restore_run(os.path.join(tmp9, "fused"), plan9, resumed)
        run.partial_fit(x8[STEPS // 2 * BATCH:]).finalize()
        torch.cuda.synchronize()
        t_res = time.perf_counter() - t0
        same = {"components": torch.equal(resumed[0].components_, full[0].components_),
                "eigenvalues": torch.equal(resumed[0].explained_variance_, full[0].explained_variance_),
                "centers": torch.equal(resumed[1].centers_, full[1].centers_),
                "reassign_counts": np.array_equal(resumed[1].reassign_counts_,
                                                  full[1].reassign_counts_)}
        print(f"  fit_many over SparsifiedPCA({PCA_K}) and SparsifiedKMeans({K}, minibatch), "
              f"{STEPS * BATCH} rows on the card: uninterrupted {t_full:.2f} s; 8 chunks and the "
              f"checkpoint {t_ck:.2f} s; restore_run and the other 8 {t_res:.2f} s; bit-equal: {same}")
        check(all(same.values()), f"the resumed fused run is not bit-equal: {same}")
        del full, run, resumed
    finally:
        shutil.rmtree(tmp9, ignore_errors=True)
    print(f"  phase 9: {time.perf_counter() - t9:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")

    # --------------------------------------------------------------- 10 refine
    print(f"== 10 refine: fit_many(refine=2) at p={P}; replay_scanned at p={P_LR}, l={ELL}; "
          f"Frequent Directions", flush=True)
    t10 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    plan10 = api.Plan(backend="stream", gamma=GAMMA, batch_size=BATCH, cov_path="lowrank", rank=24)

    def consumers10():
        return [api.SparsifiedPCA(PCA_K, plan10, key=1),
                api.SparsifiedKMeans(K, plan10, key=1, algorithm="minibatch")]

    one = consumers10()
    api.fit_many(plan10, one, x8)
    fits10 = []
    for _ in range(2):
        cons = consumers10()
        objs = []
        end_pass = cons[1]._refine_pass_end

        def record(f, last, signal, _end=end_pass, _km=cons[1], _objs=objs):
            _objs.append(float(_km._r2.obj))     # the objective under pass f's frozen centers
            _end(f, last, signal)

        cons[1]._refine_pass_end = record
        k1 = ops.launch_counts()["sketch_fused"]
        t0 = time.perf_counter()
        api.fit_many(plan10, cons, x8, refine=2)
        torch.cuda.synchronize()
        fits10.append((cons, objs, ops.launch_counts()["sketch_fused"] - k1,
                       time.perf_counter() - t0))
    (pca10, km10), objs, n_sk, t_ref = fits10[0]
    s_one, s_ref = subspace_sine(one[0].components_, comps8), subspace_sine(pca10.components_, comps8)
    rel = [(b_ - a) / abs(a) for a, b_ in zip(objs, objs[1:])]
    print(f"  fit_many(refine=2) over SparsifiedPCA({PCA_K}, rank=24) and SparsifiedKMeans({K}, "
          f"minibatch): {t_ref:.2f} s, {n_sk} sketches (16 forward, 16 each of 2 passes and the "
          f"measurement pass)")
    print(f"  top-{PCA_K} sine to phase 8's dense components: one-pass {s_one:.4g}, refined "
          f"{s_ref:.4g}; subspace change a pass {pca10.refine_subspace_change_.tolist()}")
    print(f"  the sketched K-means objective under each pass's frozen centers {objs} (relative "
          f"steps {[f'{r:.3g}' for r in rel]}); rows reassigned by the rebuilds "
          f"{km10.refine_reassign_counts_.tolist()}")
    check(n_sk == 4 * STEPS, f"{n_sk} sketches: the replay did not share one sketch a chunk")
    check(s_ref <= s_one, "the refined subspace is farther from the dense one than the one-pass")
    check(all(r <= 1e-6 for r in rel), "the K-means objective rose between refinement passes")
    (pca_b, km_b), objs_b, _, _ = fits10[1]
    same = (torch.equal(pca10.components_, pca_b.components_)
            and torch.equal(pca10.explained_variance_, pca_b.explained_variance_)
            and torch.equal(km10.centers_, km_b.centers_) and objs == objs_b
            and np.array_equal(km10.refine_reassign_counts_, km_b.refine_reassign_counts_))
    print(f"  a second identical refine: bit-identical {same}")
    check(same, "two identical refines on the card differ")
    del one, fits10, pca10, km10, pca_b, km_b
    launches10_refine = ops.launch_counts()
    print(f"  launches of the three fit_many runs: {launches10_refine}")
    check(all(launches10_refine[name] > 0 for name in PATH10_REFINE),
          f"a kernel of the p={P} refinement never launched: {launches10_refine}")
    ops.reset_counts()

    # p = 65536: 8 steps staged on the card (phase 7's planted U and λ,
    # phase 8's generator), the engine's scanned run and replay
    src10 = VectorStreamSource(p=P_LR, batch=BATCH, seed=0)
    gen = torch.Generator(device=dev).manual_seed(10)
    u10, lam10 = torch.from_numpy(src10._u).to(dev), torch.from_numpy(src10._lam).to(dev)
    xs = torch.empty((STEPS10_LR, 1, BATCH, P_LR), device=dev)
    for t in range(STEPS10_LR):
        torch.matmul(torch.randn((BATCH, src10.k), generator=gen, device=dev) * lam10, u10.T,
                     out=xs[t, 0])
        xs[t, 0].add_(torch.randn((BATCH, P_LR), generator=gen, device=dev), alpha=0.05)
    del u10, lam10
    plan_lr = api.Plan(backend="stream", gamma=GAMMA, batch_size=BATCH, cov_path="lowrank", rank=ELL)
    eng10 = api.make_engine(plan_lr, P_LR, prng.PRNGKey(1), lambda seed, step, shard: xs[step, shard],
                            kmeans=StreamKMeansConfig(k=K, n_init=N_INIT))
    st0 = eng10.init_state()
    diff = same_bits(eng10.update(st0, xs[0], 0), eng10.update(st0, xs[0], 0))
    print(f"  one step ({BATCH}, {P_LR}), l={ELL}, folded twice from the same state and batch: "
          f"{'bit-identical' if not diff else 'DIFFERS in ' + str(diff)}")
    check(not diff, f"a low-rank fold does not repeat bit for bit: {diff}")
    eng10.run_scanned(xs[:2])
    scanned = eng10.state
    eng10.run(2)
    diff = same_bits(scanned, eng10.state)
    print(f"  run_scanned(xs[:2]) against run(2) over the same rows: "
          f"{'bit-equal' if not diff else 'DIFFERS in ' + str(diff)}")
    check(not diff, f"run_scanned and run differ: {diff}")
    del st0, scanned
    launches10_replay = ops.launch_counts()
    ops.reset_counts()
    t0 = time.perf_counter()
    res_one = eng10.run_scanned(xs)
    torch.cuda.synchronize()
    t_scan = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_r = eng10.replay_scanned(xs, passes=2)
    torch.cuda.synchronize()
    t_replay = time.perf_counter() - t0
    launches10b = ops.launch_counts()
    res_r2 = eng10.replay_scanned(xs, passes=2)
    n10 = STEPS10_LR * BATCH
    comps_r = sketch_mod.unmix_dense(res_r.cov_lowrank.top(PCA_K)[0], eng10.spec)
    print(f"  run_scanned {t_scan:.2f} s; replay_scanned(passes=2) with K-means {t_replay:.2f} s; "
          f"launches {launches10b}; reassigned by rebuild 1: {res_r.refine_reassigned}")
    planted_gates(sketch_mod.unmix_dense(res_one.cov_lowrank.top(PCA_K)[0], eng10.spec),
                  res_one.cov_lowrank.eigenvalues, n10, P_LR, src10._u, src10._lam, ELL, "one pass")
    planted_gates(comps_r, res_r.cov_lowrank.eigenvalues, n10, P_LR, src10._u, src10._lam, ELL,
                  "refined (2 passes)")
    same = (torch.equal(res_r.cov_lowrank.eigenvalues, res_r2.cov_lowrank.eigenvalues)
            and torch.equal(res_r.cov_lowrank.components_pre, res_r2.cov_lowrank.components_pre)
            and torch.equal(res_r.centers_pre, res_r2.centers_pre)
            and torch.equal(res_r.kmeans_obj, res_r2.kmeans_obj))
    print(f"  a repeated replay_scanned: bit-identical {same}")
    check(same, "two replays on the card differ")
    for name in ("mean", "centers", "kmeans_obj"):
        check(bool(torch.isfinite(getattr(res_r, name)).all()), f"refined {name} is not finite")
    check(all(launches10b[name] > 0 for name in PATH2),
          f"a kernel of the p={P_LR} replay never launched: {launches10b}")
    del eng10, xs, res_one, res_r, res_r2, comps_r
    launches10_replay = {name: n + launches10_replay[name] for name, n in ops.launch_counts().items()}
    ops.reset_counts()

    # Frequent Directions on 16,384 of phase 8's rows: the card's sketch B
    # against the port's FD on the CPU and against a float64 FD written here
    # (each shrink by the eigenpairs of the (2l, 2l) Gram matrix), both fed
    # the same sketches; and Liberty's bound 0 ≼ S − BᵀB ≼ ‖W‖²/l
    n_fd, ell_fd = STEPS // 4 * BATCH, 32
    x_fd = x8[:n_fd]
    plan_fd = api.Plan(gamma=GAMMA, batch_size=BATCH, cov_path="lowrank", lowrank_method="fd",
                       rank=ell_fd)
    t0 = time.perf_counter()
    fd = api.SparsifiedPCA(PCA_K, plan_fd, key=1).fit(x_fd)
    torch.cuda.synchronize()
    t_fd = time.perf_counter() - t0
    launches_fd = ops.launch_counts()
    s_all = torch.zeros((P, P), device=dev)
    fro2 = 0.0
    st_cpu = lowrank.fd_init(P, ell_fd)
    b64 = torch.zeros((ell_fd, P), dtype=torch.float64, device=dev)
    t_cpu = 0.0
    for j in range(n_fd // BATCH):
        s_j = sketch_mod.sketch(x_fd[j * BATCH:(j + 1) * BATCH], fd.spec_,
                                batch_key=sketch_mod.batch_key(fd.spec_, j, 0))
        w = s_j.to_dense()
        s_all.addmm_(w.T, w)
        fro2 += float((w.double() ** 2).sum())
        t0 = time.perf_counter()
        st_cpu = lowrank.fd_update(st_cpu, SparseRows(s_j.values.cpu(), s_j.indices.cpu(), P))
        t_cpu += time.perf_counter() - t0
        w = w.double()
        for r in range(0, BATCH, ell_fd):
            a = torch.cat([b64, w[r:r + ell_fd]])
            ev, u = torch.linalg.eigh(a @ a.T)             # ascending: σ² and A's left vectors
            ev, u = ev.flip(0), u.flip(1)
            keep = torch.clamp(ev[:ell_fd] - ev[ell_fd].clamp(min=0), min=0)
            b64 = (torch.sqrt(keep / ev[:ell_fd].clamp(min=1e-300))[:, None] * u[:, :ell_fd].T) @ a
    del w, a
    b_fd = fd._reducer.state.sketch
    gap = torch.linalg.eigvalsh(s_all - b_fd.T @ b_fd)
    del s_all

    def gram_err(b, want):
        """max |bᵀb − wantᵀwant| / max |wantᵀwant|, in float64 on the card."""
        g = want.double().to(dev)
        g = g.T @ g
        top = g.abs().max().item()
        b = b.double().to(dev)
        g.addmm_(b.T, b, alpha=-1.0)
        return g.abs().max().item() / top

    err_cpu, err_64 = gram_err(b_fd, st_cpu.sketch), gram_err(b_fd, b64)
    err_side = max((fd._reducer.state.diag.cpu() - st_cpu.diag).abs().max().item()
                   / st_cpu.diag.abs().max().item(),
                   (fd._reducer.state.sum_w.cpu() - st_cpu.sum_w).abs().max().item()
                   / st_cpu.sum_w.abs().max().item())
    tr_b = float((b_fd.double() ** 2).sum())
    comps = fd.components_.double().cpu().numpy()
    q, _ = np.linalg.qr(comps.T)
    s_fd = float(np.sqrt(max(0.0, 1.0 - np.linalg.svd(q.T @ src._u.astype(np.float64),
                                                        compute_uv=False).min() ** 2)))
    print(f"  SparsifiedPCA({PCA_K}, lowrank_method='fd', rank={ell_fd}).fit on {n_fd} rows: "
          f"{t_fd:.2f} s ({n_fd // ell_fd} SVD-shrinks of ({2 * ell_fd}, {P})); the same folds "
          f"on the CPU {t_cpu:.2f} s; launches {launches_fd}")
    print(f"  BᵀB against the port's FD on the CPU: |err|/max {err_cpu:.3g} (1e-4); against a "
          f"float64 FD on the same sketches {err_64:.3g} (1e-4); diag and Σw against the CPU's "
          f"{err_side:.3g} (1e-5); ‖B‖_F² {tr_b:.6g} of ‖W‖_F² {fro2:.6g}")
    print(f"  S − BᵀB spans [{gap.min().item():.4g}, {gap.max().item():.4g}] against the bound "
          f"[0, ‖W‖²/l = {fro2 / ell_fd:.4g}]")
    print(f"  FD against the planted model: top-{PCA_K} sine {s_fd:.4f}, eigenvalues "
          f"{np.round(fd.explained_variance_.cpu().numpy(), 2).tolist()} vs planted "
          f"{np.round(src._lam.astype(np.float64) ** 2, 2).tolist()} (not gated: at this γ and l "
          f"each shrink takes more from a direction than the planted signal adds, in the JAX "
          f"package too: tests/test_torch_fd.py, PERF.md §6)")
    check(bool(torch.isfinite(fd.components_).all()), "FD components are not finite")
    check(err_cpu <= 1e-4, f"FD's sketch on the card is off the CPU's: {err_cpu:.3g}")
    check(err_64 <= 1e-4, f"FD's sketch on the card is off the float64 FD's: {err_64:.3g}")
    check(err_side <= 1e-5, f"FD's diag or Σw on the card is off the CPU's: {err_side:.3g}")
    check(gap.min().item() >= -1e-2 * fro2 / ell_fd and gap.max().item() <= fro2 / ell_fd * (1 + 1e-3),
          "FD breaks its deterministic bound 0 ≼ S − BᵀB ≼ ‖W‖²/l")
    check(all(launches_fd[name] > 0 for name in PATH_FD),
          f"a kernel of the FD path never launched: {launches_fd}")
    del fd, x_fd, b_fd, gap, st_cpu, b64      # x8 stays for phase 12
    torch.cuda.synchronize()
    launches10 = {name: launches10_refine[name] + launches10_replay[name] + launches_fd[name]
                  for name in launches_fd}
    print(f"  launches in phase 10: {launches10}")
    print(f"  phase 10: {time.perf_counter() - t10:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")

    # ---------------------------------------------------------------- 11 serve
    launches11 = phase11_serve(card)

    # -------------------------------------------------------------- 12 sharded
    launches12 = phase12_sharded(card, x8)
    del x8

    # ---------------------------------------------------------------- 13 train
    launches13 = phase13_train(card)

    # ------------------------------------------------------------- 14 lm-serve
    launches14 = phase14_serve(card)

    # --------------------------------------------------------- 15 lm-families
    launches15 = phase15_families(card)

    # ------------------------------------------------------------ 16 dp-train
    launches16 = phase16_dp_train(card)

    # ----------------------------------------------------------------- 17 moe
    launches17 = phase17_moe(card)

    # ------------------------------------------------------------ 18 roofline
    launches18 = phase18_roofline(card)

    # ---------------------------------------------------------------- 19 fsdp
    launches19 = phase19_fsdp(card)

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
    # launches: each kernel's count on its own path's run (phase 5 or phase
    # 7); launches_by_phase: that count again and each later path's own,
    # each read just after its reset (phase 14 serves a model on no kernel
    # of the repo: its counts are 0; phase 15's are its three training runs')
    later = {"9 resume": launches9, "10 refine": launches10_refine,
             "10 scan and replay": launches10_replay, "10 fd": launches_fd,
             "11 serve": launches11, "12 sharded": launches12, "13 train": launches13,
             "14 lm-serve": launches14, "15 lm-families": launches15, "16 dp-train": launches16,
             "17 moe": launches17, "18 roofline": launches18, "19 fsdp": launches19}
    kernels = [dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=counts[name],
                    launches_by_phase={"5" if counts is launches else "7": counts[name],
                                       **{ph: c[name] for ph, c in later.items()}},
                    **entries[name])
               for name, (source, replaces, counts) in sources.items()]
    print(f"the whole script: {time.perf_counter() - t_script:.1f} s; {card}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if "--dp-worker" in sys.argv[1:]:
        _dp_worker(sys.argv[1:])
    elif "--moe-worker" in sys.argv[1:]:
        _moe_worker(sys.argv[1:])
    elif "--fsdp-worker" in sys.argv[1:]:
        _fsdp_worker(sys.argv[1:])
    else:
        main()
