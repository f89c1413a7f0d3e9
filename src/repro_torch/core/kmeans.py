"""Sparsified K-means (paper §VI, Algs. 1–2) and the standard Lloyd it is held against.

Shape conventions: data rows = samples; centers (K, p); assignments (n,) int32.

- :func:`kmeans`            — standard Lloyd + K-means++ (the dense reference).
- :func:`sparsified_kmeans` — Alg. 1: one pass (precondition → sample → Lloyd
                              on the compact rows), optional Alg. 2 second pass.
- :func:`sparse_kmeans_core` — Lloyd on already-sketched rows, best of n_init.
- :func:`feature_extraction_kmeans` / :func:`feature_selection_kmeans` — the
                              paper's random-projection and leverage-score
                              baselines (dense Lloyd on m features).

The distances of sparse rows to centers (Eq. 35/36) are the K4 kernel's
function (``kernels.ops.sparse_assign``; :func:`repro_torch.kernels.ops.kernel_assign_fn`
is Lloyd's ``assign_fn`` on it); :func:`sparse_sq_dists` is the plain gather
form and Lloyd's default, as in the reference. Lloyd's center update (Eq. 39)
is ``kernels.ops.cluster_sums``: on the card K6's walk over the rows'
transposition, built once a fit, for the sums and an integer histogram for the
counts, so a fit is bit-reproducible from run to run.
Restarts run in turn on ``prng.split(key, n_init)`` and the first of the
smallest objectives wins, as ``lax.map`` + ``argmin`` give in the reference.
Each Lloyd iteration reads its shift on the host to decide whether to go on.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import sketch
from repro_torch.core.sampling import subsample
from repro_torch.kernels import ops
from repro_torch.utils import prng


@dataclasses.dataclass(frozen=True)
class KMeansResult:
    assignments: torch.Tensor        # (n,) int32
    centers: torch.Tensor            # (K, p) in the ORIGINAL domain
    objective: torch.Tensor          # final value of the solver's objective
    n_iter: torch.Tensor             # iterations of the final (best) run, int32
    centers_pre: torch.Tensor | None = None  # (K, p_pad) preconditioned domain (sparsified only)


# ------------------------------------------------------------ distances -----

def dense_sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(n, K) squared Euclidean distances."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=1)
    return x2 - 2.0 * x @ centers.T + c2[None, :]


def sparse_sq_dists(values: torch.Tensor, indices: torch.Tensor,
                    centers: torch.Tensor) -> torch.Tensor:
    """(n, K) sparsified distances ‖z_i − R_iᵀ μ_k‖² (Eq. 35), gather form."""
    g = centers.T[indices.long()]                            # (n, m, K)
    return torch.sum((values[..., None] - g) ** 2, dim=1)


# ----------------------------------------------------------- K-means++ ------

def _kpp_init(key, dists_to: Callable[[torch.Tensor], torch.Tensor], n: int, k: int,
              gather_rows: Callable[[torch.Tensor], torch.Tensor], p: int,
              dtype, device) -> torch.Tensor:
    """Greedy K-means++ D²-seeding: ``n_cand`` trial centers per step, keeping
    the one that most reduces the potential (as in sklearn).

    dists_to(C (c, p)) -> (c, n) squared distances of every sample to each
    candidate center; gather_rows(i (c,)) -> (c, p) dense sample rows.
    """
    n_cand = 2 + int(np.ceil(np.log(max(k, 2))))
    k0, key = prng.split(key)
    first = gather_rows(prng.randint(k0, (1,), 0, n, device=device))   # (1, p)
    centers = torch.zeros((k, p), dtype=dtype, device=device)
    centers[0] = first[0]
    min_d = dists_to(first)[0]
    for j in range(1, k):
        key, kc = prng.split(key)
        logits = torch.log(torch.clamp(min_d, min=1e-30))
        idxs = prng.categorical(kc, logits, shape=(n_cand,))
        cands = gather_rows(idxs)                                       # (n_cand, p)
        new_ds = dists_to(cands)                                        # (n_cand, n)
        pots = torch.sum(torch.minimum(min_d[None, :], new_ds), dim=1)
        best = torch.argmin(pots)
        centers[j] = cands[best]
        min_d = torch.minimum(min_d, new_ds[best])
    return centers


def kpp_init_dense(key, x: torch.Tensor, k: int) -> torch.Tensor:
    """K-means++ on dense rows (distances Σ (x − c)², one candidate at a time)."""
    n, p = x.shape

    def dists_to(c):
        return torch.stack([torch.sum((x - ci[None, :]) ** 2, dim=1) for ci in c])

    return _kpp_init(key, dists_to, n, k, lambda i: x[i.long()], p, x.dtype, x.device)


def kpp_init_sparse(key, values: torch.Tensor, indices: torch.Tensor, p: int, k: int,
                    impl: str = "auto") -> torch.Tensor:
    """K-means++ under the sparsified metric: candidate centers are scattered
    sparse rows; distances use only each row's sampled coordinates (Eq. 35),
    through the K4 kernel (``impl`` is its dispatch mode)."""
    n, _ = values.shape

    def gather_rows(i):
        out = torch.zeros((i.shape[0], p), dtype=values.dtype, device=values.device)
        return out.scatter_(1, indices[i].long(), values[i])

    def dists_to(c):
        return ops.sparse_assign(values, indices, c, mode=impl)[0].T

    return _kpp_init(key, dists_to, n, k, gather_rows, p, values.dtype, values.device)


# ------------------------------------------------------------ Lloyd loops ---

def _lloyd(mu0: torch.Tensor, max_iter: int, tol: float, dists, update):
    """Lloyd from ``mu0``: assign by ``dists(mu)`` (n, K), recompute centers by
    ``update(labels, mu)``, while fewer than ``max_iter`` iterations ran and
    the largest center move exceeds ``tol`` (the count is of body runs, as
    ``lax.while_loop`` counts them). Returns (mu, labels int32, objective,
    iterations int32)."""
    tol = np.float32(tol)
    it, mu, shift = 0, mu0, np.inf
    while it < max_iter and shift > tol:
        new_mu = update(torch.argmin(dists(mu), dim=1), mu)
        shift = torch.max(torch.abs(new_mu - mu)).item()
        it, mu = it + 1, new_mu
    d = dists(mu)
    a = torch.argmin(d, dim=1).to(torch.int32)
    return mu, a, torch.sum(torch.min(d, dim=1).values), torch.tensor(it, dtype=torch.int32)


def _lloyd_dense(x: torch.Tensor, mu0: torch.Tensor, max_iter: int, tol: float):
    k = mu0.shape[0]

    def update(a, mu):
        oh = torch.nn.functional.one_hot(a, k).to(x.dtype)           # (n, K)
        sums = oh.T @ x                                               # (K, p)
        counts = torch.sum(oh, dim=0)
        return torch.where(counts[:, None] > 0,
                           sums / torch.clamp(counts, min=1.0)[:, None], mu)

    return _lloyd(mu0, max_iter, tol, lambda mu: dense_sq_dists(x, mu), update)


def _lloyd_sparse(values: torch.Tensor, indices: torch.Tensor, p: int, mu0: torch.Tensor,
                  max_iter: int, tol: float, assign_fn=None, impl: str = "auto",
                  columns=None):
    """Lloyd on compact sparse rows: Eq. (36) assignment + Eq. (39) update.

    ``columns``: the rows' transposition for the update
    (``kernels.ops.cluster_columns``), built here if not given.
    """
    k = mu0.shape[0]
    assign_fn = assign_fn or sparse_sq_dists
    if columns is None:
        columns = ops.cluster_columns(values, indices, p, mode=impl)

    def update(a, mu):
        sums, counts = ops.cluster_sums(values, indices, a, k, p, columns, mode=impl)
        # coordinates never sampled in a cluster keep their previous value
        return torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), mu)

    return _lloyd(mu0, max_iter, tol, lambda mu: assign_fn(values, indices, mu), update)


def _best(runs):
    """The run with the smallest objective, the first among equals."""
    best = int(torch.argmin(torch.stack([r[2] for r in runs])))
    return runs[best]


# ------------------------------------------------------------- solvers ------

def kmeans(x: torch.Tensor, k: int, key, n_init: int = 5, max_iter: int = 100,
           tol: float = 1e-6) -> KMeansResult:
    """Standard K-means (Lloyd) with K-means++ seeding, best of ``n_init`` runs."""
    runs = [_lloyd_dense(x, kpp_init_dense(rkey, x, k), max_iter, tol)
            for rkey in prng.split(key, n_init)]
    mu, a, obj, it = _best(runs)
    return KMeansResult(a, mu, obj, it)


def sparse_kmeans_core(values: torch.Tensor, indices: torch.Tensor, p: int, k: int, key,
                       n_init: int = 5, max_iter: int = 100, tol: float = 1e-6,
                       assign_fn=None, impl: str = "auto"):
    """Lloyd on an already-sketched matrix (domain-agnostic); best of n_init.

    ``impl`` dispatches the seeding's distances (K4) and the center update
    (K6); ``assign_fn`` gives Lloyd's distances (default: the gather form).
    """
    columns = ops.cluster_columns(values, indices, p, mode=impl)   # one for every restart
    runs = [_lloyd_sparse(values, indices, p, kpp_init_sparse(rkey, values, indices, p, k, impl),
                          max_iter, tol, assign_fn, impl, columns)
            for rkey in prng.split(key, n_init)]
    return _best(runs)


def sparsified_kmeans(x: torch.Tensor, k: int, key, gamma: float | None = None,
                      m: int | None = None, transform: str = "hadamard",
                      precondition: bool = True, two_pass: bool = False,
                      n_init: int = 5, max_iter: int = 100, tol: float = 1e-6,
                      assign_fn=None, impl: str = "auto") -> KMeansResult:
    """Alg. 1 (one-pass) / Alg. 2 (``two_pass=True``) sparsified K-means.

    ``precondition=False`` gives the paper's no-ROS ablation baseline.
    """
    n, p = x.shape
    spec = sketch.make_spec(p, key, gamma=gamma, m=m,
                            transform=transform if precondition else "dct")
    if precondition:
        s = sketch.sketch(x, spec, impl=impl)
        pp = spec.p_pad
    else:
        s = subsample(x, spec.mask_key(), spec.m)
        pp = p

    mu_pre, a, obj, it = sparse_kmeans_core(s.values, s.indices, pp, k, spec.signs_key(),
                                            n_init, max_iter, tol, assign_fn, impl)
    centers = sketch.unmix_dense(mu_pre, spec, impl=impl) if precondition else mu_pre

    if two_pass:
        # Alg. 2: one more pass over the ORIGINAL data — recompute centers as
        # true sample means of assigned points, and reassign in the original domain.
        xf = x.to(torch.float32)
        oh = torch.nn.functional.one_hot(a.long(), k).to(torch.float32)
        sums = oh.T @ xf
        counts = torch.sum(oh, dim=0)
        centers2 = torch.where(counts[:, None] > 0,
                               sums / torch.clamp(counts, min=1.0)[:, None], centers)
        d = dense_sq_dists(xf, centers)                      # reassign w/ 1-pass centers
        a = torch.argmin(d, dim=1).to(torch.int32)
        obj = torch.sum(torch.min(d, dim=1).values)
        centers = centers2

    return KMeansResult(a, centers, obj, it, centers_pre=mu_pre)


# ---------------------------------------------------- the paper's baselines --
# The Alg. 1–2 comparisons of §VII-B (Figs. 7–9): feature extraction by a
# random ±1 projection [Boutsidis et al.] and feature selection by leverage
# scores [36]. They cluster dense (n, m) features with :func:`kmeans`.


def _second_pass(x: torch.Tensor, a: torch.Tensor, k: int, centers: torch.Tensor) -> torch.Tensor:
    """Centers as the true means of the rows assigned to them (one more pass
    over X); an empty cluster keeps its one-pass center."""
    oh = torch.nn.functional.one_hot(a.long(), k).to(torch.float32)
    counts = torch.sum(oh, dim=0)
    return torch.where(counts[:, None] > 0,
                       (oh.T @ x.to(torch.float32)) / torch.clamp(counts, min=1.0)[:, None],
                       centers)


def feature_extraction_kmeans(x: torch.Tensor, k: int, m: int, key, two_pass: bool = False,
                              n_init: int = 5, max_iter: int = 100,
                              tol: float = 1e-6) -> KMeansResult:
    """Boutsidis et al. feature extraction: cluster Z = XΩᵀ/√m, Ω ∈ {±1}^{m×p}.

    One-pass center estimates use the pseudo-inverse lift Ω⁺ (the paper's Fig. 9
    shows these are poor — kept faithful); ``two_pass`` recomputes them from X.
    """
    n, p = x.shape
    komega, krun = prng.split(key)
    omega = prng.rademacher(komega, (m, p), device=x.device) / np.float32(np.sqrt(m))
    z = x.to(torch.float32) @ omega.T
    res = kmeans(z, k, krun, n_init=n_init, max_iter=max_iter, tol=tol)
    # lift centers with the pseudo-inverse (rank-m, inconsistent — see §VII-B)
    centers = res.centers @ torch.linalg.pinv(omega).T
    a = res.assignments
    if two_pass:
        centers = _second_pass(x, a, k, centers)
    return KMeansResult(a, centers, res.objective, res.n_iter)


def leverage_scores(x: torch.Tensor, rank: int, key, oversample: int = 10) -> torch.Tensor:
    """Approximate row (feature) leverage scores via a randomized range finder [7].

    Returns (p,) scores of Xᵀ's rows = feature importances for feature
    selection. The scores are squared row norms of Q, so QR's signs do not
    matter.
    """
    n, p = x.shape
    xt = x.to(torch.float32).T                               # (p, n) features-as-rows
    g = prng.normal(key, (n, rank + oversample), device=x.device)
    q, _ = torch.linalg.qr(xt @ g)                           # (p, r+o) orthonormal
    scores = torch.sum(q[:, :rank] ** 2, dim=1)
    return scores / torch.sum(scores)


def feature_selection_kmeans(x: torch.Tensor, k: int, m: int, key, two_pass: bool = False,
                             n_init: int = 5, max_iter: int = 100,
                             tol: float = 1e-6) -> KMeansResult:
    """[36] feature selection: sample m features by leverage scores, cluster there.

    Requires ≥3 passes over the data (score pass, sampling pass, clustering) —
    included as the paper's multi-pass baseline.
    """
    n, p = x.shape
    kscore, ksel, krun = prng.split(key, 3)
    scores = leverage_scores(x, rank=k, key=kscore)
    sel = prng.choice(ksel, p, (m,), replace=False, p=scores, device=x.device)
    # rescale by 1/sqrt(m q_j) as in [36]
    scale = torch.sqrt(m * scores[sel])[None, :]
    res = kmeans(x[:, sel].to(torch.float32) / scale, k, krun, n_init=n_init,
                 max_iter=max_iter, tol=tol)
    centers = torch.zeros((k, p), dtype=torch.float32, device=x.device)
    centers[:, sel] = res.centers * scale
    a = res.assignments
    if two_pass:
        centers = _second_pass(x, a, k, centers)
    return KMeansResult(a, centers, res.objective, res.n_iter)


# -------------------------------------------------------------- metrics -----

def clustering_accuracy(pred, true, k: int) -> float:
    """Best-permutation label accuracy (Hungarian matching), as in §VII-B."""
    from scipy.optimize import linear_sum_assignment

    pred, true = (np.asarray(v.cpu() if torch.is_tensor(v) else v) for v in (pred, true))
    conf = np.zeros((k, k))
    for i in range(k):
        for j in range(k):
            conf[i, j] = np.sum((pred == i) & (true == j))
    ri, ci = linear_sum_assignment(-conf)
    return float(conf[ri, ci].sum() / len(true))
