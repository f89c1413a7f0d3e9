"""repro_torch.kernels.ref (the plain versions of K1, K2, K4) against the
reference's jnp oracles in repro.kernels.ref, the CPU routing of the kernel
wrappers and the dispatch layer, and the plain version of K6's column
transposition."""
import jax
import numpy as np
import pytest
import torch

from repro.core import ros as jros
from repro.kernels import ref as jref
from repro_torch.kernels import fwht, ops, ref, sketch_fused, sparse_assign, spmm


# jitted reference oracles: one compile per shape instead of one per op
J_SKETCH = jax.jit(jref.ref_sketch_fused)
J_HD = jax.jit(jref.ref_hd_precondition)
J_HD_AFTER = jax.jit(lambda x, s: jros.fwht(x) * s[None, :])
J_ASSIGN = jax.jit(jref.ref_sparse_assign)


def _case(n, p, m, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)).astype(np.float32)
    s = np.where(rng.random(p) < 0.5, -1.0, 1.0).astype(np.float32)
    idx = np.sort(np.argsort(rng.random((n, p)), axis=1)[:, :m], axis=1).astype(np.int32)
    return x, s, idx


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


# the shapes of tests/test_sketch_fused.py, plus ragged row counts
SKETCH_SHAPES = [(10, 128, 8), (33, 256, 16), (9, 512, 32), (21, 4096, 64),
                 (1, 512, 24), (7, 512, 24), (127, 512, 24), (130, 512, 24)]


@pytest.mark.parametrize("n,p,m", SKETCH_SHAPES)
def test_sketch_fused_and_hd_precondition_plain(n, p, m):
    x, s, idx = _case(n, p, m, seed=n * p)
    _close(ref.ref_sketch_fused(*_t(x, s, idx)), J_SKETCH(x, s, idx))
    _close(ref.ref_hd_precondition(*_t(x, s)), J_HD(x, s))
    # the unmix direction: signs after the transform
    _close(ref.ref_hd_precondition(*_t(x, s), signs_after=True), J_HD_AFTER(x, s))


def _check_assign(d, a, d_ref, a_ref):
    d, a, d_ref, a_ref = (np.asarray(v) for v in (d, a, d_ref, a_ref))
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=0)
    top2 = np.sort(np.concatenate([d_ref, np.full(d_ref.shape[:-1] + (1,), np.inf)], -1),
                   axis=-1)[..., :2]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-5 * np.abs(top2[..., 0])
    np.testing.assert_array_equal(a[clear], a_ref[clear])
    assert a.dtype == np.int32


@pytest.mark.parametrize("n,m,k,p", [(50, 16, 5, 128), (200, 64, 8, 1024), (3, 1, 1, 4)])
def test_sparse_assign_plain(n, m, k, p):
    rng = np.random.default_rng(n + k)
    _, _, idx = _case(n, p, m, seed=k)
    vals = rng.normal(size=(n, m)).astype(np.float32)
    centers = rng.normal(size=(3, k, p)).astype(np.float32)
    for c in (centers[0], centers):
        d, a = ref.ref_sparse_assign(*_t(vals, idx, c))
        if c.ndim == 2:
            d_j, a_j = J_ASSIGN(vals, idx, c)
        else:
            outs = [J_ASSIGN(vals, idx, ci) for ci in c]
            d_j, a_j = np.stack([o[0] for o in outs]), np.stack([o[1] for o in outs])
        _check_assign(d, a, d_j, a_j)


def test_wrappers_use_plain_versions_for_cpu_tensors():
    x, s, idx = _t(*_case(4, 64, 8, seed=0))
    ops.reset_counts()
    np.testing.assert_array_equal(fwht.hd_precondition(x, s), ref.ref_hd_precondition(x, s))
    np.testing.assert_array_equal(sketch_fused.sketch_fused(x, s, idx),
                                  ref.ref_sketch_fused(x, s, idx))
    c = torch.ones((2, 64))
    vals = torch.zeros((4, 8))
    d, a = sparse_assign.sparse_assign(vals, idx, c)
    assert torch.equal(d, torch.full((4, 2), 8.0)) and torch.equal(a, torch.zeros(4, dtype=torch.int32))
    ops.sketch_fused(x, s, idx)
    ops.sparse_assign(vals, idx, c, mode="ref")
    big = torch.ones((2, 1 << 16))
    ops.hd_precondition(big, torch.ones(1 << 16))
    ops.spmm(vals, idx, torch.ones((64, 3)))
    assert ops.launch_counts() == {"sketch_fused": 0, "sketch_fused_cluster": 0,
                                   "hd_precondition": 0, "hd_precondition_chunked": 0,
                                   "sparse_assign": 0, "spmm": 0, "spmm_t": 0,
                                   "transpose_columns": 0}
    assert ops.DISPATCH == {("sketch_fused", "ref"): 1, ("sparse_assign", "ref"): 1,
                            ("hd_precondition", "ref"): 1, ("spmm", "ref"): 1}
    with pytest.raises(ValueError, match="mode"):
        ops.hd_precondition(x, s, mode="interpret")


def test_kernel_checks_reject_what_the_kernel_does_not_take():
    """The CUDA-side argument checks run before any library is loaded."""
    from repro_torch.kernels import _build

    with pytest.raises(ValueError, match="CUDA"):
        _build.require(torch.zeros(2, 2), torch.float32, 2, "x")
    with pytest.raises(ValueError, match="K3"):
        fwht.check_p(1 << 16)
    with pytest.raises(ValueError, match="power-of-two"):
        fwht.check_p(1000)
    assert fwht.check_p(1 << 15) == 15 and fwht.check_p(1) == 0
    assert fwht.scale_for(1 << 15) == float(np.float32(1 / np.sqrt(1 << 15)))


def _bucket_cases():
    rng = np.random.default_rng(9)
    sorted_rows = np.sort(np.argsort(rng.random((30, 500)), axis=1)[:, :40], axis=1)
    repeats = rng.integers(0, 20, size=(25, 17))        # repeats within rows, unsorted
    repeats[repeats == 4] = 5                           # column 4 empty
    ones = np.full((6, 4), 3)                           # one column, four times a row
    return [(sorted_rows, 600), (repeats, 20), (ones, 8)]


@pytest.mark.parametrize("case", range(3))
def test_column_buckets_is_a_stable_sort(case):
    """The plain version of K6's transposition: numpy's stable argsort of the
    flat indices, with repeats within a row and empty columns."""
    idx, p = _bucket_cases()[case]
    order, starts = spmm.column_buckets(torch.from_numpy(idx.astype(np.int32)), p)
    flat = idx.reshape(-1)
    want = np.argsort(flat, kind="stable")
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(starts.numpy(), np.searchsorted(flat[want], np.arange(p + 1)))
    assert order.dtype == starts.dtype == torch.int32
    # the transposition's plain route: each entry's row and value bits, column by column
    vals = np.random.default_rng(case).normal(size=idx.shape).astype(np.float32)
    pairs, starts2 = spmm.transpose_columns(torch.from_numpy(vals),
                                            torch.from_numpy(idx.astype(np.int32)), p)
    np.testing.assert_array_equal(starts2.numpy(), starts.numpy())
    np.testing.assert_array_equal(pairs[:, 0].numpy(), want // idx.shape[1])
    np.testing.assert_array_equal(pairs[:, 1].view(torch.float32).numpy(), vals.reshape(-1)[want])


@pytest.mark.parametrize("n,m,p", [(4096, 3277, 65536), (4096, 819, 16384), (777, 205, 4096),
                                   (64, 1677722, 1 << 25), (4096, 655, 65536),
                                   (64, 3000, 1 << 25), (300, 100, 40000), (1 << 20, 50, 1 << 16),
                                   (1, 1, 1 << 27)])
def test_transpose_scratch_within_the_entry_arrays(n, m, p):
    """The transposition's scratch stays within the size of the entry arrays
    (values and indices, 2·n·m words), or one tile's p counts where that is
    more, beside a flag a row and the scan's block sums; the fast passes run
    at the paths' shapes (m/p = 0.05) and wherever they fit."""
    fast, rows, words = spmm.transpose_plan(n, m, p)
    extra = n + -(-p // 256) + 1
    assert words <= max(2 * n * m, p) + extra
    tiles, pieces = -(-n // rows), -(-p // spmm.PIECE)
    fast_words = 3 * -(-n // spmm.TILE_ROWS) * p + n * (pieces + 1) + extra
    assert fast == (fast_words <= 2 * n * m)
    if m >= 0.05 * p:
        assert fast
    if fast:
        assert rows == spmm.TILE_ROWS and words == fast_words <= 2 * n * m
    else:
        assert 1 <= rows <= n and words == tiles * p + extra


@pytest.mark.parametrize("max_cluster", [8, 16])
@pytest.mark.parametrize("log_p", range(16, 28))
def test_chunk_plan_covers_every_index_bit(log_p, max_cluster):
    """K3's schedule: one cluster pass takes the low chunk_log + log2(C) index
    bits (blocks of 2^14 values where the row fits a cluster of them, else
    2^15), register passes of at most five bits the rest, every bit exactly
    once; one pass wherever the row fits a cluster."""
    cluster, chunk_log, passes = fwht.chunk_plan(1 << log_p, max_cluster)
    assert chunk_log == (14 if 1 << log_p <= max_cluster << 14 else 15)
    assert cluster in fwht.CLUSTER_SIZES and cluster <= max_cluster
    cluster_bits = chunk_log + cluster.bit_length() - 1
    rest = log_p - cluster_bits
    assert rest >= 0 and (passes - 1) * fwht.REGISTER_BITS < rest <= passes * fwht.REGISTER_BITS \
        or rest == passes == 0
    assert (rest == 0) == ((1 << log_p) <= max_cluster << fwht.CHUNK_LOG)
    if rest:
        assert cluster == max_cluster


def test_chunk_plan_refuses_what_k3_does_not_take():
    for p in (1 << 15, 1 << 28, 3 << 16):
        with pytest.raises(ValueError):
            fwht.chunk_plan(p, 16)
    with pytest.raises(ValueError, match="max_cluster"):
        fwht.chunk_plan(1 << 16, 32)
    assert fwht.chunk_plan(1 << 16, 2) == (2, 15, 0)      # 4 blocks of 2^14 do not fit
    assert fwht.chunk_plan(1 << 19, 16) == (16, 15, 0)    # nor do 32


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("n,m,p,ell", [(4096, 3277, 65536, 128), (777, 3277, 65536, 128),
                                       (4096, 3277, 65536, 40), (1000, 3277, 65536, 130),
                                       (64, 3277, 65536, 16), (5, 64, 64, 13), (8, 1, 256, 4),
                                       (1 << 20, 50, 1 << 16, 128), (4096, 819, 16384, 128)])
def test_spmm_plan_fits_and_fills_the_card(sms, n, m, p, ell):
    """The windowed K5's plan on a card of ``sms`` SMs: two windows and the
    rows' rings of pairs within a block's 227 KiB of shared memory; at least
    one block an SM where the rows and Ω's windows allow that many; splits
    cover Ω's rows once, in whole windows. The windows take the rows where a
    row keeps at least 1/32 of Ω's rows (the low-rank path's 0.05 does)."""
    plan = spmm.spmm_plan(n, p, ell, sms)
    window = spmm.WINDOW
    smem = 2 * window * (128 if ell % 4 == 0 else 32) * 4 + spmm.WIN_ROWS * 64 * 8
    assert plan.smem == smem <= spmm.SMEM_LIMIT
    tiles = -(-n // spmm.WIN_ROWS)
    assert plan.blocks == tiles * plan.splits
    assert plan.span % window == 0 and (plan.splits - 1) * plan.span < p <= plan.splits * plan.span
    if tiles * min(-(-p // window), spmm.MAX_SPLITS) >= sms:
        assert plan.blocks >= sms
    fixed = spmm.spmm_plan(n, p, ell, sms, splits=1)
    assert fixed.splits == 1 and fixed.span >= p
    assert spmm.windows_pay(m, p) == (m >= p / 32)
    assert spmm.windows_pay(3277, 65536) and not spmm.windows_pay(655, 65536)


@pytest.mark.parametrize("sms,max_cluster", [(132, 16), (132, 8), (78, 16)])
@pytest.mark.parametrize("n", [1, 3, 10, 77, 131, 132, 4096, 16384])
def test_split_plan_spreads_few_rows_over_clusters(sms, max_cluster, n):
    """K2's schedule: a call with fewer rows than SMs splits each row of more
    than 2^11 values over a cluster of 2^11-value blocks (larger ones where
    that cluster would exceed C_max); otherwise one block a row. Every split
    covers the row and is one the kernel is built for."""
    for lp in range(0, 16):
        p = 1 << lp
        plan = fwht.split_plan(n, p, sms, max_cluster)
        if n >= sms or lp <= fwht.SPLIT_CHUNK_LOG:
            assert plan is None
            continue
        cluster, chunk_log = plan
        assert cluster << chunk_log == p and 2 <= cluster <= max_cluster
        assert chunk_log in fwht.SPLIT_CHUNK_LOGS
        assert chunk_log == max(fwht.SPLIT_CHUNK_LOG, lp - max_cluster.bit_length() + 1)
    with pytest.raises(ValueError):
        fwht.split_plan(3, 1 << 16, sms, max_cluster)
