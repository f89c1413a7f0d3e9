"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: on a machine with no card every test skips (the check is made
inside a fixture). On the card run ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_kernels_cuda.py``. Shapes are the streaming engine's
(4096 rows a step, p = 16384, m = 819, K = 10, r = 3) and the low-rank path's
(p = 65536, m = 3277, l = 128) plus the edges: the p = 2^15 ceiling of K1/K2,
K3 at every cluster size (p = 2^16 … 2^19) and on its multi-pass schedule
(2^20, 2^21), the sketch in K3's cluster gather mode, ragged row counts,
p < 32 and an l that is not a multiple of 32.

Tolerances: K1–K3 are bit-equal to the plain butterfly (same stages, same
order), the cluster sketch too. K5/K6 sum in another order than the plain
einsum/index_add, so they are held to 1e-5 of the largest output; K5 is
bit-identical across launches and, with one split, bit-equal to its row
kernel; K6 is bit-identical across launches,
its transposition to the stable sort of ``column_buckets``, and its walk to
the same walk fed by ``column_buckets``. K4 sums in another order than the
plain version: 1e-5 relative, the same argmin where the top two differ by more
than that, ties to the first index.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fwht, ops, ref, sketch_fused, sparse_assign, spmm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _case(n, p, m, dev, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32)).to(dev)
    s = torch.from_numpy(np.where(rng.random(p) < 0.5, -1.0, 1.0).astype(np.float32)).to(dev)
    idx = np.sort(np.argsort(rng.random((n, p)), axis=1)[:, :m], axis=1).astype(np.int32)
    return x, s, torch.from_numpy(idx).to(dev)


@pytest.mark.parametrize("n,p,m", [(4096, 16384, 819), (512, 32768, 1638),
                                   (777, 16384, 819), (5, 16, 3), (3, 1, 1)])
def test_sketch_fused_matches_plain(dev, n, p, m):
    x, s, idx = _case(n, p, m, dev)
    before = sketch_fused.sketch_fused.launches
    got = sketch_fused.sketch_fused(x, s, idx)
    torch.cuda.synchronize()
    assert sketch_fused.sketch_fused.launches == before + 1
    want = ref.ref_sketch_fused(x, s, idx)
    assert got.shape == (n, m)
    assert torch.max(torch.abs(got - want)).item() <= 1e-5


@pytest.mark.parametrize("n,p", [(4096, 16384), (10, 16384), (8, 32768), (7, 64), (3, 8)])
@pytest.mark.parametrize("signs_after", [False, True])
def test_hd_precondition_matches_plain(dev, n, p, signs_after):
    x, s, _ = _case(n, p, 1, dev)
    got = fwht.hd_precondition(x, s, signs_after=signs_after)
    torch.cuda.synchronize()
    want = ref.ref_hd_precondition(x, s, signs_after=signs_after)
    assert torch.max(torch.abs(got - want)).item() <= 1e-5


@pytest.mark.parametrize("n", [1, 3, 10, 200, 4096])
@pytest.mark.parametrize("lp", range(11, 16))
def test_hd_precondition_split_matches_plain(dev, n, lp):
    """K2's rows split over a cluster, on every (cluster, chunk) the card
    builds for p = 2^12 … 2^15 (rows of 2^11 values are not split), and on
    split_plan's choice for p = 2^11 … 2^15, in both sign modes: bit-equal to
    the plain butterfly, whatever the row count."""
    p = 1 << lp
    c_max = fwht.max_cluster(dev)
    x, s, _ = _case(n, p, 1, dev, seed=lp)
    plans = [(p >> cl, cl) for cl in fwht.SPLIT_CHUNK_LOGS if 2 <= p >> cl <= c_max]
    assert plans or lp <= fwht.SPLIT_CHUNK_LOG
    for signs_after in (False, True):
        want = ref.ref_hd_precondition(x, s, signs_after=signs_after)
        for plan in plans:
            got = fwht._rows(x, s, signs_after, plan)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (plan, signs_after)
        got = fwht.hd_precondition(x, s, signs_after=signs_after)
        assert torch.equal(got, want), fwht.split_plan(n, p, spmm.sm_count(dev), c_max)


K3_SHAPES = [(64, 1 << 16), (10, 1 << 16), (3, 1 << 17), (2, 1 << 21)] + [
    (n, 1 << lp) for n in (1, 10, 777) for lp in range(16, 21)]


@pytest.mark.parametrize("n,p", K3_SHAPES)
@pytest.mark.parametrize("signs_after", [False, True])
def test_chunked_transform_matches_plain(dev, n, p, signs_after):
    """K3 at every cluster size the card places (one pass up to C_max·2^15)
    and on its multi-pass schedule above, bit-equal to the plain butterfly."""
    x, s, _ = _case(n, p, 1, dev)
    before = fwht.hd_precondition_chunked.launches
    got = fwht.hd_precondition(x, s, signs_after=signs_after)      # p > 2^15: K3
    torch.cuda.synchronize()
    assert fwht.hd_precondition_chunked.launches == before + 1
    assert torch.equal(got, ref.ref_hd_precondition(x, s, signs_after=signs_after))


def test_max_cluster_and_the_one_pass_ceiling(dev):
    """C_max is 8 (portable) or 16 on an H100, and p = 2^16 is one cluster pass."""
    c_max = fwht.max_cluster(dev)
    assert c_max in (8, 16)
    assert fwht.chunk_plan(1 << 16, c_max) == (4, 14, 0)
    assert fwht.chunk_plan(c_max << 15, c_max) == (c_max, 15, 0)


@pytest.mark.parametrize("lp", range(16, 20))
@pytest.mark.parametrize("signs_after", [False, True])
def test_chunked_transform_both_block_sizes(dev, lp, signs_after):
    """K3 and the cluster sketch on the schedule of every C_max up to the
    card's: blocks of 2^14 and of 2^15 values, smaller clusters and register
    passes, all bit-equal to the plain versions."""
    p = 1 << lp
    x, s, idx = _case(9, p, 77, dev, seed=lp)
    want = ref.ref_hd_precondition(x, s, signs_after=signs_after)
    want_sketch = ref.ref_sketch_fused(x, s, idx)
    chunk_logs = set()
    for c_max in fwht.CLUSTER_SIZES:
        if c_max > fwht.max_cluster(dev):
            continue
        plan = fwht.chunk_plan(p, c_max)
        chunk_logs.add(plan[1])
        assert torch.equal(fwht._chunked(x, s, signs_after, plan), want), plan
        if not plan[2]:
            assert torch.equal(sketch_fused._cluster(x, s, idx, plan), want_sketch), plan
    assert chunk_logs == ({14, 15} if p <= fwht.max_cluster(dev) << 14 else {15})


@pytest.mark.parametrize("n,p,m", [(16, 1 << 16, 3277), (777, 1 << 16, 1), (5, 1 << 16, 65536),
                                   (3, 1 << 18, 13107), (129, 1 << 18, 1), (1, 1 << 17, 6554)])
def test_sketch_cluster_gather_matches_plain(dev, n, p, m):
    """The sketch above 2^15 in one cluster pass: bit-equal to the plain
    composition, counted on its own wrapper and tallied kernel_cluster."""
    x, s, idx = _case(n, p, m, dev, seed=n + m)
    ops.reset_counts()
    got = ops.sketch_fused(x, s, idx)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["sketch_fused_cluster"] == 1 and counts["hd_precondition_chunked"] == 0
    assert ops.DISPATCH[("sketch_fused", "kernel_cluster")] == 1
    assert got.shape == (n, m)
    assert torch.equal(got, ref.ref_sketch_fused(x, s, idx))
    shuffled = idx[:, torch.randperm(m, device=dev)].contiguous()   # any order of indices
    assert torch.equal(sketch_fused.sketch_fused_cluster(x, s, shuffled),
                       ref.ref_sketch_fused(x, s, shuffled))


def test_sketch_fused_above_the_ceiling_composes_k3(dev):
    x, s, idx = _case(4, 1 << 20, 3277, dev)
    ops.reset_counts()
    got = ops.sketch_fused(x, s, idx)
    torch.cuda.synchronize()
    assert ops.launch_counts()["hd_precondition_chunked"] == 1
    assert ops.DISPATCH[("sketch_fused", "kernel_chunked")] == 1
    assert torch.equal(got, ref.ref_sketch_fused(x, s, idx))
    with pytest.raises(ValueError, match="K3"):
        sketch_fused.sketch_fused(x, s, idx)           # K1 alone stays single-row
    with pytest.raises(ValueError, match="cluster"):
        sketch_fused.sketch_fused_cluster(x, s, idx)   # past C_max·2^15


def test_chunked_transform_above_its_ceiling_raises(dev):
    x = torch.zeros((1, 1), device=dev).expand(1, 1 << 28)
    with pytest.raises(ValueError, match="ceiling"):
        fwht.hd_precondition(x, torch.ones(1, device=dev).expand(1 << 28))


def _spmm_case(dev, n, p, m, ell, seed=2):
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.normal(size=(n, m)).astype(np.float32)).to(dev)
    idx = np.sort(np.argsort(rng.random((n, p)), axis=1)[:, :m], axis=1).astype(np.int32)
    dense = torch.from_numpy(rng.normal(size=(p, ell)).astype(np.float32)).to(dev)
    return vals, torch.from_numpy(idx).to(dev), dense


def _close_rel(got, want, tol=1e-5):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.max(torch.abs(got - want)).item() <= tol * torch.max(torch.abs(want)).item()


@pytest.mark.parametrize("n,p,m,ell", [(4096, 65536, 3277, 128), (777, 4096, 205, 128),
                                       (33, 1000, 50, 100), (5, 64, 64, 13), (8, 256, 1, 4)])
def test_spmm_and_spmm_t_match_plain(dev, n, p, m, ell):
    vals, idx, dense = _spmm_case(dev, n, p, m, ell)
    before = (spmm.spmm.launches, spmm.spmm_t.launches)
    t = spmm.spmm(vals, idx, dense)
    y = spmm.spmm_t(vals, idx, t, p)
    torch.cuda.synchronize()
    assert (spmm.spmm.launches, spmm.spmm_t.launches) == (before[0] + 1, before[1] + 1)
    _close_rel(t, ref.ref_spmm(vals, idx, dense))
    _close_rel(y, ref.ref_spmm_t(vals, idx, t, p))
    got = spmm.spmm_t(vals, idx, t, p, col_sums=True)
    want = ref.ref_spmm_t(vals, idx, t, p, col_sums=True)
    assert torch.equal(got[0], y)
    for g, w in zip(got[1:], want[1:]):
        _close_rel(g, w)


@pytest.mark.parametrize("n,ell", [(4096, 128), (777, 128), (4096, 40), (1000, 130), (33, 40)])
def test_spmm_windows_match_row_kernel(dev, n, ell):
    """The windowed K5, which the low-rank path's m/p takes: with one split
    bit-equal to the row kernel; on its plan within 1e-5 of max |plain| and
    bit-identical across launches."""
    p, m = 65536, 3277
    assert spmm.windows_pay(m, p)
    vals, idx, dense = _spmm_case(dev, n, p, m, ell, seed=n + ell)
    plan = spmm.spmm_plan(n, p, ell, spmm.sm_count(dev))
    assert plan.splits > 1 and plan.smem <= spmm.SMEM_LIMIT
    by_rows = spmm._launch(vals, idx, dense, None)[0]
    one = spmm._launch(vals, idx, dense, spmm.spmm_plan(n, p, ell, spmm.sm_count(dev), splits=1))[0]
    before = spmm.spmm.launches
    got = spmm.spmm(vals, idx, dense)
    torch.cuda.synchronize()
    assert spmm.spmm.launches == before + 1
    assert torch.equal(one, by_rows)
    _close_rel(got, ref.ref_spmm(vals, idx, dense))
    for _ in range(2):
        assert torch.equal(spmm.spmm(vals, idx, dense), got)
    for splits in (2, 3, 7):
        other = spmm.spmm_plan(n, p, ell, spmm.sm_count(dev), splits=splits)
        _close_rel(spmm._launch(vals, idx, dense, other)[0], ref.ref_spmm(vals, idx, dense))


def test_spmm_takes_the_row_kernel_where_windows_do_not_pay(dev):
    """At m/p below 1/32 every row takes the row kernel: bit-equal to it."""
    n, p, m, ell = 1000, 65536, 655, 128
    assert not spmm.windows_pay(m, p)
    vals, idx, dense = _spmm_case(dev, n, p, m, ell, seed=11)
    got = spmm.spmm(vals, idx, dense)
    assert torch.equal(got, spmm._launch(vals, idx, dense, None)[0])
    _close_rel(got, ref.ref_spmm(vals, idx, dense))


def test_spmm_rows_that_do_not_increase_take_the_row_kernel(dev):
    """Rows with a repeated or an out-of-order index go to the row kernel
    (bit-equal to it there); the others stay on the windowed kernel."""
    n, p, m, ell = 300, 65536, 3277, 128
    vals, idx, dense = _spmm_case(dev, n, p, m, ell, seed=7)
    idx[5, 10] = idx[5, 9]                        # a repeat
    idx[77] = idx[77].flip(0)                     # decreasing
    idx[150, [0, 1]] = idx[150, [1, 0]]           # one swap
    got = spmm.spmm(vals, idx, dense)
    by_rows = spmm._launch(vals, idx, dense, None)[0]
    torch.cuda.synchronize()
    _close_rel(got, ref.ref_spmm(vals, idx, dense))
    for i in (5, 77, 150):
        assert torch.equal(got[i], by_rows[i]), i
    one = spmm._launch(vals, idx, dense, spmm.spmm_plan(n, p, ell, spmm.sm_count(dev), splits=1))[0]
    assert torch.equal(one, by_rows)


def test_spmm_t_is_deterministic(dev):
    vals, idx, dense = _spmm_case(dev, 4096, 65536, 3277, 128, seed=3)
    t = spmm.spmm(vals, idx, dense)
    first = spmm.spmm_t(vals, idx, t, 65536, col_sums=True)
    for _ in range(3):
        again = spmm.spmm_t(vals, idx, t, 65536, col_sums=True)
        assert all(torch.equal(a, b) for a, b in zip(again, first))
    assert torch.equal(spmm.spmm(vals, idx, dense), t)


def test_spmm_refuses_what_it_does_not_take(dev):
    vals, idx, dense = _spmm_case(dev, 4, 64, 8, 16)
    with pytest.raises(TypeError, match="float32"):
        spmm.spmm(vals.double(), idx, dense)
    with pytest.raises(TypeError, match="int32"):
        spmm.spmm(vals, idx.long(), dense)
    with pytest.raises(ValueError, match="CUDA"):
        spmm.spmm_t(vals, idx, dense.cpu(), 64)


def _assign_case(dev, n=4096, m=819, r=3, k=10, p=16384, seed=1):
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.normal(size=(n, m)).astype(np.float32)).to(dev)
    idx = np.sort(np.argsort(rng.random((n, p)), axis=1)[:, :m], axis=1).astype(np.int32)
    centers = torch.from_numpy(rng.normal(size=(r, k, p)).astype(np.float32)).to(dev)
    return vals, torch.from_numpy(idx).to(dev), centers


def _check_assign(d, a, d_ref, a_ref):
    rel = torch.abs(d - d_ref) / torch.clamp(torch.abs(d_ref), min=1e-30)
    assert rel.max().item() <= 1e-5
    if d_ref.shape[-1] == 1:
        assert torch.all(a == 0) and torch.all(a_ref == 0)
        return
    top2 = torch.topk(d_ref, 2, dim=-1, largest=False).values
    clear = (top2[..., 1] - top2[..., 0]) > 1e-5 * torch.abs(top2[..., 0])
    assert torch.equal(a[clear], a_ref[clear])


def test_sparse_assign_matches_plain_batched(dev):
    vals, idx, centers = _assign_case(dev)
    before = sparse_assign.sparse_assign.launches
    d, a = sparse_assign.sparse_assign(vals, idx, centers)
    torch.cuda.synchronize()
    assert sparse_assign.sparse_assign.launches == before + 1  # one launch for all r
    assert d.shape == (3, 4096, 10) and a.shape == (3, 4096) and a.dtype == torch.int32
    _check_assign(d, a, *ref.ref_sparse_assign(vals, idx, centers))


def test_sparse_assign_single_set_and_ragged(dev):
    vals, idx, centers = _assign_case(dev, n=1001, m=37, r=1, k=3, p=512)
    d, a = sparse_assign.sparse_assign(vals, idx, centers[0])
    torch.cuda.synchronize()
    assert d.shape == (1001, 3) and a.shape == (1001,)
    _check_assign(d, a, *ref.ref_sparse_assign(vals, idx, centers[0]))


def test_sparse_assign_ties_go_to_first_index(dev):
    vals, idx, centers = _assign_case(dev, n=256, m=64, r=2, k=6, p=1024)
    centers[:, 4] = centers[:, 1]
    # rows that sit exactly on center 1 (= center 4): distance 0 to both
    vals[:128] = centers[0, 1][idx[:128].long()]
    d, a = sparse_assign.sparse_assign(vals, idx, centers)
    torch.cuda.synchronize()
    assert torch.all(d[0, :128, 1] == 0) and torch.all(d[0, :128, 4] == 0)
    assert torch.all(a[0, :128] == 1)
    _check_assign(d, a, *ref.ref_sparse_assign(vals, idx, centers))


@pytest.mark.parametrize("r,k", [(3, 10), (1, 5), (1, 1), (3, 16)])
@pytest.mark.parametrize("m,p", [(819, 16384), (3277, 65536)])
def test_sparse_assign_launch_shapes(dev, r, k, m, p):
    """Every (r, K) the paths launch (a step; K-means++ candidates and first
    center), one with r·K > 32, at both paths' m; n ragged for row packing."""
    vals, idx, centers = _assign_case(dev, n=1001, m=m, r=r, k=k, p=p, seed=r * k)
    if k > 1:
        a_, b_ = (3, 7) if k >= 8 else (1, k - 1)
        centers[:, b_] = centers[:, a_]
        vals[:100] = centers[0, a_][idx[:100].long()]     # distance 0 to centers a_ and b_
    before = sparse_assign.sparse_assign.launches
    d, a = sparse_assign.sparse_assign(vals, idx, centers)
    torch.cuda.synchronize()
    assert sparse_assign.sparse_assign.launches == before + 1
    assert d.shape == (r, 1001, k) and a.shape == (r, 1001)
    _check_assign(d, a, *ref.ref_sparse_assign(vals, idx, centers))
    if k > 1:
        assert torch.all(a[0, :100] == a_)
    again = sparse_assign.sparse_assign(vals, idx, centers)
    assert torch.equal(again[0], d) and torch.equal(again[1], a)


def _transpose_cases():
    rng = np.random.default_rng(5)
    sorted_rows = np.sort(np.argsort(rng.random((300, 40000)), axis=1)[:, :2000], axis=1)
    repeats = rng.integers(0, 50, size=(70, 33))           # repeats within rows, unsorted
    repeats[:, 0] = 7                                       # a column in every row
    repeats[repeats == 11] = 12                             # an empty column
    every = np.sort(np.argsort(rng.random((257, 64)), axis=1)[:, :9], axis=1)
    every[:, 0] = 0                                         # a column present in every row
    one_col = np.full((40, 3), 5)                           # a row of one column, repeated
    dense = np.sort(np.argsort(rng.random((300, 1024)), axis=1)[:, :600], axis=1)
    sparse = np.sort(np.argsort(rng.random((300, 40000)), axis=1)[:, :100], axis=1)
    mixed = np.sort(np.argsort(rng.random((150, 5000)), axis=1)[:, :20], axis=1)
    mixed[::3] = rng.integers(0, 5000, size=(50, 20))      # every third row unsorted
    mixed[::9, 1] = mixed[::9, 0]                           # some repeats
    return [("sketch rows, p > 2^15", sorted_rows, 40000 + 30000),
            ("repeats within rows", repeats, 50),
            ("a column in every row", every, 64),
            ("one column", one_col, 9),
            ("dense rows, more entries a block than it stages", dense, 1024),
            ("sketch rows at m/p = 0.0025: general passes, two slabs", sparse, 40000),
            ("general passes, rows with and without repeats", mixed, 5000)]


def _transposed_as_buckets(vals, idx, p, name):
    before = spmm.transpose_columns.launches
    pairs, starts = spmm.transpose_columns(vals, idx, p)
    torch.cuda.synchronize()
    assert spmm.transpose_columns.launches == before + 1
    want_order, want_starts = spmm.column_buckets(idx, p)
    assert torch.equal(starts, want_starts), name
    assert torch.equal(pairs[:, 0], want_order // idx.shape[1]), name
    assert torch.equal(pairs[:, 1].view(torch.float32), vals.reshape(-1)[want_order.long()]), name
    cpu = spmm.transpose_columns(vals.cpu(), idx.cpu(), p)
    assert all(torch.equal(a.cpu(), b) for a, b in zip((pairs, starts), cpu)), name


@pytest.mark.parametrize("case", range(7))
def test_transpose_columns_matches_column_buckets(dev, case):
    name, idx_np, p = _transpose_cases()[case]
    rng = np.random.default_rng(case)
    idx = torch.from_numpy(idx_np.astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.normal(size=idx_np.shape).astype(np.float32)).to(dev)
    fast = spmm.transpose_plan(*idx_np.shape, p)[0]
    assert fast == ("general passes" not in name), name
    _transposed_as_buckets(vals, idx, p, name)


@pytest.mark.parametrize("m", [1677722, 3000])
def test_transpose_and_spmm_t_past_the_grid_limit(dev, m):
    """p = 2^25 (512-column pieces past 65535; the low-rank path takes p_pad up
    to 2^27): the fast passes at m/p = 0.05 and the general ones at m = 3000,
    bit for bit against column_buckets and the walk fed by it."""
    p = 1 << 25
    gen = torch.Generator(device=dev).manual_seed(m)
    idx = torch.stack([torch.randperm(p, generator=gen, device=dev)[:m].sort().values
                       for _ in range(64)]).int()
    vals = torch.randn(idx.shape, generator=gen, device=dev)
    t = torch.randn((64, 8), generator=gen, device=dev)
    assert spmm.transpose_plan(64, m, p)[0] == (m > 3000)
    _transposed_as_buckets(vals, idx, p, f"m={m}")
    got = spmm.spmm_t(vals, idx, t, p, col_sums=True)
    want = spmm.spmm_t_from_buckets(vals, idx, t, p, col_sums=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("n,p,m,ell", [(4096, 65536, 3277, 128), (777, 4096, 205, 100),
                                       (5, 64, 64, 13)])
def test_spmm_t_bit_equal_to_bucket_walk(dev, n, p, m, ell):
    """The walk over the transposition's pairs gives the bits of the walk fed
    by column_buckets (the same sums in the same order), on every launch."""
    vals, idx, dense = _spmm_case(dev, n, p, m, ell, seed=4)
    t = spmm.spmm(vals, idx, dense)
    old = spmm.spmm_t_from_buckets(vals, idx, t, p, col_sums=True)
    for _ in range(2):
        new = spmm.spmm_t(vals, idx, t, p, col_sums=True)
        assert all(torch.equal(a, b) for a, b in zip(new, old))
    assert torch.equal(spmm.spmm_t(vals, idx, t, p), old[0])


def test_lloyd_update_is_bit_reproducible(dev):
    """Lloyd's center update on the card (K6's walk over the rows'
    transposition, built once, and the counts' integer histogram) is
    bit-identical from call to call and equals
    the plain scatter-add in row order on the CPU bit for bit; a whole
    sparse_kmeans_core fit on the card repeats its centers, labels and
    iteration count exactly."""
    from repro_torch.core import kmeans
    from repro_torch.utils import prng

    n, p, m, k = 4096, 16384, 819, 10
    rng = np.random.default_rng(5)
    idx = np.sort(np.argsort(rng.random((n, p)), axis=1)[:, :m], axis=1).astype(np.int32)
    vals = rng.normal(size=(n, m)).astype(np.float32)
    labels = rng.integers(0, k, n).astype(np.int32)
    v, i, a = (torch.from_numpy(t).to(dev) for t in (vals, idx, labels))
    cols = ops.cluster_columns(v, i, p)
    first = ops.cluster_sums(v, i, a, k, p, cols)
    again = ops.cluster_sums(v, i, a, k, p, cols)
    plain = ref.ref_cluster_sums(*(torch.from_numpy(t) for t in (vals, idx, labels)), k, p)
    for got, same, want in zip(first, again, plain):
        assert torch.equal(got, same) and torch.equal(got.cpu(), want)
    # rows near k planted centers, each keeping every 20th coordinate
    centers = rng.normal(size=(k, m))
    v = torch.from_numpy((centers[labels] + 0.1 * rng.normal(size=(n, m))).astype(np.float32))
    v = v.to(dev)
    i = torch.arange(m, dtype=torch.int32, device=dev)[None].repeat(n, 1) * (p // m)
    fits = [kmeans.sparse_kmeans_core(v, i, p, k, prng.PRNGKey(7), n_init=2, max_iter=30,
                                      assign_fn=ops.kernel_assign_fn()) for _ in range(2)]
    for f1, f2 in zip(*fits):
        assert torch.equal(f1, f2)


def _sketched(dev, n, p, m, seed):
    rng = np.random.default_rng(seed)
    idx = np.sort(np.argsort(rng.random((n, p)), axis=1)[:, :m], axis=1).astype(np.int32)
    vals = rng.normal(size=(n, m)).astype(np.float32)
    from repro_torch.core.sampling import SparseRows

    return SparseRows(torch.from_numpy(vals).to(dev), torch.from_numpy(idx).to(dev), p)


@pytest.mark.parametrize("cov_path", ["dense", "compact", "lowrank"])
def test_fold_repeats_bit_for_bit(dev, cov_path):
    """One engine step folded twice from the same state and batch gives the
    same bits: Σw by the dense batch's column sums (dense) or K6 (compact),
    the K-means sums by K6, the compact covariance at m/p = 0.05 by chunked
    fp32 products, the range state by K5/K6 (phase 5's shapes at
    fewer rows: p = 16384, m = 819, r = 3, K = 10; the low-rank path at
    p = 65536, l = 128)."""
    from repro_torch.api import Plan, make_engine
    from repro_torch.stream import StreamKMeansConfig
    from repro_torch.stream import state as state_mod

    p = 65536 if cov_path == "lowrank" else 16384
    kw = dict(rank=128) if cov_path == "lowrank" else {}
    rows = torch.from_numpy(np.random.default_rng(9).normal(size=(1, 1024, p)).astype(
        np.float32)).to(dev)
    eng = make_engine(Plan(backend="stream", gamma=0.05, batch_size=1024, cov_path=cov_path,
                           **kw), p, 1, lambda seed, step, shard: rows[0],
                      kmeans=StreamKMeansConfig(k=10, n_init=3, track_reassignments=True))
    state = eng.init_state()
    a = state_mod.engine_to_arrays(eng.update(state, rows, 0))
    b = state_mod.engine_to_arrays(eng.update(state, rows, 0))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("m", [82, 819])
def test_compact_covariance_repeats_and_matches_plain(dev, m):
    """The compact covariance on the card at p = 16384: at m = 82 (m/p =
    0.005) summed by key (a stable sort and K6's segment walk, which equals
    its plain version within 1e-6 of the largest run), at m = 819 by chunked
    products; each bit-identical across calls and within 1e-5 of the n·m²
    scatter-add on the CPU."""
    from repro_torch.core import estimators

    s = _sketched(dev, 1024, 16384, m, seed=8)
    keyed = m <= estimators.COMPACT_KEYED_FILL * s.p
    assert keyed == (m == 82)
    k6 = spmm.spmm_t.launches
    first = estimators._scatter_outer(s.values, s.indices, s.p)
    assert (spmm.spmm_t.launches > k6) == keyed
    assert torch.equal(first, estimators._scatter_outer(s.values, s.indices, s.p))
    want = estimators._scatter_outer_plain(s.values.cpu(), s.indices.cpu(), s.p)
    assert (first.cpu() - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    vals = torch.randn(5000, device=dev)
    order = torch.randperm(5000, device=dev).to(torch.int32)
    starts = torch.cat([torch.zeros(1, dtype=torch.int64),
                        torch.randint(0, 40, (300,)).cumsum(0).clamp(max=5000),
                        torch.tensor([5000])]).to(torch.int32).to(dev)
    got = ops.segment_sums(vals, order, starts)
    plain = ref.ref_segment_sums(vals.cpu(), order.cpu(), starts.cpu())
    assert torch.equal(got, ops.segment_sums(vals, order, starts))
    assert (got.cpu() - plain).abs().max().item() <= 1e-6 * plain.abs().max().item()


def test_column_sums_and_hypothesis_sums(dev):
    """K6's column sums (Σv, Σv²) within 1e-5 of the CPU's scatter-add and
    bit-identical across calls; the r-hypothesis cluster sums (one walk over
    r·K label columns) bit-equal to the CPU's scatter-add in row order."""
    s = _sketched(dev, 4096, 16384, 819, seed=6)
    first = ops.column_sums(s.values, s.indices, s.p)
    again = ops.column_sums(s.values, s.indices, s.p)
    plain = ref.ref_column_sums(s.values.cpu(), s.indices.cpu(), s.p)
    for got, same, want in zip(first, again, plain):
        assert torch.equal(got, same)
        assert (got.cpu() - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    labels = torch.from_numpy(np.random.default_rng(7).integers(0, 10, (3, 4096)).astype(
        np.int32)).to(dev)
    sums, counts = ops.cluster_sums(s.values, s.indices, labels, 10, s.p)
    want_s, want_c = ref.ref_cluster_sums(s.values.cpu(), s.indices.cpu(), labels.cpu(), 10, s.p)
    assert sums.shape == (3, 10, s.p)
    assert torch.equal(sums.cpu(), want_s) and torch.equal(counts.cpu(), want_c)


def test_kmeans2_delta_matches_plain(dev):
    """kmeans2_delta on the card (K4 for the frozen-center labels and the
    flips, K6's walk and the integer histogram for the sums and counts)
    against its plain version on the CPU: sums and counts bit-equal where the
    labels agree (they do here: no near-ties), objective 1e-5 relative."""
    from repro_torch import refine

    s = _sketched(dev, 4096, 16384, 819, seed=8)
    rng = np.random.default_rng(8)
    frozen = torch.from_numpy(rng.normal(size=(10, 16384)).astype(np.float32)).to(dev)
    prev = frozen + 0.5 * torch.from_numpy(rng.normal(size=(10, 16384)).astype(np.float32)).to(dev)
    got = refine.kmeans2_delta(s, frozen, prev)
    again = refine.kmeans2_delta(s, frozen, prev)
    from repro_torch.core.sampling import SparseRows

    want = refine.kmeans2_delta(SparseRows(s.values.cpu(), s.indices.cpu(), s.p), frozen.cpu(),
                                prev.cpu())
    for f in ("sums", "cnts", "flips", "count"):
        assert torch.equal(getattr(got, f), getattr(again, f))
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert abs(got.obj.item() - want.obj.item()) <= 1e-5 * abs(want.obj.item())


def test_power_pass_matches_plain(dev):
    """One power pass at the low-rank path's shape (p = 65536, l = 128): the
    range delta with Q in Ω's place (K5, K6) within 1e-5 of the largest
    output of the plain version, bit-identical across calls, and the next
    basis's span within a principal-angle sine of 1e-4 of the CPU's (all
    128 columns: on random rows the leading few singular values lie too
    close for a slice of them to be a stable subspace)."""
    from repro_torch import lowrank, refine

    s = _sketched(dev, 4096, 65536, 3277, seed=10)
    q = torch.linalg.qr(torch.randn((65536, 128), generator=torch.Generator().manual_seed(0)))[0]
    q_dev = q.to(dev).contiguous()
    got = lowrank.range_delta(s, q_dev)
    again = lowrank.range_delta(s, q_dev)
    from repro_torch.core.sampling import SparseRows

    want = lowrank.range_delta(SparseRows(s.values.cpu(), s.indices.cpu(), s.p), q)
    for f in ("y", "diag", "sum_w"):
        assert torch.equal(getattr(got, f), getattr(again, f))
        w = getattr(want, f)
        assert (getattr(got, f).cpu() - w).abs().max().item() <= 1e-5 * w.abs().max().item(), f
    q1 = refine.power_orth(got, q_dev, 3277)
    q1_cpu = refine.power_orth(want, q, 3277)
    assert q1.is_contiguous() and q1.dtype == torch.float32
    assert refine.subspace_change(q1.cpu(), q1_cpu) <= 1e-4


_FIRST_LAUNCHES = r'''
import sys, tempfile, threading
from pathlib import Path
import torch
from repro_torch import obs
from repro_torch.kernels import _build, ops, ref

_build.BUILD_DIR = Path(tempfile.mkdtemp())       # nothing built: the threads race to build
reg = obs.MetricsRegistry()
obs.set_default_registry(reg)
dev = torch.device("cuda")
n, p, m, threads = 512, 16384, 819, 4
start, errors = threading.Barrier(threads), []

def work(seed):
    try:
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((n, p), generator=g, device=dev)
        s = torch.where(torch.rand(p, generator=g, device=dev) < 0.5, -1.0, 1.0)
        idx = torch.sort(torch.rand((n, p), generator=g, device=dev).argsort(1)[:, :m], 1)
        idx = idx.values.to(torch.int32).contiguous()
        c = torch.randn((3, 10, p), generator=g, device=dev)
        t = torch.randn((n, 30), generator=g, device=dev)
        start.wait()
        v = ops.sketch_fused(x, s, idx)
        d, a = ops.sparse_assign(v, idx, c)
        y = ops.spmm_t(v, idx, t, p)
        torch.cuda.synchronize()
        assert torch.equal(v, ref.ref_sketch_fused(x, s, idx)), "K1"
        dr, _ = ref.ref_sparse_assign(v, idx, c)
        assert (d - dr).abs().max().item() <= 1e-5 * dr.abs().max().item(), "K4"
        yr = ref.ref_spmm_t(v, idx, t, p)
        assert (y - yr).abs().max().item() <= 1e-5 * yr.abs().max().item(), "K6"
    except Exception as e:  # noqa: BLE001 - reported below
        errors.append(repr(e))

ts = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
for t_ in ts:
    t_.start()
for t_ in ts:
    t_.join(timeout=600)
assert not any(t_.is_alive() for t_ in ts), "a thread hung"
assert not errors, errors
counts = ops.launch_counts()
for name in ("sketch_fused", "sparse_assign", "spmm_t", "transpose_columns"):
    assert counts[name] == threads, (name, counts)
for op in ("sketch_fused", "sparse_assign", "spmm_t"):
    assert ops.DISPATCH[(op, "kernel")] == threads, ops.DISPATCH
    assert reg.counter("kernels.dispatch", op=op, path="kernel").value == threads
assert sorted(q.name for q in _build.BUILD_DIR.glob("*.so")) == sorted(
    _build._target(nm).name for nm in _build.SIGNATURES), "one library a source"
print("ok")
'''


def test_first_launches_from_threads_at_once(dev):
    """A fresh process whose four threads make their first launches of K1,
    K4 and K6 at once, with nothing built: one nvcc a source (the build lock),
    each result against its plain version (K1 bit-equal, K4 and K6 within
    1e-5 of the largest output), and the launch counts, the dispatch tally
    and the registry's ``kernels.dispatch`` series adding up to 4 each."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", _FIRST_LAUNCHES], capture_output=True,
                         text=True, env=env, cwd=root, timeout=900)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stdout + out.stderr


# ------------------------------------------------ collectives on the card --

_PSUM = """
import sys
import torch
import torch.distributed as dist
from repro_torch import cluster
from repro_torch.stream.sharded import psum

pid, nproc, port, backend = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
cluster.initialize(f"127.0.0.1:{port}", nproc, pid, backend=backend, device="cuda")
dev = torch.device("cuda", torch.cuda.current_device())
mesh = cluster.process_mesh(2)
assert mesh.collective and dist.get_backend() == backend
g = torch.Generator().manual_seed(pid)
f = torch.randn((1000, 7), generator=g).to(dev)
i = torch.tensor([-7, 2**31 - 1 - pid, -(2**31) + 5, 65536 * 3 + pid], dtype=torch.int32,
                 device=dev)
c = torch.tensor(123456789012 + pid, dtype=torch.int64, device=dev)
out = psum((f, (i, c)), mesh)
fs = [torch.randn((1000, 7), generator=torch.Generator().manual_seed(r)) for r in range(nproc)]
want_f = fs[0] if nproc == 1 else fs[0] + fs[1]
assert torch.equal(out[0].cpu(), want_f), "float sum"
ints = [torch.tensor([-7, 2**31 - 1 - r, -(2**31) + 5, 65536 * 3 + r], dtype=torch.int64)
        for r in range(nproc)]
assert torch.equal(out[1][0].cpu(), sum(ints).to(torch.int32)), "int32 sum, wrapped"
assert int(out[1][1]) == sum(123456789012 + r for r in range(nproc)), "int64 sum"
assert out[0].is_cuda and out[1][0].dtype == torch.int32
if nproc > 1:
    t = torch.full((3,), float(pid), device=dev)
    parts = [torch.empty_like(t) for _ in range(nproc)]
    dist.all_gather(parts, t)
    assert [float(p[0]) for p in parts] == [float(r) for r in range(nproc)]
    b = torch.full((2,), float(pid + 10), device=dev)
    dist.broadcast(b, src=0)
    assert float(b[0]) == 10.0
if backend == "nccl" and nproc > 1:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        psum(f, mesh)
        torch.cuda.synchronize()
    assert any("nccl" in e.key.lower() for e in prof.key_averages()), "no NCCL kernel ran"
view = cluster.gather(cluster.beat(5, rows=10 * (pid + 1), t=100.0 + pid))
assert int(view.hosts) == nproc and int(view.rows) == sum(10 * (r + 1) for r in range(nproc))
cluster.shutdown()
print("ok")
"""


def _run_ranks(nproc: int, backend: str) -> None:
    import os
    import subprocess
    import sys

    from repro_torch.cluster.bootstrap import free_port

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _PSUM, str(r), str(nproc), port, backend],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                              cwd=root) for r in range(nproc)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0 and out.strip().endswith("ok"), out + err


def test_psum_one_rank_nccl(dev):
    """A one-process NCCL group: psum still runs NCCL's all-reduce on the
    card, and floats, int32 (wrapping) and int64 fields come back exact."""
    _run_ranks(1, "nccl")


def test_gloo_collectives_take_cuda_tensors(dev):
    """Two ranks on one card over gloo: psum, all_gather and broadcast of
    CUDA tensors, exact, and the heartbeat's all-gather."""
    _run_ranks(2, "gloo")


def test_psum_two_ranks_nccl_on_two_cards(dev):
    """Two ranks, each on its own card, over NCCL: psum exact, and NCCL's
    all-reduce kernel on the device (torch.profiler)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: NCCL takes a card a rank")
    _run_ranks(2, "nccl")


def test_nccl_refuses_two_ranks_on_one_card(dev):
    from repro_torch import cluster

    if torch.cuda.device_count() > 1:
        pytest.skip("more than one card: NCCL can give each rank its own")
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        cluster.initialize("127.0.0.1:1", 2, 0, backend="nccl", device="cuda")
