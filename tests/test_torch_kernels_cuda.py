"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: on a machine with no card every test skips (the check is made
inside a fixture). On the card run ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_kernels_cuda.py``. Shapes are the streaming engine's
(4096 rows a step, p = 16384, m = 819, K = 10, r = 3) and the low-rank path's
(p = 65536, m = 3277, l = 128) plus the edges: the p = 2^15 ceiling of K1/K2,
K3's outer passes at 2^17 and 2^21, ragged row counts, p < 32 and an l that is
not a multiple of 32.

Tolerances: K1–K3 are bit-equal to the plain butterfly (same stages, same
order). K5/K6 sum in another order than the plain einsum/index_add, so they
are held to 1e-5 of the largest output; K6 is bit-identical across launches.
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


@pytest.mark.parametrize("n,p", [(64, 1 << 16), (10, 1 << 16), (3, 1 << 17), (2, 1 << 21)])
@pytest.mark.parametrize("signs_after", [False, True])
def test_chunked_transform_matches_plain(dev, n, p, signs_after):
    x, s, _ = _case(n, p, 1, dev)
    before = fwht.hd_precondition_chunked.launches
    got = fwht.hd_precondition(x, s, signs_after=signs_after)      # p > 2^15: K3
    torch.cuda.synchronize()
    assert fwht.hd_precondition_chunked.launches == before + 1
    assert torch.equal(got, ref.ref_hd_precondition(x, s, signs_after=signs_after))


def test_sketch_fused_above_the_ceiling_composes_k3(dev):
    x, s, idx = _case(16, 1 << 16, 3277, dev)
    ops.reset_counts()
    got = ops.sketch_fused(x, s, idx)
    torch.cuda.synchronize()
    assert ops.launch_counts()["hd_precondition_chunked"] == 1
    assert ops.DISPATCH[("sketch_fused", "kernel_chunked")] == 1
    assert torch.equal(got, ref.ref_sketch_fused(x, s, idx))
    with pytest.raises(ValueError, match="K3"):
        sketch_fused.sketch_fused(x, s, idx)           # K1 alone stays single-row


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
