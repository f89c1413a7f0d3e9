"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: on a machine with no card every test skips (the check is made
inside a fixture). On the card run ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_kernels_cuda.py``. Shapes are the streaming engine's
(4096 rows a step, p = 16384, m = 819, K = 10, r = 3) plus the edges: the
p = 2^15 ceiling, ragged row counts and p < 32.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fwht, ops, ref, sketch_fused, sparse_assign

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


def test_above_single_row_ceiling_raises_naming_k3(dev):
    x, s, idx = _case(2, 1 << 16, 4, dev)
    with pytest.raises(ValueError, match="K3"):
        fwht.hd_precondition(x, s)
    with pytest.raises(ValueError, match="K3"):
        ops.sketch_fused(x, s, idx)


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
