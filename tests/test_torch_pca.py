"""``repro_torch.core.pca.recovered_components`` (the paper's Table-I
metric) against ``repro.core.pca``'s on the reference's cases
(``tests/test_pca.py``), the one-to-one case included, and on random
estimates of planted components."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pca as jpca
from repro_torch.core import pca


def test_recovered_components_one_to_one():
    """One estimate aligned with two true PCs is credited once; a clean
    one-to-one alignment counts fully whatever the order and signs; nothing
    above the threshold counts zero — as the reference's, and equal to it."""
    u = np.eye(4, dtype=np.float32)[:2]
    est = np.stack([(u[0] + u[1]) / np.sqrt(2.0), np.eye(4, dtype=np.float32)[2]])
    cases = [(est, u, 0.6, 1), (np.stack([-u[1], u[0]]), u, 0.95, 2),
             (np.eye(4, dtype=np.float32)[2:4], u, 0.9, 0)]
    for e, t, thresh, want in cases:
        got = pca.recovered_components(torch.from_numpy(e), torch.from_numpy(t), thresh=thresh)
        assert got == want == int(jpca.recovered_components(jnp.asarray(e), jnp.asarray(t),
                                                             thresh=thresh))


@pytest.mark.parametrize("seed", range(4))
def test_recovered_components_matches_reference(seed):
    """Noisy estimates of planted components (numpy arrays and tensors, more
    estimates than true ones) at three thresholds: the reference's count."""
    rng = np.random.default_rng(seed)
    p, kt, ke = 64, 5, 7
    true = np.linalg.qr(rng.normal(size=(p, kt)))[0].T.astype(np.float32)
    est = np.concatenate([true[rng.permutation(kt)] * rng.choice([-1, 1], (kt, 1)),
                          rng.normal(size=(ke - kt, p))]).astype(np.float32)
    est += rng.normal(scale=0.05 * (seed + 1), size=est.shape).astype(np.float32)
    est /= np.linalg.norm(est, axis=1, keepdims=True)
    for thresh in (0.5, 0.9, 0.99):
        want = int(jpca.recovered_components(jnp.asarray(est), jnp.asarray(true), thresh))
        assert pca.recovered_components(est, true, thresh) == want
        assert pca.recovered_components(torch.from_numpy(est), torch.from_numpy(true),
                                        thresh) == want
