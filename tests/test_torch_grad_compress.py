"""repro_torch.core.grad_compress and api.GradCompressor against the reference
(repro.core.grad_compress, repro.api.GradCompressor) on the CPU.

The reference and the port get the same numpy vectors and trees and the same
key. Masks (the kept coordinates) are bit-equal; the kept values, ĝ and the
residual agree to 1e-5 relative to their largest value (both run the same
butterfly; the port's float32 sums may round otherwise). The reference runs
its jnp ROS path, as its own tests run it on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import grad_compress as jgc
from repro.core import ros as jros
from repro.core import sketch as jsketch
from repro.core.sampling import sample_indices as jsample
from repro.utils.tree import tree_flatten_to_vector as jflatten
from repro_torch import api
from repro_torch.core import grad_compress as gc
from repro_torch.core import ros, sketch
from repro_torch.core.sampling import sample_indices
from repro_torch.utils import prng
from repro_torch.utils.tree import tree_flatten_to_vector, tree_leaves_with_path
from torch_layout import prng_layout  # noqa: F401  (the port's draws in JAX's layout)

CPU = dict(device="cpu")



@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the models' many small ops slow down several
    times over when test workers' threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _kd(key):
    return np.asarray(jax.random.key_data(key))


def _close(got, want, rel=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1e-30, float(np.abs(want).max())))


def _tree(seed=0):
    """A stacked-layer gradient tree (the transformer's layout) of 5,680 values."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"layers": {"mlp": {"up": f(2, 16, 40), "down": f(2, 40, 16)},
                       "ln1": f(2, 16), "attn": {"wq": f(2, 16, 32)}},
            "embed": f(64, 16), "final_norm": f(16), "lm_head": f(16, 64)}


def _torch_tree(t):
    return jax.tree.map(torch.from_numpy, t)


def _jax_tree(t):
    return jax.tree.map(jnp.asarray, t)


def test_flatten_order_is_jax_order():
    """Stacked leaves flatten layer-major, dict keys sorted, as
    jax.tree_util does; the names are keystr's."""
    t = _tree()
    vec, unflatten = tree_flatten_to_vector(_torch_tree(t))
    jvec, _ = jflatten(_jax_tree(t))
    np.testing.assert_array_equal(vec.numpy(), np.asarray(jvec))
    names = [n for n, _ in tree_leaves_with_path(t)]
    assert names == [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(t)]
    back = unflatten(vec)
    for (n, a), (_, b) in zip(tree_leaves_with_path(back), tree_leaves_with_path(t)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=n)


@pytest.mark.parametrize("unbiased", [True, False])
@pytest.mark.parametrize("n,chunk_p,gamma,step,shard", [(1024, 256, 0.25, 7, 0),
                                                         (5000, 1024, 0.1, 3, 2),
                                                         (40000, 1 << 14, 0.1, 0, 0)])
def test_compress_decompress_matches_reference(unbiased, n, chunk_p, gamma, step, shard):
    cfg = gc.CompressConfig(gamma=gamma, chunk_p=chunk_p, error_feedback=not unbiased)
    jcfg = jgc.CompressConfig(gamma=gamma, chunk_p=chunk_p, error_feedback=not unbiased)
    key = jax.random.PRNGKey(5)
    vec = np.random.default_rng(n).normal(size=n).astype(np.float32)
    g_hat, vals = gc.compress_decompress(torch.from_numpy(vec), _kd(key), step, cfg,
                                         unbiased=unbiased, shard=shard)
    jg_hat, jvals = jgc.compress_decompress(jnp.asarray(vec), key, jnp.int32(step), jcfg,
                                            unbiased=unbiased, shard=shard)
    # the mask: the same coordinates, from the same (step, shard) key
    nc = -(-n // chunk_p)
    spec = gc.mask_spec(cfg, _kd(key))
    idx = sample_indices(sketch.batch_key(spec, step, shard), nc, chunk_p, cfg.m)
    jidx = jsample(jsketch.batch_key(jgc.mask_spec(jcfg, key), jnp.int32(step), shard),
                   nc, chunk_p, jcfg.m)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    padded = torch.nn.functional.pad(torch.from_numpy(vec), (0, nc * chunk_p - n))
    y = ros.precondition(padded.reshape(nc, chunk_p), spec.signs_key(), "hadamard")
    np.testing.assert_array_equal(vals.numpy(), torch.gather(y, 1, idx.long()).numpy())
    assert vals.shape == (nc, cfg.m) and g_hat.shape == (n,)
    _close(vals, jvals)
    _close(g_hat, jg_hat)


@pytest.mark.parametrize("error_feedback", [True, False])
def test_perworker_mode_round_trip_matches_reference(error_feedback):
    """``CompressConfig(mode="per-worker")`` through compress_decompress and
    compress_grads: the reference reads no ``mode`` there, so it runs the
    shared-mask round trip, and so does the port (1e-5)."""
    cfg = gc.CompressConfig(gamma=0.25, chunk_p=256, error_feedback=error_feedback,
                            mode="per-worker")
    jcfg = jgc.CompressConfig(gamma=0.25, chunk_p=256, error_feedback=error_feedback,
                              mode="per-worker")
    key = jax.random.PRNGKey(4)
    vec = np.random.default_rng(9).normal(size=1000).astype(np.float32)
    g_hat, vals = gc.compress_decompress(torch.from_numpy(vec), _kd(key), 3, cfg)
    jg_hat, jvals = jgc.compress_decompress(jnp.asarray(vec), key, jnp.int32(3), jcfg)
    _close(vals, jvals)
    _close(g_hat, jg_hat)
    t = _tree(1)
    g_tree, res, wire = gc.compress_grads(_torch_tree(t), _kd(key), 2, cfg)
    jg_tree, jres, jwire = jgc.compress_grads(_jax_tree(t), key, jnp.int32(2), jcfg)
    assert wire == jwire and (res is None) == (jres is None) == (not error_feedback)
    _close(tree_flatten_to_vector(g_tree)[0], jflatten(jg_tree)[0])
    if error_feedback:
        _close(tree_flatten_to_vector(res)[0], jflatten(jres)[0])


def test_error_feedback_identity_and_residual():
    """ĝ + r' = g + r (the reference test's form, 1e-5), ĝ and r' as the
    reference's, over three steps of a carried residual."""
    cfg = gc.CompressConfig(gamma=0.1, chunk_p=256)
    jcfg = jgc.CompressConfig(gamma=0.1, chunk_p=256)
    key = jax.random.PRNGKey(2)
    res, jres = None, None
    for step in range(3):
        t = _tree(step)
        g_hat, res_new, wire = gc.compress_grads(_torch_tree(t), _kd(key), step, cfg, res)
        jg_hat, jres_new, jwire = jgc.compress_grads(_jax_tree(t), key, jnp.int32(step), jcfg,
                                                     jres)
        assert wire == jwire == 23 * cfg.m
        vec, _ = tree_flatten_to_vector(_torch_tree(t))
        if res is not None:
            vec = vec + tree_flatten_to_vector(res)[0]
        lhs = tree_flatten_to_vector(g_hat)[0] + tree_flatten_to_vector(res_new)[0]
        np.testing.assert_allclose(lhs.numpy(), vec.numpy(), atol=1e-5)
        _close(tree_flatten_to_vector(g_hat)[0], jflatten(jg_hat)[0])
        _close(tree_flatten_to_vector(res_new)[0], jflatten(jres_new)[0])
        res, jres = res_new, jres_new


def test_grad_compressor_state_and_reset():
    """GradCompressor's cursor, wire count and residual over three steps,
    equal to the reference's, and a reset compressor repeats step 0."""
    cfg = gc.CompressConfig(gamma=0.1, chunk_p=512)
    port = api.GradCompressor(cfg, key=11, shard=1, **CPU)
    ref = japi.GradCompressor(jgc.CompressConfig(gamma=0.1, chunk_p=512), key=11, shard=1)
    assert port.spec_.m == ref.spec_.m and port.spec_.p == ref.spec_.p
    np.testing.assert_array_equal(port.spec_.key, _kd(ref.spec_.key))
    first = None
    for step in range(3):
        t = _tree(10 + step)
        g = port.transform(_torch_tree(t))
        jg = ref.transform(_jax_tree(t))
        assert port.step_ == ref.step_ == step + 1
        assert port.wire_floats_ == ref.wire_floats_ == 12 * 51
        _close(tree_flatten_to_vector(g)[0], jflatten(jg)[0])
        _close(tree_flatten_to_vector(port.residual_)[0], jflatten(ref.residual_)[0])
        first = g if first is None else first
    assert port.reset() is port and port.residual_ is None and port.step_ == 0
    again = port.compress(_torch_tree(_tree(10)))
    for (n, a), (_, b) in zip(tree_leaves_with_path(again), tree_leaves_with_path(first)):
        assert torch.equal(a, b), n
    # an explicit step realigns the cursor, as a resumed trainer's does
    port.transform(_torch_tree(_tree(0)), step=9)
    assert port.step_ == 10


def test_wire_bytes():
    for mode in ("shared-mask", "per-worker"):
        for n_workers in (1, 8):
            got = gc.wire_bytes(1_301_802_624, gc.CompressConfig(gamma=0.1, mode=mode), n_workers)
            want = jgc.wire_bytes(1_301_802_624, jgc.CompressConfig(gamma=0.1, mode=mode),
                                  n_workers)
            assert got == want


def test_grad_compressor_shares_batch_key_discipline():
    """tests/test_api.py's case on the port: the compressor's per-step mask IS
    sample_indices(batch_key(spec, step, 0))."""
    cfg = gc.CompressConfig(gamma=0.25, chunk_p=256, error_feedback=False)
    key = prng.PRNGKey(5)
    vec = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1024,))))
    g_hat, vals = gc.compress_decompress(vec, key, 7, cfg)
    spec = gc.mask_spec(cfg, key)
    idx = sample_indices(sketch.batch_key(spec, 7, 0), 4, 256, cfg.m)
    y = ros.precondition(vec.reshape(4, 256), spec.signs_key(), "hadamard")
    np.testing.assert_array_equal(vals.numpy(), torch.gather(y, 1, idx.long()).numpy())
    assert g_hat.shape == vec.shape
    jy = jros.precondition(jnp.asarray(vec.numpy()).reshape(4, 256),
                           jgc.mask_spec(jgc.CompressConfig(gamma=0.25, chunk_p=256,
                                                            error_feedback=False),
                                         jax.random.PRNGKey(5)).signs_key(), "hadamard")
    _close(y, jy)


def test_grad_compressor_stateful_front_door():
    """tests/test_api.py's case on the port: state after one step, the
    error-feedback identity, a fresh compressor repeating step 0, and
    fit_many refusing it as a consumer."""
    rng = np.random.default_rng(0)
    g = {"a": torch.from_numpy(rng.normal(size=300).astype(np.float32)),
         "b": torch.from_numpy(rng.normal(size=(40, 10)).astype(np.float32))}
    comp = api.GradCompressor(gc.CompressConfig(gamma=0.1, chunk_p=256), key=3, **CPU)
    g1 = comp.transform(g)
    assert comp.step_ == 1 and comp.residual_ is not None and comp.wire_floats_ > 0
    assert set(g1) == set(g) and g1["b"].shape == g["b"].shape
    vec = torch.cat([g["a"], g["b"].reshape(-1)])
    v1 = torch.cat([g1["a"], g1["b"].reshape(-1)])
    rvec = torch.cat([comp.residual_["a"], comp.residual_["b"].reshape(-1)])
    np.testing.assert_allclose((v1 + rvec).numpy(), vec.numpy(), atol=1e-5)
    g1b = api.GradCompressor(gc.CompressConfig(gamma=0.1, chunk_p=256), key=3, **CPU).transform(g)
    assert torch.equal(g1["a"], g1b["a"])
    x = np.zeros((8, 16), np.float32)
    plan = api.Plan(backend="batch", gamma=0.25, batch_size=4)
    with pytest.raises(TypeError, match="SketchedEstimator"):
        api.fit_many(plan, [comp], x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.GradCompressor()
