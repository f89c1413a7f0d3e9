"""repro_torch.models.moe against repro.models.moe on the CPU.

The reference's MoE weights (``init_moe_params``, float32, d = 32, f = 64,
E = 8, top-2) are carried into the port and the same numpy-seeded tokens go
through both.

- ``moe_apply_local`` with and without a shared expert, at capacity factors
  100 (nothing drops), 1.25 and 0.5 (tokens drop): the routed ids and the
  dispatch (sort order, position in bucket, kept slots) exactly; ``y``,
  ``aux`` and the gradients of ``Σ y² + aux`` with respect to the router,
  the three expert weights, the shared expert and ``x`` within 1e-5 of
  their largest entry. A zero router (every probability tied) routes to
  experts 0 and 1, as ``lax.top_k`` does.
- ``moe_apply_ep`` over gloo, on 2 ranks (mesh 1 × 2) and 4 (2 × 2), each
  rank holding its block of x's rows and sequence and its block of the
  experts: against the reference's ``moe_apply_ep`` on 8 forced host
  devices in a subprocess (its outputs read through ``np.asarray``), at
  capacity factors 1.25, 0.5 (both stages of the dispatch drop slots) and
  100: ``y`` and ``aux`` within 1e-5, and ``jax.grad`` of ``Σ y² + aux``
  within 1e-5 — the router's and the shared expert's summed over the data
  rows (each rank holds its "model" group's sum), the experts' over every
  rank's block, x's block by block. At capacity 100 also against
  ``moe_apply_local`` within the reference's own tolerance (atol 2e-4, rtol
  2e-3, ``tests/test_distributed.py``).
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker
from repro.models import moe as jmoe
from repro_torch.models import moe
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path
from torch_layout import prng_layout  # noqa: F401  (the port's draws in JAX's layout)

D, F, E, K = 32, 64, 8, 2
CAPACITIES = (100.0, 1.25, 0.5)
MESHES = ((1, 2), (2, 2))
X_EP = (4, 32)          # (B, S) of the EP tests' tokens


def _params(shared: int):
    jp = jmoe.init_moe_params(jax.random.PRNGKey(0), D, F, E, shared, F, jnp.float32)
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def _close(got, want, rel, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1e-30, float(np.abs(want).max())),
                               err_msg=what)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("cf", CAPACITIES)
@pytest.mark.parametrize("shared", [0, 1])
def test_local_matches_reference(shared, cf):
    """Routing and dispatch exactly, output, aux and gradients within 1e-5."""
    jp, p = _params(shared)
    x = _tokens((64, D))
    jids, jgates, jme, jce = jmoe.route(jp["router"], jnp.asarray(x), K)
    ids, gates, me, ce = moe.route(p["router"], torch.from_numpy(x), K)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    for got, want in ((gates, jgates), (me, jme), (ce, jce)):
        _close(got, want, 1e-6)
    cap = moe.capacity(64, K, E, cf)
    assert cap == max(8, -(-int(np.ceil(64 * K / E * cf)) // 8) * 8)
    want = jmoe._dispatch_indices(jids.reshape(-1), E, cap)
    got = moe._dispatch_indices(ids.reshape(-1), E, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dropped = int((~got[3]).sum())
    if cf == 100.0:
        assert dropped == 0
    elif cf == 0.5:
        assert dropped > 0

    def jloss(pp, xx):
        y, aux = jmoe.moe_apply_local(pp, xx, K, cf)
        return (y ** 2).sum() + aux, (y, aux)

    (_, (jy, jaux)), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = [leaf.requires_grad_(True) for leaf in tree_leaves(p)]
    y, aux = moe.moe_apply_local(p, xt, K, cf)
    grads = torch.autograd.grad((y ** 2).sum() + aux, leaves + [xt])
    _close(y, jy, 1e-5, "y")
    _close(aux, jaux, 1e-5, "aux")
    names = [n for n, _ in tree_leaves_with_path(p)] + ["x"]
    for name, g, w in zip(names, grads, jax.tree.leaves(jg) + [jgx]):
        _close(g, w, 1e-5, name)


def test_tied_router_takes_the_lower_experts():
    """A zero router gives every expert probability 1/E: top-k takes experts
    0 … k−1 for every token, as the reference does, and each of the two
    buckets keeps the first ``capacity`` tokens' slots."""
    jp, p = _params(0)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    x = _tokens((64, D), seed=1)
    ids = moe.route(p["router"], torch.from_numpy(x), K)[0]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jmoe.route(jp["router"],
                                                                     jnp.asarray(x), K)[0]))
    assert (ids.numpy() == np.arange(K)).all()
    jy, jaux = jmoe.moe_apply_local(jp, jnp.asarray(x), K, 1.25)
    y, aux = moe.moe_apply_local(p, torch.from_numpy(x), K, 1.25)
    _close(y, jy, 1e-5)
    _close(aux, jaux, 1e-6)
    cap = moe.capacity(64, K, E, 1.25)
    assert not y[cap:].any() and y[:cap].abs().min() > 0


# the reference's moe_apply_ep on 8 forced host devices: y, aux and the
# gradients of Σ y² + aux (the parameters' leaves in tree order, then x's)
_REFERENCE = """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.launch.mesh import make_host_mesh
    from repro.models import moe

    D, F, E, K = {D}, {F}, {E}, {K}
    p = moe.init_moe_params(jax.random.PRNGKey(0), D, F, E, 1, F, jnp.float32)
    x = jnp.asarray(np.random.default_rng(0).normal(size={X_EP} + (D,)).astype(np.float32))
    out = {{}}
    for shape in {MESHES}:
        mesh = make_host_mesh(*shape)
        for cf in {CAPACITIES}:
            def loss(pp, xx):
                y, aux = moe.moe_apply_ep(pp, xx, K, cf, mesh, ("data",), "model")
                return (y ** 2).sum() + aux, (y, aux)
            (_, (y, aux)), (g, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(p, x)
            tag = f"{{shape}}{{cf}}"
            out["y" + tag], out["aux" + tag] = np.asarray(y), np.asarray(aux)
            for i, a in enumerate(jax.tree.leaves(g) + [gx]):
                out[f"g{{i}}" + tag] = np.asarray(a)
    np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference_ep(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("moe_ref") / "ref.npz")
    script = textwrap.dedent(_REFERENCE.format(D=D, F=F, E=E, K=K, X_EP=X_EP, MESHES=MESHES,
                                               CAPACITIES=CAPACITIES))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, ["src", os.environ.get("PYTHONPATH")])))
    subprocess.run([sys.executable, "-c", script, path], check=True, env=env, timeout=600)
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port_ep(tmp_path_factory):
    """Each mesh's ranks' outputs, by rank (one gloo run a mesh)."""
    _, p = _params(1)
    x = _tokens(X_EP + (D,))
    out = {}
    for shape in MESHES:
        job = dict(params=p, x=x, k=K, capacity_factors=CAPACITIES,
                   mesh=(shape, ("data", "model")))
        out[shape] = torch_dp_worker.run("moe_ep", job, shape[0] * shape[1],
                                         str(tmp_path_factory.mktemp("moe_ep")),
                                         jax.config.jax_threefry_partitionable)
    return out


def _assemble(ranks, case, shape):
    """The ranks' y blocks as (B, S, d), their aux, and the summed gradients:
    the router's and the shared expert's over one rank a data row, the
    experts' over every rank, x's blocks placed."""
    B, S = X_EP
    bl, sl = B // shape[0], S // shape[1]
    y, gx = np.zeros(X_EP + (D,), np.float32), np.zeros(X_EP + (D,), np.float32)
    auxs = []
    n_leaves = len(ranks[0]["cases"][case]["grads"]) - 1
    sums = [0.0] * n_leaves
    for r in ranks:
        c = r["cases"][case]
        di, mi = c["coords"]
        rows, cols = slice(di * bl, (di + 1) * bl), slice(mi * sl, (mi + 1) * sl)
        y[rows, cols] = c["y"].numpy()
        gx[rows, cols] = c["grads"][-1].numpy()
        auxs.append(float(c["aux"]))
        for i, g in enumerate(c["grads"][:-1]):
            expert = g.dim() == 3
            if expert or mi == 0:
                sums[i] = sums[i] + g.numpy()
    assert len(set(auxs)) == 1, auxs        # every rank holds the global-batch aux
    return y, auxs[0], sums + [gx]


@pytest.mark.parametrize("cf", CAPACITIES)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ep_matches_reference_ep(shape, cf, reference_ep, port_ep):
    """y, aux and every gradient within 1e-5 of the reference's EP."""
    tag = f"{shape}{cf}"
    y, aux, grads = _assemble(port_ep[shape], CAPACITIES.index(cf), shape)
    _close(y, reference_ep["y" + tag], 1e-5, "y")
    _close(np.float32(aux), reference_ep["aux" + tag], 1e-5, "aux")
    _, p = _params(1)
    names = [n for n, _ in tree_leaves_with_path(p)] + ["x"]
    for i, (name, g) in enumerate(zip(names, grads)):
        _close(g, reference_ep[f"g{i}" + tag], 1e-5, name)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ep_matches_local(shape, port_ep):
    """At capacity 100 nothing drops: EP over the ranks is the reference's
    moe_apply_local on all the tokens, within its own test's tolerance."""
    jp, _ = _params(1)
    x = _tokens(X_EP + (D,))
    jy, jaux = jmoe.moe_apply_local(jp, jnp.asarray(x.reshape(-1, D)), K, 100.0)
    y, aux, _ = _assemble(port_ep[shape], CAPACITIES.index(100.0), shape)
    np.testing.assert_allclose(y.reshape(-1, D), np.asarray(jy), atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(aux, float(jaux), rtol=1e-4)
