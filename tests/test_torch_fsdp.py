"""FSDP placement of the trainer's state in repro_torch (``train/fsdp.py``)
against the reference's single-device step on the global batch, over 2 gloo
ranks on the CPU (``tests/torch_dp_worker.py`` task ``fsdp``, one start of
the ranks for every case).

Both packages start from the same weights: the port's draw, carried into
the reference leaf for leaf (the reverse of ``params_from_reference``;
drawing them in JAX would cost the module ≈ 10 s of compiles). A placed
step computes what the reference's step on the global batch computes in
exact arithmetic: the ranks' gradient blocks are the global gradient's (a
float32 mean over the ranks), each rank compresses its own range of
chunks with those rows' masks, and the one residual lives in those
ranges. The bounds are ``tests/test_torch_dp.py``'s (their derivation:
``tests/test_torch_train.py``'s docstring): loss, ``grad_norm``, ``nll``
and ``aux`` within 1e-5 relative, ``lr`` and ``wire_floats`` equal, the
residual within 1e-5 of its largest entry, the parameters within
``_params_close``'s bounds (under JAX's original threefry layout each
step starts from the port's state, ``_params_near_eps``); the masks
bit-equal. The ranks move the gradient into the chunk ranges and back in
runs of 4096 values (``fsdp.MOVE_VALUES``), so every case takes several
all-to-alls.
"""
import dataclasses
import shutil
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import torch_dp_worker
from jax._src import compilation_cache
from repro.configs.registry import get_arch as jget_arch
from repro.core import sampling as jsampling
from repro.core import sketch as jsketch
from repro.core.grad_compress import CompressConfig as JCompressConfig
from repro.core.grad_compress import mask_spec as jmask_spec
from repro.data.pipeline import SyntheticLMSource as JSource
from repro.models.api import get_api as jget_api
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro.utils.prng import fold_in_str as jfold_in_str
from repro_torch.cluster.bootstrap import Mesh
from repro_torch.configs.registry import get_arch, get_shape
from repro_torch.core import grad_compress as gc
from repro_torch.core.grad_compress import CompressConfig
from repro_torch.launch import dryrun
from repro_torch.models.api import get_api
from repro_torch.train import checkpoint, fsdp, optimizer, trainer
from repro_torch.utils.tree import tree_leaves_with_path, tree_map
from test_torch_train import LR, _as_jax, _as_torch, _params_close, _params_near_eps, _rel
from torch_layout import prng_layout  # noqa: F401  (the port's draws in JAX's layout)

# (id, arch, accum_steps, CompressConfig's fields)
# (cases that share a model shape run one after the other: the reference's
# eager steps then find each other's compiled code in the cache)
CASES = [("dense-ef-accum1", "gemma3-1b", 1, {"gamma": 0.1}),
         ("dense-noef-accum1", "gemma3-1b", 1, {"gamma": 0.1, "error_feedback": False}),
         ("dense-ef-accum2", "gemma3-1b", 2, {"gamma": 0.1}),
         ("moe-ef-accum1", "qwen3-moe-235b-a22b", 1, {"gamma": 0.1})]
STEPS, WORLD = 3, 2
OPT = dict(peak_lr=LR, warmup_steps=1, total_steps=3)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads, as tests/test_torch_train.py's."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def compile_cache(tmp_path_factory):
    """JAX's persistent compilation cache in a temporary directory for the
    module: the reference's eager step compiles its scans anew at every
    call, and the same code hits the cache (≈ 2 s a step instead of 4–6)."""
    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    before = {n: getattr(jax.config, n) for n in names}
    jax.config.update(names[0], str(tmp_path_factory.mktemp("jax-cache")))
    jax.config.update(names[1], 0.0)
    jax.config.update(names[2], -1)
    yield
    for n, v in before.items():
        jax.config.update(n, v)
    compilation_cache.reset_cache()


def _case(arch, accum, comp):
    """(reference config, port config, reference TrainerConfig, the port's
    TrainerConfig fields); the moe family at capacity factor 100 (nothing
    drops, so a rank's capacity changes nothing)."""
    changes = {"capacity_factor": 100.0} if arch.startswith("qwen3") else {}
    jcfg = dataclasses.replace(jget_arch(arch, reduced=True), **changes)
    cfg = dataclasses.replace(get_arch(arch, reduced=True), **changes)
    jt = jtrainer.TrainerConfig(opt=jopt.OptConfig(**OPT), accum_steps=accum, q_chunk=16,
                                kv_chunk=16, compress=JCompressConfig(**comp))
    tkw = dict(opt=optimizer.OptConfig(**OPT), accum_steps=accum, q_chunk=16, kv_chunk=16,
               compress=CompressConfig(**comp), dp_only=True)
    return jcfg, cfg, jt, tkw


def _initial(cfg, tkw):
    """(the reference's initial state, the port's): the port's draw, carried
    into the reference leaf for leaf."""
    key = np.asarray(jax.random.key_data(jax.random.PRNGKey(0)))
    state = trainer.init_state(get_api(cfg), trainer.TrainerConfig(**tkw), key, device="cpu")
    return tree_map(_as_jax, state), state


def _noisy(state, seed):
    """``state`` with seeded normal moments and residual (what a checkpoint
    after some steps holds)."""
    rng = np.random.default_rng(seed)
    out = {"params": state["params"], "opt": dict(state["opt"])}
    for k in ("m", "v"):
        out["opt"][k] = tree_map(lambda t: torch.from_numpy(
            np.abs(rng.normal(size=t.shape)).astype(np.float32)), state["opt"][k])
    out["residual"] = tree_map(lambda t: torch.from_numpy(
        rng.normal(size=t.shape).astype(np.float32)), state["residual"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, compile_cache):
    """The ranks' outputs (one start of 2 ranks for every case and the
    checkpoint tasks) beside each case's reference trajectory, computed
    while the ranks run (in JAX's partitionable layout; under the original
    one each test steps the reference from the port's states)."""
    tmp = tmp_path_factory.mktemp("fsdp")
    cases, refs = [], {}
    for cid, arch, accum, comp in CASES:
        jcfg, cfg, jt, tkw = _case(arch, accum, comp)
        jstate, state = _initial(cfg, tkw)
        source = JSource(cfg.vocab_size, 32, 4, seed=0)
        batches = [{k: torch.from_numpy(np.array(v)) for k, v in source.next_batch().items()}
                   for _ in range(STEPS)]
        cases.append(dict(cid=cid, cfg=cfg, tcfg=tkw, state=state, batches=batches,
                          jcfg=jcfg, jt=jt, jstate=jstate))
    # checkpoints to restore into a placed state: a whole one (one process's
    # save) and one with a residual for each of two ranks beside their mean
    whole = _noisy(cases[0]["state"], 1)
    checkpoint.save(str(tmp / "whole"), 5, whole, extra={"at": 5}, async_=False)
    rng = np.random.default_rng(2)
    ranks = [tree_map(lambda t: torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)),
                      whole["residual"]) for _ in range(2)]
    mean = tree_map(lambda a, b: (a + b) / 2, *ranks)
    arrays = {k: v for k, v in tree_leaves_with_path(whole) if not k.startswith("['residual']")}
    arrays.update(tree_leaves_with_path({"residual": mean, "rank_residual": ranks}))
    checkpoint.save_arrays(str(tmp / "pr22"), 6, arrays, extra={"at": 6})
    # the whole one with a byte of a parameter's member flipped
    shutil.copytree(tmp / "whole", tmp / "corrupt")
    name, _ = tree_leaves_with_path(whole["params"])[0]
    corrupt = _flip_a_byte(checkpoint.latest_step_dir(str(tmp / "corrupt")),
                           f"['params']{name}.npy")
    fac = dict(opt=optimizer.OptConfig(**OPT, factored=True, momentum=False), q_chunk=16,
               kv_chunk=16, compress=CompressConfig(gamma=0.1), dp_only=True)
    fac_cfg = cases[0]["cfg"]
    fac_state = trainer.init_state(get_api(fac_cfg), trainer.TrainerConfig(**fac),
                                   np.asarray([0, 5], np.uint32), device="cpu")
    job = dict(factored=dict(cfg=fac_cfg, tcfg=fac, state=fac_state,
                             batches=cases[0]["batches"]),
               key=np.asarray(jax.random.key_data(jax.random.PRNGKey(0))),
               cases=[{k: c[k] for k in ("cfg", "tcfg", "state", "batches")} for c in cases],
               save_dir=str(tmp / "saved"), move_values=4096,
               restore={"whole": str(tmp / "whole"), "pr22": str(tmp / "pr22"),
                        "corrupt": str(tmp / "corrupt")})
    partitionable = jax.config.jax_threefry_partitionable
    outs = {}
    ranks_run = threading.Thread(target=lambda: outs.update(enumerate(torch_dp_worker.run(
        "fsdp", job, WORLD, str(tmp), partitionable))))
    ranks_run.start()
    try:
        if partitionable:
            # one thread an architecture: much of an eager step is XLA's
            # compiles, which run outside the interpreter's lock
            by_arch = {}
            for c in cases:
                by_arch.setdefault(c["cfg"].name, []).append(c)
            with ThreadPoolExecutor(len(by_arch)) as pool:
                for got in pool.map(lambda cs: [(c["cid"], _reference(c, None)) for c in cs],
                                    by_arch.values()):
                    refs.update(got)
    finally:
        ranks_run.join()
    assert sorted(outs) == list(range(WORLD)), "a rank of the fsdp task failed"
    return dict(cases={c["cid"]: c for c in cases}, outs=[outs[r] for r in range(WORLD)],
                refs=refs, tmp=tmp, whole=whole, rank_residuals=ranks, mean=mean,
                corrupt=corrupt)


def _flip_a_byte(step_dir, member) -> str:
    """Flip one bit of a data byte of ``member`` of the step's arrays.npz in
    place (its CRC-32 in the zip's directory kept); returns the member."""
    path = f"{step_dir}/arrays.npz"
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(member)
    with open(path, "r+b") as f:
        checkpoint._member_header(f, path, info)
        at = f.tell() + 5
        f.seek(at)
        byte = f.read(1)[0]
        f.seek(at)
        f.write(bytes([byte ^ 1]))
    return member


def _reference(case, starts):
    """The reference's (state, metrics) after each step, from its initial
    state, or each from ``starts[step]`` (a port state, carried)."""
    jfn = jtrainer.make_train_fn(jget_api(case["jcfg"]), case["jt"], jtrainer.NO_DIST,
                                 jax.random.PRNGKey(0))
    jstate, out = case["jstate"], []
    for step, batch in enumerate(case["batches"]):
        start = tree_map(_as_jax, starts[step]) if starts is not None else jstate
        jstate, jm = jfn(start, {k: v.numpy() for k, v in batch.items()})
        out.append((jstate, jm))
    return out


def _masks(case, step):
    """The reference's (nc, m) mask of ``step``: every chunk's."""
    comp = case["jt"].compress
    n = sum(int(np.prod(t.shape)) for t in jax.tree.leaves(case["jstate"]["params"]))
    nc = -(-n // comp.chunk_p)
    spec = jmask_spec(comp, jfold_in_str(jax.random.PRNGKey(0), "grad-compress"))
    return np.asarray(jsampling.sample_indices(jsketch.batch_key(spec, step, 0), nc,
                                               comp.chunk_p, comp.m))


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_placed_steps_match_reference(runs, cid):
    """3 placed steps of a reduced config on 2 ranks (blocks of 2 of the 4
    rows) against the reference's make_train_fn on the 4 rows, compressed
    with and without error feedback, with 1 and 2 micro-batches, and for
    the moe family: the module docstring's bounds; the whole leaves (norms)
    the same on both ranks; each rank's masks the rows of its chunk range
    of the reference's, bit for bit."""
    case, outs = runs["cases"][cid], runs["outs"]
    carried = not jax.config.jax_threefry_partitionable
    steps = [o["cases"][[c[0] for c in CASES].index(cid)]["steps"] for o in outs]
    if carried:
        starts = [case["state"]] + [s["state"] for s in steps[0][:-1]]
        ref = _reference(case, starts)
    else:
        ref = runs["refs"][cid]
    ef = case["tcfg"]["compress"].error_feedback
    accum = case["tcfg"]["accum_steps"]
    for step, (jstate, jm) in enumerate(ref):
        got = steps[0][step]
        assert got["metrics"] == steps[1][step]["metrics"]
        for (name, a), (_, b) in zip(tree_leaves_with_path(got["state"]),
                                     tree_leaves_with_path(steps[1][step]["state"])):
            assert torch.equal(a, b), f"the ranks' gathered {name} differ at step {step}"
        m = got["metrics"]
        assert sorted(m) == sorted(jm)
        extra = () if accum > 1 else ("nll", "aux") if "aux" in m else ("nll",)
        for name in ("loss", "grad_norm") + extra:
            assert _rel(m[name], jm[name]) < 1e-5, (step, name, m[name], float(jm[name]))
        assert m["lr"] == float(jm["lr"]) and m["wire_floats"] == float(jm["wire_floats"])
        assert ("residual" in got["state"]) == ef == ("residual" in jstate)
        if ef:
            for (name, r), (_, q) in zip(tree_leaves_with_path(got["state"]["residual"]),
                                         tree_leaves_with_path(jstate["residual"])):
                q = _as_torch(q)
                assert r.dtype == q.dtype and r.shape == q.shape, name
                np.testing.assert_allclose(r.numpy(), q.numpy(), rtol=0,
                                           atol=1e-5 * float(q.abs().max()), err_msg=name)
        if carried:
            flipped, total = _params_near_eps(got["state"]["params"], jstate["params"],
                                              jstate["opt"]["v"], step, case["tcfg"]["opt"])
        else:
            flipped, total = _params_close(got["state"]["params"], jstate["params"], step + 1,
                                           False)
            assert flipped <= 1e-4 * total, (step, flipped, total)
        want = _masks(case, step)
        rows = []
        for r in range(WORLD):
            (row0, idx), = steps[r][step]["masks"]
            rows.append((row0, row0 + idx.shape[0]))
            np.testing.assert_array_equal(idx.numpy(), want[row0:row0 + idx.shape[0]])
        assert rows[0][0] == 0 and rows[0][1] == rows[1][0] and rows[1][1] == want.shape[0]


@pytest.mark.parametrize("cid", [CASES[0][0], CASES[1][0], CASES[3][0]])
def test_place_and_gather_round_trip_and_bytes(runs, cid):
    """``place_state`` then ``gather_state`` gives the whole state back bit
    for bit; each rank holds its blocks, the leaves that stay whole and its
    range of the residual: its bytes are the layout's count, and the ranks'
    bytes add up to the whole state's plus one copy of the whole leaves for
    each further rank."""
    at = [c[0] for c in CASES].index(cid)
    got = [o["cases"][at] for o in runs["outs"]]
    for g in got:
        assert g["round_trip_differs"] == []
        assert g["state_bytes"] == g["layout_bytes"]
        assert 0 < g["whole_leaf_bytes"] < g["whole_bytes"] / 20
    assert sum(g["state_bytes"] for g in got) == \
        got[0]["whole_bytes"] + (WORLD - 1) * got[0]["whole_leaf_bytes"]


def test_range_round_trip_matches_compress_flat():
    """The chunk-range round trip (``compress_range``) of each of 3 ranges of
    a vector of 7 chunks equals ``compress_flat`` on the whole vector: ĝ
    and the residual row for row, the masks the rows of the whole draw bit
    for bit, ``wire_floats`` the whole vector's; with and without error
    feedback."""
    rng = np.random.default_rng(0)
    key = np.asarray([0, 7], np.uint32)
    for ef in (True, False):
        cfg = CompressConfig(gamma=0.1, chunk_p=256, error_feedback=ef)
        flat = torch.from_numpy(rng.normal(size=7 * 256).astype(np.float32))
        want_g, want_r, want_w = gc.compress_flat(flat.clone(), key, 3, cfg)
        whole = gc.sample_indices(gc.sketch_mod.batch_key(gc.mask_spec(cfg, key), 3, 0), 7, 256,
                                  cfg.m)
        for c0, c1 in [(0, 3), (3, 5), (5, 7)]:
            rows = flat[c0 * 256:c1 * 256].clone()
            g, r, w = gc.compress_range(rows, key, 3, cfg, c0, 7)
            assert w == want_w == 7 * cfg.m
            assert torch.equal(g, want_g[c0 * 256:c1 * 256])
            assert (r is None) == (not ef)
            if ef:
                assert torch.equal(r, want_r[c0 * 256:c1 * 256])
            part = gc.sample_indices(gc.sketch_mod.batch_key(gc.mask_spec(cfg, key), 3, 0),
                                     c1 - c0, 256, cfg.m, row0=c0, total_rows=7)
            assert torch.equal(part, whole[c0:c1])


def test_placed_checkpoint_restores_whole(runs):
    """Case 0's final placed state, saved by both ranks, is the reference's
    tree (one residual, no rank's own): it restores whole in the port and in
    the reference, equal to the state gathered bit for bit."""
    case = runs["cases"][CASES[0][0]]
    final = runs["outs"][0]["cases"][0]["steps"][-1]["state"]
    path = str(runs["tmp"] / "saved")
    arrays, _ = checkpoint.load_arrays(path)
    assert not any("rank_residual" in k for k in arrays)
    like = trainer.init_state(get_api(case["cfg"]), trainer.TrainerConfig(**case["tcfg"]),
                              np.zeros(2, np.uint32), device="cpu")
    state, _ = checkpoint.restore(path, like)
    for (name, a), (_, b) in zip(tree_leaves_with_path(state), tree_leaves_with_path(final)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    jstate, _ = jckpt.restore(path, jtrainer.abstract_state(jget_api(case["jcfg"]), case["jt"]))
    for (name, a), (_, b) in zip(tree_leaves_with_path(final),
                                 jax.tree_util.tree_leaves_with_path(jstate)):
        assert torch.equal(a, _as_torch(b)), name


def test_checkpoints_restore_into_placed_state(runs):
    """A one-process checkpoint restores into a placed state (each rank its
    own blocks, gathered back bit for bit), and a checkpoint of the
    replicated data-parallel path with a residual for each rank restores
    with their mean, the reference's residual."""
    got = {k: v for k, v in runs["outs"][0]["restored"].items()}
    assert got["whole"]["placed"] and got["whole"]["extra"] == {"at": 5}
    for (name, a), (_, b) in zip(tree_leaves_with_path(got["whole"]["state"]),
                                 tree_leaves_with_path(runs["whole"])):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    pr22 = got["pr22"]["state"]
    assert got["pr22"]["placed"] and got["pr22"]["extra"] == {"at": 6}
    first = dict(tree_leaves_with_path(runs["rank_residuals"][0]))
    for (name, a), (_, b) in zip(tree_leaves_with_path(pr22["residual"]),
                                 tree_leaves_with_path(runs["mean"])):
        assert torch.equal(a, b) and not torch.equal(a, first[name]), name
    for (name, a), (_, b) in zip(tree_leaves_with_path(pr22["params"]),
                                 tree_leaves_with_path(runs["whole"]["params"])):
        assert torch.equal(a, b), name


def test_placed_restore_rejects_a_corrupt_member(runs):
    """A restore into a placed state holds every member to its CRC-32 (each
    read through by one rank): with one bit of a parameter's member flipped
    both ranks raise, and the rank that read the member names it."""
    errors = [o["restored"]["corrupt"].get("error") for o in runs["outs"]]
    assert all(e is not None and "is truncated or corrupt" in e for e in errors), errors
    assert sum(runs["corrupt"] in e for e in errors) == 1, errors


def test_dryrun_mesh4_counts_a_quarter_of_the_state():
    """``launch.dryrun``'s train cell on ``--mesh 4`` runs the placed step
    (its gathers and reduce-scatters counted) and records a quarter of the
    ``--mesh 1`` state bytes, plus the leaves that stay whole on each card."""
    four = dryrun.run_cell("gemma3-1b", "train_4k", "4")
    assert four["status"] == "ok", four
    cfg, shape = get_arch("gemma3-1b"), get_shape("train_4k")
    tcfg = dryrun.arch_trainer_config("gemma3-1b", "train")
    one = dryrun.state_bytes(cfg, shape, dryrun.make_mesh("1"), tcfg)
    state = trainer.abstract_state(get_api(cfg), tcfg)
    layout = fsdp.Layout.of(state, dryrun.make_mesh("4"))
    whole = sum(t.numel() * t.element_size() for name, t in tree_leaves_with_path(state)
                if layout.places[name].dim is None)
    assert one == sum(t.numel() * t.element_size() for _, t in tree_leaves_with_path(state))
    assert four["memory"]["state_bytes"] == (one - whole) // 4 + whole
    assert 0 < whole < one / 1000
    assert {"all-gather", "reduce-scatter"} <= set(four["collectives_steady"])
    assert dryrun.state_bytes(cfg, get_shape("decode_32k"), None, tcfg) is None


def test_init_placed_state_is_the_placed_init_state():
    """``init_placed_state`` (the parameters drawn whole, the moments and
    residual made at the rank's blocks) gives ``place_state(init_state)``
    bit for bit, for each rank of a mesh of 2 (placing needs no group)."""
    api = get_api(get_arch("gemma3-1b", reduced=True))
    tcfg = trainer.TrainerConfig(compress=CompressConfig(gamma=0.1), dp_only=True)
    mesh = Mesh((1, 2), ("data", "model"), owners=(0, 1), collective=True)
    d = trainer.make_dist(mesh, api.cfg, dp_only=True)
    key = np.asarray([0, 3], np.uint32)
    a = trainer.init_placed_state(api, tcfg, key, d, device="cpu")
    b = trainer.place_state(trainer.init_state(api, tcfg, key, device="cpu"), d)
    assert isinstance(a, fsdp.PlacedState) and a.layout.rank == 0
    for (name, x), (_, y) in zip(tree_leaves_with_path(a), tree_leaves_with_path(b)):
        assert x.dtype == y.dtype and torch.equal(x, y), name
    assert any(x.shape != t.shape for (_, x), (_, t) in
               zip(tree_leaves_with_path(a["params"]),
                   tree_leaves_with_path(api.init_params(0, "meta"))))


def test_placed_factored_moments_match_replicated(runs):
    """Adafactor's factored second moment without momentum (kimi-k2's
    optimizer): whole on every rank, its row and column means over the
    whole leaf from the blocks' partial sums; the placed steps' metrics and
    parameters equal the replicated steps' on the same ranks to 1e-5, the
    first step's loss bit for bit."""
    got = runs["outs"][0]["factored"]
    # the same weights and batch: the first step's forward is the same
    assert got["placed"][0]["loss"] == got["replicated"][0]["loss"]
    for p, r in zip(got["placed"], got["replicated"]):
        assert sorted(p) == sorted(r)
        for k in p:
            assert _rel(p[k], r[k]) < 1e-5, (k, p[k], r[k])
    placed, replicated = got["params"]
    for (name, a), (_, b) in zip(tree_leaves_with_path(placed), tree_leaves_with_path(replicated)):
        a, b = a.detach(), b.detach()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * float(b.abs().max()), err_msg=name)
