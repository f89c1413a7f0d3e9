"""repro_torch.roofline, trainer.lower_cell, models.api.input_specs and
launch.dryrun on the CPU.

Held against the reference: parameter counts, model flops and probe depths
for every (arch × shape) cell, equal; the wire-byte model on the five
collectives of ``tests/test_roofline.py``'s HLO snippet given as records,
equal to the reference's parser on the text; the inputs of every cell,
shape for shape. Held to the port's own: the kernel bounds of ``PERF.md``
§6 to 4 significant figures with their labels, and each model's schedule
bytes at least its bound's bytes over a grid of shapes; a reduced gemma3-1b
compressed training step counted on the meta device equal to the same step
on the CPU's tensors (flops by dtype, bytes, K2 twice a step by its model);
one layer's flops against its matrix products written out; the
extrapolation's clamps; the shared-mask exchange of a fake 2-rank step;
``memmodel.peak_model``'s state against the state's own bytes; and the
dry-run's records and tables.
"""
import functools
import math

import numpy as np
import pytest
import torch
import torch.distributed as torch_dist

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.roofline import analysis as janalysis
from repro.roofline.hlo import collective_stats as jcollective_stats
from repro_torch.cluster.bootstrap import Mesh
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.grad_compress import CompressConfig, padded_len
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.models.api import get_api, input_specs
from repro_torch.roofline import analysis, hlo, memmodel, report
from repro_torch.roofline import kernels as rk
from repro_torch.roofline.counter import OpCounter
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import trainer
from repro_torch.utils.device import PLACEMENT
from repro_torch.utils.tree import tree_leaves, tree_size_bytes

ARCHS = sorted(treg.ARCHS)
SHAPES = list(treg.SHAPES)
HLO = """
  %ar = f32[16,128]{1,0} all-reduce(f32[16,128]{1,0} %x), replica_groups=[16,16]<=[256], to_apply=%add
  %ag.1 = bf16[64,256]{1,0} all-gather(bf16[4,256]{1,0} %y), replica_groups=[16,16]<=[256], dimensions={0}
  %rs = f32[2,8]{1,0} reduce-scatter(f32[32,8]{1,0} %z), replica_groups={{0,1,2,3}}, dimensions={0}
  %cp = f32[4,4]{1,0} collective-permute(f32[4,4]{1,0} %w), source_target_pairs={{0,1}}
  %aa = (f32[8,8]{1,0}) all-to-all(f32[8,8]{1,0} %v), replica_groups=[32,8]<=[256]
"""
# the same five ops as the counting mode records them
RECORDS = [
    {"kind": "all-reduce", "result_bytes": 16 * 128 * 4, "operand_bytes": 16 * 128 * 4, "group": 16},
    {"kind": "all-gather", "result_bytes": 64 * 256 * 2, "operand_bytes": 4 * 256 * 2, "group": 16},
    {"kind": "reduce-scatter", "result_bytes": 2 * 8 * 4, "operand_bytes": 32 * 8 * 4, "group": 4},
    {"kind": "collective-permute", "result_bytes": 4 * 4 * 4, "operand_bytes": 4 * 4 * 4,
     "group": 2},
    {"kind": "all-to-all", "result_bytes": 8 * 8 * 4, "operand_bytes": 8 * 8 * 4, "group": 8},
]
# PERF.md §6's Bound column: (model, its arguments, ms to 4 significant figures, label)
BOUNDS = [
    ("K1", rk.sketch_fused_roofline, (4096, 16384, 819), "0.08816", "bytes"),
    ("K1 above 2^15", rk.sketch_fused_roofline, (4096, 65536, 3277), "0.3527", "bytes"),
    ("K2 unmix", rk.fwht_roofline, (10, 16384), "0.0004108", "bytes"),
    ("K2 gradient", rk.fwht_roofline, (79_456, 16384), "3.109", "bytes"),
    ("K3 unmix", rk.fwht_roofline, (8, 65536), "0.00133", "bytes"),
    ("K4", rk.sparse_assign_roofline, (4096, 819, 3, 10, 16384), "0.008759", "bytes"),
    ("K5", rk.spmm_roofline, (4096, 3277, 65536, 128), "0.05129", "operations"),
    ("K6", rk.spmm_t_roofline, (4096, 3277, 65536, 128), "0.05129", "operations"),
]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_probe_depths_match_reference(arch):
    assert analysis.count_params(treg.get_arch(arch)) == janalysis.count_params(jreg.get_arch(arch))
    assert analysis.probe_depths(treg.get_arch(arch)) == janalysis.probe_depths(jreg.get_arch(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch, monkeypatch):
    # the reference builds its tree anew a call: once an arch here
    monkeypatch.setattr(janalysis, "count_params",
                        functools.lru_cache(maxsize=None)(janalysis.count_params))
    for shape in SHAPES:
        want = janalysis.model_flops(jreg.get_arch(arch), jreg.get_shape(shape))
        assert analysis.model_flops(treg.get_arch(arch), treg.get_shape(shape)) == want, shape


def test_collective_stats_match_reference_parser():
    got, want = hlo.collective_stats(RECORDS), jcollective_stats(HLO)
    assert got["total_wire_bytes"] == want["total_wire_bytes"]
    assert set(got["by_kind"]) == set(want["by_kind"])
    for kind, v in want["by_kind"].items():
        assert got["by_kind"][kind] == v, kind


@pytest.mark.parametrize("what,model,args,ms,label", BOUNDS, ids=[b[0] for b in BOUNDS])
def test_kernel_bounds_are_perf_md(what, model, args, ms, label):
    k = model(*args)
    assert f"{k.ms:.4g}" == ms and k.bound == label, (what, k.ms, k.bound)
    assert k.us == max(k.mem_us, k.compute_us) and k.rows_per_sec > 0


def test_schedule_bytes_at_least_the_bound():
    for n in (1, 10, 131, 4096):
        for p in (1 << 10, 1 << 15, 1 << 16, 1 << 19, 1 << 21):
            ks = [rk.fwht_roofline(n, p)]
            for gamma in (0.005, 0.05, 0.25):
                m = max(1, round(gamma * p))
                ks.append(rk.sketch_fused_roofline(n, p, m))
                for ell in (8, 128):
                    ks += [rk.spmm_roofline(n, m, p, ell), rk.spmm_t_roofline(n, m, p, ell),
                           rk.spmm_t_roofline(n, m, p, ell, col_sums=True)]
                for r, k in ((1, 10), (3, 10)):
                    ks.append(rk.sparse_assign_roofline(n, m, r, k, p))
            for k in ks:
                assert k.schedule_bytes >= k.hbm_bytes > 0, (k, n, p)
    # the schedule is the bound where it makes one pass, more where it makes more
    assert rk.fwht_roofline(64, 1 << 15).schedule_bytes == rk.fwht_roofline(64, 1 << 15).hbm_bytes
    assert rk.fwht_roofline(64, 1 << 21).schedule_bytes > rk.fwht_roofline(64, 1 << 21).hbm_bytes


def _tree_shapes(tree):
    leaves = tree_leaves(tree) if not isinstance(tree, dict) else [
        v for k in sorted(tree) for v in tree_leaves(tree[k])]
    return [(tuple(x.shape), str(x.dtype).split(".")[-1]) for x in leaves]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    cfg, jcfg = treg.get_arch(arch, reduced=True), jreg.get_arch(arch, reduced=True)
    for shape in SHAPES:
        got = input_specs(cfg, treg.get_shape(shape, reduced=True))
        want = japi.input_specs(jcfg, jreg.get_shape(shape, reduced=True))
        assert all(t.device.type == "meta" for t in tree_leaves(got) if torch.is_tensor(t))
        if "batch" in want:
            assert sorted(got["batch"]) == sorted(want["batch"])
            assert _tree_shapes(got["batch"]) == _tree_shapes(want["batch"]), shape
        else:
            assert tuple(got["token"].shape) == tuple(want["token"].shape)
            assert _tree_shapes(got["cache"]) == _tree_shapes(want["cache"]), shape
            assert got["cur_len"] == treg.get_shape(shape, reduced=True).seq_len


def _compressed(chunk_p=1024):
    return trainer.TrainerConfig(accum_steps=2, compress=CompressConfig(gamma=0.1, chunk_p=chunk_p),
                                 q_chunk=16, kv_chunk=16)


def _count(cfg, shape, tcfg, device, mesh=None):
    step, args, info = trainer.lower_cell(cfg, shape, mesh, tcfg, device=device)
    with OpCounter(device) as c:
        c.track(args)
        step(*args)
    return c, info


def test_meta_count_equals_a_cpu_run():
    cfg, shape = treg.get_arch("gemma3-1b", reduced=True), ShapeConfig("t", 32, 4, "train")
    meta, info = _count(cfg, shape, _compressed(), "meta")
    cpu, _ = _count(cfg, shape, _compressed(), "cpu")
    assert info == {"kind": "train", "n_chips": 1, "batch": 4}
    assert meta.flops == cpu.flops and meta.flops["float32"] > 0
    assert meta.bytes == cpu.bytes > 0
    assert meta.kernels == cpu.kernels == {"hd_precondition": 2}
    # the peak counts the inputs' storages from the start; a 0-dim host
    # scalar of the CPU run's is the only difference
    assert abs(meta.peak_bytes - cpu.peak_bytes) <= 64
    assert meta.collectives == cpu.collectives == []


def test_one_layer_is_its_matrix_products():
    cfg = treg.get_arch("gemma3-1b", reduced=True)
    B, S = 2, 32
    shape, tcfg = ShapeConfig("p", S, B, "prefill"), trainer.TrainerConfig(q_chunk=S, kv_chunk=S)
    d1, d2 = analysis.probe_depths(cfg)
    f1 = _count(analysis._probe_cfg(cfg, d1), shape, tcfg, "meta")[0].total_flops
    f2 = _count(analysis._probe_cfg(cfg, d2), shape, tcfg, "meta")[0].total_flops
    d, H, Hkv, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    proj = 2 * B * S * (d * H * hd + 2 * d * Hkv * hd + H * hd * d + 3 * d * ff)
    attn = 2 * 2 * B * H * S * S * hd          # QKᵀ and PV over one chunk
    assert (f2 - f1) / (d2 - d1) == proj + attn


def test_extrapolation_clamps():
    up = [{"f": 10.0}, {"f": 14.0}]
    assert analysis.extrapolate(up, 1, 2, 5, "f") == (26.0, 4.0)
    down = [{"f": 10.0}, {"f": 8.0}]         # a layer cannot remove work
    assert analysis.extrapolate(down, 1, 2, 26, "f") == (10.0, 0.0)
    assert analysis.extrapolate([{}, {"f": 3.0}], 6, 12, 38, "f") == (16.0, 0.5)


def test_fake_two_rank_step_records_one_exchange():
    cfg, shape = treg.get_arch("gemma3-1b", reduced=True), ShapeConfig("t", 32, 4, "train")
    mesh = Mesh((2,), ("data",), owners=(0, 1), collective=True)
    tcfg = _compressed()
    c, info = _count(cfg, shape, tcfg, "meta", mesh)
    assert not torch_dist.is_initialized()
    assert info == {"kind": "train", "n_chips": 2, "batch": 2}
    n = analysis.count_params(cfg)["total"]
    exchange = padded_len(n, tcfg.compress.chunk_p) // tcfg.compress.chunk_p * tcfg.compress.m * 4
    reduces = [r for r in c.collectives if r["kind"] == "all-reduce"]
    assert [r["result_bytes"] for r in reduces].count(exchange) == 1
    assert len(c.collectives) == len(reduces) == 2     # and the loss's scalar buffer
    assert all(r["group"] == 2 for r in reduces)
    stats = hlo.collective_stats(c.collectives)
    assert stats["total_wire_bytes"] == sum(2.0 * r["result_bytes"] / 2 for r in reduces)
    assert c.kernels == {"hd_precondition": 2}


@pytest.mark.parametrize("moments,momentum", [("float32", True), ("bfloat16", False)])
def test_peak_model_state_is_the_states_bytes(moments, momentum):
    cfg = treg.get_arch("gemma3-1b")
    tcfg = trainer.TrainerConfig(opt=opt_mod.OptConfig(moment_dtype=moments, momentum=momentum),
                                 compress=CompressConfig(gamma=0.1))
    state = trainer.abstract_state(get_api(cfg), tcfg)
    n = analysis.count_params(cfg)["total"]
    comp = memmodel.peak_model(
        cfg, treg.get_shape("train_4k"), 1, 1, 1, n, momentum=momentum,
        moment_bytes=torch.empty((), dtype=getattr(torch, moments)).element_size(),
        compress=tcfg.compress)["components"]
    assert comp["params"] == tree_size_bytes(state["params"])
    assert comp["optimizer"] == tree_size_bytes(state["opt"])
    assert comp["residual"] == tree_size_bytes(state["residual"])
    assert comp["grads"] == padded_len(n, tcfg.compress.chunk_p) * 4


def test_ops_count_kernels_by_model_on_meta():
    meta = torch.device("meta")
    x = torch.empty((64, 1 << 12), device=meta)
    s = torch.empty((1 << 12,), device=meta)
    idx = torch.empty((64, 205), dtype=torch.int32, device=meta)
    centers = torch.empty((3, 10, 1 << 12), device=meta)
    dense = torch.empty((1 << 12, 16), device=meta)
    with OpCounter("meta") as c:
        y = ops.hd_precondition(x, s)
        v = ops.sketch_fused(x, s, idx)
        dists, amin = ops.sparse_assign(v, idx, centers)
        t = ops.spmm(v, idx, dense)
        out = ops.spmm_t(v, idx, t, 1 << 12, col_sums=True)
    assert y.shape == x.shape and v.shape == idx.shape and t.shape == (64, 16)
    assert dists.shape == (3, 64, 10) and amin.dtype == torch.int32
    assert out[0].shape == (1 << 12, 16) and out[1].shape == (1 << 12,)
    models = [rk.fwht_roofline(64, 1 << 12), rk.sketch_fused_roofline(64, 1 << 12, 205),
              rk.sparse_assign_roofline(64, 205, 3, 10, 1 << 12),
              rk.spmm_roofline(64, 205, 1 << 12, 16),
              rk.spmm_t_roofline(64, 205, 1 << 12, 16, col_sums=True)]
    assert c.kernels == {"hd_precondition": 1, "sketch_fused": 1, "sparse_assign": 1, "spmm": 1,
                         "spmm_t": 1}
    assert c.bytes == sum(k.hbm_bytes for k in models)
    assert c.flops == {"float32": sum(k.flops for k in models)}


def test_dryrun_records_and_report(tmp_path):
    out = str(tmp_path)
    args = ["--arch", "gemma3-1b", "--shape", "decode_32k", "--roofline", "--out", out]
    assert dryrun.main([*args, "--mesh", "1"]) == 0
    assert dryrun.main([*args, "--mesh", "single"]) == 0
    recs = {r["mesh"]: r for r in report.load(out)}
    ok, refused = recs["1"], recs["single"]
    assert ok["status"] == "ok" and ok["kind"] == "decode" and ok["n_chips"] == 1
    cfg = treg.get_arch("gemma3-1b")
    per_dev = ok["roofline"]["per_device"]
    assert set(per_dev["flops_by_dtype"]) == {"bfloat16", "float32"}
    assert per_dev["flops"] == pytest.approx(sum(per_dev["flops_by_dtype"].values()))
    assert [p["depth"] for p in ok["roofline"]["probes"]] == list(analysis.probe_depths(cfg))
    terms = ok["roofline"]["terms"]
    assert terms["dominant"] == "memory" and terms["t_collective_s"] == 0
    assert terms["model_flops"] == analysis.model_flops(cfg, treg.get_shape("decode_32k"))
    # the cache alone: 26 layers × 128 × 32768 × 1 KV head × 256 × 2 (k, v) bf16 bytes
    cache = 2 * 26 * 128 * 32768 * 256 * 2
    assert ok["memory"]["peak_bytes"] > cache and not ok["memory"]["fits_80GB"]
    assert ok["memory"]["modeled_components"]["kv_cache"] == cache
    assert refused["status"] == "not_ported" and PLACEMENT in refused["reason"]
    text = report.render(list(recs.values()))
    assert "1 ok / 0 skip / 1 not ported / 0 fail" in text
    assert "| gemma3-1b | decode_32k | 1 | decode | ok |" in text
    assert "| gemma3-1b | decode_32k | single | — | not ported" in text
    assert "| gemma3-1b | decode_32k | 1 | " in text.split("### Roofline")[1]
    # a second run finds both records and recounts neither
    assert dryrun.main([*args, "--mesh", "1"]) == 0


def test_lower_cell_refuses_the_model_axis():
    mesh = dryrun.make_mesh("single")
    with pytest.raises(NotImplementedError, match=PLACEMENT):
        trainer.lower_cell(treg.get_arch("gemma3-1b"), treg.get_shape("train_4k"), mesh)
    assert math.prod(mesh.shape.values()) == 256 and np.all(np.diff(mesh.owners) == 1)
    assert dryrun.make_mesh("1") is None and dryrun.make_mesh("4").shape == {"data": 4}
