"""Rank processes for the multi-process CPU tests (``tests/test_torch_dp.py``,
``tests/test_torch_fsdp.py``, ``tests/test_torch_sharding.py``, and expert
parallelism in ``tests/test_torch_moe.py`` and ``tests/test_torch_moe_lm.py``).

    python tests/torch_dp_worker.py TASK --job job.pt --out out --world N \\
        --coordinator HOST:PORT --process-id R

The tests start N of these through ``cluster.bootstrap.run_ranks`` (which
adds ``--process-id``). Each brings up a gloo group on the CPU, reads the
job (``torch.save``'d by the test), runs its task and writes ``out.R.pt``;
the test compares what the ranks wrote with the reference. This module
imports only repro_torch: the reference runs in the test's process.
"""
import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import cluster
from repro_torch.cluster.bootstrap import free_port, make_mesh, run_ranks
from repro_torch.core import grad_compress as gc
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.cluster.bootstrap import axis_group
from repro_torch.models import moe
from repro_torch.models import transformer as tr
from repro_torch.models.api import get_api
from repro_torch.train import checkpoint
from repro_torch.train import fsdp as fsdp_mod
from repro_torch.train import trainer
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path, tree_map, tree_size_bytes


def perworker(job: dict) -> dict:
    """``perworker_mean_estimate`` of rank r's row of ``grads``, over the
    job's mesh (``mesh``: (shape, axes)) or, without one, the default group."""
    cfg = gc.CompressConfig(**job["cfg"])
    if job["mesh"] is None:
        where, shard = dist.group.WORLD, dist.get_rank()
    else:
        where = make_mesh(*job["mesh"])
        shard = where.owners.index(dist.get_rank())
    est = gc.perworker_mean_estimate(job["grads"][shard], job["key"], job["step"], cfg, where,
                                     job["axes"])
    return {"est": est}


def train(job: dict) -> dict:
    """The data-parallel trainer over ``make_host_mesh(1, N)``: the job's
    state, then one step a batch; every step's metrics and state after it."""
    api = get_api(job["cfg"])
    tcfg = trainer.TrainerConfig(**job["tcfg"])
    mesh = make_host_mesh(1, dist.get_world_size())
    fn = trainer.make_train_fn(api, tcfg, trainer.make_dist(mesh, api.cfg, dp_only=True),
                               job["key"], device="cpu")
    state, steps = job["state"], []
    for batch in job["batches"]:
        state, metrics = fn(state, batch)
        steps.append({"metrics": {k: float(v) for k, v in metrics.items()},
                      "state": tree_map(lambda t: t.detach().clone(), state)})
    return {"steps": steps}


def fsdp(job: dict) -> dict:
    """The placed trainer over ``make_host_mesh(1, N)``. For each of the
    job's cases: its whole state placed (``place_state``) and gathered back,
    the rank's state bytes beside the layout's count, then one step a batch:
    every step's metrics, the whole state gathered after it and the masks
    the step drew (rows ``[row0, …)`` of the chunks). Then the checkpoint
    round trips: case 0's final state saved placed (``save_dir``), and the
    job's checkpoints restored into a placed state and gathered whole (or
    the restore's ValueError, for a corrupt checkpoint). The
    gradient moves in runs of ``move_values`` values a rank. Last, the
    ``factored`` case's steps placed and replicated side by side."""
    mesh = make_host_mesh(1, dist.get_world_size())
    fsdp_mod.MOVE_VALUES = job["move_values"]
    drawn, draw = [], gc.sample_indices

    def recording(key, n, p, m, device="cpu", row0=0, total_rows=None):
        idx = draw(key, n, p, m, device=device, row0=row0, total_rows=total_rows)
        drawn.append((row0, idx.clone()))
        return idx

    gc.sample_indices = recording
    cases = []
    for case in job["cases"]:
        api = get_api(case["cfg"])
        tcfg = trainer.TrainerConfig(**case["tcfg"])
        d = trainer.make_dist(mesh, api.cfg, dp_only=True)
        fn = trainer.make_train_fn(api, tcfg, d, job["key"], device="cpu")
        state = trainer.place_state(case["state"], d)
        back = fsdp_mod.gather_state(state)
        same = [name for (name, a), (_, b) in zip(tree_leaves_with_path(back),
                                                  tree_leaves_with_path(case["state"]))
                if a.dtype != b.dtype or not torch.equal(a, b)]
        whole = {name: leaf for name, leaf in tree_leaves_with_path(case["state"])}
        out = {"round_trip_differs": same, "state_bytes": tree_size_bytes(state),
               "layout_bytes": state.layout.state_bytes(case["state"]),
               "whole_bytes": tree_size_bytes(case["state"]),
               "whole_leaf_bytes": sum(whole[n].numel() * whole[n].element_size()
                                       for n, pl in state.layout.places.items()
                                       if pl.dim is None),
               "steps": []}
        for batch in case["batches"]:
            drawn.clear()
            state, metrics = fn(state, batch)
            out["steps"].append({"metrics": {k: float(v) for k, v in metrics.items()},
                                 "state": fsdp_mod.gather_state(state), "masks": list(drawn)})
        if not cases:
            checkpoint.save(job["save_dir"], len(case["batches"]), state, async_=False)
        cases.append(out)
    gc.sample_indices = draw
    # the factored second moment placed against the same ranks replicated
    fac = job["factored"]
    api = get_api(fac["cfg"])
    tcfg = trainer.TrainerConfig(**fac["tcfg"])
    d = trainer.make_dist(mesh, api.cfg, dp_only=True)
    fn = trainer.make_train_fn(api, tcfg, d, job["key"], device="cpu")
    paths = {"placed": trainer.place_state(fac["state"], d),
             "replicated": tree_map(torch.clone, fac["state"])}
    factored = {k: [] for k in paths}
    for batch in fac["batches"]:
        for k in paths:
            paths[k], metrics = fn(paths[k], batch)
            factored[k].append({k: float(v) for k, v in metrics.items()})
    factored["params"] = [fsdp_mod.gather_state(paths["placed"])["params"],
                          paths["replicated"]["params"]]
    api = get_api(job["cases"][0]["cfg"])
    d = trainer.make_dist(mesh, api.cfg, dp_only=True)
    restored = {}
    for name, path in job["restore"].items():
        like = trainer.place_state(job["cases"][0]["state"], d)
        try:
            state, extra = checkpoint.restore(path, like)
        except ValueError as e:
            restored[name] = {"error": str(e)}
            continue
        restored[name] = {"state": fsdp_mod.gather_state(state), "extra": extra,
                          "placed": isinstance(state, fsdp_mod.PlacedState)}
    return {"cases": cases, "restored": restored, "factored": factored}


def _coords(mesh) -> tuple[int, ...]:
    """This rank's coordinates on ``mesh`` (one rank a position)."""
    pos = mesh.owners.index(dist.get_rank())
    return tuple(int(c) for c in np.unravel_index(pos, [mesh.shape[a] for a in mesh.axis_names]))


def moe_ep(job: dict) -> dict:
    """``moe_apply_ep`` over the job's ("data", "model") mesh at each of its
    capacity factors: the rank's block of ``x`` (B, S, d) — rows over
    "data", the sequence over "model" — and its view of the experts; its
    output, aux, and the gradients of ``Σ y² + aux``: the router's and the
    shared expert's (summed over the "model" ranks), the expert leaves'
    (non-zero in the rank's block) and its block of x's."""
    mesh = make_mesh(*job["mesh"])
    ep = axis_group(mesh, ("model",))
    di, mi = _coords(mesh)
    x = job["x"]
    bl, sl = x.shape[0] // mesh.shape["data"], x.shape[1] // mesh.shape["model"]
    out = []
    for cf in job["capacity_factors"]:
        params = tree_map(lambda t: t.clone().requires_grad_(True), job["params"])
        xl = torch.from_numpy(np.ascontiguousarray(
            x[di * bl:(di + 1) * bl, mi * sl:(mi + 1) * sl])).requires_grad_(True)
        y, aux = moe.moe_apply_ep(moe.ep_block(params, ep), xl, job["k"], cf, mesh, ("data",),
                                  "model")
        # the parameters' leaves in the reference's order, then x
        grads = torch.autograd.grad((y ** 2).sum() + aux, tree_leaves(params) + [xl])
        out.append({"y": y.detach(), "aux": aux.detach(), "grads": [g.detach() for g in grads],
                    "coords": (di, mi)})
    return {"cases": out}


def lm_ep(job: dict) -> dict:
    """A reduced MoE LM's logits, ``lm_loss`` and its gradients on every rank
    of ``make_host_mesh(1, N)``, with expert parallelism over "model"."""
    cfg = job["cfg"]
    mesh = make_host_mesh(1, dist.get_world_size())
    d = trainer.make_dist(mesh, cfg)
    params = job["params"]
    batch = {k: torch.from_numpy(v) for k, v in job["batch"].items()}
    with torch.no_grad():
        logits, aux = tr.forward(params, batch["tokens"], cfg, d, **job["chunks"])
    leaves = [leaf.requires_grad_(True) for leaf in tree_leaves(params)]
    loss, m = tr.lm_loss(params, batch, cfg, d, **job["chunks"])
    grads = torch.autograd.grad(loss, leaves)
    return {"logits": logits, "loss": loss.detach(), "nll": m["nll"].detach(),
            "aux": m["aux"].detach(), "grads": [g.detach() for g in grads],
            "index": axis_group(mesh, ("model",)).index}


TASKS = {"perworker": perworker, "train": train, "moe_ep": moe_ep, "lm_ep": lm_ep,
         "fsdp": fsdp}


def run(task: str, job: dict, world: int, tmp_dir, partitionable: bool) -> list[dict]:
    """``task`` on ``world`` gloo ranks (in the port's threefry layout
    ``partitionable``); what each rank wrote, by rank."""
    path, out = os.path.join(tmp_dir, f"{task}.job.pt"), os.path.join(tmp_dir, task)
    torch.save(job, path)
    cmd = [sys.executable, os.path.abspath(__file__), task, "--job", path, "--out", out,
           "--world", str(world), "--coordinator", f"127.0.0.1:{free_port()}"]
    name = "REPRO_TORCH_THREEFRY_PARTITIONABLE"
    before = os.environ.get(name)
    os.environ[name] = str(int(partitionable))
    try:
        assert run_ranks(cmd, world) == 0, f"a rank of {task} failed"
    finally:
        if before is None:
            del os.environ[name]
        else:
            os.environ[name] = before
    return [torch.load(f"{out}.{r}.pt", weights_only=False) for r in range(world)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("task", choices=sorted(TASKS))
    ap.add_argument("--job", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--process-id", type=int, required=True)
    args = ap.parse_args()
    torch.set_num_threads(2)
    cluster.initialize(args.coordinator, args.world, args.process_id, backend="gloo",
                       device="cpu")
    out = TASKS[args.task](torch.load(args.job, weights_only=False))
    torch.save(out, f"{args.out}.{args.process_id}.pt")
    dist.barrier()
    cluster.shutdown()


if __name__ == "__main__":
    main()
