"""The dry-run's tables from its JSON records (the port of
``repro.roofline.report``).

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir build/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def fmt_bytes(b):
    return f"{b / 1e9:.2f}"


def fmt_s(x):
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.1f}µs"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def load(dir_: str):
    recs = []
    for f in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def dryrun_table(recs):
    lines = ["| arch | shape | mesh | kind | status | peak GB/card | fits 80GB | modeled GB "
             "| count s |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        head = f"| {r['arch']} | {r['shape']} | {r['mesh']} |"
        if r["status"] == "skip":
            lines.append(f"{head} — | skip: sub-quadratic rule | — | — | — | — |")
            continue
        if r["status"] == "not_ported":
            lines.append(f"{head} — | not ported: model-axis placement | — | — | — | — |")
            continue
        if r["status"] == "fail":
            lines.append(f"{head} — | FAIL: {r['error'][:60]} | — | — | — | — |")
            continue
        m = r["memory"]
        lines.append(
            f"{head} {r['kind']} | ok | {fmt_bytes(m['peak_bytes'])} "
            f"| {'✓' if m['fits_80GB'] else '✗'} | {fmt_bytes(m['modeled_peak_bytes'])} "
            f"| {r['count_s']} |")
    return "\n".join(lines)


def roofline_table(recs):
    lines = ["| arch | shape | mesh | t_comp | t_mem | t_coll | dominant | MODEL_FLOPS "
             "| useful ratio | roofline frac |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("status") != "ok" or "roofline" not in r:
            continue
        t = r["roofline"]["terms"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {fmt_s(t['t_compute_s'])} "
            f"| {fmt_s(t['t_memory_s'])} | {fmt_s(t['t_collective_s'])} | **{t['dominant']}** "
            f"| {t['model_flops']:.3g} | {t['useful_ratio']:.2f} | {t['roofline_fraction']:.3f} |")
    return "\n".join(lines)


def collective_mix(recs):
    lines = ["| arch | shape | mesh | all-gather GB | all-reduce GB | reduce-scatter GB "
             "| all-to-all GB | permute GB |",
             "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("status") != "ok" or "roofline" not in r:
            continue
        bk = r["roofline"]["per_device"]["wire_by_kind"]
        g = lambda k: f"{bk.get(k, 0) / 1e9:.2f}"  # noqa: E731
        lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {g('all-gather')} "
                     f"| {g('all-reduce')} | {g('reduce-scatter')} | {g('all-to-all')} "
                     f"| {g('collective-permute')} |")
    return "\n".join(lines)


def render(recs) -> str:
    n = {s: sum(r["status"] == s for r in recs) for s in ("ok", "skip", "not_ported", "fail")}
    return "\n".join([
        f"### Dry-run status: {n['ok']} ok / {n['skip']} skip / {n['not_ported']} not ported "
        f"/ {n['fail']} fail\n", dryrun_table(recs),
        "\n### Roofline (per card, NVIDIA H100 SXM 80GB HBM3 peaks at 700 W)\n",
        roofline_table(recs),
        "\n### Collective mix (per card per step)\n", collective_mix(recs)])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    args = ap.parse_args(argv)
    print(render(load(args.dir)))


if __name__ == "__main__":
    main()
