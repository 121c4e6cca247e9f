"""Assemble the roofline table from dry-run records (port of
``repro/launch/report.py``, line for line, but for the default mesh, the
dry run's one card, ``h100``, and the rows of the pod meshes' untraced
``specs_only`` records, which show the arguments' bytes a device).

    PYTHONPATH=src python -m repro_torch.launch.report [--dir artifacts/dryrun]
"""
from __future__ import annotations

import argparse
import json
import os


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.3g}us"
    if x < 1:
        return f"{x*1e3:.3g}ms"
    return f"{x:.3g}s"


def load(dir_: str) -> list[dict]:
    out = []
    for fn in sorted(os.listdir(dir_)):
        if fn.endswith(".json"):
            with open(os.path.join(dir_, fn)) as f:
                out.append(json.load(f))
    return out


def table(recs: list[dict], mesh: str) -> str:
    lines = [
        "| arch | shape | compute | memory | collective | bottleneck |"
        " useful (6ND/HLO) | peak HBM/dev | compile |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    order = {"a1": 0, "lm": 1, "gnn": 2, "recsys": 3}
    recs = [r for r in recs if r["mesh"] == mesh]
    recs.sort(key=lambda r: (order.get(r.get("family", ""), 9), r["arch"],
                             r["shape"]))
    for r in recs:
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"SKIP ({r['skip_reason'][:48]}…) | — | — |")
            continue
        if r["status"] == "specs_only":
            gb = r["args_bytes_per_shard"] / 1e9
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"specs only (traced on h100) | — "
                         f"| args {gb:.1f} GB | — |")
            continue
        rl = r["roofline"]
        hbm = rl["mem_stats"].get("peak_hbm_gb", 0)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rl['compute_s'])} "
            f"| {fmt_s(rl['memory_s'])} | {fmt_s(rl['collective_s'])} "
            f"| {rl['bottleneck']} | {rl['useful_ratio']:.2f} "
            f"| {hbm:.1f} GB | {r['compile_s']:.0f}s |")
    return "\n".join(lines)


def summary(recs: list[dict]) -> str:
    n_ok = sum(1 for r in recs if r["status"] == "ok")
    n_skip = sum(1 for r in recs if r["status"] == "skipped")
    meshes = sorted({r["mesh"] for r in recs})
    return (f"{len(recs)} artifacts ({n_ok} compiled, {n_skip} recorded "
            f"skips) across meshes {meshes}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    ap.add_argument("--mesh", default="h100")
    args = ap.parse_args()
    recs = load(args.dir)
    print(summary(recs))
    print()
    print(table(recs, args.mesh))


if __name__ == "__main__":
    main()
