"""Dry run: every (architecture x shape) cell at full size on ``meta``.

Port of ``repro/launch/dryrun.py``.  The JAX dry run lowers and compiles
each cell for a 256- or 512-chip TPU mesh and records XLA's memory and
cost analyses and a roofline.  The port runs on one H100, so each cell is
built at full size as ``meta`` tensors (shapes and dtypes, no storage) and
its step traced once by ``launch/hloanalysis.py::analyze_ops``: flops,
bytes moved, collective wire bytes and peak live bytes, and the roofline
of ``launch/roofline.py`` against the card's data-sheet peaks.  A step
that would not fit on the card fails *here*, not there: a cell whose peak
passes the card's 80 GB is recorded as ``over_memory`` with its bytes.

``--mesh`` names the mesh the specs resolve against: ``h100`` (default), a
(1, 1) ("data", "model") mesh, which is one card, what the port runs;
``pod`` and ``multipod``, JAX's production shapes (16 x 16 and
2 x 16 x 16).  Only the ``h100`` records are traced.  A pod record is
``specs_only``: each argument's spec and bytes a shard, their sum and
``model_flops``, and no roofline, peak or memory status, since the one
card's trace of the whole step at the global batch says nothing of one
device of the pod.

The a1 cells (the lockstep query program and the commit-batch apply) are
host-driven: their waves read counts back to size the next step, which
``meta`` tensors cannot give.  They are recorded as ``host_driven`` with
the store's bytes a shard, their caps and ``model_flops``, untraced.

Usage:
    python -m repro_torch.launch.dryrun --list
    python -m repro_torch.launch.dryrun --arch h2o-danube-3-4b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--jobs 4] [--mesh pod]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

MESHES = ("h100", "pod", "multipod")


def make_mesh(tag: str):
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    if tag == "h100":
        return make_test_mesh((1, 1), device="meta")
    return make_production_mesh(multi_pod=tag == "multipod", device="meta")


def _arg_records(args, specs, mesh) -> list:
    """Each tensor argument's shape, dtype, spec and bytes a shard."""
    from repro_torch.core.tree import get_path, walk_leaves
    out = []
    for path, a in walk_leaves(tuple(args)):
        s = None if specs is None else get_path(specs, path)
        parts = 1
        for entry in (s or ()):
            for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
                parts *= mesh.axis_size(ax)
        nb = a.numel() * a.element_size()
        out.append({"path": "/".join(map(str, path)), "shape": list(a.shape),
                    "dtype": str(a.dtype).replace("torch.", ""),
                    "spec": None if s is None else list(s),
                    "bytes": nb, "bytes_per_shard": math.ceil(nb / parts)})
    return out


def run_cell(arch: str, shape: str, mesh_tag: str, out_dir: str) -> dict:
    from repro_torch.configs import registry
    from repro_torch.launch import roofline
    from repro_torch.launch.hloanalysis import analyze_ops
    from repro_torch.launch.steps import build_cell

    spec = registry.get(arch)
    cell_meta = spec.cell(shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_tag,
           "family": spec.family}
    if cell_meta.skip:
        rec["status"] = "skipped"
        rec["skip_reason"] = cell_meta.skip
        _write(rec, out_dir)
        return rec

    mesh = make_mesh(mesh_tag)
    t0 = time.time()
    cell = build_cell(arch, shape, mesh)
    t_build = time.time() - t0
    args = _arg_records(cell.args, cell.in_shardings, mesh)
    rec.update(mesh_devices=mesh.size, note=cell.note,
               lower_s=round(t_build, 2), args=args)
    if mesh_tag != "h100":
        rec.update(status="specs_only", model_flops=cell.model_flops,
                   args_bytes_per_shard=sum(r["bytes_per_shard"]
                                            for r in args))
        _write(rec, out_dir)
        return rec
    rec["n_devices"] = 1
    if spec.family == "a1":
        cfg = cell.model_cfg
        store = cell.args[0].nbytes()
        per_shard = store / cfg.n_shards
        rec.update(status="host_driven", compile_s=0.0,
                   n_shards=cfg.n_shards, store_bytes=store,
                   store_bytes_per_shard=per_shard,
                   caps=dict(cell_meta.geometry.get("caps", {})),
                   roofline=dict(
                       flops=0.0, flops_by_dtype={}, hbm_bytes=0.0, wire_bytes=0.0,
                       compute_s=0.0, memory_s=0.0, collective_s=0.0,
                       bottleneck="host", model_flops=cell.model_flops,
                       useful_ratio=0.0, coll_detail={},
                       mem_stats={"peak_hbm_gb": per_shard / 1e9}))
        _write(rec, out_dir)
        return rec

    t0 = time.time()
    a, _ = analyze_ops(cell.fn, *cell.args)
    t_trace = time.time() - t0
    rl = roofline.analyze(a, n_devices=1, model_flops=cell.model_flops)
    over = a.peak_bytes > roofline.HBM_BYTES
    rec.update(status="over_memory" if over else "ok",
               compile_s=round(t_trace, 2), peak_bytes=a.peak_bytes,
               ops=dict(matmul_flops=a.matmul_flops,
                        kernel_flops=a.kernel_flops,
                        kernel_calls=a.kernel_calls, n_ops=a.n_ops,
                        host_reads=a.host_reads),
               roofline=rl.to_json())
    _write(rec, out_dir)
    return rec


def _write(rec: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    fn = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(out_dir, fn), "w") as f:
        json.dump(rec, f, indent=1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=MESHES, default="h100")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args()

    from repro_torch.configs import registry

    if args.list:
        for a, s in registry.all_cells():
            skip = registry.get(a).cell(s).skip
            print(f"{a:28s} {s:16s}" + (f"  [SKIP: {skip[:40]}...]"
                                        if skip else ""))
        return

    if args.all:
        jobs = list(registry.all_cells())
        procs: list = []
        results = []
        while jobs or procs:
            while jobs and len(procs) < args.jobs:
                a, s = jobs.pop(0)
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", a, "--shape", s, "--out", args.out,
                       "--mesh", args.mesh]
                print("launch:", a, s, args.mesh, flush=True)
                procs.append(((a, s), subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
            done = []
            for item in procs:
                (a, s), p = item
                if p.poll() is not None:
                    out = p.stdout.read().decode()
                    ok = p.returncode == 0
                    results.append((a, s, ok))
                    print(("PASS" if ok else "FAIL"), a, s, args.mesh,
                          flush=True)
                    if not ok:
                        print(out[-3000:], flush=True)
                    done.append(item)
            for d in done:
                procs.remove(d)
            time.sleep(0.5)
        n_ok = sum(1 for *_, ok in results if ok)
        print(f"\n{n_ok}/{len(results)} cells passed")
        sys.exit(0 if n_ok == len(results) else 1)

    rec = run_cell(args.arch, args.shape, args.mesh, args.out)
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("roofline", "args")}, indent=1))
    if "roofline" in rec:
        r = rec["roofline"]
        print(f"compute_s={r['compute_s']:.4g} memory_s={r['memory_s']:.4g}"
              f" collective_s={r['collective_s']:.4g}"
              f" bottleneck={r['bottleneck']}"
              f" useful_ratio={r['useful_ratio']:.3f}")


if __name__ == "__main__":
    main()
