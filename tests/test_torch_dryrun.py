"""PyTorch port, the analysis tooling: ``launch/steps.py::build_cell``, the
op counts of ``launch/hloanalysis.py::analyze_ops`` (a step traced once on
``meta`` tensors), the LM kernels' meta routes, ``launch/roofline.py`` and
``launch/report.py``, against the JAX package on the committed fixture
(``tests/fixtures/torch_dist``: each reduced cell's arguments, specs on a
(2, 4) mesh, ``model_flops`` and ``analyze_hlo`` flops on a (1, 1) mesh)
and against JAX's pure-Python ``collective_wire_bytes`` and ``report``.
No JAX program is compiled here.

``build_cell``'s shapes, dtypes, specs and ``model_flops`` must equal JAX's
exactly.  The traced matmul flops must agree with ``analyze_hlo``'s dot
flops within 1 % for the gnn and recsys cells.  For the LM cells the
tolerance is 10 %, and the port counts fewer: on a CPU the JAX attention
is the chunked einsum recurrence, whose dots score every (query, key) pair
of a chunk, masked or not, forward (4 D flops a pair) and backward (8 D);
the port's cells run the flash kernels, whose meta routes count only the
pairs the causal window leaves live, at 4 D forward and 14 D backward
(``kernels/flash_attention/kernel.py::flash_cost``: each backward kernel
recomputes the scores).  The reduced danube cells (64 positions, a
32-key window) keep 38 % of the pairs.
"""
import json
import math
from pathlib import Path

import pytest
import torch

from repro.launch import report as jreport
from repro.launch import roofline as jroofline
from repro_torch.configs import registry as treg
from repro_torch.dist import mesh as mesh_mod
from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention import kernel as flash
from repro_torch.kernels.rmsnorm import kernel as rms
from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch.hloanalysis import analyze_ops
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import build_cell

from test_torch_store_index_edges import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "torch_dist" / "dist.json"
CELLS = [f"{a}/{s}" for a, s in treg.all_cells()
         if not treg.get(a).cell(s).skip]


@pytest.fixture(scope="module")
def jax_cells():
    return json.loads(FIXTURE.read_text())["cells"]


def _json(x):
    return json.loads(json.dumps(x))


def test_fixture_lists_every_cell(jax_cells):
    assert sorted(jax_cells) == sorted(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_build_cell_matches_jax(jax_cells, name):
    """Each argument's path, shape, dtype and spec on the (2, 4) mesh, and
    model_flops, equal the JAX cell's at reduced size."""
    arch, shape = name.split("/")
    mesh = make_test_mesh((2, 4), device="meta")
    cell = build_cell(arch, shape, mesh, reduced=True)
    got = {r["path"]: {k: r[k] for k in ("shape", "dtype", "spec")}
           for r in dryrun._arg_records(cell.args, cell.in_shardings, mesh)}
    want = {r["path"]: {k: r[k] for k in ("shape", "dtype", "spec")}
            for r in jax_cells[name]["args"]}
    assert _json(got) == want
    assert cell.model_flops == jax_cells[name]["model_flops"]


@pytest.mark.parametrize("name,tol", [
    ("gcn-cora/full_graph_sm", 0.01), ("bst/train_batch", 0.01),
    ("h2o-danube-3-4b/train_4k", 0.10),
    ("qwen3-moe-235b-a22b/prefill_32k", 0.10)])
def test_analyze_ops_flops_match_jax(jax_cells, name, tol):
    arch, shape = name.split("/")
    cell = build_cell(arch, shape, make_test_mesh((1, 1), device="meta"),
                      reduced=True)
    a, _ = analyze_ops(cell.fn, *cell.args)
    want = jax_cells[name]["flops"]
    assert abs(a.flops - want) <= tol * want, (a.flops, want)
    assert a.flops == a.matmul_flops + sum(a.kernel_flops.values())
    # the roofline charges each dtype's flops at its own peak
    assert sum(a.flops_by_dtype.values()) == pytest.approx(a.flops,
                                                          rel=1e-12)
    assert roofline.analyze(a).compute_s == pytest.approx(sum(
        f / roofline.peak_flops(d) for d, f in a.flops_by_dtype.items()),
        rel=1e-12)
    if treg.get(arch).family == "lm":
        assert a.flops < want       # the flash kernels skip masked pairs
        assert a.kernel_calls["flash_fwd"] == cell.model_cfg.n_layers
        # rmsnorm_fwd runs at the float32 rate whatever its dtype
        assert a.flops_by_dtype["float32"] >= a.kernel_flops["rmsnorm_fwd"]


def test_every_cell_builds_at_full_size():
    """build_cell at full size on one card's mesh and on the production
    pod: shapes only, nothing allocated."""
    for mesh in (make_test_mesh((1, 1), device="meta"),
                 dryrun.make_mesh("pod")):
        for name in CELLS:
            cell = build_cell(*name.split("/"), mesh)
            assert cell.model_flops >= 0
    with pytest.raises(ValueError, match="skipped"):
        build_cell("llama3-405b", "long_500k",
                   make_test_mesh((1, 1), device="meta"))


def test_meta_routes_report_the_bound_formulas():
    """The LM kernels' meta routes give their outputs' shapes and report
    the cost functions that chip_smoke's bound column uses."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    m = dict(device="meta", dtype=torch.bfloat16)
    x, scale = torch.empty(3, 40, 256, **m), torch.empty(256, **m)
    q, k = torch.empty(8, 100, 64, **m), torch.empty(2, 100, 64, **m)
    kw = dict(causal=True, window=32, scale=0.125, q_offset=0)
    lse = torch.empty(8, 100, device="meta")

    def step():
        return (rms.rmsnorm_fwd(x, scale), flash.flash_fwd(q, k, k, **kw),
                flash.flash_bwd_dkv(q, k, k, q, lse, lse, **kw),
                flash.flash_bwd_dq(q, k, k, q, lse, lse, **kw))
    a, (y, (o, l), (dk, dv), dq) = analyze_ops(step)
    assert a.flops_by_dtype == {
        "float32": a.kernel_flops["rmsnorm_fwd"],
        "bfloat16": sum(f for n, f in a.kernel_flops.items()
                        if n.startswith("flash"))}
    assert (y.shape, o.shape, l.shape, l.dtype, dk.shape, dq.shape) == \
        (x.shape, q.shape, (8, 100), torch.float32, k.shape, q.shape)
    pairs = flash.live_pairs(100, 100, True, 32)
    assert a.kernel_flops == {
        "rmsnorm_fwd": 4 * x.numel(), "flash_fwd": 4 * 64 * 8 * pairs,
        "flash_bwd_dkv": 8 * 64 * 8 * pairs,
        "flash_bwd_dq": 6 * 64 * 8 * pairs}
    bkw = {k_: v for k_, v in kw.items() if k_ != "scale"}
    for name, args, fl, nb in (
            ("rmsnorm_fwd", (x, scale), *rms.rmsnorm_fwd_cost(x)),
            ("flash_fwd", (q, k, k), *flash.flash_cost("flash_fwd", q, k,
                                                       **bkw)),
            ("flash_bwd_dkv", (q, k, k, q, lse, lse),
             *flash.flash_cost("flash_bwd_dkv", q, k, **bkw)),
            ("flash_bwd_dq", (q, k, k, q, lse, lse),
             *flash.flash_cost("flash_bwd_dq", q, k, **bkw))):
        peak = roofline.F32_FLOPS if name == "rmsnorm_fwd" else \
            roofline.PEAK_FLOPS
        ms, _ = cs._bound(name, args, kw)
        assert ms == pytest.approx(
            max(nb / roofline.HBM_BW, fl / peak) * 1e3, rel=1e-12)
    assert _cuda.COUNTERS == []


def test_analyze_ops_peak_reads_and_collectives():
    x = torch.empty(1000, 1000, device="meta")      # 4 MB

    def f(x):
        for _ in range(50):
            y = x * 2                                # one live at a time
        ok = bool(torch.isfinite(y.sum()))
        mesh_mod.psum([y] * 4, "model",
                      make_test_mesh((1, 4), device="meta"))
        return y, ok
    a, (y, ok) = analyze_ops(f, x)
    assert ok and a.host_reads == 1
    assert 8e6 <= a.peak_bytes <= 16e6 + 64
    assert a.arg_bytes == 4e6 and a.out_bytes == 4e6
    assert a.coll_detail["counts"] == {"all-reduce": 1}
    assert a.wire_bytes == pytest.approx(2 * 4e6 * 3 / 4)
    assert a.flops == 0 and a.mem_bytes >= 50 * 8e6


HLO = {
    "all-reduce": ("%a = f32[8,16]{1,0} all-reduce(f32[8,16]{1,0} %x), "
                   "replica_groups=[2,4]<=[8], to_apply=%sum",
                   ("all-reduce", 512, 4)),
    "all-gather": ("%g = bf16[4,32]{1,0} all-gather(bf16[1,32]{1,0} %x), "
                   "replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}",
                   ("all-gather", 256, 4)),
    "reduce-scatter": ("%r = f32[2,8]{1,0} reduce-scatter(f32[8,8]{1,0} "
                       "%x), replica_groups=[2,4]<=[8], dimensions={0}",
                       ("reduce-scatter", 64, 4)),
    "all-to-all": ("%t = s32[64]{0} all-to-all(s32[64]{0} %x), "
                   "replica_groups=[1,8]<=[8], dimensions={0}",
                   ("all-to-all", 256, 8)),
    "collective-permute": ("%p = f32[16,24]{1,0} collective-permute-start("
                           "f32[16,24]{1,0} %x), source_target_pairs="
                           "{{0,1},{1,0}}", ("collective-permute", 1536,
                                            None)),
    "group-of-one": ("%a = f32[8]{0} all-reduce(f32[8]{0} %x), "
                     "replica_groups=[8,1]<=[8], to_apply=%sum",
                     ("all-reduce", 32, 1)),
}


@pytest.mark.parametrize("kind", sorted(HLO))
def test_collective_wire_bytes_matches_jax(kind):
    text, rec = HLO[kind]
    assert roofline.collective_wire_bytes([rec], 8) == \
        jroofline.collective_wire_bytes(text, 8)


def test_report_matches_jax(tmp_path):
    """The dry run's records, from one cell of each status, render to JAX's
    table and summary."""
    for arch, shape in (("gcn-cora", "full_graph_sm"), ("bst", "serve_p99"),
                        ("llama3-405b", "long_500k"), ("a1-kg", "serve_q1")):
        rec = dryrun.run_cell(arch, shape, "h100", str(tmp_path))
        assert rec["status"] == {"gcn-cora": "ok", "bst": "ok",
                                 "llama3-405b": "skipped",
                                 "a1-kg": "host_driven"}[arch]
    recs = report.load(str(tmp_path))
    assert recs == jreport.load(str(tmp_path))
    assert report.summary(recs) == jreport.summary(recs)
    assert report.table(recs, "h100") == jreport.table(recs, "h100")
    assert report.table(recs, "h100").count("\n") == 5
    a1 = [r for r in recs if r["family"] == "a1"][0]
    assert a1["n_shards"] == 1 and a1["roofline"]["bottleneck"] == "host"
    assert a1["store_bytes_per_shard"] == a1["store_bytes"] > 0
    assert math.isclose(a1["roofline"]["model_flops"], 64 * 16384 * 8)


def test_pod_records_are_specs_only(tmp_path):
    """Under a production mesh the dry run traces nothing: the record holds
    each argument's spec and bytes a shard, and no roofline, peak or
    memory status, so the table never shows the one card's peak as a
    device's."""
    recs = [dryrun.run_cell(a, s, "pod", str(tmp_path))
            for a, s in (("gcn-cora", "full_graph_sm"),
                         ("h2o-danube-3-4b", "train_4k"),
                         ("a1-kg", "serve_q1"))]
    for rec in recs:
        assert rec["status"] == "specs_only" and rec["mesh_devices"] == 256
        assert not {"roofline", "peak_bytes", "n_devices"} & set(rec)
        assert rec["args_bytes_per_shard"] == sum(
            r["bytes_per_shard"] for r in rec["args"])
    lm = recs[1]
    assert lm["args_bytes_per_shard"] < sum(r["bytes"] for r in lm["args"])
    text = report.table(report.load(str(tmp_path)), "pod")
    rows = text.splitlines()[2:]
    assert len(rows) == 3
    for rec, row in zip(sorted(recs, key=lambda r: (
            {"a1": 0, "lm": 1, "gnn": 2}[r["family"]])), rows):
        assert row.startswith(f"| {rec['arch']} | {rec['shape']} |")
        assert "specs only" in row and "peak" not in row
        assert f"args {rec['args_bytes_per_shard'] / 1e9:.1f} GB" in row
    assert report.table(report.load(str(tmp_path)), "h100").count("\n") == 1


@pytest.mark.parametrize("dtype,peak", [
    (torch.float32, roofline.F32_FLOPS), (torch.bfloat16, roofline.PEAK_FLOPS)])
def test_roofline_charges_each_dtype_at_its_peak(dtype, peak):
    """The compute term charges a float32 matmul at the float32 rate and a
    bf16 one at the tensor cores'; a step of both sums the two."""
    m = dict(device="meta", dtype=dtype)
    a, _ = analyze_ops(lambda x, w: x @ w, torch.empty(64, 32, **m),
                       torch.empty(32, 16, **m))
    key = str(dtype).replace("torch.", "")
    assert a.flops_by_dtype == {key: 2.0 * 64 * 32 * 16} == \
        {key: a.matmul_flops}
    rl = roofline.analyze(a)
    assert rl.compute_s == a.flops / peak == \
        a.flops / roofline.peak_flops(dtype)
    assert rl.flops_by_dtype == a.flops_by_dtype
    f32 = torch.empty(64, 64, device="meta")

    def both(x, w):
        return x @ w, f32 @ f32
    b, _ = analyze_ops(both, torch.empty(64, 32, **m),
                       torch.empty(32, 16, **m))
    want = {key: 2.0 * 64 * 32 * 16}
    want["float32"] = want.get("float32", 0.0) + 2.0 * 64 ** 3
    assert b.flops_by_dtype == want
    assert roofline.analyze(b).compute_s == pytest.approx(
        sum(f / roofline.peak_flops(d) for d, f in want.items()), rel=1e-15)


def test_tree_walkers_open_tuples_and_dataclasses():
    """``map_leaves`` / ``walk_leaves`` / ``get_path``: one walk over the
    step arguments' containers for the dry run, the spec trees and the
    meta copies."""
    from repro_torch.core.tree import get_path, map_leaves, walk_leaves
    from repro_torch.optim.optimizers import OptState
    t = torch.zeros(2, 3)
    tree = ({"b": [t, (t, 5)], "a": OptState(step=t, m={"w": t}, v=None)},
            7, t)
    spec = map_leaves(lambda x: tuple(x.shape), tree)
    assert spec == ({"b": [(2, 3), ((2, 3), 5)],
                     "a": OptState(step=(2, 3), m={"w": (2, 3)}, v=None)},
                    7, (2, 3))
    paths = [p for p, _ in walk_leaves(tree)]
    assert paths == [(0, "a", "step"), (0, "a", "m", "w"), (0, "b", 0),
                     (0, "b", 1, 0), (2,)]
    assert all(get_path(tree, p) is t for p in paths)
    assert all(get_path(spec, p) == (2, 3) for p in paths)
    assert map_leaves(lambda x: x.to("meta"), tree)[0]["a"].m["w"].is_meta
