"""PyTorch port, the dist substrate: the sharding rules (``dist/sharding.py``)
against the JAX package's ``resolve`` / ``tree_specs`` called directly
(pure Python: the cases of ``tests/test_dist_sharding.py`` but its compiled
one), ``constrain``, the named lockstep mesh and its collectives
(``dist/mesh.py``, ``launch/mesh.py``), and the ring matmul,
``tp_matmul_ag``, ``pipeline_apply`` and the tiny LM with and without
``use_collective_matmul`` against the JAX outputs on the committed fixture
(``tests/fixtures/torch_dist``, made by its ``make_fixture.py`` from
``tests/torch_dist_script.py``).  No JAX program is compiled here.

Tolerance for the fixture's float32 outputs: rtol 2e-5, atol 1e-4 (the
JAX programs' own check in ``tests/spmd_programs.py``).
"""
import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from numpy.testing import assert_allclose

import torch_dist_script as script
from repro.configs import registry as jreg
from repro.dist import sharding as jsh
from repro_torch.configs import registry as treg
from repro_torch.core.tree import leaves, set_path, tree_map
from repro_torch.dist import mesh as mesh_mod
from repro_torch.dist import sharding as tsh
from repro_torch.dist.overlap import (collective_matmul_ag, ring_perm,
                                      tp_matmul_ag)
from repro_torch.dist.pipeline import pipeline_apply
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import transformer as T

from test_torch_store_index_edges import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_dist"
TOL = dict(rtol=2e-5, atol=1e-4)


class FakeMesh:
    """Just axis_names: resolve() only consults those."""
    def __init__(self, *names):
        self.axis_names = names


DM, PDM = ("data", "model"), ("pod", "data", "model")


@pytest.fixture(scope="module")
def jax_side():
    meta = json.loads((FIXTURE / "dist.json").read_text())
    with np.load(FIXTURE / "dist.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return meta, arrays


def test_fixture_is_from_this_script(jax_side):
    sha = hashlib.sha256(Path(script.__file__).read_bytes()).hexdigest()
    assert jax_side[0]["script_sha256"] == sha, (
        "tests/torch_dist_script.py changed: regenerate the fixture with "
        "PYTHONPATH=src python tests/fixtures/torch_dist/make_fixture.py")


# ---------------------------------------------------------------------------
# sharding rules against JAX's, case for case
# ---------------------------------------------------------------------------

def _norm(tree):
    """JAX PartitionSpecs as tuples, through any nesting of dicts, lists
    and tuples."""
    if isinstance(tree, P):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_norm(v) for v in tree)
    return tree


RESOLVE_CASES = [
    # test_resolve_default_plan
    (("layers", "fsdp", "heads"), None, DM),
    (("vocab", "fsdp"), None, DM),
    # test_resolve_drops_axes_missing_from_mesh
    (("batch", None, None), None, DM),
    (("batch", None, None), None, PDM),
    (("batch",), {"batch": "pod"}, DM),
    # test_resolve_never_reuses_a_mesh_axis
    (("fsdp", "vocab"), {"fsdp": ("data", "model")}, DM),
    # test_resolve_unknown_name_falls_back_to_mesh_axis_or_replicates
    (("data", "nonsense"), None, DM),
    # test_resolve_empty_axes_is_scalar_spec
    ((), None, DM),
    # explicit mesh-axis tuples and the dry run's own rule tables
    ((("data", "model"),), None, DM),
    (("batch", "seq", "vocab"), {"seq": "model"}, PDM),
    (("layers", "expert", "fsdp", None), {"fsdp": ("data", "model")}, PDM),
]


@pytest.mark.parametrize("axes,rules,names", RESOLVE_CASES)
def test_resolve_matches_jax(axes, rules, names):
    got = tsh.resolve(axes, rules=rules, mesh=FakeMesh(*names))
    assert got == tuple(jsh.resolve(axes, rules=rules,
                                    mesh=FakeMesh(*names)))


def _scenario_nested(m):
    out = [m.resolve(("heads",), mesh=FakeMesh(*DM))]
    with m.rules_context({"heads": None}):
        out.append(m.resolve(("heads",), mesh=FakeMesh(*DM)))
        with m.rules_context({"heads": "data"}):        # inner wins
            out.append(m.resolve(("heads",), mesh=FakeMesh(*DM)))
        out.append(m.resolve(("heads",), mesh=FakeMesh(*DM)))
    out.append(m.resolve(("heads",), mesh=FakeMesh(*DM)))
    return out


def _scenario_exception(m):
    with pytest.raises(RuntimeError):
        with m.rules_context({"heads": None}):
            raise RuntimeError("boom")
    return [m.resolve(("heads",), mesh=FakeMesh(*DM))]


def _scenario_explicit_beats_context(m):
    with m.rules_context({"ff": None}):
        return [m.resolve(("ff",), rules={"ff": "data"}, mesh=FakeMesh(*DM))]


def _scenario_tree(m):
    tree = {"embed": ("vocab", "fsdp"),
            "blocks": [{"wq": ("layers", "fsdp", "heads"), "ln": ("embed",)},
                       {"we1": ("layers", "expert", "fsdp", None)}],
            "step": ()}
    return [m.tree_specs(tree, mesh=FakeMesh(*DM))]


def _scenario_pair(m):
    # Adafactor's factored v: a pair of axes tuples is two leaves
    leaf = (("layers", "fsdp"), ("layers", "heads"))
    return [m.tree_specs({"v": leaf}, mesh=FakeMesh(*DM))]


def _scenario_overrides(m):
    return [m.tree_specs({"w": ("fsdp", "ff")},
                         rules={"fsdp": None, "ff": ("data", "model")},
                         mesh=FakeMesh(*DM))]


def _scenario_none_leaf(m):
    return [m.tree_specs({"a": ("batch",), "b": None}, mesh=FakeMesh(*DM))]


@pytest.mark.parametrize("scenario", [
    _scenario_nested, _scenario_exception, _scenario_explicit_beats_context,
    _scenario_tree, _scenario_pair, _scenario_overrides, _scenario_none_leaf,
], ids=lambda f: f.__name__[10:])
def test_rules_and_tree_specs_match_jax(scenario):
    """test_dist_sharding.py's rules_context and tree_specs cases, run on
    both packages."""
    assert scenario(tsh) == _norm(scenario(jsh))


def test_default_rules_and_overrides_match_jax():
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES
    for arch in jreg.all_archs():
        js, ts = jreg.get(arch), treg.get(arch)
        assert ts.rules_override == js.rules_override, arch
        assert ts.opt_rules_override == js.opt_rules_override, arch


def test_constrain_noop_outside_mesh():
    assert tsh.current_mesh() is None
    x = torch.arange(8.0).reshape(2, 4)
    assert tsh.constrain(x, ("batch", "heads")) is x


def test_constrain_under_mesh_checks_rank_and_is_identity():
    mesh = make_test_mesh((1, 1), device="cpu")
    x = torch.zeros(4, 4)
    with mesh:
        assert tsh.current_mesh() is mesh
        assert tsh.constrain(x, ("heads", None)) is x
        assert tsh.constrain(x, ()) is x
        with pytest.raises(ValueError, match="rank"):
            tsh.constrain(x, ("batch", "heads", None))
        inner = make_test_mesh((2, 2), device="cpu")
        with inner:
            assert tsh.current_mesh() is inner
        assert tsh.current_mesh() is mesh
    assert tsh.current_mesh() is None      # context exited


# ---------------------------------------------------------------------------
# the named lockstep mesh
# ---------------------------------------------------------------------------

def test_mesh_defaults_and_production_shapes():
    m = mesh_mod.make_mesh(4, device="cpu")
    assert (m.axis_names, m.shape, m.size) == (DM, (1, 4), 4)
    assert m == mesh_mod.ShardMesh((torch.device("cpu"),) * 4)
    assert mesh_mod.axis_index(m, "model") == [0, 1, 2, 3]
    p = make_production_mesh(device="meta")
    assert (p.axis_names, p.shape, p.size) == (DM, (16, 16), 256)
    mp = make_production_mesh(multi_pod=True, device="meta")
    assert (mp.axis_names, mp.shape) == (PDM, (2, 16, 16))
    with pytest.raises(ValueError):
        mesh_mod.ShardMesh((torch.device("cpu"),) * 3, DM, (2, 2))


def test_collectives_within_axis_groups():
    m = make_test_mesh((2, 4), device="cpu")
    xs = [torch.full((2,), float(s)) for s in range(8)]
    got = mesh_mod.ppermute(xs, m, "model", ring_perm(4))
    assert [int(x[0]) for x in got] == [3, 0, 1, 2, 7, 4, 5, 6]
    got = mesh_mod.ppermute(xs, m, "data", [(0, 1)])     # 1 -> nobody: 0
    assert [int(x[0]) for x in got] == [0, 0, 0, 0, 0, 1, 2, 3]
    assert [int(x[0]) for x in mesh_mod.psum(xs, "data", m)] == \
        [4, 6, 8, 10, 4, 6, 8, 10]
    assert [int(x[0]) for x in mesh_mod.psum(xs, "model", m)] == \
        [6] * 4 + [22] * 4
    assert [int(x[0]) for x in mesh_mod.psum(xs)] == [28] * 8
    assert mesh_mod.axis_index(m, "data") == [0, 0, 0, 0, 1, 1, 1, 1]


# ---------------------------------------------------------------------------
# ring matmul, tp_matmul_ag, pipeline and the LM against the fixture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", script.MESHES, ids=lambda s: "x".join(
    map(str, s)))
def test_collective_matmul_matches_jax(jax_side, shape):
    mesh = make_test_mesh(shape, device="cpu")
    x, w = (torch.from_numpy(a) for a in script.cm_inputs())
    n = shape[1]
    s, o = x.shape[0] // n, w.shape[1] // n
    mi = mesh_mod.axis_index(mesh, "model")
    outs = collective_matmul_ag([x[m * s:(m + 1) * s] for m in mi],
                                [w[:, m * o:(m + 1) * o] for m in mi],
                                "model", mesh=mesh)
    got = torch.cat(outs[:n], dim=1)            # data row 0's shards
    assert_allclose(got.numpy(), jax_side[1][f"cm_{shape[0]}x{shape[1]}"],
                    **TOL)
    for i, m in enumerate(mi):                  # data replicas agree
        assert torch.equal(outs[i], outs[m])


@pytest.mark.parametrize("shape", script.MESHES, ids=lambda s: "x".join(
    map(str, s)))
def test_tp_matmul_ag_matches_jax(jax_side, shape):
    x, w = (torch.from_numpy(a) for a in script.tp_inputs())
    with make_test_mesh(shape, device="cpu"):
        got = tp_matmul_ag(x, w)
    assert_allclose(got.numpy(), jax_side[1][f"tp_{shape[0]}x{shape[1]}"],
                    **TOL)


def test_tp_matmul_ag_falls_back_on_jax_conditions():
    x, w = torch.randn(4, 8, 16), torch.randn(16, 24)
    want = x @ w
    assert torch.equal(tp_matmul_ag(x, w), want)             # no mesh
    for shape, xx, ww in (((4, 1), x, w),                    # |model| 1
                          ((2, 4), x[:, :6], w),             # S % 4
                          ((4, 2), x[:3], w),                # B % 4
                          ((2, 4), x, w[:, :22])):           # O % 4
        with make_test_mesh(shape, device="cpu"):
            assert torch.equal(tp_matmul_ag(xx, ww), xx @ ww)
    with make_test_mesh((2, 2), ("data", "tensor"), device="cpu"):
        assert torch.equal(tp_matmul_ag(x, w), want)         # no 'model'


def test_pipeline_matches_jax(jax_side):
    mesh = make_test_mesh(script.PIPE["mesh"], ("pod", "model"),
                          device="cpu")
    x, ws = (torch.from_numpy(a) for a in script.pipe_inputs())
    M = script.PIPE["M"]
    stage = mesh_mod.axis_index(mesh, "pod")
    outs = pipeline_apply(lambda w, h: torch.tanh(h @ w),
                          [ws[s] for s in stage], x, mesh=mesh, axis="pod",
                          n_stages=4, n_microbatches=M)
    for out, s in zip(outs, stage):
        if s == 3:
            assert_allclose(out.numpy(), jax_side[1]["pipe"], **TOL)
            assert_allclose(out.numpy(), script.pipe_reference(
                x.numpy(), ws.numpy()), rtol=2e-5, atol=1e-5)
        else:
            assert not out.any()


def test_pipeline_raises_as_jax_does():
    mesh = make_test_mesh((4, 2), ("pod", "model"), device="cpu")
    x = torch.zeros(6, 3, 8)
    params = [torch.eye(8)] * 8
    kw = dict(mesh=mesh, axis="pod")
    with pytest.raises(ValueError, match="n_stages"):
        pipeline_apply(lambda w, h: h @ w, params, x, n_stages=2,
                       n_microbatches=6, **kw)
    with pytest.raises(ValueError, match="leading dim"):
        pipeline_apply(lambda w, h: h @ w, params, x, n_stages=4,
                       n_microbatches=5, **kw)
    with pytest.raises(ValueError, match="preserve shape"):
        pipeline_apply(lambda w, h: h[:, :4], params, x, n_stages=4,
                       n_microbatches=6, **kw)


def _lm_params(cfg):
    out = tree_map(lambda s: None, T.param_shapes(cfg))
    for path, shape in leaves(T.param_shapes(cfg)):
        set_path(out, path, torch.from_numpy(script.lm_param(
            "/".join(map(str, path)), shape)))
    return out


@pytest.mark.parametrize("shape", script.MESHES, ids=lambda s: "x".join(
    map(str, s)))
def test_lm_collective_matmul_matches_jax(jax_side, shape):
    cfg = T.LMConfig(**script.LM, dtype=torch.float32)
    params = _lm_params(cfg)
    tokens = torch.from_numpy(script.lm_tokens())
    tag = f"{shape[0]}x{shape[1]}"
    outs = {}
    for cm in (False, True):
        c = dataclasses.replace(cfg, use_collective_matmul=cm)
        with make_test_mesh(shape, device="cpu"), \
                tsh.rules_context(script.LM_RULES):
            outs[cm] = T.forward(params, c, tokens, backend="ref")[0]
        assert_allclose(outs[cm].numpy(),
                        jax_side[1][f"lm_{tag}_{'cm' if cm else 'plain'}"],
                        **TOL)
    assert_allclose(outs[True].numpy(), outs[False].numpy(),
                    rtol=2e-5, atol=2e-5)
