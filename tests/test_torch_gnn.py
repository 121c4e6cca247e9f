"""PyTorch port, the GNN zoo: ``data/graphs.py`` (the same arrays from the
same seed, bit for bit), ``models/gnn/common.py``, GCN and GraphSAGE
(REDUCED forward, loss and every gradient), one ``gnn_train_step`` against
the JAX package's jitted GNN cell, and ``run_training``.

Weights are drawn from a numpy seed (biases too) and handed to both sides
through ``params_from_numpy``.  Tolerances: forward and loss rtol 1e-5
(float32; the port's ``index_add`` and JAX's ``segment_sum`` both add the
edges in order on the CPU, the matmuls may pair terms otherwise);
gradients rtol 1e-4 / atol 1e-6; after one AdamW step the bounds of
``test_torch_train.py::test_train_steps_match_the_jax_cell``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import registry as jreg
from repro.data import graphs as jgraphs
from repro.launch import steps as jsteps
from repro.launch.mesh import make_test_mesh
from repro.models.gnn import common as jcommon
from repro.models.gnn import gcn as jgcn
from repro.models.gnn import sage as jsage
from repro.optim import optimizers as jopt
from repro_torch.configs import gcn_cora, graphsage_reddit
from repro_torch.core.tree import leaves, value_and_grad
from repro_torch.data import graphs as tgraphs
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.gnn import common as tcommon
from repro_torch.models.gnn import gcn as tgcn
from repro_torch.models.gnn import sage as tsage
from repro_torch.optim import optimizers as topt

from test_torch_store_index_edges import one_torch_thread  # noqa: F401

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# arch -> (port config module, port model, JAX model)
ARCHS = {"gcn-cora": (gcn_cora, tgcn, jgcn),
         "graphsage-reddit": (graphsage_reddit, tsage, jsage)}


def torch_batch(jb) -> tcommon.GraphBatch:
    """The port's GraphBatch of a JAX one, through numpy."""
    return tcommon.GraphBatch(**{
        f.name: (torch.from_numpy(np.array(v))
                 if isinstance(v := getattr(jb, f.name), jax.Array) else v)
        for f in dataclasses.fields(jb)})


def numpy_params(shapes, seed):
    """Every leaf of a shape tree drawn N(0, 1/fan_in) from numpy (1-D
    leaves N(0, 0.1), so that biases matter)."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(lambda s: None, shapes,
                       is_leaf=lambda x: isinstance(x, tuple))
    for path, s in leaves(shapes):
        a = rng.normal(size=s) * (s[0] ** -0.5 if len(s) > 1 else 0.1)
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = a.astype(np.float32)
    return out


def _leaves(tree):
    return [t for _, t in leaves(tree)]


@pytest.mark.parametrize("make", [
    lambda m: m.cora_like(0.1, seed=3),
    lambda m: m.cora_like(1.0),
    lambda m: m.reddit_like(0.0004, seed=1),
    lambda m: m.synthetic_graph_batch(50, 301, 7, seed=2,
                                      with_positions=True),
    lambda m: m.molecule_batch(batch=4, seed=5)])
def test_graph_generators_are_bit_equal(make):
    class OnCpu:          # the port's generators, with device="cpu"
        def __getattr__(self, name):
            fn = getattr(tgraphs, name)
            return lambda *a, **k: fn(*a, device="cpu", **k)
    jb, tb = make(jgraphs), make(OnCpu())
    assert tb.n_graphs == jb.n_graphs
    for f in dataclasses.fields(jb):
        a, b = getattr(jb, f.name), getattr(tb, f.name)
        if a is None or f.name == "n_graphs":
            assert b is None or f.name == "n_graphs", f.name
            continue
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype, (f.name, b.dtype, a.dtype)
        assert np.array_equal(b.numpy(), a), f.name


@pytest.mark.parametrize("norm", [None, "sym", "mean"])
def test_spmm_matches_jax(norm):
    jb = jgraphs.synthetic_graph_batch(50, 301, 6, seed=4)
    x = np.random.default_rng(0).normal(size=(50, 6)).astype(np.float32)
    want = jcommon.spmm(jnp.asarray(x), jb, 50, norm=norm)
    got = tcommon.spmm(torch.from_numpy(x), torch_batch(jb), 50, norm=norm)
    assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    assert_allclose(tcommon.degree(torch_batch(jb), 50, "src").numpy(),
                    np.asarray(jcommon.degree(jb, 50, "src")))


def test_mlp_matches_jax():
    dims = (6, 16, 16, 3)
    tree = jcommon.mlp_init(jax.random.key(0), dims, layer_norm=True)
    tree = jax.tree.map(lambda a: np.asarray(a) + 0.05, tree)
    x = np.random.default_rng(1).normal(size=(9, 6)).astype(np.float32)
    want = jcommon.mlp_apply(jax.tree.map(jnp.asarray, tree),
                             jnp.asarray(x))
    tp = jax.tree.map(torch.from_numpy, tree)
    got = tcommon.mlp_apply(tp, torch.from_numpy(x))
    assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    gen = torch.Generator().manual_seed(0)
    p = tcommon.mlp_init(gen, dims, layer_norm=True)
    assert [tuple(w.shape) for w in p["w"]] == [(6, 16), (16, 16), (16, 3)]
    assert torch.equal(p["ln_scale"], torch.ones(3))
    assert tcommon.constrain_batch(torch_batch(
        jgraphs.cora_like(0.01))).n_graphs == 1


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_loss_and_grads_match_jax(arch):
    conf, tmod, jmod = ARCHS[arch]
    jcfg = jreg.get(arch).reduced
    cfg = dataclasses.replace(conf.REDUCED, d_in=12)
    jcfg = dataclasses.replace(jcfg, d_in=12)
    tree = numpy_params(tmod.param_shapes(cfg), seed=len(arch))
    jb = jgraphs.synthetic_graph_batch(60, 301, 12, n_classes=cfg.n_classes,
                                       seed=7)
    jb = dataclasses.replace(jb, labels=jb.labels.at[:5].set(-1))
    jp = jax.tree.map(jnp.asarray, tree)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmod.loss_fn(p, jcfg, jb), has_aux=True)(jp)
    params = tmod.params_from_numpy(cfg, tree, device="cpu")
    tb = torch_batch(jb)
    assert_allclose(tmod.forward(params, cfg, tb).numpy(),
                    np.asarray(jmod.forward(jp, jcfg, jb)), **FWD_TOL)
    (loss, m), grads = value_and_grad(tmod.loss_fn, params, cfg, tb)
    assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert_allclose(float(m["acc"]), float(jm["acc"]))
    for g, w in zip(_leaves(grads), jax.tree.leaves(jg)):
        assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
    # params_from_numpy copies: updating the params leaves the tree alone
    _leaves(params)[0].add_(1.0)
    assert np.array_equal(jax.tree.leaves(tree)[0],
                          np.asarray(jax.tree.leaves(jp)[0]))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_gnn_train_step_matches_the_jax_cell(arch):
    conf, tmod, _ = ARCHS[arch]
    mesh = make_test_mesh((1, 1), ("data", "model"))
    jcell = jsteps.build_cell(arch, "full_graph_sm", mesh, reduced=True)
    jstep = jax.jit(jcell.fn)
    spec = conf.SPEC
    cfg = tsteps.gnn_cell_config(spec.reduced, spec.cell("full_graph_sm"),
                                 reduced=True)
    assert cfg.d_in == jcell.model_cfg.d_in
    N, E, dF, _ = tsteps.gnn_geometry(spec.cell("full_graph_sm"),
                                      reduced=True)
    assert (N, E, dF) == (jcell.args[2].node_feat.shape[0],
                          jcell.args[2].edge_src.shape[0],
                          jcell.args[2].node_feat.shape[1])
    jb = jgraphs.synthetic_graph_batch(N, E, dF, n_classes=cfg.n_classes,
                                       seed=11)
    tree = numpy_params(tmod.param_shapes(cfg), seed=3)
    jp = jax.tree.map(jnp.asarray, tree)
    ocfg = topt.AdamWConfig()
    js = jopt.init_opt_state(jp, jopt.AdamWConfig())
    with mesh:
        jp, js, jm = jstep(jp, js, jb)
    tp = tmod.params_from_numpy(cfg, tree, device="cpu")
    ts = topt.init_opt_state(tp, ocfg)
    tp, ts, tm = tsteps.gnn_train_step(tp, ts, torch_batch(jb), cfg, ocfg)
    assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]), rtol=1e-4)
    assert int(ts.step) == int(js.step) == 1
    for g, w in zip(_leaves(tp), jax.tree.leaves(jp)):
        d = np.abs(g.numpy() - np.asarray(w))
        assert d.max() <= 2 * ocfg.lr
        assert (d > 1e-6).sum() <= max(1, d.size // 10_000)


def test_gnn_geometry_matches_jax():
    for arch in ARCHS:
        spec = jreg.get(arch)
        for c in spec.shapes:
            for reduced in (False, True):
                assert tsteps.gnn_geometry(c, reduced) == \
                    jsteps._gnn_geometry(c, reduced), (arch, c.shape_id)
        assert [dataclasses.astuple(c) for c in ARCHS[arch][0].SPEC.shapes] \
            == [dataclasses.astuple(c) for c in spec.shapes]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_run_training_gnn(arch, capsys):
    out = ttrain.run_training(arch, steps=3, log_every=1, device="cpu")
    assert set(out) == {"loss", "gnorm"}
    assert all(np.isfinite(v) for v in out.values())
    assert capsys.readouterr().out.count("loss=") == 3
