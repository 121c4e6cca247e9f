"""PyTorch port, BST (the recsys zoo): ``data/recsys.py`` (the same arrays
from the same seed, bit for bit), ``models/recsys.py`` at REDUCED
(forward, loss, every gradient, the user tower and retrieval scores),
``gspmd_lookup``, one ``recsys_train_step`` against the JAX package's
jitted ``train_batch`` cell, the serve step, and ``run_training``.

Weights from a numpy seed through ``params_from_numpy``.  Tolerances:
forward and loss rtol 1e-5 (float32 matmuls that may pair terms
otherwise); gradients rtol 1e-4 / atol 1e-6; after one AdamW step the
bounds of ``test_torch_train.py::test_train_steps_match_the_jax_cell``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import bst as jbst
from repro.data import recsys as jdata
from repro.launch import steps as jsteps
from repro.launch.mesh import make_test_mesh
from repro.models import embedding as jemb
from repro.models import recsys as JR
from repro.optim import optimizers as jopt
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import bst
from repro_torch.core.tree import leaves, value_and_grad
from repro_torch.data import recsys as tdata
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import embedding as temb
from repro_torch.models import recsys as R
from repro_torch.optim import optimizers as topt

from test_torch_gnn import numpy_params
from test_torch_store_index_edges import one_torch_thread  # noqa: F401

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _leaves(tree):
    return [t for _, t in leaves(tree)]


def _batch(B, seed, n_items=1000):
    return [np.array(a) for a in jdata.bst_batch(batch=B, n_items=n_items,
                                                 seed=seed)]


@pytest.mark.parametrize("kw", [dict(batch=8, n_items=1000, seed=1),
                                dict(batch=300, seq_len=7, n_items=50,
                                     n_dense=3, seed=4)])
def test_bst_batch_is_bit_equal(kw):
    for a, b in zip(jdata.bst_batch(**kw),
                    tdata.bst_batch(**kw, device="cpu")):
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype and np.array_equal(b.numpy(), a)


def test_param_shapes_and_init_law():
    cfg = bst.REDUCED
    shp, _ = JR.param_shapes(jbst.REDUCED)
    assert jax.tree.leaves(shp, is_leaf=lambda x: isinstance(x, tuple)) \
        == [s for _, s in leaves(R.param_shapes(cfg))]
    p = R.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = JR.init_params(jbst.REDUCED, jax.random.key(0))
    for (path, t), w in zip(leaves(p), jax.tree.leaves(jp)):
        assert tuple(t.shape) == w.shape, path
        if t.dim() == 1:        # ones of length embed_dim, else zeros
            assert np.array_equal(t.numpy(), np.asarray(w)), path


def test_gspmd_lookup_matches_jax():
    rng = np.random.default_rng(2)
    tab = rng.normal(size=(20, 4)).astype(np.float32)
    ids = rng.integers(-1, 20, (3, 5)).astype(np.int32)
    assert np.array_equal(
        temb.gspmd_lookup(torch.from_numpy(tab), torch.from_numpy(ids))
        .numpy(), np.asarray(jemb.gspmd_lookup(tab, ids)))


@pytest.fixture(scope="module")
def pair():
    tree = numpy_params(R.param_shapes(bst.REDUCED), seed=8)
    return tree, R.params_from_numpy(bst.REDUCED, tree, device="cpu")


def test_forward_loss_and_grads_match_jax(pair):
    tree, params = pair
    hist, tgt, dense, labels = _batch(16, 3)
    hist[0, :4] = -1                                  # padding items
    jp = jax.tree.map(jnp.asarray, tree)
    jc = jbst.REDUCED
    (jl, _), jg = jax.value_and_grad(
        lambda p: JR.loss_fn(p, jc, hist, tgt, dense, labels),
        has_aux=True)(jp)
    args = [torch.from_numpy(a) for a in (hist, tgt, dense, labels)]
    assert_allclose(R.forward(params, bst.REDUCED, *args[:3]).numpy(),
                    np.asarray(JR.forward(jp, jc, hist, tgt, dense)),
                    **FWD_TOL)
    (loss, m), grads = value_and_grad(R.loss_fn, params, bst.REDUCED,
                                             *args)
    assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert_allclose(float(m["bce"]), float(jl), rtol=1e-5)
    for g, w in zip(_leaves(grads), jax.tree.leaves(jg)):
        assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_user_tower_and_retrieval_match_jax(pair):
    tree, params = pair
    hist, _, dense, _ = _batch(2, 5)
    cand = np.random.default_rng(0).integers(-1, 1000, 64).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    t = [torch.from_numpy(a) for a in (hist, dense, cand)]
    assert_allclose(R.user_tower(params, bst.REDUCED, *t[:2]).numpy(),
                    np.asarray(JR.user_tower(jp, jbst.REDUCED, hist, dense)),
                    **FWD_TOL)
    got = R.retrieval_scores(params, bst.REDUCED, *t)
    assert got.dtype == torch.float32 and got.shape == (2, 64)
    assert_allclose(got.numpy(), np.asarray(JR.retrieval_scores(
        jp, jbst.REDUCED, hist, dense, cand)), **FWD_TOL)


def test_recsys_steps_match_the_jax_cells():
    mesh = make_test_mesh((1, 1), ("data", "model"))
    spec = bst.SPEC
    jcell = jsteps.build_cell("bst", "train_batch", mesh, reduced=True)
    B = tsteps.recsys_batch(spec.cell("train_batch"), reduced=True)
    assert B == jcell.args[2].shape[0]
    batch = _batch(B, 9)
    tree = numpy_params(R.param_shapes(bst.REDUCED), seed=10)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init_opt_state(jp, jopt.AdamWConfig())
    serve = jax.jit(jsteps.build_cell("bst", "serve_p99", mesh,
                                      reduced=True).fn)
    with mesh:
        jscore = serve(jp, *batch[:3])
        jp, js, jm = jax.jit(jcell.fn)(jp, js, *batch)
    ocfg = topt.AdamWConfig()
    tp = R.params_from_numpy(bst.REDUCED, tree, device="cpu")
    tb = [torch.from_numpy(a) for a in batch]
    assert_allclose(tsteps.recsys_serve_step(tp, *tb[:3], bst.REDUCED)
                    .numpy(), np.asarray(jscore), **FWD_TOL)
    ts = topt.init_opt_state(tp, ocfg)
    tp, ts, tm = tsteps.recsys_train_step(tp, ts, *tb, bst.REDUCED, ocfg)
    assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]), rtol=1e-4)
    for g, w in zip(_leaves(tp), jax.tree.leaves(jp)):
        d = np.abs(g.numpy() - np.asarray(w))
        assert d.max() <= 2 * ocfg.lr
        assert (d > 1e-6).sum() <= max(1, d.size // 10_000)


def test_run_training_bst_and_what_it_refuses(capsys, tmp_path):
    out = ttrain.run_training("bst", steps=3, log_every=1, device="cpu")
    assert set(out) == {"loss", "gnorm"}
    assert all(np.isfinite(v) for v in out.values())
    assert capsys.readouterr().out.count("loss=") == 3
    for arch in ("no-such-arch", "a1-kg"):       # a1-kg is a graph store
        with pytest.raises(KeyError):
            ttrain.run_training(arch, steps=1, device="cpu")
    # checkpoints are ported: a step's save, then a resume past it
    ttrain.run_training("bst", steps=1, device="cpu", ckpt_dir=str(tmp_path),
                        ckpt_every=1)
    assert CheckpointManager(str(tmp_path)).steps() == [1]
    ttrain.run_training("bst", steps=2, device="cpu", ckpt_dir=str(tmp_path),
                        ckpt_every=1)
    assert "resumed from step 1" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path)).steps() == [1, 2]
