"""PyTorch port, the rest of the GNN zoo: ``models/gnn/irreps.py`` (the
same numpy algebra, bit for bit), MeshGraphNet and NequIP (``forward``,
``loss_fn`` and every gradient, NequIP's ``forces``; padding edges and a
self-loop among the edges), their configs and cells in
``launch/steps.py``, one ``gnn_train_step`` of each against the JAX train
cell, and ``run_training``'s batches against the JAX trainer's, on the
committed fixture (``tests/fixtures/torch_zoo_rest``, made by its
``make_fixture.py`` from ``tests/torch_zoo_rest_script.py``).  No JAX
program is compiled here.

Tolerances (float32): forward and loss rtol 1e-5, atol 1e-6; each
gradient leaf and the forces within 1e-5 of the leaf's largest magnitude
plus 1e-6 (``close``: a leaf's small entries are sums that cancel, and
through two LayerNorm MLP blocks both packages' f32 gradients differ from
float64 by a few 1e-6 of their leaf's scale); after one AdamW step the
bounds of ``test_torch_gnn.py``; the rotation check the JAX test's own.
"""
import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import torch_zoo_rest_script as script
from repro.models.gnn import irreps as jirreps
from repro_torch.configs import registry as treg
from repro_torch.core.tree import leaves, set_path, tree_map, value_and_grad
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.gnn import irreps as tirreps
from repro_torch.models.gnn import meshgraphnet as tmgn
from repro_torch.models.gnn import nequip as tnequip
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.optim import optimizers as topt

from test_torch_store_index_edges import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_zoo_rest"
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = 1e-5          # of a gradient leaf's largest magnitude
MODELS = {"mgn": (tmgn, tmgn.MGNConfig(**script.MGN_CFG), script.MGN_CASES),
          "nequip": (tnequip, tnequip.NequIPConfig(**script.NEQUIP_CFG),
                     script.NEQUIP_CASES)}
CASES = [(m, c) for m, (_, _, cs) in MODELS.items() for c in cs]


@pytest.fixture(scope="module")
def jax_side():
    meta = json.loads((FIXTURE / "zoo_rest.json").read_text())
    with np.load(FIXTURE / "zoo_rest.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return meta, arrays


def test_fixture_is_from_this_script(jax_side):
    sha = hashlib.sha256(Path(script.__file__).read_bytes()).hexdigest()
    assert jax_side[0]["script_sha256"] == sha, (
        "tests/torch_zoo_rest_script.py changed: regenerate the fixture "
        "with PYTHONPATH=src python tests/fixtures/torch_zoo_rest/"
        "make_fixture.py")


def test_irreps_equal_jax_bit_for_bit():
    assert tirreps.PATHS == jirreps.PATHS
    assert len(tirreps.PATHS) == 11 and tirreps.L_MAX == jirreps.L_MAX
    for path in tirreps.PATHS + [(0, 1, 2), (2, 2, 1)]:
        assert np.array_equal(tirreps.real_cg(*path), jirreps.real_cg(*path))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(17, 3))
    R = tirreps._rand_rotation(np.random.default_rng(5))
    assert np.array_equal(R, jirreps._rand_rotation(np.random.default_rng(5)))
    for l in range(3):
        assert np.array_equal(tirreps.sh_np(x, l), jirreps.sh_np(x, l))
        assert np.array_equal(tirreps.wigner_d_np(R, l),
                              jirreps.wigner_d_np(R, l))
    # the torch mirror of sh_np on unit vectors
    u = x / np.linalg.norm(x, axis=-1, keepdims=True)
    for l in range(3):
        assert_allclose(tnequip.sh(torch.from_numpy(u), l).numpy(),
                        tirreps.sh_np(u, l), rtol=1e-12, atol=1e-12)


def close(got, want, what) -> None:
    """|got - want| <= GRAD_REL * max|want| + 1e-6, elementwise."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    bound = GRAD_REL * np.abs(want).max(initial=0.0) + 1e-6
    err = np.abs(got - want).max(initial=0.0)
    assert got.shape == want.shape and err <= bound, (what, err, bound)


def _batch(fields) -> GraphBatch:
    return GraphBatch(**{k: (v if k == "n_graphs" else torch.from_numpy(
        np.asarray(v))) for k, v in fields.items()})


def _params(meta, mod, cfg, seed):
    """The port's params from the script's numpy draws over the JAX
    leaves, which must be the port's own."""
    shapes = mod.param_shapes(cfg)
    got = [[list(p), list(s)] for p, s in leaves(shapes)]
    assert got == meta["leaves"]
    tree = tree_map(lambda s: None, shapes)
    for (path, _), a in zip(leaves(shapes),
                            script.tree_params(leaves(shapes), seed)):
        set_path(tree, path, a)
    return mod.params_from_numpy(cfg, tree, device="cpu")


@pytest.mark.parametrize("model,case", CASES)
def test_forward_loss_grads_match_jax(jax_side, model, case):
    meta, arrays = jax_side
    mod, cfg, cases = MODELS[model]
    params = _params(meta[model], mod, cfg, 30)
    b = _batch(script.graph_case(case, 40 + cases.index(case)))
    assert_allclose(mod.forward(params, cfg, b).numpy(),
                    arrays[f"{model}/{case}/out"], **TOL)
    (loss, m), grads = value_and_grad(mod.loss_fn, params, cfg, b)
    assert_allclose(float(loss), meta[model][case]["loss"], **TOL)
    assert float(m["mse"]) == float(loss)
    for j, (path, g) in enumerate(leaves(grads)):
        close(g, arrays[f"{model}/{case}/grad/{j}"], path)
    if model == "nequip":
        check_forces(tnequip.forces(params, cfg, b), b, arrays,
                     f"{model}/{case}")


def check_forces(f, b, arrays, key) -> None:
    """The port's forces against JAX's float64 ones everywhere, and its
    float32 ones away from self-loop atoms, by ``close``.  At a self-loop's
    atom the JAX model's float32 force carries the rounding of a 1e6-fold
    gradient (the two halves of d rhat / d rel cancel in the atom's sum);
    the port takes that gradient as the exact 0 (``nequip.forward``), so
    there it is no further from JAX's f32 force than JAX's own rounding
    is, plus ``close``'s bound."""
    f = f.numpy()
    want, want64 = arrays[f"{key}/forces"], arrays[f"{key}/forces64"]
    assert np.isfinite(f).all()
    close(f, want64.astype(np.float32), "forces vs float64")
    loop = np.zeros(f.shape[0], bool)
    ok = b.edge_src.numpy() >= 0
    loop[b.edge_src.numpy()[ok & (b.edge_src.numpy() ==
                                  b.edge_dst.numpy())]] = True
    assert loop.sum() == 1
    close(f[~loop], want[~loop], "forces away from the self-loop")
    bound = GRAD_REL * np.abs(want).max() + 1e-6
    noise = np.abs(want[loop] - want64[loop])
    assert (np.abs(f[loop] - want[loop]) <= noise + bound).all()


def test_nequip_invariance_and_force_equivariance():
    """The JAX test on the port's model, its params from the port's
    ``init_params``: energy invariant and forces equivariant under a
    rotation plus a translation."""
    rng = np.random.default_rng(0)
    N, E = 40, 160
    cfg = tnequip.NequIPConfig(n_layers=2, mul=8, n_species=4)
    batch = GraphBatch(
        node_feat=torch.from_numpy(
            rng.integers(0, 4, (N, 1)).astype(np.float32)),
        edge_src=torch.from_numpy(rng.integers(0, N, E).astype(np.int32)),
        edge_dst=torch.from_numpy(rng.integers(0, N, E).astype(np.int32)),
        labels=torch.zeros((1,)), train_mask=torch.ones((1,), dtype=bool),
        positions=torch.from_numpy(rng.normal(size=(N, 3))
                                   .astype(np.float32)),
        graph_ids=torch.zeros((N,), dtype=torch.int32), n_graphs=1)
    params = tnequip.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    e0 = tnequip.forward(params, cfg, batch)
    A = rng.normal(size=(3, 3))
    Q, R = np.linalg.qr(A)
    Q *= np.sign(np.diag(R))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    Qt = torch.from_numpy(Q.T.astype(np.float32))
    batch2 = dataclasses.replace(
        batch, positions=batch.positions @ Qt + torch.tensor([1., 2., 3.]))
    e1 = tnequip.forward(params, cfg, batch2)
    assert abs(float(e0[0] - e1[0])) < 1e-3 * max(1.0, abs(float(e0[0])))
    f0 = tnequip.forces(params, cfg, batch)
    f1 = tnequip.forces(params, cfg, batch2)
    err = float((f1 - f0 @ Qt).abs().max())
    assert err < 6e-3, err


@pytest.mark.parametrize("arch", script.TRAIN_ARCHS)
def test_geometry_and_cell_config_match_jax(jax_side, arch):
    """gnn_geometry and gnn_cell_config for all four cells at both sizes:
    MGN's ``d_in`` is the cell's feature width, NequIP's config is the
    arch's own (it has no ``d_in``)."""
    meta, _ = jax_side
    spec = treg.get(arch)
    for shape_id in script.CELLS:
        for reduced in (False, True):
            want = meta["cells"][f"{arch}/{shape_id}/{int(reduced)}"]
            cell = spec.cell(shape_id)
            geo = tsteps.gnn_geometry(cell, reduced)
            assert list(geo) == want["geometry"]
            cfg = tsteps.gnn_cell_config(
                spec.reduced if reduced else spec.model, cell, reduced)
            got = {f.name: getattr(cfg, f.name)
                   for f in dataclasses.fields(cfg)}
            got["dtype"] = str(got["dtype"]).split(".")[-1]
            assert got == want["cfg"], (shape_id, reduced)
            assert tsteps.gnn_module(cfg) is (tmgn if arch == "meshgraphnet"
                                              else tnequip)


@pytest.mark.parametrize("i,arch", list(enumerate(script.TRAIN_ARCHS)))
def test_train_step_matches_the_jax_cell(jax_side, i, arch):
    meta, arrays = jax_side
    want = meta["train"][arch]
    spec = treg.get(arch)
    cell = spec.cell(script.TRAIN_SHAPE[arch])
    cfg = tsteps.gnn_cell_config(spec.reduced, cell, True)
    mod = tsteps.gnn_module(cfg)
    params = _params(want, mod, cfg, 50 + i)
    b = _batch(script.train_batch(arch, tsteps.gnn_geometry(cell, True),
                                  60 + i))
    ocfg = topt.AdamWConfig()
    state = topt.init_opt_state(params, ocfg)
    params, state, m = tsteps.gnn_train_step(params, state, b, cfg, ocfg)
    assert_allclose(float(m["loss"]), want["loss"], rtol=1e-5)
    assert_allclose(float(m["gnorm"]), want["gnorm"], rtol=1e-4)
    assert int(state.step) == 1
    for j, (path, p) in enumerate(leaves(params)):
        d = np.abs(p.numpy() - arrays[f"train/{arch}/params/{j}"])
        assert d.max() <= 2 * ocfg.lr, path
        assert (d > 1e-6).sum() <= max(1, d.size // 10_000), path


@pytest.mark.parametrize("arch", script.BATCH_ARCHS)
def test_trainer_batches_equal_jax(jax_side, arch):
    """run_training's GNN batches: JAX ``_batch_source``'s draws, in its
    order, bit for bit."""
    _, arrays = jax_side
    spec = treg.get(arch)
    cfg = tsteps.gnn_cell_config(spec.reduced, spec.shapes[0], True)
    src = ttrain._gnn_batches(cfg, tsteps.gnn_geometry(spec.shapes[0], True),
                              0, torch.device("cpu"))
    for d in range(script.BATCH_DRAWS):
        (b,) = next(src)
        for f in dataclasses.fields(b):
            v, key = getattr(b, f.name), f"batch/{arch}/{d}/{f.name}"
            if f.name == "n_graphs":
                continue
            assert (v is None) == (key not in arrays), key
            if v is not None:
                assert v.numpy().dtype == arrays[key].dtype, key
                assert np.array_equal(v.numpy(), arrays[key]), key


@pytest.mark.parametrize("arch", script.TRAIN_ARCHS)
def test_run_training_takes_the_new_archs(arch, capsys):
    out = ttrain.run_training(arch, steps=3, log_every=1, device="cpu")
    assert set(out) == {"loss", "gnorm"}
    assert all(np.isfinite(v) for v in out.values())
    assert capsys.readouterr().out.count("loss=") == 3
