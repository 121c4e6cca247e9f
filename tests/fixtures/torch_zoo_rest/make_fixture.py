"""Record the JAX package's MeshGraphNet, NequIP, fanout sampler and GNN
train cells for the port's tests (``tests/test_torch_mgn_nequip.py``,
``tests/test_torch_sampler.py``, ``tests/test_torch_ckpt.py``).

    PYTHONPATH=src python tests/fixtures/torch_zoo_rest/make_fixture.py

Runs the cases of ``tests/torch_zoo_rest_script.py``:

* ``meshgraphnet`` / ``nequip`` ``forward``, ``loss_fn`` and its gradient
  (every leaf) at the script's small configs, and NequIP's ``forces`` (in
  float32, and in float64 on the same inputs);
* ``launch/steps.py``: each cell's geometry and config (both archs, all
  four cells, FULL and REDUCED), one jitted train cell step of each arch
  at a reduced cell, and ``launch/train.py::_batch_source``'s first
  batches for three archs;
* ``data/sampler.py``: ``csr_from_coo``, the per-hop draws (the key
  split and ``randint`` of ``fanout_sample``, outside ``jit``),
  ``fanout_sample`` and ``build_sampled_batch``; ``fanout_sample_db``
  over a film KG that ``build_film_kg`` writes through the JAX write path.

Writes ``zoo_rest.npz`` and ``zoo_rest.json`` (the SHA-256 of the case
script, leaf paths and shapes, scalars) beside this script, in about a
minute.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, TESTS)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_zoo_rest_script as script  # noqa: E402
from repro.configs import registry  # noqa: E402
from repro.core.addressing import StoreConfig  # noqa: E402
from repro.data import sampler  # noqa: E402
from repro.data.kg import build_film_kg  # noqa: E402
from repro.launch import steps  # noqa: E402
from repro.launch import train  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models.gnn import meshgraphnet as mgn  # noqa: E402
from repro.models.gnn import nequip  # noqa: E402
from repro.models.gnn.common import GraphBatch  # noqa: E402
from repro.optim.optimizers import AdamWConfig, init_opt_state  # noqa: E402


def script_sha() -> str:
    with open(os.path.join(TESTS, "torch_zoo_rest_script.py"), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def leaves_of(shape_tree):
    """[(path, shape)] of a tree of ShapeDtypeStructs, flatten order."""
    flat, tdef = jax.tree_util.tree_flatten_with_path(shape_tree)
    paths = [tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
             for path, _ in flat]
    return list(zip(paths, [tuple(s.shape) for _, s in flat])), tdef


def params_of(shape_tree, seed):
    leaves, tdef = leaves_of(shape_tree)
    arrays = script.tree_params(leaves, seed)
    return leaves, jax.tree_util.tree_unflatten(
        tdef, [jnp.asarray(a) for a in arrays])


def batch_of(fields: dict) -> GraphBatch:
    return GraphBatch(**{k: (v if k == "n_graphs" else jnp.asarray(v))
                         for k, v in fields.items()})


def cfg_fields(cfg) -> dict:
    return {f.name: (np.dtype(getattr(cfg, f.name)).name
                     if f.name == "dtype" else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


def model_cases(arrays: dict, meta: dict) -> None:
    for name, mod, cfg, cases in (
            ("mgn", mgn, mgn.MGNConfig(**script.MGN_CFG), script.MGN_CASES),
            ("nequip", nequip, nequip.NequIPConfig(**script.NEQUIP_CFG),
             script.NEQUIP_CASES)):
        leaves, params = params_of(mod.param_shape_dtypes(cfg), 30)
        meta[name] = {"leaves": [[list(p), list(s)] for p, s in leaves]}
        fwd = jax.jit(lambda p, b, mod=mod, cfg=cfg: mod.forward(p, cfg, b))
        vg = jax.jit(jax.value_and_grad(
            lambda p, b, mod=mod, cfg=cfg: mod.loss_fn(p, cfg, b),
            has_aux=True))
        for i, case in enumerate(cases):
            b = batch_of(script.graph_case(case, 40 + i))
            (loss, _), grads = vg(params, b)
            arrays[f"{name}/{case}/out"] = np.asarray(fwd(params, b))
            for j, g in enumerate(jax.tree.leaves(grads)):
                arrays[f"{name}/{case}/grad/{j}"] = np.asarray(g)
            meta[name][case] = {"loss": float(loss)}
            if mod is nequip:
                f = jax.jit(lambda p, b: nequip.forces(p, cfg, b))
                arrays[f"{name}/{case}/forces"] = np.asarray(f(params, b))


def cell_cases(arrays: dict, meta: dict) -> None:
    mesh = make_test_mesh((1, 1), ("data", "model"))
    meta["cells"] = {}
    for arch in script.TRAIN_ARCHS:
        spec = registry.get(arch)
        for shape_id in script.CELLS:
            for reduced in (False, True):
                cell = steps.build_cell(arch, shape_id, mesh,
                                        reduced=reduced)
                b = cell.args[2]
                meta["cells"][f"{arch}/{shape_id}/{int(reduced)}"] = dict(
                    geometry=list(steps._gnn_geometry(spec.cell(shape_id),
                                                      reduced)),
                    cfg=cfg_fields(cell.model_cfg),
                    batch={f.name: (None if getattr(b, f.name) is None
                                    else [list(getattr(b, f.name).shape),
                                          getattr(b, f.name).dtype.name])
                           for f in dataclasses.fields(b)
                           if f.name != "n_graphs"},
                    n_graphs=b.n_graphs)
    meta["train"] = {}
    for i, arch in enumerate(script.TRAIN_ARCHS):
        spec = registry.get(arch)
        shape_id = script.TRAIN_SHAPE[arch]
        cell = steps.build_cell(arch, shape_id, mesh, reduced=True)
        leaves, params = params_of(cell.args[0], 50 + i)
        geo = steps._gnn_geometry(spec.cell(shape_id), True)
        b = batch_of(script.train_batch(arch, geo, 60 + i))
        state = init_opt_state(params, AdamWConfig())
        p2, _, m = jax.jit(cell.fn)(params, state, b)
        for j, leaf in enumerate(jax.tree.leaves(p2)):
            arrays[f"train/{arch}/params/{j}"] = np.asarray(leaf)
        meta["train"][arch] = dict(
            leaves=[[list(p), list(s)] for p, s in leaves],
            loss=float(m["loss"]), gnorm=float(m["gnorm"]))
    for arch in script.BATCH_ARCHS:
        spec = registry.get(arch)
        cell = steps.build_cell(arch, spec.shapes[0].shape_id, mesh,
                                reduced=True)
        src = train._batch_source(spec, cell, cell.model_cfg, 0)
        for d in range(script.BATCH_DRAWS):
            (b,) = next(src)
            for f in dataclasses.fields(b):
                v = getattr(b, f.name)
                if f.name != "n_graphs" and v is not None:
                    arrays[f"batch/{arch}/{d}/{f.name}"] = np.asarray(v)


def sampler_cases(arrays: dict, meta: dict) -> None:
    s = script.SAMPLE
    src, dst = script.sample_graph()
    indptr, indices = sampler.csr_from_coo(s["n"], src, dst)
    seeds = jnp.asarray(np.asarray(script.SAMPLE_SEEDS, np.int32))
    key = jax.random.key(s["key"])
    k, n = key, len(script.SAMPLE_SEEDS)
    for h, f in enumerate(s["fanouts"]):         # fanout_sample's draws
        k, sub = jax.random.split(k)
        arrays[f"sample/draws/{h}"] = np.asarray(
            jax.random.randint(sub, (n, f), 0, 2**31 - 1))
        n *= f
    gids, es, ed = sampler.fanout_sample(indptr, indices, seeds, key,
                                         fanouts=s["fanouts"])
    arrays["sample/indptr"] = np.asarray(indptr)
    arrays["sample/indices"] = np.asarray(indices)
    arrays["sample/gids"] = np.asarray(gids)
    arrays["sample/edge_src"] = np.asarray(es)
    arrays["sample/edge_dst"] = np.asarray(ed)
    feats, labels = script.sample_data()
    b = sampler.build_sampled_batch(jnp.asarray(feats), jnp.asarray(labels),
                                    indptr, indices, seeds, key,
                                    fanouts=s["fanouts"])
    for f in ("node_feat", "edge_src", "edge_dst", "labels", "train_mask"):
        arrays[f"sample/batch/{f}"] = np.asarray(getattr(b, f))

    kg = build_film_kg(**script.DB_KG, cfg=StoreConfig(**script.DB_CFG))
    for i, (seeds_db, fanouts, etype, seed) in enumerate(script.DB_CASES):
        out = sampler.fanout_sample_db(kg.db, seeds_db, fanouts=fanouts,
                                       etype=etype, seed=seed)
        for name, a in zip(("gids", "edge_src", "edge_dst"), out):
            arrays[f"sample_db/{i}/{name}"] = a
    meta["sample_db_clock"] = int(kg.db.clock)


def forces64_cases(arrays: dict) -> None:
    """NequIP's forces in float64 on the same (float32) inputs: the f32
    forces of an atom with a self-loop carry the rounding of a 1e6-fold
    gradient of rhat that cancels in its sum.  Turns on 64-bit mode, so it
    runs last."""
    jax.config.update("jax_enable_x64", True)
    cfg = nequip.NequIPConfig(**dict(script.NEQUIP_CFG, dtype=jnp.float64))
    leaves, tdef = leaves_of(nequip.param_shape_dtypes(cfg))
    params = jax.tree_util.tree_unflatten(tdef, [
        jnp.asarray(a, jnp.float64) for a in script.tree_params(leaves, 30)])
    for i, case in enumerate(script.NEQUIP_CASES):
        fields = script.graph_case(case, 40 + i)
        fields["positions"] = fields["positions"].astype(np.float64)
        b = batch_of(fields)
        arrays[f"nequip/{case}/forces64"] = np.asarray(
            nequip.forces(params, cfg, b))


def main() -> None:
    arrays, meta = {}, {}
    model_cases(arrays, meta)
    cell_cases(arrays, meta)
    sampler_cases(arrays, meta)
    forces64_cases(arrays)
    meta["script_sha256"] = script_sha()
    np.savez_compressed(os.path.join(HERE, "zoo_rest.npz"), **arrays)
    with open(os.path.join(HERE, "zoo_rest.json"), "w") as f:
        json.dump(meta, f, indent=0, sort_keys=True)


if __name__ == "__main__":
    main()
