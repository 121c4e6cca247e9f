"""Record the JAX package's dist substrate and cells for the port's tests
(``tests/test_torch_dist.py``, ``tests/test_torch_dryrun.py``).

    PYTHONPATH=src python tests/fixtures/torch_dist/make_fixture.py

Runs, on 8 forced host devices (set before JAX starts), the cases of
``tests/torch_dist_script.py``:

* ``collective_matmul_ag`` under ``shard_map`` and ``tp_matmul_ag`` under
  the mesh, on the (2, 4) and (4, 2) ("data", "model") meshes;
* ``pipeline_apply`` over the (4, 2) ("pod", "model") mesh, the last
  stage's output;
* the tiny LM's ``forward`` logits under ``{"seq": "model"}`` on both
  meshes, with and without ``use_collective_matmul``;
* for every cell not marked skip, at ``reduced=True``: each argument's
  path, shape, dtype and resolved spec on the (2, 4) mesh, the cell's
  ``model_flops``, and ``analyze_hlo(...).flops`` of the cell compiled on a
  (1, 1) mesh.

Writes ``dist.npz`` and ``dist.json`` beside this script, in a few
minutes (one XLA compile a cell).
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
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
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_dist_script as script  # noqa: E402
from repro.configs import registry  # noqa: E402
from repro.dist import compat  # noqa: E402
from repro.dist.overlap import collective_matmul_ag, tp_matmul_ag  # noqa: E402
from repro.dist.pipeline import pipeline_apply  # noqa: E402
from repro.dist.sharding import rules_context  # noqa: E402
from repro.launch.hloanalysis import analyze_hlo  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.launch.steps import build_cell  # noqa: E402
from repro.models import transformer as T  # noqa: E402


def script_sha() -> str:
    with open(os.path.join(TESTS, "torch_dist_script.py"), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _key(k) -> str:
    for attr in ("idx", "key", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _spec(s):
    return None if s is None else [list(e) if isinstance(e, tuple) else e
                                   for e in tuple(s.spec)]


def cell_args(cell) -> list:
    """Each argument leaf's path ("0/blocks/0/wq"), shape, dtype, spec."""
    leaves = jax.tree_util.tree_flatten_with_path(cell.args)[0]
    if cell.in_shardings is None:
        specs = [None] * len(leaves)
    else:
        specs = jax.tree.leaves(cell.in_shardings,
                                is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(specs) == len(leaves), (cell.arch_id, cell.shape_id)
    return [{"path": "/".join(_key(k) for k in path),
             "shape": list(a.shape), "dtype": str(a.dtype), "spec": _spec(s)}
            for (path, a), s in zip(leaves, specs)]


def cell_flops(arch, shape) -> float:
    mesh = make_test_mesh((1, 1), ("data", "model"))
    c = build_cell(arch, shape, mesh, reduced=True)
    fn = (jax.jit(c.fn, in_shardings=c.in_shardings,
                  out_shardings=c.out_shardings,
                  donate_argnums=c.donate_argnums)
          if c.in_shardings is not None else c.fn)
    with mesh:
        compiled = fn.lower(*c.args).compile()
    return analyze_hlo(compiled.as_text(), 1).flops


def lm_params(cfg):
    shapes, _ = T.param_shapes(cfg)
    flat = jax.tree_util.tree_flatten_with_path(
        shapes, is_leaf=lambda x: isinstance(x, tuple))[0]
    tdef = jax.tree.structure(shapes, is_leaf=lambda x: isinstance(x, tuple))
    return jax.tree.unflatten(tdef, [
        jnp.asarray(script.lm_param("/".join(_key(k) for k in p), s))
        for p, s in flat])


def main() -> None:
    arrays, meta = {}, {"script_sha256": script_sha(), "cells": {}}
    x, w = script.cm_inputs()
    xt, wt = script.tp_inputs()
    for shp in script.MESHES:
        mesh = make_test_mesh(shp, ("data", "model"))
        tag = f"{shp[0]}x{shp[1]}"
        arrays[f"cm_{tag}"] = np.asarray(jax.jit(compat.shard_map(
            lambda xs, wl: collective_matmul_ag(xs, wl, "model"), mesh=mesh,
            in_specs=(P("model", None), P(None, "model")),
            out_specs=P(None, "model")))(x, w))
        with mesh:
            arrays[f"tp_{tag}"] = np.asarray(
                jax.jit(lambda a, b: tp_matmul_ag(a, b))(xt, wt))

    mesh = make_test_mesh(script.PIPE["mesh"], ("pod", "model"))
    xin, ws = script.pipe_inputs()
    M = script.PIPE["M"]

    def pf(x, w):
        o = pipeline_apply(lambda w_, h: jnp.tanh(h @ w_), w[0], x,
                           axis="pod", n_stages=4, n_microbatches=M)
        return jax.lax.psum(
            jnp.where(jax.lax.axis_index("pod") == 3, o, 0.), "pod")

    arrays["pipe"] = np.asarray(jax.jit(compat.shard_map(
        pf, mesh=mesh, in_specs=(P(), P("pod")), out_specs=P(),
        check_vma=False))(xin, ws))

    cfg = T.LMConfig(**script.LM, dtype=jnp.float32)
    params = lm_params(cfg)
    tokens = jnp.asarray(script.lm_tokens())
    for shp in script.MESHES:
        mesh = make_test_mesh(shp, ("data", "model"))
        tag = f"{shp[0]}x{shp[1]}"
        for cm in (False, True):
            c = dataclasses.replace(cfg, use_collective_matmul=cm)
            with mesh, rules_context(script.LM_RULES):
                out = jax.jit(lambda p, t, c=c: T.forward(p, c, t)[0])(
                    params, tokens)
            arrays[f"lm_{tag}_{'cm' if cm else 'plain'}"] = np.asarray(out)

    mesh = make_test_mesh(script.CELL_MESH, ("data", "model"))
    for arch, shape in registry.all_cells():
        if registry.get(arch).cell(shape).skip:
            continue
        c = build_cell(arch, shape, mesh, reduced=True)
        meta["cells"][f"{arch}/{shape}"] = {
            "args": cell_args(c), "model_flops": float(c.model_flops),
            "flops": float(cell_flops(arch, shape))}
        print(arch, shape, meta["cells"][f"{arch}/{shape}"]["flops"],
              flush=True)

    np.savez_compressed(os.path.join(HERE, "dist.npz"), **arrays)
    with open(os.path.join(HERE, "dist.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
