"""Record the JAX package's MoE layer, LM zoo and mesh functions for the
port's tests (``tests/test_torch_moe.py``, ``tests/test_torch_lm_zoo.py``).

    PYTHONPATH=src python tests/fixtures/torch_lm_zoo/make_fixture.py

Runs, on 8 forced host devices (set before JAX starts), the cases of
``tests/torch_lm_zoo_script.py``:

* ``repro.models.moe.moe_ffn`` on each of ``MOE_CASES``: the output, the
  aux loss and drop fraction, and the routing (``eidx``) and dispatch
  (each sorted pair's slot, ``E * C`` when dropped) as the module computes
  them;
* ``forward``, ``prefill``, ``DECODE_STEPS`` decode steps and
  ``value_and_grad(loss_fn)`` of the REDUCED config of each of
  ``LM_ARCHS`` (the gradients as ``N_PROJ`` projections a leaf);
* ``a1_ship_lookup`` over a (2, 4) mesh and ``ef_compress_grads`` under
  ``shard_map`` with a scale a shard.

Writes ``lm_zoo.npz`` and ``lm_zoo.json`` (the SHA-256 of the case
script, the leaves' paths and shapes, the scalars) beside this script, in
about a minute.  This CPU's XLA has no dot of bfloat16 operands with a
float32 result, which ``moe_ffn`` asks for in its bf16 cases: there this
script casts such einsums' operands to float32 first, which gives the same
(exact) products, summed in float32.
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import hashlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, TESTS)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_lm_zoo_script as script  # noqa: E402
from repro.configs import registry  # noqa: E402
from repro.dist import compat  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import moe  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.models.embedding import a1_ship_lookup  # noqa: E402
from repro.optim.compression import ef_compress_grads  # noqa: E402


def script_sha() -> str:
    with open(os.path.join(TESTS, "torch_lm_zoo_script.py"), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


_einsum = jnp.einsum


def _einsum_f32(spec, *ops, preferred_element_type=None, **kw):
    if preferred_element_type == jnp.float32:
        ops = [o.astype(jnp.float32) for o in ops]
    return _einsum(spec, *ops, preferred_element_type=preferred_element_type,
                   **kw)


def _dispatch(x, router_w, top_k, cf, groups):
    """eidx and the sorted pairs' slots, by moe.py's own lines (routing,
    sort, rank, capacity), per group; one group for the global path."""
    T_, D = x.shape
    E = router_w.shape[-1]
    G = groups if groups and groups > 1 and T_ % groups == 0 else 1
    Tg = T_ // G
    C = moe.expert_capacity(Tg, E, top_k, cf)
    logits = x.reshape(G, Tg, D).astype(jnp.float32) @ \
        router_w.astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, eidx = jax.lax.top_k(probs, top_k)
    flat_e = eidx.reshape(G, Tg * top_k).astype(jnp.int32)
    flat_t = jnp.broadcast_to(
        (jnp.arange(Tg * top_k, dtype=jnp.int32) // top_k)[None],
        (G, Tg * top_k))
    e_s, _ = jax.lax.sort((flat_e, flat_t), num_keys=2, dimension=1)
    run_start = jax.vmap(
        lambda es: jnp.searchsorted(es, es, side="left"))(e_s)
    rank = jnp.arange(Tg * top_k, dtype=jnp.int32)[None] - run_start
    slot = jnp.where(rank < C, e_s * C + rank, E * C)
    return eidx.reshape(T_, top_k), slot


def moe_cases(arrays: dict, meta: dict) -> None:
    for name, k, g, dt in script.MOE_CASES:
        inp = script.moe_inputs(name)
        args = [jnp.asarray(inp[n]).astype(dt)
                for n in ("x", "router_w", "we1", "we3", "we2")]
        kw = dict(top_k=k, capacity_factor=script.MOE["capacity_factor"],
                  groups=g)
        jnp.einsum = _einsum_f32
        try:
            y, aux = moe.moe_ffn(*args, **kw)
        finally:
            jnp.einsum = _einsum
        eidx, slot = _dispatch(args[0], args[1], k,
                               script.MOE["capacity_factor"], g)
        drop = float(aux["drop_frac"])
        assert drop > 0, (name, "no pair dropped")
        kept = np.asarray(slot) != script.MOE["E"] * _cap(k, g)
        assert abs(drop - (1.0 - kept.mean())) < 1e-6, name
        arrays[f"moe/{name}/y"] = np.asarray(y.astype(jnp.float32))
        arrays[f"moe/{name}/eidx"] = np.asarray(eidx)
        arrays[f"moe/{name}/slot"] = np.asarray(slot)
        meta["moe"][name] = dict(aux_loss=float(aux["aux_loss"]),
                                 drop_frac=drop, capacity=_cap(k, g))


def _cap(k, g):
    T_, E = script.MOE["T"], script.MOE["E"]
    Tg = T_ // g if g > 1 else T_
    return moe.expert_capacity(Tg, E, k, script.MOE["capacity_factor"])


def _leaves(cfg):
    shp, _ = T.param_shapes(cfg)
    flat, tdef = jax.tree_util.tree_flatten_with_path(
        shp, is_leaf=lambda x: isinstance(x, tuple)
        and all(isinstance(i, int) for i in x))
    paths = [tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
             for path, _ in flat]
    return list(zip(paths, [s for _, s in flat])), tdef


def lm_cases(arrays: dict, meta: dict) -> None:
    for i, arch in enumerate(script.LM_ARCHS):
        cfg = registry.get(arch).reduced
        leaves, tdef = _leaves(cfg)
        params = jax.tree_util.tree_unflatten(
            tdef, [jnp.asarray(a) for a in script.lm_params(leaves, 10 + i)])
        toks, tgt = script.lm_tokens(cfg.vocab, 20 + i)
        logits, aux = jax.jit(lambda p, t: T.forward(p, cfg, t))(params, toks)
        last, _ = jax.jit(lambda p, t: T.prefill(p, cfg, t))(params, toks)
        cache = T.init_kv_cache(cfg, script.LM_B, script.LM_S)
        step = jax.jit(lambda p, t, c, pos: T.decode_step(p, cfg, t, c, pos))
        dec = []
        for t in range(script.DECODE_STEPS):
            lg, cache = step(params, toks[:, t:t + 1], cache, jnp.int32(t))
            dec.append(np.asarray(lg))
        (loss, m), grads = jax.jit(jax.value_and_grad(
            lambda p: T.loss_fn(p, cfg, toks, tgt), has_aux=True))(params)
        gl = jax.tree_util.tree_leaves(grads)
        proj = np.stack([
            script.projections(s, 1000 + j) @ np.asarray(g, np.float64)
            .reshape(-1) for j, ((_, s), g) in enumerate(zip(leaves, gl))])
        arrays[f"lm/{arch}/logits"] = np.asarray(logits)
        arrays[f"lm/{arch}/prefill"] = np.asarray(last)
        arrays[f"lm/{arch}/decode"] = np.stack(dec)
        arrays[f"lm/{arch}/grad_proj"] = proj
        meta["lm"][arch] = dict(
            leaves=[[list(p), list(s)] for p, s in leaves],
            aux=float(aux), loss=float(loss), nll=float(m["nll"]),
            loss_aux=float(m["aux"]))


def mesh_cases(arrays: dict) -> None:
    mesh = make_test_mesh(script.SHIP["mesh"], ("data", "model"))
    table, ids = script.ship_inputs()
    out = a1_ship_lookup(jnp.asarray(table), jnp.asarray(ids), mesh)
    arrays["ship/out"] = np.stack([np.asarray(s.data)
                                   for s in out.addressable_shards])

    g, e = script.ef_inputs()
    axes = ("data", "model")
    cast = lambda tr: {"a": tr["a"], "b": tr["b"],  # noqa: E731
                       "c": tr["c"].astype(jnp.bfloat16)}

    def body(gs, es):
        gs = jax.tree.map(lambda t: t[0], gs)
        es = jax.tree.map(lambda t: t[0], es)
        dq, ne = ef_compress_grads(gs, es, axis_name=axes)
        return (jax.tree.map(lambda t: t[None], dq),
                jax.tree.map(lambda t: t[None], ne))

    fn = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=(P(axes), P(axes)),
                                  out_specs=(P(axes), P(axes)),
                                  check_vma=False))
    gj = cast(jax.tree.map(jnp.asarray, g))
    ej = jax.tree.map(jnp.asarray, e)
    for r in range(script.EF_ROUNDS):
        dq, ej = fn(gj, ej)
        for name, t in (("dq", dq), ("err", ej)):
            arrays[f"ef/{r}/{name}/a"] = np.asarray(t["a"])
            arrays[f"ef/{r}/{name}/b"] = np.asarray(t["b"][0])
            arrays[f"ef/{r}/{name}/c"] = np.asarray(
                t["c"].astype(jnp.float32))


def main() -> None:
    assert jax.device_count() == 8
    arrays, meta = {}, {"moe": {}, "lm": {}}
    moe_cases(arrays, meta)
    lm_cases(arrays, meta)
    mesh_cases(arrays)
    meta["script_sha256"] = script_sha()
    meta["archs"] = registry.all_archs()
    meta["cells"] = [list(c) for c in registry.all_cells()]
    np.savez_compressed(os.path.join(HERE, "lm_zoo.npz"), **arrays)
    with open(os.path.join(HERE, "lm_zoo.json"), "w") as f:
        json.dump(meta, f, indent=0, sort_keys=True)


if __name__ == "__main__":
    main()
