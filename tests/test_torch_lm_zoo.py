"""PyTorch port, the LM zoo and the mesh functions: the registry's lookup,
the REDUCED configs of qwen3-moe-235b, llama4-maverick, qwen1.5-32b and
llama3-405b (``forward``, ``prefill``, decode steps, ``value_and_grad``),
``a1_ship_lookup`` and ``ef_compress_grads(axis_name=)`` over a shard mesh,
against the JAX package's outputs on the committed fixture
(``tests/fixtures/torch_lm_zoo``, made by its ``make_fixture.py`` from
``tests/torch_lm_zoo_script.py``).  No JAX program is compiled here.

Tolerances: logits rtol 1e-5 (atol 1e-5), the loss terms rtol 1e-5, each
gradient leaf's random projections within 1e-4 of the largest plus 1e-6;
``a1_ship_lookup`` exactly, ``ef_compress_grads`` as its test states.
"""
import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import torch_lm_zoo_script as script
from repro.configs import registry as jreg
from repro_torch.configs import registry as treg
from repro_torch.dist.mesh import make_mesh
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as T
from repro_torch.models.embedding import a1_ship_lookup, gspmd_lookup
from repro_torch.optim import compression as tcomp

from test_torch_store_index_edges import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_lm_zoo"
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
# the JAX registry's archs whose models are not ported: none are left
REMAINDER = set()


@pytest.fixture(scope="module")
def jax_side():
    meta = json.loads((FIXTURE / "lm_zoo.json").read_text())
    with np.load(FIXTURE / "lm_zoo.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return meta, arrays


def test_fixture_is_from_this_script(jax_side):
    sha = hashlib.sha256(Path(script.__file__).read_bytes()).hexdigest()
    assert jax_side[0]["script_sha256"] == sha, (
        "tests/torch_lm_zoo_script.py changed: regenerate the fixture with "
        "PYTHONPATH=src python tests/fixtures/torch_lm_zoo/make_fixture.py")


def test_registry_lists_match_jax(jax_side):
    meta, _ = jax_side
    archs = set(treg.all_archs())
    assert archs == set(meta["archs"]) - REMAINDER
    assert REMAINDER <= set(meta["archs"])
    assert treg.all_archs() == sorted(archs)
    want = [tuple(c) for c in meta["cells"] if c[0] not in REMAINDER]
    assert treg.all_cells() == want
    for arch in ("meshgraphnet", "nequip"):     # the last two ported
        assert treg.get(arch).arch_id == arch
        assert treg.get(arch).family == "gnn"
    with pytest.raises(KeyError):
        treg.get("no-such-arch")


@pytest.mark.parametrize("arch", sorted(set(jreg.all_archs()) - REMAINDER))
def test_spec_fields_match_jax(arch):
    """Every config field (dtypes by name), the cells with their geometry
    and skip reasons, the family and source, for FULL and REDUCED."""
    js, ts = jreg.get(arch), treg.get(arch)
    assert (ts.arch_id, ts.family, ts.source) == \
        (js.arch_id, js.family, js.source)
    assert [dataclasses.astuple(c) for c in ts.shapes] == \
        [dataclasses.astuple(c) for c in js.shapes]
    for name in ("model", "reduced"):
        jc, tc = getattr(js, name), getattr(ts, name)
        assert type(jc).__name__ == type(tc).__name__
        for f in dataclasses.fields(jc):
            a, b = getattr(tc, f.name), getattr(jc, f.name)
            if f.name == "dtype":
                assert str(a).split(".")[-1] == np.dtype(b).name, arch
            else:
                assert a == b, (arch, name, f.name)
        if js.family == "lm":
            assert tc.n_params() == jc.n_params()
            assert tc.n_active_params() == jc.n_active_params()


def _model(meta, i, arch):
    cfg = treg.get(arch).reduced
    leaves = list(T.leaves(T.param_shapes(cfg)))
    assert [[list(p), list(s)] for p, s in leaves] == meta["lm"][arch]["leaves"]
    tree = {"blocks": [{} for _ in cfg.block_pattern]}
    for (path, _), a in zip(leaves, script.lm_params(leaves, 10 + i)):
        T._set(tree, path, a)
    toks, tgt = script.lm_tokens(cfg.vocab, 20 + i)
    return (cfg, T.params_from_numpy(cfg, tree, device="cpu"),
            torch.from_numpy(toks), torch.from_numpy(tgt))


ARCHS = list(enumerate(script.LM_ARCHS))


@pytest.mark.parametrize("i,arch", ARCHS, ids=script.LM_ARCHS)
def test_forward_prefill_decode_match_jax(jax_side, i, arch):
    meta, arrays = jax_side
    cfg, params, toks, _ = _model(meta, i, arch)
    logits, aux = T.forward(params, cfg, toks)
    assert_allclose(logits.numpy(), arrays[f"lm/{arch}/logits"], **LOGIT_TOL)
    assert_allclose(float(aux), meta["lm"][arch]["aux"], rtol=1e-5)
    assert (float(aux) > 0) == ("moe" in cfg.block_pattern)
    last, aux_p = T.prefill(params, cfg, toks)
    assert_allclose(last.numpy(), arrays[f"lm/{arch}/prefill"], **LOGIT_TOL)
    assert_allclose(float(aux_p), float(aux), rtol=1e-6)
    cache = T.init_kv_cache(cfg, script.LM_B, script.LM_S, device="cpu")
    for t in range(script.DECODE_STEPS):
        lg, cache = T.decode_step(params, cfg, toks[:, t:t + 1], cache, t)
        assert_allclose(lg.numpy(), arrays[f"lm/{arch}/decode"][t],
                        **LOGIT_TOL)


@pytest.mark.parametrize("i,arch", ARCHS, ids=script.LM_ARCHS)
def test_loss_and_gradients_match_jax(jax_side, i, arch):
    meta, arrays = jax_side
    cfg, params, toks, tgt = _model(meta, i, arch)
    (loss, m), grads = T.value_and_grad(params, cfg, toks, tgt)
    want = meta["lm"][arch]
    assert_allclose(float(loss), want["loss"], rtol=1e-5)
    assert_allclose(float(m["nll"]), want["nll"], rtol=1e-5)
    assert_allclose(float(m["aux"]), want["loss_aux"], rtol=1e-5, atol=1e-7)
    proj = arrays[f"lm/{arch}/grad_proj"]
    gl = list(T.leaves(grads))
    assert len(gl) == len(proj)
    for j, (path, g) in enumerate(gl):
        got = script.projections(g.shape, 1000 + j) @ \
            g.double().reshape(-1).numpy()
        err = np.abs(got - proj[j]).max()
        assert err <= 1e-4 * np.abs(proj[j]).max() + 1e-6, (arch, path, err)


@pytest.mark.parametrize("arch", script.LM_ARCHS)
def test_run_training_takes_the_new_archs(arch, capsys):
    out = ttrain.run_training(arch, steps=1, log_every=1, device="cpu")
    assert set(out) == {"loss", "gnorm"}
    assert all(np.isfinite(v) for v in out.values())
    assert capsys.readouterr().out.count("loss=") == 1


def test_a1_ship_lookup_matches_jax_and_gspmd(jax_side):
    """Over a mesh of 8 shards (JAX's (2, 4)), every shard's rows equal
    JAX's replicated output and the plain gather, padding ids zero."""
    _, arrays = jax_side
    table, ids = script.ship_inputs()
    tt, ti = torch.from_numpy(table), torch.from_numpy(ids)
    mesh = make_mesh(int(np.prod(script.SHIP["mesh"])), device="cpu")
    got = a1_ship_lookup(tt, ti, mesh)
    want = arrays["ship/out"]
    assert len(got) == len(want) == mesh.size
    plain = gspmd_lookup(tt, ti)
    for s in range(mesh.size):
        assert np.array_equal(got[s].numpy(), want[s])
        assert torch.equal(got[s], plain)
    assert not bool(got[0][ids < 0].any())
    ids2 = ti.reshape(2, 5)            # ids of any shape
    assert torch.equal(a1_ship_lookup(tt, ids2, mesh)[3],
                       gspmd_lookup(tt, ids2))
    with pytest.raises(ValueError):
        a1_ship_lookup(tt[:63], ti, mesh)


def test_ef_compress_grads_over_a_mesh_matches_jax(jax_side):
    """Two rounds over 8 shards with a scale each, the second from JAX's
    carried errors.  Every shard's dequantized gradient is the psum of the
    int8 payloads times its own scale, over 8, and its new error gf - q *
    scale: equal to that formula computed here bit for bit, and to JAX's
    shard_map within one float32 ulp (relative) and one ulp of the leaf's
    largest gf: XLA's jit takes max / 127 as a multiply by 1/127, one ulp
    off the quotient at some scales, and may fuse q * scale and the
    difference into one rounding."""
    _, arrays = jax_side
    g, e = script.ef_inputs()
    S = script.EF_SHARDS
    ulp = 2.0 ** -23

    def shard(tree, s, bf16_c):
        c = torch.from_numpy(np.ascontiguousarray(tree["c"][s]))
        return {"a": torch.from_numpy(np.ascontiguousarray(tree["a"][s])),
                "b": [torch.from_numpy(np.ascontiguousarray(tree["b"][0][s]))],
                "c": c.to(torch.bfloat16) if bf16_c else c}
    gs = [shard(g, s, True) for s in range(S)]
    for r in range(script.EF_ROUNDS):
        if r:
            e = {k: arrays[f"ef/{r - 1}/err/{k}"] for k in "ac"}
            e["b"] = [arrays[f"ef/{r - 1}/err/b"]]
        es = [shard(e, s, False) for s in range(S)]
        dq, new = tcomp.ef_compress_grads(gs, es,
                                          axis_name=("data", "model"))
        assert len(dq) == len(new) == S
        for leaf in "abc":
            def pick(t):
                return t[leaf][0] if leaf == "b" else t[leaf]
            gfs = [pick(gs[s]).float() + pick(es[s]) for s in range(S)]
            qs = [tcomp.compress_int8(gf) for gf in gfs]
            qsum = sum(q.int() for q, _ in qs)
            for s in range(S):
                got_dq, got_err = pick(dq[s]), pick(new[s])
                assert got_dq.dtype == pick(gs[s]).dtype
                q, scale = qs[s]
                assert torch.equal(got_dq, ((qsum.float() * scale) / S)
                                   .to(got_dq.dtype)), (r, s, leaf)
                assert torch.equal(got_err, gfs[s] - q.float() * scale)
                want = arrays[f"ef/{r}/dq/{leaf}"][s]
                assert np.abs(got_dq.float().numpy() - want).max() <= \
                    ulp * np.abs(want).max(), (r, s, leaf)
                gmax = float(gfs[s].abs().max())
                assert np.abs(got_err.numpy() - arrays[f"ef/{r}/err/{leaf}"]
                              [s]).max() <= ulp * gmax, (r, s, leaf)
