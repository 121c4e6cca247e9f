"""PyTorch port, SPMD query shipping: ``GraphDB.query(mesh=...)`` against the
JAX package's, and its parts.

  * the collectives of ``repro_torch.dist.mesh`` against numpy statements of
    ``jax.lax``'s tiled ``all_to_all``, ``psum`` and ``all_gather``;
  * the per-shard operators (``_lookup_local``, ``_expand_local``,
    ``_check_local``) against the JAX functions on every shard block of the
    4-shard test stores, called in this process (they need no collective);
  * the whole slice: ``tests/torch_spmd_reference.py`` runs the JAX
    package's ``GraphDB.query(mesh=...)`` once, in a process of its own on
    four host devices as a (2, 2) ``("data", "model")`` mesh, over the same
    stores (uniform, fused per-query and shared programs, overflowing caps,
    ``Nearest``), and the port's ``mesh=make_mesh(4, device="cpu")`` results
    on both backends must equal it bit for bit, f32 rows compared as bits.

The reference runs in two processes, each with half of the cases, started
with the first test of this file; they run while the operator tests do.
The ``Nearest`` batch is ``test_torch_vector``'s, whose near-tie check
makes its seed sets exact.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import store as jstore
from repro.core.query import executor_spmd as jspmd
from repro.core.query.a1ql import Pred as JPred
from repro_torch.core import index
from repro_torch.core.query import executor_spmd as spmd
from repro_torch.core.query.a1ql import Pred
from repro_torch.core.query.executor import QueryCaps
from repro_torch.dist import mesh as mesh_mod

import torch_spmd_reference as reference
from test_backend_parity import q_chain
from test_torch_store_index_edges import (BACKENDS, CFG, JCFG,  # noqa: F401
                                          carry, jax_db, jax_stores,
                                          one_torch_thread, store_arrays)
from test_torch_vector import CFG as VCFG
from test_torch_vector import jax_vdb

S = 4
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")
CASES = {c[0]: c for c in reference.cases()}
# the reference processes' shares of the cases (about even in compile time)
SPLIT = (("uniform_count", "uniform_select", "uniform_star", "uniform_tiny",
          "nearest", "nearest_shared"),
         ("fused_mixed", "shared_mixed", "fused_tiny", "shared_tiny"))


@pytest.fixture(scope="module", autouse=True)
def jax_mesh_run(tmp_path_factory):
    """Start the JAX reference processes; they run beside the tests."""
    assert sorted(sum(SPLIT, ())) == sorted(CASES)
    out_dir = tmp_path_factory.mktemp("spmd_reference")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, TESTS] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    runs = []
    for i, names in enumerate(SPLIT):
        log = open(out_dir / f"log{i}.txt", "w")
        runs.append((subprocess.Popen(
            [sys.executable, os.path.join(TESTS, "torch_spmd_reference.py"),
             str(out_dir / f"reference{i}.npz"), *names], env=env,
            stdout=log, stderr=subprocess.STDOUT), log,
            out_dir / f"log{i}.txt", out_dir / f"reference{i}.npz"))
    yield runs
    for proc, log, _, _ in runs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log.close()


@pytest.fixture(scope="module")
def reference_results(jax_mesh_run):
    out = {}
    for proc, _, log, npz in jax_mesh_run:
        assert proc.wait(timeout=600) == 0, log.read_text()
        with np.load(npz) as z:
            out.update({k: z[k] for k in z.files})
    return out


@pytest.fixture(scope="module")
def port_dbs():
    """The port's databases over the reference process's stores."""
    docs = carry(jax_vdb())
    docs.vector_index("doc")
    return {"two_tier": carry(jax_db("two_tier")),
            "all_delta": carry(jax_db("all_delta")), "docs": docs}


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 4])
def test_collectives_match_lax_semantics(n):
    """Tiled all_to_all (shard d receives row-block d of every shard, in
    shard order), psum (summed in shard order, -0.0 + 0.0 = +0.0, on every
    shard) and all_gather (stacked), for S = 3 and 4."""
    rng = np.random.default_rng(n)
    xs = [rng.integers(-9, 9, (2 * n, 3)).astype(np.int32) for _ in range(n)]
    got = mesh_mod.all_to_all([torch.as_tensor(x) for x in xs])
    for d in range(n):
        want = np.concatenate([x[2 * d:2 * d + 2] for x in xs])
        assert np.array_equal(got[d].numpy(), want)
    fs = [rng.normal(size=(4, 5)).astype(np.float32) for _ in range(n)]
    fs[0][0, 0], fs[1][0, 0] = -0.0, 0.0
    want = fs[0].copy()
    for f in fs[1:]:
        want = want + f
    for p in mesh_mod.psum([torch.as_tensor(f) for f in fs]):
        assert np.array_equal(p.numpy().view(np.int32), want.view(np.int32))
    for gth in mesh_mod.all_gather([torch.as_tensor(x) for x in xs]):
        assert np.array_equal(gth.numpy(), np.stack(xs))


def test_mesh_and_shard_store():
    """make_mesh puts S shards on one device; shard_store's blocks are
    views of the store's fields, split once per store."""
    mesh = mesh_mod.make_mesh(S, device="cpu")
    assert mesh == mesh_mod.ShardMesh((torch.device("cpu"),) * S)
    assert mesh.size == S
    db = carry(jax_db("two_tier"))
    blocks = mesh_mod.shard_store(db.store, CFG, mesh)
    assert mesh_mod.shard_store(db.store, CFG, mesh) is blocks
    a = store_arrays(jax_db("two_tier").store)
    for s, st in enumerate(blocks):
        for name, t in zip(mesh_mod.FIELDS, st.tensors()):
            whole = getattr(db.store, name)
            assert t.untyped_storage().data_ptr() == \
                whole.untyped_storage().data_ptr()
            assert np.array_equal(t.numpy(), np.split(a[name], S)[s]), name
    with pytest.raises(ValueError):
        mesh_mod.shard_store(db.store, CFG, mesh_mod.make_mesh(2, "cpu"))


def test_make_mesh_defaults_to_cuda():
    """Like every entry point, make_mesh runs on cuda unless told
    otherwise, and raises without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_mod.make_mesh(S)


def test_index_blocks_sorted():
    """The binary searches' precondition holds on every test store: each
    shard's probe keys ascend (ROADMAP queue 3)."""
    docs = carry(jax_vdb())
    for db, cfg in ((carry(jax_db("two_tier")), CFG),
                    (carry(jax_db("all_delta")), CFG), (docs, VCFG)):
        assert index.blocks_sorted(db.store, cfg) == [True] * S


# ---------------------------------------------------------------------------
# per-shard operators against the JAX functions, shard block by block
# ---------------------------------------------------------------------------

_J_LOOKUP = jax.jit(jspmd._lookup_local, static_argnames=("cfg", "xd_win"))
_J_EXPAND = jax.jit(jspmd._expand_local, static_argnames=(
    "cfg", "etype", "direction", "cap_out"))
_J_CHECK = jax.jit(jspmd._check_local, static_argnames=(
    "cfg", "target_vtype", "pred"))


@functools.lru_cache(maxsize=None)
def _blocks(tier):
    """(JAX block stores, port block stores) of one tier."""
    a = jax_stores()[2][tier]
    jblocks = [jstore.GraphStore(**{k: jnp.asarray(np.split(v, S)[s])
                                    for k, v in a.items()})
               for s in range(S)]
    db = carry(jax_db(tier))
    return jblocks, mesh_mod.shard_store(db.store, CFG,
                                         mesh_mod.make_mesh(S, "cpu"))


def _eq(got, want, what):
    assert np.array_equal(got.numpy(), np.asarray(want)), what


@pytest.mark.parametrize("tier", ["all_delta", "two_tier"])
def test_lookup_local_matches_jax(tier):
    """Every shard's probe of its own block: live, deleted, re-created and
    missing keys, a scalar and a per-query snapshot, with and without the
    delta window."""
    vert = jax_stores()[0]
    jblocks, blocks = _blocks(tier)
    rng = np.random.default_rng(1)
    vt = np.concatenate([vert["vtype"], [0, 1, 2]]).astype(np.int32)
    key = np.concatenate([vert["key"], [77, 999, 5]]).astype(np.int32)
    valid = rng.random(vt.shape[0]) < 0.9
    per_q = rng.integers(1, 13, vt.shape[0]).astype(np.int32)
    found = 0
    for ts, xwin in ((10, None), (12, 8), (per_q, None), (per_q, 4)):
        jts = jnp.asarray(ts) if isinstance(ts, np.ndarray) else jnp.int32(ts)
        tts = torch.as_tensor(ts) if isinstance(ts, np.ndarray) else ts
        for s in range(S):
            want = _J_LOOKUP(jblocks[s], JCFG, s, jnp.asarray(vt),
                             jnp.asarray(key), jnp.asarray(valid), jts,
                             xd_win=xwin)
            for be in BACKENDS:
                got = spmd._lookup_local(blocks[s], CFG, s, torch.as_tensor(
                    vt), torch.as_tensor(key), torch.as_tensor(valid), tts,
                    be, xd_win=xwin)
                _eq(got, want, (tier, s, xwin, be))
            found += int((np.asarray(want) >= 0).sum())
    assert found > 0


@pytest.mark.parametrize("tier", ["all_delta", "two_tier"])
def test_expand_local_matches_jax(tier):
    """Every shard's enumeration of the gids it owns: both directions, an
    etype filter, several snapshots, a small cap_out, and more than MULTI_Q
    queries on one vertex with delta edges (the delta merge's overflow)."""
    vert, edge = jax_stores()[:2]
    n = vert["gid"].shape[0]
    jblocks, blocks = _blocks(tier)
    rng = np.random.default_rng(2)
    flags, multi_q = set(), False
    for s in range(S):
        owned = np.arange(s, n, S)
        gids = rng.choice(owned, 24).astype(np.int32)
        hub = int(np.bincount(edge["src"][edge["src"] % S == s],
                              minlength=n).argmax())
        gids[:10] = hub              # ten queries parked on one vertex
        qids = np.arange(24, dtype=np.int32)
        valid = rng.random(24) < 0.9
        valid[:10] = True
        for ts, etype, direction, cap_out in (
                (12, -1, "out", 256), (12, 1, "in", 256), (6, 0, "out", 8),
                (9, -1, "in", 256), (11, 1, "out", 8)):
            want = _J_EXPAND(jblocks[s], JCFG, jnp.asarray(qids),
                             jnp.asarray(gids), jnp.asarray(valid),
                             etype=etype, direction=direction,
                             read_ts=jnp.int32(ts), cap_out=cap_out)
            for be in BACKENDS:
                got = spmd._expand_local(
                    blocks[s], CFG, torch.as_tensor(qids),
                    torch.as_tensor(gids), torch.as_tensor(valid),
                    etype=etype, direction=direction, read_ts=ts,
                    cap_out=cap_out, backend=be)
                for g, w in zip(got, want):
                    _eq(g, w, (tier, s, ts, direction, be))
            flags.add(bool(want[2]))
            # the all-delta store has no CSR spans: only the delta merge's
            # MULTI_Q cap can overflow there
            multi_q |= tier == "all_delta" and bool(want[2])
    assert flags == {True, False}
    assert multi_q == (tier == "all_delta")


def test_check_local_matches_jax():
    """Owner-side vertex checks: liveness at several snapshots, a target
    type, and f32, i32 and key predicates read from the current or the
    previous data version."""
    n = jax_stores()[0]["gid"].shape[0]
    jblocks, blocks = _blocks("two_tier")
    rng = np.random.default_rng(3)
    preds = ((12, -1, None), (9, 2, ("i32", 0, ">", 1990.0)),
             (5, 2, ("f32", 0, "<", 250.0)), (12, 1, ("key", 0, "==", 300.0)),
             (10, 1, ("key", 0, "!=", 300.0)))
    alive = 0
    for s in range(S):
        gids = np.arange(s, n, S).astype(np.int32)
        valid = rng.random(gids.shape[0]) < 0.85
        for ts, tvt, p in preds:
            want = _J_CHECK(jblocks[s], JCFG, jnp.asarray(gids),
                            jnp.asarray(valid), jnp.int32(ts),
                            target_vtype=tvt,
                            pred=None if p is None else JPred(*p))
            got = spmd._check_local(blocks[s], CFG, torch.as_tensor(gids),
                                    torch.as_tensor(valid), ts, tvt,
                                    None if p is None else Pred(*p))
            _eq(got, want, (s, ts, tvt, p))
            alive += int(np.asarray(want).sum())
    assert alive > 0


# ---------------------------------------------------------------------------
# GraphDB.query(mesh=...) against the JAX package's
# ---------------------------------------------------------------------------

def assert_matches(res, ref, name):
    """A port QueryResult equal to the reference's saved fields, f32 rows
    compared as bits."""
    assert res.failed == bool(ref[f"{name}/failed"]), name
    for f in reference.FIELDS:
        got, key = getattr(res, f), f"{name}/{f}"
        assert (got is None) == (key not in ref), (name, f)
        if got is not None:
            assert got.dtype == ref[key].dtype, (name, f)
            assert np.array_equal(got, ref[key]), (name, f)
    rows = {f"{name}/rows/{k}/{c}": v
            for (k, c), v in (res.rows or {}).items()}
    assert set(rows) == {k for k in ref if k.startswith(f"{name}/rows/")}
    for k, v in rows.items():
        assert v.dtype == ref[k].dtype, k
        assert np.array_equal(v.view(np.int32), ref[k].view(np.int32)), k


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_query_matches_jax(name, port_dbs, reference_results):
    """Uniform (chains, a select, stars), fused per-query and shared mixed
    batches at per-query snapshots, overflowing buckets and frontiers, and
    Nearest in both budget modes, on both backends."""
    _, store, queries, caps, kw = CASES[name]
    mesh = mesh_mod.make_mesh(S, device="cpu")
    for be in ("ref", "kernel"):
        res = port_dbs[store].query(queries, caps=QueryCaps(**caps),
                                    backend=be, mesh=mesh, **kw)
        assert_matches(res, reference_results, f"{name}")
    if "tiny" in name:
        assert res.failed
    elif name.startswith(("fused", "shared", "nearest")):
        assert not res.failed_q.any()


def test_mesh_gid_cursor_raises(port_dbs):
    """A gid cursor under mesh= raises, as the JAX package's does: SPMD
    select rows are shard-major."""
    doc = [dict(q_chain(0, select=["key"]), gid_cursor=3)]
    with pytest.raises(ValueError, match="gid_cursor"):
        jax_db("two_tier").query(doc, mesh=object())
    with pytest.raises(ValueError, match="gid_cursor"):
        port_dbs["two_tier"].query(doc, mesh=mesh_mod.make_mesh(S, "cpu"))


def test_mesh_counts_match_local_path(port_dbs):
    """Without overflow, the mesh programs count what the local ones do and
    select the same row sets (mesh rows come shard-major)."""
    db = port_dbs["two_tier"]
    queries = CASES["fused_mixed"][2]
    kw = CASES["fused_mixed"][4]
    caps = QueryCaps(**CASES["fused_mixed"][3])
    mesh = mesh_mod.make_mesh(S, device="cpu")
    for extra in ({}, {"budget": "shared"}):
        loc = db.query(queries, caps=caps, **kw, **extra)
        got = db.query(queries, caps=caps, mesh=mesh, **kw, **extra)
        assert np.array_equal(loc.counts, got.counts)
        for a, b in zip(loc.rows_gid, got.rows_gid):
            assert sorted(a.tolist()) == sorted(b.tolist())
