"""PyTorch port, vector index and ``Nearest``: registration and backfill
against the JAX package field for field, and Nearest-rooted queries through
``GraphDB.query`` on both of the port's backends against the JAX package's,
in both budget modes and at two snapshots.

The store holds the JAX package's hybrid workload (``benchmarks/
bench_vector.py``: ``doc`` vertices whose f32 payload row is the embedding,
``tag`` vertices, two ``doc.tag`` edges a doc) at a tiny size, with docs
created at several timestamps, some deleted and some with a previous
payload version.  It is laid out once by the port's loader (which lays a
store out as the JAX compactions do) and set into both databases as numpy
arrays, so no JAX write path has to compile.

Tolerance (ROADMAP queue 3): the JAX reference sums distances in another
order, so its distances agree only to rounding.  Seed sets, and so counts
and rows, are compared exactly; :func:`assert_no_near_tie` first checks that
no query's k-th and (k+1)-th candidates lie within that rounding of each
other, where an exact comparison would not be meaningful.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.addressing import StoreConfig as JStoreConfig
from repro.core.graphdb import GraphDB as JGraphDB
from repro.core.query.executor import QueryCaps as JQueryCaps
from repro_torch.core import store
from repro_torch.core.addressing import StoreConfig
from repro_torch.core.query.executor import QueryCaps
from repro_torch.data.kg import assemble

from test_torch_query import assert_same
from test_torch_store_index_edges import (_jst, carry,  # noqa: F401
                                          one_torch_thread, store_arrays)

D = 4
JCFG = JStoreConfig(n_shards=4, cap_v=16, cap_e=64, cap_delta=16, cap_idx=32,
                    cap_idx_delta=16, cap_vec=16, d_f32=D, d_i32=2)
CFG = StoreConfig(**dataclasses.asdict(JCFG))
N_DOCS, N_TAGS, CLOCK = 40, 6, 12
CAPS = dict(frontier=64, expand=256, results=16)
F_ATTRS = tuple(f"f{i}" for i in range(D))


def docs_and_tags(seed: int = 0):
    """Vertex and edge lists: docs 0..39 (vtype 0) created at 1..7, some
    deleted at 9..11, some with a payload written after their creation
    (the previous version differs); tags (vtype 1); edges (type 0) from doc
    i to tags i % 6 and (7i + 3) % 6, created with the doc."""
    rng = np.random.default_rng(seed)
    n = N_DOCS + N_TAGS
    create = np.concatenate([rng.integers(1, 8, N_DOCS), np.ones(N_TAGS)])
    delete = np.full(n, 2**31 - 1)
    dead = np.flatnonzero(rng.random(N_DOCS) < 0.15)
    delete[dead] = rng.integers(9, 12, dead.shape[0])
    f = np.zeros((n, D), np.float32)
    f[:N_DOCS] = rng.normal(size=(N_DOCS, D))
    data_ts = create + (rng.random(n) < 0.3) * rng.integers(1, 4, n)
    data_ts[N_DOCS:] = 1
    vert = dict(gid=np.arange(n),
                vtype=np.array([0] * N_DOCS + [1] * N_TAGS),
                key=np.concatenate([np.arange(N_DOCS),
                                    10_000 + np.arange(N_TAGS)]),
                f=f, i=np.stack([np.arange(n), np.zeros(n)], 1),
                create=create, delete=delete, data_ts=data_ts,
                prev_ts=create, prev_f=f - 0.5)
    doc = np.repeat(np.arange(N_DOCS), 2)
    tag = N_DOCS + np.stack([np.arange(N_DOCS) % N_TAGS,
                             (7 * np.arange(N_DOCS) + 3) % N_TAGS],
                            1).reshape(-1)
    edge = dict(src=doc, dst=tag, etype=np.zeros_like(doc),
                create=create[doc], delete=delete[doc])
    return vert, edge


def jax_vdb():
    """A JAX GraphDB over the doc/tag store, not yet vector-indexed."""
    vert, edge = docs_and_tags()
    arrays = store_arrays(assemble(CFG, vert, edge, CLOCK, "cpu", gc_ts=1))
    jdb = JGraphDB(JCFG)
    jdb.vertex_type("doc", f_attrs=F_ATTRS, i_attrs=("x", "y"))
    jdb.vertex_type("tag")
    jdb.edge_type("doc.tag")
    jdb.store = _jst(arrays)
    jdb.clock = CLOCK
    jdb.v_next[:] = np.bincount(vert["gid"] % JCFG.n_shards,
                                minlength=JCFG.n_shards)
    return jdb


@pytest.fixture(scope="module")
def vdbs():
    """(JAX db, port db carried across after the JAX registration)."""
    jdb = jax_vdb()
    jdb.vector_index("doc")
    return jdb, carry(jdb)


def test_vector_index_backfill_matches_jax(vdbs):
    """The port's own registration of a carried-across store equals the JAX
    package's, field for field, with the host mirrors; and a JAX database
    registered before the carry keeps its index (no second backfill)."""
    jdb, carried = vdbs
    db = carry(jax_vdb())
    assert not db._vindexed
    db.vector_index("doc")
    db.vector_index("doc")                       # idempotent
    want = store_arrays(jdb.store)
    for port in (db, carried):
        for name in store.FIELDS:
            if name.startswith("vx_"):
                got = getattr(port.store, name).numpy()
                assert np.array_equal(got.view(np.int32),
                                      want[name].view(np.int32)), name
        assert np.array_equal(port.vx_count, jdb.vx_count)
        assert port._vx_pos == jdb._vx_pos
        assert port._vindexed == jdb._vindexed == {0}
    assert int(jdb.vx_count.sum()) > 0


def near(vec, k, select="count"):
    q = {"nearest": {"type": "doc", "vector": [float(x) for x in vec],
                     "k": k}}
    if select == "count":
        q["_out_edge"] = {"type": "doc.tag",
                          "_target": {"type": "tag", "select": "count"}}
    else:
        q["select"] = list(select)
    return q


def scan(key):
    return {"type": "doc", "id": int(key),
            "_out_edge": {"type": "doc.tag",
                          "_target": {"type": "tag", "select": "count"}}}


def assert_no_near_tie(jdb, vecs, ks, ts_list, tol=1e-4):
    """No query has its k-th and (k+1)-th visible docs (by the f64
    distance) closer than ``tol``: the seed sets are then exact."""
    st = store_arrays(jdb.store)
    for v, k, ts in zip(vecs, ks, ts_list):
        ok = ((st["vx_gid"] >= 0) & (st["vx_vtype"] == 0)
              & (st["vx_create"] <= ts) & (ts < st["vx_delete"]))
        e = st["vx_emb"][ok].astype(np.float64)
        d = np.sort((e * e).sum(1) - 2 * e @ np.asarray(v, np.float64))
        if d.shape[0] > k:
            assert d[k] - d[k - 1] > tol, (k, ts)


VEC_RNG = np.random.default_rng(11)
VECS = VEC_RNG.normal(size=(4, D)).astype(np.float32)
BATCH = [near(VECS[0], 3), near(VECS[1], 8), scan(5), near(VECS[2], 1),
         near(VECS[3], 8)]
TS = [CLOCK, 6, CLOCK, 9, 5]


@pytest.mark.parametrize("budget", ["per-query", "shared"])
def test_nearest_hop_counts_match_jax(vdbs, budget):
    """k-NN seeds -> doc.tag -> tag counts, beside a scan-rooted query, at
    per-query snapshots (before and after deletes and payload writes)."""
    jdb, db = vdbs
    assert_no_near_tie(jdb, VECS, (3, 8, 1, 8), (CLOCK, 6, 9, 5))
    want = jdb.query(BATCH, caps=JQueryCaps(**CAPS), read_ts=TS,
                     backend="ref", budget=budget)
    assert want.counts.min() > 0 and not want.failed_q.any()
    for be in ("ref", "kernel"):
        got = db.query(BATCH, caps=QueryCaps(**CAPS), read_ts=TS, backend=be,
                       budget=budget)
        assert_same(got, want, be)
        assert np.array_equal(got.shared_ovf_q, want.shared_ovf_q)


def test_nearest_select_keys_match_jax(vdbs):
    """The seeds themselves: nearest docs selected with their keys and an
    f32 payload column, at two snapshots."""
    jdb, db = vdbs
    queries = [near(v, 5, select=("key", "f0")) for v in VECS]
    ts = [CLOCK, 7, CLOCK, 7]
    assert_no_near_tie(jdb, VECS, (5,) * 4, ts)
    want = jdb.query(queries, caps=JQueryCaps(**CAPS), read_ts=ts,
                     backend="ref")
    assert (want.rows_gid >= 0).sum() == 20
    for be in ("ref", "kernel"):
        assert_same(db.query(queries, caps=QueryCaps(**CAPS), read_ts=ts,
                             backend=be), want, be)


def test_nearest_is_fused_only(vdbs):
    _, db = vdbs
    with pytest.raises(ValueError, match="no nearest"):
        db.query([near(VECS[0], 2)], fused=False)
