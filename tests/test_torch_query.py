"""PyTorch port, query layer: ``GraphDB.query`` on carried-across JAX stores
against the JAX package's ``GraphDB.query``, on the uniform executor and the
fused planner, on both of the port's backends.

Counts, ``failed``/``failed_q``, ``truncated``, ``deadline_q`` and select
rows must be identical.  The f32 attributes in select rows compare exactly
too: both packages only gather them from the same stored bytes.  The JAX
databases hold the seeded film KG of ``test_torch_store_index_edges`` with
``test_backend_parity.build_db``'s schema, so its query builders apply;
their stores are set directly rather than written through the JAX write
path, whose compiles alone would take most of this suite's time budget.
Few distinct query shapes run, since every JAX shape is a compile.
"""
import numpy as np
import pytest
import torch

from repro.core.query.executor import QueryCaps as JQueryCaps
from repro_torch.core.addressing import StoreConfig
from repro_torch.core.graphdb import GraphDB
from repro_torch.core.query.executor import QueryCaps
from repro_torch.data.kg import build_film_kg

from test_backend_parity import q_chain, q_star
from test_torch_store_index_edges import (carry, jax_db,  # noqa: F401
                                          one_torch_thread)

CAPS = dict(frontier=128, expand=512, results=16)
TINY = dict(frontier=16, expand=2, results=4)


def q_films(did, genre, select=("key", "gross", "year")):
    """Films of a director with a genre filter, selecting attributes."""
    return {"type": "director", "id": did,
            "_out_edge": {"type": "film.director", "_target": {
                "type": "film", "select": list(select),
                "filter": {"attr": "genre", "op": "!=", "value": genre}}}}


def assert_same(port, jax, what=""):
    assert port.failed == jax.failed, what
    for f in ("counts", "failed_q", "rows_gid", "truncated", "deadline_q"):
        a, b = getattr(port, f), getattr(jax, f)
        assert (a is None) == (b is None), (what, f)
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), (what, f)
    assert (port.rows is None) == (jax.rows is None), what
    for k, v in (jax.rows or {}).items():
        w = np.asarray(v)
        assert port.rows[k].dtype == w.dtype, (what, k)
        assert np.array_equal(port.rows[k].view(np.int32),
                              w.view(np.int32)), (what, k)


@pytest.fixture(scope="module")
def dbs():
    """``mutated``: both edge tiers, deletes and re-creates; ``all_delta``:
    every edge and index entry still in the delta tier.  Each JAX database
    is paired with its port copy."""
    return {name: (jax_db(tier), carry(jax_db(tier)))
            for name, tier in (("mutated", "two_tier"),
                               ("all_delta", "all_delta"))}


def run_all(dbs, store, queries, caps=CAPS, **kw):
    """The JAX result, then the port's on both backends, all identical."""
    jdb, db = dbs[store]
    want = jdb.query(queries, caps=JQueryCaps(**caps), backend="ref", **kw)
    for be in ("ref", "kernel"):
        assert_same(db.query(queries, caps=QueryCaps(**caps), backend=be,
                             **kw), want, (store, be))
    return want


MIXED = [q_chain(0), q_chain(301, direction="in"), q_star(0, 301),
         q_chain(1, genre=1), q_chain(999), q_star(2, 311), q_chain(2)]


@pytest.mark.parametrize("store", ["mutated", "all_delta"])
def test_fused_mixed_batch(dbs, store):
    """Chains, reverse chains, stars, a filter and a missing key fused into
    one wave program, per-query budgets."""
    res = run_all(dbs, store, MIXED, fused=True)
    assert res.counts[:3].sum() > 0


def test_fused_snapshots_and_cursors(dbs):
    """Per-query read_ts and gid cursors are runtime data of one program."""
    jdb, _ = dbs["mutated"]
    ts = [jdb.clock, 1, 9, 10, 6, jdb.clock, 11]
    run_all(dbs, "mutated", MIXED, read_ts=ts, fused=True)
    with_cursor = [dict(q, gid_cursor=c) for q, c in
                   zip(MIXED, (0, 25, 10, 0, 0, 7, 30))]
    run_all(dbs, "mutated", with_cursor, fused=True)


def test_fused_select_rows(dbs):
    """Select terminals: gids, key/f32/i32 attributes, truncation (results
    smaller than a frontier) — plus a select star in the same group."""
    cols = ["key", "gross", "year"]
    star = {"intersect": q_star(0, 301)["intersect"], "select": cols,
            "type": "film"}
    queries = [q_films(0, 1), q_films(1, 0), q_films(2, 2), star]
    res = run_all(dbs, "mutated", queries, caps=dict(CAPS, results=1),
                  fused=True)
    assert (res.rows_gid >= 0).any() and res.truncated.any()


def test_fused_overflow_flags(dbs):
    """One overflowing query fails alone; a star's flag ORs its branches."""
    queries = [q_chain(0), q_chain(999), q_chain(1), q_star(0, 301)]
    res = run_all(dbs, "mutated", queries, caps=TINY, fused=True)
    assert res.failed_q.any() and not res.failed_q.all()


@pytest.mark.parametrize("queries", [
    [q_chain(300 + a, direction="in") for a in range(3)],     # reverse
    [q_star(0, 301), q_star(1, 305), q_star(2, 311)],         # star
    [q_films(d, 1) for d in range(3)],                        # filter/select
], ids=["reverse", "star", "select"])
def test_uniform_executor(dbs, queries):
    run_all(dbs, "mutated", queries)


def test_uniform_chain_snapshots_and_overflow(dbs):
    """Chain counts at several snapshots (one program: the snapshot is
    runtime data), on both stores, and the batch-wide overflow flag."""
    jdb, _ = dbs["mutated"]
    chains = [q_chain(d) for d in range(3)]
    for ts in (5, 9, jdb.clock):
        run_all(dbs, "mutated", chains, read_ts=ts)
    run_all(dbs, "all_delta", chains)
    assert run_all(dbs, "mutated", [q_chain(d) for d in range(4)],
                   caps=TINY).failed


def test_loader_store_counts_match_set_computation():
    """The port's own loader and query path, with no JAX: 2-hop, 3-hop and
    star counts over a small film KG on both backends, fused and uniform,
    against set computations over the loader's edge list."""
    kg = build_film_kg(n_films=60, n_actors=50, n_directors=6, n_genres=4,
                       seed=5, device="cpu")
    db = kg.db
    fd, fa = (db.et(n).type_id for n in ("film.director", "film.actor"))
    out_of, in_of = {}, {}
    for s, d, e in zip(*(kg.edges[k].tolist() for k in ("src", "dst",
                                                          "etype"))):
        out_of.setdefault((s, e), set()).add(d)
        in_of.setdefault((d, e), set()).add(s)

    def step(frontier, table, e):
        return set().union(set(), *(table.get((g, e), ()) for g in frontier))
    dids, aids = range(1_000, 1_004), (10_000, 10_001, 10_005, 10_040)
    chains = [{"type": "director", "id": d, "_out_edge": {
        "type": "film.director", "_target": {"type": "film", "_out_edge": {
            "type": "film.actor", "_target": {"type": "actor", "_in_edge": {
                "type": "film.actor", "_target": {
                    "type": "film", "select": "count"}}}}}}} for d in dids]
    stars = [{"intersect": [
        {"type": "director", "id": d, "_out_edge": {
            "type": "film.director", "_target": {"type": "film"}}},
        {"type": "actor", "id": a, "_in_edge": {
            "type": "film.actor", "_target": {"type": "film"}}}],
        "select": "count"} for d in dids for a in aids]
    want_chain, want_star = [], []
    for d in dids:
        films = step({db.lookup_vertex("director", d)[0]}, out_of, fd)
        actors = step(films, out_of, fa)
        want_chain.append(len(step(actors, in_of, fa)))
        for a in aids:
            want_star.append(len(films & step(
                {db.lookup_vertex("actor", a)[0]}, in_of, fa)))
    assert sum(want_star) > 0
    for be in ("ref", "kernel"):
        for fused in (True, False):
            for queries, want in ((chains, want_chain), (stars, want_star)):
                res = db.query(queries, caps=QueryCaps(frontier=512,
                                                       expand=1024),
                               backend=be, fused=fused)
                assert not res.failed
                assert res.counts.tolist() == want, (be, fused)


def test_port_rejects_later_slices(dbs):
    _, db = dbs["mutated"]
    with pytest.raises(NotImplementedError, match="shared"):
        db.query([q_chain(0)], budget="shared")
    with pytest.raises(NotImplementedError, match="SPMD"):
        db.query([q_chain(0)], mesh=object())


def test_no_gpu_no_fallback():
    """The entry points default to CUDA and raise without a GPU: they never
    carry on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device works")
    cfg = StoreConfig(n_shards=1, cap_v=8, cap_e=16, cap_delta=4, cap_idx=8,
                      cap_idx_delta=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphDB(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_film_kg(n_films=4, n_actors=4, n_directors=2, n_genres=2)
