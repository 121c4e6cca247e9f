"""PyTorch port, shared frontier: ``GraphDB.query(..., budget="shared")``
against the JAX package's, bit for bit (counts, rows, ``failed_q``,
``shared_ovf_q``), on both of the port's backends, and the shared-mode
contract against the port's own per-query mode.

The JAX databases are the seeded film KG of ``test_torch_store_index_edges``
(its stores set directly, no JAX write path), as in ``test_torch_query``.
"""
import numpy as np
import pytest

from repro.core.query import planner as jplanner
from repro.core.query.executor import QueryCaps as JQueryCaps
from repro_torch.core.query import planner
from repro_torch.core.query.executor import QueryCaps

from test_backend_parity import q_chain, q_star
from test_torch_query import CAPS, MIXED, assert_same, dbs  # noqa: F401
from test_torch_store_index_edges import one_torch_thread  # noqa: F401

TS = [12, 1, 9, 10, 6, 12, 11]


def run_shared(dbs, store, queries, caps=CAPS, **kw):
    """The JAX shared-mode result, then the port's on both backends, all
    identical, ``shared_ovf_q`` included."""
    jdb, db = dbs[store]
    want = jdb.query(queries, caps=JQueryCaps(**caps), backend="ref",
                     budget="shared", **kw)
    for be in ("ref", "kernel"):
        got = db.query(queries, caps=QueryCaps(**caps), backend=be,
                       budget="shared", **kw)
        assert_same(got, want, (store, be))
        assert np.array_equal(got.shared_ovf_q, want.shared_ovf_q), be
    return want


def assert_shared_contract(sh, pq):
    """Per-query mode's flags are a subset of shared mode's, and every
    query flagged in neither mode has the same counts and rows."""
    assert (sh.failed_q | ~pq.failed_q).all()
    assert not (sh.shared_ovf_q & ~sh.failed_q).any()
    ok = ~sh.failed_q
    if pq.counts is not None:
        assert np.array_equal(sh.counts[ok], pq.counts[ok])
    if pq.rows_gid is not None:
        assert np.array_equal(sh.rows_gid[ok], pq.rows_gid[ok])
        assert np.array_equal(sh.truncated[ok], pq.truncated[ok])


@pytest.mark.parametrize("store,queries", [
    ("mutated", MIXED + [q_chain(1, select=["key"])]),
    ("all_delta", MIXED)], ids=["mutated", "all_delta"])
def test_shared_mixed_batch_matches_jax(dbs, store, queries):
    """Chains, reverse chains, stars, a filter, a missing key (and, on the
    mutated store, a select group) at per-query snapshots: no pool
    overflows, so shared mode also equals per-query mode."""
    ts = TS + [12] * (len(queries) - len(TS))
    sh = run_shared(dbs, store, queries, read_ts=ts)
    assert sh.counts[:7].sum() > 0 and not sh.failed_q.any()
    pq = dbs[store][1].query(queries, caps=QueryCaps(**CAPS), read_ts=ts,
                             fused=True)
    assert_shared_contract(sh, pq)
    assert_same(sh, pq)


def test_shared_overflow_matches_jax(dbs):
    """Small explicit shared pools: the pools overflow and flag their
    owners (``shared_ovf_q``), one query also overflows its own expand
    budget, and the unflagged queries keep their per-query results."""
    caps = dict(frontier=16, expand=64, results=8, shared_frontier=12,
                shared_expand=20)
    queries = MIXED + [q_chain(0), q_star(1, 305)]
    sh = run_shared(dbs, "mutated", queries, caps=caps)
    assert sh.shared_ovf_q.any() and not sh.shared_ovf_q.all()
    _, db = dbs["mutated"]
    pq = db.query(queries, caps=QueryCaps(**caps), fused=True)
    assert_shared_contract(sh, pq)
    tiny = dict(caps, expand=2)
    assert_shared_contract(
        db.query(queries, caps=QueryCaps(**tiny), budget="shared"),
        db.query(queries, caps=QueryCaps(**tiny), fused=True))


def test_shared_budget_matches_jax():
    for r in (1, 2, 3, 9, 17, 64, 85, 128, 300):
        for per_cap in (1, 16, 64, 4096, 16384):
            for explicit in (0, 5, 1000, 10**9):
                assert (planner.shared_budget(r, per_cap, explicit)
                        == jplanner.shared_budget(r, per_cap, explicit))


def test_shared_stats_and_fused_only(dbs):
    """The peak frontier bytes of each mode and the shared overflow tally,
    as the JAX package keeps them; shared mode refuses ``fused=False``."""
    _, db = dbs["mutated"]
    planner.reset_stats()
    queries = [q_chain(0), q_chain(1), q_star(0, 301)]
    caps = QueryCaps(frontier=16, expand=64, results=8, shared_frontier=4)
    db.query(queries, caps=caps, fused=True)
    res = db.query(queries, caps=caps, budget="shared")
    R = 4                                     # chain units of the batch
    assert planner.FRONTIER_STATS == {"per_query_peak_bytes": 4 * R * 16,
                                      "shared_peak_bytes": 2 * 4 * 4}
    assert (planner.OVERFLOW_STATS["shared_ovf_queries"]
            == int(res.shared_ovf_q.sum()) > 0)
    with pytest.raises(ValueError, match="fused"):
        db.query(queries, budget="shared", fused=False)
