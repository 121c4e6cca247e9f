"""PyTorch port, the serving tier (``repro_torch/launch/serve.py``'s
``A1Server``) against the JAX package: continuation tokens, hedged
retries, cursor refills, ``Nearest`` pagination and the planner counters
in ``stats`` (the cases of ``tests/test_serve.py``).

The JAX side of the seeded cases is a committed fixture
(``tests/fixtures/torch_serve``, made by its ``make_fixture.py`` from
``tests/torch_serve_script.py``; the tests compile no JAX program).  Each
case runs through the port under the same fake clock, and every recorded
step must be equal to JAX's: each result's status, count, rows and flags,
every ``stats`` key with its histograms, breaker states, latencies,
``write_result``s, pins left and the program cache's counters.  This file
also holds the helpers the two other serving files import, the planner's
``CACHE_STATS``, and ``use_spmd=True`` served through a 4-shard mesh
against the local path.
"""
import copy
import functools
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

import torch_serve_script as script
from repro_torch.core import faults, writes
from repro_torch.core.addressing import StoreConfig
from repro_torch.core.graphdb import GraphDB
from repro_torch.core.query import planner, planner_shared
from repro_torch.core.query.a1ql import ParseError
from repro_torch.core.query.executor import QueryCaps
from repro_torch.dist.mesh import make_mesh
from repro_torch.launch import serve
from test_torch_store_index_edges import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_serve"
_BUILT = {}


def _make(key, build):
    """One build per key and process; each case gets its own deep copy
    (store tensors, host mirrors, catalog and all)."""
    if key not in _BUILT:
        _BUILT[key] = build()
    return copy.deepcopy(_BUILT[key])


def port_namespace():
    return script.namespace(
        GraphDB=functools.partial(GraphDB, device="cpu"),
        StoreConfig=StoreConfig, QueryCaps=QueryCaps, w=writes,
        faults=faults, serve=serve, planner=planner,
        planner_shared=planner_shared, ParseError=ParseError,
        np_of=lambda t: t.numpy(), make=_make)


@functools.lru_cache(maxsize=None)
def jax_cases() -> dict:
    with open(FIXTURE / "serve.json") as f:
        return json.load(f)


def _diff(got, want, path="") -> str:
    """The first path at which two JSON values differ."""
    if isinstance(want, dict) and isinstance(got, dict):
        for k in sorted(set(got) | set(want)):
            if k not in got or k not in want:
                return f"{path}/{k}: only in {'port' if k in got else 'jax'}"
            d = _diff(got[k], want[k], f"{path}/{k}")
            if d:
                return d
        return ""
    if isinstance(want, list) and isinstance(got, list):
        if len(got) != len(want):
            return f"{path}: length {len(got)} != {len(want)}"
        for i, (a, b) in enumerate(zip(got, want)):
            d = _diff(a, b, f"{path}[{i}]")
            if d:
                return d
        return ""
    if got != want or type(got) is not type(want):
        return f"{path}: port {got!r} != jax {want!r}"
    return ""


def assert_case_matches_jax(name):
    got = script.run(port_namespace(), name).json()
    want = jax_cases()["cases"][name]
    assert [s["label"] for s in got["steps"]] == [
        s["label"] for s in want["steps"]]
    d = _diff(got, want)
    assert not d, f"{name}: {d}"


def test_fixture_is_of_this_script():
    data = (Path(__file__).parent / "torch_serve_script.py").read_bytes()
    assert jax_cases()["script_sha256"] == hashlib.sha256(data).hexdigest()
    assert set(jax_cases()["cases"]) == set(script.CASES)


@pytest.mark.parametrize("name", script.SERVE_CASES)
def test_case_matches_jax(name):
    assert_case_matches_jax(name)


# ---------------------------------------------------------------------------
# the planner's program-cache counters
# ---------------------------------------------------------------------------

def test_cache_stats_count_hits_misses_evictions(monkeypatch):
    planner._CACHE.clear()
    planner.reset_stats()
    monkeypatch.setattr(planner, "CACHE_MAX_PROGRAMS", 1)
    db = script.busy_db(port_namespace())
    c = QueryCaps(frontier=128, expand=512, results=8)
    db.query([script.q_chain(0)], caps=c, fused=True)
    db.query([script.q_chain(1)], caps=c, fused=True)     # same shape: hit
    assert planner.CACHE_STATS == {"hits": 1, "misses": 1, "evictions": 0}
    db.query([script.q_chain(0, select=["key"])], caps=c, fused=True)
    assert planner.CACHE_STATS == {"hits": 1, "misses": 2, "evictions": 1}
    planner.reset_stats()
    assert planner.CACHE_STATS == {"hits": 0, "misses": 0, "evictions": 0}
    assert len(planner._CACHE) == 1                  # programs are kept


def test_fresh_server_resets_planner_counters():
    db = script.busy_db(port_namespace())
    srv = serve.A1Server(db, caps=QueryCaps(frontier=128, expand=512,
                                            results=8))
    srv.execute([script.q_chain(0), script.q_star(0, 301)])
    srv.execute([script.q_chain(0), script.q_star(0, 301)])
    assert planner.CACHE_STATS["hits"] >= 1
    assert srv.stats["planner_cache_hit_rate"] > 0.0
    serve.A1Server(db)
    assert planner.CACHE_STATS == {"hits": 0, "misses": 0, "evictions": 0}
    assert planner.FRONTIER_STATS["per_query_peak_bytes"] == 0


# ---------------------------------------------------------------------------
# the server owns what it returns
# ---------------------------------------------------------------------------

def test_hedged_result_is_the_callers_own():
    """A hedge patches the base result in place: the arrays must be the
    caller's, not a buffer a later wave writes into."""
    db = script.busy_db(port_namespace())
    srv = serve.A1Server(db, caps=QueryCaps(frontier=16, expand=2,
                                            results=4))
    batch = [script.q_chain(0), script.q_chain(999), script.q_star(0, 301)]
    res = srv.execute(batch, qclass="mixed")
    assert srv.stats["hedged"] == 1
    kept = {k: np.array(getattr(res, k)) for k in ("counts", "failed_q")}
    srv.execute([script.q_chain(1), script.q_chain(2),
                 script.q_star(1, 300)], qclass="mixed")
    srv.execute(batch, qclass="mixed")
    for k, v in kept.items():
        np.testing.assert_array_equal(getattr(res, k), v)


def test_server_runs_on_its_databases_device():
    db = script.busy_db(port_namespace())
    srv = serve.A1Server(db, read_batch=1)
    assert srv.tasks.db is db and db.task_queue is srv.tasks
    r = srv.query_result(srv.submit_query(script.q_chain(0)))
    assert r["status"] == "OK" and db.store.vtype.device.type == "cpu"


# ---------------------------------------------------------------------------
# use_spmd=True through a 4-shard mesh, port against port
# ---------------------------------------------------------------------------

def _serve_waves(db, srv, pager):
    """Admitted waves of chains, a filtered chain, a star, a select and an
    in-edge select, a write between waves, then one select paged by
    ``pager`` (the growing-window refill under SPMD, the gid cursor
    locally).  Select rows come back shard-major under SPMD: each row set
    is compared sorted, and the waves' caps hold every select whole."""
    rows, wids = [], []
    for r in range(3):
        qids = [srv.submit_query(q, tenant=f"t{j % 2}") for j, q in
                enumerate([script.q_chain(r % 3), script.q_chain(1, genre=1),
                           script.q_star(0, 301), dict(script.SEL),
                           script.q_chain(323, direction="in")])]
        wids.append(srv.submit_write(
            [writes.CreateVertex("actor", 2000 + r)]))
        srv.flush_queries()
        srv.pump()
        rows += [srv.query_result(q) for q in qids]
    srv.flush_writes()
    for r in rows:
        assert r["status"] == "OK" and not r.get("truncated"), r
        if "rows" in r:
            r["rows"] = sorted(r["rows"])
    page, token = pager.select_paged(script.SEL)
    got = [int(x) for x in page]
    script._page_all(pager, token, got)
    return rows, [srv.write_result(w) for w in wids], sorted(got)


def test_spmd_serving_equals_local(monkeypatch):
    """Under the script's fake clock, so that wall-time histograms and
    latencies are counts of clock reads and compare equal."""
    m = port_namespace()
    out = {}
    for spmd in (False, True):
        clock = script.FakeClock()
        monkeypatch.setattr(serve, "time", clock)
        monkeypatch.setattr(planner, "time", script.ClockView(clock))
        planner._CACHE.clear()
        db = script.busy_db(m)
        kw = dict(use_spmd=True, mesh=make_mesh(4, device="cpu")) if spmd \
            else {}
        srv = serve.A1Server(db, caps=QueryCaps(frontier=128, expand=512,
                                                results=16),
                             read_batch=5, read_deadline_ms=1e9,
                             write_batch=1, write_deadline_ms=1e9, **kw)
        pager = serve.A1Server(db, caps=QueryCaps(frontier=128, expand=512,
                                                  results=4),
                               page_size=2, **kw)
        rows, wr, paged = _serve_waves(db, srv, pager)
        out[spmd] = (rows, [(w["status"], w["gids"]) for w in wr], paged,
                     dict(srv.stats, latency=srv.latency_report()),
                     pager.stats, script.digest(m, db))
        assert not db.active_query_ts
    loc, sp = out[False], out[True]
    assert sp[0] == loc[0] and sp[1] == loc[1] and sp[2] == loc[2]
    assert sp[3] == loc[3]
    assert sp[5] == loc[5]
    # the refill plan differs by design: SPMD grows the window where the
    # local path moves a gid cursor
    assert loc[4]["cursor_refills"] >= 1 and sp[4]["cursor_refills"] == 0
    assert sp[4]["continuations"] == loc[4]["continuations"] == 1
    assert sum(len(r.get("rows", ())) for r in loc[0]) > 0
