"""Seeded cases of the serving tier (``launch/serve.py``'s ``A1Server``)
that drive either package.

Each case in :data:`CASES` is ``fn(m, rec, clock)``: ``m`` is a namespace
the caller builds from one package (see :func:`namespace`), ``rec`` a
:class:`Recorder` of JSON-safe steps (every read and write result in
submission order, the server's ``stats`` with its histograms, breaker
states, latency report and wave-time EWMA, pins left and the planner's
program-cache counters), ``clock`` the :class:`FakeClock` that
:func:`run` puts in place of each package's ``time`` for the case.  The
cases follow the JAX package's own tests case for case:

* ``tests/test_serve.py``: continuation tokens, hedged retries, cursor
  refills, ``Nearest`` pagination, the planner counters in ``stats``;
* ``tests/test_serve_admission.py``: read admission, shedding, tenant
  caps, the wave-time EWMA, the circuit breaker, ``budget="auto"`` at the
  knee, result sweeping, SLO budgets and the engine deadline;
* ``tests/test_chaos_serve.py``: the chaos schedules (the hypothesis sweep
  as a fixed list of seeds and schedules), and the three serving fault
  sites at their visits, ``primary.crash.midwave`` among them.

Each case keeps its JAX test's own assertions, so a case that compares the
server with ``db.query`` does so within the package it drives.  Query and
write ids are ``uuid4``: results are recorded in submission order.  The
fake clock advances by one tick at every read of the serve module's clock
(so a zero TTL expires and wall times are counts of reads) and by the
requested seconds at every sleep; the planner's deadline check and the
fault sites' stalls read it without a tick.

``tests/fixtures/torch_serve/make_fixture.py`` runs them through the JAX
package and records the results; the port's tests run them through the
port and compare.  The script imports neither package.
"""
import collections
import dataclasses
import hashlib
import json

import numpy as np

# tests/test_backend_parity.py::build_db
PARITY_CFG = dict(n_shards=4, cap_v=128, cap_e=1024, cap_delta=256,
                  cap_idx=256, cap_idx_delta=128, d_f32=2, d_i32=2)
# tests/test_vector.py
D = 4
VEC_CFG = dict(PARITY_CFG, cap_vec=64, d_f32=D)
SEL = {"type": "actor", "id": 323,
       "_in_edge": {"type": "film.actor",
                    "_target": {"type": "film", "select": ["key"]}}}
# the hypothesis sweep of tests/test_chaos_serve.py as fixed draws of its
# strategies (seed in 0..7, one or two distinct sites)
SWEEP = [(0, ("engine.wave",)), (3, ("serve.wave.stall", "tasks.quantum")),
         (5, ("tasks.compaction.handoff",)),
         (7, ("engine.wave", "tasks.compaction.handoff"))]
_SITES = ("engine.wave", "serve.wave.stall", "tasks.quantum",
          "tasks.compaction.handoff")
_ACTION = {"engine.wave": "raise", "serve.wave.stall": "stall",
           "tasks.quantum": "raise", "tasks.compaction.handoff": "race"}


def namespace(**kw):
    """The package handles a case uses: ``GraphDB(cfg)`` (the port binds
    its device), ``StoreConfig``, ``QueryCaps``, the modules ``w``
    (writes: the op records), ``faults``, ``serve`` (``A1Server``),
    ``planner`` and ``planner_shared``, ``ParseError``, ``np_of`` (a store
    field as numpy) and ``make(key, build)``, which returns ``build()``'s
    database (the port's tests may return a copy of one build per key)."""
    import types
    return types.SimpleNamespace(**kw)


# ---------------------------------------------------------------------------
# the fake clock
# ---------------------------------------------------------------------------

class FakeClock:
    """``monotonic`` / ``perf_counter`` advance by ``tick`` a read;
    ``sleep`` advances by its argument."""

    def __init__(self, t0=1000.0, tick=2.0 ** -20):
        self.t, self.tick = float(t0), float(tick)

    def monotonic(self):
        self.t += self.tick
        return self.t

    perf_counter = monotonic

    def sleep(self, s):
        self.t += float(s)


class ClockView:
    """The same clock read without a tick (the planner's deadline check,
    the fault sites' stalls)."""

    def __init__(self, clock):
        self.clock = clock

    def monotonic(self):
        return self.clock.t

    perf_counter = monotonic

    def sleep(self, s):
        self.clock.sleep(s)


# ---------------------------------------------------------------------------
# what a step records
# ---------------------------------------------------------------------------

def _safe(x):
    if isinstance(x, dict):
        return {str(k): _safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_safe(v) for v in x]
    if isinstance(x, np.ndarray):
        if x.dtype == np.float32:
            x = x.view(np.int32)
        return x.tolist()
    if isinstance(x, (np.bool_, bool)):
        return bool(x)
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    return x


def result(r) -> dict:
    """A QueryResult: counts, rows and every flag (f32 rows as bits)."""
    out = {"failed": bool(r.failed)}
    for k in ("counts", "rows_gid", "truncated", "failed_q",
              "shared_ovf_q", "deadline_q"):
        v = getattr(r, k)
        out[k] = None if v is None else _safe(np.asarray(v))
    out["rows"] = None if r.rows is None else {
        f"{k[0]}:{int(k[1])}": _safe(np.asarray(v))
        for k, v in sorted(r.rows.items(), key=lambda kv: str(kv[0]))}
    return out


def digest(m, db) -> str:
    """One SHA-256 over every store field's bytes."""
    h = hashlib.sha256()
    for f in dataclasses.fields(db.store):
        a = np.ascontiguousarray(m.np_of(getattr(db.store, f.name)))
        h.update(f.name.encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def server(m, srv) -> dict:
    """The server's observable state and the planner's cache counters."""
    return {"stats": _safe(srv.stats), "breakers": srv.breaker_state(),
            "latency": _safe(srv.latency_report()),
            "wave_ms": float(srv._wave_ms), "wwave_ms": float(srv._wwave_ms),
            "pins": sorted(int(t) for t in srv.db.active_query_ts),
            "cache": dict(m.planner.CACHE_STATS)}


class Recorder:
    """The steps of one case: ``step(label, **values)``; ``json()``."""

    def __init__(self, m):
        self.m = m
        self.steps = []

    def step(self, label, **kw):
        self.steps.append(json.loads(json.dumps(_safe({"label": label,
                                                       **kw}))))

    def json(self):
        return {"steps": self.steps}


# ---------------------------------------------------------------------------
# stores and documents (tests/test_backend_parity.py, tests/test_vector.py)
# ---------------------------------------------------------------------------

def build_db(m, seed=0, n_dir=3, n_film=10, n_act=12, mutate=True):
    """tests/test_backend_parity.py::build_db through ``m``'s write path
    (``write([t])`` for its deprecated ``commit(t)``)."""
    db = m.GraphDB(m.StoreConfig(**PARITY_CFG))
    db.vertex_type("director")
    db.vertex_type("actor")
    db.vertex_type("film", f_attrs=("gross",), i_attrs=("year", "genre"))
    db.edge_type("film.director")
    db.edge_type("film.actor")
    rng = np.random.default_rng(seed)
    dirs = [db.create_vertex("director", i) for i in range(n_dir)]
    films = [db.create_vertex("film", 100 + i,
                              {"year": 1990 + int(rng.integers(30)),
                               "genre": int(rng.integers(3))})
             for i in range(n_film)]
    acts = [db.create_vertex("actor", 300 + i) for i in range(n_act)]
    t = db.create_transaction()
    for f in films:
        db.create_edge(dirs[int(rng.integers(n_dir))], f, "film.director",
                       txn=t)
        for a in rng.choice(n_act, size=int(rng.integers(1, 6)),
                            replace=False):
            db.create_edge(f, acts[a], "film.actor", txn=t)
    assert db.write([t]).statuses == ["COMMITTED"]
    if mutate:
        db.run_compaction()
        t = db.create_transaction()
        for f in films[: max(1, n_film // 3)]:
            try:
                db.create_edge(f, acts[-1], "film.actor", txn=t)
            except ValueError:
                pass
        db.write([t])
        victim = 300 + int(rng.integers(n_act))
        g, found = db.lookup_vertex("actor", victim)
        if found:
            db.delete_vertex(g)
        if rng.integers(2):
            db.create_vertex("actor", victim)
    return db


def busy_db(m):
    """tests/test_serve.py::busy_db: actor 323 is in ~10 films."""
    return m.make("busy", lambda: build_db(m, seed=30, n_film=20, n_act=24))


def build_vdb(m, seed=0, n_docs=24, n_tags=5):
    """tests/test_vector.py::build_vdb(mutate=False): (db, emb, rng)."""
    db = m.GraphDB(m.StoreConfig(**VEC_CFG))
    fa = tuple(f"f{i}" for i in range(D))
    db.vertex_type("doc", f_attrs=fa, i_attrs=("x", "y"))
    db.vertex_type("tag")
    db.edge_type("doc.tag")
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n_docs, D)).astype(np.float32)
    docs = [db.create_vertex("doc", i,
                             dict(zip(fa, map(float, emb[i])), x=i, y=0))
            for i in range(n_docs)]
    tags = [db.create_vertex("tag", 500 + i) for i in range(n_tags)]
    t = db.create_transaction()
    for i, g in enumerate(docs):
        db.create_edge(g, tags[i % n_tags], "doc.tag", txn=t)
        if i % 3 == 0:
            db.create_edge(g, tags[(i + 1) % n_tags], "doc.tag", txn=t)
    assert db.write([t]).statuses == ["COMMITTED"]
    db.vector_index("doc")
    return db, emb, rng


def vdb(m, seed):
    return m.make(("vdb", seed), lambda: build_vdb(m, seed=seed))


def q_chain(did, genre=None, select="count", direction="out"):
    tgt = {"type": "film",
           "_out_edge": {"type": "film.actor",
                         "_target": {"type": "actor", "select": select}}}
    if genre is not None:
        tgt["filter"] = {"attr": "genre", "op": "==", "value": genre}
    if direction == "out":
        return {"type": "director", "id": did,
                "_out_edge": {"type": "film.director", "_target": tgt}}
    return {"type": "actor", "id": did,
            "_in_edge": {"type": "film.actor",
                         "_target": {"type": "film", "select": select}}}


def q_star(did, aid):
    return {"intersect": [
        {"type": "director", "id": did,
         "_out_edge": {"type": "film.director", "_target": {"type": "film"}}},
        {"type": "actor", "id": aid,
         "_in_edge": {"type": "film.actor", "_target": {"type": "film"}}}],
        "select": "count"}


def q_near(vec, k=4, select=("key",), hop=False):
    q = {"nearest": {"type": "doc", "vector": [float(x) for x in vec],
                     "k": k}}
    if hop:
        q["_out_edge"] = {"type": "doc.tag",
                          "_target": {"type": "tag", "select": "count"}}
    elif select == "count":
        q["select"] = "count"
    else:
        q["select"] = list(select)
    return q


def caps(m, frontier=128, expand=512, results=8, **kw):
    return m.QueryCaps(frontier=frontier, expand=expand, results=results,
                       **kw)


def vcaps(m):
    return caps(m, results=16)


def full_rows(m, db, sel):
    res = db.query([sel], caps=caps(m, results=64))
    return sorted(int(x) for x in res.rows_gid[0] if x >= 0)


def _page_all(srv, token, got, between=None, limit=50):
    for _ in range(limit):
        if token is None:
            break
        if between is not None:
            between()
        page, token = srv.next_page(token)
        got.extend(int(x) for x in page)
    return token


# ---------------------------------------------------------------------------
# tests/test_serve.py
# ---------------------------------------------------------------------------

def case_pages_past_results_cap_by_joining_batches(m, rec, clock):
    db = busy_db(m)
    want = full_rows(m, db, SEL)
    assert len(want) > 4
    srv = m.serve.A1Server(db, caps=caps(m, results=4), page_size=2)
    page, token = srv.select_paged(SEL)
    got = [int(x) for x in page]
    rec.step("first_page", page=got, token=token is not None,
             **server(m, srv))
    res = []
    token = _page_all(srv, token, got, between=lambda: res.append(result(
        srv.execute([q_chain(0), q_star(0, 301)], qclass="Q1"))))
    assert token is None
    assert sorted(got) == want
    assert srv.stats["continuation_joins"] >= 1
    assert not db.active_query_ts
    rec.step("paged", want=want, got=got, traffic=res, **server(m, srv))


def case_pages_flush_without_traffic(m, rec, clock):
    db = busy_db(m)
    want = full_rows(m, db, SEL)
    srv = m.serve.A1Server(db, caps=caps(m, results=4), page_size=3)
    page, token = srv.select_paged(SEL)
    got = [int(x) for x in page]
    _page_all(srv, token, got)
    assert sorted(got) == want
    assert srv.stats["continuation_flushes"] >= 1
    assert not db.active_query_ts
    rec.step("paged", want=want, got=got, **server(m, srv))


def case_pages_past_server_frontier_via_hedge(m, rec, clock):
    db = busy_db(m)
    want = full_rows(m, db, SEL)
    c = caps(m, frontier=8, results=4)
    srv = m.serve.A1Server(db, caps=c, page_size=2)
    page, token = srv.select_paged(SEL)
    got = [int(x) for x in page]
    token = _page_all(srv, token, got)
    assert token is None
    assert sorted(got) == want
    assert len(want) > c.frontier
    assert not db.active_query_ts
    rec.step("paged", want=want, got=got, **server(m, srv))


def case_continuation_reads_its_pinned_snapshot(m, rec, clock):
    db = busy_db(m)
    want = full_rows(m, db, SEL)
    srv = m.serve.A1Server(db, caps=caps(m, results=4), page_size=2)
    page, token = srv.select_paged(SEL)
    got = [int(x) for x in page]
    for k in range(100, 103):
        g, found = db.lookup_vertex("film", k)
        if found:
            db.delete_vertex(g)
    db.run_compaction()
    rec.step("deleted", digest=digest(m, db), **server(m, srv))
    _page_all(srv, token, got)
    assert sorted(got) == want
    assert not db.active_query_ts
    rec.step("paged", want=want, got=got, **server(m, srv))


def case_failed_select_paged_releases_pin(m, rec, clock):
    db = busy_db(m)
    srv = m.serve.A1Server(db, caps=caps(m, results=4))
    errs = []
    try:
        srv.select_paged({"type": "actor"})
        raise AssertionError("a document without an id should not parse")
    except m.ParseError as e:
        errs.append(str(e))
    assert not db.active_query_ts
    try:
        srv.select_paged(q_chain(0))
        raise AssertionError("a count query has no rows to page")
    except ValueError as e:
        errs.append(str(e))
    assert not db.active_query_ts
    rec.step("raised", errors=errs, **server(m, srv))


def case_expired_token_releases_pin(m, rec, clock):
    db = busy_db(m)
    srv = m.serve.A1Server(db, caps=caps(m, results=4), page_size=2,
                           continuation_ttl=0.0)
    page, token = srv.select_paged(SEL)
    assert token is not None and db.active_query_ts
    rec.step("token", page=page, **server(m, srv))
    try:
        srv.next_page(token)
        raise AssertionError("expired token should raise")
    except KeyError as e:
        err = str(e)
    assert not db.active_query_ts
    rec.step("expired", error=err, **server(m, srv))


def case_hedged_retry_scales_cap_hints(m, rec, clock):
    db = busy_db(m)
    srv = m.serve.A1Server(db, caps=caps(m, frontier=512, expand=2048,
                                         results=16))
    hinted = {**q_chain(0), "hints": {"frontier": 64, "expand": 8}}
    res = srv.execute([hinted, q_chain(1)], qclass="hinted")
    assert srv.stats["hedged"] == 1
    assert not res.failed_q[0]
    solo = db.query([q_chain(0)], caps=caps(m, frontier=256, expand=32,
                                            results=16))
    assert res.counts[0] == solo.counts[0]
    rec.step("hedged", res=result(res), solo=result(solo), **server(m, srv))


def case_hedged_retry_patches_only_failed_queries(m, rec, clock):
    db = busy_db(m)
    srv = m.serve.A1Server(db, caps=caps(m, frontier=16, expand=2,
                                         results=4))
    batch = [q_chain(0), q_chain(999), q_star(0, 301)]
    res = srv.execute(batch, qclass="mixed")
    assert srv.stats["hedged"] == 1
    solos = []
    for i, q in enumerate(batch):
        solo = db.query([q], caps=caps(m, frontier=64, expand=8, results=4))
        solos.append(result(solo))
        if not solo.failed:
            assert res.counts[i] == solo.counts[0], i
    rec.step("hedged", res=result(res), solos=solos, **server(m, srv))


def case_cursor_refills_are_page_sized(m, rec, clock):
    db = busy_db(m)
    want = full_rows(m, db, SEL)
    srv = m.serve.A1Server(db, caps=caps(m, results=4), page_size=2)
    page, token = srv.select_paged(SEL)
    got = [int(x) for x in page]
    m_after_first = None
    for _ in range(50):
        if token is None:
            break
        page, token = srv.next_page(token)
        got.extend(int(x) for x in page)
        if m_after_first is None and srv.stats["cursor_refills"] >= 2:
            m_after_first = m.planner.CACHE_STATS["misses"]
    assert token is None
    assert sorted(got) == want
    assert srv.stats["cursor_refills"] >= 2
    assert m.planner.CACHE_STATS["misses"] == m_after_first
    rec.step("paged", want=want, got=got, misses_after_first=m_after_first,
             **server(m, srv))


def case_cursor_refill_falls_back_when_hints_pinned(m, rec, clock):
    db = busy_db(m)
    hinted = {**SEL, "hints": {"frontier": 128}}
    srv = m.serve.A1Server(db, caps=caps(m, results=4), page_size=2)
    want = full_rows(m, db, hinted)
    page, token = srv.select_paged(hinted)
    got = [int(x) for x in page]
    _page_all(srv, token, got)
    assert sorted(got) == want
    assert srv.stats["cursor_refills"] == 0
    assert not db.active_query_ts
    rec.step("paged", want=want, got=got, **server(m, srv))


def case_nearest_select_paged_round_trip(m, rec, clock):
    db, emb, rng = vdb(m, 55)
    vec = rng.normal(size=D)
    doc = q_near(vec, k=8)
    full = db.query([doc], caps=vcaps(m))
    want = sorted(int(x) for x in full.rows_gid[0] if x >= 0)
    assert len(want) == 8
    srv = m.serve.A1Server(db, caps=caps(m, results=4), page_size=2)
    page, token = srv.select_paged(doc)
    got = [int(x) for x in page]
    moved = False
    for _ in range(50):
        if token is None:
            break
        if not moved:
            fa = tuple(f"f{i}" for i in range(D))
            g, found = db.lookup_vertex("doc", 0)
            assert found
            db.update_vertex(g, "doc", dict(zip(fa, map(float, vec))))
            moved = True
        page, token = srv.next_page(token)
        got.extend(int(x) for x in page)
    assert token is None
    assert sorted(got) == want
    assert not db.active_query_ts
    rec.step("paged", want=want, got=got, digest=digest(m, db),
             **server(m, srv))


def case_serve_stats_expose_planner_counters(m, rec, clock):
    db = busy_db(m)
    c = caps(m, results=16)
    srv = m.serve.A1Server(db, caps=c, budget="shared")
    a = srv.execute([q_chain(0), q_star(0, 301)], qclass="Q1")
    b = srv.execute([q_chain(0), q_star(0, 301)], qclass="Q1")
    assert srv.stats["peak_frontier_bytes_shared"] > 0
    assert 0.0 < srv.stats["planner_cache_hit_rate"] <= 1.0
    res = srv.execute([q_chain(1)], qclass="Q1")
    solo = db.query([q_chain(1)], caps=c)
    assert res.counts[0] == solo.counts[0]
    rec.step("served", a=result(a), b=result(b), res=result(res),
             solo=result(solo), **server(m, srv))


# ---------------------------------------------------------------------------
# tests/test_serve_admission.py
# ---------------------------------------------------------------------------

def mk_server(m, db=None, **kw):
    db = db or busy_db(m)
    kw.setdefault("caps", caps(m))
    return m.serve.A1Server(db, **kw), db


def case_read_wave_closes_at_max_batch(m, rec, clock):
    srv, db = mk_server(m, read_batch=3, read_deadline_ms=1e9)
    qids = [srv.submit_query(q_chain(i % 3), qclass=f"c{i % 2}")
            for i in range(3)]
    rows = [srv.query_result(q) for q in qids]
    assert all(r is not None and r["status"] == "OK" for r in rows)
    for i, r in enumerate(rows):
        solo = db.query([q_chain(i % 3)], caps=caps(m))
        assert r["count"] == int(solo.counts[0])
    assert srv.stats["admitted"] == srv.stats["served"] == 3
    assert srv.stats["read_waves"] == 1
    assert not db.active_query_ts
    rec.step("served", rows=rows, **server(m, srv))


def case_read_wave_closes_at_deadline_via_poll(m, rec, clock):
    srv, db = mk_server(m, read_batch=64, read_deadline_ms=0.0)
    qid = srv.submit_query(q_chain(0))
    r = srv.query_result(qid)
    assert r["status"] == "OK"
    rec.step("served", row=r, **server(m, srv))


def case_write_deadline_flushes_via_task_pump_with_no_queries(m, rec, clock):
    srv, db = mk_server(m, write_batch=100, write_deadline_ms=0.0)
    f, _ = db.lookup_vertex("film", 100)
    wid = srv.submit_write([m.w.UpdateVertex(f, "film", {"gross": 5.0})])
    assert srv._write_q
    srv.tasks.pump(1)
    w = srv.write_result(wid)
    assert w["status"] == "COMMITTED"
    assert db.get_vertex("film", 100)["gross"] == 5.0
    rec.step("flushed", write=w, digest=digest(m, db), **server(m, srv))


def case_shed_then_retry_round_trip(m, rec, clock):
    srv, db = mk_server(m, read_batch=8, read_deadline_ms=1e9,
                        shed_watermark=2)
    keep = [srv.submit_query(q_chain(i % 3)) for i in range(2)]
    shed = srv.submit_query(q_chain(2))
    r = srv.query_result(shed)
    assert r["status"] == "SHED" and r["reason"] == "overload"
    assert r["retry_after_ms"] > 0
    assert srv.stats["sheds"] == 1
    rec.step("shed", row=r, **server(m, srv))
    srv.flush_queries()
    retry = srv.submit_query(q_chain(2))
    srv.flush_queries()
    r2 = srv.query_result(retry)
    solo = db.query([q_chain(2)], caps=caps(m))
    assert r2["status"] == "OK" and r2["count"] == int(solo.counts[0])
    kept = [srv.query_result(q) for q in keep]
    assert all(k["status"] == "OK" for k in kept)
    rec.step("retried", row=r2, kept=kept, **server(m, srv))


def case_tenant_inflight_cap_sheds_only_that_tenant(m, rec, clock):
    srv, db = mk_server(m, read_batch=64, read_deadline_ms=1e9,
                        shed_watermark=64, tenant_inflight=2)
    a1 = srv.submit_query(q_chain(0), tenant="a")
    a2 = srv.submit_query(q_chain(1), tenant="a")
    a3 = srv.submit_query(q_chain(2), tenant="a")
    b1 = srv.submit_query(q_chain(0), tenant="b")
    r3 = srv.query_result(a3)
    assert r3["status"] == "SHED" and r3["reason"] == "tenant-cap:a"
    assert srv.stats["tenant_sheds"] == 1
    srv.flush_queries()
    a4 = srv.submit_query(q_chain(2), tenant="a")
    srv.flush_queries()
    r4 = srv.query_result(a4)
    assert r4["status"] == "OK"
    rows = [srv.query_result(q) for q in (a1, a2, b1)]
    assert all(r["status"] == "OK" for r in rows)
    rec.step("served", shed=r3, a4=r4, rows=rows, **server(m, srv))


def case_rejected_doc_never_reaches_a_wave(m, rec, clock):
    srv, db = mk_server(m, read_batch=2, read_deadline_ms=1e9)
    bad = srv.submit_query({"type": "actor"})
    r = srv.query_result(bad)
    assert r["status"] == "REJECTED" and srv.stats["read_rejects"] == 1
    good = srv.submit_query(q_chain(0))
    srv.flush_queries()
    g = srv.query_result(good)
    assert g["status"] == "OK"
    assert srv.stats["read_waves"] == 1
    rec.step("served", rejected=r, good=g, **server(m, srv))


def case_every_admitted_id_terminates_in_exactly_one_result(m, rec, clock):
    srv, db = mk_server(m, read_batch=4, read_deadline_ms=1e9,
                        shed_watermark=6, tenant_inflight=3)
    qids = [srv.submit_query(q_chain(i % 3), tenant=f"t{i % 2}")
            for i in range(12)]
    srv.flush_queries()
    rows = [srv.query_result(q) for q in qids]
    assert all(r is not None for r in rows)
    statuses = [r["status"] for r in rows]
    assert statuses.count("OK") == srv.stats["served"] == \
        srv.stats["admitted"]
    assert statuses.count("SHED") == srv.stats["sheds"]
    assert len(statuses) == statuses.count("OK") + statuses.count("SHED")
    assert all(srv.query_result(q) is None for q in qids)
    assert not db.active_query_ts
    rec.step("served", rows=rows, **server(m, srv))


def case_refill_joins_wave_after_tenant_hit_inflight_cap(m, rec, clock):
    srv, db = mk_server(m, caps=caps(m, results=4), page_size=2,
                        read_batch=2, read_deadline_ms=1e9,
                        tenant_inflight=1)
    want = full_rows(m, db, SEL)
    page, token = srv.select_paged(SEL)
    got = [int(x) for x in page]
    blocked = srv.submit_query(q_chain(0), tenant="a")
    assert srv.query_result(blocked) is None
    shed = srv.submit_query(q_chain(1), tenant="a")
    rs = srv.query_result(shed)
    assert rs["status"] == "SHED"
    bs = []
    for _ in range(50):
        if token is None:
            break
        page, token = srv.next_page(token)
        got.extend(int(x) for x in page)
        bs.append(srv.submit_query(q_chain(2), tenant="b"))
        srv.flush_queries()
    assert token is None
    assert sorted(got) == want
    assert srv.stats["continuation_joins"] >= 1
    rb = srv.query_result(blocked)
    assert rb["status"] == "OK"
    assert not db.active_query_ts
    rec.step("paged", want=want, got=got, shed=rs, blocked=rb,
             b=[srv.query_result(q) for q in bs], **server(m, srv))


def case_wave_ewma_seeds_from_first_measurement(m, rec, clock):
    srv, db = mk_server(m, read_batch=1, read_deadline_ms=1e9)
    assert srv._wave_ms == 1e9 and not srv._wave_seeded
    srv.submit_query(q_chain(0))
    assert srv._wave_seeded
    assert srv._wave_ms < 1e6
    rec.step("seeded", **server(m, srv))


def case_wave_ewma_decays_on_idle_pump_ticks(m, rec, clock):
    srv, db = mk_server(m, read_batch=64, read_deadline_ms=5.0,
                        shed_watermark=1)
    srv._wave_ms, srv._wave_seeded = 5000.0, True
    seen = [srv._wave_ms]
    for _ in range(40):
        assert srv.pump() == 0
        seen.append(srv._wave_ms)
    assert all(b < a for a, b in zip(seen, seen[1:]))
    assert seen[-1] < 15.0
    srv.submit_query(q_chain(0))
    shed = srv.submit_query(q_chain(1))
    r = srv.query_result(shed)
    assert r["status"] == "SHED" and r["retry_after_ms"] < 100.0
    rec.step("decayed", seen=seen, shed=r, **server(m, srv))


def case_nearest_doc_admitted_served_and_validated(m, rec, clock):
    db, emb, rng = vdb(m, 60)
    srv = m.serve.A1Server(db, caps=vcaps(m), read_batch=8,
                           read_deadline_ms=1e9)
    vec = rng.normal(size=D)
    good = srv.submit_query(q_near(vec, k=4, hop=True))
    bad = srv.submit_query({"nearest": {"type": "doc",
                                        "vector": [0.0] * (D + 1), "k": 2},
                            "select": "count"})
    rb = srv.query_result(bad)
    assert rb["status"] == "REJECTED"
    srv.flush_queries()
    r = srv.query_result(good)
    solo = db.query([q_near(vec, k=4, hop=True)], caps=vcaps(m))
    assert r["status"] == "OK" and r["count"] == int(solo.counts[0])
    assert srv.stats["read_waves"] == 1
    assert not db.active_query_ts
    rec.step("served", good=r, bad=rb, solo=result(solo), **server(m, srv))


def case_breaker_opens_under_sustained_overflow_then_recovers(m, rec, clock):
    db = busy_db(m)
    srv = m.serve.A1Server(db, caps=caps(m, frontier=64, expand=1),
                           breaker_window=4, breaker_threshold=0.5,
                           breaker_cooldown=2)
    hot = q_chain(323, direction="in")
    out = [result(srv.execute([hot], qclass="hot")) for _ in range(4)]
    assert srv.breaker_state()["hot"] == "open"
    assert srv.stats["breaker_opens"] == 1
    rec.step("opened", res=out, **server(m, srv))
    hedged_before = srv.stats["hedged"]
    srv.execute([hot], qclass="hot")
    srv.execute([hot], qclass="hot")
    assert srv.stats["hedged"] == hedged_before
    assert srv.stats["breaker_skips"] == 2
    rec.step("skipped", **server(m, srv))
    srv.execute([hot], qclass="hot")
    assert srv.stats["hedged"] == hedged_before + 1
    assert srv.breaker_state()["hot"] == "open"
    rec.step("probed", **server(m, srv))
    srv.execute([q_chain(999)], qclass="hot")
    assert srv.breaker_state()["hot"] == "closed"
    assert "cool" not in srv.breakers
    srv.execute([q_chain(999)], qclass="cool")
    assert srv.breaker_state()["cool"] == "closed"
    rec.step("closed", **server(m, srv))


def case_auto_budget_selects_shared_at_knee(m, rec, clock):
    db = busy_db(m)
    calls = []
    orig = m.planner_shared.compile_batch_shared

    def spy(*a, **kw):
        calls.append(len(a[1]))
        return orig(*a, **kw)
    m.planner_shared.compile_batch_shared = spy
    try:
        srv = m.serve.A1Server(db, caps=caps(m), shared_knee=4)
        below = [q_chain(i % 3) for i in range(3)]
        b = srv.execute(below, qclass="b")
        assert calls == []
        at = [q_chain(i % 3) for i in range(4)]
        res = srv.execute(at, qclass="b")
        assert calls and calls[0] == 4
    finally:
        m.planner_shared.compile_batch_shared = orig
    pq = db.query(at, caps=caps(m), fused=True)
    np.testing.assert_array_equal(res.counts, pq.counts)
    rec.step("served", calls=calls, below=result(b), at=result(res),
             per_query=result(pq), **server(m, srv))


def case_per_query_flags_subset_of_shared_flags_across_fallback(m, rec,
                                                                clock):
    db = busy_db(m)
    c = caps(m, frontier=64, shared_frontier=8)
    batch = [q_chain(i % 3) for i in range(8)]
    pq = db.query(batch, caps=c, fused=True)
    sh = db.query(batch, caps=c, fused=True, budget="shared")
    assert not pq.failed
    assert sh.failed
    assert np.all(~pq.failed_q | sh.failed_q)
    assert np.all(~sh.shared_ovf_q | sh.failed_q)
    np.testing.assert_array_equal(sh.shared_ovf_q, sh.failed_q)
    assert not pq.shared_ovf_q.any()
    srv_sh = m.serve.A1Server(db, caps=c, budget="shared")
    srv_pq = m.serve.A1Server(db, caps=c, budget="per-query")
    res_sh = srv_sh.execute(batch, qclass="q")
    res_pq = srv_pq.execute(batch, qclass="q")
    assert not res_sh.failed and not res_pq.failed
    np.testing.assert_array_equal(res_sh.counts, res_pq.counts)
    assert srv_sh.stats["hedged"] == 1
    assert srv_sh.stats["shared_ovf_queries"] >= 8
    rec.step("served", pq=result(pq), sh=result(sh), res_sh=result(res_sh),
             res_pq=result(res_pq), srv_sh=server(m, srv_sh),
             srv_pq=server(m, srv_pq))


def case_never_polled_results_age_out_and_are_counted(m, rec, clock):
    srv, db = mk_server(m, write_batch=1, read_batch=1)
    srv.submit_write([m.w.CreateVertex("actor", 777)])
    srv.submit_query(q_chain(0))
    assert srv._write_results and srv._read_results
    rec.step("stored", writes=list(srv._write_results.values()),
             reads=list(srv._read_results.values()), **server(m, srv))
    for exp in (srv._write_exp, srv._read_exp):
        for k in exp:
            exp[k] = 0.0
    srv.pump()
    assert not srv._write_results and not srv._write_exp
    assert not srv._read_results and not srv._read_exp
    assert srv.stats["dropped_write_results"] == 1
    assert srv.stats["dropped_read_results"] == 1
    rec.step("swept", digest=digest(m, db), **server(m, srv))


def case_polled_results_do_not_leak_expiry_entries(m, rec, clock):
    srv, db = mk_server(m, write_batch=1, read_batch=1)
    wid = srv.submit_write([m.w.CreateVertex("actor", 778)])
    qid = srv.submit_query(q_chain(0))
    w = srv.write_result(wid)
    r = srv.query_result(qid)
    assert w["status"] == "COMMITTED"
    assert r["status"] == "OK"
    assert not srv._write_exp and not srv._read_exp
    assert srv.stats["dropped_write_results"] == 0
    assert srv.stats["dropped_read_results"] == 0
    rec.step("polled", write=w, read=r, digest=digest(m, db),
             **server(m, srv))


def case_zero_budget_short_circuits_at_admission(m, rec, clock):
    srv, db = mk_server(m)
    qid = srv.submit_query(q_chain(0), budget_ms=0.0)
    row = srv.query_result(qid)
    assert row == {"status": "OK", "failed": False, "rows": [],
                   "truncated": True, "budget_exhausted": True}
    assert srv.stats["budget_exhausted"] == 1
    assert srv.stats["admitted"] == 0 and srv.stats["read_waves"] == 0
    rec.step("short_circuit", row=row, **server(m, srv))


def case_queue_exhausted_budget_truncates_at_wave_close(m, rec, clock):
    srv, db = mk_server(m, read_batch=2)
    q_small = srv.submit_query(q_chain(0), budget_ms=1.0)
    clock.sleep(0.005)
    q_big = srv.submit_query(q_chain(1), budget_ms=1e9)
    small = srv.query_result(q_small)
    big = srv.query_result(q_big)
    assert small["budget_exhausted"] and small["truncated"]
    assert not small["failed"] and small["rows"] == []
    solo = db.query([q_chain(1)], caps=caps(m))
    assert big["status"] == "OK" and big["count"] == int(solo.counts[0])
    assert srv.stats["budget_exhausted"] == 1
    assert srv.stats["served"] == 1 and srv.stats["read_waves"] == 1
    rec.step("served", small=small, big=big, **server(m, srv))


def case_wave_close_derives_from_budget_not_constant(m, rec, clock):
    srv, db = mk_server(m, budget_ms=50.0, read_batch=64)
    assert srv.read_deadline_ms is None and srv._default_budget_ms == 50.0
    qid = srv.submit_query(q_chain(0))
    clock.sleep(0.010)
    row = srv.query_result(qid)
    assert row is not None and row["status"] == "OK"
    assert "budget_exhausted" not in row
    assert srv.stats["read_waves"] == 1
    rec.step("served", row=row, **server(m, srv))


def case_fixed_deadline_servers_keep_legacy_behavior(m, rec, clock):
    srv, db = mk_server(m, read_batch=1, read_deadline_ms=1e9)
    assert srv._default_budget_ms is None
    qid = srv.submit_query(q_chain(0))
    row = srv.query_result(qid)
    assert row["status"] == "OK" and "budget_exhausted" not in row
    assert srv.stats["budget_exhausted"] == 0
    rec.step("served", row=row, **server(m, srv))


def case_engine_deadline_truncates_without_failure(m, rec, clock):
    db = busy_db(m)
    res = db.query([q_chain(0), q_chain(0, select=["key"])], caps=caps(m),
                   deadline=clock.t - 1.0)
    assert res.deadline_q is not None and res.deadline_q.all()
    assert not res.failed and not res.failed_q.any()
    assert res.truncated[1]
    rec.step("truncated", res=result(res),
             cache=dict(m.planner.CACHE_STATS))


def case_engine_deadline_requires_fused_path(m, rec, clock):
    db = busy_db(m)
    try:
        db.query([q_chain(0)], caps=caps(m), fused=False,
                 deadline=clock.t + 1.0)
        raise AssertionError("fused=False with a deadline should raise")
    except ValueError as e:
        err = str(e)
    assert "fused" in err
    rec.step("raised", error=err)


def case_hedge_denied_once_budget_exhausted(m, rec, clock):
    db = busy_db(m)
    srv = m.serve.A1Server(db, caps=caps(m, frontier=16, expand=2,
                                         results=4))
    batch = [q_chain(0), q_chain(999), q_star(0, 301)]
    warm = srv.execute(batch)
    hedged0 = srv.stats["hedged"]
    real_run = srv._run

    def straggler(queries, c, read_ts, **kw):
        res = real_run(queries, c, read_ts, **kw)
        clock.sleep(0.05)
        return res

    srv._run = straggler
    res = srv.execute(batch, deadline=clock.t + 0.02)
    assert res.failed
    assert srv.stats["budget_denied_hedges"] == 1
    assert srv.stats["hedged"] == hedged0
    assert srv.stats["fastfails"] >= 1
    rec.step("denied", warm=result(warm), res=result(res), **server(m, srv))


def case_budget_spend_histograms_populate(m, rec, clock):
    srv, db = mk_server(m, read_batch=2)
    qids = [srv.submit_query(q_chain(i)) for i in range(2)]
    hist = srv.stats["budget_spend_ms"]
    assert sum(hist["queue"]) == 2 and sum(hist["wave"]) == 2
    assert sum(hist["hedge"]) == 0
    rec.step("spent", rows=[srv.query_result(q) for q in qids],
             **server(m, srv))


def case_retry_after_folds_queued_write_backlog(m, rec, clock):
    srv, db = mk_server(m, read_deadline_ms=1e9, write_deadline_ms=7.5,
                        write_batch=1000)
    base = srv._retry_after_ms()
    for i in range(40):
        srv.submit_write([m.w.CreateVertex("actor", 9000 + i)])
    quoted = srv._retry_after_ms()
    assert abs(quoted - (base + 7.5)) <= 1e-3
    rec.step("quoted", base=base, quoted=quoted, queued=len(srv._write_q),
             **server(m, srv))


def case_shed_quote_reflects_write_backlog_end_to_end(m, rec, clock):
    srv, db = mk_server(m, read_deadline_ms=1e9, write_deadline_ms=7.5,
                        write_batch=1000, shed_watermark=1, read_batch=64)
    srv.submit_query(q_chain(0))
    shed_dry = srv.query_result(srv.submit_query(q_chain(1)))
    for i in range(10):
        srv.submit_write([m.w.CreateVertex("actor", 9100 + i)])
    shed_wet = srv.query_result(srv.submit_query(q_chain(2)))
    assert shed_dry["status"] == shed_wet["status"] == "SHED"
    assert abs(shed_wet["retry_after_ms"]
               - (shed_dry["retry_after_ms"] + 7.5)) <= 1e-3
    rec.step("quoted", dry=shed_dry, wet=shed_wet, **server(m, srv))


# ---------------------------------------------------------------------------
# tests/test_chaos_serve.py
# ---------------------------------------------------------------------------

REF = [q_chain(0), q_chain(1), q_chain(2, genre=1), q_star(0, 301),
       dict(SEL)]


def chaos_server(m, db, **kw):
    kw.setdefault("caps", caps(m))
    kw.setdefault("read_batch", 5)
    kw.setdefault("read_deadline_ms", 1e9)
    kw.setdefault("write_batch", 1)
    kw.setdefault("write_deadline_ms", 1e9)
    return m.serve.A1Server(db, **kw)


def snap(m, db, ts):
    return db.query(REF, caps=caps(m), read_ts=ts, fused=True)


def assert_bit_identical(a, b):
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.rows_gid, b.rows_gid)
    np.testing.assert_array_equal(a.truncated, b.truncated)
    np.testing.assert_array_equal(a.failed_q, b.failed_q)
    for k in (a.rows or {}):
        np.testing.assert_array_equal(a.rows[k], b.rows[k])


def run_workload(m, db, srv, rounds=6):
    qids, wids = [], []
    for r in range(rounds):
        for j in range(5):
            qids.append(srv.submit_query(q_chain(j % 3), tenant=f"t{j % 3}",
                                         qclass="chaos"))
        f, found = db.lookup_vertex("film", 100 + r)
        ops = [m.w.CreateVertex("actor", 1000 + r)]
        if found:
            ops.append(m.w.UpdateVertex(f, "film", {"gross": float(r)}))
        wids.append(srv.submit_write(ops))
        srv.pump()
    srv.flush_queries()
    srv.flush_writes()
    for _ in range(20):
        srv.tasks.pump(1)
    return qids, wids


def assert_serving_invariants(srv, qids, wids):
    """No admitted request terminates silently; accounting partitions.
    Returns the read and the write results in submission order."""
    rows = [srv.query_result(q) for q in qids]
    assert all(r is not None for r in rows)
    by = collections.Counter(r["status"] for r in rows)
    assert by.get("OK", 0) == srv.stats["served"]
    assert by.get("ABORTED", 0) == srv.stats["aborted_faults"]
    assert by.get("SHED", 0) == srv.stats["sheds"]
    assert srv.stats["admitted"] == (srv.stats["served"]
                                     + srv.stats["aborted_faults"])
    writes = [srv.write_result(w) for w in wids]
    assert all(w is not None for w in writes)
    assert not srv._read_q and not srv._write_q
    return rows, writes


def _pinned(db):
    ts0 = db.snapshot_ts()
    db.active_query_ts.append(ts0)
    return ts0


def _chaos_step(m, rec, label, db, srv, rows, writes, inj=None, **kw):
    rec.step(label, rows=rows, writes=writes, digest=digest(m, db),
             db_stats={k: int(v) for k, v in db.stats.items()},
             epochs={k: int(v) for k, v in db.epochs.items()},
             completed=list(srv.tasks.completed),
             fault_restarts=int(srv.tasks.fault_restarts),
             fired=None if inj is None else [list(f) for f in inj.fired],
             **kw, **server(m, srv))


def _chaos(m, rec, clock, arm, *, watermark=None, check=None):
    """One schedule: a pinned reference batch, the workload under the
    injector ``arm(db)`` returns, the invariants, the re-read."""
    db = busy_db(m)
    srv = chaos_server(m, db)
    if watermark is not None:
        db.compaction_watermark = watermark
    ts0 = _pinned(db)
    try:
        base = snap(m, db, ts0)
        inj = arm(db)
        db.faults = inj
        qids, wids = run_workload(m, db, srv)
        rows, writes = assert_serving_invariants(srv, qids, wids)
        db.faults = None
        after = snap(m, db, ts0)
        assert_bit_identical(base, after)
        if check is not None:
            check(srv, db, inj, rows)
        _chaos_step(m, rec, "workload", db, srv, rows, writes, inj,
                    snap=result(after))
    finally:
        db.active_query_ts.remove(ts0)
        db.faults = None
    assert db.active_query_ts == []


def case_chaos_control_no_faults(m, rec, clock):
    def check(srv, db, inj, rows):
        assert all(r["status"] == "OK" for r in rows)
        assert srv.stats["wave_faults"] == 0
    _chaos(m, rec, clock, lambda db: None, check=check)


def case_injected_wave_crash_is_retried_transparently(m, rec, clock):
    def check(srv, db, inj, rows):
        assert srv.stats["wave_faults"] == 1
        assert srv.stats["aborted_faults"] == 0
        assert all(r["status"] == "OK" for r in rows)
    _chaos(m, rec, clock, lambda db: m.faults.FaultInjector(seed=0).inject(
        "engine.wave", action="raise", times=(0,)), check=check)


def case_wave_crash_storm_aborts_with_attribution(m, rec, clock):
    def check(srv, db, inj, rows):
        assert srv.stats["wave_faults"] == 2
        assert srv.stats["aborted_faults"] == 5
        aborted = [r for r in rows if r["status"] == "ABORTED"]
        assert len(aborted) == 5
        assert all(r["reason"] == "fault:engine.wave" for r in aborted)
    _chaos(m, rec, clock, lambda db: m.faults.FaultInjector(seed=0).inject(
        "engine.wave", action="raise", prob=1.0, max_fires=2), check=check)


def case_slow_wave_stalls_do_not_break_accounting(m, rec, clock):
    def check(srv, db, inj, rows):
        assert all(r["status"] == "OK" for r in rows)
        assert [a for (s, v, a) in inj.fired] == ["stall"] * 3
    _chaos(m, rec, clock, lambda db: m.faults.FaultInjector(seed=0).inject(
        "serve.wave.stall", action="stall", stall_s=0.002, times=(0, 1, 2)),
        check=check)


def case_stale_continuation_storm_restarts_pagination(m, rec, clock):
    db = busy_db(m)
    want = full_rows(m, db, SEL)
    srv = m.serve.A1Server(db, caps=caps(m, results=4), page_size=2)
    inj = db.faults = m.faults.FaultInjector(seed=0).inject(
        "serve.continuation.stale", action="race", times=(2,))
    try:
        page, token = srv.select_paged(SEL)
        got, restarts = [int(x) for x in page], 0
        for _ in range(100):
            if token is None:
                break
            srv.execute([q_chain(0)], qclass="bg")
            try:
                page, token = srv.next_page(token)
                got.extend(int(x) for x in page)
            except KeyError:
                restarts += 1
                page, token = srv.select_paged(SEL)
                got = [int(x) for x in page]
        assert token is None
        assert sorted(got) == want
        assert restarts >= 1
        assert srv.stats["continuations"] >= 2
    finally:
        db.faults = None
    assert db.active_query_ts == []
    rec.step("paged", want=want, got=got, restarts=restarts,
             fired=[list(f) for f in inj.fired],
             visits=inj.visits("serve.continuation.stale"), **server(m, srv))


def case_compaction_handoff_race_rebuilds_and_crashed_worker_restarts(
        m, rec, clock):
    def arm(db):
        return (m.faults.FaultInjector(seed=3)
                .inject("tasks.compaction.handoff", action="race",
                        prob=1.0, max_fires=2)
                .inject("tasks.quantum", action="raise", times=(1, 4)))

    def check(srv, db, inj, rows):
        assert srv.tasks.fault_restarts >= 1
        assert db.stats["compaction_rebuilds"] >= 1
        assert inj.visits("tasks.compaction.handoff") >= 1
    _chaos(m, rec, clock, arm, watermark=0.0, check=check)


def case_fault_schedules_replay_deterministically(m, rec, clock):
    def run_once():
        db = busy_db(m)
        srv = chaos_server(m, db)
        inj = (m.faults.FaultInjector(seed=7)
               .inject("engine.wave", action="raise", prob=0.3)
               .inject("serve.wave.stall", action="stall",
                       stall_s=0.001, prob=0.5))
        db.faults = inj
        qids, wids = run_workload(m, db, srv)
        rows, writes = assert_serving_invariants(srv, qids, wids)
        db.faults = None
        _chaos_step(m, rec, "run", db, srv, rows, writes, inj)
        return inj.fired, collections.Counter(r["status"] for r in rows)

    fired_a, stat_a = run_once()
    fired_b, stat_b = run_once()
    assert fired_a == fired_b
    assert stat_a == stat_b
    assert fired_a


def _sweep_case(seed, armed):
    def case(m, rec, clock):
        def arm(db):
            inj = m.faults.FaultInjector(seed=seed)
            for s in armed:
                inj.inject(s, action=_ACTION[s], prob=0.3, stall_s=0.001)
            return inj
        _chaos(m, rec, clock, arm, watermark=0.0)
    return case


def case_serving_fault_sites(m, rec, clock):
    """The three serving sites fire at the visits they are armed for:
    ``serve.wave.stall`` at dispatch, ``serve.continuation.stale`` in the
    sweep, ``primary.crash.midwave`` after the wave committed (its write
    is in the store and in ``applied_rids``, its result never stored)."""
    db = busy_db(m)
    srv = m.serve.A1Server(db, caps=caps(m, results=4), page_size=2,
                           write_batch=1)
    inj = db.faults = (
        m.faults.FaultInjector(seed=1)
        .inject("serve.wave.stall", action="stall", stall_s=0.003,
                times=(1,))
        .inject("serve.continuation.stale", action="race", times=(1,))
        .inject("primary.crash.midwave", action="raise", times=(1,)))
    try:
        page, token = srv.select_paged(SEL)          # stall visit 0, sweep 0
        srv.execute([q_chain(0)], qclass="bg")       # stall 1 fires, sweep 1
        try:
            srv.next_page(token)
            raise AssertionError("the stale storm should expire the token")
        except KeyError:
            pass
        w0 = srv.submit_write([m.w.CreateVertex("actor", 5000)])
        crashed = None
        try:
            srv.submit_write([m.w.CreateVertex("actor", 5001)], wid="rid-1")
        except m.faults.InjectedFault as e:
            crashed = [e.site, e.visit]
    finally:
        db.faults = None
    assert crashed == ["primary.crash.midwave", 1]
    assert srv.write_result("rid-1") is None         # never acked
    assert "rid-1" in db.applied_rids                # but committed
    got = db.get_vertex("actor", 5001)
    assert got is not None
    assert not db.active_query_ts
    rec.step("fired", fired=[list(f) for f in inj.fired],
             visits={s: inj.visits(s) for s in (
                 "serve.wave.stall", "serve.continuation.stale",
                 "primary.crash.midwave", "engine.wave")},
             w0=srv.write_result(w0), crashed=crashed,
             applied=_safe(db.applied_rids["rid-1"]),
             actor=_safe(got), digest=digest(m, db), **server(m, srv))


CASES = {
    # tests/test_serve.py
    "pages_past_results_cap_by_joining_batches":
        case_pages_past_results_cap_by_joining_batches,
    "pages_flush_without_traffic": case_pages_flush_without_traffic,
    "pages_past_server_frontier_via_hedge":
        case_pages_past_server_frontier_via_hedge,
    "continuation_reads_its_pinned_snapshot":
        case_continuation_reads_its_pinned_snapshot,
    "failed_select_paged_releases_pin":
        case_failed_select_paged_releases_pin,
    "expired_token_releases_pin": case_expired_token_releases_pin,
    "hedged_retry_scales_cap_hints": case_hedged_retry_scales_cap_hints,
    "hedged_retry_patches_only_failed_queries":
        case_hedged_retry_patches_only_failed_queries,
    "cursor_refills_are_page_sized": case_cursor_refills_are_page_sized,
    "cursor_refill_falls_back_when_hints_pinned":
        case_cursor_refill_falls_back_when_hints_pinned,
    "nearest_select_paged_round_trip": case_nearest_select_paged_round_trip,
    "serve_stats_expose_planner_counters":
        case_serve_stats_expose_planner_counters,
    # tests/test_serve_admission.py
    "read_wave_closes_at_max_batch": case_read_wave_closes_at_max_batch,
    "read_wave_closes_at_deadline_via_poll":
        case_read_wave_closes_at_deadline_via_poll,
    "write_deadline_flushes_via_task_pump_with_no_queries":
        case_write_deadline_flushes_via_task_pump_with_no_queries,
    "shed_then_retry_round_trip": case_shed_then_retry_round_trip,
    "tenant_inflight_cap_sheds_only_that_tenant":
        case_tenant_inflight_cap_sheds_only_that_tenant,
    "rejected_doc_never_reaches_a_wave":
        case_rejected_doc_never_reaches_a_wave,
    "every_admitted_id_terminates_in_exactly_one_result":
        case_every_admitted_id_terminates_in_exactly_one_result,
    "refill_joins_wave_after_tenant_hit_inflight_cap":
        case_refill_joins_wave_after_tenant_hit_inflight_cap,
    "wave_ewma_seeds_from_first_measurement":
        case_wave_ewma_seeds_from_first_measurement,
    "wave_ewma_decays_on_idle_pump_ticks":
        case_wave_ewma_decays_on_idle_pump_ticks,
    "nearest_doc_admitted_served_and_validated":
        case_nearest_doc_admitted_served_and_validated,
    "breaker_opens_under_sustained_overflow_then_recovers":
        case_breaker_opens_under_sustained_overflow_then_recovers,
    "auto_budget_selects_shared_at_knee":
        case_auto_budget_selects_shared_at_knee,
    "per_query_flags_subset_of_shared_flags_across_fallback":
        case_per_query_flags_subset_of_shared_flags_across_fallback,
    "never_polled_results_age_out_and_are_counted":
        case_never_polled_results_age_out_and_are_counted,
    "polled_results_do_not_leak_expiry_entries":
        case_polled_results_do_not_leak_expiry_entries,
    "zero_budget_short_circuits_at_admission":
        case_zero_budget_short_circuits_at_admission,
    "queue_exhausted_budget_truncates_at_wave_close":
        case_queue_exhausted_budget_truncates_at_wave_close,
    "wave_close_derives_from_budget_not_constant":
        case_wave_close_derives_from_budget_not_constant,
    "fixed_deadline_servers_keep_legacy_behavior":
        case_fixed_deadline_servers_keep_legacy_behavior,
    "engine_deadline_truncates_without_failure":
        case_engine_deadline_truncates_without_failure,
    "engine_deadline_requires_fused_path":
        case_engine_deadline_requires_fused_path,
    "hedge_denied_once_budget_exhausted":
        case_hedge_denied_once_budget_exhausted,
    "budget_spend_histograms_populate": case_budget_spend_histograms_populate,
    "retry_after_folds_queued_write_backlog":
        case_retry_after_folds_queued_write_backlog,
    "shed_quote_reflects_write_backlog_end_to_end":
        case_shed_quote_reflects_write_backlog_end_to_end,
    # tests/test_chaos_serve.py
    "chaos_control_no_faults": case_chaos_control_no_faults,
    "injected_wave_crash_is_retried_transparently":
        case_injected_wave_crash_is_retried_transparently,
    "wave_crash_storm_aborts_with_attribution":
        case_wave_crash_storm_aborts_with_attribution,
    "slow_wave_stalls_do_not_break_accounting":
        case_slow_wave_stalls_do_not_break_accounting,
    "stale_continuation_storm_restarts_pagination":
        case_stale_continuation_storm_restarts_pagination,
    "compaction_handoff_race_rebuilds_and_crashed_worker_restarts":
        case_compaction_handoff_race_rebuilds_and_crashed_worker_restarts,
    "fault_schedules_replay_deterministically":
        case_fault_schedules_replay_deterministically,
    **{f"chaos_sweep_{i}": _sweep_case(seed, armed)
       for i, (seed, armed) in enumerate(SWEEP)},
    "serving_fault_sites": case_serving_fault_sites,
}
SERVE_CASES = tuple(CASES)[:12]
ADMISSION_CASES = tuple(CASES)[12:38]
CHAOS_CASES = tuple(CASES)[38:]


def run(m, name):
    """Run one case with the planner's program cache emptied (its hit
    counters are the case's own) and the fake clock in place of each
    package's ``time`` in ``serve``, ``planner`` and ``faults``; returns
    its Recorder."""
    clock = FakeClock()
    view = ClockView(clock)
    mods = ((m.serve, clock), (m.planner, view), (m.faults, view))
    saved = [mod.time for mod, _ in mods]
    m.planner._CACHE.clear()
    m.planner.reset_stats()
    for mod, t in mods:
        mod.time = t
    rec = Recorder(m)
    try:
        CASES[name](m, rec, clock)
    finally:
        for (mod, _), t in zip(mods, saved):
            mod.time = t
    return rec
