"""Seeded cases of the A1 fleet (``launch/cluster.py``'s ``A1Frontend``
over ``Coordinator`` workers, ``launch/transport.py``'s frames and
channels, ``core/membership.py``'s leases and epochs) that drive either
package.

Each case in :data:`CASES` is ``fn(m, rec, clock)``: ``m`` is a namespace
the caller builds from one package (see :func:`namespace`), ``rec`` a
``Recorder`` of JSON-safe steps, ``clock`` the ``FakeClock`` of
``tests/torch_serve_script.py`` that :func:`run` puts in place of each
package's ``time`` in ``serve`` and ``cluster`` (so ``Membership``'s
default clock too) for the case.  The cases follow the JAX package's own
tests case for case and keep their assertions:

* ``tests/test_cluster.py`` (11): the frame and write-op codecs, the
  shared store, least-loaded routing, owner-routed continuations, the
  front door's exhausted budgets (without its wall-time gate), the mixed
  read / write / ``Nearest`` acceptance traffic, the wire dispatch, the
  worker client's recv timeout and process mode;
* ``tests/test_chaos_cluster.py``: takeover, rescue, the crash site, the
  two dropped-frame visits, the stale-route storm, and its hypothesis
  sweep as the fixed draws of :data:`CLUSTER_SWEEP`;
* ``tests/test_chaos_failover.py``: the five failover schedules and its
  hypothesis sweep as the fixed seeds of :data:`FAILOVER_SWEEP`.

A step records every query and write result with the id it was routed
under (``"<cid>:<qid>"``: the routed coordinator), frames as hex, and
``cluster_stats()`` with its membership view, replication state and every
worker's ``stats``.  :func:`run` also replaces ``uuid`` in ``serve`` and
``cluster`` by a counter, so ids are equal in both packages.  The cases in
:data:`REAL_TIME` use sockets, threads or spawned processes: they run on
the real clock, and ``process_mode_workers_map_one_segment`` is the
port's alone (``tests/test_torch_cluster_process.py``).

``tests/fixtures/torch_fleet/make_fixture.py`` runs the other cases
through the JAX package and records them; the port's tests run them
through the port and compare.  The script imports neither package.
"""
import time
import types

import numpy as np

import torch_serve_script as ss
from torch_serve_script import (SEL, ClockView, FakeClock, Recorder, _safe,
                                busy_db, caps, full_rows, q_chain, q_near)

D = ss.D
# the hypothesis sweeps as fixed draws of their strategies:
# (seed, crash_after, drop_prob, stale_prob) and the failover seeds
CLUSTER_SWEEP = [(0, 0, 0.0, 0.0), (17, 2, 0.25, 0.5), (4242, 6, 0.1, 1.0),
                 (65535, 1, 0.2, 0.3)]
FAILOVER_SWEEP = [0, 7, 1234, 65535]


def namespace(**kw):
    """The package handles a case uses: ``GraphDB(cfg)`` (the port binds
    its device), ``StoreConfig``, ``QueryCaps``, ``Frontend`` (the
    package's ``A1Frontend``; the port binds its device), the modules
    ``w`` (writes), ``faults``, ``serve``, ``cluster``, ``transport``,
    ``membership`` and ``planner``, ``np_of`` (a store field as numpy)
    and ``make(key, build)`` (see ``torch_serve_script.namespace``)."""
    return types.SimpleNamespace(**kw)


class Uuids:
    """``uuid.uuid4()`` as a counter: ids equal in both packages."""

    def __init__(self):
        self.n = 0

    def uuid4(self):
        self.n += 1
        return types.SimpleNamespace(hex=f"{self.n:032x}")


# ---------------------------------------------------------------------------
# what a step records
# ---------------------------------------------------------------------------

def fleet(fe) -> dict:
    """``cluster_stats()`` (frontend counters, membership view, replication,
    every alive worker's stats) and the routing signal."""
    return {"cluster": _safe(fe.cluster_stats()),
            "load": {str(c): float(v) for c, v in sorted(fe._load.items())},
            "alive": list(fe._alive()),
            "pins": sorted(int(t) for t in fe.db.active_query_ts)}


def routed(pub) -> int:
    """The coordinator a public query id was routed to."""
    return int(pub.split(":", 1)[0])


# ---------------------------------------------------------------------------
# stores and documents (tests/test_vector.py)
# ---------------------------------------------------------------------------

def build_vdb_mutated(m, seed=0, n_docs=24, n_tags=5):
    """tests/test_vector.py::build_vdb with its default ``mutate=True``:
    churn after the index registration, then a compaction."""
    db, emb, rng = ss.build_vdb(m, seed=seed, n_docs=n_docs, n_tags=n_tags)
    fa = tuple(f"f{i}" for i in range(D))
    for i in range(0, n_docs, 5):
        g, found = db.lookup_vertex("doc", i)
        assert found
        if i % 10 == 0:
            db.delete_vertex(g)
        else:
            emb[i] = rng.normal(size=D).astype(np.float32)
            db.update_vertex(g, "doc", dict(zip(fa, map(float, emb[i]))))
    db.run_compaction()
    return db, emb, rng


def q_scan(key, select="count"):
    tgt = {"type": "tag",
           "select": select if select == "count" else list(select)}
    return {"type": "doc", "id": key,
            "_out_edge": {"type": "doc.tag", "_target": tgt}}


def cl_caps(m):
    """tests/test_cluster.py and test_chaos_cluster.py's CAPS."""
    return caps(m, frontier=128, expand=512, results=8)


def mk_fleet(m, db=None, n=4, **kw):
    db = db or busy_db(m)
    kw.setdefault("caps", cl_caps(m))
    return m.Frontend(db, n, **kw)


# ---------------------------------------------------------------------------
# tests/test_cluster.py
# ---------------------------------------------------------------------------

def case_frame_codec_roundtrips_numpy_payloads(m, rec, clock):
    msg = {"op": "result", "n": np.int64(3), "ok": np.bool_(True),
           "rows": np.arange(3), "ms": np.float32(1.5)}
    frame = m.transport.encode_frame(msg)
    assert m.transport.decode_frame(frame) == {
        "op": "result", "n": 3, "ok": True, "rows": [0, 1, 2], "ms": 1.5}
    rec.step("frame", frame=frame.hex(),
             decoded=m.transport.decode_frame(frame))


def case_frame_buffer_reassembles_partial_feeds(m, rec, clock):
    blob = b"".join(m.transport.encode_frame({"i": i}) for i in range(3))
    buf, got = m.transport.FrameBuffer(), []
    for off in range(0, len(blob), 5):        # worst-case 5-byte reads
        got += buf.feed(blob[off:off + 5])
    assert got == [{"i": i} for i in range(3)]
    rec.step("fed", blob=blob.hex(), got=got)


def case_write_op_codec_roundtrips(m, rec, clock):
    ops = [m.w.CreateVertex("actor", 7, {"age": 31}),
           m.w.CreateEdge(2, 3, "film.actor", check=False)]
    enc = [m.transport.encode_write_op(o) for o in ops]
    assert [m.transport.decode_write_op(e) for e in enc] == ops
    try:
        m.transport.encode_write_op({"not": "an op"})
        raise AssertionError("a dict is not a write op")
    except TypeError as e:
        err = str(e)
    rec.step("ops", encoded=enc,
             frames=[m.transport.encode_frame(e).hex() for e in enc],
             error=err)


def case_inproc_fleet_shares_one_graphdb(m, rec, clock):
    with mk_fleet(m, n=4) as fe:
        assert {id(w.coord.server.db) for w in fe.workers.values()} \
            == {id(fe.db)}
        rec.step("shared", **fleet(fe))


def case_routed_queries_match_oracle_and_spread(m, rec, clock):
    db = busy_db(m)
    c = cl_caps(m)
    rows = []
    with mk_fleet(m, db, n=4, read_batch=1) as fe:
        for i in range(8):
            pub = fe.submit_query(q_chain(i % 3))
            solo = fe.db.query([q_chain(i % 3)], caps=c)
            row = fe.query_result(pub)
            assert row["status"] == "OK"
            assert row["count"] == int(solo.counts[0])
            rows.append({"pub": pub, "cid": routed(pub), "row": row,
                         "solo": int(solo.counts[0])})
        st = fe.cluster_stats()
        assert fe.stats["routed_queries"] == 8
        admitted = [w["admitted"] for w in st["workers"].values()]
        assert sum(admitted) == 8
        assert sum(1 for a in admitted if a > 0) >= 2
        assert any(v > 0 for v in fe._load.values())
        rec.step("routed", rows=rows, admitted=admitted, **fleet(fe))


def _drain(fe, page, tok, owner_fixed=False):
    got = list(page)
    owner = fe._tokmeta[tok]["cid"] if tok is not None else None
    while tok is not None:
        if owner_fixed:
            assert fe._tokmeta[tok]["cid"] == owner   # never re-homed
        page, tok = fe.next_page(tok)
        got.extend(page)
    return [int(x) for x in got]


def case_continuations_route_to_their_owner(m, rec, clock):
    db = busy_db(m)
    with mk_fleet(m, db, n=4, page_size=2) as fe:
        want = full_rows(m, fe.db, SEL)
        page, tok = fe.select_paged(SEL)
        owner = fe._tokmeta[tok]["cid"]
        got = _drain(fe, page, tok, owner_fixed=True)
        assert sorted(got) == want
        assert fe.stats["continuation_routes"] >= 2
        assert fe.stats["stale_routes"] == 0
        assert fe.stats["takeovers"] == 0
        assert not fe.db.active_query_ts          # pin-of-record released
        rec.step("paged", owner=owner, got=got, want=want, **fleet(fe))


def case_frontend_answers_exhausted_budget_locally(m, rec, clock):
    with mk_fleet(m, n=2) as fe:
        pub = fe.submit_query(q_chain(0), budget_ms=0.0)
        row = fe.query_result(pub)
        assert row == {"status": "OK", "failed": False, "rows": [],
                       "truncated": True, "budget_exhausted": True}
        assert fe.stats["budget_exhausted_frontend"] == 1
        assert fe.stats["routed_queries"] == 0    # never cost a frame
        rec.step("local", pub=pub, row=row, **fleet(fe))


def case_mixed_read_write_nearest_traffic_four_coordinators(m, rec, clock):
    db, emb, rng = m.make(("vdb_mutated", 0), lambda: build_vdb_mutated(m))
    c = cl_caps(m)
    with m.Frontend(db, 4, caps=c, read_batch=2, write_batch=1) as fe:
        vec = rng.normal(size=4).astype(np.float32)
        docs = [1, 2, 4]
        pubs = [fe.submit_query(q_scan(k), budget_ms=1e6) for k in docs]
        near = fe.submit_query(q_near(vec, k=4), budget_ms=1e6)
        fe.flush()
        reads = []
        for k, pub in zip(docs, pubs):
            solo = fe.db.query([q_scan(k)], caps=c)
            row = fe.query_result(pub)
            assert row["count"] == int(solo.counts[0])
            reads.append({"pub": pub, "cid": routed(pub), "row": row})
        solo = fe.db.query([q_near(vec, k=4)], caps=c)
        got = fe.query_result(near)
        assert sorted(got["rows"]) == sorted(
            int(x) for x in solo.rows_gid[0] if x >= 0)
        reads.append({"pub": near, "cid": routed(near), "row": got})
        rec.step("reads", reads=reads, **fleet(fe))
        attrs = {f"f{i}": float(vec[i]) for i in range(4)}
        wid = fe.submit_write([m.w.CreateVertex(
            "doc", 999, {**attrs, "x": 999, "y": 0})])
        wrow = fe.write_result(wid)
        assert wrow["status"] == "COMMITTED"
        new_gid = wrow["gids"][0]
        nearest = []
        for _ in range(4):                        # hit several coordinators
            pub = fe.submit_query(q_near(vec, k=1), budget_ms=1e6)
            fe.flush()
            row = fe.query_result(pub)
            assert row["rows"] == [new_gid]
            nearest.append({"pub": pub, "cid": routed(pub), "row": row})
        assert fe.stats["routed_writes"] == 1
        st = fe.cluster_stats()
        assert sum(w["admitted"] for w in st["workers"].values()) == 8
        assert sum(st["budget_spend_ms"]["queue"]) >= 8
        assert st["membership"]["epoch"] == 1
        assert st["membership"]["primary"] == 0
        assert all(lease["state"] == "alive"
                   for lease in st["membership"]["leases"].values())
        assert st["replication"]["shipped_seq"] >= 1
        assert st["replication"]["max_lag"] == 0
        rec.step("written", wid=wid, write=wrow, nearest=nearest,
                 **fleet(fe))


def case_wire_handle_dispatch_and_stats_aggregation(m, rec, clock):
    with mk_fleet(m, n=2, read_batch=1) as fe:
        resp = fe.handle({"op": "query", "doc": q_chain(0)})
        assert resp["status"] == "OK"
        res = fe.handle({"op": "result", "qid": resp["qid"]})
        assert res["result"]["status"] == "OK"
        page = fe.handle({"op": "select_paged", "doc": dict(SEL)})
        assert page["status"] == "OK" and page["rows"]
        bad = fe.handle({"op": "nope"})
        assert bad["status"] == "ERROR"
        st = fe.handle({"op": "stats"})["stats"]
        assert st["frontend"]["routed_queries"] == 1
        assert st["budget_spend_ms"] is not None
        assert sum(st["budget_spend_ms"]["queue"]) >= 1
        assert st["frontend"]["frames_sent"] > 0
        rec.step("wire", query=resp, result=res, page=page, bad=bad,
                 stats=_safe(st))


def case_worker_client_recv_timeout_suspect_then_recovers(m, rec, clock):
    """Real sockets and the real clock: a hung request is bounded by the
    client's recv timeout (it answers ``None`` with one timeout counted,
    not the late answer), flags the worker suspect, rebuilds the stream,
    and the next clean round trip clears the suspicion."""
    state = {"n": 0}

    def handler(msg):
        state["n"] += 1
        if state["n"] == 2:
            time.sleep(0.6)                     # hang exactly one request
        return {"status": "OK", "n": state["n"]}

    port, shutdown = m.transport.serve_worker(handler)
    try:
        c = m.transport.WorkerClient("127.0.0.1", port, recv_timeout=0.15,
                                     reconnect_attempts=3, backoff_s=0.01)
        try:
            first = c.request({"op": "x"})
            assert first["status"] == "OK"
            assert not c.suspect
            hung = c.request({"op": "x"})
            assert hung is None                 # hung: bounded wait
            assert c.suspect and c.timeouts == 1
            assert c.reconnects >= 1            # stream rebuilt
            suspect = c.suspect
            r = c.request({"op": "x"})
            assert r is not None and r["status"] == "OK"
            assert not c.suspect                # clean round trip clears it
        finally:
            c.close()
    finally:
        shutdown()
    rec.step("timeout", first=first, hung=hung, suspect=suspect,
             timeouts=c.timeouts, after=r["status"], cleared=not c.suspect)


def _worker_query(fe, cid, doc, deadline_s=60.0):
    """Route one query to a SPECIFIC worker and poll its result there
    until ``deadline_s`` of real time."""
    resp = fe._rpc(cid, {"op": "query", "doc": doc, "budget_ms": 1e6})
    assert resp["status"] == "OK"
    fe._rpc(cid, {"op": "flush"})
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        r = fe._rpc(cid, {"op": "result", "qid": resp["qid"]})
        if r is not None and r.get("result") is not None:
            return r["result"]
        time.sleep(0.02)
    raise AssertionError(f"worker {cid} never answered")


def _poll(fe, pub, deadline_s=60.0):
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        row = fe.query_result(pub)
        if row is not None:
            return row
        time.sleep(0.02)
    raise AssertionError(f"no result for {pub}")


def case_process_mode_workers_map_one_segment(m, rec, clock):
    """Two spawned workers attach one shared segment onto the frontend's
    device; reads match the frontend's own store, a write is shipped and
    replayed before its ack, the owner of a paged select is killed and
    taken over, and the fleet commits after the failover.  Every wait has
    a deadline and the fleet is closed in ``finally``."""
    db = busy_db(m)
    c = cl_caps(m)
    a_gid, found = db.lookup_vertex("actor", 323)
    assert found
    want = full_rows(m, db, SEL)
    fe = m.Frontend(db, 2, mode="process", caps=c, read_batch=1,
                    write_batch=1)
    try:
        reads = []
        for i in range(4):
            pub = fe.submit_query(q_chain(i % 3), budget_ms=1e6)
            row = _poll(fe, pub)
            solo = db.query([q_chain(i % 3)], caps=c)
            assert row["status"] == "OK"
            assert row["count"] == int(solo.counts[0])
            reads.append({"cid": routed(pub), "row": row})

        wrow = fe.write_result(fe.submit_write([m.w.CreateVertex(
            "film", 999, {"year": 2030, "genre": 0, "gross": 0.0})]))
        assert wrow["status"] == "COMMITTED"
        g999 = wrow["gids"][0]
        wrow = fe.write_result(fe.submit_write([m.w.CreateEdge(
            g999, a_gid, "film.actor")]))
        assert wrow["status"] == "COMMITTED"
        want_now = sorted(want + [g999])
        films_of_323 = q_chain(323, direction="in")
        base = int(db.query([films_of_323], caps=c).counts[0])
        for cid in fe._alive():
            res = _worker_query(fe, cid, films_of_323)
            assert res["count"] == base + 1, f"worker {cid} stale"
        st = fe.cluster_stats()
        assert st["membership"]["epoch"] == 1
        assert st["membership"]["primary"] == 0
        assert st["replication"]["shipped_seq"] >= 2
        assert st["replication"]["max_lag"] == 0      # acked => applied
        assert fe.stats["replicated_waves"] >= 2
        assert len(fe.rlog.os.scan("g.waves")) >= 2
        assert fe.rlog.os.get_meta("g.wave_frontier", 0) >= 2

        page, tok = fe.select_paged(SEL)
        owner = fe._tokmeta[tok]["cid"]
        read_ts = fe._tokmeta[tok]["read_ts"]
        fe.pump()                                     # pins reach workers
        got = list(page)
        fe.kill_worker(owner)
        while tok is not None:
            page, tok = fe.next_page(tok)
            got.extend(page)
        assert sorted(int(x) for x in got) == want_now
        assert not fe.db.active_query_ts              # pin-of-record clear
        fe.pump()                                     # empty pins fan out
        survivor = fe._alive()[0]
        hb = fe._rpc(survivor, {"op": "heartbeat", "pins": fe._pins()})
        assert hb["gc_ts"] >= read_ts                 # pin no longer holds

        st = fe.cluster_stats()
        assert st["membership"]["epoch"] >= 2         # eviction fenced it
        wrow = fe.write_result(fe.submit_write([m.w.CreateVertex(
            "film", 998, {"year": 2031, "genre": 0, "gross": 0.0})]))
        assert wrow["status"] == "COMMITTED"
        res = _worker_query(fe, survivor, q_chain(0))
        solo = db.query([q_chain(0)], caps=c)
        assert res["count"] == int(solo.counts[0])    # reads stay correct
        hb = fe._rpc(survivor, {"op": "heartbeat", "pins": fe._pins()})
        assert hb["gc_ts"] > read_ts
        if owner == 0:
            assert fe.stats["failovers"] == 1
            assert st["membership"]["primary"] == fe.membership.primary != 0
            assert fe.rlog.os.get_meta("g.epoch", 0) >= 2   # durable fence
        rec.step("process", reads=reads, owner=owner, survivor=survivor,
                 attached=sorted(fe.attach_s), stats=_safe(fe.stats))
    finally:
        fe.close()


# ---------------------------------------------------------------------------
# tests/test_chaos_cluster.py
# ---------------------------------------------------------------------------

def chaos_fleet(m, db, n=3, **kw):
    kw.setdefault("caps", cl_caps(m))
    kw.setdefault("page_size", 2)
    return m.Frontend(db, n, **kw)


def paginate(fe, on_page=None):
    """Drain one paged select; returns the ordered row stream."""
    page, tok = fe.select_paged(SEL)
    got, pages = list(page), 0
    while tok is not None and pages < 60:
        pages += 1
        if on_page is not None:
            on_page(pages, tok)
        page, tok = fe.next_page(tok)
        got.extend(int(x) for x in page)
    assert tok is None
    return [int(x) for x in got]


def clean_stream(m, rec):
    """The no-fault pagination stream: the bit-identity oracle."""
    with chaos_fleet(m, busy_db(m)) as fe:
        got = paginate(fe)
    rec.step("clean", stream=got)
    return got


def case_takeover_mid_pagination_is_bit_identical(m, rec, clock):
    clean = clean_stream(m, rec)
    with chaos_fleet(m, busy_db(m)) as fe:
        killed = []

        def crash_once(pages, tok):
            if pages == 1:
                fe.kill_worker(fe._tokmeta[tok]["cid"])
                killed.append(fe._tokmeta[tok]["cid"])

        got = paginate(fe, on_page=crash_once)
        assert got == clean                         # ordered, bit-identical
        assert fe.stats["takeovers"] == 1
        assert fe.stats["worker_kills"] == 1
        assert not fe.db.active_query_ts            # pin released at the end
        assert sorted(got) == full_rows(m, fe.db, SEL)
        rec.step("takeover", killed=killed, stream=got, **fleet(fe))


def case_crash_with_inflight_queries_rescues_them(m, rec, clock):
    c = cl_caps(m)
    with chaos_fleet(m, busy_db(m), read_batch=64) as fe:    # stays queued
        pubs = [fe.submit_query(q_chain(i % 3), budget_ms=1e6)
                for i in range(6)]
        owners = {fe._qidmeta[p]["cid"] for p in pubs}
        victim = sorted(owners)[0]
        n_victim = sum(1 for p in pubs if fe._qidmeta[p]["cid"] == victim)
        assert n_victim >= 1
        fe.kill_worker(victim)
        fe.flush()
        rows = []
        for i, p in enumerate(pubs):
            row = fe.query_result(p)
            solo = fe.db.query([q_chain(i % 3)], caps=c)
            assert row is not None and row["status"] == "OK"
            assert row["count"] == int(solo.counts[0])
            rows.append({"pub": p, "cid": routed(p), "row": row})
        assert fe.stats["rescued_queries"] == n_victim
        rec.step("rescued", victim=victim, n_victim=n_victim, rows=rows,
                 **fleet(fe))


def case_crash_site_kills_route_target_and_fails_over(m, rec, clock):
    c = cl_caps(m)
    with chaos_fleet(m, busy_db(m)) as fe:
        fe.db.faults = m.faults.FaultInjector(0).inject(
            "cluster.worker.crash", action="race", times=(0,))
        pub = fe.submit_query(q_chain(0), budget_ms=1e6)
        fe.flush()
        row = fe.query_result(pub)
        solo = fe.db.query([q_chain(0)], caps=c)
        assert row["status"] == "OK"
        assert row["count"] == int(solo.counts[0])
        assert fe.stats["worker_kills"] == 1
        assert len(fe._alive()) == 2
        rec.step("crashed", pub=pub, cid=routed(pub), row=row,
                 fired=[list(f) for f in fe.db.faults.fired], **fleet(fe))


def _drop_case(drop_visit):
    def case(m, rec, clock):
        c = cl_caps(m)
        with chaos_fleet(m, busy_db(m), n=1, read_batch=1) as fe:
            fe.db.faults = m.faults.FaultInjector(5).inject(
                "transport.drop", action="race", times=(drop_visit,))
            pub = fe.submit_query(q_chain(0), budget_ms=1e6)
            assert fe.stats["retransmits"] == 1
            row = fe.query_result(pub)
            solo = fe.db.query([q_chain(0)], caps=c)
            assert row["status"] == "OK"
            assert row["count"] == int(solo.counts[0])
            st = fe.cluster_stats()
            assert st["workers"][0]["admitted"] == 1     # exactly once
            assert st["frontend"]["frames_dropped"] == 1
            rec.step("dropped", pub=pub, row=row,
                     fired=[list(f) for f in fe.db.faults.fired],
                     **fleet(fe))
    return case


def case_stale_route_storm_bounces_every_frame_to_the_owner(m, rec, clock):
    clean = clean_stream(m, rec)
    with chaos_fleet(m, busy_db(m)) as fe:
        fe.db.faults = m.faults.FaultInjector(3).inject(
            "cluster.route.stale", action="race", prob=1.0)
        got = paginate(fe)
        assert got == clean
        assert fe.stats["stale_routes"] == fe.stats["continuation_routes"]
        assert fe.stats["stale_routes"] >= 2
        assert fe.stats["takeovers"] == 0
        rec.step("storm", stream=got, **fleet(fe))


def _cluster_sweep_case(seed, crash_after, drop_prob, stale_prob):
    def case(m, rec, clock):
        clean = clean_stream(m, rec)
        with chaos_fleet(m, busy_db(m)) as fe:
            fe.db.faults = (
                m.faults.FaultInjector(seed)
                .inject("transport.drop", action="race", prob=drop_prob,
                        max_fires=6)
                .inject("cluster.route.stale", action="race",
                        prob=stale_prob))

            def maybe_crash(pages, tok):
                if pages == crash_after:
                    fe.kill_worker(fe._tokmeta[tok]["cid"])

            got = paginate(fe, on_page=maybe_crash)
            assert got == clean
            rec.step("swept", stream=got,
                     fired=[list(f) for f in fe.db.faults.fired],
                     **fleet(fe))
    return case


# ---------------------------------------------------------------------------
# tests/test_chaos_failover.py
# ---------------------------------------------------------------------------

COUNT_DOC = q_chain(323, direction="in")          # films of actor 323


def fo_fleet(m, db, n=3, **kw):
    kw.setdefault("caps", caps(m, results=64))
    return m.Frontend(db, n, **kw)


def unlinked_films(m, db, actor_key=323):
    """(actor_gid, [film gids not yet linked to the actor])."""
    a_gid, ok = db.lookup_vertex("actor", actor_key)
    assert ok
    linked = set(full_rows(m, db, SEL))
    films = []
    for k in range(100, 120):
        g, found = db.lookup_vertex("film", k)
        if found and g not in linked:
            films.append(int(g))
    assert films, "busy_db should leave some films unlinked"
    return int(a_gid), films


def fleet_count(fe, doc=COUNT_DOC, tries=200):
    """Count query through the SLB (counts ignore the results cap)."""
    pub = fe.submit_query(doc, budget_ms=1e6)
    fe.flush()
    for _ in range(tries):
        r = fe.query_result(pub)
        if r is not None:
            assert not r.get("failed"), r
            return int(r["count"])
        fe.flush()
    raise AssertionError("query never completed")


def do_write(fe, ops, tries=200):
    """Submit one write and poll it to a terminal answer."""
    pub = fe.submit_write(ops)
    for _ in range(tries):
        r = fe.write_result(pub)
        if r is not None:
            return r
        fe.flush()
    raise AssertionError("write never terminated")


def case_primary_kill_preserves_acked_commit(m, rec, clock):
    with fo_fleet(m, busy_db(m), write_batch=1) as fe:
        a_gid, films = unlinked_films(m, fe.db)
        base = fleet_count(fe)
        r = do_write(fe, [m.w.CreateEdge(films[0], a_gid, "film.actor")])
        assert r["status"] == "COMMITTED"
        fe.kill_worker(0)                         # the write-primary
        view = fe.membership.view()
        assert view["leases"][0]["state"] == "evicted"
        assert view["epoch"] == 2 and view["primary"] == 1
        assert fe.stats["failovers"] == 1
        after = fleet_count(fe)
        assert after == base + 1                  # the ack was not a lie
        r2 = do_write(fe, [m.w.CreateEdge(films[1], a_gid, "film.actor")])
        assert r2["status"] == "COMMITTED"        # writes resumed
        assert fleet_count(fe) == base + 2
        roles = [c for c in fe._alive()
                 if fe.workers[c].coord.role == "primary"]
        assert roles == [fe.membership.primary]
        rec.step("failover", base=base, writes=[r, r2], after=after,
                 view=_safe(view), roles=roles, **fleet(fe))


def case_midwave_crash_commits_exactly_once(m, rec, clock):
    with fo_fleet(m, busy_db(m), write_batch=1) as fe:
        a_gid, films = unlinked_films(m, fe.db)
        base = fleet_count(fe)
        fe.db.faults = m.faults.FaultInjector(7).inject(
            "primary.crash.midwave", times=(0,))
        r = do_write(fe, [m.w.CreateEdge(films[0], a_gid, "film.actor")])
        assert fe.db.faults.fired, "the crash schedule never fired"
        assert r["status"] == "COMMITTED"         # original result, via rid
        assert fe.stats["failovers"] == 1
        assert fe.membership.epoch == 2
        assert not fe.workers[0].alive            # it really crashed
        count = fleet_count(fe)
        assert count == base + 1                  # once, never twice
        rec.step("midwave", base=base, write=r, count=count,
                 fired=[list(f) for f in fe.db.faults.fired], **fleet(fe))


def case_deposed_zombie_is_fenced_and_client_gets_retry_hint(m, rec, clock):
    with fo_fleet(m, busy_db(m)) as fe:           # default batch: wave open
        a_gid, films = unlinked_films(m, fe.db)
        base = fleet_count(fe)
        pub = fe.submit_write([m.w.CreateEdge(films[0], a_gid,
                                              "film.actor")])
        assert fe.write_result(pub) is None       # staged, wave still open
        fe._handle_events(fe.membership.evict(0, reason="partition"))
        assert fe.membership.primary == 1 and fe.membership.epoch == 2
        zombie = fe.workers[0].coord
        assert zombie.role == "primary"           # missed its demote frame
        n = zombie.server.flush_writes()          # tries to commit anyway
        assert n == 1
        assert zombie.server.stats["write_fenced"] == 1
        assert fleet_count(fe) == base            # store untouched
        r = fe.write_result(pub)                  # resolved at failover
        assert r["status"] == "ABORTED_FAILOVER"
        assert r["retry_after_ms"] > 0
        r2 = do_write(fe, [m.w.CreateEdge(films[0], a_gid, "film.actor")])
        assert r2["status"] == "COMMITTED"
        assert fleet_count(fe) == base + 1
        rec.step("zombie", base=base, fenced=r, retry=r2,
                 zombie_stats=_safe(zombie.server.stats), **fleet(fe))


def case_lease_expiry_suspects_then_evicts_on_fake_clock(m, rec, clock):
    t = {"now": 0.0}
    with fo_fleet(m, busy_db(m), write_batch=1, lease_s=2.0,
                  membership_clock=lambda: t["now"]) as fe:
        a_gid, films = unlinked_films(m, fe.db)
        fe.db.faults = m.faults.FaultInjector(3).inject(
            "membership.heartbeat.drop", action="race", times=(0, 3, 6))
        views = []
        fe.pump()                                 # renewal lost, not late
        views.append(_safe(fe.membership.view()))
        assert fe.membership.view()["leases"][0]["state"] == "alive"
        t["now"] = 2.5
        fe.pump()                                 # lease expired: suspect
        views.append(_safe(fe.membership.view()))
        assert fe.membership.view()["leases"][0]["state"] == "suspect"
        assert 0 not in fe._alive()               # no fresh traffic
        assert fe.membership.primary == 0         # not yet deposed
        t["now"] = 4.6
        fe.pump()                                 # grace expired: evict
        view = fe.membership.view()
        views.append(_safe(view))
        assert view["leases"][0]["state"] == "evicted"
        assert view["primary"] == 1 and view["epoch"] == 2
        assert fe.stats["failovers"] == 1
        r = do_write(fe, [m.w.CreateEdge(films[0], a_gid, "film.actor")])
        assert r["status"] == "COMMITTED"
        rec.step("lease", views=views, write=r,
                 events=_safe(fe.membership.events), **fleet(fe))


def case_forced_primary_expiry_and_stale_epoch_fence(m, rec, clock):
    t = {"now": 0.0}
    with fo_fleet(m, busy_db(m), write_batch=1,
                  membership_clock=lambda: t["now"]) as fe:
        a_gid, films = unlinked_films(m, fe.db)
        fe.db.faults = m.faults.FaultInjector(5).inject(
            "membership.lease.expire", action="race", times=(0,))
        fe.pump()                                 # one tick: evict + elect
        view = fe.membership.view()
        assert view["leases"][0]["state"] == "evicted"
        assert view["primary"] == 1 and view["epoch"] == 2
        assert fe.stats["failovers"] == 1
        stale = fe.workers[1].request(
            {"op": "stats", "rid": "stale-probe", "epoch": 1})
        assert stale["status"] == "STALE_EPOCH" and stale["epoch"] == 2
        resp = fe._rpc(1, {"op": "stats"})
        assert resp["status"] == "OK" and resp["stats"]["role"] == "primary"
        r = do_write(fe, [m.w.CreateEdge(films[0], a_gid, "film.actor")])
        assert r["status"] == "COMMITTED"
        rec.step("fenced", view=_safe(view), stale=stale,
                 restamped=_safe(resp), write=r, **fleet(fe))


def _failover_sweep_case(seed):
    def case(m, rec, clock):
        rng = np.random.default_rng(seed)
        with fo_fleet(m, busy_db(m), write_batch=1,
                      membership_clock=lambda: 0.0) as fe:
            inj = m.faults.FaultInjector(int(seed))
            fe.db.faults = inj
            a_gid, films = unlinked_films(m, fe.db)
            base = fleet_count(fe)
            outcomes, fi, actions = [], 0, []
            for _ in range(10):
                action = int(rng.integers(0, 4))
                actions.append(action)
                if action == 0 and fi < len(films):
                    outcomes.append(do_write(
                        fe, [m.w.CreateEdge(films[fi], a_gid,
                                            "film.actor")]))
                    fi += 1
                elif (action == 1 and fi < len(films)
                        and len(fe._alive()) > 1):
                    inj.inject("primary.crash.midwave",
                               times=(inj.visits("primary.crash.midwave"),))
                    outcomes.append(do_write(
                        fe, [m.w.CreateEdge(films[fi], a_gid,
                                            "film.actor")]))
                    fi += 1
                elif action == 2 and len(fe._alive()) > 1:
                    fe.kill_worker(int(rng.choice(fe._alive())))
                else:
                    inj.inject("membership.heartbeat.drop", action="race",
                               times=(inj.visits(
                                   "membership.heartbeat.drop"),))
                    fe.pump()
            fe.flush()
            statuses = [r["status"] for r in outcomes]
            assert all(s in ("COMMITTED", "ABORTED", "ABORTED_FAILOVER")
                       for s in statuses), statuses
            committed = statuses.count("COMMITTED")
            count = fleet_count(fe)
            assert count == base + committed
            roles = [c for c in fe._alive()
                     if fe.workers[c].coord.role == "primary"]
            p = fe.membership.primary
            assert roles == ([p] if p in fe._alive() else [])
            evicted = [c for c, mm in fe.membership.members.items()
                       if mm.state == "evicted"]
            assert fe.membership.epoch == 1 + len(evicted)
            rec.step("swept", actions=actions, outcomes=outcomes,
                     base=base, count=count, roles=roles,
                     fired=[list(f) for f in inj.fired], **fleet(fe))
    return case


CASES = {
    # tests/test_cluster.py
    "frame_codec_roundtrips_numpy_payloads":
        case_frame_codec_roundtrips_numpy_payloads,
    "frame_buffer_reassembles_partial_feeds":
        case_frame_buffer_reassembles_partial_feeds,
    "write_op_codec_roundtrips": case_write_op_codec_roundtrips,
    "inproc_fleet_shares_one_graphdb": case_inproc_fleet_shares_one_graphdb,
    "routed_queries_match_oracle_and_spread":
        case_routed_queries_match_oracle_and_spread,
    "continuations_route_to_their_owner":
        case_continuations_route_to_their_owner,
    "frontend_answers_exhausted_budget_locally":
        case_frontend_answers_exhausted_budget_locally,
    "mixed_read_write_nearest_traffic_four_coordinators":
        case_mixed_read_write_nearest_traffic_four_coordinators,
    "wire_handle_dispatch_and_stats_aggregation":
        case_wire_handle_dispatch_and_stats_aggregation,
    "worker_client_recv_timeout_suspect_then_recovers":
        case_worker_client_recv_timeout_suspect_then_recovers,
    "process_mode_workers_map_one_segment":
        case_process_mode_workers_map_one_segment,
    # tests/test_chaos_cluster.py
    "takeover_mid_pagination_is_bit_identical":
        case_takeover_mid_pagination_is_bit_identical,
    "crash_with_inflight_queries_rescues_them":
        case_crash_with_inflight_queries_rescues_them,
    "crash_site_kills_route_target_and_fails_over":
        case_crash_site_kills_route_target_and_fails_over,
    "dropped_frames_retransmit_idempotently_0": _drop_case(0),
    "dropped_frames_retransmit_idempotently_1": _drop_case(1),
    "stale_route_storm_bounces_every_frame_to_the_owner":
        case_stale_route_storm_bounces_every_frame_to_the_owner,
    **{f"any_schedule_pagination_converges_{i}": _cluster_sweep_case(*draw)
       for i, draw in enumerate(CLUSTER_SWEEP)},
    # tests/test_chaos_failover.py
    "primary_kill_preserves_acked_commit":
        case_primary_kill_preserves_acked_commit,
    "midwave_crash_commits_exactly_once":
        case_midwave_crash_commits_exactly_once,
    "deposed_zombie_is_fenced_and_client_gets_retry_hint":
        case_deposed_zombie_is_fenced_and_client_gets_retry_hint,
    "lease_expiry_suspects_then_evicts_on_fake_clock":
        case_lease_expiry_suspects_then_evicts_on_fake_clock,
    "forced_primary_expiry_and_stale_epoch_fence":
        case_forced_primary_expiry_and_stale_epoch_fence,
    **{f"any_schedule_failover_invariants_{i}": _failover_sweep_case(seed)
       for i, seed in enumerate(FAILOVER_SWEEP)},
}
CLUSTER_CASES = tuple(CASES)[:11]
CHAOS_CLUSTER_CASES = tuple(CASES)[11:21]
FAILOVER_CASES = tuple(CASES)[21:]
REAL_TIME = ("worker_client_recv_timeout_suspect_then_recovers",
             "process_mode_workers_map_one_segment")
PORT_ONLY = ("process_mode_workers_map_one_segment",)
FIXTURE_CASES = tuple(n for n in CASES if n not in PORT_ONLY)


def run(m, name):
    """Run one case with the planner's program cache emptied, ``uuid`` a
    counter in ``serve`` and ``cluster``, and (unless the case is in
    :data:`REAL_TIME`) the fake clock in place of ``time`` in ``serve``
    and ``cluster`` and its tick-free view in ``planner`` and ``faults``;
    returns its Recorder."""
    clock = FakeClock()
    view = ClockView(clock)
    ids = Uuids()
    mods = [(m.serve, "uuid", ids), (m.cluster, "uuid", ids)]
    if name not in REAL_TIME:
        mods += [(m.serve, "time", clock), (m.cluster, "time", clock),
                 (m.planner, "time", view), (m.faults, "time", view)]
    saved = [getattr(mod, attr) for mod, attr, _ in mods]
    m.planner._CACHE.clear()
    m.planner.reset_stats()
    for mod, attr, v in mods:
        setattr(mod, attr, v)
    rec = Recorder(m)
    try:
        CASES[name](m, rec, clock)
    finally:
        for (mod, attr, _), v in zip(mods, saved):
            setattr(mod, attr, v)
    return rec
