"""Seeded cases of background compaction, tasks, fault sites, replication
and recovery that drive either package.

Each case in :data:`CASES` is ``fn(m, rec)``: ``m`` is a namespace the
caller builds from one package (see :func:`namespace`), ``rec`` a
:class:`Recorder` that snapshots every database the case touches after
each step: a SHA-256 digest of every store field, the host mirrors,
``stats``, ``epochs``, the task queue's ``completed`` list, pinned reads,
the ObjectStore's tables and metas and the log's watermarks.  The cases
follow the JAX package's own tests:

* ``tests/test_tasks.py`` (priorities, DeleteType, DeleteGraph, a pinned
  query across maintenance quanta) and ``tests/test_core_db.py``'s vacuum;
* ``tests/test_chaos_compaction.py``: the pinned background cycle, the
  raced delete, the rebuild cap, the index tail, the raced vertex delete
  and the four ``FIXED_SCHEDULES``, each beside its uncompacted twin;
* the fault sites ``tasks.quantum``, ``tasks.compaction.handoff`` and
  ``engine.wave`` on a seeded schedule;
* a replicated run with ``fail_next`` and ``replication.ship.drop`` cuts,
  the sweeper, both recoveries before and after it catches up and a reload
  of the ObjectStore from its WAL; the cut sweep of
  ``tests/test_chaos_replication.py``; fast restart and shared attach.

``tests/fixtures/torch_durability/make_fixture.py`` runs them through the
JAX package and records the results; the port's tests run them through the
port and compare.  The script imports neither package.
"""
import hashlib
import json
import os

import numpy as np

# tests/test_chaos_compaction.py
CHAOS_CFG = dict(n_shards=2, cap_v=128, cap_e=1024, cap_delta=64,
                 cap_idx=256, cap_idx_delta=128, d_f32=1, d_i32=1)
# tests/test_tasks.py and tests/test_recovery.py
TASKS_CFG = dict(n_shards=4, cap_v=64, cap_e=512, cap_delta=128, cap_idx=128,
                 cap_idx_delta=64, d_f32=1, d_i32=1)
REC_CFG = dict(TASKS_CFG, d_f32=2, d_i32=2)
VEC_CFG = dict(REC_CFG, cap_vec=64, d_f32=4)
# tests/test_chaos_replication.py
CUT_CFG = dict(n_shards=2, cap_v=64, cap_e=512, cap_delta=128, cap_idx=128,
               cap_idx_delta=64, d_f32=1, d_i32=1)
FIXED_SCHEDULES = [
    ["write"] * 4 + ["pin", "pump", "write", "pin", "pump", "pin"],
    ["write"] * 5 + ["pump", "delete", "pump", "pump", "pin", "write"],
    ["write", "pin", "write", "pump", "delete", "pin", "pump",
     "write", "pump", "pump", "pin"],
    ["write"] * 6 + ["pin", "pump", "delete", "delete", "pump",
                     "pump", "pump", "write", "pin"],
]
OPS_SCRIPT = [
    ("create", 0, 1.5), ("create", 1, 2.5), ("edge", 0, 1),
    ("create", 2, 0.5), ("edge", 2, 0), ("update", 1, 9.0),
    ("create", 3, 4.0), ("edge", 3, 1), ("delete", 0, 0.0),
    ("create", 4, 7.0), ("edge", 4, 2), ("update", 4, 8.0),
]
CUTS = (3, 8, 21)


def namespace(**kw):
    """The package handles a case uses: ``GraphDB(cfg, **kw)`` (the port
    binds its device), ``StoreConfig``, ``QueryCaps``, the modules ``w``
    (writes), ``tasks``, ``faults``, ``replication``, the recovery entry
    points ``best_effort_recover`` / ``consistent_recover`` (store,
    schema_db, cfg), ``FastRestartCache``, ``restart(cache, name)``,
    ``attach_shared(manifest)``, and ``np_of`` (a store field as numpy)."""
    import types
    return types.SimpleNamespace(**kw)


# ---------------------------------------------------------------------------
# what a step records
# ---------------------------------------------------------------------------

def _ints(a):
    return [int(x) for x in a]


def digests(m, db) -> dict:
    """Every store field's SHA-256 (first 16 hex digits) over its bytes."""
    import dataclasses
    out = {}
    for f in dataclasses.fields(db.store):
        a = np.ascontiguousarray(m.np_of(getattr(db.store, f.name)))
        out[f.name] = hashlib.sha256(a.tobytes()).hexdigest()[:16]
    return out


def mirrors(db) -> dict:
    """The coordinator's host state, JSON-safe."""
    return dict(
        clock=int(db.clock), v_next=_ints(db.v_next),
        v_free=[_ints(f) for f in db.v_free], rr=int(db._rr),
        dl_count=_ints(db.dl_count), il_count=_ints(db.il_count),
        xd_count=_ints(db.xd_count), vx_count=_ints(db.vx_count),
        wave_seq=int(db.wave_seq),
        bg_pending=bool(db._bg_compaction_pending),
        stats={k: int(v) for k, v in db.stats.items()},
        epochs={k: int(v) for k, v in db.epochs.items()})


def tables(store) -> dict:
    """An ObjectStore's tables (sorted rows) and metas, JSON-safe."""
    return {"tables": {t: sorted([list(k), v, ts] for k, (v, ts)
                                 in rows.items())
                       for t, rows in sorted(store.tables.items())},
            "meta": dict(sorted(store.meta.items()))}


def queue(tq) -> dict:
    return {"completed": list(tq.completed),
            "pending": [t.name for t in tq._q],
            "fault_restarts": int(tq.fault_restarts)}


class Recorder:
    """The steps of one case: ``step(label, [(name, db), ...], tq=...,
    **extra)`` records a snapshot of each named database, the task queue
    and any JSON-safe extras; ``keep(name, db)`` keeps a store's fields
    whole; ``json()`` is the record of every step."""

    def __init__(self, m):
        self.m = m
        self.steps = []
        self.stores = {}          # name -> {field: numpy} of kept stores

    def step(self, label, dbs=(), *, tq=None, **extra):
        s = {"label": label}
        for name, db in dbs:
            s[name] = {"digest": digests(self.m, db), "mirrors": mirrors(db)}
        if tq is not None:
            s["queue"] = queue(tq)
        s.update(extra)
        self.steps.append(json.loads(json.dumps(s)))

    def keep(self, name, db):
        import dataclasses
        self.stores[name] = {f.name: np.array(self.m.np_of(
            getattr(db.store, f.name))) for f in dataclasses.fields(db.store)}

    def json(self):
        return {"steps": self.steps}


def _edges(db, gid, ts=None):
    return sorted([list(e) for e in db.get_edges(gid, read_ts=ts)])


def _vertex(db, vtype, key):
    got = db.get_vertex(vtype, key)
    if got is None:
        return None
    return {k: (float(v) if isinstance(v, float) else int(v))
            for k, v in got.items()}


def _result(r):
    """A QueryResult's counts, rows and flags as lists."""
    out = {}
    for k in ("counts", "rows_gid", "failed_q"):
        v = getattr(r, k)
        out[k] = None if v is None else np.asarray(v).tolist()
    return out


# ---------------------------------------------------------------------------
# tests/test_tasks.py and tests/test_core_db.py
# ---------------------------------------------------------------------------

def _tasks_db(m, n_actors=10, n_films=4):
    w = m.w
    db = m.GraphDB(m.StoreConfig(**TASKS_CFG))
    db.vertex_type("actor")
    db.vertex_type("film", i_attrs=("year",))
    db.edge_type("film.actor")
    films = [db.create_vertex("film", 100 + i, {"year": 2000 + i})
             for i in range(n_films)]
    actors = [db.create_vertex("actor", 300 + i) for i in range(n_actors)]
    t = db.create_transaction()
    db.write([w.CreateEdge(films[i % n_films], a, "film.actor")
              for i, a in enumerate(actors)], txn=t)
    assert db.write([t]).statuses == ["COMMITTED"]
    return db


def case_tasks_priority(m, rec):
    db = _tasks_db(m)
    tq = m.tasks.TaskQueue(db)
    ran = []

    def mk(name, prio):
        return m.tasks.Task(name, lambda d, t: ran.append(name) or [],
                            priority=prio)
    for name, prio in (("late", 30), ("first-a", 10), ("mid", 20),
                       ("first-b", 10)):
        tq.enqueue(mk(name, prio))
    rec.step("enqueued", [("db", db)], tq=tq)
    while tq.pending():
        tq.pump(1)
        rec.step("pump", tq=tq, ran=list(ran))
    assert ran == ["first-a", "first-b", "mid", "late"]


def case_tasks_delete_type(m, rec):
    db = _tasks_db(m, n_actors=10)
    tq = m.tasks.TaskQueue(db)
    tq.enqueue(m.tasks.delete_type_task("actor", chunk=3))
    while tq.pending():
        tq.pump(1)
        rec.step("pump", [("db", db)], tq=tq)
    rec.step("reads", actors=[_vertex(db, "actor", 300 + i)
                              for i in range(10)],
             films=[_vertex(db, "film", 100 + i) for i in range(4)],
             film_edges=[_edges(db, db.get_vertex("film", 100 + i)["gid"])
                         for i in range(4)])


def case_tasks_delete_graph(m, rec):
    db = _tasks_db(m)
    tq = m.tasks.TaskQueue(db)
    tq.enqueue(m.tasks.delete_graph_task(None, db.tenant, db.graph))
    while tq.pending():
        tq.pump(1)
        rec.step("pump", [("db", db)], tq=tq)
    rec.step("dropped",
             graph_left=db.graph in db.catalog.tenants[db.tenant])


TASK_QUERIES = [
    {"type": "film", "id": 100,
     "_out_edge": {"type": "film.actor",
                   "_target": {"type": "actor", "select": "count"}}},
    {"type": "actor", "id": 301,
     "_in_edge": {"type": "film.actor",
                  "_target": {"type": "film", "select": ["key"]}}},
]


def case_tasks_pump_pinned(m, rec):
    db = _tasks_db(m)
    caps = m.QueryCaps(frontier=64, expand=256, results=8)
    ts = db.snapshot_ts()
    db.active_query_ts.append(ts)
    base = db.query(TASK_QUERIES, caps=caps, read_ts=ts, fused=True)
    rec.step("pinned", [("db", db)], result=_result(base))
    tq = m.tasks.TaskQueue(db)
    db.delete_vertex(db.get_vertex("actor", 300)["gid"])
    for task in (m.tasks.compaction_task(), m.tasks.index_compaction_task(),
                 m.tasks.vacuum_task()):
        tq.enqueue(task)
    while tq.pending():
        tq.pump(1)
        res = db.query(TASK_QUERIES, caps=caps, read_ts=ts, fused=True)
        rec.step("pump", [("db", db)], tq=tq, result=_result(res))
    db.active_query_ts.remove(ts)
    db.run_compaction()
    db.run_index_compaction()
    fresh = db.query(TASK_QUERIES, caps=caps, fused=True)
    rec.step("fresh", [("db", db)], result=_result(fresh))


def case_vacuum(m, rec):
    """tests/test_core_db.py::test_vacuum_reclaims_slots, and the slots
    the creates after it reuse."""
    db = m.GraphDB(m.StoreConfig(**REC_CFG))
    db.vertex_type("actor", f_attrs=("rating",), i_attrs=("dob",))
    db.vertex_type("film", f_attrs=("gross",), i_attrs=("year",))
    db.edge_type("film.actor")
    gids = [db.create_vertex("actor", i) for i in range(10)]
    for g in gids[:5]:
        db.delete_vertex(g)
    rec.step("deleted", [("db", db)])
    db.run_compaction()
    db.run_index_compaction()
    n = db.vacuum()
    rec.step("vacuum", [("db", db)], n=int(n))
    again = [db.create_vertex("actor", 100 + i) for i in range(5)]
    rec.step("reuse", [("db", db)], gids=_ints(again),
             found=[list(db.lookup_vertex("actor", 100 + i))
                    for i in range(5)])
    assert n == 5


# ---------------------------------------------------------------------------
# tests/test_chaos_compaction.py
# ---------------------------------------------------------------------------

def _chaos_db(m, *, tasks):
    db = m.GraphDB(m.StoreConfig(**CHAOS_CFG))
    db.vertex_type("hub")
    db.vertex_type("spoke")
    db.edge_type("link")
    if tasks:
        db.task_queue = m.tasks.TaskQueue(db)
    return db


def _twins(m):
    return _chaos_db(m, tasks=True), _chaos_db(m, tasks=False)


def _both(dbs, ops):
    outs = [db.write(list(ops)) for db in dbs]
    assert not any(o.failed for o in outs)
    assert len({db.clock for db in dbs}) == 1
    return outs[0].gids


def _snap(rec, label, db, ref=None, **extra):
    dbs = [("db", db)] + ([("ref", ref)] if ref is not None else [])
    rec.step(label, dbs, tq=db.task_queue, **extra)


def case_chaos_pinned_bg_cycle(m, rec):
    w = m.w
    db, ref = dbs = _twins(m)
    hub = _both(dbs, [w.CreateVertex("hub", 0)])[0]
    spokes = _both(dbs, [w.CreateVertex("spoke", 1 + i) for i in range(40)])
    _both(dbs, [w.CreateEdge(hub, s, "link", check=False) for s in spokes])
    assert db.task_queue.pending() == 1 and db._bg_compaction_pending
    ts0 = db.snapshot_ts()
    db.active_query_ts.append(ts0)
    _snap(rec, "scheduled", db, ref, pinned=_edges(db, hub, ts0))
    db.task_queue.pump(1)                          # build
    _snap(rec, "built", db, ref, pinned=_edges(db, hub, ts0))
    extra = _both(dbs, [w.CreateVertex("spoke", 100 + i) for i in range(5)])
    _both(dbs, [w.CreateEdge(hub, s, "link", check=False) for s in extra])
    _snap(rec, "tail", db, ref, pinned=_edges(db, hub, ts0))
    db.task_queue.pump(1)                          # handoff + replay
    _snap(rec, "handoff", db, ref, pinned=_edges(db, hub, ts0),
          now=_edges(db, hub), ref_now=_edges(ref, hub))
    db.active_query_ts.remove(ts0)
    _snap(rec, "unpinned", db, ref, pinned=_edges(db, hub, ts0))


def case_chaos_raced_delete(m, rec):
    w = m.w
    db, ref = dbs = _twins(m)
    hub = _both(dbs, [w.CreateVertex("hub", 0)])[0]
    spokes = _both(dbs, [w.CreateVertex("spoke", 1 + i) for i in range(40)])
    _both(dbs, [w.CreateEdge(hub, s, "link", check=False) for s in spokes])
    db.task_queue.pump(1)
    _snap(rec, "built", db, ref)
    _both(dbs, [w.DeleteEdge(hub, spokes[0], "link")])
    db.task_queue.pump(1)                          # refused -> rebuild
    _snap(rec, "refused", db, ref)
    db.task_queue.pump(2)
    _snap(rec, "rebuilt", db, ref, now=_edges(db, hub),
          ref_now=_edges(ref, hub))


def case_chaos_rebuild_cap(m, rec):
    w = m.w
    db = _chaos_db(m, tasks=True)
    hub = db.write([w.CreateVertex("hub", 0)]).gids[0]
    spokes = db.write([w.CreateVertex("spoke", 1 + i)
                       for i in range(10)]).gids
    db.write([w.CreateEdge(hub, s, "link", check=False) for s in spokes])
    tq = db.task_queue
    db._bg_compaction_pending = True
    tq.enqueue(m.tasks.background_compaction_task(kinds=("edges",),
                                                  max_rebuilds=1))
    tq.pump(1)
    _snap(rec, "built", db)
    db.write([w.DeleteEdge(hub, spokes[0], "link")])
    tq.pump(1)                                     # refused at the cap
    _snap(rec, "inline", db, now=_edges(db, hub))


def case_chaos_index_tail(m, rec):
    w = m.w
    db, ref = dbs = _twins(m)
    db.compaction_watermark = 2.0
    gids = _both(dbs, [w.CreateVertex("spoke", i) for i in range(30)])
    handle = db.begin_compaction(("index",))
    _snap(rec, "built", db, ref)
    late = _both(dbs, [w.CreateVertex("spoke", 100 + i) for i in range(4)])
    ok = db.try_handoff(handle)
    _snap(rec, "handoff", db, ref, ok=ok,
          found=[list(db.lookup_vertex("spoke", k))
                 for k in list(range(30)) + [100 + i for i in range(4)]
                 + [999]], gids=_ints(gids) + _ints(late))


def case_chaos_vertex_delete_index(m, rec):
    w = m.w
    db = _chaos_db(m, tasks=True)
    gids = db.write([w.CreateVertex("spoke", i) for i in range(10)]).gids
    handle = db.begin_compaction(("index",))
    db.write([w.DeleteVertex(gids[0])])
    ok = db.try_handoff(handle)
    _snap(rec, "refused", db, ok=ok,
          found=list(db.lookup_vertex("spoke", 0)))


def _interleaving(m, rec, acts):
    w = m.w
    db, ref = dbs = _twins(m)
    db.compaction_watermark = 0.05
    hub = _both(dbs, [w.CreateVertex("hub", 0)])[0]
    nkey, alive, pins = 1, [], []
    for act in acts:
        if act == "write":
            s = _both(dbs, [w.CreateVertex("spoke", nkey)])[0]
            _both(dbs, [w.CreateEdge(hub, s, "link", check=False)])
            alive.append(s)
            nkey += 1
        elif act == "delete" and alive:
            _both(dbs, [w.DeleteEdge(hub, alive.pop(0), "link")])
        elif act == "pump":
            db.task_queue.pump(1)
        elif act == "pin":
            ts = db.snapshot_ts()
            db.active_query_ts.append(ts)
            pins.append(ts)
        now = _edges(db, hub)
        assert now == _edges(ref, hub)
        _snap(rec, act, db, ref, now=now,
              pinned=[[ts, _edges(db, hub, ts)] for ts in pins])
    db.task_queue.drain()
    _snap(rec, "drained", db, ref, now=_edges(db, hub),
          pinned=[[ts, _edges(db, hub, ts), _edges(ref, hub, ts)]
                  for ts in pins])


def _schedule(k):
    def case(m, rec):
        _interleaving(m, rec, FIXED_SCHEDULES[k])
    return case


# ---------------------------------------------------------------------------
# fault sites on a seeded schedule
# ---------------------------------------------------------------------------

def case_fault_sites(m, rec):
    """``tasks.quantum`` raises at its second visit, the first handoff is
    raced, and ``engine.wave`` raises or stalls by its seeded stream."""
    w = m.w
    db = _chaos_db(m, tasks=True)
    inj = m.faults.FaultInjector(seed=3)
    inj.inject("tasks.quantum", action="raise", times=(1,))
    inj.inject("tasks.compaction.handoff", action="race", times=(0,))
    inj.inject("engine.wave", action="raise", prob=0.4, max_fires=2)
    inj.inject("engine.wave", action="stall", prob=0.5)
    db.faults = inj
    hub = db.write([w.CreateVertex("hub", 0)]).gids[0]
    spokes = db.write([w.CreateVertex("spoke", 1 + i)
                       for i in range(40)]).gids
    db.write([w.CreateEdge(hub, s, "link", check=False) for s in spokes])
    caps = m.QueryCaps(frontier=64, expand=256, results=8)
    q = [{"type": "hub", "id": 0, "_out_edge": {
        "type": "link", "_target": {"type": "spoke", "select": "count"}}}]
    for step in range(8):
        if db.task_queue.pending():
            db.task_queue.pump(1)
        if step == 3:
            more = db.write([w.CreateVertex("spoke", 200 + i)
                             for i in range(3)]).gids
            db.write([w.CreateEdge(hub, s, "link", check=False)
                      for s in more])
        try:
            got = _result(db.query(q, caps=caps, fused=True))
        except m.faults.InjectedFault as e:
            got = {"fault": [e.site, e.visit]}
        _snap(rec, "step", db, query=got,
              fired=[list(f) for f in inj.fired],
              visits={s: inj.visits(s) for s in (
                  "tasks.quantum", "tasks.compaction.handoff",
                  "engine.wave")})
    assert db.task_queue.fault_restarts == 1
    assert db.stats["compaction_rebuilds"] == 1


# ---------------------------------------------------------------------------
# replication and recovery
# ---------------------------------------------------------------------------

def _rec_db(m, log=None, cfg=REC_CFG):
    db = m.GraphDB(m.StoreConfig(**cfg), replication_log=log)
    if log is not None:
        log.db = db
    db.vertex_type("node", f_attrs=("w",), i_attrs=("tag",))
    db.edge_type("link")
    return db


def _state(db, keys):
    """(key -> attributes) and key edge pairs of a database."""
    v, gid2key = {}, {}
    for k in keys:
        got = _vertex(db, "node", k)
        if got is not None:
            v[str(k)] = [got["w"], got["tag"]]
            gid2key[got["gid"]] = k
    edges = sorted([gid2key.get(g, -1), gid2key.get(n, -1)]
                   for g in gid2key for n, _ in db.get_edges(g))
    return {"v": v, "e": edges}


def _log_state(log):
    return {"t_R": log.os.get_meta(f"{log.graph}.t_R"),
            "wave_frontier": log.os.get_meta(f"{log.graph}.wave_frontier"),
            "lag": log.lag(), "shipped_ts": int(log.shipped_ts),
            "objectstore": tables(log.os)}


def case_replication(m, rec, tmpdir):
    """A replicated database (the WAL on disk, wave records shipped too)
    through creates, updates, edges and deletes, with two ``fail_next``
    cuts and one dropped ship round; both recoveries while the log lags,
    then the sweeper to lag 0, both recoveries again, and the ObjectStore
    reloaded from its WAL."""
    w, rp = m.w, m.replication
    path = os.path.join(tmpdir, "objectstore")
    store = rp.ObjectStore(path)
    log = rp.ReplicationLog(store, ship_waves=True)
    db = _rec_db(m, log)
    inj = m.faults.FaultInjector(seed=1)
    db.faults = inj
    rng = np.random.default_rng(21)
    keys = list(range(12))
    gid = {}

    def wave(label, ops):
        res = db.write(ops)
        assert not res.failed
        for op, g in zip(ops, res.gids):
            if g >= 0:
                gid[op.key] = g
        rec.step(label, [("db", db)], log=_log_state(log))

    wave("create", [w.CreateVertex("node", k, {
        "w": float(np.float32(rng.standard_normal())),
        "tag": int(rng.integers(100))}) for k in keys[:6]])
    wave("edges", [w.CreateEdge(gid[a], gid[b], "link")
                   for a, b in ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5))])
    store.fail_next(1)                     # the first ship of a wave dies
    wave("cut1", [w.CreateVertex("node", k, {"w": 0.1 * k, "tag": k})
                  for k in keys[6:9]] + [w.UpdateVertex(
                      gid[1], "node", {"w": np.float32(1) / np.float32(3)})])
    inj.inject("replication.ship.drop", action="race",
               times=(inj.visits("replication.ship.drop"),))
    wave("dropped", [w.CreateEdge(gid[6], gid[7], "link"),
                     w.DeleteEdge(gid[4], gid[5], "link")])
    log.sweep(budget=3)            # three of cut1's four entries ship
    rec.step("partial", log=_log_state(log))
    for name, fn in (("best_effort", m.best_effort_recover),
                     ("consistent", m.consistent_recover)):
        r = fn(store, db, db.cfg)
        rec.keep(f"lagging/{name}", r)
        rec.step(f"lagging/{name}", [(name, r)], state=_state(r, keys))
    store.fail_next(3)
    wave("cut2", [w.DeleteVertex(gid[3]),
                  w.CreateVertex("node", 9, {"w": -2.5, "tag": 9})])
    wave("more", [w.UpdateVertex(gid[0], "node", {"tag": 77}),
                  w.CreateEdge(gid[9], gid[0], "link")])
    tq = m.tasks.TaskQueue(db)
    tq.enqueue(rp.sweeper_task(log, budget=4))
    while tq.pending():
        tq.pump(1)
        rec.step("sweep", tq=tq, log=_log_state(log))
    assert log.lag() == 0
    for name, fn in (("best_effort", m.best_effort_recover),
                     ("consistent", m.consistent_recover)):
        r = fn(store, db, db.cfg)
        rec.keep(f"caught_up/{name}", r)
        rec.step(f"caught_up/{name}", [(name, r)], state=_state(r, keys))
    again = rp.ObjectStore(path)
    assert tables(again) == tables(store)
    r = m.consistent_recover(again, db, db.cfg)
    rec.step("reloaded", [("consistent", r)], objectstore=tables(again),
             source=_state(db, keys))
    rec.step("gc", removed=again.gc_tombstones("g.vertices", 10**9),
             objectstore=tables(again))


def _cut_pipeline(store, after):
    orig = store.upsert
    n = {"i": 0}

    def failing(table, key, value, ts):
        n["i"] += 1
        if n["i"] > after:
            raise IOError("chaos: pipeline cut")
        orig(table, key, value, ts)
    store.upsert = failing
    return lambda: setattr(store, "upsert", orig)


def case_cut_sweep(m, rec):
    """tests/test_chaos_replication.py's op script cut after the
    ``CUTS``-th ObjectStore write: both recoveries at each cut."""
    rp = m.replication
    for after in CUTS:
        store = rp.ObjectStore()
        log = rp.ReplicationLog(store)
        db = _rec_db(m, log, CUT_CFG)
        restore = _cut_pipeline(store, after)
        gid, live, edges = {}, set(), set()
        for op, a, b in OPS_SCRIPT:
            try:
                if op == "create" and a not in live:
                    gid[a] = db.create_vertex("node", a, {"w": float(b)})
                    live.add(a)
                elif op == "update" and a in live:
                    db.update_vertex(gid[a], "node", {"w": float(b)})
                elif op == "delete" and a in live:
                    db.delete_vertex(gid[a])
                    live.discard(a)
                elif op == "edge" and a in live and b in live:
                    db.create_edge(gid[a], gid[int(b)], "link")
                    edges.add((a, int(b)))
            except (ValueError, IOError):
                continue
        restore()
        rec.step(f"cut{after}", [("db", db)], log=_log_state(log))
        for name, fn in (("best_effort", m.best_effort_recover),
                         ("consistent", m.consistent_recover)):
            r = fn(store, db, db.cfg)
            rec.step(f"cut{after}/{name}", [(name, r)],
                     state=_state(r, range(6)))


def case_fast_restart(m, rec):
    """hold / restart / export_shared / attach_shared of a written store
    with a vector index; writes on the restarted databases."""
    w = m.w
    db = m.GraphDB(m.StoreConfig(**VEC_CFG))
    db.vertex_type("doc", f_attrs=("f0", "f1", "f2", "f3"))
    db.edge_type("link")
    docs = [db.create_vertex("doc", k, {f"f{i}": float(k + i)
                                        for i in range(4)})
            for k in range(8)]
    db.vector_index("doc")
    db.write([w.CreateEdge(docs[0], docs[k], "link") for k in (1, 2, 3)])
    q = [{"nearest": {"type": "doc", "k": 3,
                      "vector": [2.0, 3.0, 4.0, 5.0]}, "select": ("key",)}]
    rec.step("source", [("db", db)], nearest=_result(db.query(q)))
    cache = m.FastRestartCache()
    cache.hold("p0", db)
    db.write([w.CreateVertex("doc", 50, {"f0": 9.0})])     # after the hold
    rec.step("written_after_hold", [("db", db)])
    a = m.restart(cache, "p0")
    b = m.restart(cache, "p0")
    rec.step("restarted", [("a", a), ("b", b)], nearest=_result(a.query(q)),
             edges=_edges(a, docs[0]))
    a.create_vertex("doc", 99, {f"f{i}": 50.0 + i for i in range(4)})
    a.delete_vertex(docs[1])
    rec.step("a_written", [("a", a), ("b", b)],
             nearest=_result(a.query([{"nearest": {
                 "type": "doc", "k": 1, "vector": [50.0, 51.0, 52.0, 53.0]},
                 "select": ("key",)}])))
    manifest = cache.export_shared("p0")
    c = m.attach_shared(manifest)
    d = m.attach_shared(manifest)
    c.write([w.CreateEdge(docs[4], docs[5], "link")])
    rec.step("attached", [("c", c), ("d", d)], edges_c=_edges(c, docs[4]),
             edges_d=_edges(d, docs[4]))
    cache.drop("p0")
    rec.step("dropped", restart=m.restart(cache, "p0") is None)


CASES = {
    "tasks_priority": case_tasks_priority,
    "tasks_delete_type": case_tasks_delete_type,
    "tasks_delete_graph": case_tasks_delete_graph,
    "tasks_pump_pinned": case_tasks_pump_pinned,
    "vacuum": case_vacuum,
    "fault_sites": case_fault_sites,
    "chaos_pinned_bg_cycle": case_chaos_pinned_bg_cycle,
    "chaos_raced_delete": case_chaos_raced_delete,
    "chaos_rebuild_cap": case_chaos_rebuild_cap,
    "chaos_index_tail": case_chaos_index_tail,
    "chaos_vertex_delete_index": case_chaos_vertex_delete_index,
    **{f"chaos_schedule_{k}": _schedule(k)
       for k in range(len(FIXED_SCHEDULES))},
    "replication": case_replication,
    "cut_sweep": case_cut_sweep,
    "fast_restart": case_fast_restart,
}
NEEDS_TMPDIR = {"replication"}


def run(m, name, tmpdir=None):
    """Run one case; returns its Recorder."""
    rec = Recorder(m)
    if name in NEEDS_TMPDIR:
        CASES[name](m, rec, tmpdir)
    else:
        CASES[name](m, rec)
    return rec
