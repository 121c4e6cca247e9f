"""PyTorch port, durability against the JAX package: ``core/replication.py``
(the ObjectStore, its WAL, the log, the sweeper, the epoch fence) and
``core/recovery.py`` (both recoveries, fast restart, shared attach).

The seeded cases (a replicated run with ``fail_next`` and
``replication.ship.drop`` cuts, the cut sweep of
``tests/test_chaos_replication.py``, fast restart and shared attach) are
compared with the committed JAX fixture step by step (see
``test_torch_tasks.py``); the recovered stores also field by field.  The
port's WAL is JSON lines where JAX's is msgpack: the bytes differ, the
tables and metas they load are equal.  The port writes its store in
place, so the aliasing tests show that no held, restarted or attached
database shares memory with another.
"""
import json
import os

import numpy as np
import pytest
import torch

import torch_durability_script as script
from repro_torch.core import faults, recovery, replication, writes
from repro_torch.core.addressing import StoreConfig
from repro_torch.core.graphdb import GraphDB
from repro_torch.core.store import FIELDS
from test_torch_store_index_edges import one_torch_thread  # noqa: F401
from test_torch_tasks import (ASPECTS, assert_case_matches_jax, jax_cases,
                              jax_stores, port_run)

CASES = ("replication", "cut_sweep", "fast_restart")
KEPT = ("lagging/best_effort", "lagging/consistent", "caught_up/best_effort",
        "caught_up/consistent")


@pytest.mark.parametrize("aspect", ASPECTS)
@pytest.mark.parametrize("name", CASES)
def test_case_matches_jax(name, aspect, tmp_path_factory):
    assert_case_matches_jax(name, aspect, tmp_path_factory)


@pytest.mark.parametrize("kept", KEPT)
def test_recovered_store_matches_jax_field_by_field(kept, tmp_path_factory):
    got = port_run("replication", tmp_path_factory).stores[kept]
    want = jax_stores()
    for f in FIELDS:
        w = want[f"replication/{kept}/{f}"]
        assert got[f].shape == w.shape, f
        assert np.array_equal(got[f].view(np.int32), w.view(np.int32)), f


def test_cases_show_what_they_are_for():
    """The fixture's own values: t_R never passes what shipped, the
    recoveries differ while the log lags and agree once it is drained,
    and restarted and attached databases keep to themselves."""
    c = jax_cases()["cases"]
    st = {s["label"]: s for s in c["replication"]["steps"]}
    assert st["dropped"]["log"]["lag"] > 0
    assert st["dropped"]["log"]["t_R"] == st["edges"]["log"]["t_R"]
    assert st["lagging/best_effort"]["state"]["v"].keys() > st[
        "lagging/consistent"]["state"]["v"].keys()
    assert st["caught_up/best_effort"]["state"] == st[
        "caught_up/consistent"]["state"]
    assert st["reloaded"]["source"] == st["caught_up/consistent"]["state"]
    sweeps = [s["log"] for s in c["replication"]["steps"]
              if s["label"] == "sweep"]
    assert sweeps[-1]["lag"] == 0 and sweeps[-1]["wave_frontier"] > 0
    for a, b in zip(sweeps, sweeps[1:]):
        assert a["t_R"] <= b["t_R"]
    fr = {s["label"]: s for s in c["fast_restart"]["steps"]}
    assert fr["restarted"]["a"]["digest"] == fr["restarted"]["b"]["digest"]
    assert fr["a_written"]["b"]["digest"] == fr["restarted"]["b"]["digest"]
    assert fr["a_written"]["a"]["digest"] != fr["restarted"]["a"]["digest"]
    assert fr["attached"]["c"]["digest"] != fr["attached"]["d"]["digest"]
    assert fr["attached"]["d"]["digest"] == fr["restarted"]["b"]["digest"]
    assert fr["dropped"]["restart"] is True


def _t_r_never_ahead(log):
    """Every (vtype, key, ts) version at or below t_R is in the store."""
    t_r = log.os.get_meta(f"{log.graph}.t_R", 0)
    assert all(e.ts > t_r for e in log.entries), t_r


# ---------------------------------------------------------------------------
# the WAL
# ---------------------------------------------------------------------------

ROWS = [("g.vertices", (0, 5), [[np.float32(1) / np.float32(3), -0.0, 1e-38,
                                 3.4e38], [7, -1]], 3),
        ("g.vertices", (0, 6), replication.TOMBSTONE, 4),
        ("g.edges", (0, 5, 1, 0, 6), True, 4),
        ("g.vertices.versions", (0, 5, 3), [[2.5], [1]], 3),
        ("g.waves", (1,), {"seq": 1, "ts": 3, "txns": [{"rid": None}]}, 3),
        ("g.vertices", (0, 5), [[9.0], [9]], 2)]      # older: loses (LWW)


def _fill(store):
    for table, key, value, ts in ROWS:
        if isinstance(value, list):
            value = [[float(x) for x in value[0]], value[1]]
        store.upsert(table, key, value, ts)
    store.put_meta("g.t_R", 4)
    store.put_meta("g.wave_frontier", 1)


def test_wal_round_trip_equals_jax_tables(tmp_path):
    from repro.core import replication as jax_replication
    port = replication.ObjectStore(str(tmp_path / "port"))
    jax = jax_replication.ObjectStore(str(tmp_path / "jax"))
    for s in (port, jax):
        _fill(s)
    again = replication.ObjectStore(str(tmp_path / "port"))
    jax_again = jax_replication.ObjectStore(str(tmp_path / "jax"))
    assert script.tables(again) == script.tables(port)
    assert script.tables(again) == script.tables(jax_again)
    assert again.tables["g.vertices"][(0, 5)][0][0][0] == float(
        np.float32(1) / np.float32(3))
    assert all(isinstance(k, tuple) for t in again.tables.values()
               for k in t)
    assert again.tables["g.vertices"][(0, 6)] == (replication.TOMBSTONE, 4)


def test_wal_is_json_lines_and_skips_a_torn_tail(tmp_path):
    path = str(tmp_path / "os")
    store = replication.ObjectStore(path)
    _fill(store)
    with open(os.path.join(path, "g.edges.wal")) as f:
        lines = f.read().splitlines()
    assert [json.loads(x) for x in lines] == [[[0, 5, 1, 0, 6], True, 4]]
    with open(os.path.join(path, "g.edges.wal"), "a") as f:
        f.write('[[0,5,1,0,7],tr')                 # a crash mid-append
    with open(os.path.join(path, "meta.wal"), "a") as f:
        f.write('["g.t_R",')
    again = replication.ObjectStore(path)
    assert script.tables(again) == script.tables(store)


# ---------------------------------------------------------------------------
# the log's watermarks and the epoch fence
# ---------------------------------------------------------------------------

def _logged_db(log):
    db = GraphDB(StoreConfig(**script.REC_CFG), replication_log=log,
                 device="cpu")
    log.db = db
    db.vertex_type("node", f_attrs=("w",), i_attrs=("tag",))
    db.edge_type("link")
    return db


def test_fenced_log_ships_nothing():
    store = replication.ObjectStore()
    log = replication.ReplicationLog(store, ship_waves=True)
    db = _logged_db(log)
    db.create_vertex("node", 1)
    t_r = store.get_meta("g.t_R")
    log.epoch = 1
    store.put_meta("g.epoch", 2)
    db.create_vertex("node", 2)           # commits; the ship is fenced
    assert log.lag() == 2
    with pytest.raises(replication.Fenced, match="fenced"):
        log.sweep()
    assert store.get_meta("g.t_R") == t_r and log.lag() == 2
    assert (0, 2) not in store.tables["g.vertices"]
    log.epoch = 2                          # the new primary's epoch ships
    assert log.sweep() == 2 and store.get_meta("g.t_R") == db.clock


def test_dropped_ship_round_keeps_the_watermarks():
    store = replication.ObjectStore()
    log = replication.ReplicationLog(store, ship_waves=True)
    db = _logged_db(log)
    db.faults = faults.FaultInjector().inject(
        "replication.ship.drop", action="race", times=(1, 2))
    db.create_vertex("node", 1)
    marks = (store.get_meta("g.t_R"), store.get_meta("g.wave_frontier"))
    db.create_vertex("node", 2)
    with pytest.raises(IOError, match="dropped"):
        log.sweep()
    assert (store.get_meta("g.t_R"),
            store.get_meta("g.wave_frontier")) == marks
    _t_r_never_ahead(log)
    assert log.sweep() == 2 and log.lag() == 0
    assert store.get_meta("g.wave_frontier") == db.wave_seq


def test_commit_wave_ships_each_wave_record():
    store = replication.ObjectStore()
    log = replication.ReplicationLog(store, ship_waves=True)
    db = _logged_db(log)
    txns = []
    for k in range(3):
        t = db.create_transaction()
        db.write([writes.CreateVertex("node", k)], txn=t)
        txns.append(t)
    db.write(txns, caps=db.caps.__class__(create_v=1))   # three chunks
    assert sorted(store.tables["g.waves"]) == [(1,), (2,), (3,)]
    assert [store.tables["g.waves"][(s,)][0] for s in (1, 2, 3)] == list(
        db.wave_log)


# ---------------------------------------------------------------------------
# fast restart and shared attach: no database shares memory with another
# ---------------------------------------------------------------------------

def _store_np(db):
    return {f: getattr(db.store, f).numpy().copy() for f in FIELDS}


def _same_store(db, arrays):
    return all(np.array_equal(getattr(db.store, f).numpy(), arrays[f])
               for f in FIELDS)


def _disjoint(a, b):
    return all(not np.shares_memory(getattr(a.store, f).numpy(),
                                    getattr(b.store, f).numpy())
               for f in FIELDS)


def _written_db():
    db = _logged_db(replication.ReplicationLog(replication.ObjectStore()))
    g = db.write([writes.CreateVertex("node", k, {"w": float(k)})
                  for k in range(6)]).gids
    db.write([writes.CreateEdge(g[0], g[k], "link") for k in (1, 2, 3)])
    return db, g


def test_hold_copies_the_store():
    db, g = _written_db()
    cache = recovery.FastRestartCache()
    cache.hold("p", db)
    held = cache._slots["p"]["store"]
    assert all(not np.shares_memory(held[f], getattr(db.store, f).numpy())
               for f in FIELDS)
    before = {f: a.copy() for f, a in held.items()}
    db.write([writes.UpdateVertex(g[1], "node", {"w": 9.0}),
              writes.CreateVertex("node", 50)])
    db.delete_vertex(g[0])
    assert all(np.array_equal(held[f], before[f]) for f in FIELDS)
    r = cache.restart("p", device="cpu")
    assert _same_store(r, before)
    assert r.get_vertex("node", 1)["w"] == 1.0


def test_restarted_dbs_own_their_tensors():
    db, g = _written_db()
    cache = recovery.FastRestartCache()
    cache.hold("p", db)
    a = cache.restart("p", device="cpu")
    b = cache.restart("p", device="cpu")
    assert _disjoint(a, b) and _disjoint(a, db) and _disjoint(b, db)
    want = _store_np(b)
    a.write([writes.UpdateVertex(g[1], "node", {"w": 5.0})])
    a.delete_vertex(g[0])
    a.run_compaction()
    assert _same_store(b, want)
    assert (a.dl_count is not b.dl_count and a.v_free is not b.v_free
            and a.v_free[0] is not b.v_free[0])
    assert a.replication_log is None and a.task_queue is None
    assert b.get_edges(g[0]) == db.get_edges(g[0])


def test_attached_dbs_own_their_tensors():
    db, g = _written_db()
    cache = recovery.FastRestartCache()
    cache.hold("p", db)
    man = cache.export_shared("p")
    try:
        with pytest.raises(ValueError, match="already exported"):
            cache.export_shared("p")
        a = recovery.attach_shared(man, device="cpu")
        b = recovery.attach_shared(man, device="cpu")
        want = _store_np(b)
        assert _disjoint(a, b)
        a.write([writes.UpdateVertex(g[2], "node", {"w": -1.0})])
        a.delete_vertex(g[3])
        assert _same_store(b, want)
        c = recovery.attach_shared(man, device="cpu")     # segment intact
        assert _same_store(c, want)
        assert c.get_vertex("node", 2)["w"] == 2.0
    finally:
        cache.drop("p")
    assert cache.restart("p", device="cpu") is None


def test_wire_db_sets_every_attribute_init_sets():
    db, _ = _written_db()
    cache = recovery.FastRestartCache()
    cache.hold("p", db)
    r = cache.restart("p", device="cpu")
    assert set(vars(r)) == set(vars(db))
    for k in ("clock", "wave_seq", "config_epoch", "compaction_watermark"):
        assert getattr(r, k) == getattr(db, k), k
    assert r.device == db.device and r.stats["bg_compactions"] == 0


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    db, _ = _written_db()
    store = db.replication_log.os
    for fn in (recovery.best_effort_recover, recovery.consistent_recover):
        with pytest.raises(RuntimeError, match="device='cuda'"):
            fn(store, db, db.cfg)
    cache = recovery.FastRestartCache()
    cache.hold("p", db)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        cache.restart("p")
    man = cache.export_shared("p")
    try:
        with pytest.raises(RuntimeError, match="device='cuda'"):
            recovery.attach_shared(man)
    finally:
        cache.drop("p")
