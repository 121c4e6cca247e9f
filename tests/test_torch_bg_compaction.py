"""PyTorch port, background compaction against the JAX package:
``GraphDB.begin_compaction`` / ``try_handoff`` / the background task and
``store.replay_log_tail``.

The seeded cases follow ``tests/test_chaos_compaction.py`` (the pinned
background cycle, a raced edge delete, the rebuild cap's inline fallback,
the index tail, a raced vertex delete and the four fixed interleavings,
each beside its uncompacted twin) and are compared with the committed JAX
fixture step by step (see ``test_torch_tasks.py``); every snapshot also
holds the host fill mirrors equal to the device counts.  The port writes
its live store in place while a shadow built from it waits for its
handoff, so the tests here also show that a wave between build and handoff
leaves the shadow alone.
"""
import numpy as np
import pytest
import torch

import torch_durability_script as script
from repro_torch.core import writes
from repro_torch.core.addressing import StoreConfig
from repro_torch.core.graphdb import GraphDB
from repro_torch.core.store import FIELDS, replay_log_tail
from repro_torch.core.tasks import TaskQueue
from test_torch_store_index_edges import one_torch_thread  # noqa: F401
from test_torch_tasks import ASPECTS, assert_case_matches_jax, jax_cases

CASES = tuple(n for n in script.CASES if n.startswith("chaos_"))


@pytest.mark.parametrize("aspect", ASPECTS)
@pytest.mark.parametrize("name", CASES)
def test_case_matches_jax(name, aspect, tmp_path_factory):
    assert_case_matches_jax(name, aspect, tmp_path_factory)


def test_cases_show_what_they_are_for():
    """The fixture's own values: a handoff with a replayed tail, refusals
    that rebuild, the inline fallback at the cap, and pinned reads equal
    to the uncompacted twin's."""
    c = jax_cases()["cases"]
    cyc = {s["label"]: s for s in c["chaos_pinned_bg_cycle"]["steps"]}
    assert cyc["handoff"]["db"]["mirrors"]["stats"]["bg_compactions"] == 1
    assert cyc["handoff"]["db"]["mirrors"]["dl_count"] == [5, 0]
    assert cyc["handoff"]["pinned"] == cyc["scheduled"]["pinned"]
    assert cyc["handoff"]["now"] == cyc["handoff"]["ref_now"]
    raced = c["chaos_raced_delete"]["steps"]
    assert raced[1]["db"]["mirrors"]["stats"]["compaction_rebuilds"] == 1
    assert raced[2]["db"]["mirrors"]["stats"]["bg_compactions"] == 1
    cap = c["chaos_rebuild_cap"]["steps"][-1]["db"]["mirrors"]["stats"]
    assert cap["compactions"] == 1
    assert c["chaos_index_tail"]["steps"][-1]["ok"] == {"index": True}
    assert c["chaos_vertex_delete_index"]["steps"][-1]["ok"] == {
        "index": False}
    for k in range(len(script.FIXED_SCHEDULES)):
        last = c[f"chaos_schedule_{k}"]["steps"][-1]
        assert all(p[1] == p[2] for p in last["pinned"])
    assert sum(c[f"chaos_schedule_{k}"]["steps"][-1]["db"]["mirrors"][
        "stats"]["bg_compactions"] for k in range(4)) >= 4


# ---------------------------------------------------------------------------
# replay_log_tail against JAX's, live
# ---------------------------------------------------------------------------

def _tails(rng, S, cap):
    """Per-shard (w, n): a tail reaching cap, an empty tail (w == n), a
    tail from 0, and random ones."""
    w = rng.integers(0, cap + 1, S)
    n = np.minimum(w + rng.integers(0, cap + 1, S), cap)
    w[0], n[0] = rng.integers(0, cap), cap
    if S > 1:
        w[1] = n[1] = rng.integers(0, cap + 1)
    if S > 2:
        w[2] = 0
    return w.astype(np.int32), n.astype(np.int32)


@pytest.mark.parametrize("S,cap", [(1, 8), (3, 16), (4, 16)])
def test_replay_log_tail_matches_jax(S, cap):
    import jax.numpy as jnp
    from repro.core.store import replay_log_tail as jax_replay
    rng = np.random.default_rng(S * 100 + cap)
    for _ in range(4):
        dst = rng.integers(-5, 5, S * cap).astype(np.int32)
        src = rng.integers(100, 10**6, S * cap).astype(np.int32)
        w, n = _tails(rng, S, cap)
        want = np.asarray(jax_replay(jnp.asarray(dst), jnp.asarray(src),
                                     jnp.asarray(w), jnp.asarray(n),
                                     cap=cap))
        td, ts = torch.from_numpy(dst.copy()), torch.from_numpy(src.copy())
        got = replay_log_tail(td, ts, torch.from_numpy(w),
                              torch.from_numpy(n), cap=cap)
        assert np.array_equal(got.numpy(), want), (w, n)
        assert np.array_equal(td.numpy(), dst)      # neither input written
        assert np.array_equal(ts.numpy(), src)


# ---------------------------------------------------------------------------
# the shadow and the live store
# ---------------------------------------------------------------------------

COMPACTED = {"edges": ("oe_indptr", "oe_dst", "oe_type", "oe_create",
                       "oe_delete", "ie_indptr", "ie_src", "ie_type",
                       "ie_create", "ie_delete") + tuple(
                           f"{p}_{n}" for p in ("dl", "il") for n in (
                               "slot", "nbr", "type", "create", "delete",
                               "count")),
             "index": tuple(f"{p}_{n}" for p in ("ix", "xd") for n in (
                 "vtype", "key", "gid", "create", "delete", "count"))}


def _loaded_db():
    db = GraphDB(StoreConfig(**script.CHAOS_CFG), device="cpu")
    db.vertex_type("hub")
    db.vertex_type("spoke")
    db.edge_type("link")
    hub = db.create_vertex("hub", 0)
    spokes = db.write([writes.CreateVertex("spoke", k)
                       for k in range(1, 30)]).gids
    db.write([writes.CreateEdge(hub, s, "link", check=False)
              for s in spokes])
    return db, hub, spokes


def test_waves_between_build_and_handoff_leave_the_shadow_alone():
    db, hub, spokes = _loaded_db()
    handle = db.begin_compaction(("edges", "index"))
    shadow = {k: {f: getattr(s, f).clone() for f in COMPACTED[k]}
              for k, s in handle["shadow"].items()}
    ts0 = db.clock
    want0 = sorted(db.get_edges(hub, read_ts=ts0))
    # creates, a checked edge and an update land on the live store only
    late = db.write([writes.CreateVertex("spoke", 100 + k)
                     for k in range(3)]).gids
    db.write([writes.CreateEdge(hub, g, "link") for g in late]
             + [writes.UpdateVertex(spokes[0], "spoke", {})])
    for k, s in handle["shadow"].items():
        for f in COMPACTED[k]:
            assert torch.equal(getattr(s, f), shadow[k][f]), (k, f)
    assert db.try_handoff(handle) == {"edges": True, "index": True}
    for c in ("dl_count", "il_count", "xd_count"):
        assert getattr(db, c).tolist() == getattr(db.store, c).tolist()
    assert db.dl_count.tolist() == [3, 0] and db.xd_count.sum() == 3
    assert sorted(db.get_edges(hub, read_ts=ts0)) == want0
    assert {n for n, _ in db.get_edges(hub)} == set(spokes) | set(late)
    for k, g in enumerate(late):
        assert db.lookup_vertex("spoke", 100 + k) == (g, True)


def test_handoff_refused_after_an_inline_compaction():
    db, hub, _ = _loaded_db()
    handle = db.begin_compaction(("edges",))
    db.run_compaction()
    assert db.try_handoff(handle) == {"edges": False}
    assert db.stats["bg_compactions"] == 0


def test_handoff_replaces_only_the_compacted_fields():
    db, hub, spokes = _loaded_db()
    before = {f: getattr(db.store, f) for f in FIELDS}
    handle = db.begin_compaction(("edges",))
    db.try_handoff(handle)
    kept = [f for f in FIELDS if getattr(db.store, f) is before[f]]
    assert sorted(kept) == sorted(set(FIELDS) - set(COMPACTED["edges"]))


def test_vindex_kind_folds_at_handoff():
    db = GraphDB(StoreConfig(**script.VEC_CFG), device="cpu")
    db.vertex_type("doc", f_attrs=("f0", "f1", "f2", "f3"))
    g = db.create_vertex("doc", 1, {"f0": 1.0})
    db.vector_index("doc")
    db.update_vertex(g, "doc", {"f0": 2.0})
    assert int(db.vx_count.sum()) == 2
    handle = db.begin_compaction(("vindex",))
    assert handle["shadow"] == {}
    assert db.try_handoff(handle) == {"vindex": True}
    assert int(db.vx_count.sum()) == 1 and db.stats["vindex_compactions"] == 1


def test_vacuum_reclaims_only_below_the_pin():
    db = GraphDB(StoreConfig(**script.REC_CFG), device="cpu")
    db.vertex_type("n")
    gids = db.write([writes.CreateVertex("n", k) for k in range(8)]).gids
    db.delete_vertex(gids[0])
    pin = db.clock
    db.active_query_ts.append(pin)
    db.delete_vertex(gids[1])             # dead after the pin: kept
    assert db.vacuum() == 1
    assert db.v_free[gids[0] % 4] == [gids[0] // 4]
    assert db._read_header_host(gids[1], pin)[2]
    db.active_query_ts.remove(pin)
    assert db.vacuum() == 1
    row = (gids[1] % 4) * db.cfg.cap_v + gids[1] // 4
    assert int(db.store.vtype[row]) == -1
    again = db.write([writes.CreateVertex("n", 100 + k) for k in range(2)])
    assert sorted(again.gids) == sorted(gids[:2])


def test_background_task_through_the_queue_with_a_pin():
    """A pinned snapshot taken before the build reads the same edges after
    the handoff; the fold keeps the versions it needs."""
    db, hub, spokes = _loaded_db()
    db.task_queue = TaskQueue(db)
    pin = db.clock
    db.active_query_ts.append(pin)
    db.write([writes.DeleteEdge(hub, s, "link") for s in spokes[:4]])
    want = sorted(db.get_edges(hub, read_ts=pin))
    db.compaction_watermark = 0.0
    db.create_vertex("spoke", 500)        # a wave: schedules the task
    db.task_queue.drain()
    assert db.stats["bg_compactions"] >= 1
    assert sorted(db.get_edges(hub, read_ts=pin)) == want
    assert len(want) == len(spokes)
