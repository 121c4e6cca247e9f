"""PyTorch port, the task framework and the fault sites against the JAX
package: ``core/tasks.py`` (priorities, DeleteType, DeleteGraph, a pinned
query across maintenance quanta, the wave-replay task), ``GraphDB.vacuum``
and ``core/faults.py``.

The JAX side of the seeded cases is a committed fixture
(``tests/fixtures/torch_durability``, made by its ``make_fixture.py`` from
``tests/torch_durability_script.py``; the tests compile no JAX program).
Every store field (by SHA-256 digest), host mirror, stat, epoch, task
queue, pinned read and ObjectStore table must be equal to JAX's bit for
bit, step by step.  ``FaultInjector`` is pure numpy in both packages and
is compared live.  This file also holds the helpers the two other files of
the slice (``test_torch_bg_compaction.py``, ``test_torch_durability.py``)
import.
"""
import functools
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_durability_script as script
from repro_torch.core import faults, recovery, replication, tasks, writes
from repro_torch.core.addressing import StoreConfig
from repro_torch.core.graphdb import GraphDB
from repro_torch.core.query.executor import QueryCaps
from test_torch_store_index_edges import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_durability"
ASPECTS = ("store", "mirrors", "rest")


def port_namespace():
    cpu = dict(device="cpu")
    return script.namespace(
        GraphDB=functools.partial(GraphDB, **cpu), StoreConfig=StoreConfig,
        QueryCaps=QueryCaps, w=writes, tasks=tasks, faults=faults,
        replication=replication,
        best_effort_recover=functools.partial(
            recovery.best_effort_recover, **cpu),
        consistent_recover=functools.partial(
            recovery.consistent_recover, **cpu),
        FastRestartCache=recovery.FastRestartCache,
        restart=lambda cache, name: cache.restart(name, **cpu),
        attach_shared=lambda man: recovery.attach_shared(man, **cpu),
        np_of=lambda t: t.numpy())


class PortRecorder(script.Recorder):
    """Records as the script does, and holds every database it snapshots
    to the port's own invariant: host fill mirrors equal the device
    counts (the planner's delta windows read the mirrors)."""

    def step(self, label, dbs=(), **kw):
        for name, db in dbs:
            for c in ("dl_count", "il_count", "xd_count"):
                assert getattr(db, c).tolist() == getattr(
                    db.store, c).tolist(), f"{label}: {name}.{c}"
        super().step(label, dbs, **kw)


_RUNS = {}


def port_run(name, tmp_path_factory):
    """Run one case through the port once per test process."""
    if name not in _RUNS:
        rec = PortRecorder(port_namespace())
        args = ((str(tmp_path_factory.mktemp(name)),)
                if name in script.NEEDS_TMPDIR else ())
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            script.CASES[name](rec.m, rec, *args)
        finally:
            torch.set_num_threads(n)
        _RUNS[name] = rec
    return _RUNS[name]


@functools.lru_cache(maxsize=None)
def jax_cases() -> dict:
    return json.loads((FIXTURE / "durability.json").read_text())


def jax_stores() -> dict:
    with np.load(FIXTURE / "durability.npz") as z:
        return {k: z[k] for k in z.files}


def _first_difference(a, b, path=""):
    if type(a) is not type(b):
        return f"{path}: {a!r:.80} != {b!r:.80}"
    if isinstance(a, dict):
        for k in sorted(set(a) | set(b)):
            if k not in a or k not in b:
                return f"{path}/{k}: only in {'port' if k in a else 'JAX'}"
            d = _first_difference(a[k], b[k], f"{path}/{k}")
            if d:
                return d
        return None
    if isinstance(a, list):
        if len(a) != len(b):
            return f"{path}: {len(a)} items != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            d = _first_difference(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if a == b else f"{path}: {a!r:.80} != {b!r:.80}"


def _aspect(step, aspect):
    """The part of a recorded step one test compares: the store digests,
    the host mirrors, or everything else (queues, reads, logs)."""
    out = {}
    for k, v in step.items():
        if isinstance(v, dict) and "digest" in v:
            if aspect != "rest":
                out[k] = v["digest" if aspect == "store" else "mirrors"]
        elif aspect == "rest":
            out[k] = v
    return out


def assert_case_matches_jax(name, aspect, tmp_path_factory):
    got = port_run(name, tmp_path_factory).json()["steps"]
    want = jax_cases()["cases"][name]["steps"]
    assert [s["label"] for s in got] == [s["label"] for s in want]
    for k, (g, w) in enumerate(zip(got, want)):
        d = _first_difference(_aspect(json.loads(json.dumps(g)), aspect),
                              _aspect(w, aspect))
        assert d is None, f"{name}, step {k} ({w['label']}): {d}"


def test_fixture_is_from_this_script():
    sha = hashlib.sha256(Path(script.__file__).read_bytes()).hexdigest()
    assert jax_cases()["script_sha256"] == sha, (
        "tests/torch_durability_script.py changed: regenerate the fixture "
        "with tests/fixtures/torch_durability/make_fixture.py")


def test_fixture_covers_every_case():
    assert sorted(jax_cases()["cases"]) == sorted(script.CASES)


CASES = ("tasks_priority", "tasks_delete_type", "tasks_delete_graph",
         "tasks_pump_pinned", "vacuum", "fault_sites")


@pytest.mark.parametrize("aspect", ASPECTS)
@pytest.mark.parametrize("name", CASES)
def test_case_matches_jax(name, aspect, tmp_path_factory):
    assert_case_matches_jax(name, aspect, tmp_path_factory)


def test_cases_show_what_they_are_for():
    """The fixture's own values: the cascade rescheduled itself, the
    pinned query kept its results, vacuum reclaimed five slots that the
    next creates reuse, and each fault site fired."""
    c = jax_cases()["cases"]
    runs = c["tasks_delete_type"]["steps"][-2]["queue"]["completed"]
    assert runs.count("delete-type:actor") >= 4
    pinned = [s["result"] for s in c["tasks_pump_pinned"]["steps"][:4]]
    assert all(r == pinned[0] for r in pinned)
    assert c["tasks_pump_pinned"]["steps"][-1]["result"] != pinned[0]
    vac = c["vacuum"]["steps"]
    assert vac[1]["n"] == 5
    free = [{(s, x) for s, f in enumerate(v["db"]["mirrors"]["v_free"])
             for x in f} for v in vac[1:]]
    reused = {(g % 4, g // 4) for g in vac[2]["gids"]} & free[0]
    assert reused and free[0] - free[1] == reused
    fired = {(s, a) for s, _, a in c["fault_sites"]["steps"][-1]["fired"]}
    assert fired == {("tasks.quantum", "raise"),
                     ("tasks.compaction.handoff", "race"),
                     ("engine.wave", "raise"), ("engine.wave", "stall")}


# ---------------------------------------------------------------------------
# FaultInjector: both packages' are numpy, compared live
# ---------------------------------------------------------------------------

def _fire_sequence(mod, seed):
    """Visit three sites 60 times each under a mix of schedules,
    probabilities and caps; returns every outcome and the fired list."""
    inj = mod.FaultInjector(seed=seed)
    inj.inject("engine.wave", action="raise", prob=0.2, max_fires=3)
    inj.inject("engine.wave", action="stall", prob=0.3)
    inj.inject("tasks.quantum", action="raise", times=(2, 5, 40))
    inj.inject("tasks.quantum", action="race", prob=0.1, times=(7,))
    inj.inject("replication.ship.drop", action="race", prob=0.5,
               max_fires=9)
    out = []
    for k in range(60):
        for site in ("engine.wave", "tasks.quantum",
                     "replication.ship.drop", "never.armed"):
            try:
                out.append(inj.check(site))
            except mod.InjectedFault as e:
                out.append((e.site, e.visit, str(e)))
    return out, inj.fired, {s: inj.visits(s) for s in (
        "engine.wave", "tasks.quantum", "never.armed")}


@pytest.mark.parametrize("seed", (0, 1, 7, 12345))
def test_fault_injector_fires_as_jax(seed):
    from repro.core import faults as jax_faults
    got = _fire_sequence(faults, seed)
    assert got == _fire_sequence(jax_faults, seed)
    assert len(got[1]) > 10


def test_fault_check_without_injector_is_a_noop():
    class Owner:
        pass
    assert faults.check(Owner(), "engine.wave") is False
    with pytest.raises(ValueError, match="unknown fault action"):
        faults.FaultInjector().inject("x", action="explode")


def _small_db():
    db = GraphDB(StoreConfig(**script.CHAOS_CFG), device="cpu")
    db.vertex_type("hub")
    db.vertex_type("spoke")
    db.edge_type("link")
    return db


def test_engine_wave_raises_before_pinning():
    db = _small_db()
    hub = db.create_vertex("hub", 0)
    db.create_edge(hub, db.create_vertex("spoke", 1), "link")
    db.faults = faults.FaultInjector().inject("engine.wave", times=(0,))
    q = [{"type": "hub", "id": 0, "_out_edge": {
        "type": "link", "_target": {"type": "spoke", "select": "count"}}}]
    with pytest.raises(faults.InjectedFault, match="engine.wave"):
        db.query(q)
    assert db.active_query_ts == []
    assert db.query(q).counts.tolist() == [1]


# ---------------------------------------------------------------------------
# the queue's own contract
# ---------------------------------------------------------------------------

def test_pump_calls_on_pump_and_drain_gives_up():
    db = _small_db()
    tq = tasks.TaskQueue(db)
    calls = []
    tq.on_pump = lambda: calls.append(1)
    assert tq.pump(3) == 0 and calls == [1]
    tq.enqueue(tasks.Task("forever", lambda d, t: [t]))
    with pytest.raises(RuntimeError, match="did not drain"):
        tq.drain(max_steps=5)
    assert len(calls) == 6 and tq.completed == ["forever"] * 5


def test_crashed_quantum_keeps_the_task_state():
    db = _small_db()
    tq = tasks.TaskQueue(db)
    db.faults = faults.FaultInjector().inject("tasks.quantum", times=(1,))

    def step(d, t):
        t.state["n"] = t.state.get("n", 0) + 1
        return [t] if t.state["n"] < 3 else []
    tq.enqueue(tasks.Task("steps", step))
    tq.drain()
    assert tq.fault_restarts == 1 and tq.completed == ["steps"] * 3


def test_watermark_schedules_one_background_task():
    db = _small_db()
    db.task_queue = tasks.TaskQueue(db)
    hub = db.create_vertex("hub", 0)
    spokes = db.write([writes.CreateVertex("spoke", k)
                       for k in range(1, 40)]).gids
    for s in spokes:                     # every wave is over the watermark
        db.create_edge(hub, s, "link", check=False)
    assert db._bg_compaction_pending
    assert [t.name for t in db.task_queue._q] == ["bg-compaction"]
    db.task_queue.drain()
    assert not db._bg_compaction_pending and db.stats["bg_compactions"] == 1
    assert db.dl_count.tolist() == db.store.dl_count.tolist() == [0, 0]


def test_delete_graph_releases_through_the_graph_manager():
    db = _small_db()
    db.create_vertex("hub", 0)       # the types' catalog proxies are cached
    db.create_vertex("spoke", 1)
    released = []

    class Manager:
        def release(self, tenant, graph):
            released.append((tenant, graph))
    tq = tasks.TaskQueue(db)
    tq.enqueue(tasks.delete_graph_task(Manager(), db.tenant, db.graph))
    tq.drain()
    assert released == [(db.tenant, db.graph)]


def test_wave_replay_task_applies_the_jax_records():
    """The JAX write path's committed wave records (the write fixture)
    fanned into ``wave_inbox`` and drained by ``wave_replay_task``, with a
    crashed quantum: the port's replica equals the JAX replica."""
    import torch_write_script as wscript
    from repro_torch.core.txn import BatchCaps
    from test_torch_writes import FIXTURE as WFIX, PARTS
    meta = json.loads((WFIX / "writes.json").read_text())
    db = GraphDB(StoreConfig(**wscript.CFG), caps=BatchCaps(**wscript.CAPS),
                 device="cpu")
    wscript.schema(db)
    db.wave_inbox.extend(meta["records"])
    db.faults = faults.FaultInjector().inject("tasks.quantum", times=(1,))
    tq = tasks.TaskQueue(db)
    tq.enqueue(tasks.wave_replay_task(per_quantum=3))
    tq.drain()
    assert tq.fault_restarts == 1 and not db.wave_inbox
    assert db.wave_seq == meta["records"][-1]["seq"]
    with np.load(WFIX / "writes.npz") as z:
        for f in (f for fs in PARTS.values() for f in fs):
            got = getattr(db.store, f).numpy()
            assert np.array_equal(got.view(np.int32),
                                  z[f"replica/{f}"].view(np.int32)), f
