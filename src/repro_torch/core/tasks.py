"""Task framework: asynchronous workflows (§3.3).

Port of ``repro/core/tasks.py``.  A1 runs long maintenance work
(DeleteGraph cascades, GC) as *tasks* on a global queue, executed by
low-priority workers; big tasks reschedule themselves or spawn subtasks.

The queue is coordinator state on the host; ``pump()`` is the cooperative
low-priority worker that the serving loop calls between query batches, so
maintenance never preempts foreground work.  Tasks return a list of
follow-up tasks (possibly themselves) to model rescheduling and spawning.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional

import numpy as np

from repro_torch.core import faults as faults_mod
from repro_torch.core.addressing import TS_INF, gid_of


@dataclasses.dataclass
class Task:
    """A unit of deferred work.  ``fn(db, task) -> list[Task]`` spawns more."""
    name: str
    fn: Callable
    state: dict = dataclasses.field(default_factory=dict)
    priority: int = 10          # lower = sooner; foreground never waits on it
    task_id: int = -1


class TaskQueue:
    """Global task queue + stateless worker pool (cooperative)."""

    def __init__(self, db):
        self.db = db
        self._q: list[Task] = []
        self._ids = itertools.count()
        self.completed: list[str] = []
        # serving hook: runs at the top of every pump quantum, so deadline
        # work (e.g. closing a due write wave) makes progress even when the
        # query stream is empty and nothing is queued
        self.on_pump: Optional[Callable] = None
        self.fault_restarts = 0

    def enqueue(self, task: Task) -> int:
        task.task_id = next(self._ids)
        self._q.append(task)
        self._q.sort(key=lambda t: (t.priority, t.task_id))
        return task.task_id

    def pending(self) -> int:
        return len(self._q)

    def pump(self, budget: int = 1) -> int:
        """Run up to ``budget`` tasks (one worker-thread quantum each).

        A quantum killed by an injected fault models a crashed low-priority
        worker: the queue survives, the task re-enqueues (its ``state`` dict
        carries whatever progress the quantum had checkpointed), and the
        next pump retries; the workers are stateless for exactly this
        reason."""
        if self.on_pump is not None:
            self.on_pump()
        ran = 0
        while self._q and ran < budget:
            task = self._q.pop(0)
            try:
                faults_mod.check(self.db, "tasks.quantum")
                spawned = task.fn(self.db, task) or []
            except faults_mod.InjectedFault:
                self.fault_restarts += 1
                self.enqueue(task)              # crashed worker: retry later
                ran += 1
                continue
            for s in spawned:
                self.enqueue(s)
            self.completed.append(task.name)
            ran += 1
        return ran

    def drain(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.pump():
                return
        raise RuntimeError("task queue did not drain")


# ---------------------------------------------------------------------------
# Standard maintenance workflows
# ---------------------------------------------------------------------------

def compaction_task() -> Task:
    def run(db, task):
        db.run_compaction()
        return []
    return Task("compact-edges", run)


def index_compaction_task() -> Task:
    def run(db, task):
        db.run_index_compaction()
        return []
    return Task("compact-index", run)


def vacuum_task() -> Task:
    def run(db, task):
        db.vacuum()
        return []
    return Task("vacuum", run)


def wave_replay_task(*, per_quantum: int = 8) -> Task:
    """Replica tail-replay (§4): drain ``db.wave_inbox`` (committed wave
    records the frontend fanned out) through ``writes.replay_wave``,
    ``per_quantum`` records a quantum, rescheduling while the inbox is not
    empty.  High priority (replication lag is user-visible staleness) but
    cooperative: a quantum killed by ``tasks.quantum`` re-enqueues, and the
    frontier is where the last applied record left it (replay is
    idempotent by seq)."""
    from repro_torch.core import writes as writes_mod

    def run(db, task):
        n = 0
        while db.wave_inbox and n < per_quantum:
            writes_mod.replay_wave(db, db.wave_inbox.popleft())
            n += 1
        return [task] if db.wave_inbox else []

    return Task("wave-replay", run, priority=5)


def background_compaction_task(*, kinds=None, max_rebuilds: int = 4) -> Task:
    """Two-phase threshold-triggered compaction (§2.2 concurrent GC, §3.3).

    Quantum 1 (*build*): fold the delta logs into a compacted shadow CSR /
    index at ``gc_ts``, off the commit path; reads and write waves keep
    running against the live store.  Quantum 2 (*handoff*): merge the
    shadow through ``GraphDB.try_handoff``, which replays the delta tail
    appended in between.  A raced structural mutation (edge or vertex
    delete, inline compaction) invalidates the shadow and it is rebuilt, up
    to ``max_rebuilds`` times; then the inline stop-the-world compaction
    runs, so progress is guaranteed.  ``kinds=None`` reads the fill
    watermarks at build time."""
    def run(db, task):
        st = task.state
        if "kinds" not in st:
            st["kinds"] = tuple(kinds) if kinds else tuple(db._kinds_needed())
            st["rebuilds"] = 0
        if not st["kinds"]:
            db._bg_compaction_pending = False
            return []
        if "handle" not in st:
            st["handle"] = db.begin_compaction(st["kinds"])
            return [task]                     # handoff on a later quantum
        if faults_mod.check(db, "tasks.compaction.handoff"):
            # chaos site ("race"): a structural mutation landed between
            # build and handoff; bump the epoch so the shadow is stale and
            # the rebuild path below is the one exercised
            db.epochs["delete_e"] += 1
        res = db.try_handoff(st.pop("handle"))
        st["kinds"] = tuple(k for k, ok in res.items() if not ok)
        if not st["kinds"]:
            db._bg_compaction_pending = False
            return []
        st["rebuilds"] += 1
        db.stats["compaction_rebuilds"] += 1
        if st["rebuilds"] >= max_rebuilds:
            if "edges" in st["kinds"]:
                db.run_compaction()
            if "index" in st["kinds"]:
                db.run_index_compaction()
            db._bg_compaction_pending = False
            return []
        return [task]                         # rebuild the raced kinds
    return Task("bg-compaction", run, priority=5)


def _live_rows(db):
    """(vtype, v_delete) of the whole store, on the host."""
    return db.store.vtype.cpu().numpy(), db.store.v_delete.cpu().numpy()


def delete_type_task(vtype: str, *, chunk: int = 64) -> Task:
    """Delete all vertices of a type, chunk by chunk, rescheduling itself
    (the paper's DeleteType: "execute for a long time ... delete all the
    vertices, edges and indexes associated with the type")."""
    def run(db, task):
        vtid = db.vt(vtype).type_id
        vtypes, v_del = _live_rows(db)
        S, cap_v = db.cfg.n_shards, db.cfg.cap_v
        todo = []
        for row in np.where((vtypes == vtid) & (v_del == TS_INF))[0]:
            shard, slot = int(row) // cap_v, int(row) % cap_v
            todo.append(gid_of(shard, slot, S))
            if len(todo) >= chunk:
                break
        if not todo:
            return []
        # stage each cascade in its own txn, commit the chunk as one wave;
        # intra-batch losers (shared edges) stay live and retry next quantum
        from repro_torch.core.writes import DeleteVertex
        txns = []
        for gid in todo:
            t = db.create_transaction()
            try:
                db.write([DeleteVertex(gid)], txn=t)
            except ValueError:
                continue
            txns.append(t)
        if txns:
            db.write(txns)
        return [task]       # reschedule until no vertices remain
    return Task(f"delete-type:{vtype}", run)


def delete_graph_task(graph_mgr, tenant: str, graph: str) -> Task:
    """DeleteGraph workflow: mark Deleting, spawn per-type deletes, then
    free the graph (§3.3).  ``graph_mgr`` (the serving tier's, ROADMAP
    queue 1 item 11) may be ``None``."""
    def run(db, task):
        phase = task.state.setdefault("phase", "mark")
        if phase == "mark":
            meta = db.catalog.mark_deleting(tenant, graph)
            task.state["phase"] = "wait"
            spawned = [delete_type_task(name) for name in list(meta.vtypes)]
            return spawned + [task]
        # wait phase: done when no vertices remain
        vtypes, v_del = _live_rows(db)
        if ((vtypes >= 0) & (v_del == TS_INF)).sum() > 0:
            return [task]
        db.run_compaction()
        db.run_index_compaction()
        db.vacuum()
        db.catalog.drop_graph(tenant, graph)
        if graph_mgr is not None:
            graph_mgr.release(tenant, graph)
        return []
    return Task(f"delete-graph:{graph}", run)
