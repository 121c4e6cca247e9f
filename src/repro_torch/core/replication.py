"""Replication to durable storage (§4): replication log + ObjectStore.

Port of ``repro/core/replication.py``:

  * every committed wave appends *logical* entries to the replication log
    (vertices as (vtype, key) -> columns, edges as endpoint keys: physical
    gids don't survive recovery, logical identities do);
  * the log is shipped to the ObjectStore synchronously with the request;
    on failure an asynchronous *sweeper* flushes FIFO;
  * the ObjectStore holds two tables per graph (vertices, edges) in both
    encodings at once: best-effort (last-writer-wins rows keyed by
    identity, with timestamped tombstones) and consistent (versioned rows
    keyed (identity, ts), plus the t_R watermark: "all writes below t_R
    are durable");
  * shipping is idempotent (both encodings tolerate replay).

Everything here lives on the host.  ObjectStore persistence is an
append-only write-ahead log per table, replayed on load.  The JAX package
encodes it with a third-party binary serializer; the port writes one JSON
line a record (standard library only), so the WAL *bytes* differ between
the packages while the tables and metas they load are equal: keys come
back as tuples, floats (JSON's shortest round-trip repr) exactly, and
``TOMBSTONE`` stays a string.  A torn last line (a crash mid-append) is
skipped on load.
Failure injection (``fail_next``, the ``replication.ship.drop`` site) cuts
the pipeline mid-transaction to reproduce the paper's partial-replication
scenarios.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Optional

from repro_torch.core import faults as faults_mod

TOMBSTONE = "__tombstone__"


class Fenced(IOError):
    """A deposed primary's log tried to advance durable state: the
    ObjectStore's configuration-epoch meta is newer than the log's (the §4
    epoch fence).  Nothing ships, the sweep raises, and the locally
    committed but never acknowledged writes die with the old primary."""


def _line(record) -> str:
    return json.dumps(record, separators=(",", ":")) + "\n"


def _records(fn: str):
    """The JSON records of one WAL file, a torn last line skipped."""
    with open(fn, encoding="utf-8") as f:
        for line in f:
            if line.endswith("\n"):
                yield json.loads(line)


class ObjectStore:
    """Durable KV tables with timestamp-conditional upsert (the Bing
    ObjectStore analogue).  Keys are tuples of ints, values JSON-safe."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.tables: dict[str, dict] = {}
        self.meta: dict = {}
        self._fail = 0
        self._lock = threading.Lock()
        if path:
            os.makedirs(path, exist_ok=True)
            self._load()

    # -- failure injection (tests / chaos) -----------------------------------
    def fail_next(self, n: int = 1) -> None:
        self._fail = n

    def _maybe_fail(self) -> None:
        if self._fail > 0:
            self._fail -= 1
            raise IOError("objectstore write failed (injected)")

    # -- persistence -----------------------------------------------------------
    def _wal(self, table: str):
        return os.path.join(self.path, f"{table}.wal") if self.path else None

    def _append_wal(self, table: str, record) -> None:
        wal = self._wal(table)
        if wal:
            with open(wal, "a", encoding="utf-8") as f:
                f.write(_line(record))

    def _load(self) -> None:
        for fn in sorted(os.listdir(self.path)):
            if not fn.endswith(".wal") or fn == "meta.wal":
                continue
            t = self.tables.setdefault(fn[:-4], {})
            for key, value, ts in _records(os.path.join(self.path, fn)):
                self._apply(t, tuple(key), value, ts)
        metaf = os.path.join(self.path, "meta.wal")
        if os.path.exists(metaf):
            for k, v in _records(metaf):
                self.meta[k] = v

    # -- the single-roundtrip conditional upsert (§4) ------------------------
    @staticmethod
    def _apply(table: dict, key: tuple, value, ts: int) -> None:
        cur = table.get(key)
        if cur is None or ts >= cur[1]:
            table[key] = (value, ts)

    def upsert(self, table: str, key: tuple, value, ts: int) -> None:
        """LWW upsert: newer timestamp wins; idempotent on replay."""
        with self._lock:
            self._maybe_fail()
            t = self.tables.setdefault(table, {})
            self._apply(t, key, value, ts)
            self._append_wal(table, [list(key), value, ts])

    def put_meta(self, key: str, value) -> None:
        with self._lock:
            self.meta[key] = value
            if self.path:
                with open(os.path.join(self.path, "meta.wal"), "a",
                          encoding="utf-8") as f:
                    f.write(_line([key, value]))

    def get_meta(self, key: str, default=None):
        return self.meta.get(key, default)

    def scan(self, table: str):
        return dict(self.tables.get(table, {}))

    def gc_tombstones(self, table: str, older_than_ts: int) -> int:
        """Offline tombstone GC (the paper's week-old cleanup)."""
        t = self.tables.get(table, {})
        dead = [k for k, (v, ts) in t.items()
                if v == TOMBSTONE and ts < older_than_ts]
        for k in dead:
            del t[k]
        return len(dead)


@dataclasses.dataclass
class LogEntry:
    ts: int
    kind: str     # 'v_upsert' | 'v_delete' | 'e_insert' | 'e_delete' | 'wave'
    key: tuple    # logical identity ('wave': the (seq,) singleton)
    value: Any = None


class ReplicationLog:
    """The replication log + sweeper (§4).

    ``ship_waves=True`` (a cluster frontend's durable log) also ships every
    committed *wave record* into a ``{graph}.waves`` table with a
    ``{graph}.wave_frontier`` meta: the WAL tail a failover reads back to
    bring a promoted replica to the commit frontier.  ``epoch`` arms the
    durable fence: a sweep whose epoch is older than the ObjectStore's
    ``{graph}.epoch`` meta raises :class:`Fenced`."""

    def __init__(self, objectstore: ObjectStore, *, graph: str = "g",
                 ship_waves: bool = False):
        self.os = objectstore
        self.graph = graph
        self.entries: list[LogEntry] = []    # FIFO, unshipped
        self.db = None                       # backref set by GraphDB owner
        self.shipped_ts = 0                  # durable t_R (never ahead)
        self.ship_waves = bool(ship_waves)
        self.epoch: Optional[int] = None     # config epoch (None = unfenced)
        self.faults = None                   # injector for db-less logs
        self._max_ts = 0                     # highest ts ever appended
        self._max_seq = 0                    # highest wave seq ever appended

    # -- called with each committed wave (writes.commit_wave) ----------------
    def append_wave(self, rec: dict) -> None:
        """Enqueue one committed wave record's logical entries (and the
        record itself when this log ships waves), then attempt the §4
        synchronous ship; failures leave entries for the sweeper.  The
        record carries the logical identities (resolved at commit time by
        ``writes.wave_record``), so this needs no ``db`` backref."""
        ts = int(rec["ts"])
        for tr in rec["txns"]:
            for _g, vt, key, f, i in tr["create_v"]:
                self.entries.append(LogEntry(
                    ts, "v_upsert", (int(vt), int(key)),
                    [list(f), list(i)]))
            for _g, vt, key, f, i in tr["update_v"]:
                self.entries.append(LogEntry(
                    ts, "v_upsert", (int(vt), int(key)),
                    [list(f), list(i)]))
            for _g, vt, key in tr["delete_v"]:
                self.entries.append(LogEntry(
                    ts, "v_delete", (int(vt), int(key))))
            for _s, _d, et, svt, sk, dvt, dk in tr["create_e"]:
                self.entries.append(LogEntry(
                    ts, "e_insert",
                    (int(svt), int(sk), int(et), int(dvt), int(dk))))
            for _s, _d, et, svt, sk, dvt, dk in tr["delete_e"]:
                self.entries.append(LogEntry(
                    ts, "e_delete",
                    (int(svt), int(sk), int(et), int(dvt), int(dk))))
        if self.ship_waves:
            self.entries.append(LogEntry(ts, "wave", (int(rec["seq"]),),
                                         rec))
            self._max_seq = max(self._max_seq, int(rec["seq"]))
        self._max_ts = max(self._max_ts, ts)
        try:
            self.sweep()
        except IOError:
            pass

    def append(self, ts: int, winners) -> None:
        """Txn-list entry point (callers from before wave records)."""
        assert self.db is not None, "attach with log.db = db"
        from repro_torch.core import writes as writes_mod
        self.append_wave(writes_mod.wave_record(self.db, winners, ts, 0))

    # -- shipping --------------------------------------------------------------
    def _ship_one(self, e: LogEntry) -> None:
        g = self.graph
        if e.kind == "v_upsert":
            self.os.upsert(f"{g}.vertices", e.key, e.value, e.ts)
            self.os.upsert(f"{g}.vertices.versions", (*e.key, e.ts),
                           e.value, e.ts)
        elif e.kind == "v_delete":
            self.os.upsert(f"{g}.vertices", e.key, TOMBSTONE, e.ts)
            self.os.upsert(f"{g}.vertices.versions", (*e.key, e.ts),
                           TOMBSTONE, e.ts)
        elif e.kind == "e_insert":
            self.os.upsert(f"{g}.edges", e.key, True, e.ts)
            self.os.upsert(f"{g}.edges.versions", (*e.key, e.ts), True, e.ts)
        elif e.kind == "e_delete":
            self.os.upsert(f"{g}.edges", e.key, TOMBSTONE, e.ts)
            self.os.upsert(f"{g}.edges.versions", (*e.key, e.ts), TOMBSTONE,
                           e.ts)
        elif e.kind == "wave":
            self.os.upsert(f"{g}.waves", e.key, e.value, e.ts)

    def sweep(self, budget: Optional[int] = None) -> int:
        """Flush unshipped entries FIFO (the async sweeper).  Returns the
        number shipped.

        Watermark discipline: ``shipped_ts`` and the durable ``t_R`` /
        ``wave_frontier`` metas advance only to the frontier that is
        actually durable, computed from what remains unshipped after this
        batch inside a ``finally``, so a mid-batch failure (``fail_next``,
        an injected ``replication.ship.drop``) never leaves a watermark
        ahead of the rows the store holds.  Advancement is monotonic: a
        fresh log over a store with history never regresses it."""
        if self.epoch is not None:
            cur = self.os.get_meta(f"{self.graph}.epoch")
            if cur is not None and int(cur) > int(self.epoch):
                raise Fenced(
                    f"epoch {self.epoch} fenced by durable epoch {cur}")
        owner = self.db if self.db is not None else self
        shipped = 0
        try:
            if faults_mod.check(owner, "replication.ship.drop"):
                raise IOError("replication ship dropped (injected)")
            while self.entries and (budget is None or shipped < budget):
                e = self.entries[0]
                self._ship_one(e)      # raises on (injected) failure
                self.entries.pop(0)
                shipped += 1
        finally:
            self._advance_watermarks()
        return shipped

    def _advance_watermarks(self) -> None:
        # t_R: all writes <= t_R are durable.  Any unshipped entry at ts
        # caps it at ts-1 (FIFO: everything older already shipped whole)
        oldest = self.entries[0].ts if self.entries else None
        t_r = (oldest - 1) if oldest is not None else self._max_ts
        t_r = max(t_r, self.shipped_ts,
                  int(self.os.get_meta(f"{self.graph}.t_R", 0)))
        self.shipped_ts = t_r
        self.os.put_meta(f"{self.graph}.t_R", int(t_r))
        if self.ship_waves:
            pend = [e.key[0] for e in self.entries if e.kind == "wave"]
            frontier = (min(pend) - 1) if pend else self._max_seq
            frontier = max(frontier, int(self.os.get_meta(
                f"{self.graph}.wave_frontier", 0)))
            self.os.put_meta(f"{self.graph}.wave_frontier", int(frontier))

    def lag(self) -> int:
        return len(self.entries)


def sweeper_task(log: ReplicationLog, *, budget: int = 128):
    """Task-framework wrapper: reschedules itself while the log is not
    empty (the paper's low-priority background sweeper)."""
    from repro_torch.core.tasks import Task

    def run(db, task):
        try:
            log.sweep(budget)
        except IOError:
            pass
        return [task] if log.lag() else []

    return Task("replication-sweeper", run, priority=20)
