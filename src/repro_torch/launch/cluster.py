"""Cluster front: N coordinators over one shared store (Fig. 4).

Port of ``repro/launch/cluster.py``, laid out as it is.  This is the
paper's SLB -> coordinator-fleet shape on one host.  An
:class:`A1Frontend` owns the store seam and the routing table; N
:class:`Coordinator` workers each wrap the :class:`~repro_torch.launch.
serve.A1Server` admission machinery (read/write waves, SLO budgets,
breakers, continuations) and answer frame-encoded requests.

**The device comes from the frontend** (``device=``, ``cuda`` by default,
which raises without a GPU; nothing carries on on the CPU when the card
is missing).  Inproc fleets restart the held slot onto it; process fleets
hand its name to every spawned worker, which copies each field of the
shared segment onto it.  Workers are spawned, never forked (a CUDA
context does not survive a fork), so each has a CUDA context of its own
and counts its own kernel launches.  Every wait on a worker has a
deadline, and :meth:`A1Frontend.close` terminates and joins them all.

**The shared-store seam** (workers must not duplicate the CSR/index
arrays — the contract ``core/README.md`` documents):

  * ``mode="inproc"`` — the fleet shares ONE ``GraphDB`` object rehydrated
    via ``FastRestartCache.restart``: every coordinator literally maps the
    same host/device buffers, writes are fleet-visible immediately, and
    chaos schedules are deterministic.  This is the default and the mode
    the acceptance contract (mixed read/write/nearest traffic) runs in.
  * ``mode="process"`` — the frontend ``export_shared``-publishes the held
    slot as one POSIX shared-memory segment and spawns real worker
    processes that ``attach_shared`` the same pages (one host copy of the
    graph beside the held slot; each worker pays only its own §5.3 copy
    onto its device) and serve JSON frames over TCP.  Writes are
    **fleet-visible** here too: the elected primary commits mutation waves
    against its own device arrays and the frontend ships the committed
    wave records (§4) to every replica, which tail-replays them at the
    ORIGINAL commit timestamps — MVCC snapshots and physical gids agree
    fleet-wide, and a read routed to any alive coordinator sees an acked
    write within the advertised replication lag (``/stats``).

**Membership, epochs, failover** (:mod:`repro_torch.core.membership`).  The
frontend is the configuration manager: every worker holds a heartbeat
lease; a worker that misses renewals goes suspect, then evicted, and
every configuration change bumps a monotonic **epoch**.  All frames are
stamped with the sender's epoch — a coordinator that sees a stale epoch
bounces the frame (``STALE_EPOCH``, the fencing token), and a deposed
primary's wave close is refused by its ``write_fence`` before the store
is touched.  When the primary's lease expires (or its crash is detected)
the most caught-up replica is elected, promoted with the WAL tail it has
not yet applied, and write waves resume; an acked commit is never lost,
and an unacked in-flight write either resolves to its ORIGINAL result
via rid-idempotent replay (exactly once) or answers
``ABORTED_FAILOVER`` with a retry hint — never a silent drop.

**SLB routing.**  Fresh queries go to the least-loaded coordinator — the
load signal is each worker's wave-wall EWMA (``_wave_ms``) times its
queue depth, piggybacked on every response (``_load``).  Continuation and
gid-cursor state is *owned*: public tokens/ids are stamped
``"<cid>:<id>"`` and routed back to the stamped coordinator.  Ownership is
verified at the receiver (a stale SLB view — the ``cluster.route.stale``
site — bounces with ``WRONG_OWNER`` and the frontend re-routes; the wrong
worker never answers from the wrong state).

**Takeover.**  When a token's owner is gone, the frontend — which is
pin-of-record for every routed token's snapshot timestamp — picks a new
coordinator and sends ``adopt``: re-plan the select at the token's pinned
``read_ts``, fast-forward past the rows the client already consumed, and
assert the replayed prefix is bit-identical (MVCC at a pinned snapshot
makes the replay deterministic; divergence is a bug, not a condition to
handle).  The client's token keeps working across the crash.

**SLO budgets.**  Each request carries a budget (default 100 ms).  The
frontend spends from it at the route stage (an already-exhausted budget
answers sub-millisecond at the front door, never touching a worker), the
coordinator's admission spends it through queueing/wave/hedge
(:mod:`repro_torch.launch.serve`), and ``/stats`` aggregates the per-stage
spend histograms fleet-wide.
"""
from __future__ import annotations

import collections
import time
import uuid
from typing import Optional

import numpy as np

from repro_torch.core import faults as faults_mod
from repro_torch.core import tasks as tasks_mod
from repro_torch.core import writes as writes_mod
from repro_torch.core.backend import resolve_device
from repro_torch.core.membership import Membership
from repro_torch.core.recovery import FastRestartCache
from repro_torch.core.replication import ObjectStore, ReplicationLog
from repro_torch.launch.serve import A1Server
from repro_torch.launch.transport import (MemoryChannel, WorkerClient,
                                          decode_write_op, encode_write_op,
                                          serve_worker)

_RID_CACHE = 4096
_START_S = 600.0        # deadline for a spawned worker to announce its port


class _PinBoard:
    """Process-mode frontend store handle: the pin-of-record list and the
    fault-injector mount, without duplicating any store arrays (the
    workers map the shared segment; the frontend keeps only metadata)."""

    def __init__(self):
        self.active_query_ts: list[int] = []
        self.faults = None


class Coordinator:
    """One serving worker: an :class:`A1Server` behind a frame handler.

    Every mutating request carries a client-chosen ``rid``; responses are
    cached so a retransmit (duplicate frame after a lost response) returns
    the *original* answer instead of re-executing — at-least-once delivery
    with exactly-once effects, which is what makes result polling
    idempotent under ``transport.drop`` chaos.

    Each coordinator also tracks the configuration ``epoch`` and its
    ``role`` ("primary" commits write waves; "replica" refuses them).  A
    frame stamped with an older epoch bounces ``STALE_EPOCH`` — the
    fencing token of §2/FaRM — and a frame that proves a NEWER config in
    which someone else is primary demotes this coordinator on the spot
    (staged writes answer ``ABORTED_FAILOVER``; the store is untouched).
    Promotion is only ever explicit (the ``promote`` op, which carries
    the WAL tail this replica has not yet applied)."""

    def __init__(self, cid: int, db, *, role: str = "primary",
                 fence=None, **server_kw):
        self.cid = int(cid)
        self.role = role
        self.epoch = 1
        self.fence = fence            # extra membership fence (inproc CM)
        self.server = A1Server(db, write_fence=self._write_fence,
                               **server_kw)
        self._rids: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        import threading
        self._lock = threading.Lock()

    def _write_fence(self) -> bool:
        """Commit-time check: may this coordinator close a write wave?"""
        if self.role != "primary":
            return False
        if self.fence is not None and not self.fence():
            return False              # the CM's view says we were deposed
        return True

    def _demote(self) -> None:
        self.role = "replica"
        self.server.abort_staged_writes("primary deposed")

    # -- dispatch -------------------------------------------------------
    def handle(self, msg: dict) -> dict:
        with self._lock:
            e = msg.get("epoch")
            if e is not None:
                e = int(e)
                if e < self.epoch:
                    # fencing: a frame from a configuration the fleet has
                    # left.  Bounced, NOT rid-cached — the sender restamps
                    # at the current epoch and retries under a fresh rid.
                    s = self.server
                    return {"status": "STALE_EPOCH", "epoch": self.epoch,
                            "_load": {"wave_ms": s._wave_ms,
                                      "inflight": (len(s._read_q)
                                                   + len(s._write_q))}}
                if e > self.epoch:
                    self.epoch = e
                    db = self.server.db
                    db.config_epoch = max(
                        getattr(db, "config_epoch", 0), e)
                p = msg.get("primary")
                if (p is not None and int(p) != self.cid
                        and self.role == "primary"):
                    self._demote()    # the new config elected someone else
            rid = msg.get("rid")
            if rid is not None and rid in self._rids:
                return self._rids[rid]
            try:
                resp = self._dispatch(msg)
            except faults_mod.InjectedFault:
                raise                          # chaos wants these visible
            except (KeyError, ValueError, TypeError) as e:
                resp = {"status": "ERROR", "reason": str(e)}
            s = self.server
            resp["_load"] = {
                "wave_ms": s._wave_ms,
                "inflight": len(s._read_q) + len(s._write_q)}
            if rid is not None:
                self._rids[rid] = resp
                while len(self._rids) > _RID_CACHE:
                    self._rids.popitem(last=False)
            return resp

    def _dispatch(self, msg: dict) -> dict:
        op = msg["op"]
        s = self.server
        if op == "query":
            qid = s.submit_query(msg["doc"],
                                 tenant=msg.get("tenant", "default"),
                                 qclass=msg.get("qclass", "q"),
                                 budget_ms=msg.get("budget_ms"))
            return {"status": "OK", "qid": qid}
        if op == "result":
            return {"status": "OK", "result": s.query_result(msg["qid"])}
        if op == "select_paged":
            rows, token = s.select_paged(msg["doc"],
                                         read_ts=msg.get("read_ts"))
            read_ts = (s._continuations[token].read_ts
                       if token is not None else None)
            return {"status": "OK", "rows": rows.tolist(), "token": token,
                    "read_ts": read_ts}
        if op == "next_page":
            owner = msg.get("owner", self.cid)
            if int(owner) != self.cid:
                # stale SLB view: never answer for state we don't own
                return {"status": "WRONG_OWNER", "owner": owner}
            try:
                rows, token = s.next_page(msg["token"])
            except KeyError:
                return {"status": "EXPIRED"}
            return {"status": "OK", "rows": rows.tolist(), "token": token}
        if op == "adopt":
            return self._adopt(msg)
        if op == "write":
            if self.role != "primary":
                # stale SLB view of the primaryship: bounce, never stage a
                # write on a replica (it could only ever abort or fork)
                return {"status": "NOT_PRIMARY", "epoch": self.epoch}
            wid = s.submit_write([decode_write_op(d) for d in msg["ops"]],
                                 budget_ms=msg.get("budget_ms"),
                                 wid=msg.get("wid"))
            return {"status": "OK", "wid": wid}
        if op == "write_result":
            return {"status": "OK", "result": s.write_result(msg["wid"])}
        if op == "write_by_rid":
            # failover resolution: did a wave with this rid ever commit
            # here (directly or via replay)?  Exactly-once by construction.
            hit = getattr(s.db, "applied_rids", {}).get(msg["wid"])
            if hit is None:
                return {"status": "OK", "result": None}
            return {"status": "OK",
                    "result": {"status": "COMMITTED", "reason": None,
                               "gids": list(hit["gids"]),
                               "ts": int(hit["ts"])}}
        if op == "heartbeat":
            # lease renewal carrying the CM's pin-of-record (fleet pins
            # hold MVCC GC on every replica) and returning how far this
            # worker's replication frontier has advanced
            if "pins" in msg:
                s.db.fleet_pins = [int(t) for t in msg["pins"]]
            return {"status": "OK", "role": self.role, "epoch": self.epoch,
                    "applied_seq": int(getattr(s.db, "wave_seq", 0)),
                    "gc_ts": int(s.db.gc_ts())}
        if op == "ship":
            # primary-side: hand the CM every committed wave record past
            # the durable/replicated frontier (§4 replication log pull)
            after = int(msg.get("after", 0))
            return {"status": "OK",
                    "waves": [r for r in getattr(s.db, "wave_log", ())
                              if r["seq"] > after],
                    "seq": int(getattr(s.db, "wave_seq", 0))}
        if op == "replicate":
            # replica-side: queue the shipped records on the wave inbox
            # and drain them through the tail-replay task (idempotent by
            # seq, applied at the ORIGINAL commit timestamps)
            fresh = [r for r in msg.get("waves", ())
                     if int(r["seq"]) > s.db.wave_seq]
            if fresh:
                s.db.wave_inbox.extend(fresh)
                s.tasks.enqueue(tasks_mod.wave_replay_task())
                guard = 0
                while s.db.wave_inbox and guard < 10_000:
                    s.tasks.pump()
                    guard += 1
            if "pins" in msg:
                s.db.fleet_pins = [int(t) for t in msg["pins"]]
            return {"status": "OK", "applied_seq": int(s.db.wave_seq)}
        if op == "promote":
            # failover: replay the WAL tail to the commit frontier, then
            # take the primaryship at the new epoch
            for rec in msg.get("waves", ()):
                writes_mod.replay_wave(s.db, rec)
            self.role = "primary"
            self.epoch = max(self.epoch, int(msg["epoch"]))
            s.db.config_epoch = max(
                getattr(s.db, "config_epoch", 0), self.epoch)
            return {"status": "OK", "applied_seq": int(s.db.wave_seq)}
        if op == "pump":
            return {"status": "OK", "n": s.pump()}
        if op == "flush":
            return {"status": "OK",
                    "n": s.flush_queries() + s.flush_writes()}
        if op == "stats":
            st = dict(s.stats)
            st["role"] = self.role
            st["epoch"] = self.epoch
            st["wave_seq"] = int(getattr(s.db, "wave_seq", 0))
            return {"status": "OK", "stats": st,
                    "latency": s.latency_report(),
                    "breakers": s.breaker_state()}
        return {"status": "ERROR", "reason": f"unknown op {op!r}"}

    def _adopt(self, msg: dict) -> dict:
        """Takeover: replay a lost coordinator's paged select here.

        Re-plans at the token's pinned ``read_ts`` (the frontend holds
        that pin, so the snapshot is guaranteed live), fast-forwards whole
        pages past the rows the client already consumed, and proves the
        replayed prefix bit-identical — the MVCC contract that makes
        coordinator crashes invisible to paging clients."""
        served = [int(x) for x in msg["served"]]
        rows, token = self.server.select_paged(
            msg["doc"], read_ts=int(msg["read_ts"]))
        consumed = rows.tolist()
        while len(consumed) < len(served) and token is not None:
            page, token = self.server.next_page(token)
            consumed += page.tolist()
        if consumed[:len(served)] != served:
            return {"status": "DIVERGED",
                    "reason": "replayed prefix differs from served rows"}
        return {"status": "OK", "token": token,
                "read_ts": (self.server._continuations[token].read_ts
                            if token is not None else None),
                "leftover": consumed[len(served):]}


# ---------------------------------------------------------------------------
# worker handles
# ---------------------------------------------------------------------------

class _InprocWorker:
    """A coordinator in this process behind a frame-faithful channel."""

    def __init__(self, cid: int, coord: Coordinator, owner):
        self.cid = cid
        self.coord = coord
        self.chan = MemoryChannel(coord.handle, owner)
        self.alive = True

    def request(self, msg: dict) -> Optional[dict]:
        if not self.alive:
            return None
        return self.chan.request(msg)

    def kill(self) -> None:
        self.alive = False
        # a dead coordinator's own continuation pins must not block MVCC
        # GC on the SHARED store (a process-mode worker's pins die with
        # its process; the inproc analogue is explicit).  The frontend's
        # pin-of-record keeps takeover-able snapshots alive regardless.
        srv = self.coord.server
        for c in srv._continuations.values():
            try:
                srv.db.active_query_ts.remove(c.read_ts)
            except ValueError:
                pass
        srv._continuations.clear()


class _ProcWorker:
    """A spawned coordinator process behind a TCP frame client."""

    def __init__(self, cid: int, proc, client: WorkerClient):
        self.cid = cid
        self.proc = proc
        self.client = client
        self.alive = True

    @property
    def suspect(self) -> bool:
        """Hung (recv timeout), as opposed to dead: the membership layer
        stops renewing its lease instead of evicting on the spot."""
        return self.client.suspect

    def request(self, msg: dict) -> Optional[dict]:
        if not self.alive:
            return None
        resp = self.client.request(msg)
        if resp is None and not self.client.suspect:
            self.alive = False        # refused/reset: the process is gone
        return resp

    def kill(self) -> None:
        self.alive = False
        _stop(self.proc)
        self.client.close()


def _stop(proc) -> None:
    """Terminate a worker process and join it, killing it if SIGTERM does
    not end it within the deadline."""
    if proc.is_alive():
        proc.terminate()
    proc.join(timeout=10)
    if proc.is_alive():
        proc.kill()
        proc.join(timeout=10)


def _worker_main(cid: int, manifest: dict, conn, server_kw: dict,
                 role: str = "replica", device: str = "cuda") -> None:
    """Entry point of a spawned coordinator worker (process mode): copy the
    shared segment onto ``device``, then serve.  It announces its port and
    the seconds the attach took."""
    import torch

    from repro_torch.core.query import planner
    from repro_torch.core.recovery import attach_shared
    t0 = time.perf_counter()
    db = attach_shared(manifest, device=device)
    if db.device.type == "cuda":
        torch.cuda.synchronize(db.device)
    attach_s = time.perf_counter() - t0
    # warm the first-dispatch path (window scans) BEFORE announcing the
    # port: restart time is §5.3's problem, not the client's
    planner.delta_window(db)
    planner.index_window(db)
    coord = Coordinator(cid, db, role=role, **server_kw)
    handle = coord.handle
    if db.device.type == "cuda":
        # the connection threads launch on the store's card, whatever
        # device a new thread starts on
        def handle(msg, _h=coord.handle, _d=db.device):
            with torch.cuda.device(_d):
                return _h(msg)
    port, _shutdown = serve_worker(handle)
    conn.send({"port": port, "attach_s": attach_s})
    conn.close()
    while True:                                   # serve until terminated
        handle({"op": "pump"})
        time.sleep(0.005)


def _await_port(proc, conn, deadline: float) -> dict:
    """A spawned worker's hello (``{"port", "attach_s"}``), waited for
    until ``deadline``; raises if the worker died or never answered."""
    try:
        while not conn.poll(0.1):
            if not proc.is_alive():
                raise RuntimeError(
                    f"coordinator worker exited with code {proc.exitcode} "
                    "before announcing its port")
            if time.monotonic() > deadline:
                raise TimeoutError("coordinator worker never announced its "
                                   "port")
        return conn.recv()
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# the frontend (SLB + routing table + pin-of-record)
# ---------------------------------------------------------------------------

class A1Frontend:
    """SLB-style front over N coordinators sharing one store.

    See the module docstring for the routing/ownership/takeover and
    budget contracts.  ``close()`` tears the fleet down (and unlinks the
    shared segment in process mode); the frontend is also a context
    manager.  ``device`` is where the fleet's stores live (``cuda`` by
    default; raises without a GPU); ``attach_s`` holds each process-mode
    worker's seconds to copy the segment onto it."""

    def __init__(self, db, n_workers: int = 4, *, mode: str = "inproc",
                 name: str = "cluster", cache: Optional[FastRestartCache]
                 = None, budget_ms: float = 100.0, lease_s: float = 2.0,
                 membership_clock=None, recv_timeout_s: Optional[float]
                 = None, objectstore: Optional[ObjectStore] = None,
                 device="cuda", **server_kw):
        if mode not in ("inproc", "process"):
            raise ValueError(f"unknown mode {mode!r}")
        self.device = resolve_device(device)
        self.mode = mode
        self.name = name
        self.budget_ms = budget_ms
        self.cache = cache or FastRestartCache()
        self.cache.hold(name, db)
        self.workers: dict[int, object] = {}
        self.stats = {"routed_queries": 0, "routed_writes": 0,
                      "continuation_routes": 0, "stale_routes": 0,
                      "takeovers": 0, "rescued_queries": 0,
                      "retransmits": 0, "worker_kills": 0,
                      "budget_exhausted_frontend": 0,
                      "frames_sent": 0, "frames_dropped": 0,
                      "failovers": 0, "replicated_waves": 0,
                      "ship_drops": 0}
        self._load: dict[int, float] = {}
        self._rr = 0
        self._qidmeta: dict[str, dict] = {}     # pub qid -> routing meta
        self._tokmeta: dict[str, dict] = {}     # pub token -> routing meta
        self._local: dict[str, dict] = {}       # frontend-answered results
        self._widmeta: dict[str, dict] = {}     # pub write id -> {cid, wid}
        self._applied: dict[int, int] = {}      # cid -> replicated wave seq
        self._shipped_seq = 0                   # durable/replicated frontier
        self._waves: dict[int, dict] = {}       # CM-held WAL tail (process)
        self.attach_s: dict[int, float] = {}
        if mode == "inproc":
            # ONE rehydrated GraphDB: every coordinator wraps the same
            # store object — zero array duplication, writes fleet-visible
            self.db = self.cache.restart(name, device=self.device)
            self.rlog: Optional[ReplicationLog] = None
            self.membership = Membership(
                range(n_workers), lease_s=lease_s,
                clock=membership_clock or time.monotonic, owner=self.db)
            for cid in range(n_workers):
                # cid 0 starts as write-primary; the commit-time fence is
                # the CM's membership view — a deposed primary's wave
                # close is refused even if it missed its demote frame
                coord = Coordinator(
                    cid, self.db,
                    role="primary" if cid == 0 else "replica",
                    fence=(lambda c=cid: self.membership.is_primary(c)),
                    **server_kw)
                self.workers[cid] = _InprocWorker(cid, coord, self.db)
        else:
            import multiprocessing as mp
            # one host copy in shared memory; workers map the same pages.
            # spawn, not fork: a CUDA context does not survive a fork
            self._manifest = self.cache.export_shared(name)
            self.db = _PinBoard()               # pins + faults, no arrays
            self.membership = Membership(
                range(n_workers), lease_s=lease_s,
                clock=membership_clock or time.monotonic, owner=self.db)
            # the CM's durable replication log: committed wave records are
            # pulled from the primary and shipped to the ObjectStore
            # before a commit is acked (§4); the `{graph}.epoch` meta is
            # the durable fence a deposed primary cannot get past
            self.rlog = ReplicationLog(objectstore or ObjectStore(),
                                       ship_waves=True)
            self.rlog.epoch = self.membership.epoch
            ctx = mp.get_context("spawn")
            started = []
            try:
                # start every worker, then wait for each port: the workers
                # attach side by side
                for cid in range(n_workers):
                    parent, child = ctx.Pipe()
                    proc = ctx.Process(
                        target=_worker_main,
                        args=(cid, self._manifest, child, dict(server_kw),
                              "primary" if cid == 0 else "replica",
                              str(self.device)),
                        daemon=True)
                    proc.start()
                    child.close()
                    started.append((cid, proc, parent))
                deadline = time.monotonic() + _START_S
                for cid, proc, parent in started:
                    hello = _await_port(proc, parent, deadline)
                    self.attach_s[cid] = float(hello["attach_s"])
                    self.workers[cid] = _ProcWorker(
                        cid, proc, WorkerClient(
                            "127.0.0.1", hello["port"],
                            recv_timeout=recv_timeout_s, seed=cid))
            except BaseException:
                for w in self.workers.values():
                    w.client.close()
                for _, proc, _ in started:
                    _stop(proc)
                self.cache.drop(name)
                raise
        for cid in self.workers:
            self._load[cid] = 0.0
            self._applied[cid] = 0

    # -- routing --------------------------------------------------------
    def _alive(self) -> list[int]:
        """Route-able workers: process up AND lease current (a suspect or
        evicted member stops taking fresh traffic before it is dead)."""
        routable = set(self.membership.routable())
        return [cid for cid, w in self.workers.items()
                if w.alive and cid in routable]

    def _least_loaded(self) -> int:
        """Least-loaded alive coordinator: wave-wall EWMA x queue depth,
        round-robin among ties (fresh fleets are all-zero)."""
        alive = self._alive()
        if not alive:
            raise RuntimeError("no alive coordinators")
        self._rr += 1
        return min(alive, key=lambda c: (self._load[c],
                                         (c + self._rr) % len(self.workers)))

    def _raw_request(self, w, cid: int, msg: dict) -> Optional[dict]:
        try:
            return w.request(msg)
        except faults_mod.InjectedFault:
            # the worker "crashed" executing the frame (e.g. the
            # primary.crash.midwave schedule): same outcome as a dead
            # process — evict, fail over, let the caller re-route
            self.kill_worker(cid)
            return None

    def _rpc(self, cid: int, msg: dict, retries: int = 4) -> Optional[dict]:
        """One logical request: a fixed ``rid`` across retransmits, so a
        dropped frame is retried and a duplicate delivery is absorbed by
        the coordinator's rid cache.  Every frame is stamped with the
        CM's configuration epoch and primary — the receiver adopts newer
        configs, bounces stale senders, and demotes itself when the stamp
        proves it lost the primaryship."""
        w = self.workers.get(cid)
        if w is None or not w.alive:
            return None
        msg.setdefault("rid", uuid.uuid4().hex)
        msg["epoch"] = self.membership.epoch
        msg.setdefault("primary", self.membership.primary)
        resp = self._raw_request(w, cid, msg)
        while resp is None and retries > 0 and w.alive:
            if getattr(w, "suspect", False):
                break                 # hung, not dead: don't hammer it
            self.stats["retransmits"] += 1
            retries -= 1
            resp = self._raw_request(w, cid, msg)
        if resp is not None and resp.get("status") == "STALE_EPOCH":
            # the config moved while this frame was in flight: restamp at
            # the current epoch under a FRESH rid and retry once (the old
            # rid's cached answer, if any, belongs to the old config)
            msg = dict(msg)
            msg["rid"] = uuid.uuid4().hex
            msg["epoch"] = self.membership.epoch
            msg["primary"] = self.membership.primary
            resp = self._raw_request(w, cid, msg)
        if resp is not None:
            load = resp.pop("_load", None)
            if load is not None:
                self._load[cid] = (max(load["wave_ms"], 0.01)
                                   * (1 + load["inflight"]))
            return resp
        if not w.alive:
            self._on_worker_down(cid)     # idempotent (kill may have run)
        elif getattr(w, "suspect", False):
            self.membership.suspect(cid)  # lease stops renewing
        return None

    def _maybe_crash_route_target(self, cid: int) -> bool:
        """``cluster.worker.crash``: the chaos site that kills the routing
        target just before the frame leaves — the crash-at-worst-moment
        schedule.  Returns True when the target died."""
        if faults_mod.check(self.db, "cluster.worker.crash"):
            self.kill_worker(cid)
            return True
        return False

    # -- reads ----------------------------------------------------------
    def submit_query(self, doc: dict, *, tenant: str = "default",
                     qclass: str = "q",
                     budget_ms: Optional[float] = None) -> str:
        """Admit one read through the SLB; returns a stamped query id.

        The route stage spends from the request's SLO budget: routing time
        is decremented before admission, and an already-exhausted budget
        is answered *here* — a sub-millisecond truncated-with-flag
        response that never costs a worker frame."""
        t0 = time.monotonic()
        budget = self.budget_ms if budget_ms is None else budget_ms
        if budget is not None and budget <= 0:
            pub = f"fe:{uuid.uuid4().hex}"
            self.stats["budget_exhausted_frontend"] += 1
            self._local[pub] = {"status": "OK", "failed": False,
                                "rows": [], "truncated": True,
                                "budget_exhausted": True}
            return pub
        self.stats["routed_queries"] += 1
        deadline = None if budget is None else t0 + budget * 1e-3
        for _ in range(len(self.workers) + 1):
            cid = self._least_loaded()
            self._maybe_crash_route_target(cid)
            remaining = (None if budget is None
                         else (deadline - time.monotonic()) * 1e3)
            resp = self._rpc(cid, {"op": "query", "doc": doc,
                                   "tenant": tenant, "qclass": qclass,
                                   "budget_ms": remaining})
            if resp is not None and resp["status"] == "OK":
                pub = f"{cid}:{resp['qid']}"
                self._qidmeta[pub] = {
                    "cid": cid, "qid": resp["qid"], "doc": doc,
                    "tenant": tenant, "qclass": qclass,
                    "deadline": deadline}
                return pub
            if resp is not None:                    # admission error row
                pub = f"{cid}:{uuid.uuid4().hex}"
                self._local[pub] = {"status": "REJECTED",
                                    "reason": resp.get("reason", "")}
                return pub
            # target died mid-route: fail over to another coordinator
        raise RuntimeError("no alive coordinators")

    def query_result(self, pub: str) -> Optional[dict]:
        """Poll a stamped id; drives worker wave clocks on the way."""
        local = self._local.pop(pub, None)
        if local is not None:
            return local
        meta = self._qidmeta.get(pub)
        if meta is None:
            return {"status": "UNKNOWN", "reason": "no such query id"}
        w = self.workers.get(meta["cid"])
        if w is None or not w.alive:
            self._rescue(meta["cid"])
            meta = self._qidmeta.get(pub)
            if meta is None:                       # rescue answered it
                return self._local.pop(pub, None)
        resp = self._rpc(meta["cid"], {"op": "result", "qid": meta["qid"]})
        if resp is None:
            self._rescue(meta["cid"])
            return None                            # client polls again
        r = resp.get("result")
        if r is not None:
            del self._qidmeta[pub]
        return r

    def _rescue(self, dead_cid: int) -> None:
        """Re-route every in-flight query owned by a dead coordinator.

        Queries whose results are stranded on the lost worker re-submit
        (same doc, remaining budget) to an alive one; exhausted budgets
        answer truncated-with-flag locally.  Continuations are *not*
        rescued here — their takeover is lazy, at the next ``next_page``."""
        for pub, meta in list(self._qidmeta.items()):
            if meta["cid"] != dead_cid:
                continue
            remaining = None
            if meta["deadline"] is not None:
                remaining = (meta["deadline"] - time.monotonic()) * 1e3
                if remaining <= 0:
                    self._local[pub] = {
                        "status": "OK", "failed": False, "rows": [],
                        "truncated": True, "budget_exhausted": True}
                    del self._qidmeta[pub]
                    continue
            alive = self._alive()
            if not alive:
                self._local[pub] = {"status": "ABORTED",
                                    "reason": "worker-lost"}
                del self._qidmeta[pub]
                continue
            cid = self._least_loaded()
            resp = self._rpc(cid, {"op": "query", "doc": meta["doc"],
                                   "tenant": meta["tenant"],
                                   "qclass": meta["qclass"],
                                   "budget_ms": remaining})
            if resp is None or resp["status"] != "OK":
                self._local[pub] = {"status": "ABORTED",
                                    "reason": "worker-lost"}
                del self._qidmeta[pub]
                continue
            self.stats["rescued_queries"] += 1
            meta["cid"], meta["qid"] = cid, resp["qid"]

    # -- paged selects / continuations ----------------------------------
    def select_paged(self, doc: dict) -> tuple[np.ndarray, Optional[str]]:
        """First page + a coordinator-stamped public token.

        The frontend records the token's snapshot timestamp and pins it on
        its own store handle — the pin-of-record that keeps the snapshot
        alive even if the owning coordinator dies (its takeover replay
        needs the pinned versions to still exist)."""
        for _ in range(len(self.workers) + 1):
            cid = self._least_loaded()
            self._maybe_crash_route_target(cid)
            resp = self._rpc(cid, {"op": "select_paged", "doc": doc})
            if resp is None:
                continue                            # died mid-route
            if resp["status"] != "OK":
                raise ValueError(resp.get("reason", "select_paged failed"))
            rows = np.asarray(resp["rows"], np.int64)
            if resp["token"] is None:
                return rows, None
            pub = f"{cid}:{resp['token']}"
            self._tokmeta[pub] = {
                "cid": cid, "token": resp["token"], "doc": doc,
                "read_ts": int(resp["read_ts"]),
                "served": rows.tolist()}
            self.db.active_query_ts.append(int(resp["read_ts"]))
            return rows, pub
        raise RuntimeError("no alive coordinators")

    def next_page(self, pub: str) -> tuple[np.ndarray, Optional[str]]:
        """Route a continuation to its owner; take over if the owner died.

        The happy path is one owner-routed frame.  Under
        ``cluster.route.stale`` the frame goes to the wrong coordinator
        first and bounces (``WRONG_OWNER``); under ``cluster.worker.crash``
        the owner dies as the frame leaves, and the takeover path re-plans
        on a new coordinator at the token's pinned snapshot — asserting
        the replayed pages bit-identical before the client sees a row."""
        meta = self._tokmeta.get(pub)
        if meta is None:
            raise KeyError("continuation expired; restart the query")
        self.stats["continuation_routes"] += 1
        self._maybe_crash_route_target(meta["cid"])
        target = meta["cid"]
        alive = self._alive()
        if faults_mod.check(self.db, "cluster.route.stale") and alive:
            wrong = [c for c in alive if c != meta["cid"]]
            if wrong:
                target = wrong[self._rr % len(wrong)]
        resp = None
        if self.workers[meta["cid"]].alive:
            resp = self._rpc(target, {"op": "next_page",
                                      "token": meta["token"],
                                      "owner": meta["cid"]})
            if resp is not None and resp["status"] == "WRONG_OWNER":
                # stale SLB view detected at the receiver: re-route to the
                # true owner (the stamp, not the view, is authoritative)
                self.stats["stale_routes"] += 1
                resp = self._rpc(meta["cid"], {"op": "next_page",
                                               "token": meta["token"],
                                               "owner": meta["cid"]})
        if resp is None:                            # owner is gone
            resp = self._takeover(pub, meta)
        if resp["status"] == "EXPIRED":
            self._release_token(pub)
            raise KeyError("continuation expired; restart the query")
        if resp["status"] != "OK":
            self._release_token(pub)
            raise RuntimeError(resp.get("reason", resp["status"]))
        rows = np.asarray(resp["rows"], np.int64)
        meta["served"] += rows.tolist()
        if resp["token"] is None:
            self._release_token(pub)
            return rows, None
        meta["token"] = resp["token"]
        return rows, pub

    def _takeover(self, pub: str, meta: dict) -> dict:
        """Adopt a lost coordinator's token on a new one, then page."""
        self.stats["takeovers"] += 1
        cid = self._least_loaded()
        resp = self._rpc(cid, {"op": "adopt", "doc": meta["doc"],
                               "read_ts": meta["read_ts"],
                               "served": meta["served"]})
        if resp is None or resp["status"] != "OK":
            return resp or {"status": "ERROR", "reason": "takeover failed"}
        if resp["token"] is None:
            # the replay completed the select: whatever rows remain past
            # the served prefix are the final page
            return {"status": "OK", "rows": resp["leftover"],
                    "token": None}
        meta["cid"], meta["token"] = cid, resp["token"]
        return self._rpc(cid, {"op": "next_page", "token": meta["token"],
                               "owner": cid})

    def _release_token(self, pub: str) -> None:
        meta = self._tokmeta.pop(pub, None)
        if meta is not None:
            try:
                self.db.active_query_ts.remove(meta["read_ts"])
            except ValueError:
                pass

    # -- writes ---------------------------------------------------------
    def submit_write(self, ops, *, budget_ms: Optional[float] = None) -> str:
        """Admit one write through the SLB: routed to the elected
        write-primary (both modes).

        The frontend chooses the wid up front — it doubles as the
        transaction's rid, so a retransmit to a freshly promoted primary
        that already replayed the original wave resolves to the ORIGINAL
        result instead of committing twice (exactly once, §4).  In
        process mode the commit is not acked until the wave record is
        durable in the ObjectStore and replayed on every alive replica —
        read-your-write holds on any coordinator."""
        self.stats["routed_writes"] += 1
        encoded = [encode_write_op(o) for o in ops]
        wid = uuid.uuid4().hex
        pub = f"w:{wid}"
        for _ in range(len(self.workers) + 2):
            p = self.membership.primary
            if p is None:
                raise RuntimeError("no alive coordinators")
            self._maybe_crash_route_target(p)
            p = self.membership.primary   # the crash may have failed over
            if p is None:
                raise RuntimeError("no alive coordinators")
            resp = self._rpc(p, {"op": "write", "ops": encoded,
                                 "budget_ms": budget_ms, "wid": wid})
            if resp is None:
                continue       # primary died mid-route; failover ran
            if resp["status"] == "NOT_PRIMARY":
                continue       # stale role view; re-read the membership
            if resp["status"] == "OK":
                self._widmeta[pub] = {"cid": p, "wid": wid}
                return pub
            self._local[pub] = {"status": "ABORTED",
                                "reason": resp.get("reason", "")}
            return pub
        raise RuntimeError("no alive coordinators")

    def write_result(self, pub: str) -> Optional[dict]:
        """Outcome of a routed write; ``None`` while its wave is open.

        The ack barrier: a COMMITTED result is only returned after
        :meth:`_replicate` made the wave durable and fleet-visible
        (process mode; inproc shares one store, so it is a no-op).  If
        the owning primary died, the write resolves through the rid-
        idempotent failover path — the original result when the commit
        survived, ``ABORTED_FAILOVER`` with a retry hint otherwise."""
        local = self._local.pop(pub, None)
        if local is not None:
            return local
        meta = self._widmeta.get(pub)
        if meta is None:
            if ":" in pub:                  # legacy "<cid>:<wid>" stamp
                cid, wid = pub.split(":", 1)
                resp = self._rpc(int(cid), {"op": "write_result",
                                            "wid": wid})
                if resp is None:
                    return {"status": "ABORTED", "reason": "worker-lost"}
                return resp.get("result")
            return {"status": "UNKNOWN", "reason": "no such write id"}
        w = self.workers.get(meta["cid"])
        owner_lost = (w is None or not w.alive
                      or meta["cid"] not in self.membership.admitted())
        resp = None
        if not owner_lost:
            resp = self._rpc(meta["cid"], {"op": "write_result",
                                           "wid": meta["wid"]})
            owner_lost = resp is None and not self.workers[meta["cid"]].alive
        if owner_lost:
            self._on_worker_down(meta["cid"])   # idempotent
            r = self._local.pop(pub, None)      # failover may have resolved
            if r is None:
                r = self._resolve_by_rid(meta)
            self._widmeta.pop(pub, None)
            if r.get("status") == "COMMITTED":
                self._replicate()               # ack barrier still holds
            return r
        if resp is None:
            return None                         # hung owner: poll again
        r = resp.get("result")
        if r is None:
            return None                         # wave still open
        self._widmeta.pop(pub, None)
        if r.get("status") == "COMMITTED":
            self._replicate()                   # ack barrier
        return r

    def _resolve_by_rid(self, meta: dict) -> dict:
        """Failover resolution for a write stranded on a dead primary:
        ask the CURRENT primary whether that rid ever committed (directly
        or via wave replay).  Found -> the original result, exactly once;
        not found -> the txn died unacked and the client retries."""
        p = self.membership.primary
        if p is not None:
            resp = self._rpc(p, {"op": "write_by_rid", "wid": meta["wid"]})
            r = resp.get("result") if resp is not None else None
            if r is not None:
                return r
        return {"status": "ABORTED_FAILOVER",
                "reason": "primary failed before the commit replicated; "
                          "safe to retry",
                "retry_after_ms": 5.0}

    # -- replication (process mode: §4 wave shipping) --------------------
    def _pins(self) -> list[int]:
        return [int(t) for t in self.db.active_query_ts]

    def _replicate(self) -> None:
        """Pull committed waves from the primary, make them durable, fan
        them out to every alive replica.  Inproc fleets share one store
        (replication is the identity); in process mode this is the ack
        barrier and the replication-lag pump.  ``replication.ship.drop``
        loses a whole round — lag grows, nothing is acked on top of it."""
        if self.rlog is None:
            return
        p = self.membership.primary
        if p is None:
            return
        if faults_mod.check(self.db, "replication.ship.drop"):
            self.stats["ship_drops"] += 1
            return
        resp = self._rpc(p, {"op": "ship", "after": self._shipped_seq})
        if resp is None or resp.get("status") != "OK":
            return
        waves = resp.get("waves", [])
        if not waves:
            return
        for rec in waves:
            self._waves[int(rec["seq"])] = rec
            try:
                self.rlog.append_wave(rec)      # durable point
            except IOError:
                pass                            # sweeper retries the ship
        while len(self._waves) > 2048:          # ObjectStore holds the WAL
            del self._waves[min(self._waves)]
        self._shipped_seq = max(self._shipped_seq, int(waves[-1]["seq"]))
        self._applied[p] = max(self._applied.get(p, 0), self._shipped_seq)
        self.membership.heartbeat(p, applied_seq=self._shipped_seq)
        self.stats["replicated_waves"] += len(waves)
        pins = self._pins()
        for cid in self._alive():
            if cid == p:
                continue
            r = self._rpc(cid, {"op": "replicate", "waves": waves,
                                "pins": pins})
            if r is not None and r.get("status") == "OK":
                seq = int(r.get("applied_seq", 0))
                self._applied[cid] = max(self._applied.get(cid, 0), seq)
                self.membership.heartbeat(cid, applied_seq=seq)

    # -- membership / failover -------------------------------------------
    def _on_worker_down(self, cid: int) -> None:
        """A worker is gone for sure (dead process, killed inproc, grace
        expired): evict it, complete any failover, re-route its work."""
        events = self.membership.evict(cid, reason="crash")
        if not events:
            return                    # already out of the configuration
        self._handle_events(events)
        self._rescue(cid)

    def _handle_events(self, events: list) -> None:
        for ev in events:
            if ev["type"] == "elect":
                self._complete_failover(ev["epoch"], ev["primary"])

    def _complete_failover(self, epoch: int, new_primary) -> None:
        """Finish an election: durable epoch fence, WAL-tail replay on
        the elected replica, explicit promotion, config broadcast, and
        resolution of every write stranded on the dead primary."""
        if new_primary is None:
            return
        self.stats["failovers"] += 1
        tail = []
        if self.rlog is not None:
            # fence FIRST: once `{graph}.epoch` advances, a deposed
            # primary's sweep can never reach durable state (Fenced).
            # Monotonic — a nested failover may already have fenced higher
            key = f"{self.rlog.graph}.epoch"
            if int(epoch) > int(self.rlog.os.get_meta(key, 0)):
                self.rlog.os.put_meta(key, int(epoch))
            self.rlog.epoch = max(self.rlog.epoch or 0, int(epoch))
            applied = self._applied.get(new_primary, 0)
            tail = [self._waves[s]
                    for s in range(applied + 1, self._shipped_seq + 1)
                    if s in self._waves]
        resp = self._rpc(new_primary, {"op": "promote", "epoch": int(epoch),
                                       "waves": tail})
        if resp is None or resp.get("status") != "OK":
            return      # it died too: _rpc's down-path re-elected already
        seq = int(resp.get("applied_seq", 0))
        self._applied[new_primary] = max(
            self._applied.get(new_primary, 0), seq)
        self.membership.heartbeat(new_primary, applied_seq=seq)
        # propagate the new configuration now: the epoch/primary stamp on
        # the heartbeat demotes any coordinator that still thinks it is
        # primary (its staged writes answer ABORTED_FAILOVER)
        for cid in self._alive():
            if cid != new_primary:
                self._rpc(cid, {"op": "heartbeat"})
        # resolve writes stranded on evicted owners: committed waves are
        # found by rid on the new primary (exactly once); anything else
        # aborts with a retry hint — never a silent drop
        admitted = set(self.membership.admitted())
        for pub, meta in list(self._widmeta.items()):
            w = self.workers.get(meta["cid"])
            if (w is not None and w.alive and meta["cid"] in admitted):
                continue
            self._local[pub] = self._resolve_by_rid(meta)
            del self._widmeta[pub]

    # -- fleet control ---------------------------------------------------
    def kill_worker(self, cid: int) -> None:
        """Kill one coordinator (chaos/ops).  In-flight queries it owned
        re-route; its continuations take over lazily at next_page; if it
        was the write-primary, failover completes before this returns."""
        w = self.workers.get(cid)
        if w is None:
            return
        if w.alive:
            self.stats["worker_kills"] += 1
            w.kill()
        self._on_worker_down(cid)

    def _membership_quantum(self) -> None:
        """One CM tick: renew leases (frames in process mode; liveness is
        direct inproc — the worker IS this process), advance the lease
        state machine, complete any resulting failover, pump replication."""
        if self.mode == "inproc":
            seq = int(getattr(self.db, "wave_seq", 0))
            for cid in self.membership.admitted():
                w = self.workers.get(cid)
                if w is not None and w.alive:
                    self._applied[cid] = seq    # shared store: zero lag
                    self.membership.heartbeat(cid, applied_seq=seq)
        else:
            pins = self._pins()
            for cid in list(self.membership.admitted()):
                w = self.workers.get(cid)
                if w is None or not w.alive:
                    continue
                resp = self._rpc(cid, {"op": "heartbeat", "pins": pins})
                if resp is not None and resp.get("status") == "OK":
                    seq = int(resp.get("applied_seq", 0))
                    self._applied[cid] = max(
                        self._applied.get(cid, 0), seq)
                    self.membership.heartbeat(cid, applied_seq=seq)
        self._handle_events(self.membership.tick())
        self._replicate()

    def pump(self) -> int:
        """One fleet quantum: membership/replication first, then close
        due waves on every coordinator."""
        n = 0
        self._membership_quantum()
        for cid in self._alive():
            resp = self._rpc(cid, {"op": "pump"})
            if resp is not None:
                n += resp.get("n", 0)
        return n

    def flush(self) -> int:
        n = 0
        for cid in self._alive():
            resp = self._rpc(cid, {"op": "flush"})
            if resp is not None:
                n += resp.get("n", 0)
        return n

    def cluster_stats(self) -> dict:
        """Frontend counters + per-worker /stats (budget histograms
        aggregated fleet-wide) + the membership view and per-replica
        replication lag (waves shipped but not yet applied there)."""
        agg = {"frontend": dict(self.stats), "workers": {},
               "budget_spend_ms": None,
               "membership": self.membership.view()}
        if self.rlog is not None:
            frontier = self._shipped_seq
            applied = {c: self._applied.get(c, 0)
                       for c in self.membership.admitted()}
        else:           # one shared store: every alive worker is current
            frontier = int(getattr(self.db, "wave_seq", 0))
            applied = {c: frontier for c in self.membership.admitted()
                       if self.workers[c].alive}
        agg["replication"] = {
            "shipped_seq": frontier,
            "applied_seq": applied,
            "lag": {c: max(0, frontier - s) for c, s in applied.items()},
        }
        agg["replication"]["max_lag"] = max(
            agg["replication"]["lag"].values(), default=0)
        for w in self.workers.values():
            if isinstance(w, _InprocWorker):
                agg["frontend"]["frames_sent"] += w.chan.sent
                agg["frontend"]["frames_dropped"] += w.chan.dropped
        for cid in self._alive():
            resp = self._rpc(cid, {"op": "stats"})
            if resp is None or resp["status"] != "OK":
                continue
            agg["workers"][cid] = resp["stats"]
            h = resp["stats"].get("budget_spend_ms")
            if h:
                if agg["budget_spend_ms"] is None:
                    agg["budget_spend_ms"] = {
                        k: list(v) for k, v in h.items()}
                else:
                    for k, v in h.items():
                        agg["budget_spend_ms"][k] = [
                            a + b for a, b in
                            zip(agg["budget_spend_ms"][k], v)]
        return agg

    # -- wire dispatch (serve_frontend) ----------------------------------
    def handle(self, msg: dict) -> dict:
        """The front door's frame dispatch (JSON-over-TCP clients)."""
        try:
            op = msg["op"]
            if op == "query":
                return {"status": "OK", "qid": self.submit_query(
                    msg["doc"], tenant=msg.get("tenant", "default"),
                    qclass=msg.get("qclass", "q"),
                    budget_ms=msg.get("budget_ms"))}
            if op == "result":
                return {"status": "OK",
                        "result": self.query_result(msg["qid"])}
            if op == "select_paged":
                rows, token = self.select_paged(msg["doc"])
                return {"status": "OK", "rows": rows.tolist(),
                        "token": token}
            if op == "next_page":
                try:
                    rows, token = self.next_page(msg["token"])
                except KeyError as e:
                    return {"status": "EXPIRED", "reason": str(e)}
                return {"status": "OK", "rows": rows.tolist(),
                        "token": token}
            if op == "write":
                return {"status": "OK", "wid": self.submit_write(
                    [decode_write_op(d) for d in msg["ops"]],
                    budget_ms=msg.get("budget_ms"))}
            if op == "write_result":
                return {"status": "OK",
                        "result": self.write_result(msg["wid"])}
            if op == "pump":
                return {"status": "OK", "n": self.pump()}
            if op == "stats":
                return {"status": "OK", "stats": self.cluster_stats()}
            return {"status": "ERROR", "reason": f"unknown op {op!r}"}
        except (KeyError, ValueError, TypeError, RuntimeError) as e:
            return {"status": "ERROR", "reason": str(e)}

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        try:
            for pub in list(self._tokmeta):
                self._release_token(pub)
        finally:
            try:
                for w in self.workers.values():
                    if w.alive:
                        w.kill()
                    elif isinstance(w, _ProcWorker):
                        _stop(w.proc)       # gone from the fleet, not reaped
                        w.client.close()
            finally:
                self.cache.drop(self.name)

    def __enter__(self) -> "A1Frontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
