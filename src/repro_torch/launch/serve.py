"""A1 serving tier: the production loop of §2.2/§3.4.

The paper's serving architecture end to end on one host:

  * a frontend loop that batches incoming A1QL queries (the SLB -> frontend
    -> backend routing of Fig. 4) through the unified ``GraphDB.query``
    entry point — mixed plan shapes, chains *and* star patterns, execute as
    fused multi-query waves (core/query/planner.py) instead of one dispatch
    per query — the paper's "many concurrent queries share each operator
    wave";
  * snapshot-timestamped execution with fast-fail + **continuation
    tokens** (§3.4: big result sets return a token; the frontend routes the
    follow-up to the owning coordinator).  Tokens are continuation-aware
    batch citizens: each token pins its snapshot and caches a result
    window; when a client pages past the window, the follow-up fetch is
    *enqueued* and joins the next wave batch — at its own pinned snapshot
    and with a per-plan ``results`` cap hint — instead of being dispatched
    alone (and pages inside the window never re-run the traversal at all);
  * interleaved writes through the transactional path + replication log;
  * the Task framework pumped between batches (compaction, sweeper,
    vacuum — "low priority workers", §3.3);
  * **read admission** mirroring the write wave: clients
    ``submit_query`` into an async queue that closes into one fused wave at
    ``read_batch`` requests or ``read_deadline_ms`` — whichever first —
    with per-tenant in-flight caps and load shedding: past the queue
    watermark a request gets an immediate ``SHED`` response with a
    retry-after hint instead of growing the queue (the backpressure
    contract; every admitted id terminates in a result or an attributed
    shed/abort);
  * **circuit-breaker hedging**: a fast-failed batch is retried once at
    quadrupled capacities (straggler/outlier mitigation — the latency-tail
    policy the paper enforces with its 100 ms budget), but each query
    class's failure-rate window can open a breaker that skips the hedge
    (truncated-with-flag) under sustained overflow; with per-query flags
    (the fused path) only the failed slice re-dispatches — and it always
    re-dispatches **per-query-budget**, so ``budget="shared"`` overflow
    never re-enters the saturated pool (``shared_ovf_q`` attribution) and
    ``budget="auto"`` can pick shared mode safely at batch >= the knee;
  * latency accounting per query class (avg + P99, the paper's metrics);
  * named fault-injection sites (``core/faults.py``) so chaos tests can
    drive the admission→execute→hedge→respond loop under wave crashes,
    stalls, and stale-continuation storms.

Port of ``repro/launch/serve.py``, laid out as it is.  The server is host
logic over ``GraphDB.query`` and ``GraphDB.write``: it runs on whatever
device its database was built on and adds no device logic of its own.  The
fused planner's results are fresh host arrays, so a hedge patches the
caller's own copy.  The port's write path keeps no program cache (eager
PyTorch builds nothing per op shape), so a fresh server resets only the
planner's counters.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import uuid
from typing import Optional

import numpy as np

from repro_torch.core import faults as faults_mod
from repro_torch.core.query.executor import QueryCaps, QueryResult
from repro_torch.core.query.planner import _pow2ceil
from repro_torch.core.tasks import (TaskQueue, compaction_task,
                                    index_compaction_task, vacuum_task)

# per-stage budget-spend histogram edges (ms).  Each admitted request's SLO
# budget is spent across queueing -> wave -> hedge; /stats buckets the spend
# so operators can see *where* the 100 ms goes (the paper's budget accounting)
BUDGET_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, float("inf"))


@dataclasses.dataclass
class Continuation:
    """One paged select: a pinned snapshot + the materialized row window."""
    token: str
    query: dict           # the original A1QL select document
    read_ts: int          # pinned for the token's lifetime (GC barrier)
    rows: np.ndarray      # valid result gids materialized so far
    cursor: int
    want: int             # results cap the window was materialized at
    truncated: bool       # the server had more rows than ``want``
    expires: float
    hints: dict           # the document's effective cap hints (parse-time)
    max_rows: int         # refill-window ceiling (constant per token)
    cursor_mode: bool = False   # last refill used a gid-cursor predicate


@dataclasses.dataclass
class _ReadReq:
    """One admitted read waiting for its wave."""
    qid: str
    query: dict
    tenant: str
    qclass: str
    arrived: float
    budget_ms: Optional[float] = None   # SLO budget; None = no deadline
    deadline: Optional[float] = None    # abs monotonic: arrived + budget


class _Breaker:
    """Per-query-class circuit breaker over a post-hedge failure window.

    Closed: hedges run normally.  A full window at >= ``threshold`` failure
    rate opens the breaker — sustained overflow means the 4x retry is just
    burning capacity, so waves return truncated-with-flag instead.  While
    open, one probe hedge is admitted every ``cooldown`` skipped waves
    (half-open); any wave that ends unfailed closes it again."""

    def __init__(self, window: int = 8, threshold: float = 0.5,
                 cooldown: int = 4):
        self.window, self.threshold, self.cooldown = window, threshold, \
            cooldown
        self.events = collections.deque(maxlen=window)
        self.open = False
        self._skips = 0
        self.opens = 0

    def allow(self) -> bool:
        if not self.open:
            return True
        if self._skips >= self.cooldown:
            self._skips = 0                       # half-open: probe hedge
            return True
        self._skips += 1
        return False

    def record(self, failed: bool) -> None:
        self.events.append(bool(failed))
        if self.open:
            if not failed:
                self.open = False
                self.events.clear()
                self._skips = 0
        elif (len(self.events) >= self.window
              and sum(self.events) / len(self.events) >= self.threshold):
            self.open = True
            self.opens += 1
            self._skips = 0


class A1Server:
    def __init__(self, db, *, caps: Optional[QueryCaps] = None,
                 page_size: int = 16, continuation_ttl: float = 60.0,
                 use_spmd: bool = False, mesh=None,
                 budget: Optional[str] = "auto",
                 budget_ms: float = 100.0, queue_frac: float = 0.1,
                 write_batch: int = 16,
                 write_deadline_ms: Optional[float] = None,
                 read_batch: int = 16,
                 read_deadline_ms: Optional[float] = None,
                 shed_watermark: int = 64, tenant_inflight: int = 32,
                 result_ttl: Optional[float] = None,
                 shared_knee: int = 64,
                 breaker_window: int = 8, breaker_threshold: float = 0.5,
                 breaker_cooldown: int = 4,
                 write_fence: Optional[callable] = None):
        self.db = db
        # commit-time fence: when set, every wave close consults it and a
        # False answer aborts the whole wave ABORTED_FAILOVER — the last
        # line against a deposed primary committing after its epoch moved
        # on (the cluster front wires this to membership, §2/FaRM §3)
        self.write_fence = write_fence
        self.caps = caps or QueryCaps()
        self.page = page_size
        self.ttl = continuation_ttl
        self.tasks = TaskQueue(db)
        # attach the queue so write waves can threshold-trigger background
        # compaction (§2.2) instead of compacting on the commit path
        db.task_queue = self.tasks
        # deadline work must progress with an *empty* query stream too: the
        # low-priority pump doubles as the wave-deadline clock (§3.3)
        self.tasks.on_pump = self._maybe_close_write_wave
        self._continuations: dict[str, Continuation] = {}
        self._pending: list[str] = []       # tokens awaiting a refill fetch
        self.use_spmd = use_spmd
        self.mesh = mesh
        # fused frontier discipline: "auto" picks "shared" (the serving-cap
        # memory shape, owner-attributed fast-fail) for waves of >=
        # ``shared_knee`` queries — the measured amortization knee — and
        # per-query budgets below it; None/"per-query"/"shared" pin a mode.
        # Safe because shared-pool overflow re-dispatches per-query (see
        # ``_dispatch``), never re-entering the saturated pool.
        self.budget = budget
        self.shared_knee = shared_knee
        # SLO-budget scheduling (the paper's ~100 ms end-to-end budget):
        # every request carries a budget; admission decrements it through
        # the queueing / wave / hedge stages.  ``read_deadline_ms`` /
        # ``write_deadline_ms`` are now *optional* legacy overrides: when
        # ``None`` (the default) wave-close deadlines derive from the
        # queued requests' remaining budgets (a wave closes once its oldest
        # member has spent ``queue_frac`` of its budget queueing), the wave
        # execution deadline is the earliest member's budget edge (threaded
        # to the engine, which skips not-yet-run fusion groups past it),
        # and hedges are denied once the budget is gone.  An explicitly
        # passed value pins the historical fixed-deadline behavior — and
        # turns *off* per-request deadlines unless a request opts in with
        # its own ``budget_ms``.
        self.budget_ms = budget_ms
        self.queue_frac = queue_frac
        self._default_budget_ms = (None if read_deadline_ms is not None
                                   else budget_ms)
        self._read_floor_ms = (read_deadline_ms if read_deadline_ms
                               is not None else queue_frac * budget_ms)
        self._write_floor_ms = (write_deadline_ms if write_deadline_ms
                                is not None else queue_frac * budget_ms)
        # write admission: staged txns accumulate here and close into one
        # fused mutation wave at max-batch-or-deadline
        self.write_batch = write_batch
        self.write_deadline_ms = write_deadline_ms
        self._write_q: list[tuple] = []     # (wid, txn, staged gids, arrived)
        self._write_results: dict[str, dict] = {}
        self._write_exp: dict[str, float] = {}
        self._wave_opened = 0.0
        # read admission: the same max-batch-or-deadline wave, plus
        # backpressure — queue watermark shedding and per-tenant caps
        self.read_batch = read_batch
        self.read_deadline_ms = read_deadline_ms
        self.shed_watermark = shed_watermark
        self.tenant_cap = tenant_inflight
        self.result_ttl = continuation_ttl if result_ttl is None \
            else result_ttl
        self._read_q: list[_ReadReq] = []
        self._read_opened = 0.0
        self._read_results: dict[str, dict] = {}
        self._read_exp: dict[str, float] = {}
        self._tenant_inflight: collections.Counter = collections.Counter()
        self._closing = False               # read-wave reentrancy guard
        self._wave_ms = self._read_floor_ms  # EWMA of recent wave wall time
        self._wave_seeded = False           # EWMA holds a measured wall yet?
        self._wwave_ms = self._write_floor_ms  # write-wave wall EWMA
        self._wwave_seeded = False
        self.breakers: dict[str, _Breaker] = {}
        self._breaker_cfg = (breaker_window, breaker_threshold,
                             breaker_cooldown)
        self.latencies: dict[str, list[float]] = {}
        self.stats = {"queries": 0, "fastfails": 0, "hedged": 0,
                      "continuations": 0, "continuation_joins": 0,
                      "continuation_flushes": 0, "cursor_refills": 0,
                      "write_waves": 0, "write_txns": 0,
                      "write_aborts": 0, "write_rejects": 0,
                      "write_fenced": 0,
                      "admitted": 0, "served": 0, "sheds": 0,
                      "tenant_sheds": 0, "read_rejects": 0,
                      "read_waves": 0, "wave_faults": 0,
                      "aborted_faults": 0,
                      "breaker_skips": 0, "breaker_opens": 0,
                      "dropped_write_results": 0, "dropped_read_results": 0,
                      "shared_ovf_queries": 0,
                      "budget_exhausted": 0, "budget_denied_hedges": 0,
                      "deadline_truncated_queries": 0,
                      "budget_spend_ms": {
                          s: [0] * len(BUDGET_BUCKETS_MS)
                          for s in ("queue", "wave", "hedge")},
                      "planner_cache_hit_rate": 0.0,
                      "peak_frontier_bytes_per_query": 0,
                      "peak_frontier_bytes_shared": 0}
        # the planner's counters are process-global (programs are shared);
        # a fresh server must not report the previous instance's hit rates,
        # peaks, or overflow tallies (the write path has no program cache)
        from repro_torch.core.query import planner as planner_mod
        planner_mod.reset_stats()

    # ------------------------------------------------------------------
    def execute(self, queries: list[dict], *, qclass: str = "q",
                read_ts: Optional[int] = None,
                deadline: Optional[float] = None) -> QueryResult:
        """One batched execution with hedged retry on fast-fail.

        The whole attempt — base run *and* hedged retry — reads one pinned
        snapshot, so a patched batch never mixes two timestamps.  Pending
        continuation refills join the batch (at their own pinned
        snapshots, per-query ``read_ts`` vector) before it dispatches.
        ``deadline`` is the wave's SLO-budget edge (absolute monotonic):
        fusion groups past it come back ``deadline_q``-truncated and the
        hedge is denied once it has passed."""
        t0 = time.perf_counter()
        # close a due mutation wave BEFORE pinning the read snapshot: readers
        # then see the freshest committed state, and the pinned snapshot is
        # never moved by writes admitted mid-flight (hedged retries included)
        self._maybe_close_write_wave()
        ts0 = self.db.snapshot_ts() if read_ts is None else int(read_ts)
        self.db.active_query_ts.append(ts0)      # pin across run + hedge
        try:
            self._sweep()
            pend = self._drain_pending()
            n = len(queries)
            batch = queries + [q for _, q, _ in pend]
            ts_vec = [ts0] * n + [t for _, _, t in pend]
            self.stats["continuation_joins"] += len(pend)
            res = self._dispatch(batch, ts_vec, qclass=qclass,
                                 deadline=deadline)
            for j, (token, _, _) in enumerate(pend):
                self._refill(token, res, n + j)
            if pend:
                res = self._slice_result(res, n)
        finally:
            self.db.active_query_ts.remove(ts0)
        dt = time.perf_counter() - t0
        self.latencies.setdefault(qclass, []).append(dt)
        self.stats["queries"] += len(queries)
        self._update_planner_stats()
        # cooperative maintenance between batches (§3.3 low-priority pump)
        self.tasks.pump(1)
        return res

    def _update_planner_stats(self) -> None:
        """Surface the planner's cache hit-rate and peak frontier footprint
        (per budget mode) in the server's /stats counters."""
        from repro_torch.core.query import planner
        cs = planner.CACHE_STATS
        total = cs["hits"] + cs["misses"]
        self.stats["planner_cache_hit_rate"] = (
            round(cs["hits"] / total, 4) if total else 0.0)
        self.stats["peak_frontier_bytes_per_query"] = (
            planner.FRONTIER_STATS["per_query_peak_bytes"])
        self.stats["peak_frontier_bytes_shared"] = (
            planner.FRONTIER_STATS["shared_peak_bytes"])
        self.stats["shared_ovf_queries"] = (
            planner.OVERFLOW_STATS["shared_ovf_queries"])

    def _budget_for(self, n: int) -> Optional[str]:
        """Resolve the per-dispatch frontier discipline: ``"auto"`` takes
        shared budgets at/above the amortization knee, else per-query."""
        if self.budget == "auto":
            return "shared" if n >= self.shared_knee else "per-query"
        return self.budget

    def _run(self, queries, caps, read_ts, fused: Optional[bool] = None,
             budget: str = "auto", deadline: Optional[float] = None):
        """The unified entry point; ``fused=True`` forces per-query
        ``failed_q`` flags (what hedged retries want).  ``budget="auto"``
        resolves the server policy; hedged retries pass ``"per-query"``
        explicitly so they never re-enter a saturated shared pool."""
        if budget == "auto":
            budget = self._budget_for(len(queries))
        mesh = self.mesh if self.use_spmd else None
        return self.db.query(queries, caps=caps, read_ts=read_ts, mesh=mesh,
                             fused=fused, budget=budget, deadline=deadline)

    def _doc_hints(self, q: dict) -> dict:
        """Effective cap hints of a document, exactly as the parser merges
        them (terminal + root, root wins) — the parse result is the single
        source of that precedence."""
        from repro_torch.core.query.a1ql import parse
        return {k: v
                for k, v in dataclasses.asdict(parse(self.db, q).hints
                                               ).items() if v is not None}

    def _hedged_doc(self, q: dict) -> dict:
        """Quadruple a document's own frontier/expand hints for the hedged
        retry (hints override the retry caps, so they must scale too)."""
        h = self._doc_hints(q)
        scaled = {k: (4 * v if k in ("frontier", "expand") else v)
                  for k, v in h.items()}
        return {**q, "hints": scaled} if scaled else q

    def _breaker(self, qclass: str) -> _Breaker:
        br = self.breakers.get(qclass)
        if br is None:
            br = self.breakers[qclass] = _Breaker(*self._breaker_cfg)
        return br

    def breaker_state(self) -> dict:
        return {k: ("open" if b.open else "closed")
                for k, b in self.breakers.items()}

    def _dispatch(self, batch, ts_vec, fused: Optional[bool] = None,
                  qclass: str = "q",
                  deadline: Optional[float] = None) -> QueryResult:
        """Base run + circuit-breaker-hedged retry.

        A fast-failed batch is retried once at 4x capacity (tail control,
        then give up — the paper discards queries that blow the time
        budget), unless ``qclass``'s breaker is open: under sustained
        overflow the hedge is pure waste, so the wave returns
        truncated-with-flag immediately (a half-open probe hedge every few
        waves closes the breaker once retries succeed again).  With
        per-query flags (fused path) only the failed slice retries, and the
        retry always runs **per-query budgets**: a shared-pool eviction
        (``shared_ovf_q``) must not re-enter the pool that evicted it, and
        per-query-mode flags are a subset of shared-mode flags, so anything
        the pool would have answered the retry answers identically.
        Queries whose own cap hints pin frontier/expand get those hints
        quadrupled too — otherwise the hint would override ``big`` and the
        retry would re-run at exactly the failed budget.

        The hedge decision derives from the remaining SLO budget: a wave
        whose ``deadline`` has already passed gets no hedge at all
        (``budget_denied_hedges``) — re-running a failed query past the
        budget edge is exactly the waste the paper's 100 ms discipline
        forbids — and a hedge that does run inherits the deadline, so its
        not-yet-run groups truncate instead of overshooting."""
        faults_mod.check(self.db, "serve.wave.stall")
        res = self._run(batch, self.caps, ts_vec, fused=fused,
                        deadline=deadline)
        if res.failed:
            t_hedge = time.monotonic()
            if deadline is not None and t_hedge >= deadline:
                self.stats["budget_denied_hedges"] += 1
                self.stats["fastfails"] += 1
            elif self._breaker(qclass).allow():
                self.stats["hedged"] += 1
                big = dataclasses.replace(
                    self.caps, frontier=self.caps.frontier * 4,
                    expand=self.caps.expand * 4)
                if res.failed_q is not None and not all(res.failed_q):
                    idx = [i for i, f in enumerate(res.failed_q) if f]
                    retry = self._run(
                        [self._hedged_doc(batch[i]) for i in idx], big,
                        [ts_vec[i] for i in idx], fused=True,
                        budget="per-query", deadline=deadline)
                    self._patch(res, retry, idx)
                else:
                    res = self._run([self._hedged_doc(q) for q in batch],
                                    big, ts_vec, fused=fused,
                                    budget="per-query", deadline=deadline)
                self._spend("hedge", (time.monotonic() - t_hedge) * 1e3)
                if res.failed:
                    self.stats["fastfails"] += 1
            else:
                self.stats["breaker_skips"] += 1
                self.stats["fastfails"] += 1
        self._breaker(qclass).record(bool(res.failed))
        self.stats["breaker_opens"] = sum(b.opens
                                          for b in self.breakers.values())
        return res

    @staticmethod
    def _patch(res: QueryResult, retry: QueryResult, idx: list[int]) -> None:
        """Overwrite the failed queries' slices with their hedged retry."""
        for j, i in enumerate(idx):
            if retry.counts is not None and res.counts is not None:
                res.counts[i] = retry.counts[j]
            if retry.rows_gid is not None and res.rows_gid is not None:
                k = min(retry.rows_gid.shape[1], res.rows_gid.shape[1])
                res.rows_gid[i, :k] = retry.rows_gid[j, :k]
                res.truncated[i] = retry.truncated[j]
                for key in (res.rows or {}):
                    if retry.rows and key in retry.rows:
                        res.rows[key][i, :k] = retry.rows[key][j, :k]
            res.failed_q[i] = retry.failed_q[j]
            if retry.deadline_q is not None and res.deadline_q is not None:
                # the hedge itself ran out of budget: the query is now
                # budget-truncated, not failed
                res.deadline_q[i] = retry.deadline_q[j]
            if res.shared_ovf_q is not None:
                # the retry ran per-query: any surviving failure is now
                # self-inflicted, not a shared-pool eviction
                res.shared_ovf_q[i] = (False if retry.shared_ovf_q is None
                                       else retry.shared_ovf_q[j])
        res.failed = bool(np.any(res.failed_q))

    @staticmethod
    def _slice_result(res: QueryResult, n: int) -> QueryResult:
        sl = lambda a: None if a is None else a[:n]
        return QueryResult(
            counts=sl(res.counts), rows_gid=sl(res.rows_gid),
            rows=None if res.rows is None else
            {k: v[:n] for k, v in res.rows.items()},
            truncated=sl(res.truncated),
            failed_q=sl(res.failed_q),
            shared_ovf_q=sl(res.shared_ovf_q),
            deadline_q=sl(res.deadline_q),
            failed=res.failed if res.failed_q is None
            else bool(np.any(res.failed_q[:n])))

    def _spend(self, stage: str, ms: float) -> None:
        """Bucket one stage's budget spend into the /stats histogram."""
        h = self.stats["budget_spend_ms"][stage]
        for i, edge in enumerate(BUDGET_BUCKETS_MS):
            if ms <= edge:
                h[i] += 1
                return

    # ------------------------------------------------------------------
    # continuation tokens (§3.4)
    # ------------------------------------------------------------------
    def select_paged(self, query: dict, *, read_ts: Optional[int] = None
                     ) -> tuple[np.ndarray, Optional[str]]:
        """Run a select query; return (first page, continuation token).

        ``read_ts`` pins the page walk at a caller-chosen snapshot — the
        cluster takeover path replays a lost coordinator's token at the
        *original* token's timestamp so the remaining pages come back
        bit-identical (the caller owns that pin; this method adds its own
        for the token's lifetime either way)."""
        ts0 = self.db.snapshot_ts() if read_ts is None else int(read_ts)
        self.db.active_query_ts.append(ts0)      # the token's pin
        token = None
        try:
            res = self.execute([query], qclass="select", read_ts=ts0)
            if res.rows_gid is None:
                raise ValueError("select_paged needs a select query")
            rows = res.rows_gid[0]
            rows = rows[rows >= 0]
            truncated = bool(res.truncated[0])
            if len(rows) <= self.page and not truncated:
                return rows, None
            first = rows[: self.page]
            token = uuid.uuid4().hex
            hints = self._doc_hints(query)
            self._continuations[token] = Continuation(
                token=token, query=query, read_ts=ts0, rows=rows,
                cursor=len(first), want=self.caps.results,
                truncated=truncated, expires=time.monotonic() + self.ttl,
                hints=hints, max_rows=self._max_rows(hints))
            self.stats["continuations"] += 1
            return first, token
        finally:
            if token is None:                    # no token owns the pin
                self.db.active_query_ts.remove(ts0)

    def next_page(self, token: str) -> tuple[np.ndarray, Optional[str]]:
        """Follow a continuation token (expired/crashed -> client restarts,

        exactly the paper's contract).  Pages inside the cached window are
        free; paging past it enqueues a refill that joins the next wave
        batch (``execute``), or flushes synchronously when the client gets
        there first."""
        c = self._continuations.get(token)
        if c is None or time.monotonic() > c.expires:
            self._drop(token)
            raise KeyError("continuation expired; restart the query")
        if c.truncated and c.cursor + self.page > len(c.rows):
            # client outran the prefetch (or there was no traffic for the
            # refill to join): flush the pending batch now.  A no-op when a
            # prior ``execute`` already carried the refill.
            self._request_refill(token)
            self._flush_pending()
        page = c.rows[c.cursor:c.cursor + self.page]
        c.cursor += len(page)
        if c.cursor >= len(c.rows) and not c.truncated:
            self._drop(token)
            return page, None
        if c.truncated and c.cursor + self.page > len(c.rows):
            # prefetch: the follow-up fetch joins the next wave batch
            self._request_refill(token)
        return page, token

    # -- continuation internals ----------------------------------------
    def _max_rows(self, hints: dict) -> int:
        """Ceiling on the rows a refill can materialize: the final frontier
        region is per-shard under SPMD (global rows span all shards), the
        document's own ``frontier`` hint may raise it, and the hedged retry
        runs at 4x — so the window keeps growing as long as refills can
        still deliver (a progress guard in ``_refill`` terminates deep
        pagination once they stop)."""
        shards = self.db.cfg.n_shards if self.use_spmd else 1
        frontier = max(self.caps.frontier, hints.get("frontier", 0))
        return 4 * frontier * shards

    def _request_refill(self, token: str) -> None:
        if token not in self._pending:
            self._pending.append(token)

    def _drain_pending(self):
        """Pending refills -> (token, hinted query, read_ts) triples.

        Two refill plans:

        * **gid-cursor** (preferred): the document gains a root-level
          ``gid_cursor`` — a runtime ``gid > cursor`` final predicate — and
          a *constant* O(page) ``results`` window, so every deep-page
          refill costs one page instead of re-materializing a pow2-growing
          window.  Requires the local executors (rows are globally
          gid-ascending there; under SPMD positions are shard-major, so a
          max-gid cursor could skip rows) and no pinned document hints.
        * **pow2 fallback**: the historical growing-window refill (kept for
          SPMD and hint-pinned documents)."""
        out = []
        for token in self._pending:
            c = self._continuations.get(token)
            if c is None:
                continue
            c.cursor_mode = (not self.use_spmd and not c.hints
                             and len(c.rows) > 0)
            if c.cursor_mode:
                self.stats["cursor_refills"] += 1
                want = _pow2ceil(2 * self.page)          # O(page), constant
                doc = {**c.query, "gid_cursor": int(c.rows[-1]),
                       "hints": {"results": want}}
                out.append((token, doc, c.read_ts))
                continue
            want = min(_pow2ceil(max(c.want * 2, c.cursor + 2 * self.page)),
                       c.max_rows)
            c.want = want
            # keep the document's own hints (frontier/expand budgets it may
            # need) — only the results window is overridden, root wins
            out.append((token,
                        {**c.query, "hints": {**c.hints, "results": want}},
                        c.read_ts))
        self._pending = []
        return out

    def _refill(self, token: str, res: QueryResult, idx: int) -> None:
        c = self._continuations.get(token)
        if c is None:
            return
        if res.failed_q is not None and bool(res.failed_q[idx]):
            # the refill fast-failed (even after the hedge): keep the old
            # window rather than committing a failed run's partial rows —
            # the client retries via the still-truncated token (or it
            # expires)
            return
        if res.deadline_q is not None and bool(res.deadline_q[idx]):
            # the wave it joined ran out of SLO budget before the refill's
            # group dispatched: same keep-the-window contract as a failure
            return
        rows = res.rows_gid[idx]
        new_rows = rows[rows >= 0]
        if c.cursor_mode:
            # cursor refill: every row is past the window's last gid, so
            # the fetch *appends* — the window stays ascending and each
            # refill did O(page) work.  A truncated cursor fetch always
            # returned >= 1 row, so pagination is guaranteed to progress.
            if len(new_rows):
                c.rows = np.concatenate([c.rows, new_rows])
            c.truncated = bool(res.truncated[idx])
            c.expires = time.monotonic() + self.ttl
            return
        # once the window can no longer grow (want at ceiling) AND a refill
        # stopped delivering new rows, the token must complete — otherwise
        # every next_page would re-dispatch the same doomed fetch
        progressed = len(new_rows) > len(c.rows)
        c.rows = new_rows
        c.truncated = bool(res.truncated[idx]) and (
            c.want < c.max_rows or progressed)
        c.expires = time.monotonic() + self.ttl

    def _flush_pending(self) -> None:
        """Run the pending refills as their own wave batch (no primary
        traffic to join).  Same hedged-retry policy as primary batches."""
        pend = self._drain_pending()
        if not pend:
            return
        self.stats["continuation_flushes"] += 1
        res = self._dispatch([q for _, q, _ in pend],
                             [t for _, _, t in pend], fused=True,
                             qclass="continuation")
        for j, (token, _, _) in enumerate(pend):
            self._refill(token, res, j)

    def _drop(self, token: str) -> None:
        c = self._continuations.pop(token, None)
        if c is not None:
            self.db.active_query_ts.remove(c.read_ts)

    def _sweep(self) -> None:
        """Expiry sweep: continuations, write results, read results.

        Results for ids the client never polls would otherwise accumulate
        forever (a ``_write_results`` leak); they age out on the
        same ``result_ttl`` clock and the drops are counted — a dropped
        result is an *attributed* loss, visible in /stats, never a silent
        one.  The ``serve.continuation.stale`` chaos site force-expires
        every token here (stale-token storm): clients get the §3.4
        "restart the query" contract, pins are released, nothing leaks."""
        now = time.monotonic()
        if faults_mod.check(self.db, "serve.continuation.stale"):
            for c in self._continuations.values():
                c.expires = now - 1.0
        for token in [t for t, c in self._continuations.items()
                      if now > c.expires]:
            self._drop(token)
        for results, exp, key in (
                (self._write_results, self._write_exp,
                 "dropped_write_results"),
                (self._read_results, self._read_exp,
                 "dropped_read_results")):
            for k in [k for k, e in exp.items() if now > e]:
                del exp[k]
                results.pop(k, None)
                self.stats[key] += 1

    # ------------------------------------------------------------------
    # read admission (the §3.4 serving queue: SLB -> frontend backpressure)
    # ------------------------------------------------------------------
    def submit_query(self, query: dict, *, tenant: str = "default",
                     qclass: str = "q",
                     budget_ms: Optional[float] = None) -> str:
        """Admit one client read; returns a query id to poll.

        Admission control runs *before* the queue grows: past the
        ``shed_watermark`` (or the tenant's in-flight cap) the request is
        shed immediately — a ``SHED`` result with a ``retry_after_ms``
        drain estimate, costing dict ops, not a wave slot.  Malformed
        documents reject at admission (``REJECTED``) so a bad query can
        never poison a wave.  Admitted requests close into a fused wave at
        ``read_batch`` or the wave-close deadline — fixed
        ``read_deadline_ms`` if pinned, else the oldest member's
        ``queue_frac`` budget spend (serviced by :meth:`query_result`
        polls, :meth:`pump`, or :meth:`flush_queries`).  Every admitted id
        terminates in exactly one stored result.

        ``budget_ms`` is this request's SLO budget (default: the server's
        ``budget_ms`` when running budget-derived deadlines, none when a
        fixed ``read_deadline_ms`` was pinned).  An already-exhausted
        budget (``<= 0``) short-circuits at admission: the truncated
        ``budget_exhausted`` row is stored immediately — never queued, no
        wave slot, the sub-millisecond fast-reject the paper's budget
        discipline implies."""
        qid = uuid.uuid4().hex
        now = time.monotonic()
        if budget_ms is None:
            budget_ms = self._default_budget_ms
        if budget_ms is not None and budget_ms <= 0:
            self.stats["budget_exhausted"] += 1
            self._store_read_result(qid, {
                "status": "OK", "failed": False, "rows": [],
                "truncated": True, "budget_exhausted": True})
            return qid
        if len(self._read_q) >= self.shed_watermark:
            self.stats["sheds"] += 1
            self._store_read_result(qid, {
                "status": "SHED", "reason": "overload",
                "retry_after_ms": self._retry_after_ms()})
            return qid
        if self._tenant_inflight[tenant] >= self.tenant_cap:
            self.stats["sheds"] += 1
            self.stats["tenant_sheds"] += 1
            self._store_read_result(qid, {
                "status": "SHED", "reason": f"tenant-cap:{tenant}",
                "retry_after_ms": self._retry_after_ms()})
            return qid
        try:
            from repro_torch.core.query.a1ql import parse
            parse(self.db, query)
        except (ValueError, KeyError, TypeError) as e:
            self.stats["read_rejects"] += 1
            self._store_read_result(qid, {"status": "REJECTED",
                                          "reason": str(e)})
            return qid
        self._read_q.append(_ReadReq(
            qid, query, tenant, qclass, now, budget_ms=budget_ms,
            deadline=None if budget_ms is None
            else now + budget_ms * 1e-3))
        self._tenant_inflight[tenant] += 1
        self.stats["admitted"] += 1
        if len(self._read_q) == 1:
            self._read_opened = now
        if len(self._read_q) >= self.read_batch:
            self._close_read_wave()
        return qid

    def query_result(self, qid: str) -> Optional[dict]:
        """Poll a submitted read: the result dict, or ``None`` while its
        wave is still open.  Polling drives the deadline clock."""
        self._maybe_close_read_wave()
        r = self._read_results.pop(qid, None)
        if r is not None:
            self._read_exp.pop(qid, None)
        return r

    def flush_queries(self) -> int:
        """Close every pending read wave now (shutdown, test barriers)."""
        n = 0
        while self._read_q:
            n += self._close_read_wave()
        return n

    def pump(self) -> int:
        """One serving quantum with no client traffic: close due admission
        waves (writes and reads), sweep expired state, and run one
        maintenance task."""
        n = self._maybe_close_write_wave()
        nr = self._maybe_close_read_wave()
        if nr == 0:
            # idle tick: decay the EWMA toward the deadline floor so a burst
            # of slow waves long past doesn't inflate shed retry-after hints
            # forever (_retry_after_ms trusts _wave_ms; stale is a lie)
            self._wave_ms += 0.2 * (self._read_floor_ms - self._wave_ms)
        n += nr
        self._sweep()
        self.tasks.pump(1)
        return n

    def _retry_after_ms(self) -> float:
        """Drain estimate for a shed client: backlog waves x recent wave
        wall time (EWMA), floored at one wave deadline — *both* sides of
        the house.  Reads and writes drain through the same serving loop
        (a read wave closes the due mutation wave first), so a queued
        write backlog delays the shed client's retry exactly like queued
        reads do; quoting from the read EWMA alone under-estimates under
        mixed overload."""
        waves = max(1, -(-len(self._read_q) // self.read_batch))
        est = waves * max(self._wave_ms, self._read_floor_ms)
        if self._write_q:
            wwaves = -(-len(self._write_q) // self.write_batch)
            est += wwaves * max(self._wwave_ms, self._write_floor_ms)
        return round(est, 3)

    def _store_read_result(self, qid: str, row: dict) -> None:
        self._read_results[qid] = row
        self._read_exp[qid] = time.monotonic() + self.result_ttl

    def _maybe_close_read_wave(self) -> int:
        if self._closing or not self._read_q:
            return 0
        now = time.monotonic()
        if self.read_deadline_ms is not None:      # pinned legacy deadline
            due = (now - self._read_opened) * 1e3 >= self.read_deadline_ms
        else:
            # SLO-budget scheduling: the wave is due once any queued
            # request has spent its queueing allowance (queue_frac of its
            # budget) — the deadline knob derives from the budgets, not a
            # constant
            due = any(
                r.budget_ms is not None
                and (now - r.arrived) * 1e3
                >= self.queue_frac * r.budget_ms
                for r in self._read_q)
        if due or len(self._read_q) >= self.read_batch:
            return self._close_read_wave()
        return 0

    def _close_read_wave(self) -> int:
        """Execute one admitted wave and store every member's result.

        An injected wave crash (``engine.wave``) gets one retry — the
        crashed-worker re-dispatch — then the whole wave aborts *with
        attribution* (``fault:<site>``): the invariant is that no admitted
        request ever terminates silently, not that every wave succeeds."""
        if self._closing or not self._read_q:
            return 0
        self._closing = True
        try:
            wave = self._read_q[:self.read_batch]
            self._read_q = self._read_q[self.read_batch:]
            if self._read_q:
                self._read_opened = time.monotonic()
            t0 = time.monotonic()
            # requests whose whole budget went to queueing answer here:
            # truncated-with-flag, never a wave slot (§3.4 discards queries
            # past the budget; we answer them with the exhaustion marker)
            live = []
            for r in wave:
                if r.deadline is not None and t0 >= r.deadline:
                    self._tenant_inflight[r.tenant] -= 1
                    self.stats["budget_exhausted"] += 1
                    self._spend("queue", (t0 - r.arrived) * 1e3)
                    self._store_read_result(r.qid, {
                        "status": "OK", "failed": False, "rows": [],
                        "truncated": True, "budget_exhausted": True})
                    self.latencies.setdefault(r.qclass, []).append(
                        t0 - r.arrived)
                else:
                    live.append(r)
            if not live:
                self.stats["read_waves"] += 1
                return len(wave)
            # the wave's execution deadline: the earliest member's budget
            # edge — one fused dispatch serves the whole wave, so the
            # tightest budget bounds it (groups past the edge come back
            # ``deadline_q`` for *every* member; the paper's budget is a
            # shared discipline, not per-query slack)
            edges = [r.deadline for r in live if r.deadline is not None]
            wave_deadline = min(edges) if edges else None
            res, err = None, None
            for _ in range(2):
                try:
                    res = self.execute([r.query for r in live],
                                       qclass="wave",
                                       deadline=wave_deadline)
                    break
                except faults_mod.InjectedFault as e:
                    err = e
                    self.stats["wave_faults"] += 1
            wall = (time.monotonic() - t0) * 1e3
            if self._wave_seeded:
                self._wave_ms = 0.7 * self._wave_ms + 0.3 * wall
            else:
                # first completed wave: seed with the measurement instead of
                # blending into the deadline-derived initial guess
                self._wave_ms = wall
                self._wave_seeded = True
            done = time.monotonic()
            for i, r in enumerate(live):
                self._tenant_inflight[r.tenant] -= 1
                self._spend("queue", (t0 - r.arrived) * 1e3)
                self._spend("wave", wall)
                if res is None:
                    self.stats["aborted_faults"] += 1
                    self._store_read_result(r.qid, {
                        "status": "ABORTED", "reason": f"fault:{err.site}"})
                else:
                    self._store_read_result(r.qid, self._result_row(res, i))
                    self.stats["served"] += 1
                self.latencies.setdefault(r.qclass, []).append(
                    done - r.arrived)
            if res is not None and res.deadline_q is not None:
                self.stats["deadline_truncated_queries"] += int(
                    np.asarray(res.deadline_q)[:len(live)].sum())
            self.stats["read_waves"] += 1
            return len(wave)
        finally:
            self._closing = False

    @staticmethod
    def _result_row(res: QueryResult, i: int) -> dict:
        row = {"status": "OK",
               "failed": bool(res.failed_q[i]) if res.failed_q is not None
               else bool(res.failed)}
        if res.counts is not None and int(res.counts[i]) >= 0:
            row["count"] = int(res.counts[i])
        if res.rows_gid is not None:
            r = res.rows_gid[i]
            row["rows"] = r[r >= 0].tolist()
            row["truncated"] = bool(res.truncated[i])
        if res.deadline_q is not None and bool(res.deadline_q[i]):
            # SLO-budget truncation: the group never dispatched.  Not a
            # failure (failed stays False) — the client sees a partial
            # result with the exhaustion marker and decides to retry
            row["budget_exhausted"] = True
            row["truncated"] = True
        return row

    # ------------------------------------------------------------------
    # write admission (§3.4 grows its first write-side machinery)
    # ------------------------------------------------------------------
    def submit_write(self, ops, *, budget_ms: Optional[float] = None,
                     wid: Optional[str] = None) -> str:
        """Admit one client write: a list of mutation-op records.

        The ops stage into their own transaction at the admission snapshot
        and queue for the next mutation wave, which closes at
        ``write_batch`` transactions or the wave-close deadline — fixed
        ``write_deadline_ms`` when pinned, else once the oldest staged
        write has spent ``queue_frac`` of its SLO budget queueing (the
        deadline is serviced by query traffic via :meth:`execute`, or by
        :meth:`flush_writes`).  Returns a write id; poll
        :meth:`write_result` for the outcome.  Staging contract violations
        (duplicate key, missing endpoint, ...) reject immediately — the
        wave never sees them.  Write budgets drive *scheduling* only: an
        admitted write always commits or aborts through its wave —
        truncating a half-applied transaction is not a thing.

        ``wid=`` lets the cluster frontend pin the id (its rid): if that
        rid already committed here — a retransmit to a freshly promoted
        primary that replayed the original wave — the ORIGINAL result is
        restored instead of committing twice (exactly-once, §4).
        """
        wid = wid or uuid.uuid4().hex
        hit = getattr(self.db, "applied_rids", {}).get(wid)
        if hit is not None:
            self._write_results[wid] = {
                "status": "COMMITTED", "reason": None,
                "gids": list(hit["gids"]), "ts": hit["ts"]}
            self._write_exp[wid] = time.monotonic() + self.result_ttl
            return wid
        if budget_ms is None:
            budget_ms = (None if self.write_deadline_ms is not None
                         else self.budget_ms)
        t = self.db.create_transaction()
        t.rid = wid
        try:
            staged = self.db.write(list(ops), txn=t)
        except ValueError as e:
            self.stats["write_rejects"] += 1
            self._write_results[wid] = {"status": "ABORTED",
                                        "reason": str(e), "gids": [], "ts": -1}
            self._write_exp[wid] = time.monotonic() + self.result_ttl
            return wid
        self._write_q.append((wid, t, staged.gids,
                              time.monotonic(), budget_ms))
        if len(self._write_q) == 1:
            self._wave_opened = time.monotonic()
        if len(self._write_q) >= self.write_batch:
            self._close_write_wave()
        return wid

    def write_result(self, wid: str) -> Optional[dict]:
        """Outcome of a submitted write: ``{status, reason, gids, ts}``, or
        ``None`` while it is still queued for a wave."""
        r = self._write_results.pop(wid, None)
        if r is not None:
            self._write_exp.pop(wid, None)
        return r

    def flush_writes(self) -> int:
        """Close the open mutation wave now (deadline expiry, shutdown)."""
        return self._maybe_close_write_wave(force=True)

    def abort_staged_writes(self, reason: str = "primary deposed") -> int:
        """Demotion path: answer every staged (not yet waved) write
        ABORTED_FAILOVER with a retry hint.  A replica must never commit,
        and an admitted write must never vanish silently."""
        wave, self._write_q = self._write_q, []
        exp = time.monotonic() + self.result_ttl
        for wid, _, gids, *_ in wave:
            self._write_results[wid] = {
                "status": "ABORTED_FAILOVER", "reason": reason,
                "gids": [-1] * len(gids), "ts": -1,
                "retry_after_ms": self._wwave_ms}
            self._write_exp[wid] = exp
        self.stats["write_fenced"] = (
            self.stats.get("write_fenced", 0) + len(wave))
        return len(wave)

    def _maybe_close_write_wave(self, force: bool = False) -> int:
        if not self._write_q:
            return 0
        now = time.monotonic()
        if self.write_deadline_ms is not None:     # pinned legacy deadline
            due = (now - self._wave_opened) * 1e3 >= self.write_deadline_ms
        else:
            due = any(
                b is not None
                and (now - arr) * 1e3 >= self.queue_frac * b
                for _, _, _, arr, b in self._write_q)
        if force or due or len(self._write_q) >= self.write_batch:
            return self._close_write_wave()
        return 0

    def _close_write_wave(self) -> int:
        wave, self._write_q = self._write_q, []
        if self.write_fence is not None and not self.write_fence():
            # deposed between admission and commit: the store is untouched
            # and every queued write answers ABORTED_FAILOVER (retryable
            # through the new primary) — never a silent drop, never a
            # split-brain commit
            exp = time.monotonic() + self.result_ttl
            for wid, _, gids, *_ in wave:
                self._write_results[wid] = {
                    "status": "ABORTED_FAILOVER",
                    "reason": "primary deposed before wave close",
                    "gids": [-1] * len(gids), "ts": -1,
                    "retry_after_ms": self._wwave_ms}
                self._write_exp[wid] = exp
            self.stats["write_fenced"] = (
                self.stats.get("write_fenced", 0) + len(wave))
            return len(wave)
        t0 = time.monotonic()
        res = self.db.write([t for _, t, *_ in wave])
        # the worst-moment crash: the wave COMMITTED (it is in the store
        # and the wave log) but this primary dies before a single result
        # is stored or acked — failover must surface those commits via
        # rid-idempotent replay, exactly once
        faults_mod.check(self.db, "primary.crash.midwave")
        wall = (time.monotonic() - t0) * 1e3
        if self._wwave_seeded:
            self._wwave_ms = 0.7 * self._wwave_ms + 0.3 * wall
        else:
            self._wwave_ms = wall
            self._wwave_seeded = True
        exp = time.monotonic() + self.result_ttl
        for i, (wid, _, gids, *_) in enumerate(wave):
            ok = res.statuses[i] == "COMMITTED"
            self._write_results[wid] = {
                "status": res.statuses[i], "reason": res.reasons[i],
                "gids": gids if ok else [-1] * len(gids),
                "ts": res.ts if ok else -1}
            self._write_exp[wid] = exp
            if not ok:
                self.stats["write_aborts"] += 1
        self.stats["write_waves"] += 1
        self.stats["write_txns"] += len(wave)
        return len(wave)

    # ------------------------------------------------------------------
    def enqueue_maintenance(self) -> None:
        self.tasks.enqueue(compaction_task())
        self.tasks.enqueue(index_compaction_task())
        self.tasks.enqueue(vacuum_task())
        if self.db.replication_log is not None:
            from repro_torch.core.replication import sweeper_task
            self.tasks.enqueue(sweeper_task(self.db.replication_log))

    def latency_report(self) -> dict:
        out = {}
        for k, xs in self.latencies.items():
            a = np.asarray(xs) * 1e3
            out[k] = {"avg_ms": float(a.mean()),
                      "p99_ms": float(np.percentile(a, 99)),
                      "n": len(a)}
        return out
