"""Deterministic fault injection for the chaos checks.

Port of ``repro/core/faults.py`` (pure numpy, kept line for line so that
the same seed, sites and schedule fire at the same visits with the same
actions in both packages).  A :class:`FaultInjector` is attached to a
``GraphDB`` (``db.faults``) and the layers consult it at **named sites**;
with no injector attached every site is a no-op.

Sites wired in the port:

================================  =========================================
``engine.wave``                   start of ``GraphDB.query``: a wave
                                  execution exception (``raise``) or a
                                  slow-wave straggler (``stall``)
``serve.wave.stall``              serve dispatch, before the base run
``serve.continuation.stale``      serve sweep: ``race`` force-expires all
                                  continuation tokens (stale-token storm)
``tasks.quantum``                 task-queue pump: a low-priority worker
                                  crash mid-quantum
``tasks.compaction.handoff``      background compaction, before
                                  ``try_handoff``: ``race`` simulates a
                                  concurrent structural mutation so the
                                  shadow must rebuild
``cluster.worker.crash``          cluster frontend, before routing a
                                  request to its coordinator: ``race``
                                  kills the target worker first (the
                                  mid-pagination crash the takeover
                                  contract must survive)
``cluster.route.stale``           cluster frontend, on continuation
                                  routing: ``race`` routes the token to a
                                  *wrong* coordinator (stale SLB view); the
                                  receiver must bounce it back by ownership
                                  stamp, never answer from the wrong state
``transport.drop``                transport channel, per frame: ``race``
                                  drops the frame; clients must retransmit
                                  and result polling must stay idempotent
``membership.heartbeat.drop``     membership renewal: ``race`` loses that
                                  heartbeat (the frame never arrived); the
                                  lease keeps aging toward suspect/evict
``membership.lease.expire``       membership ``tick``: ``race``
                                  force-expires the current primary's lease
                                  (straight to evict) so failover runs
                                  without waiting out real time
``replication.ship.drop``         replication sweep / the frontend's wave
                                  fan-out: ``race`` drops the whole ship
                                  round; lag grows, watermarks must NOT
                                  advance, and acked commits stay acked
``primary.crash.midwave``         serve ``_close_write_wave``, after the
                                  commit but before results are stored:
                                  ``raise`` kills the primary at the worst
                                  moment; failover must answer the
                                  committed-but-unacked txns exactly once
================================  =========================================

Firing is seeded: a site fires on an explicit schedule of visit indices
(``times=``) and/or with probability ``prob`` drawn from a per-``(seed,
crc32(site))`` ``numpy`` generator, so replaying a schedule against the
same workload reproduces the same fault sequence.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Optional

import numpy as np


class InjectedFault(RuntimeError):
    """Raised by a ``raise``-action site; carries the site for attribution."""

    def __init__(self, site: str, visit: int):
        super().__init__(f"injected fault at {site} (visit {visit})")
        self.site = site
        self.visit = visit


@dataclasses.dataclass
class FaultSpec:
    """One armed site.  ``action`` is ``raise`` | ``stall`` | ``race``."""
    site: str
    action: str = "raise"
    prob: float = 0.0                  # per-visit firing probability
    times: tuple = ()                  # explicit 0-based visit indices
    stall_s: float = 0.0               # sleep length for ``stall``
    max_fires: Optional[int] = None    # total-fire cap (None = unbounded)
    fires: int = 0


class FaultInjector:
    """Named-site fault oracle, deterministic under a fixed seed."""

    ACTIONS = ("raise", "stall", "race")

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._specs: dict[str, list[FaultSpec]] = {}
        self._visits: dict[str, int] = {}
        self._rng: dict[str, np.random.Generator] = {}
        self.fired: list[tuple[str, int, str]] = []   # (site, visit, action)

    def inject(self, site: str, *, action: str = "raise", prob: float = 0.0,
               times=(), stall_s: float = 0.0,
               max_fires: Optional[int] = None) -> "FaultInjector":
        """Arm ``site``; chainable.  ``times`` and ``prob`` compose (OR)."""
        if action not in self.ACTIONS:
            raise ValueError(f"unknown fault action {action!r}")
        spec = FaultSpec(site=site, action=action, prob=float(prob),
                         times=tuple(int(t) for t in times),
                         stall_s=float(stall_s), max_fires=max_fires)
        self._specs.setdefault(site, []).append(spec)
        return self

    def _site_rng(self, site: str) -> np.random.Generator:
        rng = self._rng.get(site)
        if rng is None:
            # stable across processes (hash() is salted; crc32 is not)
            rng = np.random.default_rng([self.seed,
                                         zlib.crc32(site.encode())])
            self._rng[site] = rng
        return rng

    def check(self, site: str) -> bool:
        """Consult ``site``; called once per visit by the instrumented code.

        ``raise`` fires by raising :class:`InjectedFault`; ``stall`` sleeps
        ``stall_s`` and returns ``False``; ``race`` returns ``True``: the
        caller interprets it (e.g. "a concurrent mutation happened")."""
        visit = self._visits.get(site, 0)
        self._visits[site] = visit + 1
        raced = False
        for spec in self._specs.get(site, ()):
            if spec.max_fires is not None and spec.fires >= spec.max_fires:
                continue
            fire = visit in spec.times
            if not fire and spec.prob > 0.0:
                # always draw so the stream stays aligned with the visit
                fire = bool(self._site_rng(site).random() < spec.prob)
            if not fire:
                continue
            spec.fires += 1
            self.fired.append((site, visit, spec.action))
            if spec.action == "raise":
                raise InjectedFault(site, visit)
            if spec.action == "stall":
                time.sleep(spec.stall_s)
            else:                                   # "race"
                raced = True
        return raced

    def visits(self, site: str) -> int:
        return self._visits.get(site, 0)


def check(owner, site: str) -> bool:
    """Site hook: consult ``owner.faults`` when armed, else no-op.

    ``owner`` is whatever object carries the injector (a ``GraphDB``, or a
    replication log without one).  Instrumented code calls this
    unconditionally; production pays one ``getattr`` per site visit."""
    inj = getattr(owner, "faults", None)
    if inj is None:
        return False
    return inj.check(site)
