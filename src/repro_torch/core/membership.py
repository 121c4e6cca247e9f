"""Lease-based membership + configuration epochs (§2, FaRM §3).

Port of ``repro/core/membership.py``, kept line for line: pure Python, with
its own copy in the port as ``faults.py`` has, so that the same clock reads,
fault visits and elections happen in the same order in both packages.

A1 inherits FaRM's failure model: every machine holds a *lease* with the
configuration manager; a machine that misses its lease renewal is
suspected, then evicted, and every eviction/election advances a
monotonically increasing **configuration epoch**.  The epoch is the
fencing token: a message stamped with an old epoch is bounced
(``STALE_EPOCH``) and a deposed primary can never get a commit past a
fleet that has moved on.  Here the frontend (the SLB of
:mod:`repro_torch.launch.cluster`) plays the CM role: it owns the
:class:`Membership` table, renews leases by heartbeating its workers,
and completes failover when the elected write-primary changes.

State machine per member::

    alive --(lease expires)--> suspect --(grace expires)--> evicted
      ^           |
      +--(renewal)+          evicted is terminal until ``readmit``

Election picks the most caught-up routable member (max replicated
``applied_seq``; ties break to the lowest cid, deterministic, so every
observer agrees).  Every configuration change (evict / elect / readmit)
bumps the epoch.

The clock is injectable: chaos tests drive lease expiry deterministically
by advancing a fake clock instead of sleeping through real lease windows.

Fault sites (``core/faults.py``): ``membership.heartbeat.drop``,
consulted per renewal, ``race`` loses that renewal (the heartbeat frame
never arrived); ``membership.lease.expire``, consulted once per
``tick``, ``race`` force-expires the current primary's lease (the
primary-partition schedule that must end in a clean failover).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.core import faults as faults_mod


@dataclasses.dataclass
class Lease:
    member: int
    expires: float
    state: str = "alive"            # 'alive' | 'suspect' | 'evicted'


class Membership:
    """The CM-side membership table: leases, epochs, one write-primary."""

    def __init__(self, members, *, lease_s: float = 2.0,
                 grace_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 owner=None):
        members = sorted(int(m) for m in members)
        if not members:
            raise ValueError("membership needs at least one member")
        self.lease_s = float(lease_s)
        self.grace_s = float(lease_s if grace_s is None else grace_s)
        self.clock = clock
        self._owner = owner                       # carries .faults (chaos)
        self.epoch = 1
        self.primary: Optional[int] = members[0]
        now = clock()
        self.members: dict[int, Lease] = {
            m: Lease(m, now + self.lease_s) for m in members}
        self.applied: dict[int, int] = {m: 0 for m in members}
        self.events: list[dict] = []              # full config-change history

    # -- renewals -------------------------------------------------------
    def heartbeat(self, cid: int, *, applied_seq: Optional[int] = None
                  ) -> bool:
        """Renew ``cid``'s lease; returns False when the renewal is lost
        (evicted member, or an injected ``membership.heartbeat.drop``)."""
        m = self.members.get(int(cid))
        if m is None or m.state == "evicted":
            return False
        if faults_mod.check(self._owner, "membership.heartbeat.drop"):
            return False                          # renewal frame lost
        m.expires = self.clock() + self.lease_s
        if m.state == "suspect":
            m.state = "alive"                     # recovered before eviction
        if applied_seq is not None:
            self.applied[int(cid)] = max(self.applied.get(int(cid), 0),
                                         int(applied_seq))
        return True

    def suspect(self, cid: int) -> None:
        """External suspicion signal (e.g. a transport recv timeout): the
        member stops being routable now and its lease stops renewing —
        eviction follows at ``tick`` unless a heartbeat lands first."""
        m = self.members.get(int(cid))
        if m is not None and m.state == "alive":
            m.state = "suspect"
            m.expires = min(m.expires, self.clock())

    # -- the lease clock ------------------------------------------------
    def tick(self) -> list[dict]:
        """Advance the lease state machine; returns config-change events
        (``{"type": "suspect"|"evict"|"elect", ...}``) in order."""
        now = self.clock()
        events: list[dict] = []
        forced = faults_mod.check(self._owner, "membership.lease.expire")
        if forced and self.primary is not None:
            m = self.members[self.primary]
            if m.state != "evicted":              # straight through suspect
                m.expires = now - self.grace_s - 1.0
        for cid in sorted(self.members):
            m = self.members[cid]
            if m.state == "alive" and now >= m.expires:
                m.state = "suspect"
                events.append({"type": "suspect", "member": cid,
                               "epoch": self.epoch})
            if m.state == "suspect" and now >= m.expires + self.grace_s:
                events += self._evict(cid, reason="lease-expired")
        self.events += events
        return events

    # -- configuration changes ------------------------------------------
    def evict(self, cid: int, *, reason: str = "crash") -> list[dict]:
        """Evict ``cid`` immediately (detected crash).  Idempotent."""
        events = self._evict(int(cid), reason=reason)
        self.events += events
        return events

    def _evict(self, cid: int, *, reason: str) -> list[dict]:
        m = self.members.get(cid)
        if m is None or m.state == "evicted":
            return []
        m.state = "evicted"
        self.epoch += 1                           # every config change fences
        events = [{"type": "evict", "member": cid, "reason": reason,
                   "epoch": self.epoch}]
        if cid == self.primary:
            self.primary = self._elect()
            events.append({"type": "elect", "primary": self.primary,
                           "epoch": self.epoch})
        return events

    def _elect(self) -> Optional[int]:
        """Most caught-up non-evicted member (max applied_seq, tie ->
        lowest cid); None when the fleet is empty."""
        cands = [c for c, m in self.members.items() if m.state != "evicted"]
        if not cands:
            return None
        return min(cands, key=lambda c: (-self.applied.get(c, 0), c))

    def readmit(self, cid: int) -> list[dict]:
        """Re-admit an evicted member (operator action after a restart).
        It re-enters as a replica at the *current* epoch — it can never
        resume a primaryship it lost."""
        m = self.members.get(int(cid))
        if m is None or m.state != "evicted":
            return []
        m.state = "alive"
        m.expires = self.clock() + self.lease_s
        self.epoch += 1
        ev = [{"type": "readmit", "member": int(cid), "epoch": self.epoch}]
        self.events += ev
        return ev

    # -- queries --------------------------------------------------------
    def is_primary(self, cid: int, epoch: Optional[int] = None) -> bool:
        """The commit-time fence: is ``cid`` THE primary (at ``epoch``)?"""
        return (self.primary == int(cid)
                and (epoch is None or int(epoch) == self.epoch))

    def routable(self) -> list[int]:
        """Members requests may be routed to (alive, lease current)."""
        return [c for c, m in sorted(self.members.items())
                if m.state == "alive"]

    def admitted(self) -> list[int]:
        """Members still in the configuration (not evicted)."""
        return [c for c, m in sorted(self.members.items())
                if m.state != "evicted"]

    def view(self) -> dict:
        """The /stats projection: epoch, primary, per-member lease state."""
        now = self.clock()
        return {
            "epoch": self.epoch,
            "primary": self.primary,
            "leases": {
                c: {"state": m.state,
                    "remaining_s": round(max(0.0, m.expires - now), 3),
                    "applied_seq": self.applied.get(c, 0)}
                for c, m in sorted(self.members.items())},
        }
