"""PyTorch port, leases, epochs and fleet-visible writes under crashes
against the JAX package: the schedules of ``tests/test_chaos_failover.py``
(a killed primary keeps its acked commit, a mid-wave crash commits exactly
once, a deposed zombie is fenced, lease expiry on a fake clock, a forced
primary expiry with the stale-epoch fence) and its hypothesis sweep as
the fixed seeds of ``torch_fleet_script.FAILOVER_SWEEP``; and the port's
``Membership`` against the JAX package's, imported live.

Each fleet case runs through the port under the fake clock of
``tests/torch_serve_script.py`` and must equal the committed JAX fixture
step by step (see ``test_torch_cluster.py``): every ``write_result``, the
membership views and events, roles, the fault sequence and
``cluster_stats()``.
"""
import numpy as np
import pytest

import torch_fleet_script as script
from repro.core import faults as jax_faults
from repro.core import membership as jax_membership
from repro_torch.core import faults, membership
from test_torch_cluster import assert_case_matches_jax, jax_cases
from test_torch_store_index_edges import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", script.FAILOVER_CASES)
def test_case_matches_jax(name):
    assert_case_matches_jax(name)


def test_sweep_seeds_exercise_the_faults():
    """Together the fixed seeds commit, crash a primary mid-wave, kill a
    worker and lose heartbeats."""
    c = jax_cases()["cases"]
    acts, sites = set(), set()
    for i in range(len(script.FAILOVER_SWEEP)):
        step = c[f"any_schedule_failover_invariants_{i}"]["steps"][0]
        acts |= set(step["actions"])
        sites |= {f[0] for f in step["fired"]}
        assert step["count"] == step["base"] + [
            o["status"] for o in step["outcomes"]].count("COMMITTED")
    assert acts == {0, 1, 2, 3}
    assert {"primary.crash.midwave", "membership.heartbeat.drop"} <= sites


def _drive(mod, fmod, seed):
    """A seeded schedule of renewals, suspicions, ticks, evictions and
    readmissions on one package's ``Membership`` over a fake clock, with
    both membership sites armed; returns every observable."""
    rng = np.random.default_rng(seed)
    t = {"now": 0.0}

    class Owner:
        faults = (fmod.FaultInjector(seed)
                  .inject("membership.heartbeat.drop", action="race",
                          prob=0.2)
                  .inject("membership.lease.expire", action="race",
                          prob=0.05))
    ms = mod.Membership(range(5), lease_s=2.0, grace_s=1.0,
                        clock=lambda: t["now"], owner=Owner)
    out = []
    for _ in range(200):
        op = int(rng.integers(0, 6))
        cid = int(rng.integers(0, 6))        # 5 is no member
        if op == 0:
            out.append(("hb", ms.heartbeat(cid, applied_seq=int(
                rng.integers(0, 9)))))
        elif op == 1:
            ms.suspect(cid)
        elif op == 2:
            t["now"] += float(rng.uniform(0, 1.5))
            out.append(("tick", ms.tick()))
        elif op == 3 and rng.random() < 0.2:
            out.append(("evict", ms.evict(cid, reason="crash")))
        elif op == 4:
            out.append(("readmit", ms.readmit(cid)))
        out.append((ms.epoch, ms.primary, ms.routable(), ms.admitted(),
                    ms.is_primary(cid, ms.epoch), ms.view()))
    return out, ms.events, [list(f) for f in Owner.faults.fired]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_membership_equals_jax(seed):
    got = _drive(membership, faults, seed)
    want = _drive(jax_membership, jax_faults, seed)
    assert got == want
    assert any(e["type"] == "elect" for e in got[1])
    assert got[2]                            # the sites fired


def test_membership_needs_a_member():
    with pytest.raises(ValueError, match="at least one member"):
        membership.Membership([])
