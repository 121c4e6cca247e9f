"""PyTorch port, the serving tier under injected faults against the JAX
package: the schedules of ``tests/test_chaos_serve.py`` (control, a wave
crash retried, a crash storm aborted with attribution, stalls, a
stale-continuation storm, raced compaction handoffs with a crashed
worker, deterministic replay, and its hypothesis sweep as a fixed list of
seeds and schedules), and the three serving fault sites at their visits.

Each case runs through the port under the fake clock of
``tests/torch_serve_script.py`` and must equal the committed JAX fixture
step by step (see ``test_torch_serve.py``): every read and write result,
the fault sequence fired, the store's digest, its stats and epochs, the
tasks completed, and the reference batch re-read at its pinned snapshot.
"""
import pytest

import torch_serve_script as script
from test_torch_serve import (assert_case_matches_jax, jax_cases,
                              port_namespace)
from test_torch_store_index_edges import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", script.CHAOS_CASES)
def test_case_matches_jax(name):
    assert_case_matches_jax(name)


def test_serving_sites_fire_at_their_jax_visits():
    """The stale storm at the second sweep (the top of the second
    ``execute``), ``serve.wave.stall`` at that batch's dispatch,
    ``primary.crash.midwave`` at the second write wave, after it
    committed: the port's fire list is JAX's."""
    rec = script.run(port_namespace(), "serving_fault_sites")
    got = rec.steps[0]
    want = jax_cases()["cases"]["serving_fault_sites"]["steps"][0]
    assert got["fired"] == want["fired"] == [
        ["serve.continuation.stale", 1, "race"],
        ["serve.wave.stall", 1, "stall"],
        ["primary.crash.midwave", 1, "raise"]]
    assert got["crashed"] == ["primary.crash.midwave", 1]
    assert got["applied"] == want["applied"]


def test_chaos_cases_show_what_they_are_for():
    c = jax_cases()["cases"]
    storm = c["wave_crash_storm_aborts_with_attribution"]["steps"][0]
    assert [r["status"] for r in storm["rows"]].count("ABORTED") == 5
    race = c["compaction_handoff_race_rebuilds_and_crashed_worker_"
             "restarts"]["steps"][0]
    assert race["db_stats"]["compaction_rebuilds"] >= 1
    assert race["fault_restarts"] >= 1
    a, b = c["fault_schedules_replay_deterministically"]["steps"]
    assert a["fired"] == b["fired"] and a["fired"]
