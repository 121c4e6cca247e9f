"""PyTorch port, the fleet under crashes, dropped frames and stale routes
against the JAX package: the schedules of ``tests/test_chaos_cluster.py``
(a takeover mid-pagination, in-flight queries rescued from a dead
coordinator, the ``cluster.worker.crash`` site, a dropped request and a
dropped response frame, a stale-route storm) and its hypothesis sweep as
the fixed draws of ``torch_fleet_script.CLUSTER_SWEEP``.

Each case runs through the port under the fake clock of
``tests/torch_serve_script.py`` and must equal the committed JAX fixture
step by step (see ``test_torch_cluster.py``): the no-fault stream, the
stream under faults (bit-identical to it), the fault sequence fired, each
result with its routed coordinator, and ``cluster_stats()``.
"""
import pytest

import torch_fleet_script as script
from test_torch_cluster import assert_case_matches_jax, jax_cases
from test_torch_store_index_edges import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", script.CHAOS_CLUSTER_CASES)
def test_case_matches_jax(name):
    assert_case_matches_jax(name)


def test_sweep_draws_exercise_the_faults():
    """The fixed draws stand for the hypothesis sweep only if they fire:
    together they drop frames, route stale and crash an owner, and every
    faulted stream equals the clean one."""
    c = jax_cases()["cases"]
    fired = set()
    for i in range(len(script.CLUSTER_SWEEP)):
        clean, swept = c[f"any_schedule_pagination_converges_{i}"]["steps"]
        assert swept["stream"] == clean["stream"]
        fired |= {f[0] for f in swept["fired"]}
        fired |= {"kill"} if swept["cluster"]["frontend"]["worker_kills"] \
            else set()
    assert fired == {"transport.drop", "cluster.route.stale", "kill"}
