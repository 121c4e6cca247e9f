"""PyTorch port, the serving tier's read admission against the JAX
package: wave closing at max-batch or deadline, shedding with retry-after
hints, tenant caps, rejected documents, refills past tenant caps, the
wave-time EWMA, ``Nearest`` documents through admission, the circuit
breaker, ``budget="auto"`` at the knee, shared-overflow hedging, result
sweeping, SLO budgets and the engine deadline (the cases of
``tests/test_serve_admission.py``).

Each case runs through the port under the fake clock of
``tests/torch_serve_script.py`` and must equal the committed JAX fixture
step by step (see ``test_torch_serve.py``).
"""
import pytest

import torch_serve_script as script
from test_torch_serve import assert_case_matches_jax, jax_cases
from test_torch_store_index_edges import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", script.ADMISSION_CASES)
def test_case_matches_jax(name):
    assert_case_matches_jax(name)


def test_cases_show_what_they_are_for():
    """The fixture's own values: the shed quote folds the write backlog,
    the breaker opens, skips, probes and closes, and the queue-exhausted
    request never took a wave slot."""
    c = jax_cases()["cases"]
    q = c["retry_after_folds_queued_write_backlog"]["steps"][0]
    assert q["quoted"] == pytest.approx(q["base"] + 7.5, abs=1e-3)
    br = {s["label"]: s for s in
          c["breaker_opens_under_sustained_overflow_then_recovers"]["steps"]}
    assert br["opened"]["breakers"] == {"hot": "open"}
    assert br["skipped"]["stats"]["breaker_skips"] == 2
    assert br["closed"]["breakers"] == {"hot": "closed", "cool": "closed"}
    ex = c["queue_exhausted_budget_truncates_at_wave_close"]["steps"][0]
    assert ex["small"]["budget_exhausted"] and ex["stats"]["served"] == 1
    assert sum(ex["stats"]["budget_spend_ms"]["queue"]) == 2
