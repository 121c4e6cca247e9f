"""PyTorch port, the A1 fleet (``repro_torch/launch/cluster.py``'s
``A1Frontend`` over ``Coordinator`` workers on one shared store) against
the JAX package: the inproc cases of ``tests/test_cluster.py`` (the shared
store, least-loaded routing, owner-routed continuations, the front door's
exhausted budgets, the mixed read / write / ``Nearest`` traffic over four
coordinators, the wire dispatch).

The JAX side of the seeded cases is a committed fixture
(``tests/fixtures/torch_fleet``, made by its ``make_fixture.py`` from
``tests/torch_fleet_script.py``; the tests compile no JAX program).  Each
case runs through the port under the same fake clock and id counter, and
every recorded step must be equal to JAX's: each result with the
coordinator it was routed to, each ``write_result``, and
``cluster_stats()`` with its membership view, replication state and every
worker's ``stats``.  This file also holds the helpers the other fleet
files import, and the device contract of ``A1Frontend``.
"""
import functools
import hashlib
import json
from pathlib import Path

import pytest
import torch

import torch_fleet_script as script
import torch_serve_script as serve_script
from repro_torch.core import faults, membership, writes
from repro_torch.core.addressing import StoreConfig
from repro_torch.core.graphdb import GraphDB
from repro_torch.core.query import planner
from repro_torch.core.query.executor import QueryCaps
from repro_torch.launch import cluster, serve, transport
from test_torch_serve import _diff, _make
from test_torch_store_index_edges import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_fleet"
INPROC_CASES = tuple(n for n in script.CLUSTER_CASES
                     if n not in script.REAL_TIME
                     and not n.startswith(("frame_", "write_op_")))


def port_namespace():
    return script.namespace(
        GraphDB=functools.partial(GraphDB, device="cpu"),
        StoreConfig=StoreConfig, QueryCaps=QueryCaps,
        Frontend=functools.partial(cluster.A1Frontend, device="cpu"),
        w=writes, faults=faults, serve=serve, cluster=cluster,
        transport=transport, membership=membership, planner=planner,
        np_of=lambda t: t.numpy(), make=_make)


@functools.lru_cache(maxsize=None)
def jax_cases() -> dict:
    with open(FIXTURE / "fleet.json") as f:
        return json.load(f)


def assert_case_matches_jax(name):
    got = script.run(port_namespace(), name).json()
    want = jax_cases()["cases"][name]
    assert [s["label"] for s in got["steps"]] == [
        s["label"] for s in want["steps"]]
    d = _diff(got, want)
    assert not d, f"{name}: {d}"


def _sha(name: str) -> str:
    return hashlib.sha256((Path(__file__).parent / name).read_bytes()
                          ).hexdigest()


def test_fixture_is_of_these_scripts():
    assert jax_cases()["script_sha256"] == _sha("torch_fleet_script.py")
    assert jax_cases()["serve_script_sha256"] == _sha(
        "torch_serve_script.py")
    assert set(jax_cases()["cases"]) == set(script.FIXTURE_CASES)


@pytest.mark.parametrize("name", INPROC_CASES)
def test_case_matches_jax(name):
    assert_case_matches_jax(name)


def test_routing_spreads_in_the_fixture_too():
    """The recorded JAX run routed the 8 reads over at least two
    coordinators (a fleet that pinned one worker would still pass the
    step comparison if the port pinned the same one)."""
    step = jax_cases()["cases"][
        "routed_queries_match_oracle_and_spread"]["steps"][0]
    assert len({r["cid"] for r in step["rows"]}) >= 2
    assert sum(step["admitted"]) == 8


# ---------------------------------------------------------------------------
# the device contract
# ---------------------------------------------------------------------------

def test_frontend_defaults_to_cuda_and_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    db = serve_script.busy_db(port_namespace())
    with pytest.raises(RuntimeError, match="device='cuda'"):
        cluster.A1Frontend(db, 2)


def test_inproc_fleet_runs_on_the_frontends_device():
    """The held slot restarts onto the frontend's device, every
    coordinator wraps that one database, and it holds tensors of its own
    (a fleet write never reaches the caller's database)."""
    m = port_namespace()
    db = serve_script.busy_db(m)
    before = serve_script.digest(m, db)
    with cluster.A1Frontend(db, 3, device="cpu", write_batch=1) as fe:
        assert fe.device == torch.device("cpu")
        assert fe.db is not db and fe.db.device.type == "cpu"
        assert {id(w.coord.server.db) for w in fe.workers.values()} \
            == {id(fe.db)}
        r = script.do_write(fe, [writes.CreateVertex("actor", 9001)])
        assert r["status"] == "COMMITTED"
        assert fe.db.get_vertex("actor", 9001) is not None
    assert db.get_vertex("actor", 9001) is None
    assert serve_script.digest(m, db) == before
