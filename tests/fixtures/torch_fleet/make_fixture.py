"""Record the JAX package's fleet for the port's tests
(``tests/test_torch_cluster.py``, ``test_torch_chaos_cluster.py``,
``test_torch_chaos_failover.py`` and ``test_torch_transport.py``).

    PYTHONPATH=src python tests/fixtures/torch_fleet/make_fixture.py

Runs every case of ``tests/torch_fleet_script.py`` but the port-only
process-mode one through the JAX package and writes ``fleet.json`` beside
this script: each case's recorded steps and the SHA-256 of the script and
of ``tests/torch_serve_script.py``, whose stores and clock it uses.  Each
case builds its stores through the JAX write path and compiles its query
programs afresh (the script empties the planner's program cache), so this
takes several minutes; the tier-1 tests only read its output.
``make_fixture.py NAME ...`` runs the named cases without writing.
"""
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, TESTS)

import torch_fleet_script as script  # noqa: E402
from repro.core import faults, membership, writes  # noqa: E402
from repro.core.addressing import StoreConfig  # noqa: E402
from repro.core.graphdb import GraphDB  # noqa: E402
from repro.core.query import planner  # noqa: E402
from repro.core.query.executor import QueryCaps  # noqa: E402
from repro.launch import cluster, serve, transport  # noqa: E402


def script_sha(name: str) -> str:
    with open(os.path.join(TESTS, name), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def namespace():
    return script.namespace(
        GraphDB=GraphDB, StoreConfig=StoreConfig, QueryCaps=QueryCaps,
        Frontend=cluster.A1Frontend, w=writes, faults=faults, serve=serve,
        cluster=cluster, transport=transport, membership=membership,
        planner=planner, np_of=np.asarray, make=lambda key, build: build())


def main(names=None) -> None:
    m = namespace()
    cases = {}
    for name in names or script.FIXTURE_CASES:
        cases[name] = script.run(m, name).json()
        print(name, len(cases[name]["steps"]), "steps", flush=True)
    if names:
        return
    with open(os.path.join(HERE, "fleet.json"), "w") as f:
        json.dump(dict(script_sha256=script_sha("torch_fleet_script.py"),
                       serve_script_sha256=script_sha(
                           "torch_serve_script.py"),
                       cases=cases), f, separators=(",", ":"))


if __name__ == "__main__":
    main(sys.argv[1:])
