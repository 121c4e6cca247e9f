"""Record the JAX package's serving tier for the port's tests
(``tests/test_torch_serve.py``, ``test_torch_serve_admission.py`` and
``test_torch_chaos_serve.py``).

    PYTHONPATH=src python tests/fixtures/torch_serve/make_fixture.py

Runs every case of ``tests/torch_serve_script.py`` through the JAX
package and writes ``serve.json`` beside this script: each case's recorded
steps and the SHA-256 of the script.  Each case builds its stores through
the JAX write path and compiles its query programs afresh (the script
empties the planner's program cache), so this takes several minutes; the
tier-1 tests only read its output.
"""
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, TESTS)

import torch_serve_script as script  # noqa: E402
from repro.core import faults, writes  # noqa: E402
from repro.core.addressing import StoreConfig  # noqa: E402
from repro.core.graphdb import GraphDB  # noqa: E402
from repro.core.query import planner, planner_shared  # noqa: E402
from repro.core.query.a1ql import ParseError  # noqa: E402
from repro.core.query.executor import QueryCaps  # noqa: E402
from repro.launch import serve  # noqa: E402


def script_sha() -> str:
    with open(os.path.join(TESTS, "torch_serve_script.py"), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def namespace():
    return script.namespace(
        GraphDB=GraphDB, StoreConfig=StoreConfig, QueryCaps=QueryCaps,
        w=writes, faults=faults, serve=serve, planner=planner,
        planner_shared=planner_shared, ParseError=ParseError,
        np_of=np.asarray, make=lambda key, build: build())


def main(names=None) -> None:
    m = namespace()
    cases = {}
    for name in names or script.CASES:
        cases[name] = script.run(m, name).json()
        print(name, len(cases[name]["steps"]), "steps", flush=True)
    if names:
        return
    with open(os.path.join(HERE, "serve.json"), "w") as f:
        json.dump(dict(script_sha256=script_sha(), cases=cases), f,
                  separators=(",", ":"))


if __name__ == "__main__":
    main(sys.argv[1:])
