"""Record the JAX package's maintenance and durability paths for the port's
tests (``tests/test_torch_tasks.py``, ``test_torch_bg_compaction.py`` and
``test_torch_durability.py``).

    PYTHONPATH=src python tests/fixtures/torch_durability/make_fixture.py

Runs every case of ``tests/torch_durability_script.py`` through the JAX
package and writes, beside this script:

* ``durability.json``: each case's recorded steps (store-field digests,
  host mirrors, stats, epochs, task queues, pinned reads, ObjectStore
  tables and metas, watermarks) and the SHA-256 of the script;
* ``durability.npz`` (compressed): every field of the stores the cases
  keep (the recovered stores), under ``<case>/<store>/<field>``.

The JAX write path compiles a program per op-shape bucket, so this takes a
few minutes; the tier-1 tests only read its output.
"""
import hashlib
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, TESTS)

import torch_durability_script as script  # noqa: E402
from repro.core import faults, recovery, replication, tasks, writes  # noqa: E402
from repro.core.addressing import StoreConfig  # noqa: E402
from repro.core.graphdb import GraphDB  # noqa: E402
from repro.core.query.executor import QueryCaps  # noqa: E402


def script_sha() -> str:
    with open(os.path.join(TESTS, "torch_durability_script.py"), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def namespace():
    return script.namespace(
        GraphDB=GraphDB, StoreConfig=StoreConfig, QueryCaps=QueryCaps,
        w=writes, tasks=tasks, faults=faults, replication=replication,
        best_effort_recover=recovery.best_effort_recover,
        consistent_recover=recovery.consistent_recover,
        FastRestartCache=recovery.FastRestartCache,
        restart=lambda cache, name: cache.restart(name),
        attach_shared=recovery.attach_shared,
        np_of=np.asarray)


def main() -> None:
    m = namespace()
    cases, arrays = {}, {}
    for name in script.CASES:
        with tempfile.TemporaryDirectory() as tmp:
            rec = script.run(m, name, tmp)
        cases[name] = rec.json()
        for store, fields in rec.stores.items():
            for f, a in fields.items():
                arrays[f"{name}/{store}/{f}"] = a
        print(name, len(rec.steps), "steps", flush=True)
    np.savez_compressed(os.path.join(HERE, "durability.npz"), **arrays)
    with open(os.path.join(HERE, "durability.json"), "w") as f:
        json.dump(dict(script_sha256=script_sha(), cases=cases), f,
                  separators=(",", ":"))


if __name__ == "__main__":
    main()
