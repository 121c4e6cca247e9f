"""Record the JAX package's write path for ``tests/test_torch_writes.py``.

    PYTHONPATH=src python tests/fixtures/torch_writes/make_fixture.py

Runs the seeded op script ``tests/torch_write_script.py`` through
``repro.core.graphdb.GraphDB.write``, replays the resulting wave records onto
a fresh JAX database (a replica), and builds the film KG of
``torch_write_script.KG_SIZES`` with ``repro.data.kg.build_film_kg`` at
``KG_CFG``.  Writes, beside this script:

* ``writes.npz`` (compressed): every ``GraphStore`` field of the three
  stores, under ``script/``, ``replica/`` and ``kg/``;
* ``writes.json``: the script's events, the three databases' host mirrors,
  the script's wave records and the SHA-256 of the script that made them.

The JAX write path compiles a program per op-shape bucket, so this takes a
minute or two; the tier-1 tests only read its output.
"""
import dataclasses
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, TESTS)

import torch_write_script as script  # noqa: E402
from repro.core import writes  # noqa: E402
from repro.core.addressing import StoreConfig  # noqa: E402
from repro.core.graphdb import GraphDB  # noqa: E402
from repro.core.txn import BatchCaps  # noqa: E402
from repro.data.kg import build_film_kg  # noqa: E402


def script_sha() -> str:
    with open(os.path.join(TESTS, "torch_write_script.py"), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def fresh_db() -> GraphDB:
    db = GraphDB(StoreConfig(**script.CFG), caps=BatchCaps(**script.CAPS))
    script.schema(db)
    return db


def arrays(db, prefix: str) -> dict:
    return {f"{prefix}/{f.name}": np.asarray(getattr(db.store, f.name))
            for f in dataclasses.fields(db.store)}


def main() -> None:
    db = fresh_db()
    events = script.run(db, writes)
    records = list(db.wave_log)
    replica = fresh_db()
    for rec in records:
        writes.replay_wave(replica, rec)
    kg = build_film_kg(**script.KG_SIZES, cfg=StoreConfig(**script.KG_CFG))
    out = {}
    for prefix, d in (("script", db), ("replica", replica), ("kg", kg.db)):
        out.update(arrays(d, prefix))
    np.savez_compressed(os.path.join(HERE, "writes.npz"), **out)
    meta = dict(script_sha256=script_sha(), events=events, records=records,
                mirrors={"script": script.mirrors(db),
                         "replica": script.mirrors(replica),
                         "kg": script.mirrors(kg.db)})
    with open(os.path.join(HERE, "writes.json"), "w") as f:
        json.dump(meta, f, separators=(",", ":"))


if __name__ == "__main__":
    main()
