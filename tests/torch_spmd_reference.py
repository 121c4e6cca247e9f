"""The JAX package's ``GraphDB.query(mesh=...)`` results that
``tests/test_torch_spmd.py`` holds the PyTorch port to.

    python tests/torch_spmd_reference.py OUT.npz [CASE ...]

It runs in a process of its own, because the forced host-device count must
be set before JAX first starts: four CPU devices as a ``(2, 2)`` mesh over
``("data", "model")``, so the store's shards are laid out row-major over two
axes.  Every case of :func:`cases` (or the ones named) runs once on the
reference backend, and each result field is saved as ``<case>/<field>``.
"""
import os
import sys

import numpy as np

# (name, store, queries, caps, keyword arguments of GraphDB.query); stores
# are test_torch_store_index_edges.jax_db's tiers and test_torch_vector's
# doc store ("docs")


def cases():
    from test_backend_parity import q_chain, q_star
    from test_torch_query import CAPS, MIXED, q_films
    from test_torch_vector import BATCH, CAPS as VCAPS, TS as VTS
    ts = [12, 1, 9, 10, 6, 12, 11]
    star_sel = {"intersect": q_star(0, 301)["intersect"],
                "select": ["key", "gross", "year"], "type": "film"}
    sel = [q_films(0, 1), q_films(1, 0), q_films(2, 2), star_sel]
    tiny = dict(frontier=16, expand=8, results=4, bucket=1)
    return [
        ("uniform_count", "two_tier", [q_chain(d) for d in range(4)],
         dict(CAPS, bucket=32), dict(read_ts=9)),
        ("uniform_select", "two_tier", [q_films(d, 1) for d in range(3)],
         dict(CAPS, results=1), {}),
        ("uniform_star", "all_delta",
         [q_star(0, 301), q_star(1, 305), q_star(2, 311)], CAPS, {}),
        ("fused_mixed", "two_tier", MIXED + sel, CAPS,
         dict(read_ts=ts + [12] * len(sel), fused=True)),
        ("shared_mixed", "two_tier", MIXED + sel, CAPS,
         dict(read_ts=ts + [12] * len(sel), budget="shared")),
        ("uniform_tiny", "two_tier", [q_chain(d) for d in range(4)],
         dict(frontier=16, expand=64, bucket=2), {}),
        ("fused_tiny", "two_tier", MIXED, tiny, dict(fused=True)),
        ("shared_tiny", "two_tier", MIXED,
         dict(tiny, bucket=2, shared_bucket=3), dict(budget="shared")),
        ("nearest", "docs", BATCH, VCAPS, dict(read_ts=VTS)),
        ("nearest_shared", "docs", BATCH, VCAPS,
         dict(read_ts=VTS, budget="shared")),
    ]


FIELDS = ("counts", "rows_gid", "truncated", "failed_q", "shared_ovf_q",
          "deadline_q")


def main(out: str, names=()) -> int:
    from repro.core.query.executor import QueryCaps
    from repro.dist import compat
    from test_torch_store_index_edges import jax_db
    from test_torch_vector import jax_vdb
    mesh = compat.make_mesh((2, 2), ("data", "model"))
    dbs = {"two_tier": jax_db("two_tier"), "all_delta": jax_db("all_delta"),
           "docs": jax_vdb()}
    dbs["docs"].vector_index("doc")
    arrays = {}
    for name, store, queries, caps, kw in cases():
        if names and name not in names:
            continue
        res = dbs[store].query(queries, caps=QueryCaps(**caps), backend="ref",
                               mesh=mesh, **kw)
        arrays[f"{name}/failed"] = np.asarray(res.failed)
        for f in FIELDS:
            if getattr(res, f) is not None:
                arrays[f"{name}/{f}"] = np.asarray(getattr(res, f))
        for (kind, col), v in (res.rows or {}).items():
            arrays[f"{name}/rows/{kind}/{col}"] = np.asarray(v)
    np.savez(out, **arrays)
    return 0


if __name__ == "__main__":
    # four host devices, set before JAX first starts
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4")
    sys.exit(main(sys.argv[1], sys.argv[2:]))
