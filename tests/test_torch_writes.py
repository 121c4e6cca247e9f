"""PyTorch port, write path: ``GraphDB.write``, OCC validation, mutation
waves, wave records, the inline compaction backstop and the film-KG loader
against the JAX package.

The JAX side is a committed fixture (``tests/fixtures/torch_writes``): the
seeded op script ``tests/torch_write_script.py`` run through the JAX write
path, a JAX replica that replayed its wave records, and the JAX
``build_film_kg`` store at a small explicit config.  Regenerate it with
``PYTHONPATH=src python tests/fixtures/torch_writes/make_fixture.py``; the
tests compile no JAX program.  Integer fields, statuses, gids and reasons
must match exactly and floats bit for bit (the port copies them).
"""
import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_write_script as script
from repro_torch.core import graphdb as graphdb_mod
from repro_torch.core import store as store_mod
from repro_torch.core import txn as txn_mod
from repro_torch.core import vindex, writes
from repro_torch.core.addressing import StoreConfig
from repro_torch.core.graphdb import GraphDB
from repro_torch.core.txn import BatchCaps
from repro_torch.data.kg import SCHEMA, build_film_kg, load_film_kg
from test_torch_store_index_edges import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_writes"
PARTS = {   # the store's fields, by layer
    "vertices": ("vtype", "vkey", "v_create", "v_delete", "v_edgever",
                 "vdata_f", "vdata_i", "vdata_ts", "vprev_f", "vprev_i",
                 "vprev_ts"),
    "out_csr": ("oe_indptr", "oe_dst", "oe_type", "oe_create", "oe_delete",
                "oe_data"),
    "in_csr": ("ie_indptr", "ie_src", "ie_type", "ie_create", "ie_delete"),
    "edge_logs": tuple(f"{p}_{n}" for p in ("dl", "il") for n in
                       ("slot", "nbr", "type", "create", "delete", "count")),
    "index": tuple(f"ix_{n}" for n in ("vtype", "key", "gid", "create",
                                       "delete", "count")),
    "index_delta": tuple(f"xd_{n}" for n in ("vtype", "key", "gid",
                                             "create", "delete", "count")),
    "vector_index": tuple(f"vx_{n}" for n in ("gid", "vtype", "create",
                                              "delete", "emb", "count")),
}


def test_parts_cover_the_store():
    assert sorted(f for fs in PARTS.values() for f in fs) == sorted(
        store_mod.FIELDS)


@pytest.fixture(scope="module")
def jax_side():
    meta = json.loads((FIXTURE / "writes.json").read_text())
    with np.load(FIXTURE / "writes.npz") as z:
        meta["arrays"] = {k: z[k] for k in z.files}
    return meta


def fresh_db(**kw) -> GraphDB:
    db = GraphDB(StoreConfig(**script.CFG), caps=BatchCaps(**script.CAPS),
                 device="cpu", **kw)
    script.schema(db)
    return db


@pytest.fixture(scope="module")
def port_script():
    db = fresh_db()
    return db, script.run(db, writes)


@pytest.fixture(scope="module")
def port_replica(jax_side):
    db = fresh_db()
    for rec in jax_side["records"]:
        assert writes.replay_wave(db, rec) == 1
    return db


@pytest.fixture(scope="module")
def port_kg():
    return load_film_kg(**script.KG_SIZES, cfg=StoreConfig(**script.KG_CFG),
                        device="cpu").db


def assert_part_equal(db, arrays, prefix, part):
    for name in PARTS[part]:
        got = getattr(db.store, name).cpu().numpy()
        want = arrays[f"{prefix}/{name}"]
        assert got.shape == want.shape, name
        assert got.dtype.itemsize == want.dtype.itemsize == 4, name
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), name


def test_fixture_is_from_this_script(jax_side):
    sha = hashlib.sha256(Path(script.__file__).read_bytes()).hexdigest()
    assert jax_side["script_sha256"] == sha, (
        "tests/torch_write_script.py changed: regenerate the fixture with "
        "make_fixture.py")


# ---------------------------------------------------------------------------
# the op script: stores, outcomes, host state, wave records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("part", sorted(PARTS))
@pytest.mark.parametrize("which", ("script", "replica", "kg"))
def test_store_matches_jax(which, part, jax_side, request):
    db = {"script": lambda: request.getfixturevalue("port_script")[0],
          "replica": lambda: request.getfixturevalue("port_replica"),
          "kg": lambda: request.getfixturevalue("port_kg")}[which]()
    assert_part_equal(db, jax_side["arrays"], which, part)


@pytest.mark.parametrize("which", ("script", "replica", "kg"))
def test_host_mirrors_match_jax(which, jax_side, request):
    db = {"script": lambda: request.getfixturevalue("port_script")[0],
          "replica": lambda: request.getfixturevalue("port_replica"),
          "kg": lambda: request.getfixturevalue("port_kg")}[which]()
    want = jax_side["mirrors"][which]
    assert json.loads(json.dumps(script.mirrors(db))) == want


def test_write_results_match_jax(port_script, jax_side):
    """Every WriteResult (statuses, gids, reasons, clock), raised error and
    snapshot read of the script, in order."""
    got = json.loads(json.dumps(port_script[1]))
    want = jax_side["events"]
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"event {k}"


def test_script_covers_its_cases(jax_side):
    """The fixture holds every outcome the script is there to show."""
    ev = jax_side["events"]
    reasons = {r for e in ev if e[0] == "result" and isinstance(e[1], list)
               and len(e[1]) == 4 for r in e[1][2] if r}
    assert reasons == {"stale read (OCC validation)",
                       "intra-batch write-write conflict (first wins)",
                       "intra-batch read-write conflict (first wins)"}
    errors = {(e[1], e[2]) for e in ev if e[0] == "error"}
    assert ("CapacityError",
            "single transaction exceeds batch caps; raise BatchCaps") in errors
    assert {t for t, _ in errors} == {"ValueError", "TypeError", "Aborted",
                                      "CapacityError"}
    dead, src = ev[-2], ev[-1]          # the delete that missed an edge
    assert dead[3][2] is False and dead[6] == [[src[1], 1]]
    assert [dead[1], 1] in src[5]
    st = jax_side["mirrors"]["script"]["stats"]
    assert st["compactions"] >= 2 and st["vindex_compactions"] >= 2
    assert jax_side["mirrors"]["script"]["epochs"]["compact_index"] >= 2


def test_wave_records_match_jax(port_script, jax_side):
    db, _ = port_script
    got = json.loads(json.dumps(list(db.wave_log)))
    assert [r["seq"] for r in got] == [r["seq"] for r in jax_side["records"]]
    for g, w in zip(got, jax_side["records"]):
        assert g == w, f"wave {w['seq']}"


def test_replay_is_idempotent_and_refuses_gaps(jax_side):
    recs = jax_side["records"]
    db = fresh_db()
    assert writes.replay_wave(db, recs[0]) == 1
    assert writes.replay_wave(db, recs[0]) == 0
    with pytest.raises(ValueError, match="replication gap"):
        writes.replay_wave(db, recs[2])


# ---------------------------------------------------------------------------
# pieces of the wave on their own
# ---------------------------------------------------------------------------

def test_one_gid_updated_twice_keeps_the_last_row():
    db = fresh_db()
    g = db.create_vertex("person", 1, {"x": 1.0, "y": 2.0, "age": 3})
    db.write([writes.UpdateVertex(g, "person", {"x": 5.0}),
              writes.UpdateVertex(g, "person", {"age": 9})])
    f, i = db._read_data_host(g, db.clock)
    assert f.tolist() == [1.0, 2.0] and i.tolist() == [9, 0]
    f, i = db._read_data_host(g, db.clock - 1)       # the previous version
    assert f.tolist() == [1.0, 2.0] and i.tolist() == [3, 0]


def test_last_wins_mask():
    idx = torch.tensor([3, 5, 3, 7, 5, 3], dtype=torch.int32)
    ok = torch.tensor([True, True, True, True, False, False])
    assert txn_mod._last_wins(idx, ok).tolist() == [False, True, True, True,
                                                     False, False]


def test_csr_find_clamps_at_the_pool_end():
    """A shard's last span may end at cap_e: the search must not read past
    the pool, and finds the span's last entry."""
    indptr = torch.tensor([[0, 2, 4]], dtype=torch.int32)       # cap_v 2
    typ = torch.tensor([[0, 1, 0, 1]], dtype=torch.int32)       # cap_e 4
    nbr = torch.tensor([[5, 6, 7, 9]], dtype=torch.int32)
    z = torch.zeros(4, dtype=torch.int32)
    pos = txn_mod._csr_find(indptr, typ, nbr, z,
                            torch.tensor([1, 1, 1, 0], dtype=torch.int32),
                            torch.tensor([1, 1, 0, 1], dtype=torch.int32),
                            torch.tensor([9, 10, 7, 6], dtype=torch.int32))
    assert pos.tolist() == [3, -1, 2, 1]


def test_vector_fold_keeps_what_a_pin_sees():
    db = fresh_db()
    g = db.create_vertex("person", 1, {"x": 1.0, "y": 2.0})
    pin = db.clock
    db.update_vertex(g, "person", {"x": 3.0})
    db.active_query_ts.append(pin)
    db.run_vindex_compaction()
    assert int(db.vx_count.sum()) == 2            # the old vector stays
    db.active_query_ts.remove(pin)
    db.run_vindex_compaction()
    assert db.vx_count.tolist() == [1, 0, 0, 0]
    assert db._vx_pos == {g: (0, db.vt("person").type_id)}
    assert db.store.vx_emb[0].tolist() == [3.0, 2.0]


def test_fold_is_stable_within_each_shard():
    db = fresh_db()
    gids = db.write([writes.CreateVertex("person", k, {"x": float(k)})
                     for k in range(6)]).gids
    db.delete_vertex(gids[0])
    db.delete_vertex(gids[4])              # both on shard 0, first and last
    before = {g: p for g, (p, _) in db._vx_pos.items()}
    db.run_vindex_compaction()
    assert db.vx_count.tolist() == [0, 2, 1, 1]
    x = db.store.vx_emb[:, 0].tolist()
    for g, (p, _) in db._vx_pos.items():
        assert x[p] == float(gids.index(g)) and p <= before[g]


# ---------------------------------------------------------------------------
# the facade's contract
# ---------------------------------------------------------------------------

def test_capacity_error_is_one_class():
    assert graphdb_mod.CapacityError is writes.CapacityError
    assert vindex.CapacityError is writes.CapacityError


def test_deprecated_shims_warn():
    db = fresh_db()
    t = db.create_transaction()
    db.write([writes.CreateVertex("person", 1)], txn=t)
    with pytest.warns(DeprecationWarning, match="write"):
        assert db.commit(t) == "COMMITTED"
    with pytest.warns(DeprecationWarning, match="write"):
        assert db.commit_many([]) == []


def test_unported_parts_raise():
    """The parts this file's slice left out (a replication log, a task
    queue over the watermark) are ported now: both are taken, and neither
    raises."""
    from repro_torch.core.replication import ObjectStore, ReplicationLog
    from repro_torch.core.tasks import TaskQueue
    log = ReplicationLog(ObjectStore())
    db = fresh_db(replication_log=log)
    db.write([writes.CreateVertex("person", 1)])
    assert log.lag() == 0 and len(log.os.tables["g.vertices"]) == 1
    db.task_queue = TaskQueue(db)
    db.compaction_watermark = 0.0
    db.write([writes.CreateVertex("person", 2)])
    assert [t.name for t in db.task_queue._q] == ["bg-compaction"]
    db.task_queue.drain()
    assert db.stats["bg_compactions"] == 2          # edges and index


def test_gc_ts_counts_fleet_pins():
    db = fresh_db()
    db.clock = 9
    assert db.gc_ts() == 9
    db.fleet_pins.append(4)
    db.active_query_ts.append(6)
    assert db.gc_ts() == 4


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        load_film_kg(n_films=2, n_actors=3, n_directors=1, n_genres=1)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        GraphDB(StoreConfig(**script.CFG))


def test_from_numpy_carries_the_allocator(port_kg):
    """A carried-across store allocates the gids its source would."""
    db = port_kg
    arrays = {f.name: getattr(db.store, f.name).numpy()
              for f in dataclasses.fields(db.store)}
    counters = dict(clock=db.clock, dl_count=db.dl_count,
                    il_count=db.il_count, xd_count=db.xd_count,
                    v_next=db.v_next, v_free=db.v_free, rr=db._rr,
                    wave_seq=db.wave_seq)
    other = GraphDB.from_numpy(db.cfg, arrays, SCHEMA, counters,
                               device="cpu")
    assert other._rr == db._rr and other.wave_seq == db.wave_seq
    for d in (db, other):
        d.v_free[2].append(5)
    got = [other._alloc_vertex() for _ in range(6)]
    assert got == [db._alloc_vertex() for _ in range(6)]


def test_vectorised_loader_sets_the_cursor():
    kg = build_film_kg(n_films=5, n_actors=6, n_directors=2, n_genres=3,
                       device="cpu")
    assert kg.db._rr == 16 % kg.db.cfg.n_shards


def test_a_wave_past_a_shard_log_raises_before_applying():
    """A batch whose appends overrun one shard's delta log even after the
    backstop raises (the JAX package would write into the next shard's
    block); a batch of as many edges spread over the shards commits.  A
    refused wave of staged transactions leaves them OPEN."""
    cfg = StoreConfig(n_shards=2, cap_v=16, cap_e=64, cap_delta=4,
                      cap_idx=32, cap_idx_delta=8, d_f32=2, d_i32=2)
    db = GraphDB(cfg, device="cpu")
    db.vertex_type("p")
    db.edge_type("e")
    g = db.write([writes.CreateVertex("p", k) for k in range(8)]).gids
    clock, rows = db.clock, db.store.dl_slot.clone()
    with pytest.raises(writes.CapacityError, match="cap_delta"):
        db.write([writes.CreateEdge(g[0], d, "e", check=False)
                  for d in g[1:6]])
    assert db.clock == clock and torch.equal(db.store.dl_slot, rows)
    res = db.write([writes.CreateEdge(s, d, "e", check=False)
                    for s, d in zip(g[:6], g[2:8])])
    assert res.statuses == ["COMMITTED"] * 6
    assert db.dl_count.tolist() == [3, 3]
    # a refused wave leaves its staged transactions OPEN; they commit later
    A, B = g[0::2], g[1::2]          # the two shards' vertices
    assert {x % 2 for x in A} == {0} and {x % 2 for x in B} == {1}
    txns = [db.create_transaction() for _ in range(3)]
    for t, pairs in zip(txns, ([(A[0], B[0]), (A[0], B[1])],
                               [(A[1], B[2]), (A[1], B[3])],
                               [(A[2], A[3])])):
        db.write([writes.CreateEdge(s, d, "e", check=False)
                  for s, d in pairs], txn=t)
    clock, seq = db.clock, db.wave_seq
    with pytest.raises(writes.CapacityError, match="cap_delta"):
        db.write(txns)
    assert [t.status for t in txns] == ["OPEN"] * 3
    assert (db.clock, db.wave_seq) == (clock, seq)
    assert db.write(txns[:2]).statuses == ["COMMITTED"] * 2
    assert [t.status for t in txns] == ["COMMITTED"] * 2 + ["OPEN"]
    assert db.dl_count.tolist() == [4, 0]


@pytest.fixture(scope="module")
def written_kg():
    """The small film KG with entries in its edge logs: each of twelve
    films casts six actors more."""
    kg = load_film_kg(**script.KG_SIZES, cfg=StoreConfig(**script.KG_CFG),
                      device="cpu")
    db, e = kg.db, kg.edges
    fa, fd = db.et("film.actor").type_id, db.et("film.director").type_id
    films = e["dst"][e["etype"] == fd][:12]
    actors = np.unique(e["dst"][e["etype"] == fa])[:6]
    db.write([writes.CreateEdge(int(f), int(a), "film.actor", check=False)
              for f in films for a in actors])
    assert db.dl_count.max() > 0
    return kg


@pytest.mark.parametrize("mesh", [False, True], ids=["per_query", "mesh"])
def test_dedup_rows_wider_than_the_kernel_are_packed(mesh, written_kg,
                                                     monkeypatch):
    """A wave over a store with full delta logs holds F + 2 (E + delta
    window) candidates a row, up to 69,632 at the a1-kg caps, past the
    dedup kernel's 16-bit-count route (MAX_W).  The kernel takes such rows
    whole by its wide route, so no layer packs them any more: on a small
    written store, per-query and through ``mesh=``, the kernel path hands
    the dedup the reference path's rows, column for column (no delta
    match packed, none cut), and the results equal the reference's."""
    from repro_torch.core import backend as backend_mod
    from repro_torch.core.query.executor import QueryCaps
    from repro_torch.dist.mesh import make_mesh
    kg = written_kg
    db = kg.db
    seen = {"kernel": [], "ref": []}

    def dedup(x, cap, *, backend):
        seen[backend.kind].append((x.clone(), cap))
        return dedup0(x, cap, backend=backend)
    dedup0 = backend_mod.dedup_compact_rows
    monkeypatch.setattr(backend_mod, "dedup_compact_rows", dedup)
    assert not hasattr(backend_mod, "DEDUP_MAX_W")
    dks = [int(k) for k in kg.director_keys]
    batch = []
    for j, d in enumerate(dks):
        batch += [
            {"type": "director", "id": d, "_out_edge": {
                "type": "film.director", "_target": {
                    "type": "film", "_out_edge": {
                        "type": "film.actor", "_target": {
                            "type": "actor", "select": "count"}}}}},
            {"type": "actor", "id": int(kg.actor_keys[j]), "_in_edge": {
                "type": "film.actor", "_target": {
                    "type": "film", "select": ["key", "year"]}}}]
    kw = dict(caps=QueryCaps(frontier=64, expand=256), fused=True,
              mesh=make_mesh(4, device="cpu") if mesh else None)
    got = db.query(batch, backend="kernel", **kw)
    want = db.query(batch, backend="ref", **kw)
    assert seen["kernel"] and len(seen["kernel"]) == len(seen["ref"])
    for (xk, ck), (xr, cr) in zip(seen["kernel"], seen["ref"]):
        assert ck == cr and torch.equal(xk, xr)
    # the rows carry the delta window whole: more columns than F + E
    assert max(x.shape[1] for x, _ in seen["kernel"]) > 64 + 256
    assert not got.failed and got.failed == want.failed
    assert np.array_equal(got.counts, want.counts)
    assert np.array_equal(got.rows_gid, want.rows_gid)
