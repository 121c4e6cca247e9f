"""PyTorch port, storage layer: the store, the primary index, edge
enumeration, compaction and the film-KG loader against the JAX package.

The JAX stores here hold a seeded film KG with an MVCC history (deletes, an
edge and a vertex deleted and created again), laid into the delta tier as
the write path appends it and moved into the CSR / main index by the JAX
package's own compactions.  They cross into the port as numpy arrays, so
both packages read the same bytes.  Every output compared is an integer and
is compared exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import edges as jedges
from repro.core import index as jindex
from repro.core import store as jstore
from repro.core.addressing import StoreConfig as JStoreConfig
from repro_torch.core import backend as backend_mod
from repro_torch.core import edges, index, store
from repro_torch.core.addressing import StoreConfig
from repro_torch.core.graphdb import GraphDB
from repro_torch.data.kg import assemble

BACKENDS = (backend_mod.REF, backend_mod.KERNEL)
INF = 2**31 - 1
JCFG = JStoreConfig(n_shards=4, cap_v=16, cap_e=96, cap_delta=64, cap_idx=32,
                    cap_idx_delta=24, d_f32=2, d_i32=2)
CFG = StoreConfig(**dataclasses.asdict(JCFG))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port's torch ops on one thread: the suite runs several test
    processes at once, and tiny ops on a pool of threads per process spend
    their time waiting for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def store_arrays(jst) -> dict:
    return {f.name: np.array(getattr(jst, f.name))
            for f in dataclasses.fields(jst)}


def carry(jdb, device="cpu") -> GraphDB:
    """A port GraphDB over a JAX GraphDB's store, catalog and host mirrors
    (the vector index's included)."""
    g = jdb.catalog.tenants[jdb.tenant][jdb.graph]
    schema = [("v", vt.name,
               tuple(a.name for a in vt.attrs if a.kind == "f32"),
               tuple(a.name for a in vt.attrs if a.kind == "i32"))
              for vt in g.vtypes.values()]
    schema += [("e", et.name, (), ()) for et in g.etypes.values()]
    counters = dict(clock=jdb.clock, dl_count=jdb.dl_count,
                    il_count=jdb.il_count, xd_count=jdb.xd_count,
                    v_next=jdb.v_next, vx_count=jdb.vx_count,
                    vx_pos=jdb._vx_pos, vindexed=jdb._vindexed)
    return GraphDB.from_numpy(StoreConfig(**dataclasses.asdict(jdb.cfg)),
                              store_arrays(jdb.store), schema, counters,
                              device=device)


def assert_store_equal(port_store, jax_arrays):
    for name in store.FIELDS:
        got = getattr(port_store, name).cpu().numpy()
        want = jax_arrays[name]
        assert got.shape == want.shape, name
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), name


# ---------------------------------------------------------------------------
# a seeded film KG with an MVCC history, and JAX stores holding it
# ---------------------------------------------------------------------------

def history(seed: int = 0):
    """Vertex and edge lists (vtypes director 0 / actor 1 / film 2, edge
    types film.director 0 / film.actor 1) with create/delete timestamps up
    to 12.  Actor 300 is deleted at 9 and created again (a new gid, the same
    key) at 10, cascading its edges; one film.actor edge is deleted at 11
    and created again at 12; some vertices have a previous data version."""
    rng = np.random.default_rng(seed)
    n_dir, n_film, n_act = 4, 14, 12
    vt = np.array([0] * n_dir + [2] * n_film + [1] * n_act + [1], np.int32)
    key = np.concatenate([np.arange(n_dir), 100 + np.arange(n_film),
                          300 + np.arange(n_act), [300]]).astype(np.int32)
    n = vt.shape[0]
    create = rng.integers(1, 4, n).astype(np.int32)
    delete = np.full(n, INF, np.int32)
    victim = n_dir + n_film                       # actor 300
    delete[victim], create[-1] = 9, 10
    f = rng.uniform(1, 500, (n, 2)).astype(np.float32)
    i = np.stack([rng.integers(1960, 2026, n),                   # year
                  rng.integers(0, 3, n)], 1).astype(np.int32)   # genre
    vert = dict(gid=np.arange(n), vtype=vt, key=key, create=create,
                delete=delete, f=f, i=i,
                edgever=rng.integers(0, 12, n).astype(np.int32))
    src, dst, typ = [], [], []
    for fi in range(n_film):
        film = n_dir + fi
        src.append(int(rng.integers(n_dir)))
        dst.append(film)
        typ.append(0)
        for a in rng.choice(n_act, size=int(rng.integers(1, 6)),
                            replace=False):
            src.append(film)
            dst.append(n_dir + n_film + int(a))
            typ.append(1)
    src, dst, typ = (np.array(x, np.int32) for x in (src, dst, typ))
    e_cre = rng.integers(4, 8, src.shape[0]).astype(np.int32)
    e_del = np.where(rng.random(src.shape[0]) < 0.2,
                     e_cre + rng.integers(1, 4, src.shape[0]), INF)
    e_del = np.where((dst == victim) & (e_del > 9), 9, e_del).astype(np.int32)
    k = int(np.flatnonzero((typ == 1) & (e_del == INF) & (dst != victim))[0])
    e_del[k] = 11
    edge = dict(src=np.append(src, src[k]), dst=np.append(dst, dst[k]),
                etype=np.append(typ, typ[k]), create=np.append(e_cre, 12),
                delete=np.append(e_del, INF))
    # half the vertices were updated after their creation: the previous
    # version holds other values and is what a snapshot before data_ts sees
    data_ts = create + rng.integers(0, 2, n) * rng.integers(1, 8, n)
    vert.update(data_ts=data_ts.astype(np.int32), prev_ts=create,
                prev_f=f - 7,
                prev_i=np.stack([i[:, 0] - 1, (i[:, 1] + 1) % 3], 1))
    return vert, edge


def _append_delta(a, vert, edge, vsel, esel):
    """Append the selected index entries and half-edges to the delta logs in
    creation order, as the write path does (and write every vertex row)."""
    S, cap_v = JCFG.n_shards, JCFG.cap_v
    g = vert["gid"]
    rows = (g % S) * cap_v + g // S
    for name, col in (("vtype", "vtype"), ("vkey", "key"),
                      ("v_create", "create"), ("v_delete", "delete"),
                      ("vdata_ts", "data_ts"), ("vprev_ts", "prev_ts"),
                      ("v_edgever", "edgever"), ("vdata_f", "f"),
                      ("vdata_i", "i"), ("vprev_f", "prev_f"),
                      ("vprev_i", "prev_i")):
        a[name][rows] = vert[col]

    def put(prefix, cap, shards, vals):
        for j, s in enumerate(shards):
            row = s * cap + a[f"{prefix}_count"][s]
            for col, v in vals.items():
                a[f"{prefix}_{col}"][row] = v[j]
            a[f"{prefix}_count"][s] += 1

    iv = np.flatnonzero(vsel)[np.argsort(vert["create"][vsel], kind="stable")]
    put("xd", JCFG.cap_idx_delta,
        [jindex.route_host(int(vert["vtype"][j]), int(vert["key"][j]), S)
         for j in iv],
        dict(vtype=vert["vtype"][iv], key=vert["key"][iv], gid=g[iv],
             create=vert["create"][iv], delete=vert["delete"][iv]))
    ie = np.flatnonzero(esel)[np.argsort(edge["create"][esel], kind="stable")]
    for prefix, own, other in (("dl", "src", "dst"), ("il", "dst", "src")):
        put(prefix, JCFG.cap_delta, edge[own][ie] % S,
            dict(slot=edge[own][ie] // S, nbr=edge[other][ie],
                 type=edge["etype"][ie], create=edge["create"][ie],
                 delete=edge["delete"][ie]))
    return a


def _jst(arrays):
    return jstore.GraphStore(**{k: jnp.asarray(v) for k, v in arrays.items()})


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_compact(jst, cfg, gc_ts):
    return jindex.compact_index(jedges.compact(jst, cfg, gc_ts), cfg, gc_ts)


_jax_lookup = jax.jit(jindex.lookup, static_argnames=("cfg", "xd_win"))
_jax_expand = jax.jit(jedges.expand,
                      static_argnames=("cfg", "direction", "cap_out"))
_jax_degrees = jax.jit(jedges.degrees, static_argnames=("cfg", "direction"))
_jax_headers = jax.jit(jstore.gather_headers, static_argnames=("cfg",))
_jax_data = jax.jit(jstore.gather_data, static_argnames=("cfg",))


@functools.lru_cache(maxsize=None)
def jax_stores():
    """(vertex list, edge list, {name: JAX store arrays}): ``all_delta``
    holds everything in the delta tier; ``two_tier`` has what was created by
    ts 7 compacted (pinned at 1) into the CSR and main index, and the rest in
    the delta logs."""
    vert, edge = history()
    empty = store_arrays(jstore.make_store(JCFG))
    fresh = lambda: {k: v.copy() for k, v in empty.items()}   # noqa: E731
    all_delta = _append_delta(fresh(), vert, edge,
                              np.ones(vert["gid"].shape[0], bool),
                              np.ones(edge["src"].shape[0], bool))
    early_v, early_e = vert["create"] <= 7, edge["create"] <= 7
    first = _append_delta(fresh(), vert, edge, early_v, early_e)
    compacted = store_arrays(_jax_compact(_jst(first), JCFG, 1))
    two_tier = _append_delta(compacted, vert, edge, ~early_v, ~early_e)
    return vert, edge, dict(all_delta=all_delta, two_tier=two_tier)


def jax_db(tier: str):
    """A JAX GraphDB over one of :func:`jax_stores` with the film schema of
    ``test_backend_parity.build_db`` (the same type ids), for the query
    tests: its store is set directly, so no write path has to compile."""
    from repro.core.graphdb import GraphDB as JGraphDB
    a = jax_stores()[2][tier]
    jdb = JGraphDB(JCFG)
    jdb.vertex_type("director")
    jdb.vertex_type("actor")
    jdb.vertex_type("film", f_attrs=("gross",), i_attrs=("year", "genre"))
    jdb.edge_type("film.director")
    jdb.edge_type("film.actor")
    jdb.store = _jst(a)
    jdb.clock = 12
    for k in ("dl_count", "il_count", "xd_count"):
        getattr(jdb, k)[:] = a[k]
    jdb.v_next[:] = np.bincount(jax_stores()[0]["gid"] % JCFG.n_shards,
                                minlength=JCFG.n_shards)
    return jdb


def _both(tier):
    a = jax_stores()[2][tier]
    return _jst(a), store.store_from_numpy(CFG, a, "cpu")


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_make_store_field_for_field():
    jcfg = JStoreConfig(n_shards=3, cap_v=17, cap_e=40, cap_delta=9,
                        cap_idx=21, cap_idx_delta=5, cap_vec=6, d_f32=3,
                        d_i32=2, d_ef32=1)
    assert_store_equal(
        store.make_store(StoreConfig(**dataclasses.asdict(jcfg)), "cpu"),
        store_arrays(jstore.make_store(jcfg)))


def test_mix32_and_route_wrap_like_jax():
    rng = np.random.default_rng(0)
    n = 100_000
    vt = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    key = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    vt[:4] = [0, -1, 2**31 - 1, -2**31]
    key[:4] = [2**31 - 1, -2**31, 0, -1]
    tv, tk = torch.as_tensor(vt), torch.as_tensor(key)
    h = index.mix32(tv, tk)
    assert h.dtype == torch.int32
    assert np.array_equal(h.numpy(), np.asarray(
        jindex.mix32(jnp.asarray(vt), jnp.asarray(key))))
    for S in (1, 4, 7):
        assert np.array_equal(index.route(tv, tk, S).numpy(), np.asarray(
            jindex.route(jnp.asarray(vt), jnp.asarray(key), S)))
    assert [index.mix32_host(int(a), int(b)) for a, b in
            zip(vt[:50], key[:50])] == h[:50].tolist()
    assert [index.route_host(int(a), int(b), 7) for a, b in
            zip(vt[:50], key[:50])] == index.route(tv, tk, 7)[:50].tolist()


@pytest.mark.parametrize("tier", ["all_delta", "two_tier"])
def test_index_lookup_matches_jax(tier):
    """Live, deleted, re-created and missing keys at several snapshots (per
    query, as the fused planner probes), with and without the delta
    window; the uniform executor's scalar snapshot runs in the query
    tests."""
    vert = jax_stores()[0]
    jst, st = _both(tier)
    rng = np.random.default_rng(1)
    vt = np.concatenate([vert["vtype"], [0, 1, 2]]).astype(np.int32)
    key = np.concatenate([vert["key"], [77, 999, 5]]).astype(np.int32)
    valid = rng.random(vt.shape[0]) < 0.9
    per_q = rng.integers(1, 13, vt.shape[0]).astype(np.int32)
    found = 0
    n = vt.shape[0]
    for ts, xwin in ((np.full(n, 2), None), (np.full(n, 9), 8),
                     (np.full(n, 10), None), (np.full(n, 12), 8),
                     (per_q, None)):
        ts = ts.astype(np.int32)
        want = _jax_lookup(jst, JCFG, jnp.asarray(vt), jnp.asarray(key),
                           jnp.asarray(valid), jnp.asarray(ts), xd_win=xwin)
        for be in BACKENDS:
            got = index.lookup(st, CFG, torch.as_tensor(vt),
                               torch.as_tensor(key), torch.as_tensor(valid),
                               torch.as_tensor(ts), backend=be, xd_win=xwin)
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy(), np.asarray(w)), (ts, be)
        found += int(np.asarray(want[1]).sum())
    assert found > 0


@pytest.mark.parametrize("tier", ["all_delta", "two_tier"])
def test_edges_expand_matches_jax(tier):
    """Both directions, with and without an etype filter, at several
    snapshots, on both backends; a small cap_out trips the overflow flag."""
    n = jax_stores()[0]["gid"].shape[0]
    jst, st = _both(tier)
    rng = np.random.default_rng(2)
    gids = rng.integers(0, n, 32).astype(np.int32)
    qids = np.arange(32, dtype=np.int32)
    vmask = rng.random(32) < 0.85
    overflowed = False
    for ts, etype, direction, cap_out in (
            (12, -1, "out", 256), (12, 1, "in", 256), (6, 0, "out", 8),
            (9, -1, "in", 256), (11, 1, "out", 8)):
        want = _jax_expand(jst, JCFG, jnp.asarray(qids), jnp.asarray(gids),
                           jnp.asarray(vmask), etype=jnp.int32(etype),
                           direction=direction, read_ts=jnp.int32(ts),
                           cap_out=cap_out)
        for be in BACKENDS:
            got = edges.expand(st, CFG, torch.as_tensor(qids),
                               torch.as_tensor(gids), torch.as_tensor(vmask),
                               etype=etype, direction=direction, read_ts=ts,
                               cap_out=cap_out, backend=be)
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy(), np.asarray(w)), (ts, be)
        overflowed |= bool(want[3])
    assert overflowed == (tier == "two_tier")   # only CSR spans count


def test_gathers_and_degrees_match_jax():
    """Vertex header and data gathers (current or previous version by
    snapshot, invisible ids zeroed) and raw CSR degrees, against JAX."""
    jst, st = _both("two_tier")
    n = jax_stores()[0]["gid"].shape[0]
    gids = np.concatenate([np.arange(n), [-1, 5]]).astype(np.int32)
    valid = np.arange(gids.shape[0]) % 4 != 1
    for ts in (2, 9, 12):
        for jfn, fn in ((_jax_headers, store.gather_headers),
                        (_jax_data, store.gather_data)):
            want = jfn(jst, JCFG, jnp.asarray(gids), jnp.int32(ts))
            got = fn(st, CFG, torch.as_tensor(gids), ts)
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy(), np.asarray(w)), (fn, ts)
    for direction in ("out", "in"):
        want = _jax_degrees(jst, JCFG, jnp.asarray(gids), jnp.asarray(valid),
                            etype=jnp.int32(-1), direction=direction,
                            read_ts=jnp.int32(12))
        got = edges.degrees(st, CFG, torch.as_tensor(gids),
                            torch.as_tensor(valid), etype=-1,
                            direction=direction, read_ts=12)
        assert np.array_equal(got.numpy(), np.asarray(want)), direction


@pytest.mark.parametrize("tier", ["all_delta", "two_tier"])
def test_compactions_match_jax(tier):
    """edges.compact and index.compact_index at a pinned and an unpinned
    gc_ts (dead versions kept or dropped)."""
    jst, st = _both(tier)
    for gc in (1, 10):
        want = jedges.compact(jst, JCFG, jnp.int32(gc))
        assert_store_equal(edges.compact(st, CFG, gc), store_arrays(want))
        want = jindex.compact_index(jst, JCFG, jnp.int32(gc))
        assert_store_equal(index.compact_index(st, CFG, gc),
                           store_arrays(want))


def test_facade_reads_match_history():
    """GraphDB.lookup_vertex / get_vertex / get_edges over the two-tier
    store against the vertex and edge lists it holds, at several snapshots:
    the deleted and re-created actor, the deleted and re-created edge, a
    missing key, an etype filter and the overflow error."""
    from repro_torch.core.graphdb import CapacityError
    vert, edge, stores = jax_stores()
    a = stores["two_tier"]
    schema = [("v", "director", (), ()), ("v", "actor", (), ()),
              ("v", "film", ("gross",), ("year", "genre")),
              ("e", "film.director", (), ()), ("e", "film.actor", (), ())]
    counters = dict(clock=12, dl_count=a["dl_count"], il_count=a["il_count"],
                    xd_count=a["xd_count"],
                    v_next=np.bincount(vert["gid"] % CFG.n_shards,
                                       minlength=CFG.n_shards))
    db = GraphDB.from_numpy(CFG, a, schema, counters, device="cpu")
    names = ("director", "actor", "film")

    def live(create, delete, ts):
        return (create <= ts) & (delete > ts)
    for vt, key in ((1, 300), (2, 101), (0, 2), (1, 999)):
        for ts in (2, 9, 10, 12):
            ok = (live(vert["create"], vert["delete"], ts)
                  & (vert["vtype"] == vt) & (vert["key"] == key))
            want = int(vert["gid"][ok][0]) if ok.any() else -1
            assert db.lookup_vertex(names[vt], key, read_ts=ts) == (
                want, want >= 0), (vt, key, ts)
    g = int(vert["gid"][(vert["vtype"] == 2) & (vert["key"] == 101)][0])
    assert db.get_vertex("film", 101) == {
        "gid": g, "key": 101, "gross": float(vert["f"][g, 0]),
        "year": int(vert["i"][g, 0]), "genre": int(vert["i"][g, 1])}
    assert db.get_vertex("actor", 999) is None
    for gid in range(vert["gid"].shape[0]):
        for direction, own, other in (("out", "src", "dst"),
                                      ("in", "dst", "src")):
            for ts, et in ((12, -1), (10, 1), (6, 0)):
                sel = ((edge[own] == gid)
                       & live(edge["create"], edge["delete"], ts)
                       & ((et < 0) | (edge["etype"] == et)))
                want = sorted(zip(edge[other][sel].tolist(),
                                  edge["etype"][sel].tolist()))
                got = db.get_edges(gid, direction=direction, read_ts=ts,
                                   etype=et)
                assert sorted(got) == want, (gid, direction, ts, et)
    busy = int(np.bincount(edge["src"][edge["create"] <= 7]).argmax())
    with pytest.raises(CapacityError):
        db.get_edges(busy, cap=1)


def test_assemble_matches_compacted_jax_store():
    """The loader's layout equals the JAX store after the JAX compactions
    (pinned at 1, so dead versions stay), including the edge and the vertex
    that were deleted and created again (two versions under one sort key),
    whatever order the lists come in."""
    vert, edge, stores = jax_stores()
    want = store_arrays(_jax_compact(_jst(stores["all_delta"]), JCFG, 1))
    key = np.stack([edge["src"], edge["dst"], edge["etype"]], 1)
    assert len(np.unique(key, axis=0)) < len(key)          # a tied sort key
    rng = np.random.default_rng(3)
    pv = rng.permutation(vert["gid"].shape[0])
    pe = rng.permutation(edge["src"].shape[0])
    got = assemble(CFG, {k: v[pv] for k, v in vert.items()},
                   {k: v[pe] for k, v in edge.items()}, ts=1, device="cpu",
                   gc_ts=1)
    assert_store_equal(got, want)
