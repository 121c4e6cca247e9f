"""A seeded write-op script that drives either package's write path.

``run(db, w)`` takes a ``GraphDB`` of the JAX package or of the PyTorch port
(built with :data:`CFG` and :data:`CAPS`, schema from :func:`schema`) and
that package's op-records module ``w`` (``repro.core.writes`` or
``repro_torch.core.writes``), and returns the list of events it saw: every
``WriteResult`` (statuses, gids, abort reasons, clock), every raised error
(type and message) and the reads it made.  It covers every op kind,
implicit and explicit transactions and ``STAGED`` results, a stale-read
abort, intra-batch write-write and read-write aborts, a cascade delete, a
delete then re-insert of one key, chunking under small ``BatchCaps``, a
transaction over the caps, the staging errors, one gid updated twice in a
transaction, the deprecated ``commit`` / ``commit_many`` shims, a pinned
snapshot across the inline backstops (edge logs, index delta and the
vector-index fold of a vector-indexed type), the backstops again unpinned,
and a delete that commits after an edge to its vertex was added (the
cascade leaves that edge, in both packages).

``tests/fixtures/torch_writes/make_fixture.py`` runs it through the JAX
package and records the results; ``tests/test_torch_writes.py`` runs it
through the port and compares.  The script imports neither package.
"""
import warnings

import numpy as np

CFG = dict(n_shards=4, cap_v=32, cap_e=128, cap_delta=16, cap_idx=64,
           cap_idx_delta=8, cap_vec=8, d_f32=2, d_i32=2)
CAPS = dict(reads=256, create_v=6, update_v=4, delete_v=2, create_e=8,
            delete_e=32)
# the film KG through the write path, at a small explicit config
KG_CFG = dict(n_shards=4, cap_v=64, cap_e=512, cap_delta=512, cap_idx=128,
              cap_idx_delta=64, d_f32=2, d_i32=2)
KG_SIZES = dict(n_films=40, n_actors=60, n_directors=8, n_genres=4, seed=5)
MISSING = 127          # a gid inside the store that is never allocated


def schema(db) -> None:
    db.vertex_type("person", f_attrs=("x", "y"), i_attrs=("age",))
    db.vertex_type("item", f_attrs=("price",), i_attrs=("year", "stock"))
    db.edge_type("likes")      # person -> item
    db.edge_type("knows")      # person -> person
    db.vector_index("person")  # the f32 row (x, y) is the embedding


def _result(r):
    """A write's outcome as JSON-safe lists."""
    if hasattr(r, "statuses"):
        return [list(r.statuses), [int(g) for g in r.gids],
                list(r.reasons), int(r.ts)]
    if isinstance(r, list):
        return [str(s) for s in r]
    return r if r is None or isinstance(r, str) else int(r)


def run(db, w) -> list:
    rng = np.random.default_rng(11)
    ev = []

    def do(fn, *a, **kw):
        try:
            r = fn(*a, **kw)
        except Exception as e:        # compared with the other package's
            ev.append(["error", type(e).__name__, str(e)])
            return None
        ev.append(["result", _result(r)])
        return r

    def person():
        return {"x": float(rng.standard_normal()),
                "y": float(rng.standard_normal()),
                "age": int(rng.integers(18, 90))}

    def item():
        return {"price": float(rng.uniform(1, 100)),
                "year": int(rng.integers(1990, 2026)),
                "stock": int(rng.integers(0, 50))}

    def read(gids, ts=None):
        """Headers, attribute rows and both edge lists at a snapshot."""
        ts = db.clock if ts is None else ts
        for g in gids:
            ev.append(["read", int(g), int(ts),
                       list(db._read_header_host(int(g), ts)),
                       [np.asarray(x).tolist()
                        for x in db._read_data_host(int(g), ts)],
                       [list(e) for e in db.get_edges(int(g), read_ts=ts)],
                       [list(e) for e in db.get_edges(int(g), read_ts=ts,
                                                      direction="in")]])

    # -- creates: an implicit multi-op write, an explicit txn (STAGED) ----
    P = do(db.write, [w.CreateVertex("person", k, person())
                      for k in range(6)]).gids
    t = db.create_transaction()
    t.rid = "load-items"
    I = do(db.write, [w.CreateVertex("item", 100 + k, item())
                      for k in range(4)], txn=t).gids
    do(db.write, [t])
    # -- edges: checked, unchecked, the per-op wrappers -------------------
    do(db.write, [w.CreateEdge(P[0], I[0], "likes"),
                  w.CreateEdge(P[0], I[1], "likes"),
                  w.CreateEdge(P[1], I[0], "likes"),
                  w.CreateEdge(P[2], P[0], "knows"),
                  w.CreateEdge(P[3], P[0], "knows"),
                  w.CreateEdge(P[0], P[4], "knows")])
    do(db.create_edge, P[5], I[2], "likes", check=False)
    do(db.update_vertex, I[2], "item", {"stock": 7})
    P.append(do(db.create_vertex, "person", 6, person(), hint=I[1]))

    # -- staging errors ----------------------------------------------------
    do(db.write, [])
    do(db.write, [w.CreateVertex("person", 0)])
    do(db.write, [w.CreateEdge(P[0], MISSING, "likes")])
    do(db.write, [w.CreateEdge(P[0], I[0], "likes")])
    do(db.write, [w.DeleteVertex(MISSING - 1)])
    t2 = db.create_transaction()
    do(db.write, [t2, w.CreateVertex("person", 50)])
    do(db.write, [t2], txn=t2)
    do(db.write, ["not an op"])
    # the first op allocates a gid before the second fails
    do(db.write, [w.CreateVertex("person", 40, person()),
                  w.CreateVertex("person", 1)])

    # -- a stale read, then staging into the aborted transaction ----------
    t_old = db.create_transaction()
    do(db.write, [w.UpdateVertex(P[1], "person", {"age": 30})], txn=t_old)
    do(db.write, [w.UpdateVertex(P[1], "person", {"x": 0.5})])
    do(db.write, [t_old])
    do(db.write, [w.CreateVertex("person", 41)], txn=t_old)

    # -- intra-batch conflicts: write-write, read-write, a winner ---------
    ta, tb, tc, td = (db.create_transaction() for _ in range(4))
    do(db.write, [w.UpdateVertex(P[2], "person", {"age": 40})], txn=ta)
    do(db.write, [w.UpdateVertex(P[2], "person", {"age": 41})], txn=tb)
    do(db.write, [w.CreateEdge(P[3], P[2], "knows")], txn=tc)
    do(db.write, [w.UpdateVertex(P[4], "person", person()),
                  w.CreateVertex("item", 104, item())], txn=td)
    do(db.write, [ta, tb, tc, td])

    # -- one gid updated twice in one transaction: the last row wins ------
    do(db.write, [w.UpdateVertex(P[3], "person", {"x": 7.0}),
                  w.UpdateVertex(P[3], "person", {"y": -7.0})])
    read([P[3]])

    # -- cascade delete (out and in edges), delete then re-insert a key ---
    before = db.clock
    do(db.delete_vertex, P[0])
    do(db.write, [w.DeleteVertex(I[3])])
    do(db.write, [w.CreateVertex("item", 103, item())])
    read([P[0], I[3], P[2], I[0]])
    read([P[0], I[3]], before)

    # -- explicit DeleteEdge through the deprecated shims -----------------
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        t = db.create_transaction()
        db.write([w.DeleteEdge(P[1], I[0], "likes")], txn=t)
        do(db.commit, t)
        t1, t2 = db.create_transaction(), db.create_transaction()
        db.write([w.CreateEdge(P[1], I[1], "likes")], txn=t1)
        db.write([w.CreateEdge(P[2], I[1], "likes")], txn=t2)
        do(db.commit_many, [t1, t2])
        do(db.commit_many, [])

    # -- chunking under the small caps, and one txn over them -------------
    txns = []
    for j in range(4):
        t = db.create_transaction()
        if j == 2:
            t.rid = "chunked"
        db.write([w.CreateVertex("person", 200 + 3 * j + k, person())
                  for k in range(3)], txn=t)
        txns.append(t)
    do(db.write, txns)
    Q = [g for t in txns for g, *_ in t.create_v]
    do(db.write, [w.CreateVertex("item", 300 + k, item()) for k in range(7)])

    # -- a pinned snapshot across the inline backstops --------------------
    pin = db.clock
    db.active_query_ts.append(pin)
    pairs = [(Q[a], Q[b]) for a in range(len(Q)) for b in range(len(Q))
             if a != b]
    order = rng.permutation(len(pairs))
    for off in range(0, 40, 8):       # edge logs and the index delta fill
        ops = [w.CreateEdge(*pairs[k], "knows") for k in order[off:off + 8]]
        do(db.write, ops + [w.CreateVertex("item", 400 + off, item())])
    for g in Q[:8]:                   # the vector index fills: the fold
        do(db.write, [w.UpdateVertex(g, "person", person())])
    do(db.write, [w.DeleteVertex(Q[0])])
    do(db.write, [w.DeleteEdge(*pairs[order[1]], "knows")])
    read([Q[0], Q[1], pairs[order[1]][0]], pin)
    read([Q[0], Q[1], pairs[order[1]][0]])
    db.active_query_ts.remove(pin)

    # -- the backstops again, nothing pinned ------------------------------
    for off in range(40, 72, 8):
        ops = [w.CreateEdge(*pairs[k], "knows") for k in order[off:off + 8]
               if Q[0] not in pairs[k]]
        do(db.write, ops + [w.CreateVertex("person", 500 + off, person())])
    for g in Q[1:9]:
        do(db.write, [w.UpdateVertex(g, "person", person())])
    do(db.write, [w.DeleteVertex(Q[2]), w.DeleteVertex(Q[3])])
    read([Q[1], Q[2], Q[4], P[6]])
    read([Q[2]], pin)

    # -- a delete staged before an edge to its vertex commits: the
    #    cascade names the edges its staging read, and its read set holds
    #    the vertex alone, so the later edge outlives the vertex ---------
    u = do(db.create_vertex, "person", 600, person())
    t_del = db.create_transaction()
    do(db.write, [w.DeleteVertex(u)], txn=t_del)
    do(db.write, [w.CreateEdge(Q[5], u, "knows")])
    do(db.write, [t_del])
    read([u, Q[5]])
    return ev


def mirrors(db) -> dict:
    """The coordinator's host state, JSON-safe."""
    def ints(a):
        return [int(x) for x in a]
    return dict(
        clock=int(db.clock), v_next=ints(db.v_next),
        v_free=[ints(f) for f in db.v_free], rr=int(db._rr),
        dl_count=ints(db.dl_count), il_count=ints(db.il_count),
        xd_count=ints(db.xd_count), vx_count=ints(db.vx_count),
        vx_pos=sorted([int(g), int(p), int(t)]
                      for g, (p, t) in db._vx_pos.items()),
        vindexed=sorted(int(t) for t in db._vindexed),
        wave_seq=int(db.wave_seq), config_epoch=int(db.config_epoch),
        stats={k: int(v) for k, v in db.stats.items()},
        epochs={k: int(v) for k, v in db.epochs.items()},
        applied_rids=[[k, v] for k, v in db.applied_rids.items()])
