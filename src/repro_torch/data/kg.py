"""Synthetic film/entertainment knowledge graph (the paper's §6 dataset).

Port of ``repro/data/kg.py`` for the read-only slice of the PyTorch port.
The JAX package loads its graph through the transactional write path; this
package has no write path yet, so :func:`assemble` lays a store out directly,
exactly as the compactions leave it: vertex rows written in place, both
CSRs built by :func:`repro_torch.core.edges._compact_one_shard` over an
empty tier 1 with every half-edge as the "delta" (sorted by slot, edge type,
neighbor), and the primary index built by
:func:`repro_torch.core.index.merge_index_entries` the same way (sorted by
mix32, vtype, key).  Once the write path is ported, this loader moves onto it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import edges as edges_mod
from repro_torch.core import index as index_mod
from repro_torch.core.addressing import NULL, TS_INF, StoreConfig
from repro_torch.core.catalog import Catalog
from repro_torch.core.graphdb import GraphDB, resolve_device
from repro_torch.core.store import GraphStore, make_store

SCHEMA = (("v", "director", (), ("dob",)),
          ("v", "actor", (), ("dob",)),
          ("v", "film", ("gross",), ("year", "genre")),
          ("v", "genre", (), ()),
          ("e", "film.director", (), ()),      # director -> film
          ("e", "film.actor", (), ()),         # film -> actor
          ("e", "film.genre", (), ()))         # film -> genre


@dataclasses.dataclass
class FilmKG:
    db: GraphDB
    n_directors: int
    n_actors: int
    n_films: int
    n_genres: int
    director_keys: np.ndarray
    actor_keys: np.ndarray
    film_keys: np.ndarray
    genre_keys: np.ndarray
    edges: dict = None       # the generated edge list: src, dst, etype


def _col(d: dict, name: str, n: int, fill, dtype=np.int32) -> np.ndarray:
    v = d.get(name)
    return np.full(n, fill, dtype) if v is None else np.asarray(v, dtype)


def assemble(cfg: StoreConfig, vertices: dict, edges: dict, ts: int, device,
             gc_ts=None) -> GraphStore:
    """Lay out a compacted store from vertex and edge lists.

    ``vertices``: ``gid``, ``vtype``, ``key`` (n,) and optionally ``f``
    (n, <= d_f32), ``i`` (n, <= d_i32), ``create`` / ``delete`` (default
    ``ts`` / live), ``data_ts``, ``prev_f``, ``prev_i``, ``prev_ts`` (default:
    the current version at ``create``) and ``edgever`` (default ``ts`` for
    every endpoint of an edge, else 0).  ``edges``: ``src``, ``dst``,
    ``etype`` (m,) and optionally ``create`` / ``delete``.  Every vertex
    gets one index entry with its own interval.  Records dead at ``gc_ts``
    (default ``ts``) are dropped, as a compaction drops them; ties in the
    sort keys (an edge deleted and created again) keep creation order."""
    S, cap_v = cfg.n_shards, cfg.cap_v
    dev = torch.device(device)
    gc = ts if gc_ts is None else gc_ts
    store = make_store(cfg, dev)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    # ---- vertex rows ------------------------------------------------------
    gid = np.asarray(vertices["gid"], np.int64)
    n = gid.shape[0]
    rows = t((gid % S) * cap_v + gid // S)
    create = _col(vertices, "create", n, ts)
    f = np.asarray(vertices.get("f", np.zeros((n, 0))), np.float32)
    i = np.asarray(vertices.get("i", np.zeros((n, 0))), np.int32)
    cols = dict(vtype=vertices["vtype"], vkey=vertices["key"],
                v_create=create,
                v_delete=_col(vertices, "delete", n, TS_INF),
                vdata_ts=vertices.get("data_ts", create),
                vprev_ts=vertices.get("prev_ts", create))
    for name, v in cols.items():
        getattr(store, name)[rows] = t(np.asarray(v, np.int32))
    store.vdata_f[rows, :f.shape[1]] = t(f)
    store.vdata_i[rows, :i.shape[1]] = t(i)
    pf = np.asarray(vertices.get("prev_f", f), np.float32)
    pi = np.asarray(vertices.get("prev_i", i), np.int32)
    store.vprev_f[rows, :pf.shape[1]] = t(pf)
    store.vprev_i[rows, :pi.shape[1]] = t(pi)

    # ---- both CSRs: compaction of an empty tier 1 with every half-edge ----
    src = np.asarray(edges["src"], np.int64)
    dst = np.asarray(edges["dst"], np.int64)
    m = src.shape[0]
    e_cre = _col(edges, "create", m, ts)
    order = np.argsort(e_cre, kind="stable")       # ties keep creation order
    e_typ = t(np.asarray(edges["etype"], np.int32)[order])
    e_cre_t = t(e_cre[order])
    e_del = t(_col(edges, "delete", m, TS_INF)[order])
    src, dst = src[order], dst[order]
    if "edgever" in vertices:
        store.v_edgever[rows] = t(np.asarray(vertices["edgever"], np.int32))
    elif m:
        ends = t(np.unique(np.concatenate([src, dst])))
        store.v_edgever[(ends % S) * cap_v + ends // S] = int(ts)
    csr = {}
    for direction, own, other in (("out", src, dst), ("in", dst, src)):
        own_t = t(own.astype(np.int32))
        other_t = t(other.astype(np.int32))
        parts = [edges_mod._compact_one_shard(
            *_empty_tier1(cfg, dev), *(x[own_t % S == s] for x in (
                own_t // S, other_t, e_typ, e_cre_t, e_del)),
            gc_ts=gc, cap_v=cap_v) for s in range(S)]
        if any(bool(p[5]) for p in parts):
            raise ValueError(f"{direction}-edges overflow cap_e={cfg.cap_e}")
        csr[direction] = [torch.cat([p[k] for p in parts]) for k in range(5)]
    (store.oe_indptr, store.oe_dst, store.oe_type, store.oe_create,
     store.oe_delete) = csr["out"]
    (store.ie_indptr, store.ie_src, store.ie_type, store.ie_create,
     store.ie_delete) = csr["in"]

    # ---- primary index: one entry per vertex, routed by (vtype, key) ------
    order = np.argsort(create, kind="stable")
    x_vt = t(np.asarray(vertices["vtype"], np.int32)[order])
    x_k = t(np.asarray(vertices["key"], np.int32)[order])
    x_g = t(gid.astype(np.int32)[order])
    x_c = t(create[order])
    x_d = t(_col(vertices, "delete", n, TS_INF)[order])
    x_sh = index_mod.route(x_vt, x_k, S)
    cap_x = cfg.cap_idx
    shards = []
    for s in range(S):
        sel = x_sh == s
        merged = index_mod.merge_index_entries(
            *(torch.cat([torch.full((cap_x,), int(fill), dtype=torch.int32,
                                    device=dev), x[sel]])
              for fill, x in ((TS_INF, x_vt), (TS_INF, x_k), (NULL, x_g),
                              (TS_INF, x_c), (TS_INF, x_d))),
            gc_ts=gc, cap_x=cap_x)
        if int(merged[5]) > cap_x:
            raise ValueError(f"index shard {s} overflows cap_idx={cap_x}")
        shards.append(merged)
    (store.ix_vtype, store.ix_key, store.ix_gid, store.ix_create,
     store.ix_delete) = (torch.cat([sh[k] for sh in shards]) for k in range(5))
    store.ix_count = torch.stack([sh[5] for sh in shards]).to(torch.int32)
    return store


def _empty_tier1(cfg: StoreConfig, dev):
    """An empty shard pool as ``edges.compact`` reads it: every entry's slot
    is cap_v (past the last indptr) and its neighbor NULL."""
    full = torch.full
    E = cfg.cap_e
    return (full((E,), cfg.cap_v, dtype=torch.int32, device=dev),
            full((E,), int(NULL), dtype=torch.int32, device=dev),
            full((E,), int(NULL), dtype=torch.int32, device=dev),
            full((E,), int(TS_INF), dtype=torch.int32, device=dev),
            full((E,), int(TS_INF), dtype=torch.int32, device=dev))


_CAST_DRAWS = 4     # candidate draws per cast slot, before repeats are skipped


def _draw(rng, p_cdf: np.ndarray, size) -> np.ndarray:
    """Inverse-CDF draws from a discrete distribution (with replacement)."""
    u = rng.random(size) * p_cdf[-1]
    return np.minimum(np.searchsorted(p_cdf, u, side="right"),
                      p_cdf.shape[0] - 1)


def build_film_kg(*, n_films: int = 200, n_actors: int = 300,
                  n_directors: int = 40, n_genres: int = 8,
                  actors_per_film: tuple = (2, 8), seed: int = 0,
                  cfg: StoreConfig = None, zipf_a: float = 1.5,
                  device=None, ts: int = 1) -> FilmKG:
    """Film KG with the schema, key ranges, attributes and Zipf-skewed
    popularity of ``repro.data.kg.build_film_kg``, generated with vectorised
    numpy so that one machine's share (millions of films) takes seconds.

    The laws are the JAX generator's, the draws are NOT: each film's cast is
    drawn by inverse CDF with repeats skipped, which samples without
    replacement as the JAX generator does one film at a time, but from
    another random stream (and a film whose ``_CAST_DRAWS``-fold draws hold
    too few distinct actors keeps fewer).  Every record is created at
    ``ts``, which becomes the database clock.  Gids follow the JAX creation
    order: directors, actors, genres, films."""
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)
    if cfg is None:
        n_v = n_films + n_actors + n_directors + n_genres
        per_film = (actors_per_film[0] + actors_per_film[1]) // 2 + 2
        n_e = n_films * per_film * 2
        S = 8
        cfg = StoreConfig(
            n_shards=S, cap_v=max(256, 2 * n_v // S),
            cap_e=max(2048, 4 * n_e // S), cap_delta=max(512, n_e // S),
            cap_idx=max(512, 4 * n_v // S),
            cap_idx_delta=max(256, n_v // S), d_f32=2, d_i32=2)
    catalog = Catalog()
    catalog.create_tenant("default")
    catalog.create_graph("default", "g")
    ids = {}
    for kind, name, f_attrs, i_attrs in SCHEMA:
        if kind == "v":
            ids[name] = catalog.create_vertex_type(
                "default", "g", name, f_attrs, i_attrs,
                max_f_cols=cfg.d_f32, max_i_cols=cfg.d_i32).type_id
        else:
            ids[name] = catalog.create_edge_type("default", "g",
                                                 name).type_id

    d_keys = np.arange(1_000, 1_000 + n_directors)
    a_keys = np.arange(10_000, 10_000 + n_actors)
    f_keys = np.arange(100_000, 100_000 + n_films)
    g_keys = np.arange(500, 500 + n_genres)
    d0, a0 = 0, n_directors
    g0 = a0 + n_actors
    f0 = g0 + n_genres
    n_v = f0 + n_films

    vtype = np.concatenate([np.full(n_directors, ids["director"]),
                            np.full(n_actors, ids["actor"]),
                            np.full(n_genres, ids["genre"]),
                            np.full(n_films, ids["film"])]).astype(np.int32)
    key = np.concatenate([d_keys, a_keys, g_keys, f_keys]).astype(np.int32)
    f = np.zeros((n_v, 1), np.float32)
    i = np.zeros((n_v, 2), np.int32)
    i[d0:a0, 0] = rng.integers(1940, 1995, n_directors)       # dob
    i[a0:g0, 0] = rng.integers(1940, 2000, n_actors)          # dob
    f[f0:, 0] = rng.uniform(1, 500, n_films)                  # gross
    i[f0:, 0] = rng.integers(1960, 2026, n_films)             # year
    i[f0:, 1] = rng.integers(n_genres, size=n_films)          # genre

    # Zipf-skewed popularity: a few mega-actors, like the paper's skew
    a_cdf = np.cumsum(1.0 / np.power(np.arange(1, n_actors + 1), zipf_a))
    d_cdf = np.cumsum(1.0 / np.power(np.arange(1, n_directors + 1), zipf_a))
    films = np.arange(n_films, dtype=np.int64)
    director = _draw(rng, d_cdf, n_films)
    genre = rng.integers(n_genres, size=n_films)
    lo, hi = actors_per_film
    n_cast = rng.integers(lo, hi, size=n_films)
    # each film's cast: draws by popularity, repeats skipped, the first
    # n_cast distinct kept (sampling without replacement, as the JAX
    # generator's rng.choice(replace=False, p=pop) does)
    cast = _draw(rng, a_cdf, (n_films, _CAST_DRAWS * (hi - 1)))
    order = np.argsort(cast, axis=1, kind="stable")
    srt = np.take_along_axis(cast, order, axis=1)
    first = np.empty_like(cast, dtype=bool)
    np.put_along_axis(first, order, np.concatenate(
        [np.ones((n_films, 1), bool), srt[:, 1:] != srt[:, :-1]], axis=1),
        axis=1)
    cast_ok = first & (np.cumsum(first, axis=1) <= n_cast[:, None])
    pair = np.unique((films[:, None] * n_actors + cast)[cast_ok])
    c_film, c_actor = pair // n_actors, pair % n_actors

    src = np.concatenate([d0 + director, f0 + films, f0 + c_film])
    dst = np.concatenate([f0 + films, g0 + genre, a0 + c_actor])
    etype = np.concatenate([np.full(n_films, ids["film.director"]),
                            np.full(n_films, ids["film.genre"]),
                            np.full(pair.shape[0], ids["film.actor"])])
    store = assemble(cfg, dict(gid=np.arange(n_v), vtype=vtype, key=key,
                               f=f, i=i),
                     dict(src=src, dst=dst, etype=etype), ts, dev)
    db = GraphDB(cfg, catalog=catalog, device=dev, store=store)
    db.clock = int(ts)
    gid = np.arange(n_v)
    db.v_next = np.bincount(gid % cfg.n_shards, minlength=cfg.n_shards
                            ).astype(np.int64)
    return FilmKG(db=db, n_directors=n_directors, n_actors=n_actors,
                  n_films=n_films, n_genres=n_genres,
                  director_keys=d_keys, actor_keys=a_keys,
                  film_keys=f_keys, genre_keys=g_keys,
                  edges=dict(src=src, dst=dst, etype=etype))
