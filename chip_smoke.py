#!/usr/bin/env python3
"""Drive the PyTorch port's A1 read path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # the whole run (one GPU, ~2 minutes)
    python3 chip_smoke.py --quick    # build and check the kernels only

Phases, each printed on its own line:

  1. device — ``nvidia-smi`` name and power limit;
  2. build — the CUDA kernels under ``src/repro_torch/csrc``, one ``nvcc``
     each, in parallel;
  3. kernel checks — every kernel against its plain PyTorch version on the
     card at edge-case shapes (exact equality: every output is an integer);
  4. load — one shard of the a1-kg paper-scale config (one A1 machine's
     share of the §6 graph) filled by the port's film-KG loader;
  5. serve — 64-query batches of the a1-kg shape cells (serve_q1 2-hop,
     serve_q2 3-hop, serve_q3 2-branch star, all counts) and one mixed
     batch through ``GraphDB.query(..., fused=True)``, then the uniform
     executor; every result must equal the ``backend="ref"`` run bit for
     bit, and a small store must agree with a plain set computation;
  6. kernels — each kernel at the inputs the main path gave it: its
     launches during phase 5, its time beside the plain version's, the
     bound and a library call, as one JSON line.

Any failed check raises, so the script exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 before
printing any result.  ``--rehearse`` runs phases 4-5 at a tiny size on the
CPU (plain kernel versions, no build) and then exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
I32MAX = 2**31 - 1
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores

# a1-kg (src/repro/configs/a1_kg.py): one shard of FULL, the shape-cell caps
A1_SHARD = dict(n_shards=1, cap_v=15_000_000, cap_e=50_000_000,
                cap_delta=16_384, cap_idx=16_000_000, cap_idx_delta=16_384,
                d_f32=32, d_i32=16)
A1_CAPS = dict(frontier=4096, expand=16384, bucket=256, results=64)
KG_FULL = dict(n_films=3_500_000, n_actors=10_000_000, n_directors=1_000_000,
               n_genres=64)
BATCHES = 8                     # timed batches per serve cell
KG_REHEARSE = dict(n_films=3_000, n_actors=6_000, n_directors=500,
                   n_genres=16)

KERNELS = {   # wrapper -> (source, the TPU kernel's pallas_call it replaces)
    "searchsorted_left_ranged": (
        "src/repro_torch/csrc/sorted_lookup.cu",
        "src/repro/kernels/sorted_lookup/kernel.py:105"),
    "expand": ("src/repro_torch/csrc/edge_expand.cu",
               "src/repro/kernels/edge_expand/kernel.py:83"),
    "dedup_compact_rows": ("src/repro_torch/csrc/dedup_compact.cu",
                           "src/repro/kernels/dedup_compact/kernel.py:155"),
    "sort_rows": ("src/repro_torch/csrc/dedup_compact.cu",
                  "src/repro/kernels/dedup_compact/kernel.py:132"),
}


def say(tag: str, **kw) -> None:
    print(f"{tag} " + json.dumps(kw, default=str), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# queries: the a1-kg shape cells on the film KG
# ---------------------------------------------------------------------------

def q1(did):          # serve_q1: 2-hop count, actors who worked with X
    return {"type": "director", "id": int(did),
            "_out_edge": {"type": "film.director", "_target": {
                "type": "film", "_out_edge": {"type": "film.actor",
                                              "_target": {
                                                  "type": "actor",
                                                  "select": "count"}}}}}


def q2(did):          # serve_q2: 3-hop count, films of X's actors
    return {"type": "director", "id": int(did),
            "_out_edge": {"type": "film.director", "_target": {
                "type": "film", "_out_edge": {"type": "film.actor", "_target": {
                    "type": "actor", "_in_edge": {"type": "film.actor",
                                                  "_target": {
                                                      "type": "film",
                                                      "select": "count"}}}}}}}


def q3(did, aid):     # serve_q3: films by director X AND starring actor Y
    return {"intersect": [
        {"type": "director", "id": int(did),
         "_out_edge": {"type": "film.director", "_target": {"type": "film"}}},
        {"type": "actor", "id": int(aid),
         "_in_edge": {"type": "film.actor", "_target": {"type": "film"}}}],
        "select": "count"}


def q_select(did):    # films of X with their attributes (a select terminal)
    return {"type": "director", "id": int(did),
            "_out_edge": {"type": "film.director", "_target": {
                "type": "film", "select": ["key", "gross", "year"]}}}


def zipf_keys(rng, n_items: int, base: int, size: int, a: float = 1.5):
    """Keys drawn by the loader's popularity law (rank r has weight r^-a)."""
    import numpy as np
    cdf = np.cumsum(1.0 / np.power(np.arange(1, n_items + 1), a))
    r = np.searchsorted(cdf, rng.random(size) * cdf[-1], side="right")
    return base + np.minimum(r, n_items - 1)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def phase_build():
    from repro_torch.kernels import _cuda
    t0 = time.perf_counter()
    reports = _cuda.build()
    secs = time.perf_counter() - t0
    for name, log in reports.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"ptxas {name}: {ln.strip()}", flush=True)
    say("BUILD", seconds=secs, built=sorted(reports))


def _exact(a, b, what):
    import torch
    if isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            _exact(x, y, f"{what}[{i}]")
        return
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{what}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    check(bool(torch.equal(a, b)), f"{what}: kernel and plain version differ")


def phase_kernel_checks():
    """Each kernel against its plain version at edge-case shapes."""
    import numpy as np
    import torch
    from repro_torch.kernels.dedup_compact import kernel as dk
    from repro_torch.kernels.edge_expand import kernel as ek
    from repro_torch.kernels.edge_expand import ref as eref
    from repro_torch.kernels.sorted_lookup import kernel as sk
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)
    n_cases = 0
    # -- searchsorted_left_ranged: sorted blocks, clipped/empty windows ------
    blk, S = 1000, 3
    keys = np.sort(rng.integers(-2**31, I32MAX, (S, blk)), axis=1)
    keys[:, -100:] = I32MAX                                # empty slots
    q = rng.integers(-2**31, I32MAX, 999)
    q[:8] = [I32MAX, -2**31, 0, keys[0, 0], keys[1, 5], keys[2, -101], -1, 1]
    shard = rng.integers(0, S, q.shape[0])
    lo, hi = shard * blk, shard * blk + blk
    lo[10:20], hi[10:20] = 5, 5                            # empty windows
    hi[20:30] = lo[20:30] - 7                              # hi < lo
    lo[30:40], hi[30:40] = -50, S * blk + 50               # clipped
    args = (t(keys.reshape(-1)), t(q), t(lo), t(hi))
    _exact(sk.searchsorted_left_ranged(*args),
           sk.searchsorted_left_ranged_plain(*args),
           "searchsorted_left_ranged")
    n_cases += 1
    # -- expand: deg 0, long spans, padding tiles, a truncated plan --------
    E = 50_000
    pools = [t(rng.integers(-5, 1_000_000, E)) for _ in range(4)]
    for F, cap_extra, n_pools in ((500, 7, 4), (1, 3, 1), (300, -20, 2)):
        degs = rng.integers(0, 400, F)
        degs[::7] = 0
        degs[::13] = rng.integers(1000, 3000, degs[::13].shape[0])
        starts = rng.integers(0, E - degs.max() - 1, F)
        degs_t, starts_t = t(degs), t(starts)
        n_tiles = int(((degs + 127) // 128).sum())
        cap_tiles = max(1, n_tiles + cap_extra)
        item, tw, _, _ = eref.plan(degs_t, 128, cap_tiles)
        a = ek.expand(starts_t, degs_t, pools[:n_pools], item, tw,
                      cap_tiles=cap_tiles)
        b = ek.expand_plain(starts_t, degs_t, pools[:n_pools], item, tw,
                            cap_tiles=cap_tiles)
        _exact(a, b, f"expand F={F} pools={n_pools}")
        n_cases += 1
    # -- dedup_compact_rows / sort_rows: widths, caps, all-PAD rows --------
    shapes = [(7, 1, 4), (5, 100, 8), (3, 1000, 1500), (4, 4097, 4096),
              (2, 36_866, 4096), (1, dk.MAX_W, 512), (3, 0, 5)]
    for R, W, cap in shapes:
        x = rng.integers(-3, 60, (R, W)) if W < 200 else \
            rng.integers(-2**31, I32MAX, (R, W))
        if W:
            x[0, :] = I32MAX                               # an all-PAD row
            x[-1, : W // 2] = rng.integers(0, 40, W // 2)  # many duplicates
        xt = t(x)
        _exact(dk.dedup_compact_rows(xt, cap),
               dk.dedup_compact_rows_plain(xt, cap),
               f"dedup {R}x{W} cap={cap}")
        _exact(dk.sort_rows(xt), dk.sort_rows_plain(xt), f"sort {R}x{W}")
        check(bool(torch.equal(dk.sort_rows(xt), torch.sort(xt, 1).values)),
              f"sort_rows {R}x{W} disagrees with torch.sort")
        n_cases += 2
    try:
        dk.sort_rows(t(np.zeros((1, dk.MAX_W + 1))))
        raise AssertionError("a row wider than MAX_W was accepted")
    except ValueError:
        pass
    torch.cuda.synchronize()
    say("KERNEL_CHECKS", cases=n_cases, equal=True)


class Recorder:
    """Wraps the kernel wrappers the backend calls, keeping the inputs of
    the largest call of each (by the work it asks for)."""

    def __init__(self):
        from repro_torch.kernels.dedup_compact import kernel as dk
        from repro_torch.kernels.edge_expand import kernel as ek
        from repro_torch.kernels.sorted_lookup import kernel as sk
        self.best = {}
        self.mods = {"searchsorted_left_ranged": sk, "expand": ek,
                     "dedup_compact_rows": dk, "sort_rows": dk}
        self.orig = {n: getattr(m, n) for n, m in self.mods.items()}
        for name, mod in self.mods.items():
            setattr(mod, name, self._wrap(name, self.orig[name]))

    WORK = {"searchsorted_left_ranged": lambda a, kw: a[1].numel(),
            "expand": lambda a, kw: kw["cap_tiles"],
            "dedup_compact_rows": lambda a, kw: a[0].numel(),
            "sort_rows": lambda a, kw: a[0].numel()}

    def _wrap(self, name, fn):
        def rec(*args, **kw):
            size = self.WORK[name](args, kw)
            if size >= self.best.get(name, (-1,))[0]:
                self.best[name] = (size, args, kw)
            return fn(*args, **kw)
        return rec

    def restore(self):
        for name, mod in self.mods.items():
            setattr(mod, name, self.orig[name])


def _tensors(args):
    import torch
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (tuple, list)):
            yield from _tensors(a)


def phase_load(dev, kg_sizes, cfg_kw):
    import torch
    from repro_torch.core.addressing import StoreConfig
    from repro_torch.data.kg import build_film_kg
    cfg = StoreConfig(**cfg_kw)
    t0 = time.perf_counter()
    kg = build_film_kg(**kg_sizes, cfg=cfg, seed=0, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    db = kg.db
    n_v = kg.n_films + kg.n_actors + kg.n_directors + kg.n_genres
    say("LOAD", seconds=secs, store_bytes=db.store.nbytes(),
        memory_allocated=(torch.cuda.memory_allocated() if dev.type == "cuda"
                          else None),
        vertices=n_v, edges=int(kg.edges["src"].shape[0]), config=cfg_kw,
        reduced="n_shards 256 -> 1")
    return kg


def _same(a, b, what):
    """Bit-identical QueryResults (counts, flags, rows)."""
    import numpy as np
    check(a.failed == b.failed, f"{what}: failed")
    for f in ("counts", "failed_q", "rows_gid", "truncated", "deadline_q"):
        x, y = getattr(a, f), getattr(b, f)
        check((x is None) == (y is None) and (
            x is None or np.array_equal(x, y)), f"{what}: {f} differs")
    check((a.rows is None) == (b.rows is None), f"{what}: rows")
    for k in (a.rows or {}):
        check(np.array_equal(a.rows[k].view(np.int32),
                             b.rows[k].view(np.int32)), f"{what}: rows {k}")


def _active_law(kg):
    """Key draws uniform over the graph's collaborations: a director of at
    least one film, and (director, actor) pairs who made a film together,
    drawn over cast entries (the loader numbers directors from gid 0,
    actors right after them, films last)."""
    import numpy as np
    e = kg.edges
    fd, fa = (kg.db.et(n).type_id for n in ("film.director", "film.actor"))
    f0 = kg.n_directors + kg.n_actors + kg.n_genres
    m = e["etype"] == fd
    dir_of_film = np.empty(kg.n_films, np.int64)
    dir_of_film[e["dst"][m] - f0] = e["src"][m]
    directors = np.unique(e["src"][m])
    cast = np.flatnonzero(e["etype"] == fa)

    def d(rng, n):
        return 1_000 + rng.choice(directors, n)

    def pairs(rng, n):
        k = rng.choice(cast, n)
        return zip(1_000 + dir_of_film[e["src"][k] - f0],
                   10_000 + e["dst"][k] - kg.n_directors)
    return d, pairs


def _batches(kg, rng, n_batches, Q):
    """(cell, queries) batches: each shape cell under two key laws.
    ``zipf``: keys drawn by the graph's own popularity law (hub starts
    common, as in entity-answer traffic; the star pairs an independent
    director and actor, so most stars are empty).  ``active``: the long
    tail of :func:`_active_law` (under the Zipf law most directors have no
    film, and a query from one does no work)."""
    nd, na = kg.n_directors, kg.n_actors

    def zipf_d(rng, n):
        return zipf_keys(rng, nd, 1_000, n)

    def zipf_pairs(rng, n):
        return zip(zipf_d(rng, n), zipf_keys(rng, na, 10_000, n))
    out = []
    for law, (d, pairs) in (("zipf", (zipf_d, zipf_pairs)),
                            ("active", _active_law(kg))):
        for _ in range(n_batches):
            out.append((f"serve_q1/{law}", [q1(k) for k in d(rng, Q)]))
            out.append((f"serve_q2/{law}", [q2(k) for k in d(rng, Q)]))
            out.append((f"serve_q3/{law}", [q3(x, y) for x, y in
                                             pairs(rng, Q)]))
            out.append((f"mixed/{law}",
                        [q1(k) for k in d(rng, 22)]
                        + [q2(k) for k in d(rng, 21)]
                        + [q3(x, y) for x, y in pairs(rng, 21)]))
    return out


def phase_serve(kg, dev, n_batches: int, caps_kw=A1_CAPS):
    import numpy as np
    import torch
    from repro_torch.core.query.executor import QueryCaps
    from repro_torch.kernels import _cuda
    db = kg.db
    caps = QueryCaps(**caps_kw)
    rng = np.random.default_rng(1)
    batches = _batches(kg, rng, n_batches, 64)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    # warm-up (first-use allocations), not counted
    db.query(batches[0][1], caps=caps, fused=True, backend="kernel")
    sync()
    _cuda.reset_launches()
    rec = Recorder()
    lat, results = {}, []
    for cell, qs in batches:
        t0 = time.perf_counter()
        res = db.query(qs, caps=caps, fused=True, backend="kernel")
        sync()
        lat.setdefault(cell, []).append(time.perf_counter() - t0)
        results.append((cell, qs, res))
    uni = []
    for cell, qs in batches:
        if cell.startswith("mixed") or any(c == cell for c, _, _ in uni):
            continue
        res = db.query(qs, caps=caps, fused=False, backend="kernel")
        uni.append((cell, qs, res))
    sel = [q_select(k) for k in zipf_keys(rng, kg.n_directors, 1_000, 64)]
    sel_f = db.query(sel, caps=caps, fused=True, backend="kernel")
    sel_u = db.query(sel, caps=caps, fused=False, backend="kernel")
    sync()
    launches = dict(_cuda.LAUNCHES)
    rec.restore()

    # every result equals the reference backend's on the same card
    for cell, qs, res in results:
        _same(res, db.query(qs, caps=caps, fused=True, backend="ref"),
              f"fused {cell}")
    for cell, qs, res in uni:
        _same(res, db.query(qs, caps=caps, fused=False, backend="ref"),
              f"uniform {cell}")
    _same(sel_f, db.query(sel, caps=caps, fused=True, backend="ref"),
          "fused select")
    _same(sel_u, db.query(sel, caps=caps, fused=False, backend="ref"),
          "uniform select")
    for cell, ts in lat.items():
        ms = np.asarray(ts) * 1e3
        failed = np.concatenate([r.failed_q for c, _, r in results
                                 if c == cell])
        counts = np.concatenate([r.counts for c, _, r in results if c == cell])
        say("SERVE", cell=cell, batches=len(ts), queries_per_batch=64,
            qps=64 * len(ts) / float(np.sum(ts)), p50_ms=float(np.median(ms)),
            p99_ms=float(np.percentile(ms, 99)),
            fast_fail_share=float(failed.mean()),
            mean_count_unfailed=(float(counts[~failed].mean())
                                 if (~failed).any() else None))
    say("SERVE_PARITY", fused_batches=len(results), uniform_batches=len(uni),
        select_batches=2, identical_to_ref=True)
    if dev.type == "cuda":
        firsts = {}
        for cell, qs in batches:
            firsts.setdefault(cell, qs)
        for cell, qs in firsts.items():
            phase_profile(db, cell, qs, caps, float(np.median(lat[cell])))
    return launches, rec.best


OWN_KERNELS = ("searchsorted_left_ranged_kernel", "expand_kernel",
               "dedup_compact_rows_kernel", "sort_rows_kernel")


def phase_profile(db, cell, qs, caps, p50_s):
    """Device busy time and kernel launches of one fused batch (profiler):
    the share of it in the port's own kernels, and the busy time against
    the profiled batch's wall time and the unprofiled p50 latency.  The
    whole table goes to ``chiprun_out/profile_<cell>.txt``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        db.query(qs, caps=caps, fused=True, backend="kernel")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kern = _device_events(prof)
    busy_us = sum(e.self_device_time_total for e in kern)
    own_us = sum(e.self_device_time_total for e in kern
                 if any(k in e.key for k in OWN_KERNELS))
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{cell.replace('/', '_')}.txt"),
              "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60,
            max_name_column_width=90))
    say("PROFILE", cell=cell, device_busy_ms=busy_us / 1e3,
        own_kernels_ms=own_us / 1e3,
        device_kernels=int(sum(e.count for e in kern)),
        profiled_wall_ms=wall_s * 1e3,
        idle_share_profiled=1.0 - busy_us / 1e6 / wall_s,
        busy_over_p50=busy_us / 1e6 / p50_s,
        top=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
             for e in top])


def phase_small_reference(dev):
    """A small store: the port's counts against plain set computations."""
    import numpy as np
    from repro_torch.core.query.executor import QueryCaps
    from repro_torch.data.kg import build_film_kg
    kg = build_film_kg(n_films=2_000, n_actors=1_500, n_directors=200,
                       n_genres=8, seed=3, device=dev)
    db = kg.db
    et = {name: db.et(name).type_id for name in ("film.director",
                                                  "film.actor")}
    out_of, in_of = {}, {}
    for s, d, e in zip(*(kg.edges[k].tolist() for k in ("src", "dst",
                                                          "etype"))):
        out_of.setdefault((s, e), set()).add(d)
        in_of.setdefault((d, e), set()).add(s)

    def gid(vt, key):
        return db.lookup_vertex(vt, key)[0]

    def step(frontier, table, e):
        return set().union(*[table.get((g, e), set()) for g in frontier])
    rng = np.random.default_rng(4)
    dids = rng.integers(1_000, 1_000 + kg.n_directors, 16)
    aids = rng.integers(10_000, 10_000 + kg.n_actors, 16)
    caps = QueryCaps(frontier=4096, expand=16384, results=64)
    res = db.query([q1(d) for d in dids] + [q2(d) for d in dids]
                   + [q3(d, a) for d, a in zip(dids, aids)], caps=caps,
                   fused=True, backend="kernel")
    want = []
    for d in dids:
        films = step({gid("director", d)}, out_of, et["film.director"])
        want.append(len(step(films, out_of, et["film.actor"])))
    for d in dids:
        films = step({gid("director", d)}, out_of, et["film.director"])
        actors = step(films, out_of, et["film.actor"])
        want.append(len(step(actors, in_of, et["film.actor"])))
    for d, a in zip(dids, aids):
        f1 = step({gid("director", d)}, out_of, et["film.director"])
        f2 = step({gid("actor", a)}, in_of, et["film.actor"])
        want.append(len(f1 & f2))
    check(not res.failed_q.any(), "small store: unexpected fast-fail")
    check(np.array_equal(res.counts, np.asarray(want)),
          f"small store: counts {res.counts.tolist()} != {want}")
    say("SMALL_REFERENCE", queries=len(want), equal=True)


def _events_ms(fn, n: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _device_ms(fn, n: int = 10):
    """Device busy time per call from the profiler (None if it saw none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in _device_events(prof))
    return us / 1e3 / n if us > 0 else None


def _device_events(prof):
    """The profiler's device-side entries (kernels, memsets, copies); an
    operator's own entry repeats its kernels' time, so it is left out."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and (e.self_device_time_total or 0) > 0]


def _bound(name, args, kw, out):
    """Least time for the work on this run's inputs, and what bounds it:
    (ms, 'bytes' | 'operations')."""
    import math
    import torch
    if name == "searchsorted_left_ranged":
        keys, q, lo, hi = args
        n = keys.shape[0]
        w = (torch.clamp(hi.long(), max=n) - torch.clamp(lo.long(), min=0)
             ).clamp(min=0)
        probes = int(sum(int(x).bit_length() for x in w.tolist()))
        nbytes, ops = 16 * q.shape[0] + 4 * probes, probes
    elif name == "expand":
        starts, degs, pools = args[0], args[1], args[2]
        item, tw, cap_tiles = args[3], args[4], kw["cap_tiles"]
        F = degs.shape[0]
        rem = degs[item.clamp(max=F - 1)] - tw * 128
        lanes = int(rem.clamp(0, 128)[item < F].sum())
        nbytes = (8 * starts.shape[0] + 8 * cap_tiles
                  + len(pools) * 4 * (cap_tiles * 128 + lanes))
        ops = 0
    else:
        x = args[0]
        R, W = x.shape
        cap = args[1] if name == "dedup_compact_rows" else W
        nbytes = 4 * R * W + 4 * R * cap + (4 * R if cap != W else 0)
        ops = R * W * max(1, math.ceil(math.log2(max(W, 2))))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_report(launches, best):
    import torch
    from repro_torch.kernels.dedup_compact import kernel as dk
    from repro_torch.kernels.edge_expand import kernel as ek
    from repro_torch.kernels.sorted_lookup import kernel as sk
    fns = {"searchsorted_left_ranged": (sk.searchsorted_left_ranged,
                                        sk.searchsorted_left_ranged_plain),
           "expand": (ek.expand, ek.expand_plain),
           "dedup_compact_rows": (dk.dedup_compact_rows,
                                  dk.dedup_compact_rows_plain),
           "sort_rows": (dk.sort_rows, dk.sort_rows_plain)}
    rows = []
    for name, (src, replaces) in KERNELS.items():
        check(launches[name] > 0, f"{name} was not launched on the main path")
        check(name in best, f"{name}: no main-path inputs recorded")
        _, args, kw = best[name]
        kern, plain = fns[name]
        out = kern(*args, **kw)
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        _exact(out, ref, f"{name} at main-path inputs")
        err = max(int((o.long() - r.long()).abs().max()) if o.numel() else 0
                  for o, r in zip(_tensors([out]), _tensors([ref])))
        lib = None
        if name == "sort_rows":
            lib = lambda: torch.sort(args[0], dim=1)
        elif name == "searchsorted_left_ranged":
            keys, q, lo, hi = args
            if bool((lo == lo[0]).all()) and bool((hi == hi[0]).all()):
                blk = keys[int(lo[0]):int(hi[0])]
                lib = lambda: torch.searchsorted(blk, q, out_int32=True)
        bound_ms, bound_by = _bound(name, args, kw, out)
        shapes = [tuple(a.shape) for a in _tensors(args)][:3]
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=int(launches[name]), max_abs_err=err,
            ms=_events_ms(lambda: kern(*args, **kw)),
            plain_ms=_events_ms(lambda: plain(*args, **kw), n=5),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=_events_ms(lib) if lib else None,
            device_ms=_device_ms(lambda: kern(*args, **kw)),
            shapes=shapes))
    print(json.dumps({"kernels": rows}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only")
    ap.add_argument("--rehearse", action="store_true",
                    help="without a GPU: phases 4-5 at a tiny size on the "
                         "CPU, then exit 1")
    args = ap.parse_args(argv)
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if not torch.cuda.is_available():
        if not args.rehearse:
            print("chip_smoke: no CUDA device; nothing was run",
                  file=sys.stderr)
            return 1
        dev = torch.device("cpu")
        kg = phase_load(dev, KG_REHEARSE, dict(A1_SHARD, cap_v=20_000,
                                               cap_e=80_000, cap_idx=20_000))
        phase_serve(kg, dev, 1, dict(A1_CAPS, frontier=256, expand=1024))
        phase_small_reference(dev)
        print("chip_smoke: CPU rehearsal finished; no GPU result",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (the checkout's package, or fail here)
    dev = torch.device("cuda")
    phase_device()
    phase_build()
    phase_kernel_checks()
    if not args.quick:
        kg = phase_load(dev, KG_FULL, A1_SHARD)
        launches, best = phase_serve(kg, dev, BATCHES)
        phase_kernel_report(launches, best)
        del kg
        phase_small_reference(dev)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
