#!/usr/bin/env python3
"""Drive the PyTorch port's A1 read path and LM serving and training paths
on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # the whole run (one GPU, ~10 minutes)
    python3 chip_smoke.py --quick    # build and check the kernels only

Phases, each printed on its own line:

  1. device — ``nvidia-smi`` name and power limit;
  2. build — the CUDA kernels under ``src/repro_torch/csrc``, one ``nvcc``
     each, in parallel;
  3. kernel checks — every kernel against its plain PyTorch version on the
     card at edge-case shapes (the int kernels and ``knn_topk`` exactly,
     floats compared as bits; ``rmsnorm_fwd``, ``flash_fwd`` and the two
     ``flash_bwd`` kernels within the tolerances stated beside their
     checks);
  4. load — one shard of the a1-kg paper-scale config (one A1 machine's
     share of the §6 graph) filled by the port's film-KG loader;
  5. serve — 64-query batches of the a1-kg shape cells (serve_q1 2-hop,
     serve_q2 3-hop, serve_q3 2-branch star, all counts) and one mixed
     batch through ``GraphDB.query(..., fused=True)``, then the uniform
     executor; every result must equal the ``backend="ref"`` run bit for
     bit;
  6. shared — the same batches with ``budget="shared"`` (the serving tier's
     mode for batches of 64 and more): equal to ``backend="ref"`` bit for
     bit, and holding the shared-mode contract against phase 5's results;
  7. nearest — a second store (the JAX package's hybrid vector+graph
     workload at one machine's size: 4 M vector-indexed docs) and batches of
     ``Nearest``-rooted queries in both budget modes, equal to
     ``backend="ref"``;
  8. mesh4 — four a1-kg shards, each at one machine's full caps, side by
     side on the card (``make_mesh(4)``), and phase 5's batch shapes through
     ``GraphDB.query(mesh=...)`` (the SPMD query-shipping programs) in both
     budget modes: equal to ``backend="ref"`` bit for bit, shared mode
     holding its contract, and every query flagged by neither run equal to
     the local path on the same store; the first two stores are freed first;
  9. lm — h2o-danube-3-4b at full width (24 layers, d_model 3840, GQA
     32/8, window 4096) with weights drawn from a seed: ``lm/check_f32``
     (float32 ``forward`` on the kernel path against ``backend="ref"``),
     ``lm/decode_consistency`` (decode steps against ``forward``, and a
     ring that wraps), ``lm/prefill_32k`` and ``lm/decode_32k`` in bf16,
     timed, each checked against ``backend="ref"``;
 9b. lm_train — after phase 9's weights and cache are freed:
     ``lm/train_check_f32`` (4 of the 24 layers in float32 over 4,608
     tokens: ``loss_fn`` and every gradient on the kernel path against
     ``backend="ref"``, and remat against none) and ``lm/train_4k`` (all 24
     layers in bf16, AdamW with f32 moments, one 4,096-token sequence a
     step: the first step's loss, gradient norm and gradients against
     ``backend="ref"``, then 2 warm-up and 8 timed steps on one batch whose
     loss must fall);
 10. kernels — each kernel at the inputs the main path gave it: its
     launches during phases 5-9b, its time beside the plain version's, the
     bound and a library call, as one JSON line;
 11. small reference — small stores against plain set computations and a
     numpy k-NN in the kernels' summation order, on one shard and on a
     4-shard mesh.

Each of phases 5-9b sets the kernels' launch counts to 0 just before its
timed batches, calls or steps (per budget mode or cell) and reads them just
after.
Any failed check raises, so the script exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 before
printing any result.  ``--rehearse`` runs phases 4-9b and 11 at a tiny size
on the CPU (plain kernel versions, no build) and then exits 1.
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
# the hybrid vector+graph workload (benchmarks/bench_vector.py): 16 docs a
# tag, two doc.tag edges a doc; d = the a1-kg payload width, one machine's
# 4 M vector-indexed docs
NEAREST_FULL = dict(n_docs=4_194_304, d=32)
NEAREST_REHEARSE = dict(n_docs=4_096, d=32)
NEAREST_K = 8
# mesh4: four a1-kg shards at one machine's caps each (4x the one-shard
# graph), on one card; the bucket grows with the frontier a shard sends
# each owner (a 4096-pair frontier sends ~16 pairs an owner at 256 shards,
# ~1024 at 4)
A1_MESH = dict(A1_SHARD, n_shards=4)
A1_MESH_CAPS = dict(A1_CAPS, bucket=4096)
KG_MESH = dict(n_films=14_000_000, n_actors=40_000_000,
               n_directors=4_000_000, n_genres=64)
MESH_REDUCED = ("n_shards 256 -> 4", "bucket 256 -> 4096")
# the LM phase: h2o-danube-3-4b FULL (src/repro/configs/h2o_danube_3_4b.py)
# and its prefill_32k / decode_32k cells (configs/registry.py:87-104)
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor cores
# f32_seq runs past the window, so that the f32 check's mask drops keys
LM_FULL = dict(f32_seq=4096 + 512, consist=(2, 256), ring=(2, 64, 96),
               prefill_batch=1, decode_steps=16, check_layers=4,
               train_batch=1, warm_steps=2, timed_steps=8)
LM_REHEARSE = dict(f32_seq=64, consist=(2, 40), ring=(2, 8, 24),
                   prefill_batch=1, decode_steps=3, seq=96, decode_batch=4,
                   check_layers=4, train_batch=1, warm_steps=2,
                   timed_steps=3, train_seq=64)
# float32 model outputs, kernel path against backend="ref" or decode
# against forward: max |a - b| over max |b|.  Each op rounds at ~1e-7
# relative, sums of up to 10,240 terms reach ~1e-5, 24 layers add up.
LM_F32_TOL = 1e-3
# bfloat16 model outputs, the same measure: the kernels' outputs equal the
# plain ones up to a bf16 rounding (one ulp, 2**-8 relative), and every
# such difference passes through the later layers' bf16 matmuls.
LM_BF16_TOL = 3e-2
# remat against none, float32 gradients on the kernel path: the same
# forward recomputed gives the same bits; only the order of the float32
# atomic adds in the embedding gather's backward may differ
REMAT_TOL = 1e-5
# lm/train_4k's first step, bf16 kernel path against backend="ref": the
# loss is a mean over 4,096 positions of errors like prefill's (LM_BF16_TOL
# at the largest logit, far less on average); the gradient norm and each
# leaf's direction sum millions of bf16-rounded products whose rounding
# errors are independent.  Read on the H100: loss 3.5e-7, gnorm 1.97e-4,
# least cosine 0.99961.  One lost kv-head group of wk's 24 x 8 (of equal
# norm) would read sqrt(1 - 1/192) = 0.9974, one lost layer 0.979
TRAIN_LOSS_TOL, TRAIN_GNORM_TOL, TRAIN_MIN_COSINE = 1e-4, 3e-3, 0.999

KERNELS = {   # wrapper -> (source, the TPU kernel's pallas_call it replaces)
    "searchsorted_left_ranged": (
        "src/repro_torch/csrc/sorted_lookup.cu",
        "src/repro/kernels/sorted_lookup/kernel.py:105"),
    "searchsorted_left": ("src/repro_torch/csrc/sorted_lookup.cu",
                          "src/repro/kernels/sorted_lookup/kernel.py:52"),
    "expand": ("src/repro_torch/csrc/edge_expand.cu",
               "src/repro/kernels/edge_expand/kernel.py:83"),
    "dedup_compact_rows": ("src/repro_torch/csrc/dedup_compact.cu",
                           "src/repro/kernels/dedup_compact/kernel.py:155"),
    "sort_rows": ("src/repro_torch/csrc/dedup_compact.cu",
                  "src/repro/kernels/dedup_compact/kernel.py:132"),
    "sort_pairs": ("src/repro_torch/csrc/sort_pairs.cu",
                   "src/repro/kernels/dedup_compact/kernel.py:181"),
    "knn_topk": ("src/repro_torch/csrc/knn_topk.cu",
                 "src/repro/kernels/knn_topk/kernel.py:144"),
    "rmsnorm_fwd": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/kernel.py:33"),
    "flash_fwd": ("src/repro_torch/csrc/flash_fwd.cu",
                  "src/repro/kernels/flash_attention/kernel.py:107"),
    "flash_bwd_dkv": ("src/repro_torch/csrc/flash_bwd.cu",
                      "src/repro/kernels/flash_attention/kernel.py:212"),
    "flash_bwd_dq": ("src/repro_torch/csrc/flash_bwd.cu",
                     "src/repro/kernels/flash_attention/kernel.py:234"),
}
LM_KERNELS = ("rmsnorm_fwd", "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
# the main path each kernel belongs to: phase 5's per-query serve, phase
# 6's shared serve, phase 7's nearest serve, phase 8's mesh serve, phase
# 9's LM prefill or phase 9b's LM train step
PATH_OF = {"searchsorted_left_ranged": "per_query", "expand": "per_query",
           "dedup_compact_rows": "per_query", "sort_rows": "per_query",
           "sort_pairs": "shared", "knn_topk": "nearest",
           "searchsorted_left": "mesh", "rmsnorm_fwd": "lm_prefill",
           "flash_fwd": "lm_prefill", "flash_bwd_dkv": "lm_train",
           "flash_bwd_dq": "lm_train"}
# float kernels: (rtol, atol) of the kernel against its plain version, per
# output and input dtype (see _check_rmsnorm, _check_flash and
# _check_flash_bwd)
FLOAT_TOL = {"rmsnorm_fwd": {"float32": [(1e-5, 1e-5)],
                             "bfloat16": ["ulp"]},
             "flash_fwd": {"float32": [(2e-5, 2e-5), (1e-5, 1e-5)],
                           "bfloat16": [(2 ** -7, 1e-4), (1e-5, 1e-5)]},
             "flash_bwd_dkv": {"float32": [(2e-4, 2e-4)] * 2,
                               "bfloat16": ["scale_ulp"] * 2},
             "flash_bwd_dq": {"float32": [(2e-4, 2e-4)],
                              "bfloat16": ["scale_ulp"]}}


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
    n_cases += _check_searchsorted_left(rng, t)
    n_cases += _check_sort_pairs(rng, t)
    n_cases += _check_knn_topk(rng, t)
    torch.cuda.synchronize()
    say("KERNEL_CHECKS", cases=n_cases, equal=True)
    errs = {"rmsnorm_fwd": _check_rmsnorm(dev), "flash_fwd": _check_flash(dev),
            "flash_bwd": _check_flash_bwd(dev)}
    torch.cuda.synchronize()
    say("KERNEL_CHECKS_FLOAT", cases={k: len(v) for k, v in errs.items()},
        within_tolerance=True, max_abs_err={
            k: {dt: max(e for d, e in v if d == dt) for dt in
                ("float32", "bfloat16")} for k, v in errs.items()},
        tolerance=FLOAT_TOL)


def _check_searchsorted_left(rng, t) -> int:
    """searchsorted_left against its plain version and the library search:
    duplicates, queries below and above every key, INT32_MAX queries and
    pads, N not a power of two, N = 1, Q = 1, an empty index, and 16 M keys
    (one shard's cap_idx)."""
    import numpy as np
    import torch
    from repro_torch.kernels.sorted_lookup import kernel as sk
    cases = []
    for n, q in ((1000, 999), (1, 1), (1, 50), (777, 1), (16_000_000, 4096)):
        keys = np.sort(rng.integers(-2**31, I32MAX, n))
        if n > 10:
            keys[n // 3:n // 3 + n // 10] = keys[n // 3]     # duplicates
            keys[-(n // 8):] = I32MAX                       # empty slots
        qs = rng.integers(-2**31, I32MAX, q)
        ext = [I32MAX, -2**31, int(keys[0]), int(keys[-1]), int(keys[0]) - 1]
        qs[:min(q, 5)] = ext[:min(q, 5)]
        cases.append((f"N={n} Q={q}", keys, qs))
    cases.append(("empty index", np.full(4096, I32MAX),
                  np.array([I32MAX, 0, -2**31])))
    for what, keys, qs in cases:
        k, q = t(keys), t(qs)
        got = sk.searchsorted_left(k, q)
        _exact(got, sk.searchsorted_left_plain(k, q),
               f"searchsorted_left {what}")
        _exact(got, torch.searchsorted(k, q, out_int32=True),
               f"searchsorted_left {what} vs torch.searchsorted")
    return len(cases)


def _check_sort_pairs(rng, t) -> int:
    """sort_pairs against its plain version and the library sort of the
    packed key: one pair, widths that are not powers of two, equal pairs,
    ghosts, the int32 extremes, and widths up to 2**20."""
    import numpy as np
    from repro_torch.kernels.dedup_compact import kernel as dk
    from repro_torch.kernels.dedup_compact import ref as dref
    i32min = -2**31
    cases = []
    for W in (1, 2, 37, 8191, 8192, 8193, 100_003, 196_608, 1 << 20):
        k1 = rng.integers(-50, 50, W)
        k2 = rng.integers(i32min, I32MAX, W, endpoint=True)
        cases.append((f"random W={W}", k1, k2))
    W = 30_000
    cases.append(("all pairs equal", np.full(W, 7), np.full(W, -3)))
    k1 = rng.integers(0, 64, W)
    k2 = rng.integers(0, 1_000_000, W)
    ghost = rng.random(W) < 0.5
    k1[ghost], k2[ghost] = 64, I32MAX                  # (R, PAD) ghosts
    cases.append(("ghosts (R, PAD)", k1, k2))
    ext = np.array([i32min, I32MAX, 0, -1, 1])
    cases.append(("int32 extremes", rng.choice(ext, 70_001),
                  rng.choice(ext, 70_001)))
    for what, k1, k2 in cases:
        a, b = t(k1), t(k2)
        got = dk.sort_pairs(a, b)
        _exact(got, dk.sort_pairs_plain(a, b), f"sort_pairs {what}")
        _exact(got, dref.sort_pairs(a, b), f"sort_pairs {what} vs torch.sort")
    return len(cases)


def _check_knn_topk(rng, t) -> int:
    """knn_topk against its plain version, bit for bit (distances compared
    as bits): k = 1, k > N, N not a multiple of the chunk, nothing visible,
    duplicate embeddings (ties broken by gid), zero embeddings (a -0.0
    product), a type mismatch, create == ts and delete == ts, rows past one
    row tile, and a k that needs several merge passes."""
    import numpy as np
    import torch
    from repro_torch.kernels.knn_topk import kernel as kk
    dev = torch.device("cuda")

    def case(R, N, D, seed):
        r = np.random.default_rng(seed)
        gid = r.permutation(4 * N)[:N]
        gid[r.random(N) < 0.2] = -1
        cr = r.integers(0, 10, N)
        return dict(vecs=r.normal(size=(R, D)), emb=r.normal(size=(N, D)),
                    gid=gid, vtype=r.integers(0, 3, N), create=cr,
                    delete=np.where(r.random(N) < 0.3,
                                    cr + r.integers(1, 10, N), I32MAX),
                    q_vt=r.integers(0, 3, R), q_ts=r.integers(0, 10, R))
    cases = []
    c = case(5, 1000, 32, 1)
    cases.append(("k=1", c, 1))
    cases.append(("k > N", case(3, 5, 4, 2), 16))
    cases.append(("N not a multiple of the chunk", case(64, 100_003, 32, 3),
                  8))
    c = case(4, 3000, 8, 4)
    c["gid"][:] = -1
    cases.append(("nothing visible", c, 8))
    c = case(6, 4000, 16, 5)
    c["emb"][::2] = c["emb"][0]                        # duplicate rows
    c["vecs"][0] = c["emb"][0]
    cases.append(("duplicate embeddings", c, 32))
    c = case(4, 500, 8, 6)
    c["emb"][:100] = 0.0
    c["vecs"][:] = -np.abs(c["vecs"])                  # products of -0.0
    cases.append(("zero embeddings", c, 16))
    c = case(4, 2000, 8, 7)
    c["q_vt"][:] = 5
    cases.append(("type mismatch", c, 8))
    c = case(8, 2000, 8, 8)
    c["create"][::3] = c["q_ts"][0]
    c["delete"][1::3] = c["q_ts"][0]
    c["q_ts"][:] = c["q_ts"][0]
    cases.append(("create == ts and delete == ts", c, 8))
    cases.append(("130 rows, k=100", case(130, 20_000, 32, 9), 100))
    cases.append(("k=4096", case(3, 60_000, 32, 10), 4096))
    for what, c, k in cases:
        args = [torch.as_tensor(np.ascontiguousarray(c[n], np.float32),
                                device=dev) for n in ("vecs", "emb")]
        args += [t(c[n]) for n in ("gid", "vtype", "create", "delete",
                                   "q_vt", "q_ts")]
        got = kk.knn_topk(*args, k)
        want = kk.knn_topk_plain(*args, k)
        _exact((got[0].view(torch.int32), got[1]),
               (want[0].view(torch.int32), want[1]), f"knn_topk {what}")
    return len(cases)


def _close(a, b, what, tol) -> float:
    """``a`` within ``tol`` of ``b`` everywhere (one shape and dtype):
    ``(rtol, atol)``, ``"ulp"`` for at most one bf16 ulp apart (the bit
    patterns of same-signed values differ by at most 1), or ``"scale_ulp"``
    for at most one bf16 ulp of ``b``'s largest magnitude apart.  NaN never
    passes.  Returns the largest absolute difference."""
    import math
    import torch
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{what}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    if a.numel() == 0:
        return 0.0
    err = (a.double() - b.double()).abs()
    if tol == "ulp":
        steps = (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()
        ok = (steps <= 1) | (err == 0)
    elif tol == "scale_ulp":
        top = float(b.double().abs().max())
        ok = err <= (2.0 ** (math.floor(math.log2(top)) - 7) if top else 0.0)
    else:
        rtol, atol = tol
        ok = err <= atol + rtol * b.double().abs()
    bad = int((~ok).sum())
    check(bad == 0, f"{what}: {bad} of {a.numel()} values outside {tol} "
          f"(max abs err {float(err.max())})")
    return float(err.max())


def _float_tol(name, dtype):
    return FLOAT_TOL[name][str(dtype).replace("torch.", "")]


def _check_rmsnorm(dev):
    """rmsnorm_fwd against its plain version: f32 within 1e-5 (the sum of
    squares in another order), bf16 within one ulp (both round one f32
    value); widths that are and are not a multiple of the 16-byte vector
    (1001),
    one row (decode at batch 1), 4,096 rows, and a row base off the vector
    alignment (the scalar path).  Returns [(dtype, max abs err)]."""
    import torch
    from repro_torch.kernels.rmsnorm import kernel as rk
    gen = torch.Generator(device=dev).manual_seed(11)
    out = []
    for dt in (torch.float32, torch.bfloat16):
        for d in (120, 128, 1000, 1001, 3840):
            for n, offset in ((1, 0), (7, 0), (4096, 0), (7, 1)):
                buf = torch.randn(n * d + offset, generator=gen, device=dev)
                x = buf.to(dt)[offset:].view(n, d)
                scale = (1 + 0.1 * torch.randn(d, generator=gen,
                                               device=dev)).to(dt)
                err = _close(rk.rmsnorm_fwd(x, scale),
                             rk.rmsnorm_fwd_plain(x, scale),
                             f"rmsnorm_fwd {dt} n={n} d={d} off={offset}",
                             _float_tol("rmsnorm_fwd", dt)[0])
                out.append((str(dt).replace("torch.", ""), err))
    return out


# (B, Hkv, G, Sq, Sk, D, causal, window, q_offset)
FLASH_CASES = (
    (2, 2, 1, 256, 256, 64, True, 0, 0),          # causal, one q head a kv
    (1, 2, 4, 256, 256, 32, True, 0, 0),          # GQA
    (1, 2, 4, 300, 300, 120, True, 128, 0),       # ragged tails, window
    (1, 2, 4, 4096, 4096, 120, True, 128, 0),     # window empties kv tiles
    (1, 1, 4, 4096, 4096, 128, True, 4096, 0),    # window = causal
    (1, 1, 4, 32768, 32768, 120, True, 4096, 0),  # the main path's mask
    (1, 2, 1, 200, 200, 64, False, 0, 0),         # bidirectional
    (1, 2, 4, 100, 170, 120, False, 128, 0),      # window, not causal
    (1, 2, 4, 64, 4160, 120, True, 4096, 4096),   # q_offset, Sq < Sk
    (2, 1, 4, 1, 4097, 120, True, 4096, 4096),    # one decode row
    (1, 2, 1, 17, 17, 32, True, 0, 0),            # Sq < one block
    (1, 1, 4, 10, 20, 64, False, 50, 100),        # rows with no live key
)


def _check_flash(dev):
    """flash_fwd against its plain version, out and lse: f32 within 2e-5
    and 1e-5 (the JAX kernel tests' tolerances); bf16 out within one bf16
    ulp (rtol 2**-7: both round once an f32 value that differs only in the
    last bits) plus atol 1e-4 for outputs near 0, where the f32 sums'
    rounding exceeds an ulp, and lse within 1e-5 (computed in f32 from the
    same inputs).  Returns [(dtype, max abs err)]."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(12)
    out = []
    for dt in (torch.float32, torch.bfloat16):
        tol = _float_tol("flash_fwd", dt)
        for B, Hkv, G, Sq, Sk, D, causal, window, qo in FLASH_CASES:
            if Sq > 4096 and dt == torch.float32:
                continue                      # the main path runs bf16
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                       for shape in ((B * Hkv * G, Sq, D), (B * Hkv, Sk, D),
                                     (B * Hkv, Sk, D)))
            kw = dict(causal=causal, window=window, scale=D ** -0.5,
                      q_offset=qo)
            got, want = fk.flash_fwd(q, k, v, **kw), \
                fk.flash_fwd_plain(q, k, v, **kw)
            what = f"flash_fwd {dt} {(B, Hkv, G, Sq, Sk, D, causal, window, qo)}"
            err = max(_close(got[0], want[0], what + " out", tol[0]),
                      _close(got[1], want[1], what + " lse", tol[1]))
            out.append((str(dt).replace("torch.", ""), err))
    return out


# (B*Hkv, G, Sq, Sk, D, causal, window, q_offset)
FLASH_BWD_CASES = (
    (2, 1, 63, 63, 64, True, 0, 0),               # one tile, G = 1
    (1, 4, 65, 65, 120, True, 0, 0),              # one row past a tile
    (2, 4, 300, 300, 17, True, 128, 0),           # odd D, window
    (1, 4, 4097, 4097, 120, True, 4096, 0),       # the window drops key 0
    (1, 4, 4097, 4097, 120, True, 128, 0),        # q tiles a k tile skips
    (1, 1, 1, 1, 120, True, 0, 0),                # one query, one key
    (1, 4, 1, 4097, 120, True, 4096, 4096),       # one decode row
    (2, 1, 65, 63, 64, False, 0, 0),              # bidirectional, Sq > Sk
    (1, 4, 63, 4097, 17, True, 128, 4034),        # q_offset, window
    (1, 4, 10, 20, 17, False, 8, 20),             # rows 7-9 see no key
)


def _check_flash_bwd(dev):
    """The two flash_bwd kernels against their plain version, dq, dk and
    dv, from the plain forward's lse and delta = sum(out * dout): f32
    within 2e-4 (the JAX kernel tests' tolerance for the gradients); bf16
    within one bf16 ulp of each output's largest magnitude (both sum the
    same bf16 inputs in f32 in another order, then round once: two values
    a few f32 ulps apart round at most one bf16 ulp apart, and no element
    is larger than the largest).  Returns [(dtype, max abs err)]."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(13)
    out = []
    for dt in (torch.float32, torch.bfloat16):
        tol_dq = _float_tol("flash_bwd_dq", dt)[0]
        tol_dkv = _float_tol("flash_bwd_dkv", dt)[0]
        for BHkv, G, Sq, Sk, D, causal, window, qo in FLASH_BWD_CASES:
            q, do = (torch.randn((BHkv * G, Sq, D), generator=gen,
                                 device=dev).to(dt) for _ in range(2))
            k, v = (torch.randn((BHkv, Sk, D), generator=gen,
                                device=dev).to(dt) for _ in range(2))
            kw = dict(causal=causal, window=window, scale=D ** -0.5,
                      q_offset=qo)
            o, lse = fk.flash_fwd_plain(q, k, v, **kw)
            delta = torch.sum(o.float() * do.float(), dim=-1)
            got = fk.flash_bwd(q, k, v, do, lse, delta, **kw)
            want = fk.flash_bwd_plain(q, k, v, do, lse, delta, **kw)
            what = (f"flash_bwd {dt} "
                    f"{(BHkv, G, Sq, Sk, D, causal, window, qo)}")
            err = max(_close(g, w, f"{what} {name}", tol)
                      for g, w, name, tol in zip(
                          got, want, ("dq", "dk", "dv"),
                          (tol_dq, tol_dkv, tol_dkv)))
            out.append((str(dt).replace("torch.", ""), err))
    return out


class Recorder:
    """Wraps the kernel wrappers the backend calls, keeping the inputs of
    the largest call of each (by the work it asks for)."""

    def __init__(self):
        from repro_torch.kernels.dedup_compact import kernel as dk
        from repro_torch.kernels.edge_expand import kernel as ek
        from repro_torch.kernels.knn_topk import kernel as kk
        from repro_torch.kernels.flash_attention import kernel as fk
        from repro_torch.kernels.rmsnorm import kernel as rk
        from repro_torch.kernels.sorted_lookup import kernel as sk
        self.best = {}
        self.mods = {"searchsorted_left_ranged": sk, "expand": ek,
                     "dedup_compact_rows": dk, "sort_rows": dk,
                     "sort_pairs": dk, "knn_topk": kk,
                     "searchsorted_left": sk, "rmsnorm_fwd": rk,
                     "flash_fwd": fk, "flash_bwd_dkv": fk,
                     "flash_bwd_dq": fk}
        self.only = None          # record just these wrappers (None: all)
        self.orig = {n: getattr(m, n) for n, m in self.mods.items()}
        for name, mod in self.mods.items():
            setattr(mod, name, self._wrap(name, self.orig[name]))

    WORK = {"searchsorted_left_ranged":     # the index probe, not a delta
            lambda a, kw: a[0].numel() * a[1].numel(),
            "searchsorted_left": lambda a, kw: a[0].numel() * a[1].numel(),
            "expand": lambda a, kw: kw["cap_tiles"],
            "dedup_compact_rows": lambda a, kw: a[0].numel(),
            "sort_rows": lambda a, kw: a[0].numel(),
            "sort_pairs": lambda a, kw: a[0].numel(),
            "knn_topk": lambda a, kw: a[0].shape[0] * a[1].shape[0],
            "rmsnorm_fwd": lambda a, kw: a[0].numel(),
            "flash_fwd": lambda a, kw: a[0].numel() * a[1].shape[1],
            "flash_bwd_dkv": lambda a, kw: a[0].numel() * a[1].shape[1],
            "flash_bwd_dq": lambda a, kw: a[0].numel() * a[1].shape[1]}

    def _wrap(self, name, fn):
        def rec(*args, **kw):
            if self.only is None or name in self.only:
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


def phase_load(dev, kg_sizes, cfg_kw, reduced=("n_shards 256 -> 1",)):
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
        reduced="; ".join(reduced))
    return kg


def _same(a, b, what):
    """Bit-identical QueryResults (counts, flags, rows)."""
    import numpy as np
    check(a.failed == b.failed, f"{what}: failed")
    for f in ("counts", "failed_q", "rows_gid", "truncated", "deadline_q",
              "shared_ovf_q"):
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


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _serve_line(cell, secs, results, Q, **extra):
    """One SERVE line: throughput, latency and fast-fail share of a cell's
    timed batches, and the mean count of the answered queries."""
    import numpy as np
    ms = np.asarray(secs) * 1e3
    failed = np.concatenate([r.failed_q for r in results])
    counts = np.concatenate([r.counts for r in results])
    say("SERVE", cell=cell, batches=len(secs), queries_per_batch=Q,
        qps=Q * len(secs) / float(np.sum(secs)), p50_ms=float(np.median(ms)),
        p99_ms=float(np.percentile(ms, 99)),
        fast_fail_share=float(failed.mean()),
        mean_count_unfailed=(float(counts[~failed].mean())
                             if (~failed).any() else None), **extra)


def _timed(dev, batches, launches, path, **kw):
    """Run every (cell, db, queries) batch once through ``GraphDB.query``
    on the kernel backend, timed, with the launch counts set to 0 just
    before and read into ``launches[path]`` just after.  Returns
    {cell: [seconds]}, [(cell, queries, result)] and the per-cell peak
    frontier bytes of the batch's budget mode."""
    from repro_torch.core.query import planner
    from repro_torch.kernels import _cuda
    key = ("shared_peak_bytes" if kw.get("budget") == "shared"
           else "per_query_peak_bytes")
    lat, results, peak = {}, [], {}
    _cuda.reset_launches()
    for cell, db, qs in batches:
        planner.reset_stats()
        t0 = time.perf_counter()
        res = db.query(qs, backend="kernel", **kw)
        _sync(dev)
        lat.setdefault(cell, []).append(time.perf_counter() - t0)
        results.append((cell, qs, res))
        peak[cell] = max(peak.get(cell, 0), planner.FRONTIER_STATS[key])
    launches[path] = dict(_cuda.LAUNCHES)
    return lat, results, peak


def phase_serve(kg, dev, n_batches: int, launches, caps_kw=A1_CAPS):
    """The per-query-budget cells: fused batches (the timed main path),
    then the uniform executor and a select batch, each equal to
    ``backend="ref"`` on the same card."""
    import numpy as np
    from repro_torch.core.query.executor import QueryCaps
    db = kg.db
    caps = QueryCaps(**caps_kw)
    rng = np.random.default_rng(1)
    batches = _batches(kg, rng, n_batches, 64)

    # warm-up (first-use allocations), not counted
    db.query(batches[0][1], caps=caps, fused=True, backend="kernel")
    _sync(dev)
    lat, results, peak = _timed(dev, [(c, db, qs) for c, qs in batches],
                                launches, "per_query", caps=caps, fused=True)
    uni = []
    for cell, qs in batches:
        if cell.startswith("mixed") or any(c == cell for c, _, _ in uni):
            continue
        res = db.query(qs, caps=caps, fused=False, backend="kernel")
        uni.append((cell, qs, res))
    sel = [q_select(k) for k in zipf_keys(rng, kg.n_directors, 1_000, 64)]
    sel_f = db.query(sel, caps=caps, fused=True, backend="kernel")
    sel_u = db.query(sel, caps=caps, fused=False, backend="kernel")
    _sync(dev)

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
        _serve_line(cell, ts, [r for c, _, r in results if c == cell], 64,
                    peak_frontier_bytes=peak[cell],
                    tile_buffer_bytes=_tile_buffer_bytes(
                        _firsts(batches)[cell], caps, False))
    say("SERVE_PARITY", fused_batches=len(results), uniform_batches=len(uni),
        select_batches=2, identical_to_ref=True)
    if dev.type == "cuda":
        for cell, qs in _firsts(batches).items():
            phase_profile(db, cell, qs, float(np.median(lat[cell])),
                          caps=caps, fused=True)
    return batches, results, peak


def _tile_buffer_bytes(queries, caps, shared: bool) -> int:
    """Bytes of one direction's expand tile buffers (four int32 pools of
    128-lane tiles) as the planners size them: ``R*(min(F, E) + 1 +
    E/128)`` tiles per-query, ``FS + 1 + ES/128`` shared."""
    from repro_torch.core.query import planner
    R = sum(len(q.get("intersect", (q,))) for q in queries)
    F, E = caps.frontier, caps.expand
    if shared:
        tiles = (planner.shared_budget(R, F) + 1
                 + -(-planner.shared_budget(R, E) // 128))
    else:
        tiles = R * (min(F, E) + 1 + -(-E // 128))
    return tiles * 128 * 4 * 4


def _firsts(batches):
    out = {}
    for cell, qs in batches:
        out.setdefault(cell, qs)
    return out


def _shared_contract(sh, pq, what):
    """Shared mode against per-query mode on one batch: every per-query
    flag is set in shared mode, shared-pool flags are failures, and every
    query flagged in neither mode has the same count."""
    import numpy as np
    check(bool((sh.failed_q | ~pq.failed_q).all()),
          f"{what}: a per-query flag is clear in shared mode")
    check(not (sh.shared_ovf_q & ~sh.failed_q).any(),
          f"{what}: shared_ovf_q outside failed_q")
    ok = ~sh.failed_q
    check(np.array_equal(sh.counts[ok], pq.counts[ok]),
          f"{what}: unflagged counts differ from per-query mode")


def phase_serve_shared(kg, dev, batches, pq_results, pq_peak, launches,
                       caps_kw=A1_CAPS):
    """Phase 5's batches with ``budget="shared"``: each equal to
    ``backend="ref"`` with the same budget, and holding the shared-mode
    contract against the per-query result of the same batch."""
    import numpy as np
    from repro_torch.core.query.executor import QueryCaps
    db = kg.db
    caps = QueryCaps(**caps_kw)
    db.query(batches[0][1], caps=caps, budget="shared", backend="kernel")
    _sync(dev)
    lat, results, peak = _timed(
        dev, [(f"{c}/shared", db, qs) for c, qs in batches], launches,
        "shared", caps=caps, budget="shared")
    for (cell, qs, res), (_, _, pq) in zip(results, pq_results):
        _same(res, db.query(qs, caps=caps, budget="shared", backend="ref"),
              f"shared {cell}")
        _shared_contract(res, pq, cell)
    rs_qs = {c: qs for c, qs, _ in results}
    for cell, ts in lat.items():
        rs = [r for c, _, r in results if c == cell]
        _serve_line(cell, ts, rs, 64, shared_ovf_share=float(
            np.concatenate([r.shared_ovf_q for r in rs]).mean()),
            shared_peak_frontier_bytes=peak[cell],
            per_query_peak_frontier_bytes=pq_peak[cell[:-len("/shared")]],
            shared_tile_buffer_bytes=_tile_buffer_bytes(rs_qs[cell], caps,
                                                        True),
            per_query_tile_buffer_bytes=_tile_buffer_bytes(rs_qs[cell], caps,
                                                           False))
    say("SHARED_PARITY", batches=len(results), identical_to_ref=True,
        contract_held=True)
    if dev.type == "cuda":
        for cell, qs in _firsts(batches).items():
            phase_profile(db, f"{cell}/shared", qs,
                          float(np.median(lat[f"{cell}/shared"])), caps=caps,
                          budget="shared")


def _agree_local(m, loc, what) -> int:
    """A mesh result against the local path's on the same store: every
    query flagged by neither run has the same count, and (where neither
    run truncated it) the same set of select rows; mesh rows come
    shard-major.  Returns how many queries were compared."""
    import numpy as np
    Q = len(m.counts if m.counts is not None else m.rows_gid)

    def flags(r):
        return r.failed_q if r.failed_q is not None else np.full(Q, r.failed)
    ok = ~flags(m) & ~flags(loc)
    if m.counts is not None:
        check(np.array_equal(m.counts[ok], loc.counts[ok]),
              f"{what}: unflagged counts differ from the local path")
    else:
        ok &= ~m.truncated & ~loc.truncated
        for q in np.flatnonzero(ok):
            check(sorted(m.rows_gid[q].tolist())
                  == sorted(loc.rows_gid[q].tolist()),
                  f"{what}: query {q}'s rows differ from the local path")
    return int(ok.sum())


def phase_mesh(kg, dev, n_batches: int, launches, caps_kw=A1_MESH_CAPS):
    """The mesh4 cells: phase 5's batch shapes and key laws through
    ``GraphDB.query(mesh=make_mesh(4))``, per-query (``fused=True``) and
    ``budget="shared"``, timed; then a uniform count batch and a select
    batch.  Every batch equals ``backend="ref"`` on the mesh, shared mode
    holds its contract against per-query mesh mode, and unflagged queries
    agree with the local path on the same 4-shard store."""
    import numpy as np
    import torch
    from repro_torch.core import index
    from repro_torch.core.query.executor import QueryCaps
    from repro_torch.dist.mesh import make_mesh, shard_store
    db = kg.db
    mesh = make_mesh(db.cfg.n_shards, device=dev)
    caps = QueryCaps(**caps_kw)
    sorted_ok = index.blocks_sorted(db.store, db.cfg)
    say("INDEX_SORTED", shards=sorted_ok)
    check(all(sorted_ok), "an index block is not sorted: the binary "
          "searches would not give count(keys < q)")
    if dev.type == "cuda":
        # each lookup wave recomputes a shard's probe keys from its index
        # block, as the reference does
        st = shard_store(db.store, db.cfg, mesh)[0]
        say("MESH_COSTS", ix_h_ms_per_shard=_events_ms(lambda: torch.where(
            st.ix_gid >= 0, index.mix32(st.ix_vtype, st.ix_key), I32MAX)))
    rng = np.random.default_rng(6)
    batches = [(f"mesh4/{c}", qs) for c, qs in _batches(kg, rng, n_batches,
                                                          64)]
    for kw in ({"fused": True}, {"budget": "shared"}):       # warm-up
        db.query(batches[0][1], caps=caps, mesh=mesh, backend="kernel", **kw)
    _sync(dev)
    lat, results, peak = _timed(dev, [(c, db, qs) for c, qs in batches],
                                launches, "mesh", caps=caps, mesh=mesh,
                                fused=True)
    lat_s, results_s, peak_s = _timed(
        dev, [(f"{c}/shared", db, qs) for c, qs in batches], launches,
        "mesh_shared", caps=caps, mesh=mesh, budget="shared")
    q1s = next(qs for c, qs in batches if "serve_q1" in c)
    sel = [q_select(k) for k in zipf_keys(rng, kg.n_directors, 1_000, 64)]
    extra = [("uniform q1", q1s, {"fused": False}),
             ("fused select", sel, {"fused": True}),
             ("uniform select", sel, {"fused": False})]
    extra = [(w, qs, kw, db.query(qs, caps=caps, mesh=mesh,
                                  backend="kernel", **kw))
             for w, qs, kw in extra]
    _sync(dev)

    compared, local_ff = 0, {}
    for (cell, qs, pq), (_, _, sh) in zip(results, results_s):
        _same(pq, db.query(qs, caps=caps, mesh=mesh, fused=True,
                           backend="ref"), cell)
        _same(sh, db.query(qs, caps=caps, mesh=mesh, budget="shared",
                           backend="ref"), f"{cell}/shared")
        _shared_contract(sh, pq, f"{cell}/shared")
        for res, kw, what in ((pq, {"fused": True}, cell),
                              (sh, {"budget": "shared"}, f"{cell}/shared")):
            loc = db.query(qs, caps=caps, backend="kernel", **kw)
            compared += _agree_local(res, loc, what)
            local_ff.setdefault(what, []).append(loc.failed_q)
    for what, qs, kw, res in extra:
        _same(res, db.query(qs, caps=caps, mesh=mesh, backend="ref", **kw),
              f"mesh4 {what}")
        compared += _agree_local(res, db.query(qs, caps=caps,
                                               backend="kernel", **kw),
                                 f"mesh4 {what}")
    # the local path's fast-fail share on the same batches and store
    ff = {c: float(np.concatenate(f).mean()) for c, f in local_ff.items()}
    for cell, ts in lat.items():
        _serve_line(cell, ts, [r for c, _, r in results if c == cell], 64,
                    peak_frontier_bytes=peak[cell],
                    local_path_fast_fail_share=ff[cell])
    for cell, ts in lat_s.items():
        rs = [r for c, _, r in results_s if c == cell]
        _serve_line(cell, ts, rs, 64, shared_ovf_share=float(
            np.concatenate([r.shared_ovf_q for r in rs]).mean()),
            shared_peak_frontier_bytes=peak_s[cell],
            local_path_fast_fail_share=ff[cell])
    say("MESH_PARITY", batches=len(results) + len(results_s) + len(extra),
        identical_to_ref=True, contract_held=True,
        queries_agreeing_with_local_path=compared)
    if dev.type == "cuda":
        for cell, qs in _firsts(batches).items():
            phase_profile(db, cell, qs, float(np.median(lat[cell])),
                          caps=caps, mesh=mesh, fused=True)
            phase_profile(db, f"{cell}/shared", qs,
                          float(np.median(lat_s[f"{cell}/shared"])),
                          caps=caps, mesh=mesh, budget="shared")


def build_doc_store(dev, n_docs: int, d: int, seed: int = 7,
                    n_shards: int = 1):
    """The hybrid vector+graph workload of ``benchmarks/bench_vector.py``
    (``doc`` vertices whose ``d`` f32 attributes are drawn N(0, 1), ``tag``
    vertices, 16 docs a tag, doc i linked to tags i % n_tags and
    (7i + 3) % n_tags), laid out by the port's loader on ``n_shards``
    shards and vector-indexed.  Returns (db, edges, load seconds, backfill
    seconds)."""
    import numpy as np
    from repro_torch.core.addressing import StoreConfig
    from repro_torch.core.catalog import Catalog
    from repro_torch.core.graphdb import GraphDB
    from repro_torch.data.kg import assemble
    t0 = time.perf_counter()
    n_tags = n_docs // 16
    n_v = n_docs + n_tags
    S = n_shards
    per_v = -(-n_v // S)
    # a shard's half-edges: 2 a doc it owns, ~32 a tag it owns
    cap_e = 2 * n_docs if S == 1 else 2 * -(-n_docs // S) + 64
    # index entries route by a hash of (type, key), not by gid: room for
    # the imbalance on several shards
    cfg = StoreConfig(n_shards=S, cap_v=per_v, cap_e=cap_e,
                      cap_delta=16_384, cap_idx=per_v if S == 1 else 2 * per_v,
                      cap_idx_delta=16_384,
                      cap_vec=-(-n_docs // S), d_f32=d, d_i32=2)
    catalog = Catalog()
    catalog.create_tenant("default")
    catalog.create_graph("default", "g")
    fa = tuple(f"f{i}" for i in range(d))
    for name in ("doc", "tag"):
        catalog.create_vertex_type("default", "g", name, fa, ("x", "y"),
                                   max_f_cols=d, max_i_cols=2)
    catalog.create_edge_type("default", "g", "doc.tag")
    rng = np.random.default_rng(seed)
    f = np.zeros((n_v, d), np.float32)
    f[:n_docs] = rng.standard_normal((n_docs, d), np.float32)
    i = np.zeros((n_v, 2), np.int32)
    i[:n_docs, 0] = np.arange(n_docs)
    docs = np.arange(n_docs)
    edges = dict(src=np.repeat(docs, 2),
                 dst=n_docs + np.stack([docs % n_tags,
                                        (7 * docs + 3) % n_tags],
                                       1).reshape(-1))
    edges["etype"] = np.zeros_like(edges["src"])
    store = assemble(cfg, dict(
        gid=np.arange(n_v), vtype=np.repeat([0, 1], [n_docs, n_tags]),
        key=np.concatenate([docs, 10_000 + np.arange(n_tags)]), f=f, i=i),
        edges, 1, dev)
    db = GraphDB(cfg, catalog=catalog, device=dev, store=store)
    db.v_next[:] = np.bincount(np.arange(n_v) % S, minlength=S)
    _sync(dev)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    db.vector_index("doc")
    _sync(dev)
    return db, edges, load_s, time.perf_counter() - t0


def q_near(vec, k=NEAREST_K):
    """``Nearest`` k docs -> doc.tag -> tag count (bench_vector's query)."""
    return {"nearest": {"type": "doc", "vector": [float(x) for x in vec],
                        "k": k},
            "_out_edge": {"type": "doc.tag",
                          "_target": {"type": "tag", "select": "count"}}}


def phase_nearest(dev, sizes, n_batches: int, launches, caps_kw=A1_CAPS):
    """Nearest-rooted batches on the doc store: 64 distinct query vectors
    a batch in both budget modes, and single queries; each batch equal to
    ``backend="ref"`` on the same card."""
    import numpy as np
    import torch
    from repro_torch.core.query.executor import QueryCaps
    db, _, load_s, backfill_s = build_doc_store(dev, **sizes)
    say("LOAD", store="docs", seconds=load_s, backfill_seconds=backfill_s,
        store_bytes=db.store.nbytes(),
        memory_allocated=(torch.cuda.memory_allocated()
                          if dev.type == "cuda" else None),
        docs=sizes["n_docs"], tags=sizes["n_docs"] // 16,
        edges=2 * sizes["n_docs"], vx_count=int(db.vx_count.sum()),
        source="benchmarks/bench_vector.py:24-55, d = a1-kg d_f32")
    caps = QueryCaps(**caps_kw)
    rng = np.random.default_rng(2)
    d = sizes["d"]
    b64 = [[q_near(v) for v in rng.standard_normal((64, d))]
           for _ in range(n_batches)]
    b1 = [[q_near(rng.standard_normal(d))] for _ in range(n_batches)]
    db.query(b64[0], caps=caps, backend="kernel")
    db.query(b64[0], caps=caps, budget="shared", backend="kernel")
    _sync(dev)
    cells = [("nearest_k8/b64", b64, {}),
             ("nearest_k8/b64/shared", b64, {"budget": "shared"}),
             ("nearest_k8/b1", b1, {})]
    runs = {}
    lat_all = {}
    for path_kw in ({}, {"budget": "shared"}):
        todo = [(c, db, qs) for c, bs, kw in cells if kw == path_kw
                for qs in bs]
        path = "nearest" if not path_kw else "nearest_shared"
        lat, results, _ = _timed(dev, todo, launches, path, caps=caps,
                                 **path_kw)
        lat_all.update(lat)
        runs[path] = results
    for cell, bs, kw in cells:
        rs = [(qs, r) for rr in runs.values() for c, qs, r in rr
              if c == cell]
        for qs, res in rs:
            _same(res, db.query(qs, caps=caps, backend="ref", **kw),
                  f"{cell}")
            check(not res.failed_q.any() and bool(
                ((res.counts >= 1) & (res.counts <= 2 * NEAREST_K)).all()),
                  f"{cell}: counts {res.counts.tolist()} outside [1, 16]")
        _serve_line(cell, lat_all[cell], [r for _, r in rs], len(bs[0]))
    say("NEAREST_PARITY", batches=sum(len(bs) for _, bs, _ in cells),
        identical_to_ref=True)
    if dev.type == "cuda":
        for cell, bs, kw in cells:
            phase_profile(db, cell, bs[0], float(np.median(lat_all[cell])),
                          caps=caps, **kw)


OWN_KERNELS = ("searchsorted_left_ranged_kernel", "searchsorted_left_kernel",
               "expand_kernel",
               "dedup_compact_rows_kernel", "sort_rows_kernel",
               "chunk_sort_kernel", "global_step_kernel",
               "chunk_merge_kernel", "knn_chunk_kernel", "knn_merge_kernel",
               "rmsnorm_fwd_kernel", "flash_fwd_kernel",
               "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")


def phase_profile(db, cell, qs, p50_s, **kw):
    """Device busy time and kernel launches of one fused batch (profiler):
    see :func:`_profile`."""
    _profile(cell, lambda: db.query(qs, backend="kernel", **kw), p50_s)


def _profile(cell, fn, p50_s, **extra):
    """Device busy time and kernel launches of one call of ``fn``
    (profiler): the share of it in the port's own kernels, and the busy
    time against the profiled call's wall time and the unprofiled p50
    latency.  The whole table goes to ``profile_<cell>.txt`` in the output
    directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
             for e in top], **extra)


# ---------------------------------------------------------------------------
# the LM serving path: h2o-danube-3-4b
# ---------------------------------------------------------------------------

def _lm_weights(cfg, dev, seed: int):
    """Weights by the JAX init law from a fixed generator on ``dev``, then
    ``embed`` <- N(0, 1) and the ln scales <- 1 + 0.1 N(0, 1).  The law
    gives ``embed`` all ones (its rule for leaves whose last axis is
    d_model), under which the output does not depend on the tokens: a wrong
    embedding gather, or any prompt, would pass every check below."""
    import torch
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = T.init_params(cfg, gen, device=dev)
    p["embed"] = torch.randn(p["embed"].shape, generator=gen,
                             device=dev).to(cfg.dtype)
    for t in [p["ln_f"]] + [b[n] for b in p["blocks"] for n in ("ln1",
                                                                 "ln2")]:
        t.copy_(1 + 0.1 * torch.randn(t.shape, generator=gen, device=dev))
    return p


def _lm_tokens(cfg, dev, batch: int, seq: int, seed: int):
    import numpy as np
    import torch
    from repro_torch.data.tokens import _synth_batch
    return torch.as_tensor(_synth_batch(np.random.default_rng(seed), batch,
                                        seq, cfg.vocab), device=dev)


def _rel_err(a, b) -> float:
    """max |a - b| / max |b| (NaN if either has a non-finite value)."""
    import torch
    if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
        return float("nan")
    return float((a - b).abs().max() / b.abs().max())


def _same_argmax(a, b, tol_abs: float, what: str) -> int:
    """Row by row, the same argmax, or a tie within ``tol_abs`` in both
    (two logits that close are as likely to swap under a bf16 rounding).
    Returns the rows whose argmax differs."""
    import torch
    ia, ib = a.argmax(-1), b.argmax(-1)
    rows = torch.arange(a.shape[0], device=a.device)
    diff = ia != ib
    gap = torch.maximum((a[rows, ia] - a[rows, ib]).abs(),
                        (b[rows, ia] - b[rows, ib]).abs())
    check(not bool((diff & (gap > tol_abs)).any()),
          f"{what}: argmax differs beyond a tie within {tol_abs}")
    return int(diff.sum())


def _lm_launch_check(launches, path, want: dict, calls: int, dev):
    if dev.type != "cuda":
        return
    for name, n in want.items():
        check(launches[path][name] == n * calls,
              f"{path}: {name} launched {launches[path][name]} times in "
              f"{calls} calls, not {n} a call")


def phase_lm_f32(dev, cfg, sizes):
    """``lm/check_f32``: the full-width model in float32, ``forward`` over
    more positions than the window on the kernel path against
    ``backend="ref"``; then
    ``lm/decode_consistency``: every decode step from an empty cache against
    ``forward`` at that position, and a 2-layer model whose window-sized
    ring wraps."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as T
    check(sizes["f32_seq"] > cfg.window, "lm/check_f32 inside the window")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p = _lm_weights(cfg32, dev, 0)
    toks = _lm_tokens(cfg, dev, 1, sizes["f32_seq"], 10)
    t0 = time.perf_counter()
    lk, _ = T.forward(p, cfg32, toks, backend="kernel")
    _sync(dev)
    k_s = time.perf_counter() - t0
    lr, _ = T.forward(p, cfg32, toks, backend="ref")
    err = _rel_err(lk, lr)
    check(err <= LM_F32_TOL, f"lm/check_f32: kernel vs ref {err}")
    check(lk.shape == (1, sizes["f32_seq"], cfg.vocab), "lm/check_f32 shape")
    other, _ = T.prefill(p, cfg32, _lm_tokens(cfg, dev, 1,
                                              sizes["f32_seq"], 11))
    moved = float((other - lk[:, -1]).abs().max())
    check(moved > 1e-2, "lm/check_f32: another prompt, the same logits")
    say("LM_CHECK", cell="lm/check_f32", dtype="float32", batch=1,
        seq=sizes["f32_seq"], layers=cfg.n_layers, rel_err=err,
        tolerance=LM_F32_TOL, forward_kernel_s=k_s,
        other_prompt_max_abs_diff=moved)
    del lk, lr, other

    B, n = sizes["consist"]
    toks = _lm_tokens(cfg, dev, B, n, 12)
    full, _ = T.forward(p, cfg32, toks)
    cache = T.init_kv_cache(cfg32, B, n, device=dev)
    worst = 0.0
    for t in range(n):
        lg, cache = T.decode_step(p, cfg32, toks[:, t:t + 1], cache, t)
        worst = max(worst, _rel_err(lg, full[:, t]))
    check(worst <= LM_F32_TOL, f"lm/decode_consistency: {worst}")
    del p, full, cache
    layers, window, steps = sizes["ring"]
    cfg_r = dataclasses.replace(cfg32, n_layers=layers, window=window)
    p = _lm_weights(cfg_r, dev, 1)
    toks = _lm_tokens(cfg, dev, B, steps, 13)
    full, _ = T.forward(p, cfg_r, toks)
    cache = T.init_kv_cache(cfg_r, B, steps, device=dev)
    check(cache[0][0].shape[3] == window, "ring: cache is not window-sized")
    ring = 0.0
    for t in range(steps):
        lg, cache = T.decode_step(p, cfg_r, toks[:, t:t + 1], cache, t)
        ring = max(ring, _rel_err(lg, full[:, t]))
    check(ring <= LM_F32_TOL, f"lm/decode_consistency ring: {ring}")
    say("LM_CHECK", cell="lm/decode_consistency", dtype="float32", batch=B,
        steps=n, rel_err=worst, ring=dict(layers=layers, window=window,
                                          steps=steps, rel_err=ring),
        tolerance=LM_F32_TOL)
    del p, full, cache
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _attn_flops(cfg, batch: int, seq: int) -> float:
    """4 * Hq * D flops a live (query, key) pair, every layer."""
    live = _live_pairs(seq, seq, True, cfg.window, 0)
    return 4.0 * cfg.n_heads * cfg.d_head * live * batch * cfg.n_layers


def phase_lm_prefill(dev, cfg, p, sizes, launches, rec):
    """``lm/prefill_32k``: the cell's 32,768 tokens in bf16, timed over 3
    calls after a warm one, launches counted, then against
    ``backend="ref"`` on the same prompts."""
    import numpy as np
    from repro_torch.configs.h2o_danube_3_4b import SHAPES
    from repro_torch.configs.registry import cell
    from repro_torch.kernels import _cuda
    from repro_torch.models import transformer as T
    geo = cell(SHAPES, "prefill_32k").geometry
    B, S = sizes["prefill_batch"], sizes.get("seq", geo["seq_len"])
    toks = _lm_tokens(cfg, dev, B, S, 14)
    T.prefill(p, cfg, toks)
    _sync(dev)
    _cuda.reset_launches()
    rec.only = set(LM_KERNELS)
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        lk, _ = T.prefill(p, cfg, toks)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
    rec.only = set()
    launches["lm_prefill"] = dict(_cuda.LAUNCHES)
    _lm_launch_check(launches, "lm_prefill", {
        "rmsnorm_fwd": 2 * cfg.n_layers + 1, "flash_fwd": cfg.n_layers}, 3,
        dev)
    lr, _ = T.prefill(p, cfg, toks, backend="ref")
    err = _rel_err(lk, lr)
    check(lk.shape == (B, cfg.vocab) and err <= LM_BF16_TOL,
          f"lm/prefill_32k: kernel vs ref {err}")
    swapped = _same_argmax(lk, lr, LM_BF16_TOL * float(lr.abs().max()),
                           "lm/prefill_32k")
    p50 = float(np.median(secs))
    flops = 2.0 * cfg.n_active_params() * B * S + _attn_flops(cfg, B, S)
    reduced = [] if B == geo["global_batch"] else \
        [f"global_batch {geo['global_batch']} -> {B}"]
    say("LM_SERVE", cell="lm/prefill_32k", dtype=str(cfg.dtype), batch=B,
        seq=S, reduced=reduced, p50_ms=p50 * 1e3,
        ms=[x * 1e3 for x in secs], tokens_per_s=B * S / p50,
        launches_per_call={k: launches["lm_prefill"][k] / 3
                           for k in LM_KERNELS},
        flops=flops, bf16_peak_share=flops / p50 / BF16_OPS_PER_S,
        rel_err_vs_ref=err, tolerance=LM_BF16_TOL,
        argmax_ties_swapped=swapped)
    if dev.type == "cuda":
        _profile("lm_prefill_32k", lambda: T.prefill(p, cfg, toks), p50)


def phase_lm_decode(dev, cfg, p, sizes, launches):
    """``lm/decode_32k``: the cell's batch (halved until the cache fits)
    over a full ring cache (4,096 slots filled from a generator, as after
    32,768 tokens), 16 greedy steps timed after a warm one, launches
    counted, then one step against ``backend="ref"``."""
    import numpy as np
    import torch
    from repro_torch.configs.h2o_danube_3_4b import SHAPES
    from repro_torch.configs.registry import cell
    from repro_torch.kernels import _cuda
    from repro_torch.models import transformer as T
    geo = cell(SHAPES, "decode_32k").geometry
    B, S = sizes.get("decode_batch", geo["global_batch"]), \
        sizes.get("seq", geo["seq_len"])
    Sc = T.cache_len(cfg, S)
    per_seq = 2 * cfg.n_layers * cfg.n_kv_heads * Sc * cfg.d_head * 2
    # the f32 copies of one layer's k and v in the decode attention
    temp = 2 * cfg.n_kv_heads * Sc * cfg.d_head * 4
    if dev.type == "cuda":
        free = torch.cuda.mem_get_info()[0] - (4 << 30)
        while B > 1 and B * (per_seq + temp) > free:
            B //= 2
    cache = T.init_kv_cache(cfg, B, S, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    for k, v in cache:
        k.normal_(generator=gen)
        v.normal_(generator=gen)
    pos = S - 1
    tok = _lm_tokens(cfg, dev, B, 1, 15)
    lg, cache = T.decode_step(p, cfg, tok, cache, pos)
    tok = lg.argmax(-1, keepdim=True)
    _sync(dev)
    _cuda.reset_launches()
    secs = []
    for _ in range(sizes["decode_steps"]):
        pos += 1
        t0 = time.perf_counter()
        lg, cache = T.decode_step(p, cfg, tok, cache, pos)
        tok = lg.argmax(-1, keepdim=True)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
    launches["lm_decode"] = dict(_cuda.LAUNCHES)
    _lm_launch_check(launches, "lm_decode", {
        "rmsnorm_fwd": 2 * cfg.n_layers + 1, "flash_fwd": 0},
        sizes["decode_steps"], dev)
    pos += 1
    lk, cache = T.decode_step(p, cfg, tok, cache, pos)
    lr, cache = T.decode_step(p, cfg, tok, cache, pos, backend="ref")
    err = _rel_err(lk, lr)
    check(lk.shape == (B, cfg.vocab) and err <= LM_BF16_TOL,
          f"lm/decode_32k: kernel vs ref {err}")
    swapped = _same_argmax(lk, lr, LM_BF16_TOL * float(lr.abs().max()),
                           "lm/decode_32k")
    p50 = float(np.median(secs))
    cache_bytes = B * per_seq
    weight_bytes = cfg.n_params() * 2
    bound_s = (cache_bytes + weight_bytes) / HBM_BYTES_PER_S
    reduced = [] if B == geo["global_batch"] else \
        [f"global_batch {geo['global_batch']} -> {B}"]
    say("LM_SERVE", cell="lm/decode_32k", dtype=str(cfg.dtype), batch=B,
        cache_slots=Sc, start_pos=S - 1, steps=len(secs), reduced=reduced,
        p50_ms=p50 * 1e3, ms=[x * 1e3 for x in secs],
        tokens_per_s=B / p50, cache_bytes=cache_bytes,
        weight_bytes=weight_bytes, bytes_bound_ms=bound_s * 1e3,
        bytes_bound_share=bound_s / p50, rel_err_vs_ref=err,
        tolerance=LM_BF16_TOL, argmax_ties_swapped=swapped,
        memory_allocated=(torch.cuda.memory_allocated()
                          if dev.type == "cuda" else None))
    if dev.type == "cuda":
        _profile("lm_decode_32k",
                 lambda: T.decode_step(p, cfg, tok, cache, pos + 1), p50)
    del cache


def phase_lm(dev, cfg, sizes, launches, rec):
    """Phase 9: the f32 checks, then prefill and decode in the config's
    bf16 (the f32 weights are freed before the bf16 ones are made)."""
    import torch
    t0 = time.perf_counter()
    phase_lm_f32(dev, cfg, sizes)
    p = _lm_weights(cfg, dev, 4)
    phase_lm_prefill(dev, cfg, p, sizes, launches, rec)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    phase_lm_decode(dev, cfg, p, sizes, launches)
    del p
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    say("LM_PHASE", seconds=time.perf_counter() - t0, config=cfg.name,
        source="src/repro/configs/h2o_danube_3_4b.py")


# ---------------------------------------------------------------------------
# the LM training path: h2o-danube-3-4b's train_4k
# ---------------------------------------------------------------------------

def _slices(t):
    return t.unbind(0) if t.dim() >= 3 else (t,)


def _cosine(a, b) -> float:
    """Cosine similarity of two gradient leaves, in float32 a layer at a
    time (no whole-leaf float32 copy)."""
    import torch
    dot = na = nb = torch.zeros((), device=a.device)
    for x, y in zip(_slices(a), _slices(b)):
        x, y = x.float(), y.float()
        dot, na, nb = dot + (x * y).sum(), na + (x * x).sum(), \
            nb + (y * y).sum()
    return float(dot / torch.sqrt(na * nb).clamp(min=1e-30))


def _grad_leaves(grads):
    from repro_torch.models import transformer as T
    return [(".".join(map(str, path)), g) for path, g in T.leaves(grads)]


def phase_lm_train_check(dev, cfg, sizes):
    """``lm/train_check_f32``: FULL's widths cut to ``check_layers`` layers
    in float32, one sequence past the window: ``loss_fn``'s loss and every
    gradient leaf on the kernel path against ``backend="ref"`` (with remat,
    which bounds the reference attention's saved scores to one layer), and
    the kernel path with remat against without."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as T
    cfg32 = dataclasses.replace(
        cfg, dtype=torch.float32,
        n_layers=min(sizes["check_layers"], cfg.n_layers))
    p = _lm_weights(cfg32, dev, 5)
    toks = _lm_tokens(cfg, dev, 1, sizes["f32_seq"] + 1, 16)
    tokens, targets = toks[:, :-1], toks[:, 1:]
    runs, secs = {}, {}
    for name, remat, be in (("kernel", False, "kernel"),
                            ("kernel_remat", True, "kernel"),
                            ("ref", True, "ref")):
        t0 = time.perf_counter()
        (loss, _), g = T.value_and_grad(
            p, dataclasses.replace(cfg32, remat=remat), tokens, targets,
            backend=be)
        _sync(dev)
        secs[name] = time.perf_counter() - t0
        runs[name] = (loss, _grad_leaves(g))
        del g
    (lk, gk), (lr, gr) = runs["kernel_remat"], runs["ref"]
    loss_err = abs(float(lk) - float(lr)) / abs(float(lr))
    errs = {n: _rel_err(a, b) for (n, a), (_, b) in zip(gk, gr)}
    remat = max(_rel_err(a, b) for (_, a), (_, b) in
                zip(gk, runs["kernel"][1]))
    worst = max(errs.values())
    check(loss_err <= LM_F32_TOL and worst <= LM_F32_TOL,
          f"lm/train_check_f32: kernel vs ref loss {loss_err}, "
          f"gradients {errs}")
    check(remat <= REMAT_TOL, f"lm/train_check_f32: remat vs none {remat}")
    check(all(bool(torch.isfinite(g).all()) for _, g in gk),
          "lm/train_check_f32: non-finite gradient")
    say("LM_CHECK", cell="lm/train_check_f32", dtype="float32", batch=1,
        seq=sizes["f32_seq"], layers=cfg32.n_layers, loss=float(lk),
        loss_rel_err=loss_err, grad_rel_err_max=worst,
        grad_rel_err=errs, remat_vs_none_rel_err=remat,
        tolerance=LM_F32_TOL, remat_tolerance=REMAT_TOL, seconds=secs)
    del p, runs, gk, gr
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def phase_lm_train(dev, cfg, sizes, launches, rec):
    """Phase 9b.  ``lm/train_4k``: the cell's 4,096-token sequences at full
    width and depth in bf16 with the optimizer ``pick_opt`` gives (AdamW,
    float32 moments), ``train_batch`` sequences a step from
    ``token_pipeline``.  Check 1: the first step's loss, gradient norm and
    gradients on the kernel path against ``backend="ref"``.  Check 2: 2
    warm-up steps, then timed steps on the same batch (launches counted),
    the loss falling from the first step to the last."""
    import numpy as np
    import torch
    from repro_torch.configs.h2o_danube_3_4b import SHAPES
    from repro_torch.configs.registry import cell
    from repro_torch.data.tokens import token_pipeline
    from repro_torch.kernels import _cuda
    from repro_torch.launch.steps import (lm_train_step, pick_opt,
                                          train_geometry)
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import (AdamWConfig, global_norm,
                                              init_opt_state)
    t_phase = time.perf_counter()
    held = None
    if dev.type == "cuda":
        # phase 9's weights and 48 GB cache are gone; what stays is the
        # recorder's main-path kernel inputs (~2 GB)
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        check(held < 8 << 30, f"lm_train: {held} bytes still held")
    phase_lm_train_check(dev, cfg, sizes)

    c = cell(SHAPES, "train_4k")
    accum, mb, S = train_geometry(c)
    B, S = sizes["train_batch"], sizes.get("train_seq", S)
    check(accum == 1, f"train_4k: accum {accum}")
    p = _lm_weights(cfg, dev, 6)
    pipe = token_pipeline(batch=B, seq=S, vocab=cfg.vocab, seed=17,
                          device=dev)
    tokens, targets = (t[None] for t in next(pipe))   # (accum, B, S)
    pipe.close()

    # check 1: the first step's gradients, kernel path against ref
    first = {}
    for be in ("kernel", "ref"):
        t0 = time.perf_counter()
        (loss, _), g = T.value_and_grad(p, cfg, tokens[0], targets[0],
                                        backend=be)
        first[be] = (float(loss), float(global_norm(g)), _grad_leaves(g),
                     time.perf_counter() - t0)
        del g
    (lk, nk, gk, _), (lr, nr, gr, _) = first["kernel"], first["ref"]
    cos = {n: _cosine(a, b) for (n, a), (_, b) in zip(gk, gr)}
    loss_err, gnorm_err = abs(lk - lr) / abs(lr), abs(nk - nr) / nr
    check(loss_err <= TRAIN_LOSS_TOL and gnorm_err <= TRAIN_GNORM_TOL
          and min(cos.values()) >= TRAIN_MIN_COSINE,
          f"lm/train_4k first step: loss {lk} vs {lr}, gnorm {nk} vs {nr}, "
          f"cosines {cos}")
    check(all(np.isfinite([lk, nk])), "lm/train_4k: non-finite first step")
    del gk, gr
    for be in first:
        first[be] = first[be][:2] + first[be][3:]
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ocfg = pick_opt(cfg.n_params())
    check(dev.type != "cuda" or ocfg == AdamWConfig(),
          f"train_4k: optimizer {ocfg}")
    state = init_opt_state(p, ocfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, gnorms, secs = [], [], []

    def step():
        nonlocal p, state
        p, state, m = lm_train_step(p, state, tokens, targets, cfg, ocfg)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    for _ in range(sizes["warm_steps"]):
        step()
    _sync(dev)
    _cuda.reset_launches()
    rec.only = {"flash_bwd_dkv", "flash_bwd_dq"}
    for _ in range(sizes["timed_steps"]):
        t0 = time.perf_counter()
        step()
        _sync(dev)
        secs.append(time.perf_counter() - t0)
    rec.only = set()
    launches["lm_train"] = dict(_cuda.LAUNCHES)
    L = cfg.n_layers
    _lm_launch_check(launches, "lm_train", {
        "rmsnorm_fwd": 4 * L + 1, "flash_fwd": 2 * L, "flash_bwd_dkv": L,
        "flash_bwd_dq": L}, sizes["timed_steps"], dev)
    check(all(np.isfinite(losses + gnorms)), f"lm/train_4k: {losses}")
    check(losses[-1] < losses[0],
          f"lm/train_4k: the loss did not fall: {losses}")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    p50 = float(np.median(secs))
    live = _live_pairs(S, S, True, cfg.window, 0)
    flops = 6.0 * cfg.n_active_params() * B * S \
        + 18.0 * cfg.d_head * live * cfg.n_heads * L * B
    say("LM_TRAIN", cell="lm/train_4k", dtype=str(cfg.dtype), batch=B,
        seq=S, layers=L, reduced=[f"global_batch "
                                  f"{c.geometry['global_batch']} -> {B}"],
        optimizer=str(ocfg), p50_ms=p50 * 1e3, ms=[x * 1e3 for x in secs],
        tokens_per_s=B * S / p50, flops=flops,
        bf16_peak_share=flops / p50 / BF16_OPS_PER_S,
        peak_memory_allocated=peak, held_before=held, losses=losses,
        gnorms=gnorms,
        launches_per_step={k: launches["lm_train"][k] / len(secs)
                           for k in LM_KERNELS},
        first_step=dict(kernel=first["kernel"], ref=first["ref"],
                        loss_rel_err=loss_err, gnorm_rel_err=gnorm_err,
                        min_cosine=min(cos.values()), cosine=cos,
                        tolerance=dict(loss=TRAIN_LOSS_TOL,
                                       gnorm=TRAIN_GNORM_TOL,
                                       min_cosine=TRAIN_MIN_COSINE)))
    if dev.type == "cuda":
        _profile("lm_train_4k", step, p50)
    del p, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    say("LM_TRAIN_PHASE", seconds=time.perf_counter() - t_phase,
        config=cfg.name, source="src/repro/configs/h2o_danube_3_4b.py")


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
    sh = db.query([q1(d) for d in dids] + [q2(d) for d in dids]
                  + [q3(d, a) for d, a in zip(dids, aids)], caps=caps,
                  budget="shared", backend="kernel")
    check(not sh.failed_q.any() and sh.counts.tolist() == want,
          f"small store, budget=shared: counts {sh.counts.tolist()}")
    n_near = _small_nearest_reference(dev)
    say("SMALL_REFERENCE", queries=2 * len(want) + n_near, equal=True)


def _small_nearest_reference(dev) -> int:
    """Small doc stores: Nearest -> doc.tag counts in both budget modes, on
    one shard and through a 4-shard mesh (equal to ``backend="ref"`` there
    too), against numpy, which sums the distances in the port's order
    (float32, each multiply and add rounded on its own) and takes the k
    smallest by (dist, gid)."""
    import numpy as np
    from repro_torch.dist.mesh import make_mesh
    vecs = np.random.default_rng(9).standard_normal((16, 32), np.float32)
    n = 0
    for n_shards in (1, 4):
        db, edges, _, _ = build_doc_store(dev, n_docs=3_000, d=32, seed=5,
                                          n_shards=n_shards)
        gid = db.store.vx_gid.cpu().numpy()
        emb = db.store.vx_emb.cpu().numpy()[gid >= 0]
        gid = gid[gid >= 0]
        tags_of = {}
        for s_, t_ in zip(edges["src"].tolist(), edges["dst"].tolist()):
            tags_of.setdefault(s_, set()).add(t_)
        want = []
        for v in vecs:
            ee = np.zeros(emb.shape[0], np.float32)
            ip = np.zeros(emb.shape[0], np.float32)
            for d in range(emb.shape[1]):
                ee = ee + emb[:, d] * emb[:, d]
                ip = ip + v[d] * emb[:, d]
            dist = (ee - np.float32(2.0) * ip) + np.float32(0.0)
            top = np.lexsort((gid, dist))[:NEAREST_K]
            want.append(len(set().union(*(tags_of[int(gid[j])]
                                          for j in top))))
        kw = {} if n_shards == 1 else {"mesh": make_mesh(n_shards, dev)}
        for budget in ("per-query", "shared"):
            qs = [q_near(v) for v in vecs]
            res = db.query(qs, budget=budget, backend="kernel", **kw)
            check(res.counts.tolist() == want,
                  f"small nearest, {n_shards} shard(s), budget={budget}: "
                  f"{res.counts.tolist()} != {want}")
            if kw:
                _same(res, db.query(qs, budget=budget, backend="ref", **kw),
                      f"small nearest mesh, budget={budget}")
            n += len(want)
    return n


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


def _device_ms(fn, n: int = 10) -> float:
    """Device time per call: CUDA events recorded just before and just
    after each of ``n`` calls, so the host's gaps between calls (which
    ``ms`` includes when a call is shorter than its launch) are left out."""
    import torch
    fn()
    torch.cuda.synchronize()
    marks = [tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
             for _ in range(n)]
    for a, b in marks:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks) / n


def _device_events(prof):
    """The profiler's device-side entries (kernels, memsets, copies); an
    operator's own entry repeats its kernels' time, so it is left out."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and (e.self_device_time_total or 0) > 0]


def _bound(name, args, kw):
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
    elif name == "searchsorted_left":
        # the same count as the ranged probe's: the keys a binary search
        # must read (one a halving), the queries in, the positions out
        keys, q = args
        probes = q.shape[0] * int(keys.shape[0]).bit_length()
        nbytes, ops = 8 * q.shape[0] + 4 * probes, probes
    elif name == "expand":
        starts, degs, pools = args[0], args[1], args[2]
        item, tw, cap_tiles = args[3], args[4], kw["cap_tiles"]
        F = degs.shape[0]
        rem = degs[item.clamp(max=F - 1)] - tw * 128
        lanes = int(rem.clamp(0, 128)[item < F].sum())
        nbytes = (8 * starts.shape[0] + 8 * cap_tiles
                  + len(pools) * 4 * (cap_tiles * 128 + lanes))
        ops = 0
    elif name == "sort_pairs":
        W = args[0].shape[0]
        nbytes = 16 * W                    # two i32 keys in, two out
        ops = W * max(1, math.ceil(math.log2(max(W, 2))))
    elif name == "knn_topk":
        vecs, emb, k = args[0], args[1], args[8]
        (R, D), N = vecs.shape, emb.shape[0]
        # the index (emb + four i32 columns) and the rows read once, the
        # (R, k) distances and gids written once; a multiply and an add
        # for every (row, entry, dim)
        nbytes = 4 * N * D + 16 * N + 4 * R * D + 8 * R + 8 * R * k
        ops = 2 * R * N * D
    elif name == "rmsnorm_fwd":
        # x read and y written once, the scale once; ~4 flops an element
        x = args[0]
        nbytes = (2 * x.numel() + x.shape[-1]) * x.element_size()
        ops = 4 * x.numel()
    elif name == "flash_fwd":
        # q, k, v read and out written once, lse written; 4*D flops a live
        # (query, key) pair at the bf16 tensor-core rate
        q, k, _ = args
        BHq, Sq, D = q.shape
        live = _live_pairs(Sq, k.shape[1], kw["causal"], kw["window"],
                           kw["q_offset"])
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
            + 4 * BHq * Sq
        t_ops = 4.0 * D * BHq * live / BF16_OPS_PER_S
        t_bytes = nbytes / HBM_BYTES_PER_S
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")
    elif name in ("flash_bwd_dkv", "flash_bwd_dq"):
        # q, k, v, dout, lse and delta read once, dk and dv (or dq)
        # written once; a live pair costs 8*D flops for dk and dv (s, dp,
        # p^T dout, ds^T q) and 6*D for dq (s, dp, ds k) at the bf16
        # tensor-core rate
        q, k = args[0], args[1]
        BHq, Sq, D = q.shape
        live = _live_pairs(Sq, k.shape[1], kw["causal"], kw["window"],
                           kw["q_offset"])
        out = 2 * k.numel() if name == "flash_bwd_dkv" else q.numel()
        nbytes = (2 * q.numel() + 2 * k.numel() + out) * q.element_size() \
            + 8 * BHq * Sq
        per_pair = 8.0 if name == "flash_bwd_dkv" else 6.0
        t_ops = per_pair * D * BHq * live / BF16_OPS_PER_S
        t_bytes = nbytes / HBM_BYTES_PER_S
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")
    else:
        x = args[0]
        R, W = x.shape
        cap = args[1] if name == "dedup_compact_rows" else W
        nbytes = 4 * R * W + 4 * R * cap + (4 * R if cap != W else 0)
        ops = R * W * max(1, math.ceil(math.log2(max(W, 2))))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _live_pairs(Sq, Sk, causal, window, q_offset) -> int:
    """(query, key) pairs a head that the mask leaves live."""
    import numpy as np
    qp = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(qp, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qp - window + 1, 0) if window > 0 else np.zeros(Sq)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _bits(ts):
    """Float tensors as their int32 bits (exact comparison, -0.0 != 0.0)."""
    import torch
    return tuple(t.view(torch.int32) if t.is_floating_point() else t
                 for t in ts)


def _library_call(name, args, kw):
    """(label, ms) of one PyTorch call computing the same function on the
    same inputs, or None.  The flash_bwd kernels' is SDPA's backward."""
    import torch
    from repro_torch.kernels.dedup_compact import ref as dref
    if name in ("flash_bwd_dkv", "flash_bwd_dq"):
        return _sdpa_bwd(args, kw)
    lib = None
    if name == "sort_rows":
        lib = "torch.sort", lambda: torch.sort(args[0], dim=1)
    if name == "sort_pairs":
        packed = dref.pack_pairs(*args)
        lib = "torch.sort of the packed int64", lambda: torch.sort(packed)
    if name == "searchsorted_left":
        lib = "torch.searchsorted", lambda: torch.searchsorted(
            args[0], args[1], out_int32=True)
    if name == "searchsorted_left_ranged":
        keys, q, lo, hi = args
        if bool((lo == lo[0]).all()) and bool((hi == hi[0]).all()):
            blk = keys[int(lo[0]):int(hi[0])]
            lib = "torch.searchsorted, one block", lambda: \
                torch.searchsorted(blk, q, out_int32=True)
    if name == "rmsnorm_fwd" and hasattr(torch.nn.functional, "rms_norm"):
        x, scale = args
        lib = "F.rms_norm", lambda: torch.nn.functional.rms_norm(
            x, (x.shape[-1],), scale, kw.get("eps", 1e-6))
    if name == "flash_fwd":
        lib = _sdpa_call(args, kw)
    return (lib[0], _events_ms(lib[1])) if lib else None


def _sdpa_call(args, kw, rows=None):
    """F.scaled_dot_product_attention on flash_fwd's inputs (the first
    ``rows`` positions, with ``is_causal`` there when the window covers
    them; else the boolean mask), on a fused backend (flash or
    memory-efficient: the math backend would hold every score), with
    ``enable_gqa``, or with k and v repeated over the group where the
    backend does not take it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention.ref import attention_mask
    q, k, v = args
    BHkv, Sk, D = k.shape
    G = q.shape[0] // BHkv
    if rows:
        q, k, v = (t[:, :rows] for t in (q, k, v))
        Sk = rows
    q4, k4, v4 = (t.reshape(1, -1, t.shape[1], D) for t in (q, k, v))
    causal_only = rows and kw["causal"] and kw["window"] >= Sk and \
        kw["q_offset"] == 0
    mask = None if causal_only else attention_mask(
        q.shape[1], Sk, causal=kw["causal"], window=kw["window"],
        q_offset=kw["q_offset"], device=q.device)
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]

    def call(kk, vv, **gqa):
        with sdpa_kernel(backends):
            return F.scaled_dot_product_attention(
                q4, kk, vv, attn_mask=mask, is_causal=bool(causal_only),
                scale=kw["scale"], **gqa)
    try:
        call(k4, v4, enable_gqa=True)
        label = "sdpa enable_gqa"
        fn = lambda: call(k4, v4, enable_gqa=True)       # noqa: E731
    except RuntimeError:
        kr, vr = (t.repeat_interleave(G, dim=1) for t in (k4, v4))
        label = "sdpa, k and v repeated"
        fn = lambda: call(kr, vr)                       # noqa: E731
    return (f"{label}, {'is_causal' if causal_only else 'bool mask'}, "
            f"{q.shape[1]} rows"), fn


def _sdpa_bwd(args, kw):
    """(label, ms) of the backward of F.scaled_dot_product_attention on
    flash_bwd's inputs (fused backends, ``is_causal``, ``enable_gqa`` or k
    and v repeated over the group), timed as forward plus backward minus
    forward; None unless the mask is the plain causal one (the window
    covers every position and no offset), where SDPA computes the same
    function."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q, k, v, do = args[:4]
    BHq, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    if not (kw["causal"] and kw["q_offset"] == 0 and Sq == Sk
            and (kw["window"] <= 0 or kw["window"] >= Sk)):
        return None
    q4, k4, v4 = (t.detach().reshape(1, -1, t.shape[1], D).requires_grad_()
                  for t in (q, k, v))
    do4 = do.reshape(1, BHq, Sq, D)
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]

    def fwd(kk, vv, **gqa):
        with sdpa_kernel(backends):
            return F.scaled_dot_product_attention(
                q4, kk, vv, is_causal=True, scale=kw["scale"], **gqa)
    try:
        fwd(k4, v4, enable_gqa=True)
        label, f = "sdpa enable_gqa", lambda: fwd(k4, v4, enable_gqa=True)
    except RuntimeError:
        G = BHq // BHkv
        label = "sdpa, k and v repeated"
        f = lambda: fwd(*(t.repeat_interleave(G, dim=1)   # noqa: E731
                          for t in (k4, v4)))
    with torch.enable_grad():
        f_ms = _events_ms(f)
        fb_ms = _events_ms(lambda: torch.autograd.grad(f(), (q4, k4, v4),
                                                       do4))
    return (f"{label}, is_causal, {Sq} rows: backward (forward + backward "
            f"{fb_ms} ms minus forward {f_ms} ms), dq, dk and dv together"), \
        fb_ms - f_ms


def phase_kernel_report(launches, best):
    import torch
    from repro_torch.kernels.dedup_compact import kernel as dk
    from repro_torch.kernels.edge_expand import kernel as ek
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.knn_topk import kernel as kk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.sorted_lookup import kernel as sk
    fns = {"searchsorted_left_ranged": (sk.searchsorted_left_ranged,
                                        sk.searchsorted_left_ranged_plain),
           "searchsorted_left": (sk.searchsorted_left,
                                 sk.searchsorted_left_plain),
           "expand": (ek.expand, ek.expand_plain),
           "dedup_compact_rows": (dk.dedup_compact_rows,
                                  dk.dedup_compact_rows_plain),
           "sort_rows": (dk.sort_rows, dk.sort_rows_plain),
           "sort_pairs": (dk.sort_pairs, dk.sort_pairs_plain),
           "knn_topk": (kk.knn_topk, kk.knn_topk_plain),
           "rmsnorm_fwd": (rk.rmsnorm_fwd, rk.rmsnorm_fwd_plain),
           "flash_fwd": (fk.flash_fwd, fk.flash_fwd_plain),
           "flash_bwd_dkv": (fk.flash_bwd_dkv, fk.flash_bwd_dkv_plain),
           "flash_bwd_dq": (fk.flash_bwd_dq, fk.flash_bwd_dq_plain)}
    # the kernels each path must have launched: its own, and the earlier
    # slices' kernels that serve it too
    for path, need in (("shared", ("sort_pairs", "expand",
                                   "searchsorted_left_ranged")),
                       ("nearest", ("knn_topk", "dedup_compact_rows")),
                       ("nearest_shared", ("knn_topk", "sort_pairs")),
                       ("mesh", ("searchsorted_left", "expand",
                                 "dedup_compact_rows", "sort_rows")),
                       ("mesh_shared", ("searchsorted_left", "sort_pairs",
                                        "expand",
                                        "searchsorted_left_ranged")),
                       ("lm_decode", ("rmsnorm_fwd",)),
                       ("lm_train", LM_KERNELS)):
        for name in need:
            check(launches[path][name] > 0,
                  f"{name} was not launched on the {path} path")
    rows = []
    torch.set_grad_enabled(False)     # the recorded inputs may need grad
    for name in KERNELS:
        src, replaces = KERNELS[name]
        n_path = launches[PATH_OF[name]][name]
        check(n_path > 0, f"{name} was not launched on the main path")
        check(name in best, f"{name}: no main-path inputs recorded")
        _, args, kw = best[name]
        kern, plain = fns[name]
        out = kern(*args, **kw)
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        out_t, ref_t = list(_tensors([out])), list(_tensors([ref]))
        if name in FLOAT_TOL:
            tols = _float_tol(name, out_t[0].dtype)
            err = max(_close(o, r, f"{name} at main-path inputs", tol)
                      for o, r, tol in zip(out_t, ref_t, tols))
        else:
            _exact(_bits(out_t), _bits(ref_t), f"{name} at main-path inputs")
            err = max(float((o.double() - r.double()).abs().nan_to_num(0)
                            .max()) if o.numel() else 0.0
                      for o, r in zip(out_t, ref_t))
        del out, ref, out_t, ref_t
        lib = _library_call(name, args, kw)
        bound_ms, bound_by = _bound(name, args, kw)
        shapes = [tuple(a.shape) for a in _tensors(args)][:3]
        row = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=sum(int(n[name]) for n in launches.values()),
            launches_by_path={p: int(n[name]) for p, n in launches.items()},
            max_abs_err=err,
            ms=_events_ms(lambda: kern(*args, **kw)),
            plain_ms=_events_ms(lambda: plain(*args, **kw), n=5),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib[1] if lib else None,
            library=lib[0] if lib else None,
            device_ms=_device_ms(lambda: kern(*args, **kw)),
            shapes=shapes, dtype=str(args[0].dtype))
        if name == "flash_fwd":
            # the window mask equals the causal one over the first 4096
            # positions: the fused causal attention's time there
            S0 = min(4096, args[0].shape[1])
            part = [t[:, :S0].contiguous() for t in args]
            label, fn = _sdpa_call(part, kw, rows=S0)
            row.update(ms_causal_4096=_events_ms(lambda: kern(*part, **kw)),
                       library_causal_4096_ms=_events_ms(fn),
                       library_causal_4096=label)
        rows.append(row)
        torch.cuda.empty_cache()
    torch.set_grad_enabled(True)
    print(json.dumps({"kernels": rows}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only")
    ap.add_argument("--rehearse", action="store_true",
                    help="without a GPU: phases 4-9b and 11 at a tiny size "
                         "on the CPU, then exit 1")
    args = ap.parse_args(argv)
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import h2o_danube_3_4b as danube
    if not torch.cuda.is_available():
        if not args.rehearse:
            print("chip_smoke: no CUDA device; nothing was run",
                  file=sys.stderr)
            return 1
        dev = torch.device("cpu")
        kg = phase_load(dev, KG_REHEARSE, dict(A1_SHARD, cap_v=20_000,
                                               cap_e=80_000, cap_idx=20_000))
        caps = dict(A1_CAPS, frontier=256, expand=1024)
        launches = {}
        batches, results, peak = phase_serve(kg, dev, 1, launches, caps)
        phase_serve_shared(kg, dev, batches, results, peak, launches, caps)
        phase_nearest(dev, NEAREST_REHEARSE, 1, launches, caps)
        kg = phase_load(dev, KG_REHEARSE, dict(A1_MESH, cap_v=5_000,
                                               cap_e=20_000, cap_idx=5_000),
                        MESH_REDUCED)
        phase_mesh(kg, dev, 1, launches, dict(A1_MESH_CAPS, frontier=256,
                                              expand=1024, bucket=256))
        rec = Recorder()
        rec.only = set()
        phase_lm(dev, danube.REDUCED, LM_REHEARSE, launches, rec)
        phase_lm_train(dev, danube.REDUCED, LM_REHEARSE, launches, rec)
        rec.restore()
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
        rec = Recorder()
        launches = {}
        batches, results, peak = phase_serve(kg, dev, BATCHES, launches)
        phase_serve_shared(kg, dev, batches, results, peak, launches)
        del kg, batches, results
        torch.cuda.empty_cache()
        phase_nearest(dev, NEAREST_FULL, BATCHES, launches)
        torch.cuda.empty_cache()
        kg = phase_load(dev, KG_MESH, A1_MESH, MESH_REDUCED)
        rec.only = {"searchsorted_left"}      # the earlier paths' inputs stay
        phase_mesh(kg, dev, BATCHES, launches)
        del kg
        torch.cuda.empty_cache()
        rec.only = set()                      # phase_lm records its own
        phase_lm(dev, danube.FULL, LM_FULL, launches, rec)
        phase_lm_train(dev, danube.FULL, LM_FULL, launches, rec)
        rec.restore()
        phase_kernel_report(launches, rec.best)
        phase_small_reference(dev)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
