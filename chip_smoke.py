#!/usr/bin/env python3
"""Drive the PyTorch port's A1 read and write paths, LM serving and training
paths and GNN/recsys zoo on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # the whole run (one GPU, ~10 minutes)
    python3 chip_smoke.py --quick    # build and check the kernels only

Phases, each printed on its own line:

  1. device — ``nvidia-smi`` name and power limit;
  2. build — the CUDA kernels under ``src/repro_torch/csrc``, one ``nvcc``
     each, in parallel; ptxas's registers and spills (a PTXAS line for the
     tensor-core flash kernels);
  3. kernel checks — every kernel against its plain PyTorch version on the
     card at edge-case shapes (the int kernels, ``knn_topk`` and f32
     ``embedding_bag`` exactly, floats compared as bits; ``rmsnorm_fwd``,
     ``flash_fwd``, the two ``flash_bwd`` kernels, ``segment_spmm`` and
     bf16 ``embedding_bag`` within the tolerances stated beside their
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
 6b. write — the a1-kg ``update`` cell on phase 5's store: 72 mutation
     waves through ``GraphDB.write(txns)`` (~416 transactions a wave near
     the default ``BatchCaps``: film and actor creates, checked cast edges
     to Zipf actors, dob updates, film deletes with their cascades; a
     quarter of each wave staged before the previous wave commits, so
     stale reads abort too), both inline compactions at full size, with a
     pre-wave ``read_ts`` pinned throughout; read-backs every 8 waves and
     after the last (created vertices by key with their attributes, every
     written film's edges, deleted films gone, aborted writes invisible, a
     q1 / q3 / select batch equal to ``backend="ref"`` and, at the pinned
     ``read_ts``, to its pre-wave results); a WRITE line and a profiled
     commit;
  7. nearest — a second store (the JAX package's hybrid vector+graph
     workload at one machine's size: 4 M vector-indexed docs) and batches of
     ``Nearest``-rooted queries in both budget modes, equal to
     ``backend="ref"``; then one write wave of doc creates and embedding
     updates and the vector fold, with phase 7's ``read_ts`` pinned:
     ``Nearest`` equal to ``backend="ref"`` at the new clock and to phase
     7's results at the pinned one;
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
     timed, each checked against ``backend="ref"``; the profiled bf16
     prefill must have run only the tensor-core ``flash_fwd`` kernel;
 9b. lm_train — after phase 9's weights and cache are freed:
     ``lm/train_check_f32`` (4 of the 24 layers in float32 over 4,608
     tokens: ``loss_fn`` and every gradient on the kernel path against
     ``backend="ref"``, and remat against none) and ``lm/train_4k`` (all 24
     layers in bf16, AdamW with f32 moments, one 4,096-token sequence a
     step: the first step's loss, gradient norm and gradients against
     ``backend="ref"``, then 2 warm-up and 8 timed steps on one batch whose
     loss must fall; the profiled step must have run only the tensor-core
     ``flash_fwd``, ``flash_bwd_dkv`` and ``flash_bwd_dq`` kernels);
 9c. zoo — after phase 9b's model is freed, gcn-cora, graphsage-reddit
     and bst FULL (float32, AdamW with f32 moments) at their shape cells:
     ``zoo/gcn-cora/full_graph_sm`` (``cora_like(1.0)``) and
     ``zoo/graphsage-reddit/minibatch_lg`` (a synthetic graph of the
     fanout sample's 169,984 nodes and 168,960 edges), each first step's
     loss and gradients on the card against the CPU, then 2 warm-up and 8
     timed ``gnn_train_step``s; ``zoo/gcn-cora/ogb_products`` (2,449,029
     nodes, 61,859,140 edges) timed; ``zoo/bst/check`` (n_items cut to
     1,000,000: logits and gradients against the CPU),
     ``zoo/bst/train_batch`` (10^8 items, batch 65,536) timed, and
     ``zoo/bst/serve_p99`` / ``serve_bulk``; then the zoo path: the two
     kernels through their ``ops`` entry points, forward and backward, at
     those cells' inputs (``segment_spmm`` over ogb_products' features with
     an ELL of each node's first 25 in-neighbours, ``embedding_bag`` over
     BST's item table with the train batch's histories as bags), and
     ``segment_spmm`` against the model's ``common.spmm`` on cora;
 10. kernels — each kernel at the inputs the main path gave it: its
     launches during phases 5-9c (by path, ``write`` among them), its time beside the plain version's, the
     bound and a library call, as one JSON line; a kernel under 0.5 ms and
     its library call are timed again as 20 calls in one CUDA graph
     (``graph_ms``: no host time inside), and its wrapper's host time a
     call is given (``host_ms``; by part, ``host_parts_ms``, for the two
     ``sorted_lookup`` probes and ``sort_pairs``); ``knn_topk`` is timed
     again at its largest one-row call (``at_r1``, the ``nearest_k8/b1``
     cell) and ``dedup_compact_rows`` and ``sort_rows`` at their largest
     calls on the mesh path (``at_mesh``), each with its own bound, and
     the radix rows' valid keys and digit passes (``valid_per_row``,
     ``rows_by_passes``); ``segment_spmm`` adds a second bound,
     ``gathered_ms`` (x's row read once an id), and its share of ``ms``;
 11. small reference — small stores against plain set computations and a
     numpy k-NN in the kernels' summation order, on one shard and on a
     4-shard mesh; the CPU tests' seeded write script on the card and on
     the CPU (every store field, host mirror, event and wave record equal
     bit for bit); the film KG loaded through the write path onto 4
     shards, edited by a write wave, and queried through a 4-shard mesh
     against set computations.

Each of phases 5-9b sets the kernels' launch counts to 0 just before its
timed batches, calls or steps (per budget mode or cell) and reads them just
after (the write phase around the whole phase: its launches are its
read-back queries'); phase 9c does so around its kernel calls.
Any failed check raises, so the script exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 before
printing any result.  ``--rehearse`` runs phases 4-9c and 11 at a tiny size
on the CPU (plain kernel versions, no build) and then exits 1.
"""
from __future__ import annotations

import argparse
import functools
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
# the write phase: a1-kg's update cell (src/repro/configs/a1_kg.py:49, the
# commit-batch apply at the default BatchCaps, src/repro/launch/steps.py:
# 439-463) on phase 5's store; a wave's staged totals are near the caps:
# 256 create_v (32 ingest txns of 2 films and 6 actors), 128 update_v, 32
# delete_v (cascades <= 256 delete_e), 512 create_e (320 ingest, 192
# cast).  72 waves carry both inline backstops (cap_idx_delta near wave
# 63, cap_delta before it)
WRITE_FULL = dict(waves=72, ingest=32, cast=192, update=128, delete=32,
                  readback_every=8, pool=256)
WRITE_REHEARSE = dict(waves=12, ingest=4, cast=16, update=16, delete=4,
                      readback_every=4, pool=32)
# the hybrid vector+graph workload (benchmarks/bench_vector.py): 16 docs a
# tag, two doc.tag edges a doc; d = the a1-kg payload width, one machine's
# 4 M vector-indexed docs
NEAREST_FULL = dict(n_docs=4_194_304, d=32)
NEAREST_REHEARSE = dict(n_docs=4_096, d=32)
NEAREST_K = 8
DOC_WRITE_ROOM = 4_096          # slots for the doc store's write wave
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
# phase 9c, the zoo: gcn-cora, graphsage-reddit and bst FULL
# (src/repro/configs/{gcn_cora,graphsage_reddit,bst}.py) at their shape
# cells (src/repro/configs/registry.py:106-131); None takes the cell's own
# geometry or batch.  ell_k: GraphSAGE's first-hop fanout (arXiv:1706.02216)
ZOO_FULL = dict(cora_scale=1.0, reduced_geometry=False, ogb=None,
                bst_items=None, bst_batch=None, serve={}, serve_calls=8,
                check_items=1_000_000, check_batch=4_096, ell_k=25,
                warm_steps=2, timed_steps=8)
ZOO_REHEARSE = dict(cora_scale=0.1, reduced_geometry=True,
                    ogb=(3_000, 12_000, 100, 1), bst_items=10_000,
                    bst_batch=256, serve=dict(serve_p99=16, serve_bulk=512),
                    serve_calls=2, check_items=1_000, check_batch=64,
                    ell_k=25, warm_steps=1, timed_steps=2)
# the zoo's card-against-CPU checks, float32 throughout, max |a - b| over
# max |b|: the card adds the edges' messages with atomics and cuBLAS sums
# its f32 products in other orders than the CPU (each op ~1e-7 relative,
# sums over thousands of edges and nodes reach ~1e-6); the loss is one
# mean, each gradient leaf a sum over the whole graph or batch
ZOO_LOSS_TOL, ZOO_GRAD_TOL = 1e-5, 1e-4
# segment_spmm (every in-neighbour, norm 1/deg) against common.spmm's mean:
# f32 sums of the same terms in another order, a multiply by 1/deg against
# a divide by deg
ZOO_SPMM_TOL = 1e-5

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
    "segment_spmm": ("src/repro_torch/csrc/segment_spmm.cu",
                     "src/repro/kernels/segment_spmm/kernel.py:71"),
    "embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag/kernel.py:63"),
}
LM_KERNELS = ("rmsnorm_fwd", "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
# the main path each kernel belongs to: phase 5's per-query serve, phase
# 6's shared serve, phase 7's nearest serve, phase 8's mesh serve, phase
# 9's LM prefill, phase 9b's LM train step or phase 9c's zoo
PATH_OF = {"searchsorted_left_ranged": "per_query", "expand": "per_query",
           "dedup_compact_rows": "per_query", "sort_rows": "per_query",
           "sort_pairs": "shared", "knn_topk": "nearest",
           "searchsorted_left": "mesh", "rmsnorm_fwd": "lm_prefill",
           "flash_fwd": "lm_prefill", "flash_bwd_dkv": "lm_train",
           "flash_bwd_dq": "lm_train", "segment_spmm": "zoo",
           "embedding_bag": "zoo"}
# float kernels: (rtol, atol) of the kernel against its plain version, per
# output and input dtype (see _close, _check_rmsnorm, _check_flash,
# _check_flash_bwd, _check_segment_spmm and _check_embedding_bag)
FLOAT_TOL = {"rmsnorm_fwd": {"float32": [(1e-5, 1e-5)],
                             "bfloat16": ["ulp"]},
             "flash_fwd": {"float32": [(2e-5, 2e-5), (1e-5, 1e-5)],
                           "bfloat16": ["tc", (1e-5, 1e-5)]},
             "flash_bwd_dkv": {"float32": [(2e-4, 2e-4)] * 2,
                               "bfloat16": ["tc"] * 2},
             "flash_bwd_dq": {"float32": [(2e-4, 2e-4)],
                              "bfloat16": ["tc"]},
             "segment_spmm": {"float32": [(5e-5, 5e-5)],
                              "bfloat16": [(2 ** -7, 1e-4)]},
             "embedding_bag": {"float32": [(0.0, 0.0)],
                               "bfloat16": ["ulp"]}}


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
    cdf = _zipf_cdf(n_items, a)
    r = np.searchsorted(cdf, rng.random(size) * cdf[-1], side="right")
    return base + np.minimum(r, n_items - 1)


@functools.lru_cache(maxsize=8)
def _zipf_cdf(n_items: int, a: float):
    """The law's cumulative weights (10 M items: kept, not rebuilt a draw)."""
    import numpy as np
    return np.cumsum(1.0 / np.power(np.arange(1, n_items + 1), a))


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
    """Compile every kernel source; print ptxas's register and spill lines,
    and one PTXAS line with the tensor-core kernels' registers and spill
    bytes by instantiation."""
    import re
    from repro_torch.kernels import _cuda
    t0 = time.perf_counter()
    reports = _cuda.build()
    secs = time.perf_counter() - t0
    tc = {}
    for name, log in reports.items():
        fn = None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:      # a tensor-core kernel's name and template argument
                fn = next((f"{k}<{t.group(1)}>" for k, _ in TC_ROUTE.values()
                           for t in [re.search(k + r"ILi(\d+)E", m.group(1))]
                           if t), None)
            if "registers" in ln or "spill" in ln:
                print(f"ptxas {name}: {ln.strip()}", flush=True)
            if fn:
                row = tc.setdefault(fn, {})
                for key, pat in (("registers", r"Used (\d+) registers"),
                                 ("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads")):
                    m = re.search(pat, ln)
                    if m:
                        row[key] = int(m.group(1))
    if tc:
        say("PTXAS", tensor_core_kernels=tc)
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
    n_cases = _check_searchsorted_left_ranged(rng, t)
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
    n_cases += _check_dedup(rng, t)
    n_cases += _check_sort_rows(rng, t)
    n_cases += _check_searchsorted_left(rng, t)
    n_cases += _check_sort_pairs(rng, t)
    n_cases += _check_knn_topk(rng, t)
    torch.cuda.synchronize()
    say("KERNEL_CHECKS", cases=n_cases, equal=True)
    errs = {"rmsnorm_fwd": _check_rmsnorm(dev), "flash_fwd": _check_flash(dev),
            "flash_bwd": _check_flash_bwd(dev),
            "segment_spmm": _check_segment_spmm(dev),
            "embedding_bag": _check_embedding_bag(dev)}
    torch.cuda.synchronize()
    say("KERNEL_CHECKS_FLOAT", cases={k: len(v) for k, v in errs.items()},
        within_tolerance=True, max_abs_err={
            k: {dt: max(e for d, e in v if d == dt) for dt in
                ("float32", "bfloat16")} for k, v in errs.items()},
        tolerance=FLOAT_TOL, tc_share_of_tolerance=TC_SHARE)


def _dedup_rows(rng, W):
    """Rows of every kind the radix dedup takes: 0 to 4 digit passes, -1 as
    the smallest value, constant, all-PAD and all-valid rows, 30 % PAD
    elsewhere."""
    import numpy as np
    i32min = -2**31

    def some(lo, hi):
        return rng.integers(lo, hi, W, endpoint=True)
    rows = np.stack([
        some(i32min, I32MAX - 1),                          # 4 passes
        some(0, 14_500_063),                               # 3: a1-kg gids
        some(-30_000, 30_000),                             # 2, negative
        np.where(rng.random(W) < 0.2, -1, some(0, 200)),   # 1, -1 smallest
        np.full(W, 7),                                     # 0: constant
        np.full(W, I32MAX),                                # all PAD
        np.where(rng.random(W) < 0.5, -1, 5),              # -1, then 5
        some(0, 14_500_063)])                              # all valid
    pad = rng.random(rows.shape) < 0.3
    pad[4:] = False
    rows[pad] = I32MAX
    return rows


def _radix_widths():
    """The widths at the radix routine's edges: around one block's 1,024
    threads, the switch to them (DEDUP_SMALL_W), a load round (8 keys a
    thread), the widest row whose two key buffers fit in shared memory
    whatever its count (and the first that reads the row instead), the
    main path's 8,192 and 36,866, and MAX_W."""
    from repro_torch.kernels.dedup_compact import kernel as dk
    gather = dk.dedup_key_cap(dk.MAX_W) // 2       # the widest gathered row
    return [1, 2, 31, 1023, 1024, 1025, dk.DEDUP_SMALL_W,
            dk.DEDUP_SMALL_W + 1, 8191, 8192, 8193, gather - 1, gather,
            gather + 1, 36_866, dk.MAX_W]


def _smem_edge_rows(rng):
    """MAX_W rows of gids whose valid counts straddle the two key buffers'
    and one buffer's room in shared memory (past them the buffers are
    global rows)."""
    import numpy as np
    from repro_torch.kernels.dedup_compact import kernel as dk
    cap2 = dk.dedup_key_cap(dk.MAX_W)              # keys shared memory holds
    rows = []
    for n in (cap2 // 2, cap2 // 2 + 1, cap2, cap2 + 1, dk.MAX_W):
        r = rng.integers(0, 14_500_063, dk.MAX_W)
        r[rng.permutation(dk.MAX_W)[:dk.MAX_W - n]] = I32MAX
        rows.append(r)
    return np.stack(rows)


def _check_dedup(rng, t) -> int:
    """dedup_compact_rows against its plain version and the ref backend:
    the radix routine's edge widths, each with every row kind; the
    shared-memory edge rows (the scratch rows in use); R = 130 and R = 0;
    and caps below and past the width."""
    import numpy as np
    from repro_torch.kernels.dedup_compact import kernel as dk
    from repro_torch.kernels.dedup_compact import ref as dref
    cases = [(f"W={W}", _dedup_rows(rng, W), cap)
             for W in _radix_widths() for cap in ((4096, W + 3) if W < 9000
                                                  else (4096,))]
    cases.append(("MAX_W, valid counts at the shared-memory edges",
                  _smem_edge_rows(rng), 4096))
    cases.append(("R=130", rng.integers(-5, 3000, (130, 300)), 64))
    cases.append(("R=0", np.zeros((0, 300)), 64))
    for what, x, cap in cases:
        xt = t(x)
        got = dk.dedup_compact_rows(xt, cap)
        _exact(got, dk.dedup_compact_rows_plain(xt, cap), f"dedup {what} "
               f"cap={cap}")
        _exact(got, dref.dedup_compact_rows(xt, cap), f"dedup {what} "
               f"cap={cap} vs the ref backend")
    return len(cases)


def _merge_layout(rng, Q, Bmax, F):
    """(Q, Bmax * F) rows as ``planner._merge_rows`` builds them: Bmax
    sorted-unique runs of gids a row, each run padded to F with PAD, the
    second run sharing some gids with the first."""
    import numpy as np
    rows = np.full((Q, Bmax, F), I32MAX, np.int64)
    for q in range(Q):
        first = None
        for b in range(Bmax):
            g = rng.integers(0, 14_500_063, int(rng.integers(0, F + 1)))
            if first is not None and first.size:
                g[:g.size // 2] = rng.choice(first, g.size // 2)
            g = np.unique(g)[:F]
            rows[q, b, :g.size] = g
            first = g
    return rows.reshape(Q, Bmax * F)


def _check_sort_rows(rng, t) -> int:
    """sort_rows against its plain version, torch.sort and the ref backend,
    bit for bit: every _dedup_rows kind at the radix routine's edge widths;
    the shared-memory edge rows (past one buffer's room the first buffer is
    the output row); rows of Bmax sorted-unique runs (the _merge_rows
    layout) at 64 x 2 x 4,096 and 4 x 3 x 100; R = 130, R = 0 and W = 0."""
    import numpy as np
    import torch
    from repro_torch.kernels.dedup_compact import kernel as dk
    from repro_torch.kernels.dedup_compact import ref as dref
    cases = [(f"W={W}", _dedup_rows(rng, W)) for W in _radix_widths()]
    cases += [("MAX_W, valid counts at the shared-memory edges",
               _smem_edge_rows(rng)),
              ("the merge layout, 64 x 2 x 4096", _merge_layout(rng, 64, 2,
                                                                4096)),
              ("the merge layout, 4 x 3 x 100", _merge_layout(rng, 4, 3,
                                                              100)),
              ("R=130", rng.integers(-5, 3000, (130, 300))),
              ("R=0", np.zeros((0, 300))), ("W=0", np.zeros((3, 0)))]
    for what, x in cases:
        xt = t(x)
        got = dk.sort_rows(xt)
        _exact(got, dk.sort_rows_plain(xt), f"sort_rows {what}")
        _exact(got, torch.sort(xt, dim=1).values,
               f"sort_rows {what} vs torch.sort")
        _exact(got, dref.sort_rows(xt), f"sort_rows {what} vs the ref "
               "backend")
    return len(cases)


def _probe_runs(rng, n):
    """Sorted keys of length n in which runs of equal keys straddle the
    warp search's first-round probe points ((i + 1) n // 33), and queries
    on, just below and just above each run."""
    import numpy as np
    keys = np.sort(rng.integers(-2**31, I32MAX, n))
    pts = np.array([(i + 1) * n // 33 for i in range(32)])
    for p in pts[::3]:
        keys[max(0, p - 2):p + 3] = keys[p]
    vals = keys[pts].astype(np.int64)
    qs = np.concatenate([vals, vals - 1, vals + 1])
    return keys, np.clip(qs, -2**31, I32MAX)


def _check_searchsorted_left(rng, t) -> int:
    """searchsorted_left against its plain version and the library search:
    duplicates, queries below and above every key, INT32_MAX queries and
    pads, N not a power of two, N = 1, Q = 1, an empty index, 16 M keys
    (one shard's cap_idx); for the warp's 32-ary search, N at the edges of
    its rounds (33, 34, 1089 = 33^2, 1090), runs of equal keys across its
    probe points, and all keys equal."""
    import numpy as np
    import torch
    from repro_torch.kernels.sorted_lookup import kernel as sk
    cases = []
    for n, q in ((1000, 999), (1, 1), (1, 50), (777, 1), (16_000_000, 4096),
                 (33, 40), (34, 40), (1089, 300), (1090, 300)):
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
    for n in (33, 1090, 16_000_000):
        cases.append((f"N={n}, runs across the probe points",
                      *_probe_runs(rng, n)))
    cases.append(("N=1090, all keys equal", np.full(1090, 7),
                  np.array([6, 7, 8, -2**31, I32MAX])))
    for what, keys, qs in cases:
        k, q = t(keys), t(qs)
        got = sk.searchsorted_left(k, q)
        _exact(got, sk.searchsorted_left_plain(k, q),
               f"searchsorted_left {what}")
        _exact(got, torch.searchsorted(k, q, out_int32=True),
               f"searchsorted_left {what} vs torch.searchsorted")
    return len(cases)


def _window_queries(rng, keys, a, w):
    """Queries for the window keys[a:a + w]: the keys at the warp search's
    first-round probe points, each minus and plus one, the window's ends,
    the int32 extremes and random ones."""
    import numpy as np
    win = keys[a:a + w]
    pts = [(i + 1) * w // 33 for i in range(32)] if w > 32 else range(w)
    vals = win[list(pts)].astype(np.int64)
    ends = np.array([win[0], win[-1]] if w else [], np.int64)
    qs = np.concatenate([vals, vals - 1, vals + 1, ends, [I32MAX, -2**31],
                         rng.integers(-2**31, I32MAX, 8)])
    return np.clip(qs, -2**31, I32MAX)


def _check_searchsorted_left_ranged(rng, t) -> int:
    """searchsorted_left_ranged against its plain version and the library
    search of each window (given as hi, and as a width where the windows
    are blocks): shard-major blocks with empty slots, windows of the warp
    search's edge widths (0, 1, 32, 33, 34, 1089, 1090), runs of equal keys
    across the probe points of a 16 M-key window, windows clipped at either
    end, ending at n, hi < lo, all-PAD windows, and the shared planner's
    many small windows."""
    import numpy as np
    import torch
    from repro_torch.kernels.sorted_lookup import kernel as sk
    cases = []
    blk, S = 1000, 3                     # the index probe's blocked layout
    keys = np.sort(rng.integers(-2**31, I32MAX, (S, blk)), axis=1)
    keys[:, -100:] = I32MAX                                # empty slots
    q = rng.integers(-2**31, I32MAX, 999)
    q[:8] = [I32MAX, -2**31, 0, keys[0, 0], keys[1, 5], keys[2, -101], -1, 1]
    lo = rng.integers(0, S, q.shape[0]) * blk
    cases.append(("blocks", keys.reshape(-1), q, lo, lo + blk, blk))
    n = 5000
    flat = np.sort(rng.integers(-2**31, I32MAX, n))
    flat[-500:] = I32MAX
    for w in (0, 1, 32, 33, 34, 1089, 1090):
        wins = [(17, 17 + w), (-5, w - 5), (n - w, n), (n - w + 7, n + 7),
                (n - 400, n - 400 + w)]               # the last all PAD
        qs, lo, hi = [], [], []
        for a, b in wins:
            qa = _window_queries(rng, flat, max(a, 0),
                                 max(0, min(b, n) - max(a, 0)))
            qs.append(qa)
            lo.append(np.full(qa.shape, a))
            hi.append(np.full(qa.shape, b))
        cases.append((f"windows of width {w}", flat,
                      *map(np.concatenate, (qs, lo, hi)), None))
    q = rng.integers(-2**31, I32MAX, 300)
    lo = rng.integers(-100, n + 100, 300)
    cases.append(("hi < lo, empty and clipped windows", flat, q, lo,
                  lo - rng.integers(-20, 20, 300), None))
    big = 16_000_000                      # one shard's cap_idx
    keys = np.sort(rng.integers(-2**31, I32MAX, big + 3000))
    a = 1000
    for i in range(0, 32, 3):             # runs across the probe points
        p = a + (i + 1) * big // 33
        keys[p - 2:p + 3] = keys[p]
    keys = np.maximum.accumulate(keys)
    keys[a + big - big // 8:a + big] = I32MAX
    q = _window_queries(rng, keys, a, big)
    cases.append(("a 16 M-key window, runs across the probe points", keys, q,
                  np.full(q.shape, a), np.full(q.shape, a + big), big))
    gid = np.sort(rng.integers(0, 1 << 24, 442_624))     # the delta probe
    seg = np.sort(rng.integers(0, 128, 442_624))
    bounds = np.searchsorted(seg, np.arange(129))
    order = np.lexsort((gid, seg))
    gid = gid[order]
    r = rng.integers(0, 128, 128 * 64)
    q = np.where(rng.random(r.shape[0]) < 0.5,
                 gid[np.minimum(bounds[r], len(gid) - 1)],
                 rng.integers(0, 1 << 24, r.shape[0]))
    cases.append(("the delta probe's 8,192 small windows", gid, q, bounds[r],
                  bounds[r + 1], None))
    for what, keys, qs, lo, hi, width in cases:
        k, q, lo_t, hi_t = t(keys), t(qs), t(lo), t(hi)
        got = sk.searchsorted_left_ranged(k, q, lo_t, hi_t)
        _exact(got, sk.searchsorted_left_ranged_plain(k, q, lo_t, hi_t),
               f"searchsorted_left_ranged {what}")
        if width is not None:
            _exact(sk.searchsorted_left_ranged(k, q, lo_t, width=width), got,
                   f"searchsorted_left_ranged {what}, as a width")
        a = torch.clamp(lo_t.long(), min=0)
        b = torch.maximum(torch.clamp(hi_t.long(), max=k.shape[0]), a)
        if bool((lo_t == lo_t[0]).all()) and bool((hi_t == hi_t[0]).all()):
            lib = torch.searchsorted(k[int(a[0]):int(b[0])], q,
                                     out_int32=True)
        else:                             # per window, on the host
            kc, qc, ac, bc = (x.cpu().numpy() for x in (k, q, a, b))
            lib = t([np.searchsorted(kc[x:y], v) for v, x, y in
                     zip(qc, ac, bc)])
        _exact(got, lib, f"searchsorted_left_ranged {what} vs searchsorted")
    return len(cases)


def _check_sort_pairs(rng, t) -> int:
    """sort_pairs against its plain version and the library sort of the
    packed key: one pair, all pairs equal (no digit varies), one digit
    varying, only k1 varying, the main path's 442,624 (seg, gid) pairs with
    99 % ghosts (R, PAD), random full-range pairs (all eight passes), the
    int32 extremes and negative k1, widths at and around the one-launch
    threshold, the radix sort's first widths at its tile edges (2,048 k and
    one either side), and widths up to 2**24, past the point where the
    histogram blocks reach their cap (the pass blocks the card holds at
    once: 4,096 keys a block, so 2**22 pairs want 1,024)."""
    import numpy as np
    from repro_torch.kernels.dedup_compact import kernel as dk
    from repro_torch.kernels.dedup_compact import ref as dref
    i32min = -2**31
    sm = dk.SMALL_MAX
    cases = []
    for W in (1, 2, 37, sm - 1, sm, sm + 1, 8192, 100_003, 196_608, 1 << 20):
        k1 = rng.integers(-50, 50, W)
        k2 = rng.integers(i32min, I32MAX, W, endpoint=True)
        cases.append((f"random W={W}", k1, k2))
    edges = [w for k in range(2, 7) for w in (dk.TILE * k - 1, dk.TILE * k,
                                              dk.TILE * k + 1) if w > sm]
    for W in edges + [1 << 22, 1 << 24]:
        k1 = rng.integers(i32min, I32MAX, W, endpoint=True)
        k2 = rng.integers(i32min, I32MAX, W, endpoint=True)
        cases.append((f"full range W={W}", k1, k2))
    W = 442_624
    cases.append(("full range (eight passes)",
                  rng.integers(i32min, I32MAX, W, endpoint=True),
                  rng.integers(i32min, I32MAX, W, endpoint=True)))
    for n in (sm + 1, W):
        cases.append((f"all pairs equal W={n}", np.full(n, 7), np.full(n, -3)))
    cases.append(("one digit varying", np.full(W, 5),
                  rng.integers(0, 256, W) << 8))
    cases.append(("only k1 varying", rng.integers(-40, 40, W),
                  np.full(W, I32MAX)))
    for share, n in ((0.5, W), (0.99, W), (0.5, 1 << 22)):
        k1 = rng.integers(0, 128, n)
        k2 = rng.integers(0, 14_500_064, n)
        ghost = rng.random(n) < share
        k1[ghost], k2[ghost] = 128, I32MAX             # (R, PAD) ghosts
        cases.append((f"{share:.0%} ghosts (R, PAD) W={n}", k1, k2))
    ext = np.array([i32min, i32min + 1, I32MAX, I32MAX - 1, 0, -1, 1])
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
    row tile, a k that needs several merge passes, R = 1, 2, 63, 65 with k
    on both sides of the warp lists' 32, N = 1, N at tile edges, D not a
    multiple of 4, entry rows not 16-byte aligned and 4 M entries at R =
    1."""
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
    # the cut by R (warps over entries at R <= 8, over rows past 32), both
    # list routes (k <= 32 in a warp, larger k in shared memory), tile
    # edges (256 entries a tile at R <= 8, 128 past it), D not a multiple
    # of 4 (4-byte copies, zero-padded dims), and a large index at R = 1
    for R in (1, 2, 63, 65):
        for k in (8, 32, 33, 100, 4096):
            cases.append((f"R={R}, k={k}", case(R, 9_000, 32, 100 + R + k),
                          k))
    cases.append(("N=1", case(4, 1, 32, 11), 8))
    for R, te in ((1, 256), (64, 128)):
        for N in (te - 1, te, te + 1, 3 * te + 1):
            cases.append((f"R={R}, N={N} (tile edge)",
                          case(R, N, 32, 12 + N), 8))
    for D in (5, 12):
        cases.append((f"D={D}", case(3, 1000, D, 13 + D), 8))
    cases.append(("R=1, N=4,194,304", case(1, 4_194_304, 32, 14), 8))
    c = case(2, 3000, 32, 15)
    c["unaligned"] = True
    cases.append(("entry rows not 16-byte aligned", c, 8))
    for what, c, k in cases:
        args = [torch.as_tensor(np.ascontiguousarray(c[n], np.float32),
                                device=dev) for n in ("vecs", "emb")]
        if c.get("unaligned"):         # the same rows, 4 bytes past 16
            e = torch.empty(args[1].numel() + 1, device=dev)[1:]
            args[1] = e.view(args[1].shape).copy_(args[1])
        args += [t(c[n]) for n in ("gid", "vtype", "create", "delete",
                                   "q_vt", "q_ts")]
        got = kk.knn_topk(*args, k)
        want = kk.knn_topk_plain(*args, k)
        _exact((got[0].view(torch.int32), got[1]),
               (want[0].view(torch.int32), want[1]), f"knn_topk {what}")
    return len(cases)


# the largest error of a "tc" check as a share of its tolerance, by the
# first word of what was checked
TC_SHARE = {}


def _close(a, b, what, tol, bound=None) -> float:
    """``a`` within ``tol`` of ``b`` everywhere (one shape and dtype):
    ``(rtol, atol)``, ``"ulp"`` for at most one bf16 ulp apart (the bit
    patterns of same-signed values differ by at most 1), or ``"tc"`` for
    at most ``bound`` (a tensor like ``a``) plus one bf16 ulp of the larger
    of the two apart (see _flash_fwd_tc_plain).  NaN never passes.  Returns
    the largest absolute difference."""
    import torch
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{what}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    if a.numel() == 0:
        return 0.0
    err = (a.double() - b.double()).abs()
    if tol == "ulp":
        steps = (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()
        ok = (steps <= 1) | (err == 0)
    elif tol == "tc":
        big = torch.maximum(a.double().abs(), b.double().abs())
        ulp = torch.where(big > 0, torch.exp2(torch.floor(torch.log2(
            big.clamp(min=2.0 ** -126))) - 7), 0.0)
        ok = err <= bound.double() + ulp
        key = what.split()[0]
        TC_SHARE[key] = max(TC_SHARE.get(key, 0.0), float(
            (err / (bound.double() + ulp).clamp(min=2.0 ** -149)).max()))
    else:
        rtol, atol = tol
        ok = err <= atol + rtol * b.double().abs()
    bad = int((~ok).sum())
    check(bad == 0, f"{what}: {bad} of {a.numel()} values outside {tol} "
          f"(max abs err {float(err.max())})")
    return float(err.max())


def _float_tol(name, dtype):
    return FLOAT_TOL[name][str(dtype).replace("torch.", "")]


# The tensor-core kernels (bf16 inputs) round one operand of a product to
# bf16 that the plain versions keep in f32: p before P V (flash_fwd's out,
# p taken against the running max of the kernel's key step), p and ds
# before P^T dout and dS^T Q (flash_bwd_dkv's dv and dk), ds before dS K
# (flash_bwd_dq's dq).  q, k, v and dout are bf16 already, and every sum is
# f32.  So each is held against a plain version that rounds the same
# operands at the same steps (_flash_fwd_tc_plain, _flash_dkv_tc_plain,
# _flash_dq_tc_plain), and what remains between the two is f32 arithmetic
# done in another order:
#  * an operand the kernel rounds is computed from the same inputs through
#    a dot product of D <= 128 exact bf16 products (s, dp), an exp2 and a
#    few f32 products: its f32 value may differ by DOT_REL of the
#    magnitudes it is made of (|q| |k|, |dout| |v|, the exponent's terms).
#    Two f32 sums of n terms in other orders differ by about
#    2 sqrt(n) 2**-24 of the terms' magnitudes (independent roundings):
#    2**-19.5 at n = 128, so DOT_REL = 2**-17 leaves a factor 5.  Where the
#    value lies that close to a bf16 midpoint the two may round it to
#    neighbouring values; the bound adds |r(x + eps) - r(x - eps)| for each
#    term (r: round to bf16), 0 where no midpoint is that close;
#  * the f32 sums of the products (P V and dS K over the visited keys, the
#    dK/dV sums over G heads and every row, O's rescaling chain) differ by
#    SUM_REL of their terms' magnitudes: 2 sqrt(n) 2**-24 is 2**-15.5 at
#    n = 32,768, so SUM_REL = 2**-14;
#  * both round the f32 result to bf16 once: one ulp of the larger of the
#    two (_close's "tc").
# The bound stays about one ulp of the result: a key step left out moves
# out, dk, dv or dq by many (tests/test_torch_flash_tc.py shows it at a
# window of 4,096 keys).
DOT_REL = 2.0 ** -17
SUM_REL = 2.0 ** -14
LOG2E = 1.4426950408889634
TC_ROWS = 512           # query rows the rounding-matched versions take at once


def _spread(x, eps):
    """How far rounding x to bf16 can move when x moves by up to eps."""
    import torch
    return (x + eps).to(torch.bfloat16).float() - \
        (x - eps).to(torch.bfloat16).float()


def _flash_fwd_tc_plain(q, k, v, *, causal, window, scale, q_offset=0):
    """flash_fwd_tc_kernel's arithmetic in plain torch, TC_ROWS rows at a
    time over the keys their q blocks visit: x = s scale log2(e), the
    running max m of each row over the kernel's key steps (a 64-key tile in
    one step where its warp's 32 rows see every key of it and D <= 120,
    else in two 32-key steps; a step's p is taken against the max through
    the step's end), p = exp2(x - m) in f32, l summed from the f32 p and
    O += bf16(p) V, both rescaled to the row's final max.  Returns (out,
    lse, bound): bound per element of out, see DOT_REL (lse is held to
    (1e-5, 1e-5) as for the f32 kernel: l is summed from the f32 p)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import NEG_INF, \
        attention_mask
    BHq, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    G = BHq // BHkv
    c = scale * LOG2E
    BK, H, W = fk.TC_BK, fk.TC_BK // 2, fk.TC_WARP_ROWS
    out = torch.zeros_like(q)
    lse = torch.full((BHq, Sq), NEG_INF, device=q.device)
    bound = torch.zeros(q.shape, device=q.device)
    og, lg, bg = (t.view(BHkv, G, Sq, *t.shape[2:]) for t in (out, lse,
                                                              bound))
    qg = q.view(BHkv, G, Sq, D)
    for a in range(0, Sq, TC_ROWS):
        n = min(TC_ROWS, Sq - a)
        tiles = fk.kv_tiles(a, n, Sk, causal=causal, window=window,
                            q_offset=q_offset, bk=BK)
        if not len(tiles):
            continue
        k0, T = tiles.start * BK, len(tiles)
        nk = min(Sk, tiles.stop * BK) - k0
        live = torch.zeros((-(-n // W) * W, T * BK), dtype=torch.bool,
                           device=q.device)
        live[:n, :nk] = attention_mask(n, nk, causal=causal, window=window,
                                       q_offset=q_offset + a - k0,
                                       device=q.device)
        # the warps' steps: a tile split in two unless its warp's rows see
        # every key of it and D <= 120 (the kernel's kFull and KF)
        full = live.view(-1, W, T, BK).all(3).all(1)
        split = (~full | (D > 120)).repeat_interleave(W, 0)[:n]
        live = live[:n]
        qa = qg[:, :, a:a + n].float()
        kk = F.pad(k[:, None, k0:k0 + nk].float(), (0, 0, 0, T * BK - nk))
        vv = F.pad(v[:, None, k0:k0 + nk].float(), (0, 0, 0, T * BK - nk))
        x = torch.where(live, torch.matmul(qa, kk.transpose(-1, -2)) * c,
                        NEG_INF)
        cm = torch.cummax(x.unflatten(-1, (2 * T, H)).amax(-1), -1).values
        m = torch.stack((torch.where(split, cm[..., 0::2], cm[..., 1::2]),
                         cm[..., 1::2]), -1).flatten(-2)
        m = m.repeat_interleave(H, -1)
        mf = cm[..., -1:]
        p = torch.where(live, torch.exp2(x - m), 0.0)
        f = torch.exp2(m - mf)
        pr = p.to(torch.bfloat16).float()
        l = (p * f).sum(-1, keepdim=True)
        lc = l.clamp(min=1e-30)
        o = torch.matmul(pr * f, vv) / lc
        og[:, :, a:a + n] = o.to(q.dtype)
        lg[:, :, a:a + n] = (torch.where(l > 0, mf / LOG2E, NEG_INF)
                             + torch.log(lc))[..., 0]
        # the bound: exponent x - m from |q| |k| and the terms' sizes
        amag = torch.where(live, torch.matmul(qa.abs(),
                                              kk.abs().transpose(-1, -2)), 0)
        arg = DOT_REL * (c * (amag + amag.amax(-1, keepdim=True))
                         + x.abs() + m.abs() + 1)
        eps = torch.where(live, p * torch.expm1(arg), 0.0)
        w = (_spread(p, eps) + SUM_REL * pr) * f
        bg[:, :, a:a + n] = torch.matmul(w, vv.abs()) / lc + o.abs() * (
            (eps * f).sum(-1, keepdim=True) / lc + SUM_REL)
        del x, p, f, pr, m, amag, arg, eps, w
    return out, lse, bound


def _tc_p_ds(qa, oa, kf, vf, la, da, live, c, scale):
    """The backward kernels' p = exp2(s c - lse log2(e)) and ds = p (dp -
    delta) scale in f32 for a slab of rows (``la``: lse log2(e)), with how
    far the kernels' f32 values may lie from them (see DOT_REL): p's
    exponent from |q| |k| and its terms' sizes, ds's dp - delta from
    |dout| |v| and |delta|.  Returns (p, ds, eps of p, eps of ds)."""
    import torch
    sc = torch.matmul(qa, kf.transpose(-1, -2)) * c
    p = torch.where(live, torch.exp2(sc - la), 0.0)
    dp = torch.matmul(oa, vf.transpose(-1, -2))
    ds = p * (dp - da) * scale
    arg = DOT_REL * (c * torch.matmul(qa.abs(), kf.abs().transpose(-1, -2))
                     + sc.abs() + la.abs() + 1)
    del sc
    ep = torch.where(live, p * torch.expm1(arg), 0.0)
    del arg
    eds = ep * (dp - da).abs() * scale + DOT_REL * (
        p * scale * (torch.matmul(oa.abs(), vf.abs().transpose(-1, -2))
                     + da.abs()) + ds.abs())
    return p, ds, ep, eds


def _flash_dkv_tc_plain(q, k, v, do, lse, delta, *, causal, window, scale,
                        q_offset=0):
    """flash_bwd_dkv_tc_kernel's arithmetic in plain torch, TC_ROWS rows at
    a time with the G q heads of a kv head stacked: p and ds in f32
    (_tc_p_ds), dv += bf16(p)^T dout and dk += bf16(ds)^T q.  Returns (dk,
    dv, bound of dk, bound of dv), see DOT_REL."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_mask
    BHq, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    G = BHq // BHkv
    kf, vf = k.float()[:, None], v.float()[:, None]
    qg, og = q.view(BHkv, G, Sq, D), do.view(BHkv, G, Sq, D)
    lg, dg = lse.view(BHkv, G, Sq, 1), delta.view(BHkv, G, Sq, 1)
    dk, dv, bk, bv = (torch.zeros((BHkv, Sk, D), device=q.device)
                      for _ in range(4))
    for a in range(0, Sq, TC_ROWS):
        b = min(Sq, a + TC_ROWS)
        qa, oa = qg[:, :, a:b].float(), og[:, :, a:b].float()
        live = attention_mask(b - a, Sk, causal=causal, window=window,
                              q_offset=q_offset + a, device=q.device)
        p, ds, ep, eds = _tc_p_ds(qa, oa, kf, vf, lg[:, :, a:b] * LOG2E,
                                  dg[:, :, a:b], live, scale * LOG2E, scale)
        pr, dsr = (t.to(torch.bfloat16).float() for t in (p, ds))
        dv += torch.matmul(pr.transpose(-1, -2), oa).sum(1)
        dk += torch.matmul(dsr.transpose(-1, -2), qa).sum(1)
        bv += torch.matmul((_spread(p, ep) + SUM_REL * pr).transpose(-1, -2),
                           oa.abs()).sum(1)
        bk += torch.matmul((_spread(ds, eds) + SUM_REL * dsr.abs())
                           .transpose(-1, -2), qa.abs()).sum(1)
        del p, ds, pr, dsr, ep, eds
    return dk.to(k.dtype), dv.to(v.dtype), bk, bv


def _flash_dq_tc_plain(q, k, v, do, lse, delta, *, causal, window, scale,
                       q_offset=0):
    """flash_bwd_dq_tc_kernel's arithmetic in plain torch, TC_ROWS rows at a
    time with the G q heads of a kv head stacked: p and ds in f32
    (_tc_p_ds), dq += bf16(ds) k.  Returns (dq, bound of dq), see
    DOT_REL."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_mask
    BHq, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    G = BHq // BHkv
    kf, vf = k.float()[:, None], v.float()[:, None]
    qg, og = q.view(BHkv, G, Sq, D), do.view(BHkv, G, Sq, D)
    lg, dg = lse.view(BHkv, G, Sq, 1), delta.view(BHkv, G, Sq, 1)
    dq = torch.empty_like(q)
    bound = torch.zeros(q.shape, device=q.device)
    dqg, bg = dq.view(BHkv, G, Sq, D), bound.view(BHkv, G, Sq, D)
    for a in range(0, Sq, TC_ROWS):
        b = min(Sq, a + TC_ROWS)
        qa, oa = qg[:, :, a:b].float(), og[:, :, a:b].float()
        live = attention_mask(b - a, Sk, causal=causal, window=window,
                              q_offset=q_offset + a, device=q.device)
        p, ds, ep, eds = _tc_p_ds(qa, oa, kf, vf, lg[:, :, a:b] * LOG2E,
                                  dg[:, :, a:b], live, scale * LOG2E, scale)
        dsr = ds.to(torch.bfloat16).float()
        dqg[:, :, a:b] = torch.matmul(dsr, kf).to(q.dtype)
        bg[:, :, a:b] = torch.matmul(_spread(ds, eds) + SUM_REL * dsr.abs(),
                                     kf.abs())
        del p, ds, dsr, ep, eds
    return dq, bound


def _reference(name, plain, args, kw):
    """(outputs, bound of each) a kernel is held to on ``args``: the plain
    version's outputs with no bounds, or for the tensor-core flash kernels
    (bf16 inputs) the rounding-matched plain version's with its bounds."""
    import torch
    bf16 = args[0].dtype == torch.bfloat16
    if name == "flash_fwd" and bf16:
        out, lse, bound = _flash_fwd_tc_plain(*args, **kw)
        return [out, lse], [bound, None]
    if name == "flash_bwd_dkv" and bf16:
        dk, dv, bk, bv = _flash_dkv_tc_plain(*args, **kw)
        return [dk, dv], [bk, bv]
    if name == "flash_bwd_dq" and bf16:
        dq, bound = _flash_dq_tc_plain(*args, **kw)
        return [dq], [bound]
    ref = list(_tensors([plain(*args, **kw)]))
    return ref, [None] * len(ref)


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
    (1, 2, 5, 384, 384, 128, True, 256, 0),       # qwen1.5-32b: D 128, G 5
    (1, 2, 4, 1000, 1000, 120, True, 200, 0),     # window edge mid-tile
    (1, 1, 4, 4097, 4097, 120, True, 4096, 0),    # one row past 32 q blocks
    (1, 2, 4, 100, 4196, 120, True, 4096, 4096),  # q_offset, Sq < a q block
    (1, 2, 2, 300, 300, 17, True, 128, 0),        # odd D: element loads
)


def _check_flash(dev):
    """flash_fwd against its plain version, out and lse: f32 within 2e-5
    and 1e-5 (the JAX kernel tests' tolerances); bf16 (the tensor-core
    kernel) against the plain version that rounds p where it does, out
    within one bf16 ulp plus its bound (see DOT_REL) and lse within 1e-5
    (the denominator is summed from the f32 p).  Returns [(dtype, max abs
    err)]."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(12)
    out = []
    for dt in (torch.float32, torch.bfloat16):
        tol = _float_tol("flash_fwd", dt)
        for B, Hkv, G, Sq, Sk, D, causal, window, qo in FLASH_CASES:
            if Sq == 32768 and dt == torch.float32:
                continue                      # the main path runs bf16
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                       for shape in ((B * Hkv * G, Sq, D), (B * Hkv, Sk, D),
                                     (B * Hkv, Sk, D)))
            kw = dict(causal=causal, window=window, scale=D ** -0.5,
                      q_offset=qo)
            got = fk.flash_fwd(q, k, v, **kw)
            want, bounds = _reference("flash_fwd", fk.flash_fwd_plain,
                                      (q, k, v), kw)
            what = f"flash_fwd {dt} {(B, Hkv, G, Sq, Sk, D, causal, window, qo)}"
            err = max(_close(g, w, f"{what} {name}", t, bd)
                      for g, w, name, t, bd in zip(
                          got, want, ("out", "lse"), tol, bounds))
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
    (2, 5, 384, 384, 128, True, 256, 0),          # qwen1.5-32b: D 128, G 5
    (1, 4, 1000, 1000, 120, True, 200, 0),        # window edge mid-tile
    (1, 4, 40, 4136, 120, True, 4096, 4096),      # q_offset, Sq < a q tile
)


def _check_flash_bwd(dev):
    """The two flash_bwd kernels against their plain version, dq, dk and
    dv, from the plain forward's lse and delta = sum(out * dout): f32
    within 2e-4 (the JAX kernel tests' tolerance for the gradients); bf16
    dq, dk and dv (tensor cores) against the plain versions that round ds
    (and p) where the kernels do, within one bf16 ulp plus their bounds
    (see DOT_REL).  Returns [(dtype, max abs err)]."""
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
            args = (q, k, v, do, lse, delta)
            got = fk.flash_bwd(*args, **kw)
            want, bounds = _reference("flash_bwd_dq", fk.flash_bwd_dq_plain,
                                      args, kw)
            dkv, dkv_bounds = _reference(
                "flash_bwd_dkv", fk.flash_bwd_dkv_plain, args, kw)
            what = (f"flash_bwd {dt} "
                    f"{(BHkv, G, Sq, Sk, D, causal, window, qo)}")
            err = max(_close(g, w, f"{what} {name}", tol, bd)
                      for g, w, name, tol, bd in zip(
                          got, want + dkv, ("dq", "dk", "dv"),
                          (tol_dq, tol_dkv, tol_dkv),
                          bounds + dkv_bounds))
            out.append((str(dt).replace("torch.", ""), err))
    return out


def _check_segment_spmm(dev):
    """segment_spmm against its plain version: with and without W and
    norm, f32 and bf16; D of 1, 31, 32, 33, 602 and 1433 with Dout up to
    130 (two W column tiles); K of 1, 7 and 40; row counts that leave a
    partial tile; a row of padding only and an id at the last row.  f32
    within 5e-5 (the W product sums up to 1,433 products in another order
    than cuBLAS; without W both sum in the same order), bf16 within one
    bf16 ulp plus 1e-4 near 0 (both round an f32 value once).  Returns
    [(dtype, max abs err)]."""
    import torch
    from repro_torch.kernels.segment_spmm import kernel as sk
    gen = torch.Generator(device=dev).manual_seed(14)
    out = []
    N = 3000
    for dt in (torch.float32, torch.bfloat16):
        tol = _float_tol("segment_spmm", dt)[0]
        for D, d_out in ((1, 5), (31, 16), (32, 128), (33, 130), (602, 128),
                         (1433, 16)):
            x = torch.randn((N, D), generator=gen, device=dev).to(dt)
            w = (torch.randn((D, d_out), generator=gen, device=dev)
                 * D ** -0.5).to(dt)
            for R, K in ((257, 7), (64, 1), (33, 40)):
                ids = torch.randint(-1, N, (R, K), generator=gen, device=dev,
                                    dtype=torch.int32)
                ids[0] = -1
                ids[-1, 0] = N - 1
                norm = torch.rand(R, generator=gen, device=dev)
                for ww, nn in ((w, norm), (None, None), (w, None),
                               (None, norm)):
                    err = _close(sk.segment_spmm(x, ids, ww, nn),
                                 sk.segment_spmm_plain(x, ids, ww, nn),
                                 f"segment_spmm {dt} D={D} R={R} K={K} "
                                 f"w={ww is not None} norm={nn is not None}",
                                 tol)
                    out.append((str(dt).replace("torch.", ""), err))
    return out


def _check_embedding_bag(dev):
    """embedding_bag against its plain version, sum and mean: f32 bit for
    bit (both sum the slots in order in f32 and divide once), bf16 within
    one ulp (the same f32 value rounded once); D of 1, 31, 32, 33, 602 and
    1433; bags of one slot, of 20 (BST's) and of 70 (three chunks of 32
    ids); empty bags (every id -1) and ids at the last row; and a float32
    table of 68,000,000 x 32 (2.18e9 elements, past an int32 offset) with
    ids near its end.  Returns [(dtype, max abs err)]."""
    import torch
    from repro_torch.kernels.embedding_bag import kernel as ek
    gen = torch.Generator(device=dev).manual_seed(15)
    out = []

    def one(table, ids, what):
        for mode in ek.MODES:
            got = ek.embedding_bag(table, ids, mode=mode)
            want = ek.embedding_bag_plain(table, ids, mode=mode)
            if table.dtype == torch.float32:
                _exact(_bits((got,)), _bits((want,)), f"{what} {mode}")
            out.append((str(table.dtype).replace("torch.", ""), _close(
                got, want, f"{what} {mode}",
                _float_tol("embedding_bag", table.dtype)[0])))
    V = 1000
    for dt in (torch.float32, torch.bfloat16):
        for D in (1, 31, 32, 33, 602, 1433):
            table = torch.randn((V, D), generator=gen, device=dev).to(dt)
            for B, L in ((37, 1), (300, 20), (5, 70)):
                ids = torch.randint(-1, V, (B, L), generator=gen, device=dev,
                                    dtype=torch.int32)
                ids[0] = -1
                ids[-1, 0] = V - 1
                one(table, ids, f"embedding_bag {dt} D={D} B={B} L={L}")
    V, D = 68_000_000, 32
    table = torch.randn((V, D), generator=gen, device=dev)
    ids = torch.randint(V - 3_000_000, V, (4096, 20), generator=gen,
                        device=dev, dtype=torch.int32)
    ids[::7, 3] = -1
    ids[0, 0] = V - 1
    one(table, ids, f"embedding_bag float32 V={V} (> 2^31 elements)")
    del table
    torch.cuda.empty_cache()
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
        from repro_torch.kernels.embedding_bag import kernel as ebk
        from repro_torch.kernels.segment_spmm import kernel as ssk
        self.best = {}
        self.mods = {"searchsorted_left_ranged": sk, "expand": ek,
                     "dedup_compact_rows": dk, "sort_rows": dk,
                     "sort_pairs": dk, "knn_topk": kk,
                     "searchsorted_left": sk, "rmsnorm_fwd": rk,
                     "flash_fwd": fk, "flash_bwd_dkv": fk,
                     "flash_bwd_dq": fk, "segment_spmm": ssk,
                     "embedding_bag": ebk}
        self.only = None          # record just these wrappers (None: all)
        self.extra = {}           # (wrapper, label) -> (size, args, kw)
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
            "flash_bwd_dq": lambda a, kw: a[0].numel() * a[1].shape[1],
            "segment_spmm": lambda a, kw: a[1].numel() * a[0].shape[1],
            "embedding_bag": lambda a, kw: a[1].numel() * a[0].shape[1]}

    # further calls timed beside the largest: knn_topk's largest one-row
    # call (nearest_k8/b1), dedup_compact_rows' and sort_rows' largest on
    # the mesh path
    EXTRA = {"knn_topk": ("r1", lambda a: a[0].shape[0] == 1),
             "dedup_compact_rows": ("mesh", lambda a: TIMED_PATH[0] ==
                                    "mesh"),
             "sort_rows": ("mesh", lambda a: TIMED_PATH[0] == "mesh")}

    def _wrap(self, name, fn):
        def rec(*args, **kw):
            size = None
            if self.only is None or name in self.only:
                size = self.WORK[name](args, kw)
                if size >= self.best.get(name, (-1,))[0]:
                    self.best[name] = (size, args, kw)
            label, want = self.EXTRA.get(name, (None, None))
            if label and want(args):
                size = self.WORK[name](args, kw) if size is None else size
                if size >= self.extra.get((name, label), (-1,))[0]:
                    self.extra[(name, label)] = (size, args, kw)
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
    TIMED_PATH[0] = path
    for cell, db, qs in batches:
        planner.reset_stats()
        t0 = time.perf_counter()
        res = db.query(qs, backend="kernel", **kw)
        _sync(dev)
        lat.setdefault(cell, []).append(time.perf_counter() - t0)
        results.append((cell, qs, res))
        peak[cell] = max(peak.get(cell, 0), planner.FRONTIER_STATS[key])
    launches[path] = dict(_cuda.LAUNCHES)
    TIMED_PATH[0] = None
    return lat, results, peak


TIMED_PATH = [None]     # the path whose batches _timed is running


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


# ---------------------------------------------------------------------------
# the write phase: a1-kg's update cell on phase 5's store
# ---------------------------------------------------------------------------

class _WriteLoad:
    """The write phase's op generator, and the host's record of what
    committed: the truth the read-backs hold the store to.

    A wave's transactions, in a shuffled order: ``ingest`` (two new films
    of one genre, each with a pool director and three new actors, and
    their director, genre and cast edges, unchecked, as a bulk load writes
    them; a wave's ingest uses distinct genres and directors), ``cast``
    (one checked film.actor edge from a film this phase created to an
    actor drawn by the loader's Zipf law), ``update`` (an actor's ``dob``:
    Zipf actors, and actors this phase created) and ``delete`` (a film
    and, by the cascade, its edges: films of pool directors, any film of
    the load, films this phase created).  A delete's cascade writes its
    film's genre and director edge lists, so a wave's deletes pick films
    of other genres and directors than its ingest: the index delta then
    fills by ~256 creates a wave and passes ``cap_idx_delta`` in 72.

    The cascade deletes the edges the delete's staging read, and its read
    set holds the vertex, not its edge lists (as in the JAX package): an
    edge committed after that snapshot (a ``cast`` of the wave before)
    outlives the film.  The truth keeps such edges as ``dangling``."""

    def __init__(self, kg, rng, sz):
        import numpy as np
        self.kg, self.db, self.rng, self.sz = kg, kg.db, rng, sz
        db = kg.db
        self.a0 = kg.n_directors
        self.g0 = self.a0 + kg.n_actors
        self.f0 = self.g0 + kg.n_genres
        self.col = {n: db.vt(t).attr(n).col for t, n in (
            ("film", "gross"), ("film", "year"), ("film", "genre"),
            ("actor", "dob"))}
        self.vtid = {n: db.vt(n).type_id for n in ("film", "actor")}
        self.et = {n: db.et(n).type_id for n in ("film.director",
                                                  "film.actor", "film.genre")}
        e = kg.edges
        m = e["etype"] == self.et["film.director"]
        # each loaded film's director and genre gid, by film index
        self.dir_of = np.empty(kg.n_films, np.int64)
        self.dir_of[e["dst"][m] - self.f0] = e["src"][m]
        mg = e["etype"] == self.et["film.genre"]
        self.genre_of = np.empty(kg.n_films, np.int64)
        self.genre_of[e["src"][mg] - self.f0] = e["dst"][mg]
        active = np.unique(e["src"][m])
        half = sz["pool"] // 2
        pool = np.concatenate([rng.choice(active, half, replace=False),
                               rng.choice(kg.n_directors, half,
                                          replace=False)])
        self.pool = np.unique(pool)
        own = np.isin(e["src"][m], self.pool)
        self.pool_films = [int(f) for f in rng.permutation(e["dst"][m][own])]
        self.key = {"film": 200_000_000, "actor": 300_000_000}
        self.dob_next = 5_000_000
        self.films = {}        # film gid -> truth of a film this phase made
        self.live = []         # those films, committed and not deleted
        self.actors = {}       # actor gid -> [key, dob] of actors it made
        self.dob = {}          # actor gid -> last committed dob (updates)
        self.deleted = {}      # gid -> (vtype name, key)
        self.dangling = {}     # deleted film -> {"out": set, "in": set}
        self.aborted_keys = []             # (vtype name, key)
        self.aborted_dob = []              # (gid, dob)
        self.busy = set()      # films a staged, uncommitted txn deletes
        self.rejected = {}     # staging ValueError message -> count
        self.stage_s = {}      # kind -> staging seconds
        self.committed_ops = 0

    # -- staging -------------------------------------------------------
    def plan(self) -> dict:
        """One wave: its transactions' kinds, shuffled, and the distinct
        pool directors and genres its ingest uses."""
        sz, rng = self.sz, self.rng
        kinds = (["ingest"] * sz["ingest"] + ["cast"] * sz["cast"]
                 + ["update"] * sz["update"] + ["delete"] * sz["delete"])
        rng.shuffle(kinds)
        dirs = [int(d) for d in rng.choice(self.pool, 2 * sz["ingest"],
                                           replace=False)]
        genres = [self.g0 + int(g) for g in rng.choice(
            self.kg.n_genres, sz["ingest"], replace=False)]
        return dict(kinds=kinds, dirs=dirs, genres=genres,
                    taken=set(dirs) | set(genres))

    def stage(self, kind, wave):
        """Stage one transaction of ``kind``; returns (txn, meta), or None
        when there is nothing to stage or staging raised ``ValueError``
        (counted by message)."""
        t = self.db.create_transaction()
        t0 = time.perf_counter()
        try:
            meta = getattr(self, f"_{kind}")(t, wave)
        except ValueError as err:
            self.rejected[str(err)] = self.rejected.get(str(err), 0) + 1
            meta = None
        self.stage_s[kind] = (self.stage_s.get(kind, 0.0)
                              + time.perf_counter() - t0)
        if meta is None:
            return None
        meta["kind"] = kind
        return t, meta

    def _new_key(self, vt):
        self.key[vt] += 1
        return self.key[vt]

    def _ingest(self, t, wave):
        from repro_torch.core.writes import CreateEdge, CreateVertex
        rng = self.rng
        genre = wave["genres"].pop()
        films, ops, edges = [], [], []
        for _ in range(2):
            fat = {"gross": float(rng.uniform(1, 500)),
                   "year": int(rng.integers(1960, 2026)),
                   "genre": genre - self.g0}
            acts = [(self._new_key("actor"), int(rng.integers(1940, 2000)))
                    for _ in range(3)]
            films.append(dict(key=self._new_key("film"), attrs=fat,
                              director=wave["dirs"].pop(), genre=genre,
                              acts=acts))
            ops += ([CreateVertex("film", films[-1]["key"], fat)]
                    + [CreateVertex("actor", k, {"dob": d})
                       for k, d in acts])
        gids = self.db.write(ops, txn=t).gids
        for j, f in enumerate(films):
            film, actors = gids[4 * j], gids[4 * j + 1:4 * j + 4]
            f.update(film=film, actors=[(a, k, d) for a, (k, d) in
                                        zip(actors, f.pop("acts"))])
            edges += ([CreateEdge(f["director"], film, "film.director",
                                  check=False),
                       CreateEdge(film, genre, "film.genre", check=False)]
                      + [CreateEdge(film, a, "film.actor", check=False)
                         for a in actors])
        self.db.write(edges, txn=t)
        return dict(films=films, ops=len(ops) + len(edges))

    def _zipf_actor(self):
        k = zipf_keys(self.rng, self.kg.n_actors, 0, 1)[0]
        return self.a0 + int(k)

    def _cast(self, t, wave):
        from repro_torch.core.writes import CreateEdge
        if not self.live:
            return None
        film = self.live[int(self.rng.integers(len(self.live)))]
        actor = self._zipf_actor()
        if film in self.busy or actor in self.films[film]["actors"]:
            return None
        self.db.write([CreateEdge(film, actor, "film.actor")], txn=t)
        return dict(film=film, actor=actor, ops=1)

    def _update(self, t, wave):
        from repro_torch.core.writes import UpdateVertex
        if self.actors and self.rng.random() < 0.25:
            mine = list(self.actors)
            gid = mine[int(self.rng.integers(len(mine)))]
        else:
            gid = self._zipf_actor()
        self.dob_next += 1
        self.db.write([UpdateVertex(gid, "actor", {"dob": self.dob_next})],
                      txn=t)
        return dict(gid=gid, dob=self.dob_next, ops=1)

    def _target(self):
        """A film to delete: a pool director's, any loaded one, or one this
        phase made (from the older half)."""
        r = self.rng.random()
        if r < 0.25 and self.pool_films:
            return self.pool_films.pop()
        if r < 0.5 or len(self.live) < 8:
            return self.f0 + int(self.rng.integers(self.kg.n_films))
        return self.live[int(self.rng.integers(len(self.live) // 2))]

    def _delete(self, t, wave):
        from repro_torch.core.writes import DeleteVertex
        for _ in range(8):
            film = self._target()
            if film in self.busy or film in self.deleted:
                continue
            if film in self.films:
                lists = {self.films[film]["director"],
                         self.films[film]["genre"]}
            else:
                lists = {int(self.dir_of[film - self.f0]),
                         int(self.genre_of[film - self.f0])}
            if not lists & wave["taken"]:
                break
        else:
            return None
        self.db.write([DeleteVertex(film)], txn=t)
        self.busy.add(film)
        return dict(film=film, ops=1 + len(t.delete_e),
                    cascade=set(t.delete_e))

    # -- outcomes ------------------------------------------------------
    def settle(self, metas, statuses, reasons, counts):
        for meta, st, why in zip(metas, statuses, reasons):
            kind = meta["kind"]
            if kind == "delete":
                self.busy.discard(meta["film"])
            if st != "COMMITTED":
                counts[why] = counts.get(why, 0) + 1
                if kind == "ingest":
                    for f in meta["films"]:
                        self.aborted_keys += [("film", f["key"])] + [
                            ("actor", k) for _, k, _ in f["actors"]]
                elif kind == "update":
                    self.aborted_dob.append((meta["gid"], meta["dob"]))
                continue
            counts["committed"] = counts.get("committed", 0) + 1
            self.committed_ops += meta["ops"]
            if kind == "ingest":
                for f in meta["films"]:
                    self.films[f["film"]] = dict(
                        f, actors={a for a, _, _ in f["actors"]})
                    self.live.append(f["film"])
                    for a, k, dob in f["actors"]:
                        self.actors[a] = [k, dob]
            elif kind == "cast":
                self.films[meta["film"]]["actors"].add(meta["actor"])
            elif kind == "update":
                self.dob[meta["gid"]] = meta["dob"]
                if meta["gid"] in self.actors:
                    self.actors[meta["gid"]][1] = meta["dob"]
            else:
                f = meta["film"]
                key = (self.films[f]["key"] if f in self.films
                       else 100_000 + f - self.f0)
                self.deleted[f] = ("film", key)
                self.dangling[f] = {"out": set(), "in": set()}
                if f in self.films:
                    self.live.remove(f)
                    self._dangle(f, meta["cascade"])

    def _dangle(self, f, cascade):
        """The edges of film ``f`` its delete's cascade did not name."""
        et, t, d = self.et, self.films[f], self.dangling[f]
        d["out"] = ({a for a in t["actors"]
                     if (f, a, et["film.actor"]) not in cascade}
                    | ({t["genre"]} - {g for _, g, e in cascade
                                       if e == et["film.genre"]}))
        if (t["director"], f, et["film.director"]) not in cascade:
            d["in"] = {t["director"]}


def _chunks_of(xs, n):
    return [xs[i:i + n] for i in range(0, len(xs), n)]


def _lookup_many(db, vtid, keys, ts):
    """Gids (-1: not found) of (vtid, key) pairs at ``ts``, 1,024 at once
    (the index-delta scan is a (probes x delta) mask)."""
    import numpy as np
    import torch
    from repro_torch.core import index as index_mod
    out = []
    for part in _chunks_of(list(keys), 1024):
        k = torch.as_tensor(np.asarray(part, np.int32), device=db.device)
        g, _ = index_mod.lookup(db.store, db.cfg, torch.full_like(k, vtid),
                                k, torch.ones_like(k, dtype=torch.bool),
                                int(ts))
        out.append(g.cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0, np.int32)


def _rows_many(db, gids, ts):
    """(f32 rows, i32 rows, alive) of ``gids`` at ``ts``."""
    import numpy as np
    import torch
    from repro_torch.core.store import gather_data
    g = torch.as_tensor(np.asarray(gids, np.int32), device=db.device)
    f, i, alive = gather_data(db.store, db.cfg, g, int(ts))
    return f.cpu().numpy(), i.cpu().numpy(), alive.cpu().numpy()


def _edge_sets(db, gids, direction, etype, ts):
    """{gid: set of neighbours} over edges of ``etype`` in ``direction`` at
    ``ts``, 256 vertices an expansion."""
    import numpy as np
    import torch
    from repro_torch.core import edges as edges_mod
    out = {int(g): set() for g in gids}
    for part in _chunks_of(list(gids), 256):
        g = torch.as_tensor(np.asarray(part, np.int32), device=db.device)
        q = torch.arange(g.shape[0], dtype=torch.int32, device=db.device)
        oq, on, ov, ovf = edges_mod.expand(
            db.store, db.cfg, q, g, torch.ones_like(g, dtype=torch.bool),
            etype=int(etype), direction=direction, read_ts=int(ts),
            cap_out=64 * len(part))
        check(not bool(ovf), "read-back: edge expansion overflowed")
        oq, on, ov = (x.cpu().numpy() for x in (oq, on, ov))
        for a, b in zip(oq[ov], on[ov]):
            out[int(part[a])].add(int(b))
    return out


def _write_readback(load, batch, rec0, ts0, caps, dev):
    """The store against the host's truth at the current clock, the
    query batch against ``backend="ref"`` now and against ``rec0`` at
    ``ts0``.  Returns the number of vertices and edges checked."""
    import numpy as np
    db, col, now = load.db, load.col, load.db.clock
    films = [f for f in load.films if f not in load.deleted]
    # every vertex created in a committed wave: found by key, attributes
    fkeys = [load.films[f]["key"] for f in films]
    check(np.array_equal(_lookup_many(db, load.vtid["film"], fkeys, now),
                         np.asarray(films)), "read-back: a film is lost")
    fr, ir, alive = _rows_many(db, films, now)
    want_g = np.asarray([load.films[f]["attrs"]["gross"] for f in films],
                        np.float32)
    check(alive.all() and np.array_equal(fr[:, col["gross"]].view(np.int32),
                                         want_g.view(np.int32))
          and ir[:, col["year"]].tolist() == [
              load.films[f]["attrs"]["year"] for f in films]
          and ir[:, col["genre"]].tolist() == [
              load.films[f]["attrs"]["genre"] for f in films],
          "read-back: a film's attributes differ")
    acts = list(load.actors)
    check(np.array_equal(_lookup_many(db, load.vtid["actor"],
                                      [load.actors[a][0] for a in acts],
                                      now), np.asarray(acts)),
          "read-back: an actor is lost")
    dob = dict(load.dob)
    dob.update({a: v for a, (_, v) in load.actors.items()})
    upd = list(dob)
    _, ir, alive = _rows_many(db, upd, now)
    check(alive.all() and ir[:, col["dob"]].tolist() == [dob[g] for g in upd],
          "read-back: an actor's dob is not its last committed one")
    # every film's edges, from the film's side, equal the truth
    et = {n: db.et(n).type_id for n in ("film.director", "film.actor",
                                         "film.genre")}
    got_a = _edge_sets(db, films, "out", et["film.actor"], now)
    got_g = _edge_sets(db, films, "out", et["film.genre"], now)
    got_d = _edge_sets(db, films, "in", et["film.director"], now)
    for f in films:
        t = load.films[f]
        check(got_a[f] == t["actors"] and got_g[f] == {t["genre"]}
              and got_d[f] == {t["director"]},
              f"read-back: film {f}'s edges differ from the committed ones")
    # every deleted vertex and the edges its cascade named are gone
    dead = list(load.deleted)
    check((_lookup_many(db, load.vtid["film"],
                        [load.deleted[g][1] for g in dead], now) < 0).all()
          and not _rows_many(db, dead, now)[2].any(),
          "read-back: a deleted film is still visible")
    for d in ("out", "in"):
        got = _edge_sets(db, dead, d, -1, now)
        check(all(got[g] == load.dangling[g][d] for g in dead),
              f"read-back: a deleted film's {d}-edges differ from the "
              "edges its cascade did not name")
    # no write of an aborted transaction is visible
    for vt in ("film", "actor"):
        keys = [k for v, k in load.aborted_keys if v == vt]
        check((_lookup_many(db, load.vtid[vt], keys, now) < 0).all(),
              f"read-back: an aborted {vt} create is visible")
    if load.aborted_dob:
        gids = [g for g, _ in load.aborted_dob]
        cur = _rows_many(db, gids, now)[1][:, col["dob"]]
        check(all(c != v for c, (_, v) in zip(cur, load.aborted_dob)),
              "read-back: an aborted update is visible")
    # the query batch: against ref now, against the pre-wave record at ts0
    res = db.query(batch, caps=caps, fused=True, backend="kernel")
    _same(res, db.query(batch, caps=caps, fused=True, backend="ref"),
          "write read-back at the new clock")
    _same(db.query(batch, caps=caps, fused=True, backend="kernel",
                   read_ts=ts0), rec0, "write read-back at the pinned ts")
    _sync(dev)
    n_edges = sum(len(s) for s in got_a.values()) + 2 * len(films)
    return len(films) + len(acts) + len(upd) + len(dead), n_edges


class _PackTimer:
    """Times the planner's pack of a wave's delta matches
    (``planner._fit_delta``) on the calls that pack: on the card, CUDA
    events around each call (its host read of the width included); on the
    CPU, the host clock."""

    def __init__(self, planner_mod, dev):
        self.mod, self.fit, self.dev = planner_mod, planner_mod._fit_delta, dev
        self.calls = []          # (columns in, columns out, start, end)
        planner_mod._fit_delta = self._fit

    def _stamp(self):
        import torch
        if self.dev.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _fit(self, dn, row_w, backend):
        t0 = self._stamp()
        out = self.fit(dn, row_w, backend)
        if out is not dn:
            self.calls.append((dn.shape[1], out.shape[1], t0, self._stamp()))
        return out

    def restore(self):
        self.mod._fit_delta = self.fit

    def summary(self) -> dict:
        import numpy as np
        _sync(self.dev)
        if self.dev.type == "cuda":
            ms = [a.elapsed_time(b) for _, _, a, b in self.calls]
        else:
            ms = [(b - a) * 1e3 for _, _, a, b in self.calls]
        out = [c[1] for c in self.calls]
        return dict(calls=len(ms), ms_total=float(np.sum(ms)),
                    ms_p50=float(np.median(ms)) if ms else None,
                    ms_max=float(np.max(ms)) if ms else None,
                    columns_in_max=max((c[0] for c in self.calls),
                                       default=None),
                    columns_out_p50=float(np.median(out)) if out else None,
                    columns_out_max=max(out, default=None))


def phase_write(kg, dev, sz, launches, rec=None, caps_kw=A1_CAPS):
    """The a1-kg ``update`` cell: ``sz["waves"]`` mutation waves through
    ``GraphDB.write(txns)`` on phase 5's store, a quarter of each wave
    staged before the previous wave commits; read-backs every
    ``readback_every`` waves and after the last; one WRITE line."""
    import numpy as np
    import torch
    from repro_torch.core.query import planner as planner_mod
    from repro_torch.core.query.executor import QueryCaps
    from repro_torch.core.writes import CapacityError, DeleteVertex
    from repro_torch.kernels import _cuda
    db = kg.db
    caps = QueryCaps(**caps_kw)
    rng = np.random.default_rng(11)
    load = _WriteLoad(kg, rng, sz)
    packs = _PackTimer(planner_mod, dev)
    only = rec.only if rec is not None else None
    if rec is not None:
        rec.only = set()        # the kernel report keeps the serve inputs
    _cuda.reset_launches()
    t_phase = time.perf_counter()

    # the top director's edge list is over get_edges' cap of 4,096 at full
    # size: staging its delete raises, as the JAX package's does
    hub_deg = int(np.count_nonzero(kg.edges["src"] == 0))
    if hub_deg > 4096:
        try:
            db.write([DeleteVertex(0)], txn=db.create_transaction())
            check(False, "staging a hub director's delete did not raise")
        except CapacityError:
            pass
    # the read-back batch, its pre-wave results, and the snapshot pin
    dk = [1_000 + int(d) for d in load.pool]
    hot = [10_000 + a for a in range(16)]
    batch = [q1(dk[j % len(dk)]) if j < 22 else
             q3(dk[j % len(dk)], hot[j % 16]) if j < 43 else
             q_select(dk[j % len(dk)]) for j in range(64)]
    ts0 = db.clock
    rec0 = db.query(batch, caps=caps, fused=True, backend="kernel")
    _same(rec0, db.query(batch, caps=caps, fused=True, backend="ref"),
          "write read-back batch before the waves")
    db.active_query_ts.append(ts0)

    comp = []

    def timed(kind, fn):
        def run():
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            comp.append(dict(kind=kind, wave=wave,
                             seconds=time.perf_counter() - t0))
        return run
    for kind in ("run_compaction", "run_index_compaction",
                 "run_vindex_compaction"):
        setattr(db, kind, timed(kind, getattr(db, kind)))

    def stage_part(plan, kinds):
        t0 = time.perf_counter()
        out = [x for x in (load.stage(k, plan) for k in kinds) if x]
        return out, time.perf_counter() - t0

    W = sz["waves"]
    stage_s, commit_s, counts, n_txns, checked = [], [], {}, 0, [0, 0]
    readback_s = 0.0
    timed = [0, 0]           # committed ops and txns of the timed waves
    plan = load.plan()
    q = len(plan["kinds"]) // 4
    early, early_s = stage_part(plan, plan["kinds"][:q])
    for wave in range(W):
        late, late_s = stage_part(plan, plan["kinds"][q:])
        if wave + 1 < W:           # the next wave's first quarter, staged
            plan = load.plan()     # before this wave commits
            nxt, nxt_s = stage_part(plan, plan["kinds"][:q])
        else:
            nxt, nxt_s = [], 0.0
        staged = early + late
        txns = [t for t, _ in staged]
        n_txns += len(txns)
        check(bool(txns), f"wave {wave} staged no transaction")
        _sync(dev)
        t0 = time.perf_counter()
        if wave == W - 1 and dev.type == "cuda":
            # the last wave's commit is profiled, and left out of the
            # commit times (the profiler's start-up is in its wall time)
            out = []
            _profile("write/update", lambda: out.append(db.write(txns)),
                     float(np.median(commit_s)), wave=wave)
            res = out[0]
        else:
            res = db.write(txns)
            _sync(dev)
            commit_s.append(time.perf_counter() - t0)
        stage_s.append(early_s + late_s)
        before = (load.committed_ops, counts.get("committed", 0))
        load.settle([m for _, m in staged], res.statuses, res.reasons,
                    counts)
        if len(commit_s) == len(stage_s):      # a timed wave
            timed[0] += load.committed_ops - before[0]
            timed[1] += counts.get("committed", 0) - before[1]
        early, early_s = nxt, nxt_s
        if (wave + 1) % sz["readback_every"] == 0 or wave == W - 1:
            t0 = time.perf_counter()
            n_v, n_e = _write_readback(load, batch, rec0, ts0, caps, dev)
            readback_s += time.perf_counter() - t0
            checked[0] += n_v
            checked[1] += n_e
    db.active_query_ts.remove(ts0)
    for kind in ("run_compaction", "run_index_compaction",
                 "run_vindex_compaction"):
        delattr(db, kind)
    packs.restore()
    launches["write"] = dict(_cuda.LAUNCHES)
    if rec is not None:
        rec.only = only
    secs = float(np.sum(stage_s[:len(commit_s)]) + np.sum(commit_s))
    st_ms, cm_ms = np.asarray(stage_s) * 1e3, np.asarray(commit_s) * 1e3
    say("WRITE", cell="write/update", waves=W, txns_staged=n_txns,
        committed=counts.get("committed", 0),
        aborted={k: v for k, v in counts.items() if k != "committed"},
        stage_rejected=load.rejected, committed_ops=load.committed_ops,
        dangling_edges=sum(len(d["out"]) + len(d["in"])
                           for d in load.dangling.values()),
        ops_per_s=timed[0] / secs, committed_txns_per_s=timed[1] / secs,
        timed_waves=len(commit_s),
        stage_ms_p50=float(np.median(st_ms)),
        stage_ms_p99=float(np.percentile(st_ms, 99)),
        commit_ms_p50=float(np.median(cm_ms)),
        commit_ms_p99=float(np.percentile(cm_ms, 99)),
        stage_s_by_kind=load.stage_s, readback_s=readback_s,
        delta_pack=packs.summary(),
        inline_compactions=comp, readbacks=-(-W // sz["readback_every"]),
        checked_vertices=checked[0], checked_edges=checked[1],
        hub_out_degree=hub_deg, clock=db.clock,
        phase_seconds=time.perf_counter() - t_phase,
        store_bytes=db.store.nbytes(),
        memory_allocated=(torch.cuda.memory_allocated()
                          if dev.type == "cuda" else None),
        reduced="n_shards 256 -> 1")
    kinds = {c["kind"] for c in comp}
    check({"run_compaction", "run_index_compaction"} <= kinds,
          f"the waves ran the inline backstops {sorted(kinds)}, not both")
    say("WRITE_PARITY", readbacks_equal_to_ref=True,
        pinned_snapshot_equal=True)


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
    # the imbalance on several shards; vertex slots, index entries and
    # vector entries have room for the write wave of phase_nearest
    room = DOC_WRITE_ROOM
    cfg = StoreConfig(n_shards=S, cap_v=per_v + room, cap_e=cap_e,
                      cap_delta=16_384,
                      cap_idx=per_v + room if S == 1 else 2 * per_v,
                      cap_idx_delta=16_384,
                      cap_vec=-(-n_docs // S) + room, d_f32=d, d_i32=2)
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
    _nearest_write(db, dev, sizes, cells, runs, caps)


def _nearest_write(db, dev, sizes, cells, runs, caps):
    """One write wave on the doc store (32 transactions, each creating 4
    docs with their doc.tag edges and updating 4 docs' embeddings, through
    ``GraphDB.write``, so ``vindex.apply_wave`` appends and tombstones),
    then the fold (``run_vindex_compaction``) with phase 7's ``read_ts``
    pinned: ``Nearest`` at the new clock equals ``backend="ref"``, at the
    pinned ``read_ts`` it equals phase 7's results; then the fold again
    unpinned, which drops the replaced vectors."""
    import numpy as np
    from repro_torch.core.writes import CreateEdge, CreateVertex, UpdateVertex
    rng = np.random.default_rng(3)
    n_docs, d = sizes["n_docs"], sizes["d"]
    n_tags = n_docs // 16
    ts7, vx0 = db.clock, int(db.vx_count.sum())
    db.active_query_ts.append(ts7)

    def emb():
        return {f"f{c}": float(x) for c, x in
                enumerate(rng.standard_normal(d).astype(np.float32))}
    t0 = time.perf_counter()
    upd = rng.choice(n_docs, 128, replace=False)
    tags = n_docs + rng.choice(n_tags, 128, replace=False)
    txns = []
    for j in range(32):
        t = db.create_transaction()
        gids = db.write([CreateVertex("doc", n_docs + 4 * j + k, emb())
                         for k in range(4)], txn=t).gids
        db.write([CreateEdge(g, int(tags[4 * j + k]), "doc.tag", check=False)
                  for k, g in enumerate(gids)]
                 + [UpdateVertex(int(g), "doc", emb())
                    for g in upd[4 * j:4 * j + 4]], txn=t)
        txns.append(t)
    stage_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = db.write(txns)
    _sync(dev)
    commit_s = time.perf_counter() - t0
    check(not res.failed, f"doc wave aborted: {set(res.reasons)}")
    check(int(db.vx_count.sum()) == vx0 + 256,
          "doc wave: 128 creates and 128 updates append 256 vectors")
    folds = []
    for pinned in (True, False):
        if not pinned:
            db.active_query_ts.remove(ts7)
        t0 = time.perf_counter()
        db.run_vindex_compaction()
        _sync(dev)
        folds.append(time.perf_counter() - t0)
        check(int(db.vx_count.sum()) == vx0 + (256 if pinned else 128),
              f"doc fold, pinned={pinned}: {int(db.vx_count.sum())} "
              f"entries left of {vx0 + 256}")
        for cell, bs, kw in cells:
            res = db.query(bs[0], caps=caps, backend="kernel", **kw)
            _same(res, db.query(bs[0], caps=caps, backend="ref", **kw),
                  f"{cell} after the doc wave, pinned={pinned}")
        if pinned:
            n = 0
            for path, kw in (("nearest", {}), ("nearest_shared",
                                               {"budget": "shared"})):
                for cell, qs, res in runs[path]:
                    _same(db.query(qs, caps=caps, backend="kernel",
                                   read_ts=ts7, **kw), res,
                          f"{cell} at phase 7's read_ts after the wave")
                    n += 1
    say("NEAREST_WRITE", txns=len(txns), docs_created=128,
        embeddings_updated=128, stage_ms=stage_s * 1e3,
        commit_ms=commit_s * 1e3, fold_pinned_s=folds[0],
        fold_unpinned_s=folds[1], vx_count=int(db.vx_count.sum()),
        batches_equal_at_pinned_ts=n, new_clock_equal_to_ref=True)


def _global_names(csrc: str) -> frozenset:
    """The names of the ``__global__`` functions in the CUDA sources
    (``*.cu``, ``*.cuh``) under ``csrc``."""
    import glob
    import re
    names = set()
    for path in sorted(glob.glob(os.path.join(csrc, "*.cu*"))):
        with open(path) as f:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+)\s*[(<]", f.read()))
    return frozenset(names)


# every kernel of the port, by its name in the sources: PROFILE's "own
# kernels ms" sums the device events whose name is one of them
OWN_KERNELS = _global_names(os.path.join(ROOT, "src", "repro_torch", "csrc"))


def _is_own(key: str) -> bool:
    """A profiler event's key names one of the port's kernels: as a whole
    word of the demangled name (namespace, template and argument types
    around it) or as a length-prefixed name of a mangled one."""
    import re
    words = set(re.findall(r"\w+", key))
    return any(k in words or f"{len(k)}{k}" in key for k in OWN_KERNELS)


# the bf16 LM paths' flash kernels, by route: (tensor-core kernel, CUDA-core
# kernel it must not run), per wrapper
TC_ROUTE = {"flash_fwd": ("flash_fwd_tc_kernel", "flash_fwd_kernel"),
            "flash_bwd_dkv": ("flash_bwd_dkv_tc_kernel",
                              "flash_bwd_dkv_kernel"),
            "flash_bwd_dq": ("flash_bwd_dq_tc_kernel", "flash_bwd_dq_kernel")}


def phase_profile(db, cell, qs, p50_s, **kw):
    """Device busy time and kernel launches of one fused batch (profiler):
    see :func:`_profile`."""
    _profile(cell, lambda: db.query(qs, backend="kernel", **kw), p50_s)


def _profile(cell, fn, p50_s, **extra):
    """Device busy time and kernel launches of one call of ``fn``
    (profiler): the share of it in the port's own kernels, and the busy
    time against the profiled call's wall time and the unprofiled p50
    latency.  The whole table goes to ``profile_<cell>.txt`` in the output
    directory.  Returns {kernel name: launches} of the device events."""
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
    own_us = sum(e.self_device_time_total for e in kern if _is_own(e.key))
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
    return {e.key: e.count for e in kern}


def _check_tc_route(cell, counts, launched: dict):
    """The profiled call of a bf16 LM cell ran each flash wrapper's
    tensor-core kernel once a wrapper launch (``launched``: {wrapper:
    launches a call, as ``_lm_launch_check`` holds them}) and never its
    CUDA-core kernel."""
    import re
    for name, n in launched.items():
        tc, cores = TC_ROUTE[name]
        got = {k: sum(c for key, c in counts.items()
                      if re.search(rf"\b{k}\b", key)) for k in (tc, cores)}
        check(got[tc] == n and got[cores] == 0,
              f"{cell}: {name} launched {n} times, the profile shows "
              f"{got[tc]} {tc} and {got[cores]} {cores}")
    say("ROUTE", cell=cell, tensor_core_launches=launched)


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
        counts = _profile("lm_prefill_32k", lambda: T.prefill(p, cfg, toks),
                          p50)
        _check_tc_route("lm/prefill_32k", counts,
                        {"flash_fwd": cfg.n_layers})


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
        counts = _profile("lm_train_4k", step, p50)
        _check_tc_route("lm/train_4k", counts,
                        {"flash_fwd": 2 * L, "flash_bwd_dkv": L,
                         "flash_bwd_dq": L})
    del p, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    say("LM_TRAIN_PHASE", seconds=time.perf_counter() - t_phase,
        config=cfg.name, source="src/repro/configs/h2o_danube_3_4b.py")


# ---------------------------------------------------------------------------
# the GNN and recsys zoo: gcn-cora, graphsage-reddit and bst
# ---------------------------------------------------------------------------

def _ell(batch, n: int, k=None):
    """(ids (n, k) int32, in-degree (n,) float32): each node's first ``k``
    in-neighbours in edge order, padded with -1 (``k`` None: the largest
    in-degree, so that every edge is kept).  The ELL layout
    ``segment_spmm`` takes; the JAX package has no builder for it."""
    import torch
    ok = batch.edge_src >= 0
    src, dst = batch.edge_src[ok].long(), batch.edge_dst[ok].long()
    order = torch.argsort(dst, stable=True)
    src, dst = src[order], dst[order]
    deg = torch.bincount(dst, minlength=n)
    rank = torch.arange(dst.numel(), device=dst.device) - \
        (torch.cumsum(deg, 0) - deg)[dst]
    k = int(deg.max()) if k is None else k
    keep = rank < k
    ids = torch.full((n, k), -1, dtype=torch.int32, device=dst.device)
    ids[dst[keep], rank[keep]] = src[keep].int()
    return ids, deg.float()


def _zoo_check(dev, cell, mod, cfg, params_cpu, args_cpu, logits=None):
    """The first step's loss and every gradient (``tree.value_and_grad``
    of ``mod.loss_fn``) on the card against the same step on the CPU (the
    port's code, which the CPU tests hold against JAX), from the same
    params and inputs; ``logits`` (a forward) compared as well."""
    from repro_torch.core.tree import leaves, tree_map, value_and_grad
    args_dev = [a.to(dev) for a in args_cpu]
    params = tree_map(lambda t: t.to(dev), params_cpu)
    runs = {}
    for name, p, a in (("cpu", params_cpu, args_cpu),
                       ("dev", params, args_dev)):
        t0 = time.perf_counter()
        (loss, _), g = value_and_grad(mod.loss_fn, p, cfg, *a)
        out = logits(p, a) if logits else None
        _sync(dev)
        runs[name] = (float(loss), dict(leaves(g)), out,
                      time.perf_counter() - t0)
    (lc, gc, oc, _), (ld, gd, od, _) = runs["cpu"], runs["dev"]
    loss_err = abs(ld - lc) / abs(lc)
    errs = {".".join(map(str, k)): _rel_err(gd[k].cpu(), gc[k]) for k in gc}
    out_err = _rel_err(od.cpu(), oc) if logits else None
    check(loss_err <= ZOO_LOSS_TOL
          and all(e <= ZOO_GRAD_TOL for e in errs.values())
          and (out_err is None or out_err <= ZOO_LOSS_TOL),
          f"{cell}: card vs CPU loss {ld} vs {lc}, logits {out_err}, "
          f"gradients {errs}")
    say("ZOO_CHECK", cell=cell, config=cfg.name, loss_cpu=lc, loss_dev=ld,
        loss_rel_err=loss_err, logits_rel_err=out_err,
        grad_rel_err_max=max(errs.values()), grad_rel_err=errs,
        tolerance=dict(loss=ZOO_LOSS_TOL, grads=ZOO_GRAD_TOL),
        seconds={k: v[3] for k, v in runs.items()})
    return params


def _zoo_timed(dev, cell, step, sizes, **line):
    """``warm_steps`` then ``timed_steps`` train steps (``step()`` returns
    the metrics), host clock ending in a synchronize; the loss must stay
    finite and fall from the first step to the last.  Prints a ZOO_TRAIN
    line; returns the p50 in seconds."""
    import numpy as np
    import torch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, gnorms, secs = [], [], []
    for i in range(sizes["warm_steps"] + sizes["timed_steps"]):
        t0 = time.perf_counter()
        m = step()
        _sync(dev)
        if i >= sizes["warm_steps"]:
            secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    check(all(np.isfinite(losses + gnorms)), f"{cell}: {losses} {gnorms}")
    check(losses[-1] < losses[0], f"{cell}: the loss did not fall: {losses}")
    p50 = float(np.median(secs))
    say("ZOO_TRAIN", cell=cell, p50_ms=p50 * 1e3, ms=[s * 1e3 for s in secs],
        losses=losses, gnorms=gnorms,
        peak_memory_allocated=(torch.cuda.max_memory_allocated()
                               if dev.type == "cuda" else None),
        **{k: (v(p50) if callable(v) else v) for k, v in line.items()})
    if dev.type == "cuda":
        _profile(cell, step, p50)
    return p50


def _gnn_cell(dev, arch_conf, shape_id, sizes, seed, *, batch_cpu=None,
              geometry=None, reduced=()):
    """One GNN cell at the config's full widths, ``d_in`` the features of
    its graph (as ``steps.gnn_cell_config`` sets it): ``batch_cpu``, whose
    first step on the card is checked against the CPU, or a synthetic graph
    of ``geometry`` (the cell's own by default) made on the card; then the
    timed AdamW steps.  Returns (params, batch)."""
    import dataclasses
    import torch
    from repro_torch.data.graphs import synthetic_graph_batch
    from repro_torch.launch import steps
    from repro_torch.optim.optimizers import AdamWConfig, init_opt_state
    spec = arch_conf.SPEC
    if batch_cpu is not None:
        N, E = batch_cpu.node_feat.shape[0], batch_cpu.edge_src.shape[0]
        dF = batch_cpu.node_feat.shape[1]
    else:
        N, E, dF, _ = geometry or steps.gnn_geometry(
            spec.cell(shape_id), sizes["reduced_geometry"])
    cfg = dataclasses.replace(spec.model, d_in=dF)
    mod = steps.gnn_module(cfg)
    cell = f"zoo/{spec.arch_id}/{shape_id}"
    gen = torch.Generator(device="cpu" if batch_cpu is not None else dev)
    gen.manual_seed(seed)
    if batch_cpu is not None:
        p_cpu = mod.init_params(cfg, gen, device="cpu")
        params = _zoo_check(dev, cell, mod, cfg, p_cpu, [batch_cpu])
        batch = batch_cpu.to(dev)
        del p_cpu
    else:
        t0 = time.perf_counter()
        batch = synthetic_graph_batch(N, E, dF, n_classes=cfg.n_classes,
                                      seed=seed, device=dev)
        say("ZOO_LOAD", cell=cell, nodes=N, edges=E, d_feat=dF,
            seconds=time.perf_counter() - t0)
        params = mod.init_params(cfg, gen, device=dev)
    ocfg = AdamWConfig()
    state = init_opt_state(params, ocfg)

    def step():
        nonlocal params, state
        params, state, m = steps.gnn_train_step(params, state, batch, cfg,
                                                ocfg)
        return m
    _zoo_timed(dev, cell, step, sizes, config=cfg.name, nodes=N, edges=E,
               d_feat=dF, layers=cfg.n_layers, reduced=list(reduced),
               source=spec.source, edges_per_s=lambda p50: E / p50)
    del state
    return params, batch


def _bst_cells(dev, sizes):
    """zoo/bst/check (n_items cut to ``check_items``: logits and gradients
    on the card against the CPU), zoo/bst/train_batch (FULL, AdamW f32
    moments, timed) and the two serve cells with the trained params.
    Returns (params, the train batch's hist)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import bst
    from repro_torch.data.recsys import bst_batch
    from repro_torch.launch import steps
    from repro_torch.models import recsys as R
    from repro_torch.optim.optimizers import AdamWConfig, init_opt_state
    spec = bst.SPEC
    # check: n_items cut so that the CPU holds the model
    cfg_c = dataclasses.replace(spec.model, n_items=sizes["check_items"])
    p_cpu = R.init_params(cfg_c, torch.Generator().manual_seed(21),
                          device="cpu")
    b_cpu = bst_batch(batch=sizes["check_batch"], n_items=cfg_c.n_items,
                      seed=22, device="cpu")
    _zoo_check(dev, "zoo/bst/check", R, cfg_c, p_cpu, list(b_cpu),
               logits=lambda p, a: R.forward(p, cfg_c, *a[:3]))
    del p_cpu, b_cpu
    cfg = spec.model if sizes["bst_items"] is None else \
        dataclasses.replace(spec.model, n_items=sizes["bst_items"])
    c = spec.cell("train_batch")
    B = sizes["bst_batch"] or steps.recsys_batch(c)
    t0 = time.perf_counter()
    params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(23),
                           device=dev)
    batch = bst_batch(batch=B, seq_len=cfg.seq_len, n_items=cfg.n_items,
                      n_dense=cfg.n_dense, seed=24, device=dev)
    say("ZOO_LOAD", cell="zoo/bst/train_batch", n_items=cfg.n_items,
        table_bytes=params["item_emb"].numel() * 4, batch=B,
        seconds=time.perf_counter() - t0)
    ocfg = AdamWConfig()
    state = init_opt_state(params, ocfg)

    def step():
        nonlocal params, state
        params, state, m = steps.recsys_train_step(params, state, *batch,
                                                   cfg, ocfg)
        return m
    reduced = [] if B == c.geometry["batch"] else \
        [f"batch {c.geometry['batch']} -> {B}"]
    if cfg.n_items != spec.model.n_items:
        reduced.append(f"n_items {spec.model.n_items} -> {cfg.n_items}")
    _zoo_timed(dev, "zoo/bst/train_batch", step, sizes, config=cfg.name,
               batch=B, n_items=cfg.n_items, optimizer=str(ocfg),
               reduced=reduced, source=spec.source,
               samples_per_s=lambda p50: B / p50)
    del state                  # 25.6 GB of moments, before any backward
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for shape_id in ("serve_p99", "serve_bulk"):
        Bs = sizes["serve"].get(shape_id) or \
            steps.recsys_batch(spec.cell(shape_id))
        hist, tgt, dense, _ = bst_batch(batch=Bs, seq_len=cfg.seq_len,
                                        n_items=cfg.n_items,
                                        n_dense=cfg.n_dense, seed=25,
                                        device=dev)
        secs = []
        for i in range(1 + sizes["serve_calls"]):
            t0 = time.perf_counter()
            out = steps.recsys_serve_step(params, hist, tgt, dense, cfg)
            _sync(dev)
            if i:
                secs.append(time.perf_counter() - t0)
        check(out.shape == (Bs,) and bool(torch.isfinite(out).all()),
              f"zoo/bst/{shape_id}: scores {out.shape}")
        p50 = float(np.median(secs))
        cell = f"zoo/bst/{shape_id}"
        say("ZOO_SERVE", cell=cell, batch=Bs, p50_ms=p50 * 1e3,
            ms=[s * 1e3 for s in secs], samples_per_s=Bs / p50)
        if dev.type == "cuda":
            _profile(cell, lambda: steps.recsys_serve_step(
                params, hist, tgt, dense, cfg), p50)
        del hist, tgt, dense, out
    return params, batch[0]


def _zoo_kernels(dev, ogb, table, hist, launches, rec):
    """The zoo path: the two kernels through their ``ops`` entry points,
    forward and backward, at the inputs the zoo's configs and generators
    give them (launches counted): ``segment_spmm`` over the ogb_products
    cell's features, an ELL of each node's first ``ell_k`` in-neighbours,
    W = the trained layer-1 weight and norm = 1/max(deg, 1);
    ``embedding_bag`` over BST's item table with the train batch's
    histories as bags, in sum and mean mode."""
    import torch
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.kernels.segment_spmm import ops as sops
    x, ids, w, norm = ogb
    if dev.type == "cuda":
        torch.cuda.empty_cache()          # the serve cells' cached blocks
    rec.only = {"segment_spmm", "embedding_bag"}
    _cuda.reset_launches()
    t0 = time.perf_counter()
    xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
    y = sops.segment_spmm(xr, ids, wr, norm)
    dx, dw = torch.autograd.grad(y, (xr, wr), torch.ones_like(y))
    check(y.shape == (x.shape[0], w.shape[1]) and dx.shape == x.shape
          and all(bool(torch.isfinite(t).all()) for t in (y, dx, dw)),
          "zoo segment_spmm: shapes or non-finite values")
    del y, dx, dw, xr, wr
    nnz = int((hist >= 0).sum())
    for mode in ("sum", "mean"):
        tr = table.detach().requires_grad_()
        out = eops.embedding_bag(tr, hist, mode)
        (dt,) = torch.autograd.grad(out, (tr,), torch.ones_like(out))
        total = float(dt.sum(dtype=torch.float64))
        want = nnz * table.shape[1] if mode == "sum" else \
            hist.shape[0] * table.shape[1] - \
            int(((hist >= 0).sum(1) == 0).sum()) * table.shape[1]
        check(bool(torch.isfinite(out).all()) and abs(total - want)
              <= 1e-3 * want, f"zoo embedding_bag {mode}: gradient sums to "
              f"{total}, want {want}")
        del tr, out, dt
    _sync(dev)
    secs = time.perf_counter() - t0
    launches["zoo"] = dict(_cuda.LAUNCHES)
    rec.only = set()
    if dev.type == "cuda":
        check(launches["zoo"]["segment_spmm"] == 1
              and launches["zoo"]["embedding_bag"] == 2,
              f"zoo kernel launches {launches['zoo']}")
    say("ZOO_KERNELS", seconds=secs, segment_spmm=dict(
        rows=ids.shape[0], k=ids.shape[1], d=x.shape[1], d_out=w.shape[1],
        non_pad=int((ids >= 0).sum())), embedding_bag=dict(
        table=list(table.shape), bags=list(hist.shape), non_pad=nnz),
        launches={k: launches["zoo"][k] for k in ("segment_spmm",
                                                  "embedding_bag")})


def _zoo_spmm_cross_check(dev, batch):
    """On cora_like(1.0): ``segment_spmm`` with every in-neighbour (K the
    largest in-degree) and norm = 1/deg against the model's own
    ``common.spmm(x, batch, n, norm="mean")``."""
    import torch
    from repro_torch.kernels.segment_spmm import ops as sops
    from repro_torch.models.gnn import common
    n = batch.node_feat.shape[0]
    ids, deg = _ell(batch, n)
    with torch.no_grad():
        got = sops.segment_spmm(batch.node_feat, ids, None,
                                1.0 / torch.clamp(deg, min=1.0))
        want = common.spmm(batch.node_feat, batch, n, norm="mean")
    err = _rel_err(got, want)
    check(err <= ZOO_SPMM_TOL, f"zoo segment_spmm vs common.spmm: {err}")
    say("ZOO_SPMM_CROSS_CHECK", nodes=n, k=ids.shape[1],
        d=batch.node_feat.shape[1], rel_err=err, tolerance=ZOO_SPMM_TOL)


def phase_zoo(dev, sizes, launches, rec):
    """Phase 9c: gcn-cora, graphsage-reddit and bst at full width (see the
    docstring), then the zoo path's two kernels."""
    import torch
    from repro_torch.configs import gcn_cora, graphsage_reddit
    from repro_torch.data.graphs import cora_like
    t_phase = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        check(held < 8 << 30, f"zoo: {held} bytes still held")
    from repro_torch.data.graphs import synthetic_graph_batch
    from repro_torch.launch.steps import gnn_geometry
    cora = cora_like(sizes["cora_scale"], device="cpu")
    _gnn_cell(dev, gcn_cora, "full_graph_sm", sizes, 31, batch_cpu=cora)
    N, E, dF, _ = gnn_geometry(graphsage_reddit.SPEC.cell("minibatch_lg"),
                               sizes["reduced_geometry"])
    _gnn_cell(dev, graphsage_reddit, "minibatch_lg", sizes, 32,
              batch_cpu=synthetic_graph_batch(
                  N, E, dF, n_classes=graphsage_reddit.FULL.n_classes,
                  seed=32, device="cpu"),
              reduced=("the fanout sample (data/sampler.py, not ported) "
                       "-> synthetic_graph_batch of its nodes and edges",))
    p, batch = _gnn_cell(dev, gcn_cora, "ogb_products", sizes, 33,
                         geometry=sizes["ogb"])
    ids, deg = _ell(batch, batch.node_feat.shape[0], sizes["ell_k"])
    ogb = (batch.node_feat, ids, p["w"][0].detach(),
           1.0 / torch.clamp(deg, min=1.0))
    del p, batch, deg
    table_params, hist = _bst_cells(dev, sizes)
    _zoo_kernels(dev, ogb, table_params["item_emb"], hist, launches, rec)
    del table_params
    _zoo_spmm_cross_check(dev, cora.to(dev))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    say("ZOO_PHASE", seconds=time.perf_counter() - t_phase)


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
    n_write = _small_write_reference(dev)
    say("SMALL_REFERENCE", queries=2 * len(want) + n_near + n_write,
        equal=True)


def _same_db(a, b, what):
    """Two databases' stores (every field, bit for bit), host mirrors and
    wave records are equal."""
    import numpy as np
    import torch_write_script as script
    from repro_torch.core.store import FIELDS
    for name in FIELDS:
        x, y = (getattr(d.store, name).cpu().numpy() for d in (a, b))
        check(x.shape == y.shape and np.array_equal(x.view(np.int32),
                                                    y.view(np.int32)),
              f"{what}: store field {name} differs")
    check(script.mirrors(a) == script.mirrors(b), f"{what}: host mirrors")
    check(json.dumps(list(a.wave_log)) == json.dumps(list(b.wave_log)),
          f"{what}: wave records")


def _small_write_reference(dev) -> int:
    """The CPU tests' seeded op script (``tests/torch_write_script.py``)
    on this device and on the CPU: every store field, host mirror, event
    and wave record equal bit for bit.  Then the film KG of the CPU tests
    loaded through the write path onto 4 shards (equal to the CPU's load),
    one wave of edits (films deleted with their edges, edges created and
    deleted, a film created), and q1 / q2 / q3 through a 4-shard mesh and
    locally, in both budget modes, against set computations over the edge
    list the writes leave.  Returns the number of queries checked."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_write_script as script
    from repro_torch.core import writes
    from repro_torch.core.addressing import StoreConfig
    from repro_torch.core.graphdb import GraphDB
    from repro_torch.core.query.executor import QueryCaps
    from repro_torch.core.txn import BatchCaps
    from repro_torch.data.kg import load_film_kg
    from repro_torch.dist.mesh import make_mesh
    cpu = torch.device("cpu")
    runs = []
    for d in (dev, cpu):
        db = GraphDB(StoreConfig(**script.CFG), caps=BatchCaps(**script.CAPS),
                     device=d)
        script.schema(db)
        runs.append((db, json.dumps(script.run(db, writes))))
    check(runs[0][1] == runs[1][1], "op script: events differ from the CPU's")
    _same_db(runs[0][0], runs[1][0], "op script")
    kgs = [load_film_kg(**script.KG_SIZES, cfg=StoreConfig(**script.KG_CFG),
                        device=d) for d in (dev, cpu)]
    _same_db(kgs[0].db, kgs[1].db, "film KG through the write path")
    kg = kgs[0]
    db = kg.db
    rng = np.random.default_rng(8)
    et = {n: db.et(n).type_id for n in ("film.director", "film.actor",
                                         "film.genre")}
    edges = set(zip(*(kg.edges[k].tolist() for k in ("src", "dst",
                                                      "etype"))))
    f0 = kg.n_directors + kg.n_actors + kg.n_genres
    films = list(range(f0, f0 + kg.n_films))
    acts = list(range(kg.n_directors, kg.n_directors + kg.n_actors))
    gone = [int(f) for f in rng.choice(films, 3, replace=False)]
    left = [f for f in films if f not in gone]
    ops = [writes.DeleteVertex(f) for f in gone]
    cast = sorted(e for e in edges if e[2] == et["film.actor"]
                  and e[0] not in gone)
    drop = [cast[int(k)] for k in rng.choice(len(cast), 4, replace=False)]
    ops += [writes.DeleteEdge(s_, d_, "film.actor") for s_, d_, _ in drop]
    new = set()
    while len(new) < 6:
        e = (int(rng.choice(left)), int(rng.choice(acts)), et["film.actor"])
        if e not in edges:
            new.add(e)
    ops += [writes.CreateEdge(s_, d_, "film.actor") for s_, d_, _ in new]
    res = db.write([writes.CreateVertex("film", 900_000, {"year": 2026})])
    film = res.gids[0]
    new |= {(0, film, et["film.director"]), (film, acts[0], et["film.actor"])}
    ops += [writes.CreateEdge(0, film, "film.director", check=False),
            writes.CreateEdge(film, acts[0], "film.actor", check=False)]
    res = db.write(ops)
    check(not res.failed, f"small write wave aborted: {res.reasons[0]}")
    edges = {e for e in edges if e[0] not in gone and e[1] not in gone}
    edges = (edges - set(drop)) | new
    out_of, in_of = {}, {}
    for s_, d_, e in edges:
        out_of.setdefault((s_, e), set()).add(d_)
        in_of.setdefault((d_, e), set()).add(s_)

    def step(frontier, table, e):
        return set().union(*[table.get((g, e), set()) for g in frontier])
    dids = 1_000 + np.arange(kg.n_directors)
    aids = 10_000 + rng.choice(kg.n_actors, kg.n_directors)
    want = []
    for d in dids:
        fs = step({int(d) - 1_000}, out_of, et["film.director"])
        want.append(len(step(fs, out_of, et["film.actor"])))
    for d in dids:
        fs = step({int(d) - 1_000}, out_of, et["film.director"])
        actors = step(fs, out_of, et["film.actor"])
        want.append(len(step(actors, in_of, et["film.actor"])))
    for d, a in zip(dids, aids):
        f1 = step({int(d) - 1_000}, out_of, et["film.director"])
        f2 = step({kg.n_directors + int(a) - 10_000}, in_of,
                  et["film.actor"])
        want.append(len(f1 & f2))
    qs = ([q1(d) for d in dids] + [q2(d) for d in dids]
          + [q3(d, a) for d, a in zip(dids, aids)])
    caps = QueryCaps(frontier=4096, expand=16384, results=64)
    n = 0
    for kw in ({}, {"mesh": make_mesh(4, dev)}):
        for budget in ("per-query", "shared"):
            r = db.query(qs, caps=caps, budget=budget, backend="kernel",
                         **kw)
            check(not r.failed_q.any() and r.counts.tolist() == want,
                  f"small written store, mesh={bool(kw)}, budget={budget}: "
                  f"{r.counts.tolist()} != {want}")
            n += len(want)
    return n


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


def _graph_ms(fn, n: int = 20) -> float:
    """Device time per call with no host time inside the window: ``n``
    calls captured in one CUDA graph (the wrappers launch on the current
    stream, which the capture records), one replay timed with CUDA
    events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                          # lazy set-up stays out of the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / n
    del g
    return ms


def _host_ms(fn, n: int = 20) -> float:
    """Host time per call: the host clock over ``n`` calls issued back to
    back after a synchronize (the launch queue has room for them)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


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
        keys, q, lo, hi = _ranged_args(args, kw)
        n = keys.shape[0]
        w = (torch.clamp(hi.long(), max=n) - torch.clamp(lo.long(), min=0)
             ).clamp(min=0)
        probes = int(sum(int(x).bit_length() for x in w.tolist()))
        n_in = 4 if len(args) > 3 or kw.get("hi") is not None else 3
        nbytes, ops = 4 * (n_in * q.shape[0] + probes), probes
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
    elif name == "segment_spmm":
        # each row of x that an id names read once (a row named by many
        # ids still once), the ids, W and norm read once, the output
        # written once; an add a non-padding id's element, a multiply an
        # aggregated one and 2*D*Dout flops a row
        x, ids, w, norm = args
        (R, K), D, es = ids.shape, x.shape[1], x.element_size()
        nnz = int((ids >= 0).sum())
        rows = int(torch.unique(ids[ids >= 0]).numel())
        d_out = D if w is None else w.shape[1]
        nbytes = (rows * D + R * d_out) * es + 4 * R * K + \
            (0 if w is None else w.numel() * es) + (0 if norm is None
                                                     else 4 * R)
        ops = nnz * D + (0 if norm is None else R * D) + \
            (0 if w is None else 2 * R * D * d_out)
    elif name == "embedding_bag":
        # each table row that an id names read once, the ids read once,
        # the bags written once; an add a non-padding id's element (and a
        # divide a bag element in mean mode)
        table, ids = args
        (B, L), D, es = ids.shape, table.shape[1], table.element_size()
        nnz = int((ids >= 0).sum())
        rows = int(torch.unique(ids[ids >= 0]).numel())
        nbytes = rows * D * es + 4 * B * L + B * D * es
        ops = nnz * D + (B * D if kw.get("mode") == "mean" else 0)
    else:
        x = args[0]
        R, W = x.shape
        cap = args[1] if name == "dedup_compact_rows" else W
        nbytes = 4 * R * W + 4 * R * cap + (4 * R if cap != W else 0)
        ops = R * W * max(1, math.ceil(math.log2(max(W, 2))))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _ranged_args(args, kw):
    """A searchsorted_left_ranged call's (keys, queries, lo, hi), its
    windows given as hi or as a width."""
    keys, q, lo = args[:3]
    hi = args[3] if len(args) > 3 else kw.get("hi")
    return keys, q, lo, lo + kw["width"] if hi is None else hi


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
    """(label, ms, fn) of one PyTorch call computing the same function on
    the same inputs, or None; fn is what ms timed, to time again
    (``graph_ms``), or None where that is not one closure (SDPA's fastest
    setup).  The flash_bwd kernels' is SDPA's backward."""
    import torch
    from repro_torch.kernels.dedup_compact import ref as dref
    if name in ("flash_bwd_dkv", "flash_bwd_dq"):
        lib = _sdpa_bwd(args, kw)
        return (*lib, None) if lib else None
    if name in ("segment_spmm", "embedding_bag"):
        return _bag_library(name, args, kw)
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
        keys, q, lo, hi = _ranged_args(args, kw)
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
        return (*lib, None) if lib else None
    return (lib[0], _events_ms(lib[1]), lib[1]) if lib else None


def _bag_library(name, args, kw):
    """(label, ms, fn) of ``F.embedding_bag`` over the table (or x) with a zero
    row appended and padding ids sent to it as ``padding_idx`` (for
    segment_spmm in sum mode, followed by ``* norm`` and ``torch.matmul``
    with W, f32 accumulation: three calls).  It counts as the same
    function only if it agrees with the kernel on these inputs (mean mode:
    only if its mean leaves the padding out of the count); else the ms is
    None and the label says why."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.precision import f32_accumulation
    from repro_torch.kernels.embedding_bag import kernel as ek
    from repro_torch.kernels.segment_spmm import kernel as sk
    table, ids = args[0], args[1]
    V = table.shape[0]
    padded = torch.cat([table.detach(), table.new_zeros((1, table.shape[1]))])
    safe = torch.where(ids >= 0, ids, V).long()
    if name == "embedding_bag":
        mode = kw.get("mode", "sum")
        label = f"F.embedding_bag({mode}, padding_idx)"

        def fn():
            return F.embedding_bag(safe, padded, mode=mode, padding_idx=V)
        want = ek.embedding_bag(*args, **kw)
    else:
        w, norm = args[2], args[3]
        label = "F.embedding_bag(sum, padding_idx) * norm, torch.matmul: " \
            "three calls"

        def fn():
            agg = F.embedding_bag(safe, padded, mode="sum", padding_idx=V)
            if norm is not None:
                agg = agg * norm[:, None]
            if w is None:
                return agg
            with f32_accumulation():
                return agg @ w
        want = sk.segment_spmm(*args, **kw)
    err = _rel_err(fn().float(), want.float())
    if not err <= 1e-5:
        return f"{label}: not the same function here (rel err {err})", \
            None, None
    return f"{label} (rel err {err} to the kernel)", _events_ms(fn), fn


def _sdpa_setups(k4, v4, G):
    """(label, backend, k, v, kwargs) of each way one SDPA call can take
    these inputs: each fused backend that this PyTorch has (flash,
    memory-efficient, cuDNN; the math backend would hold every score),
    with ``enable_gqa`` and with k and v repeated over the group before the
    call."""
    from torch.nn.attention import SDPBackend
    kr, vr = (t.repeat_interleave(G, dim=1) for t in (k4, v4))
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
        if not hasattr(SDPBackend, name):
            continue
        backend = getattr(SDPBackend, name)
        label = name.split("_")[0].lower()
        if G > 1:
            yield f"{label} enable_gqa", backend, k4, v4, {"enable_gqa": True}
        yield f"{label}, k and v repeated", backend, kr, vr, {}


def _fastest(timed):
    """The (label, ms) of least ms among ``(label, fn)`` pairs, timing each
    fn that runs (a setup its backend refuses raises and is passed over),
    or None."""
    import warnings
    best = None
    for label, fn in timed:
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                ms = fn()
        except (RuntimeError, TypeError):
            continue
        if best is None or ms < best[1]:
            best = (label, ms)
    return best


def _sdpa_call(args, kw, rows=None):
    """(label, ms) of F.scaled_dot_product_attention on flash_fwd's inputs
    (the first ``rows`` positions, with ``is_causal`` there when the window
    covers them; else the boolean mask), the fastest of _sdpa_setups."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel
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

    def timer(backend, kk, vv, gqa):
        def call():
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(
                    q4, kk, vv, attn_mask=mask, is_causal=bool(causal_only),
                    scale=kw["scale"], **gqa)
        return lambda: _events_ms(call)
    best = _fastest((label, timer(*rest))
                    for label, *rest in _sdpa_setups(k4, v4, G))
    if best is None:
        return None
    return (f"sdpa {best[0]}, {'is_causal' if causal_only else 'bool mask'}"
            f", {q.shape[1]} rows"), best[1]


def _sdpa_bwd(args, kw):
    """(label, ms) of the backward of F.scaled_dot_product_attention on
    flash_bwd's inputs (``is_causal``), the fastest of _sdpa_setups (with
    k and v repeated, the gradients are the repeated tensors'), timed as
    forward plus backward minus forward; None unless the mask is the plain
    causal one (the window covers every position and no offset), where
    SDPA computes the same function."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel
    q, k, v, do = args[:4]
    BHq, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    if not (kw["causal"] and kw["q_offset"] == 0 and Sq == Sk
            and (kw["window"] <= 0 or kw["window"] >= Sk)):
        return None
    q4, k4, v4 = (t.detach().reshape(1, -1, t.shape[1], D)
                  for t in (q, k, v))
    do4 = do.reshape(1, BHq, Sq, D)
    q4 = q4.requires_grad_()

    def timer(backend, kk, vv, gqa):
        kk, vv = (t.detach().requires_grad_() for t in (kk, vv))

        def fwd():
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(
                    q4, kk, vv, is_causal=True, scale=kw["scale"], **gqa)

        def ms():
            with torch.enable_grad():
                f_ms = _events_ms(fwd)
                fb_ms = _events_ms(lambda: torch.autograd.grad(
                    fwd(), (q4, kk, vv), do4))
            return fb_ms - f_ms
        return ms
    best = _fastest((label, timer(*rest))
                    for label, *rest in _sdpa_setups(k4, v4, BHq // BHkv))
    if best is None:
        return None
    return (f"sdpa {best[0]}, is_causal, {Sq} rows: backward (forward + "
            f"backward minus forward), dq, dk and dv together"), best[1]


SHORT_MS = 0.5      # kernel rows timed again without the host (graph_ms)


def _host_parts(name, args, kw):
    """A short wrapper's host time, whole and by part (ms a call, the host
    clock over 200 calls, 50 for sort_pairs, so that the launch queue has
    room for them): its argument checks, the stream lookup (and
    ``torch.cuda.current_stream``, the query it replaced), the allocation
    of its outputs (and scratch), and the C call with its launch."""
    import torch
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.dedup_compact import kernel as dk
    from repro_torch.kernels.sorted_lookup import kernel as sk
    x = args[0]
    stream = _cuda.stream_of(x)
    if name == "sort_pairs":
        k1, k2 = args
        W = k1.shape[0]
        big = W > dk.SMALL_MAX
        nbytes = dk.radix_scratch_bytes(W) if big else 0

        def alloc():
            buf = torch.empty((2 * W + nbytes // 4,), dtype=torch.int32,
                              device=x.device)
            return buf, buf[:2 * W].view(2, W)
        buf, (o1, o2) = alloc()
        fn = _cuda.function("sort_pairs", "sort_pairs", None)
        parts = {
            "wrapper": lambda: dk.sort_pairs(k1, k2),
            "checks": lambda: dk._check_pairs(k1, k2),
            "alloc": alloc,
            "c_call": lambda: fn(k1.data_ptr(), k2.data_ptr(),
                                 o1.data_ptr(), o2.data_ptr(),
                                 buf.data_ptr() + 8 * W if big else None,
                                 nbytes, W, stream)}
    elif name == "searchsorted_left_ranged":
        keys, q, lo, hi = (*args, None)[:4]
        width = kw.get("width")
        out = torch.empty_like(q)
        if hi is None:
            fn = _cuda.function("sorted_lookup", "searchsorted_left_width",
                                None)
            c_args = (lambda: (keys.data_ptr(), keys.shape[0], q.data_ptr(),
                               lo.data_ptr(), width, out.data_ptr(),
                               q.shape[0], stream))
        else:
            fn = _cuda.function("sorted_lookup", "searchsorted_left_ranged",
                                None)
            c_args = (lambda: (keys.data_ptr(), keys.shape[0], q.data_ptr(),
                               lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
                               q.shape[0], stream))
        parts = {
            "wrapper": lambda: sk.searchsorted_left_ranged(*args, **kw),
            "checks": lambda: sk._check_ranged(keys, q, lo, hi, width),
            "alloc": lambda: torch.empty_like(q),
            "c_call": lambda: fn(*c_args())}
    else:
        keys, q = args
        out = torch.empty_like(q)
        fn = _cuda.function("sorted_lookup", "searchsorted_left", None)
        parts = {
            "wrapper": lambda: sk.searchsorted_left(keys, q),
            "checks": lambda: sk._check("searchsorted_left", keys, q),
            "alloc": lambda: torch.empty_like(q),
            "c_call": lambda: fn(keys.data_ptr(), keys.shape[0],
                                 q.data_ptr(), out.data_ptr(), q.shape[0],
                                 stream)}
    parts.update(stream_of=lambda: _cuda.stream_of(x),
                 current_stream=lambda: torch.cuda.current_stream(
                     x.device).cuda_stream)
    n = 50 if name == "sort_pairs" else 200   # 9 launches a radix sort
    return {k: _host_ms(f, n) for k, f in parts.items()}


# the kernels of the radix routine, whose rows report their inputs' valid
# keys and digit passes
RADIX_ROWS = ("dedup_compact_rows", "sort_rows")


def _gathered_ms(args) -> float:
    """segment_spmm's second bound: x's row read once for every
    non-padding id (no row found in the L2 again), the ids, W and norm
    read once and the output written once, over the card's memory rate."""
    x, ids, w, norm = args
    (R, K), D, es = ids.shape, x.shape[1], x.element_size()
    d_out = D if w is None else w.shape[1]
    nnz = int((ids >= 0).sum())
    nbytes = (nnz * D + R * d_out) * es + 4 * R * K + \
        (0 if w is None else w.numel() * es) + (0 if norm is None else 4 * R)
    return nbytes / HBM_BYTES_PER_S * 1e3


def _dedup_input_stats(x):
    """The valid keys a row (min, median, max) and the rows by digit
    passes of a dedup_compact_rows or sort_rows input."""
    import torch
    from repro_torch.kernels.dedup_compact import kernel as dk
    n = (x != I32MAX).sum(dim=1).float()
    passes = dk.dedup_passes(x)
    return dict(valid_per_row=[float(n.min()), float(n.median()),
                               float(n.max())],
                rows_by_passes=torch.bincount(passes, minlength=5).tolist())


def _extra_timing(name, kern, plain, args, kw):
    """One more call of a kernel timed beside its main-path row: equal to
    its plain version there, its ms / device_ms / graph_ms and its bound."""
    _exact(_bits(list(_tensors([kern(*args, **kw)]))),
           _bits(list(_tensors([plain(*args, **kw)]))),
           f"{name} at its second recorded call")

    def call():
        return kern(*args, **kw)
    bound_ms, bound_by = _bound(name, args, kw)
    row = dict(shapes=[tuple(a.shape) for a in _tensors(args)][:3],
               ms=_events_ms(call), device_ms=_device_ms(call),
               bound_ms=bound_ms, bound_by=bound_by)
    if row["ms"] < SHORT_MS:
        row["graph_ms"] = _graph_ms(call)
    if name in RADIX_ROWS:
        row.update(_dedup_input_stats(args[0]))
    return row


def phase_kernel_report(launches, best, extra=None):
    import torch
    from repro_torch.kernels.dedup_compact import kernel as dk
    from repro_torch.kernels.edge_expand import kernel as ek
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.knn_topk import kernel as kk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.sorted_lookup import kernel as sk
    from repro_torch.kernels.embedding_bag import kernel as ebk
    from repro_torch.kernels.segment_spmm import kernel as ssk
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
           "flash_bwd_dq": (fk.flash_bwd_dq, fk.flash_bwd_dq_plain),
           "segment_spmm": (ssk.segment_spmm, ssk.segment_spmm_plain),
           "embedding_bag": (ebk.embedding_bag, ebk.embedding_bag_plain)}
    # the kernels each path must have launched: its own, and the earlier
    # slices' kernels that serve it too
    for path, need in (("shared", ("sort_pairs", "expand",
                                   "searchsorted_left_ranged")),
                       ("write", ("searchsorted_left_ranged", "expand",
                                  "dedup_compact_rows", "sort_rows")),
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
        ref_t, bounds = _reference(name, plain, args, kw)
        TC_SHARE.clear()
        torch.cuda.synchronize()
        out_t = list(_tensors([out]))
        check(len(out_t) == len(ref_t), f"{name}: {len(out_t)} outputs, "
              f"{len(ref_t)} in its reference")
        if name in FLOAT_TOL:
            tols = _float_tol(name, out_t[0].dtype)
            check(len(tols) == len(out_t), f"{name}: {len(out_t)} outputs, "
                  f"{len(tols)} tolerances")
            err = max(_close(o, r, f"{name} at main-path inputs", tol, bd)
                      for o, r, tol, bd in zip(out_t, ref_t, tols, bounds))
        else:
            _exact(_bits(out_t), _bits(ref_t), f"{name} at main-path inputs")
            err = max(float((o.double() - r.double()).abs().nan_to_num(0)
                            .max()) if o.numel() else 0.0
                      for o, r in zip(out_t, ref_t))
        del out, out_t, ref_t, bounds
        lib = _library_call(name, args, kw)
        bound_ms, bound_by = _bound(name, args, kw)
        shapes = [tuple(a.shape) for a in _tensors(args)][:3]

        def call():
            return kern(*args, **kw)
        row = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=sum(int(n[name]) for n in launches.values()),
            launches_by_path={p: int(n[name]) for p, n in launches.items()},
            max_abs_err=err,
            ms=_events_ms(call),
            plain_ms=_events_ms(lambda: plain(*args, **kw), n=5),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib[1] if lib else None,
            library=lib[0] if lib else None,
            device_ms=_device_ms(call),
            shapes=shapes, dtype=str(args[0].dtype))
        if row["ms"] < SHORT_MS:
            row.update(graph_ms=_graph_ms(call), host_ms=_host_ms(call),
                       library_graph_ms=_graph_ms(lib[2]) if lib and lib[2]
                       else None)
        if name in ("searchsorted_left", "searchsorted_left_ranged",
                    "sort_pairs"):
            row["host_parts_ms"] = _host_parts(name, args, kw)
        if name in TC_SHARE:
            row["tc_share_of_tolerance"] = TC_SHARE[name]
        if name in RADIX_ROWS:
            row.update(_dedup_input_stats(args[0]))
        if name == "segment_spmm":
            row["gathered_ms"] = _gathered_ms(args)
            row["gathered_share"] = row["gathered_ms"] / row["ms"]
        for (xname, label), (_, xargs, xkw) in (extra or {}).items():
            if xname == name:
                row[f"at_{label}"] = _extra_timing(name, kern, plain, xargs,
                                                   xkw)
        if name == "flash_fwd":
            # the window mask equals the causal one over the first 4096
            # positions: the fused causal attention's time there
            S0 = min(4096, args[0].shape[1])
            part = [t[:, :S0].contiguous() for t in args]
            label, lib_ms = _sdpa_call(part, kw, rows=S0) or (None, None)
            row.update(ms_causal_4096=_events_ms(lambda: kern(*part, **kw)),
                       library_causal_4096_ms=lib_ms,
                       library_causal_4096=label)
        rows.append(row)
        del lib          # a library call may hold a copy of the table
        torch.cuda.empty_cache()
    torch.set_grad_enabled(True)
    print(json.dumps({"kernels": rows}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only")
    ap.add_argument("--rehearse", action="store_true",
                    help="without a GPU: phases 4-9c and 11 at a tiny size "
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
                                               cap_e=80_000, cap_idx=20_000,
                                               cap_delta=256,
                                               cap_idx_delta=256))
        caps = dict(A1_CAPS, frontier=256, expand=1024)
        launches = {}
        batches, results, peak = phase_serve(kg, dev, 1, launches, caps)
        phase_serve_shared(kg, dev, batches, results, peak, launches, caps)
        phase_write(kg, dev, WRITE_REHEARSE, launches, caps_kw=caps)
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
        phase_zoo(dev, ZOO_REHEARSE, launches, rec)
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
        del batches, results
        phase_write(kg, dev, WRITE_FULL, launches, rec)
        del kg
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
        phase_zoo(dev, ZOO_FULL, launches, rec)
        rec.restore()
        phase_kernel_report(launches, rec.best, rec.extra)
        phase_small_reference(dev)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
