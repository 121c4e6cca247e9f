#!/usr/bin/env python3
"""Drive the PyTorch port's A1 read and write paths, its maintenance,
durability, serving and fleet paths, LM serving and training paths, the
LM zoo (dense and MoE) and GNN/recsys zoo on one NVIDIA GPU and check
them.

    python3 chip_smoke.py            # the whole run (one GPU)
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
 6c. maintenance — on 6b's written store, a ``TaskQueue`` and a
     ``FaultInjector`` attached and a pre-phase ``read_ts`` pinned: waves
     of 6b's mix with ``pump(1)`` between waves until the background
     compaction has handed off both ``edges`` and ``index`` with a
     non-empty replayed tail (a wave inside a build's window stages no
     deletes, which would refuse the handoff); the first handoff raced
     (``tasks.compaction.handoff``: one rebuild), one quantum crashed
     (``tasks.quantum``: ``fault_restarts`` 1); 6b's read-backs and host
     mirrors equal to the device counts after every handoff and at the
     end, the pinned batch equal to its pre-phase results; then
     ``vacuum`` (its slots = the dead rows below ``gc_ts``) and a wave of
     creates into the reclaimed slots, read back; then
     ``FastRestartCache``: hold, drop the database, restart on the card,
     the batch bit for bit, one more wave; a MAINT line;
 6d. serving — on 6c's store, ``repro_torch.launch.serve.A1Server`` at the
     JAX package's serving defaults for a wave of 64 (a1-kg caps,
     ``budget_ms`` 100, ``queue_frac`` 0.1, ``read_batch`` 64,
     ``budget="auto"``, ``shared_knee`` 64): (a) 48 admitted waves of phase
     5's ``mixed`` documents under both key laws (4 tenants, the three
     query classes), a wave of 6b's write mix through ``submit_write`` and
     ``pump()`` after each, the background compaction's watermark at 1/64
     of a log; every dispatch, base and hedge, re-run with
     ``backend="ref"`` at its snapshot and equal bit for bit (the check's
     seconds off the server's clock), every read and write id ending in one
     result, ``admitted == served + aborted_faults``; (b) 16 selects paged
     to the end during (a), each equal to the select at its token's pinned
     snapshot, no pin left; (c) ``benchmarks/bench_serve.py``'s overload
     run: 12 calibration waves, then open-loop arrivals at 1x and 2x their
     rate for 4 s each, the shed watermark below the wave size; (d) 8
     chaos waves (a wave crash retried, a crash storm aborted with
     attribution, a stall, a stale-continuation storm) against a batch
     pinned before them; a PROFILE of one wave at the knee and a
     SERVE_TIER line;
 6e. fleet — on 6d's store, ``repro_torch.launch.cluster.A1Frontend``:
     (a) 4 inproc coordinators (one restarted copy of the store on the
     card) at 6d's settings, 16 waves of phase 5's ``mixed`` documents
     through ``submit_query`` with a wave of 6b's write mix through
     ``submit_write`` and ``pump()`` after each, every coordinator's
     dispatches equal to ``backend="ref"``, every id ending in one result,
     the workers' reads partitioning the routed ones, routing over at
     least 2 workers; (b) 8 selects paged by 16 against their snapshots,
     again under a stale-route storm, 64 reads under dropped frames (one
     admission each), and one owner killed mid-stream (takeover,
     bit-identical), no pin left; a PROFILE of one fleet wave of 64; (c) a
     5-coordinator fleet on a fake membership clock: an acked commit
     survives its primary's kill (the failover recovery against the
     median steady write wave), a mid-wave crash commits once, a deposed
     zombie is fenced, a lease expires; (d) process mode: workers spawned
     with one CUDA context each copy the frontend's shared segment onto
     the card; bench_serve's cluster run (a 1-worker calibration, open
     loops at 1x and 2x through 1 and 4 workers), then each worker's
     counts against ``backend="ref"``, a write replayed everywhere before
     its ack, a takeover after the owner's kill, a commit after it; (e)
     (after phase 7, on its doc store) scans and ``Nearest`` through 4
     coordinators, and a doc created at the probe vector answering k=1 on
     several at once; a FLEET line;
 6f. sampler_db — ``data/sampler.py::fanout_sample_db`` over 6e's store:
     16 director seeds at fanouts (15, 10), 3 calls; the slot layout and
     every sampled gid among its parent's ``get_edges`` neighbours; a
     SAMPLER_DB line;
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
 9e. lm_dist — on phase 9's bf16 weights, after its prefill: (a) prefill
     of 1 x 4,096 tokens with ``use_collective_matmul`` under ``{"seq":
     "model"}`` on ``make_test_mesh((1, 4))`` (the q/k/v and w1/w3
     products on the ppermute ring of ``dist/overlap.py``, 3 hops each)
     against the plain prefill, p50 of both (LM_DIST_RING); (b)
     ``pipeline_apply`` over a ("pod", "model") (4, 1) mesh, stage s a
     danube block with layer s's weights, 8 microbatches of 1 x 4,096
     against the four blocks in sequence, p50 of both (LM_DIST_PIPELINE);
     the references first, then the launches of one ring prefill
     (``lm_dist_ring``) and of one pipeline run (``lm_dist_pipeline``)
     counted alone and checked exactly; (c) in phases 9, 9b and 9c, for
     ``lm/prefill_32k``, ``lm/train_4k`` and ``zoo/bst/train_batch``: the
     dry run's op counts (``launch/hloanalysis.py::analyze_ops`` on meta
     copies of the step's inputs) against one more step under a fresh
     profiler, matmul flops within 1 %, the predicted peak bytes beside
     ``max_memory_allocated`` (DRYRUN_CHECK);
 9d. lm_zoo — qwen3-moe-235b (grouped top-8 MoE, GQA 64/4), llama4-maverick
     (dense | top-1 MoE, GQA 40/8), qwen1.5-32b (MHA, qkv bias) and
     llama3-405b (d_model 16384, GQA 128/8) at full width, weights drawn
     from a seed, the recorder's kernel inputs parked on the host: for
     each, one cycle in float32 over 4,096 positions (``forward_hidden``
     and ``prefill`` on the kernel path against ``backend="ref"``; each
     MoE layer's dispatch, grouped and global, against a per-expert loop:
     the kept pairs and ``drop_frac`` equal, the aux loss within 1e-6),
     qwen3-moe's decode steps against ``forward`` (2 layers, float32), then
     the bf16 cells, each printed as an LM_ZOO line:
     ``lm_zoo/<arch>/prefill_32k`` (32,768 tokens, layers cut to 4 / 2 /
     8 / 2, 8 timed calls, against ``backend="ref"``, profiled, only the
     tensor-core ``flash_fwd``; its ``flash_fwd`` and ``rmsnorm_fwd``
     inputs timed for the kernel report's ``at_<cell>``) and
     ``lm_zoo/qwen3-moe-235b-a22b/decode_32k`` (2 layers, batch 128, a
     32,768-slot cache, 16 steps);
 9b. lm_train — after phase 9's weights and cache are freed:
     ``lm/train_check_f32`` (4 of the 24 layers in float32 over 4,608
     tokens: ``loss_fn`` and every gradient on the kernel path against
     ``backend="ref"``, and remat against none) and ``lm/train_4k`` (all 24
     layers in bf16, AdamW with f32 moments, one 4,096-token sequence a
     step: the first step's loss, gradient norm and gradients against
     ``backend="ref"``, then 2 warm-up and 8 timed steps on one batch whose
     loss must fall; the profiled step must have run only the tensor-core
     ``flash_fwd``, ``flash_bwd_dkv`` and ``flash_bwd_dq`` kernels); the
     first step's gradients through ``ef_compress_grads(axis_name=)`` over
     4 shards (a scale each), equal to the formula bit for bit (EF_MESH);
 9c. zoo — after phase 9b's model is freed, gcn-cora, graphsage-reddit,
     meshgraphnet, nequip and bst FULL (float32, AdamW with f32 moments) at
     their shape cells: ``zoo/gcn-cora/full_graph_sm`` (``cora_like(1.0)``),
     then the minibatch_lg base graph made on the card (232,965 nodes,
     114,615,892 edges, 602 features, ``reddit_like``'s law), its CSR by
     ``data/sampler.py::csr_from_coo`` and fanout samples of 1,024 seeds at
     (15, 10) by ``build_sampled_batch`` (169,984 node and 168,960 edge
     slots; each checked: the slot layout, -1 exactly under a -1 or
     neighbourless parent, every sampled edge an edge of the base graph; a
     SAMPLER line with the CSR build s and ms a sample):
     ``zoo/graphsage-reddit/minibatch_lg`` and
     ``zoo/meshgraphnet/minibatch_lg`` (15 blocks, d_in 602, a fresh
     sample with positions by gid and (N, 3) targets), and
     ``zoo/nequip/molecule`` (``molecule_batch(128, 30, 64)``), each first
     step's loss and gradients on the card against the CPU, then 2 warm-up
     and 8 timed ``gnn_train_step``s; NequIP's forces on the card against
     the CPU, its energy invariant and forces equivariant under a seeded
     rotation plus translation (NEQUIP_CHECK); ``zoo/gcn-cora/ogb_products``
     (2,449,029 nodes, 61,859,140 edges) timed (MGN and NequIP do not run
     there: MGN's concatenated edge input alone, 61,859,140 x 384 x 4 B,
     is 95 GB); ``zoo/bst/check`` (n_items cut to
     1,000,000: logits and gradients against the CPU),
     ``zoo/bst/train_batch`` (10^8 items, batch 65,536) timed, and
     ``zoo/bst/serve_p99`` / ``serve_bulk``; then the zoo path: the two
     kernels through their ``ops`` entry points, forward and backward, at
     those cells' inputs (``segment_spmm`` over ogb_products' features with
     an ELL of each node's first 25 in-neighbours, ``embedding_bag`` over
     BST's item table with the train batch's histories as bags), and
     ``segment_spmm`` against the model's ``common.spmm`` on cora;
     ``a1_ship_lookup`` over ``make_mesh(4)`` on BST's table with the
     histories as ids (tails padded) equal to ``gspmd_lookup`` bit for bit
     (SHIP_LOOKUP);
 10. kernels — each kernel at the inputs the main path gave it: its
     launches during phases 5-9e, 11b and 11 (by path: ``write``,
     ``maintenance`` for 6c and 11b together, ``serving`` for 6d and
     11's mesh serving, ``fleet`` for 6e, ``lm_dist_ring`` and
     ``lm_dist_pipeline`` for 9e, and
     ``lm_zoo/<arch>/<cell>`` for each of 9d's cells, among them), its time
     beside the plain version's, the
     bound and a library call, as one JSON line; a kernel under 0.5 ms and
     its library call are timed again as 20 calls in one CUDA graph
     (``graph_ms``: no host time inside), and its wrapper's host time a
     call is given (``host_ms``; by part, ``host_parts_ms``, for the two
     ``sorted_lookup`` probes and ``sort_pairs``); ``knn_topk`` is timed
     again at its largest one-row call (``at_r1``, the ``nearest_k8/b1``
     cell), ``dedup_compact_rows`` and ``sort_rows`` at their largest
     calls on the mesh path (``at_mesh``), and ``dedup_compact_rows`` at
     its largest wide-route call in 6d (``at_wide``, a hedge's rows past
     MAX_W), each with its own bound, and
     the radix rows' valid keys and digit passes (``valid_per_row``,
     ``rows_by_passes``); ``segment_spmm`` adds a second bound,
     ``gathered_ms`` (x's row read once an id), and its share of ``ms``;
 11. small reference — small stores against plain set computations and a
     numpy k-NN in the kernels' summation order, on one shard and on a
     4-shard mesh; the CPU tests' seeded write script on the card and on
     the CPU (every store field, host mirror, event and wave record equal
     bit for bit); the film KG loaded through the write path onto 4
     shards, edited by a write wave, and queried through a 4-shard mesh
     against set computations, then served by ``A1Server`` through the
     mesh (``use_spmd=True``) and locally (run before phase 10, so that
     the mesh serving's launches count as ``serving``);
 11b. durability (run after 9c, before phase 10, so that its launches
     count) — a film KG loaded through the write path into a database
     whose ``ReplicationLog`` ships every wave to an ``ObjectStore`` with
     its WAL on disk: ``fail_next`` at two waves of the load and a dropped
     ship round (``replication.ship.drop``) after it, then
     ``sweeper_task`` to lag 0, ``t_R`` never ahead of an unshipped
     entry; the ObjectStore reloaded from its WAL; ``consistent_recover``
     and ``best_effort_recover`` onto the card, each equal to the source
     by logical identity (vertices by key with their attributes, edge
     sets) and its q1 / q3 counts, and to the same recovery on the CPU
     field by field; then ``export_shared`` and two ``attach_shared``
     onto the card (a write to one leaves the other); a RECOVER line.

Each of phases 5-9e sets the kernels' launch counts to 0 just before its
timed batches, calls or steps (per budget mode or cell) and reads them just
after (the write phase around the whole phase: its launches are its
read-back queries'; phases 6c and 11b likewise, into one count; phase 6d
and phase 11's mesh serving into ``serving``; phase 6e's inproc fleets,
(a)-(c) and (e), into ``fleet``: process-mode workers count their own
launches, in their own processes, uncounted here); phase 9c does so
around its kernel calls.
Any failed check raises, so the script exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 before
printing any result.  ``--rehearse`` runs phases 4-9d (6d, 6e and 9d, at
the REDUCED configs, among them), 11b and 11 at a tiny size on the CPU
(plain kernel versions, no build) and then exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import a1_kg  # noqa: E402  (the checkout's, or fail)
from repro_torch.launch.roofline import (F32_FLOPS as F32_OPS_PER_S,  # noqa: E402
                                         HBM_BW as HBM_BYTES_PER_S,
                                         PEAK_FLOPS as BF16_OPS_PER_S,
                                         peak_flops)

I32MAX = 2**31 - 1

# a1-kg (configs/a1_kg.py): one shard of FULL, the shape-cell caps
A1_SHARD = dict(dataclasses.asdict(a1_kg.FULL), n_shards=1)
A1_CAPS = dict(a1_kg.SPEC.cell("serve_q1").geometry["caps"])
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
# phase 6c: at most this many waves to see both kinds handed off in the
# background (the index delta crosses its watermark last; PERF.md §5 has
# the count), and at most this many reclaimed slots, each of which a
# create reuses
MAINT_FULL = dict(maint_waves=60, reuse=16_384)
MAINT_REHEARSE = dict(maint_waves=40, reuse=4_096)
# phase 6d, the serving tier: read waves of 64 (src/repro/launch/serve.py's
# defaults at the a1-kg serving cell's batch), selects paged at the
# server's default page, bench_serve's 12 calibration waves and open loops
# (benchmarks/bench_serve.py:74-135; 4 s a rate here), 8 chaos waves; a
# read wave's writes: WRITE_FULL's ingest / cast / update / delete mix
# (32:192:128:32) over 32
SERVE_FULL = dict(waves=48, pages=16, page_size=16, calib_waves=12,
                  open_s=4.0)
SERVE_REHEARSE = dict(waves=8, pages=4, page_size=16, calib_waves=3,
                      open_s=0.5)
SERVE_TXNS = dict(ingest=1, cast=6, update=4, delete=1)
# phase 6e, the fleet (src/repro/launch/cluster.py) on 6d's store: 16 waves
# of 64 through 4 coordinators, 8 selects paged by 16, 64 reads under
# dropped frames, 5 steady writes before the primary's kill (bench_serve.py:
# 392-433 takes 5), bench_serve._bench_cluster's 320 requests a rate (its
# smoke size) through 1 and 4 process-mode workers
FLEET_FULL = dict(waves=16, selects=8, page_size=16, drop_queries=64,
                  steady=5, bench_req=320, procs=4)
FLEET_REHEARSE = dict(waves=4, selects=3, page_size=16, drop_queries=16,
                      steady=3, bench_req=40, procs=4)
CLUSTER_B = 4   # benchmarks/bench_serve.py:182: the process bench's wave cap
# phase 11b: the film KG that loads, replicates and recovers through the
# write path (host-bound: a vertex probe a create; PERF.md §5)
DUR_FULL = dict(n_films=5_000, n_actors=4_000, n_directors=250, n_genres=30)
DUR_REHEARSE = dict(n_films=300, n_actors=240, n_directors=20, n_genres=8)
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
# f32_seq runs past the window, so that the f32 check's mask drops keys
LM_FULL = dict(f32_seq=4096 + 512, consist=(2, 256), ring=(2, 64, 96),
               prefill_batch=1, decode_steps=16, check_layers=4,
               train_batch=1, warm_steps=2, timed_steps=8, dist_seq=4096,
               dist_micro=8, dist_calls=3)
LM_REHEARSE = dict(f32_seq=64, consist=(2, 40), ring=(2, 8, 24),
                   prefill_batch=1, decode_steps=3, seq=96, decode_batch=4,
                   check_layers=4, train_batch=1, warm_steps=2,
                   timed_steps=3, train_seq=64, dist_seq=64, dist_micro=3,
                   dist_calls=2)
# phase 9e (c): the dry run's matmul flops (launch/hloanalysis.py, a trace
# on meta tensors) against the profiler's count of the same aten matmuls
DRYRUN_MATMULS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
DRYRUN_FLOP_TOL = 0.01
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
# phase 9c, the zoo: gcn-cora, graphsage-reddit, meshgraphnet, nequip and
# bst FULL (src/repro/configs/{gcn_cora,graphsage_reddit,meshgraphnet,
# nequip,bst}.py) at their shape cells (src/repro/configs/registry.py:
# 106-131); None takes the cell's own geometry or batch.  ell_k:
# GraphSAGE's first-hop fanout (arXiv:1706.02216)
# sample_base None: the minibatch_lg cell's own base graph (232,965 nodes,
# 114,615,892 edges); sample_calls: timed fanout samples; sampler_db_*:
# phase_sampler_db's director seeds and calls
ZOO_FULL = dict(cora_scale=1.0, reduced_geometry=False, ogb=None,
                bst_items=None, bst_batch=None, serve={}, serve_calls=8,
                check_items=1_000_000, check_batch=4_096, ell_k=25,
                warm_steps=2, timed_steps=8, sample_base=None,
                sample_calls=8, sampler_db_seeds=16, sampler_db_calls=3)
ZOO_REHEARSE = dict(cora_scale=0.1, reduced_geometry=True,
                    ogb=(3_000, 12_000, 100, 1), bst_items=10_000,
                    bst_batch=256, serve=dict(serve_p99=16, serve_bulk=512),
                    serve_calls=2, check_items=1_000, check_batch=64,
                    ell_k=25, warm_steps=1, timed_steps=2,
                    sample_base=(2_000, 40_000), sample_calls=2,
                    sampler_db_seeds=4, sampler_db_calls=1)
# the zoo's card-against-CPU checks, float32 throughout, max |a - b| over
# max |b|: the card adds the edges' messages with atomics and cuBLAS sums
# its f32 products in other orders than the CPU (each op ~1e-7 relative,
# sums over thousands of edges and nodes reach ~1e-6); the loss is one
# mean, each gradient leaf a sum over the whole graph or batch
ZOO_LOSS_TOL, ZOO_GRAD_TOL = 1e-5, 1e-4
# a cell's own gradient tolerance, where its depth carries that rounding
# further: meshgraphnet's 15 residual blocks (30 MLPs, each ending in a
# LayerNorm whose backward divides by the row's spread) carry the atomic
# sums' ~1e-7 back to the encoder; on the H100 at minibatch_lg the loss
# was equal and the worst leaf (enc_node.w.0, the farthest from the loss)
# read 1.74e-4, 5.59e-4, 5.03e-4 and 5.27e-4 in four runs (median leaf
# 8e-6, 4-5 of 262 leaves past 1e-4): the run-to-run spread alone is 3x
ZOO_GRAD_TOL_CELL = {"zoo/meshgraphnet/minibatch_lg": 3e-3}
# NequIP under a rotation plus a translation, on the card: each molecule's
# energy within 1e-3 of max(1, |E|), the forces within 6e-3 absolute
# (tests/test_models.py:116-148)
NEQUIP_TOL = dict(energy=1e-3, forces=6e-3)
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
    try:
        dk.dedup_compact_rows(torch.empty((0, dk.MAX_W_WIDE + 1),
                                          dtype=torch.int32, device=dev), 8)
        raise AssertionError("a row wider than MAX_W_WIDE was accepted")
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


def _wide_edge_rows(rng):
    """Rows of the wide route (147,471 columns, a hedge's): valid counts
    around its key room in shared memory (49,536 keys: 32-bit counts take
    16 KB more), and 80,000 and all valid keys that the first pass puts in
    one bucket (multiples of 256), where a warp's start inside the bucket
    passes 2**16."""
    import numpy as np
    from repro_torch.kernels.dedup_compact import kernel as dk
    W = 147_471
    cap2 = dk.dedup_key_cap(W)
    rows = []
    for n in (cap2 // 2, cap2 // 2 + 1, cap2, cap2 + 1, W):
        r = rng.integers(0, 14_500_063, W)
        r[rng.permutation(W)[:W - n]] = I32MAX
        rows.append(r)
    for n in (80_000, W):
        r = rng.integers(0, 56_000, W) * 256
        r[rng.permutation(W)[:W - n]] = I32MAX
        rows.append(r)
    return np.stack(rows)


def _check_dedup(rng, t) -> int:
    """dedup_compact_rows against its plain version and the ref backend:
    the radix routine's edge widths, each with every row kind; the
    shared-memory edge rows (the scratch rows in use); R = 130 and R = 0;
    caps below and past the width; and the wide route's widths and edge
    rows."""
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
    # past MAX_W (a hedge at 4x the a1-kg caps): the wide route's 32-bit
    # digit counts, at its first width, around 2**16 and at the hedge's
    cases += [(f"W={W} (wide)", _dedup_rows(rng, W), cap)
              for W in (dk.MAX_W + 1, 65_535, 65_536, 65_537, 147_471)
              for cap in (4096, 16_384)]
    cases.append(("wide, valid counts at the shared-memory edges",
                  _wide_edge_rows(rng), 4096))
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
    # the mesh path, dedup_compact_rows' largest wide-route call in the
    # serving phase (a hedge's rows), and the LM zoo cell's flash_fwd and
    # rmsnorm_fwd (timed in phase 9d, see _zoo_kernel_rows)
    EXTRA = {"knn_topk": [("r1", lambda a: a[0].shape[0] == 1)],
             "flash_fwd": [("lm_zoo", lambda a: ZOO_CELL[0] is not None)],
             "rmsnorm_fwd": [("lm_zoo", lambda a: ZOO_CELL[0] is not None)],
             "dedup_compact_rows": [
                 ("mesh", lambda a: TIMED_PATH[0] == "mesh"),
                 ("wide", lambda a: TIMED_PATH[0] == "serving"
                  and a[0].shape[1] > _dk().MAX_W)],
             "sort_rows": [("mesh", lambda a: TIMED_PATH[0] == "mesh")]}

    def _wrap(self, name, fn):
        def rec(*args, **kw):
            size = None
            if self.only is None or name in self.only:
                size = self.WORK[name](args, kw)
                if size is not None and \
                        size >= self.best.get(name, (-1,))[0]:
                    self.best[name] = (size, args, kw)
            for label, want in self.EXTRA.get(name, ()):
                if want(args):
                    size = self.WORK[name](args, kw) if size is None \
                        else size
                    if size >= self.extra.get((name, label), (-1,))[0]:
                        self.extra[(name, label)] = (size, args, kw)
            return fn(*args, **kw)
        return rec

    def restore(self):
        for name, mod in self.mods.items():
            setattr(mod, name, self.orig[name])

    def park(self, dev):
        """Every recorded input moved to ``dev`` (the host while phase 9d
        needs the card's memory, the card again after it)."""
        import torch

        def move(a):
            if isinstance(a, torch.Tensor):
                return a.to(dev)
            if isinstance(a, (tuple, list)):
                return type(a)(move(x) for x in a)
            return a
        for book in (self.best, self.extra):
            for key, (size, args, kw) in list(book.items()):
                book[key] = (size, move(args),
                             {k: move(v) for k, v in kw.items()})


def _dk():
    from repro_torch.kernels.dedup_compact import kernel
    return kernel


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
    return kg, secs


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


def _pack_left(dn):
    """The delta pack the planner ran before the dedup kernel took wide
    rows (``planner._fit_delta``, since removed): each row's delta matches
    (NULL where none) packed left and cut to the most any row holds (one
    host read of that count)."""
    import torch
    from repro_torch.core.query import planner
    R = dn.shape[0]
    if R == 0 or dn.shape[1] == 0:
        return dn
    hit = dn >= 0
    pos = torch.cumsum(hit, dim=1, dtype=torch.int32) - 1
    W = max(int(pos[:, -1].max()) + 1, 1)
    out = torch.full((R, W + 1), planner._NULL, dtype=dn.dtype,
                     device=dn.device)
    out.scatter_(1, torch.where(hit, pos, W).long(), dn)
    return out[:, :W]


def _pack_ab(db, batch, caps, dev, n=6):
    """Whether a delta pack still pays now that the dedup kernel takes
    wide rows: the read-back batch on the written store, on the kernel
    backend, as the planner runs it (``plain``: rows of F + 2 (E + delta
    window) columns, past MAX_W, the kernel's wide route) and with every
    wave's delta matches packed first (``packed``: :func:`_pack_left`),
    in the order plain, packed, packed, plain, ...; equal results;
    host-clock ms to ``synchronize()`` and the widest dedup row of each
    arm.  Run after the write path's launches were read."""
    import numpy as np
    from repro_torch.core import backend as backend_mod
    from repro_torch.core.query import planner
    rows0, dedup0 = planner._delta_rows, backend_mod.dedup_compact_rows
    ms = {"plain": [], "packed": []}
    res, widest = {}, {"plain": 0, "packed": 0}
    mode = [None]

    def dedup(x, cap, *, backend):
        widest[mode[0]] = max(widest[mode[0]], x.shape[1])
        return dedup0(x, cap, backend=backend)
    backend_mod.dedup_compact_rows = dedup
    try:
        for i in range(2 * n):
            mode[0] = ("plain", "packed")[(i + i // 2) % 2]
            planner._delta_rows = rows0 if mode[0] == "plain" else (
                lambda *a: _pack_left(rows0(*a)))
            _sync(dev)
            t0 = time.perf_counter()
            r = db.query(batch, caps=caps, fused=True, backend="kernel")
            _sync(dev)
            ms[mode[0]].append((time.perf_counter() - t0) * 1e3)
            res.setdefault(mode[0], r)
    finally:
        planner._delta_rows, backend_mod.dedup_compact_rows = rows0, dedup0
    _same(res["plain"], res["packed"], "read-back batch, plain and packed")
    return {m: dict(ms_p50=float(np.median(v)), ms=v,
                    widest_dedup_row=widest[m]) for m, v in ms.items()}


def phase_write(kg, dev, sz, launches, rec=None, caps_kw=A1_CAPS):
    """The a1-kg ``update`` cell: ``sz["waves"]`` mutation waves through
    ``GraphDB.write(txns)`` on phase 5's store, a quarter of each wave
    staged before the previous wave commits; read-backs every
    ``readback_every`` waves and after the last; one WRITE line.  Returns
    what phase 6c goes on with: the op generator and its truth, the
    read-back batch, its caps and the commit times."""
    import numpy as np
    import torch
    from repro_torch.core.query.executor import QueryCaps
    from repro_torch.core.writes import CapacityError, DeleteVertex
    from repro_torch.kernels import _cuda
    db = kg.db
    caps = QueryCaps(**caps_kw)
    rng = np.random.default_rng(11)
    load = _WriteLoad(kg, rng, sz)
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
    launches["write"] = dict(_cuda.LAUNCHES)
    pack_ab = _pack_ab(db, batch, caps, dev)
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
        delta_pack_ab=pack_ab,
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
    return dict(load=load, batch=batch, caps=caps, commit_ms=cm_ms)


# ---------------------------------------------------------------------------
# phase 6c: background compaction, tasks, fault sites, vacuum, fast restart
# ---------------------------------------------------------------------------

def _mirrors_match(db, what):
    for c in ("dl_count", "il_count", "xd_count"):
        check(getattr(db, c).tolist() == getattr(db.store, c).tolist(),
              f"{what}: the host's {c} differs from the device count")


def _in_window(tq) -> bool:
    """Whether a background compaction has built its shadow and waits for
    its handoff (a wave now lands in the replayed tail)."""
    return any("handle" in t.state for t in tq._q)


class _MaintTimer:
    """Times ``begin_compaction``, ``try_handoff`` and the inline
    compactions of one database (each to ``synchronize()``), and the tail
    each handoff replays."""

    def __init__(self, db, dev):
        self.db, self.dev = db, dev
        self.builds, self.handoffs, self.inline = [], [], []
        self.wave = -1
        for name in ("begin_compaction", "try_handoff", "run_compaction",
                     "run_index_compaction"):
            setattr(db, name, self._wrap(name, getattr(db, name)))

    def _wrap(self, name, fn):
        def run(*a):
            db = self.db
            if name == "try_handoff":
                h = a[0]
                tails = {}
                if "edges" in h["kinds"]:
                    tails["edges"] = int((db.dl_count - h["marks"]["dl"]).sum()
                                         + (db.il_count
                                            - h["marks"]["il"]).sum())
                if "index" in h["kinds"]:
                    tails["index"] = int((db.xd_count
                                          - h["marks"]["xd"]).sum())
            _sync(self.dev)
            t0 = time.perf_counter()
            out = fn(*a)
            _sync(self.dev)
            secs = time.perf_counter() - t0
            if name == "begin_compaction":
                self.builds.append(dict(kinds=list(a[0]), seconds=secs,
                                        wave=self.wave))
            elif name == "try_handoff":
                self.handoffs.append(dict(ok=out, tails=tails, seconds=secs,
                                          wave=self.wave))
            else:
                self.inline.append(dict(kind=name, seconds=secs,
                                        wave=self.wave))
            return out
        return run

    def restore(self):
        for name in ("begin_compaction", "try_handoff", "run_compaction",
                     "run_index_compaction"):
            delattr(self.db, name)

    def handed_off(self) -> set:
        """The kinds handed off with a non-empty replayed tail."""
        return {k for h in self.handoffs for k, ok in h["ok"].items()
                if ok and h["tails"].get(k, 0) > 0}


def _reclaimable(db) -> set:
    """Gids of the rows ``vacuum`` may reclaim now: typed, dead at or
    before ``gc_ts``, below their shard's fresh-slot mark."""
    import numpy as np
    from repro_torch.core.addressing import gid_of
    S, cap_v = db.cfg.n_shards, db.cfg.cap_v
    vt = db.store.vtype.cpu().numpy().reshape(S, cap_v)
    dl = db.store.v_delete.cpu().numpy().reshape(S, cap_v)
    out = set()
    for s in range(S):
        dead = np.flatnonzero((vt[s] >= 0) & (dl[s] <= db.gc_ts()))
        out |= {gid_of(s, int(x), S) for x in dead if x < db.v_next[s]}
    return out


def phase_maintenance(kg, dev, sz, state, launches, load_s, rec=None):
    """Phase 6c on phase 6b's written store: a task queue and a fault
    injector attached, a pre-phase ``read_ts`` pinned, further waves of
    6b's mix with one ``pump(1)`` between waves until both ``edges`` and
    ``index`` were handed off in the background with a non-empty replayed
    tail (a wave inside a build's window stages no deletes: a structural
    mutation there refuses the handoff by design); the first handoff raced
    (one rebuild), one quantum crashed.  Read-backs after every handoff and
    at the end; then ``vacuum`` against the dead rows below ``gc_ts`` and a
    wave that reuses the reclaimed slots; then ``FastRestartCache``: hold,
    drop the database, restart on the card, the batch bit for bit and one
    more wave.  One MAINT line."""
    import numpy as np
    import torch
    from repro_torch.core import faults as faults_mod
    from repro_torch.core.recovery import FastRestartCache
    from repro_torch.core.tasks import TaskQueue
    from repro_torch.core.writes import CreateVertex
    from repro_torch.kernels import _cuda
    db, load, batch, caps = kg.db, state["load"], state["batch"], state["caps"]
    only = rec.only if rec is not None else None
    if rec is not None:
        rec.only = set()
    _cuda.reset_launches()
    t_phase = time.perf_counter()
    tq = db.task_queue = TaskQueue(db)
    db.faults = inj = faults_mod.FaultInjector(seed=6)
    inj.inject("tasks.compaction.handoff", action="race", times=(0,))
    inj.inject("tasks.quantum", action="raise", times=(1,))
    ts1 = db.clock
    rec1 = db.query(batch, caps=caps, fused=True, backend="kernel")
    _same(rec1, db.query(batch, caps=caps, fused=True, backend="ref"),
          "maintenance batch before the waves")
    db.active_query_ts.append(ts1)
    timer = _MaintTimer(db, dev)
    commit_s, pump_s, counts, readbacks, checked = [], [], {}, 0, [0, 0]

    def readback(what):
        nonlocal readbacks
        n_v, n_e = _write_readback(load, batch, rec1, ts1, caps, dev)
        _mirrors_match(db, what)
        readbacks += 1
        checked[0] += n_v
        checked[1] += n_e
    wave = 0
    while timer.handed_off() != {"edges", "index"}:
        check(wave < sz["maint_waves"], "maintenance: after "
              f"{wave} waves the kinds handed off with a tail are "
              f"{sorted(timer.handed_off())}, not edges and index")
        timer.wave = wave
        plan = load.plan()
        kinds = [k for k in plan["kinds"]
                 if not (k == "delete" and _in_window(tq))]
        staged = [x for x in (load.stage(k, plan) for k in kinds) if x]
        _sync(dev)
        t0 = time.perf_counter()
        res = db.write([t for t, _ in staged])
        _sync(dev)
        commit_s.append(time.perf_counter() - t0)
        load.settle([m for _, m in staged], res.statuses, res.reasons,
                    counts)
        n_ok = sum(all(h["ok"].values()) for h in timer.handoffs)
        t0 = time.perf_counter()
        tq.pump(1)
        _sync(dev)
        pump_s.append(time.perf_counter() - t0)
        if sum(all(h["ok"].values()) for h in timer.handoffs) > n_ok:
            readback(f"maintenance wave {wave}")
        wave += 1
    timer.wave = wave
    tq.drain()
    readback("maintenance, queue drained")
    db.active_query_ts.remove(ts1)
    check(tq.fault_restarts == 1, f"fault_restarts {tq.fault_restarts}")
    check(sorted(inj.fired) == [("tasks.compaction.handoff", 0, "race"),
                                ("tasks.quantum", 1, "raise")]
          and db.stats["compaction_rebuilds"] >= 1,
          f"the raced handoff did not rebuild: {inj.fired}")
    db.task_queue = db.faults = None
    timer.restore()
    timer.db = tq.db = None
    restarts = tq.fault_restarts

    # vacuum: every dead row below gc_ts, and a wave that reuses them
    want = _reclaimable(db)
    S = db.cfg.n_shards
    free0 = {(s, x) for s in range(S) for x in db.v_free[s]}
    _sync(dev)
    t0 = time.perf_counter()
    n_vac = db.vacuum()
    _sync(dev)
    vac_s = time.perf_counter() - t0
    got = {s + S * x for s in range(S) for x in db.v_free[s]
           if (s, x) not in free0}
    check(n_vac == len(want) and got == want and n_vac > 0,
          f"vacuum reclaimed {n_vac} slots, {len(want)} rows are dead "
          "below gc_ts")
    check(n_vac <= sz["reuse"], f"{n_vac} reclaimed slots, over the "
          f"{sz['reuse']} creates the reuse wave makes")
    txns = []
    for part in _chunks_of(range(n_vac), 8):
        t = db.create_transaction()
        db.write([CreateVertex("actor", 400_000_000 + k,
                               {"dob": 7_000_000 + k}) for k in part],
                 txn=t)
        txns.append(t)
    res = db.write(txns)
    check(res.statuses == ["COMMITTED"] * len(txns),
          "the wave of creates into reclaimed slots aborted")
    reused = {g for t in txns for g, *_ in t.create_v}
    check(reused == want, "the creates did not take the reclaimed slots")
    for g in reused:                  # a reclaimed film's gid is an actor's
        load.deleted.pop(g, None)
        load.dangling.pop(g, None)
        load.films.pop(g, None)
    for t in txns:
        for g, _, key, _, i in t.create_v:
            load.actors[g] = [key, int(i[load.col["dob"]])]
    now = db.clock
    rec_now = db.query(batch, caps=caps, fused=True, backend="kernel")
    n_v, n_e = _write_readback(load, batch, rec_now, now, caps, dev)
    checked[0] += n_v
    checked[1] += n_e

    # fast restart: hold, drop the database, restart on the card
    stats = dict(db.stats)
    cache = FastRestartCache()
    _sync(dev)
    t0 = time.perf_counter()
    cache.hold("a1", db)
    hold_s = time.perf_counter() - t0
    store_bytes = db.store.nbytes()
    kg.db = load.db = db = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    db = cache.restart("a1", device=dev)
    _sync(dev)
    restart_s = time.perf_counter() - t0
    cache.drop("a1")
    check(db.store.device.type == dev.type, "the restart left the card")
    kg.db = load.db = db
    _same(db.query(batch, caps=caps, fused=True, backend="kernel"), rec_now,
          "the restarted store's batch")
    _mirrors_match(db, "restarted store")
    plan = load.plan()
    staged = [x for x in (load.stage(k, plan) for k in plan["kinds"]
                          if k != "delete") if x]
    res = db.write([t for t, _ in staged])
    load.settle([m for _, m in staged], res.statuses, res.reasons, counts)
    check("COMMITTED" in res.statuses, "no write committed after restart")
    n_v, n_e = _write_readback(load, batch, rec_now, now, caps, dev)
    checked[0] += n_v
    checked[1] += n_e
    launches["maintenance"] = dict(_cuda.LAUNCHES)
    if rec is not None:
        rec.only = only
    cm = np.asarray(commit_s) * 1e3
    say("MAINT", cell="maintenance/update", waves=wave,
        committed=counts.get("committed", 0),
        aborted={k: v for k, v in counts.items() if k != "committed"},
        builds=timer.builds, handoffs=timer.handoffs,
        handed_off_with_tail=sorted(timer.handed_off()),
        bg_compactions=stats["bg_compactions"],
        rebuilds=stats["compaction_rebuilds"],
        fault_restarts=restarts, fired=inj.fired,
        inline_backstops=timer.inline,
        commit_ms_p50=float(np.median(cm)),
        commit_ms_p99=float(np.percentile(cm, 99)),
        write_commit_ms_p50=float(np.median(state["commit_ms"])),
        write_commit_ms_p99=float(np.percentile(state["commit_ms"], 99)),
        pump_ms_p50=float(np.median(pump_s) * 1e3),
        pump_ms_max=float(np.max(pump_s) * 1e3),
        readbacks=readbacks, checked_vertices=checked[0],
        checked_edges=checked[1], vacuum_slots=n_vac, vacuum_s=vac_s,
        reused_slots=len(reused), hold_s=hold_s, restart_s=restart_s,
        load_s=load_s, store_bytes=store_bytes,
        phase_seconds=time.perf_counter() - t_phase,
        reduced="n_shards 256 -> 1")


# ---------------------------------------------------------------------------
# phase 6d: the serving tier (A1Server) on 6c's store
# ---------------------------------------------------------------------------

class _CheckClock:
    """The ``time`` of the serve and planner modules during phase 6d: the
    real clocks less the seconds spent in the ``backend="ref"`` checks, so
    that a check moves no deadline, budget spend, EWMA or latency."""

    def __init__(self):
        self.paused = 0.0

    def monotonic(self):
        return time.monotonic() - self.paused

    def perf_counter(self):
        return time.perf_counter() - self.paused


def _same_unskipped(a, b, what) -> int:
    """``_same``, except for the slots a deadline skipped in ``a`` (the
    reference ran them): those must be flagged and unfailed.  Returns the
    number of skipped slots."""
    import numpy as np
    if a.deadline_q is None or not a.deadline_q.any():
        _same(a, b, what)
        return 0
    from repro_torch.core.addressing import NULL
    keep = ~a.deadline_q
    check(not a.failed_q[a.deadline_q].any(), f"{what}: a skipped slot failed")
    for f in ("counts", "failed_q", "rows_gid", "truncated", "shared_ovf_q"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None and y is not None:
            # every slot of this terminal was skipped: the kept ones are
            # of the other terminal, empty in the reference too
            check(bool((y[keep] == (False if f == "truncated"
                                    else NULL)).all()), f"{what}: {f}")
            continue
        check((x is None) == (y is None) and (
            x is None or np.array_equal(x[keep], y[keep])),
            f"{what}: {f} differs")
    for k in (a.rows or {}):
        check(np.array_equal(a.rows[k][keep].view(np.int32),
                             b.rows[k][keep].view(np.int32)),
              f"{what}: rows {k}")
    return int(a.deadline_q.sum())


class _RefCheck:
    """Wraps a server's ``_run``: every dispatch, base and hedge alike, is
    re-run at once with ``backend="ref"`` at the same ``read_ts``, caps,
    budget and ``fused`` (fused whenever a deadline made the dispatch
    fused), with the database's fault injector off, and must agree bit for
    bit.  The check's seconds go to ``clock.paused``."""

    def __init__(self, srv, clock):
        self.srv, self.clock, self.real = srv, clock, srv._run
        self.checked = self.skipped = 0
        srv._run = self

    def __call__(self, queries, caps, read_ts, fused=None, budget="auto",
                 deadline=None):
        srv = self.srv
        res = self.real(queries, caps, read_ts, fused=fused, budget=budget,
                        deadline=deadline)
        db = srv.db
        t0 = time.monotonic()
        inj, db.faults = db.faults, None
        try:
            ref = db.query(
                queries, caps=caps, read_ts=read_ts, backend="ref",
                mesh=srv.mesh if srv.use_spmd else None,
                fused=True if deadline is not None else fused,
                budget=srv._budget_for(len(queries)) if budget == "auto"
                else budget)
        finally:
            db.faults = inj
        self.skipped += _same_unskipped(res, ref,
                                        f"serving dispatch {self.checked}")
        self.checked += 1
        self.clock.paused += time.monotonic() - t0
        return res


class _ServeWrites:
    """Phase 6d's writes through ``A1Server.submit_write``: 6b's mix
    (``_WriteLoad``'s keys, pools, Zipf actors and delete targets) in
    WRITE_FULL's proportions, ``SERVE_TXNS`` transactions a read wave.  An
    ingest is two transactions, as a client without the gids must send
    it: the films and actors, then (once that committed) their director,
    genre and cast edges.  Every write id is kept, with its outcome."""

    def __init__(self, load, srv):
        self.load, self.srv = load, srv
        self.wids = []             # every submitted id
        self.open = {}             # wid -> (kind, meta), outcome unread
        self.links = []            # committed ingests waiting for edges
        self.results = {}          # wid -> write_result
        self.deleted, self.busy = set(), set()
        self.by_kind = {}

    def _submit(self, kind, ops, meta=None):
        wid = self.srv.submit_write(ops)
        self.wids.append(wid)
        self.open[wid] = (kind, meta)
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
        return wid

    def wave(self):
        from repro_torch.core.writes import (CreateEdge, CreateVertex,
                                             DeleteVertex, UpdateVertex)
        load, rng = self.load, self.load.rng
        plan = load.plan()
        for films in self.links:
            ops = []
            for f in films:
                ops += ([CreateEdge(f["director"], f["film"], "film.director",
                                    check=False),
                         CreateEdge(f["film"], f["genre"], "film.genre",
                                    check=False)]
                        + [CreateEdge(f["film"], a, "film.actor", check=False)
                           for a in f["actors"]])
            self._submit("link", ops, films)
        self.links = []
        kinds = [k for k, n in SERVE_TXNS.items() for _ in range(n)]
        rng.shuffle(kinds)
        for kind in kinds:
            if kind == "ingest":
                films, ops = [], []
                genre = plan["genres"].pop()
                for _ in range(2):
                    fat = {"gross": float(rng.uniform(1, 500)),
                           "year": int(rng.integers(1960, 2026)),
                           "genre": genre - load.g0}
                    films.append(dict(director=plan["dirs"].pop(),
                                      genre=genre))
                    ops += ([CreateVertex("film", load._new_key("film"), fat)]
                            + [CreateVertex("actor", load._new_key("actor"),
                                            {"dob": int(rng.integers(
                                                1940, 2000))})
                               for _ in range(3)])
                self._submit("ingest", ops, films)
            elif kind == "cast":
                if not load.live:
                    continue
                film = load.live[int(rng.integers(len(load.live)))]
                actor = load._zipf_actor()
                if film in self.busy or actor in load.films[film]["actors"]:
                    continue
                self._submit("cast", [CreateEdge(film, actor, "film.actor")],
                             (film, actor))
            elif kind == "update":
                load.dob_next += 1
                self._submit("update", [UpdateVertex(
                    load._zipf_actor(), "actor", {"dob": load.dob_next})])
            else:
                for _ in range(8):
                    film = load._target()
                    if film not in self.busy and film not in self.deleted:
                        break
                else:
                    continue
                self.busy.add(film)
                self._submit("delete", [DeleteVertex(film)], film)

    def settle(self):
        """Read every outcome the closed write waves stored."""
        for wid in list(self.open):
            r = self.srv.write_result(wid)
            if r is None:
                continue
            kind, meta = self.open.pop(wid)
            self.results[wid] = r
            ok = r["status"] == "COMMITTED"
            if kind == "delete":
                self.busy.discard(meta)
                if ok:
                    self.deleted.add(meta)
                    if meta in self.load.films:
                        self.load.live.remove(meta)
            elif ok and kind == "ingest":
                for j, f in enumerate(meta):
                    f.update(film=r["gids"][4 * j],
                             actors=r["gids"][4 * j + 1:4 * j + 4])
                self.links.append(meta)
            elif ok and kind == "link":
                for f in meta:
                    self.load.films[f["film"]] = dict(
                        f, actors=set(f["actors"]))
                    self.load.live.append(f["film"])
            elif ok and kind == "cast":
                self.load.films[meta[0]]["actors"].add(meta[1])


def _page_directors(kg, rng, n, page):
    """``n`` directors with 65-256 films at load (a select truncated at
    the a1-kg ``results`` cap of 64: every token refills), or, on a small
    graph, the ``n`` with the fewest films over a page."""
    import numpy as np
    e = kg.edges
    m = e["etype"] == kg.db.et("film.director").type_id
    cnt = np.bincount(e["src"][m], minlength=kg.n_directors)
    pick = np.flatnonzero((cnt >= 65) & (cnt <= 256))
    if len(pick) >= n:
        return [1_000 + int(d) for d in rng.choice(pick, n, replace=False)]
    over = np.flatnonzero(cnt > page)
    check(len(over) >= n, "phase 6d: too few directors to page")
    return [1_000 + int(d) for d in over[np.argsort(cnt[over],
                                                    kind="stable")][:n]]


def _serving_row_checks(srv, qids, rows):
    """The accounting invariants of tests/test_chaos_serve.py: every
    admitted id ends in exactly one result, and the counts partition."""
    import collections
    check(all(r is not None for r in rows), "serving: an id has no result")
    check(all(srv.query_result(q) is None for q in qids),
          "serving: a result was stored twice")
    by = collections.Counter(r["status"] for r in rows)
    st = srv.stats
    check(by.get("OK", 0) == st["served"]
          and by.get("ABORTED", 0) == st["aborted_faults"]
          and by.get("SHED", 0) == st["sheds"]
          and st["admitted"] == st["served"] + st["aborted_faults"],
          f"serving: results {dict(by)} against stats {st}")
    return by


def _class_latency(srv) -> dict:
    import numpy as np
    return {k: {"p50_ms": float(np.percentile(np.asarray(v) * 1e3, 50)),
                "p99_ms": float(np.percentile(np.asarray(v) * 1e3, 99)),
                "n": len(v)} for k, v in srv.latencies.items()}


def _open_loop(srv, docs, rate, seconds):
    """bench_serve's open-loop arrivals at ``rate`` a second for
    ``seconds``: before each ``pump()`` every arrival that is due is
    submitted (a wave's wall does not thin the arrivals); submissions stop
    at twice ``seconds`` if the host falls behind, and what is left unsent
    is counted; then the queue is flushed.  ``offered_qps`` is the rate
    the server saw: submissions over the time from the first to the
    last."""
    import numpy as np
    n_req = max(1, int(rate * seconds))
    sub, qids = {}, []
    t0 = time.perf_counter()
    i, t_last = 0, t0
    while i < n_req and time.perf_counter() - t0 < 2 * seconds:
        while i < n_req and time.perf_counter() >= t0 + i / rate:
            q, cls = docs[i % len(docs)]
            s0 = time.perf_counter()
            qid = srv.submit_query(q, tenant=f"t{i % 4}", qclass=cls)
            t_last = time.perf_counter()
            sub[qid] = t_last - s0
            qids.append(qid)
            i += 1
        srv.pump()
    srv.flush_queries()
    wall = time.perf_counter() - t0
    rows = [srv.query_result(q) for q in qids]
    _serving_row_checks(srv, qids, rows)
    ok = sum(r["status"] == "OK" and not r.get("budget_exhausted")
             for r in rows)
    shed = [q for q, r in zip(qids, rows) if r["status"] == "SHED"]
    lat = np.concatenate([np.asarray(v) for k, v in srv.latencies.items()
                          if k != "wave"]) * 1e3
    return {"rate_qps": rate, "submitted": len(qids),
            "unsent": n_req - len(qids),
            "offered_qps": len(qids) / max(t_last - t0, 1e-9),
            "submit_s": t_last - t0, "wall_s": wall,
            "goodput_qps": ok / wall, "ok": ok, "shed": len(shed),
            "shed_share": len(shed) / len(qids),
            "shed_p50_ms": (float(np.median([sub[q] for q in shed])) * 1e3
                            if shed else None),
            "budget_exhausted": srv.stats["budget_exhausted"],
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "read_waves": srv.stats["read_waves"]}


@contextlib.contextmanager
def _uncounted():
    """Kernel launches made inside are left out of the path's counts (the
    counts are put back as they were on entry)."""
    from repro_torch.kernels import _cuda
    saved = dict(_cuda.LAUNCHES)
    try:
        yield
    finally:
        _cuda.LAUNCHES.update(saved)


def phase_serving(kg, dev, sz, state, launches, rec=None):
    """Phase 6d on 6c's store: ``repro_torch.launch.serve.A1Server`` at
    the JAX package's serving defaults for the a1-kg serving cell's batch
    (``A1_CAPS``, ``budget_ms`` 100, ``queue_frac`` 0.1, ``read_batch`` 64,
    ``budget="auto"``, ``shared_knee`` 64).  (a) mixed serving: phase 5's
    ``mixed`` documents under both key laws, 4 tenants, the three query
    classes, one wave of 6b's write mix through ``submit_write`` a read
    wave and ``pump()`` after each, every dispatch held to
    ``backend="ref"`` (:class:`_RefCheck`); (b) during (a), selects paged
    to the end against the select at each token's pinned snapshot; (c)
    overload: a closed calibration loop, then open-loop arrivals at 1x and
    2x its rate with the shed watermark below the wave size
    (``benchmarks/bench_serve.py:74-135``), nothing checked inside; (d)
    chaos over 8 waves against a batch pinned before them.  Launches
    count as the ``serving`` path, the server's own only: the pinned
    batch's reads and the end-of-loop ``tasks.drain()`` are left out
    (:func:`_uncounted`).  ``rec`` records no main-path input here, as in
    6b and 6c (the kernel report stays at the read path's inputs), but
    keeps the largest wide-route dedup call (a hedge's rows) as
    ``dedup_compact_rows``' ``at_wide``; then a PROFILE of one wave at the
    knee and one SERVE_TIER line."""
    import dataclasses
    import numpy as np
    from repro_torch.core import faults as faults_mod
    from repro_torch.core.query import planner
    from repro_torch.kernels import _cuda
    from repro_torch.launch import serve
    db, load, caps = kg.db, state["load"], state["caps"]
    t_phase = time.perf_counter()
    rng = np.random.default_rng(11)
    cfg = dict(caps=caps, budget_ms=100.0, queue_frac=0.1, read_batch=64,
               budget="auto", shared_knee=64, page_size=sz["page_size"])
    classes = ["serve_q1"] * 22 + ["serve_q2"] * 21 + ["serve_q3"] * 21
    mixed = [qs for cell, qs in _batches(kg, rng, -(-sz["waves"] // 2), 64)
             if cell.startswith("mixed")][:sz["waves"]]
    clock = _CheckClock()
    saved = (serve.time, planner.time, db.compaction_watermark)
    serve.time = planner.time = clock
    # the background compaction's trigger: 1/64 of a delta log (the 0.5
    # default would not fire in 48 waves), so that the serving loop pumps
    # builds and handoffs between mixed waves that delete
    db.compaction_watermark = 1 / 64
    stats0 = dict(db.stats)
    timer = _MaintTimer(db, dev)
    only = rec.only if rec is not None else None
    if rec is not None:
        rec.only = set()
    _cuda.reset_launches()
    TIMED_PATH[0] = "serving"
    try:
        # (a) + (b): mixed serving with writes, paging
        srv = serve.A1Server(db, **cfg)
        chk = _RefCheck(srv, clock)
        wr = _ServeWrites(load, srv)
        dirs = _page_directors(kg, rng, sz["pages"], sz["page_size"])
        tokens = {}          # director -> [token, read_ts, pages]
        qids = []
        for w, qs in enumerate(mixed):
            timer.wave = w
            wr.wave()
            qids += [srv.submit_query(q, tenant=f"t{j % 4}",
                                      qclass=classes[j])
                     for j, q in enumerate(qs)]
            if w < len(dirs):
                page, tok = srv.select_paged(q_select(dirs[w]))
                check(tok is not None, f"select of director {dirs[w]}: "
                      "no continuation token")
                ts = srv._continuations[tok].read_ts
                db.active_query_ts.append(ts)       # held for the check
                tokens[dirs[w]] = [tok, ts, [page]]
            for t in tokens.values():
                if t[0] is not None:
                    page, t[0] = srv.next_page(t[0])
                    t[2].append(page)
            srv.pump()
            wr.settle()
        while any(t[0] is not None for t in tokens.values()):
            for t in tokens.values():           # clients page side by side
                if t[0] is not None:
                    page, t[0] = srv.next_page(t[0])
                    t[2].append(page)
        srv.flush_queries()
        srv.flush_writes()
        with _uncounted():
            srv.tasks.drain()
        wr.settle()
        timer.wave = len(mixed)
        rows = [srv.query_result(q) for q in qids]
        by = _serving_row_checks(srv, qids, rows)
        check(not wr.open and len(wr.results) == len(wr.wids),
              "serving: a write id has no result")
        check(srv.stats["read_waves"] >= len(mixed), "serving: waves")
        paged_rows = 0
        for d, (_, ts, pages) in tokens.items():
            got = np.concatenate(pages)
            res = db.query([q_select(d)], caps=dataclasses.replace(
                caps, results=1 << (len(got) + 1).bit_length()),
                read_ts=ts, backend="ref")
            want = res.rows_gid[0][res.rows_gid[0] >= 0]
            check(not res.truncated[0] and np.array_equal(got, want),
                  f"paging director {d}: {len(got)} rows paged, the select "
                  f"at its snapshot {ts} has {len(want)}")
            db.active_query_ts.remove(ts)
            paged_rows += len(got)
        check(not db.active_query_ts, "serving: pins left "
              f"{db.active_query_ts}")
        failed = sum(bool(r.get("failed")) for r in rows
                     if r["status"] == "OK")
        wave_s = np.asarray(srv.latencies["wave"])
        mix = dict(
            waves=len(mixed), reads=len(qids), checked_dispatches=chk.checked,
            deadline_skipped_slots=chk.skipped, statuses=dict(by),
            counters={k: srv.stats[k] for k in (
                "admitted", "served", "sheds", "tenant_sheds",
                "read_rejects", "aborted_faults", "budget_exhausted",
                "deadline_truncated_queries", "hedged", "breaker_skips",
                "breaker_opens", "budget_denied_hedges", "fastfails",
                "shared_ovf_queries", "read_waves", "continuations",
                "continuation_joins", "continuation_flushes",
                "cursor_refills", "planner_cache_hit_rate",
                "peak_frontier_bytes_per_query",
                "peak_frontier_bytes_shared")},
            fast_fail_share=failed / max(1, by.get("OK", 0)),
            latency=_class_latency(srv),
            budget_spend_ms=srv.stats["budget_spend_ms"],
            writes=dict(submitted=len(wr.wids), by_kind=wr.by_kind,
                        waves=srv.stats["write_waves"],
                        txns=srv.stats["write_txns"],
                        aborts=srv.stats["write_aborts"],
                        rejects=srv.stats["write_rejects"]),
            compaction=dict(
                watermark=db.compaction_watermark,
                bg_compactions=db.stats["bg_compactions"]
                - stats0["bg_compactions"],
                rebuilds=db.stats["compaction_rebuilds"]
                - stats0["compaction_rebuilds"],
                builds=timer.builds, handoffs=timer.handoffs,
                inline_backstops=timer.inline),
            paging=dict(tokens=len(tokens), rows=paged_rows,
                        pages=sum(len(t[2]) for t in tokens.values())))
        p50_wave = float(np.median(wave_s))

        # (c) overload: calibration, then 1x and 2x open loops
        docs = [(q, classes[j]) for qs in mixed for j, q in enumerate(qs)]
        cal = serve.A1Server(db, **cfg)
        t0 = time.perf_counter()
        for w in range(sz["calib_waves"]):
            for j, q in enumerate(mixed[w % len(mixed)]):
                cal.submit_query(q, tenant=f"t{j % 4}", qclass=classes[j])
            cal.flush_queries()
        rate = sz["calib_waves"] * 64 / (time.perf_counter() - t0)
        over = {"calibrated_qps": rate}
        for mult in (1, 2):
            o = serve.A1Server(db, **dict(cfg, shed_watermark=63))
            over[f"{mult}x"] = _open_loop(o, docs, mult * rate,
                                          sz["open_s"])

        # (d) chaos over 8 waves, a batch pinned before them
        batch = state["batch"]
        ts0 = db.clock
        db.active_query_ts.append(ts0)
        with _uncounted():
            base = db.query(batch, caps=caps, read_ts=ts0, fused=True,
                            backend="kernel")
        ch = serve.A1Server(db, **cfg)
        cchk = _RefCheck(ch, clock)
        cwr = _ServeWrites(load, ch)
        FI = faults_mod.FaultInjector
        plan = [FI(seed=21).inject("engine.wave", action="raise", times=(0,)),
                None,
                FI(seed=22).inject("engine.wave", action="raise", prob=1.0,
                                   max_fires=2),
                None,
                FI(seed=23).inject("serve.wave.stall", action="stall",
                                   stall_s=0.005, times=(0,)),
                None,
                FI(seed=24).inject("serve.continuation.stale",
                                   action="race", times=(1,)),
                None]
        fired, cq, restarts, tok = [], [], 0, None
        for w, inj in enumerate(plan):
            if inj is not None:
                db.faults = inj
            if w == 6:      # a token (its sweep is visit 0) the storm expires
                page, tok = ch.select_paged(q_select(dirs[-1]))
            cwr.wave()
            cq += [ch.submit_query(q, tenant=f"t{j % 4}", qclass=classes[j])
                   for j, q in enumerate(mixed[w % len(mixed)])]
            ch.pump()
            cwr.settle()
            if tok is not None:
                try:
                    page, tok = ch.next_page(tok)
                except KeyError:                  # the stale storm
                    restarts += 1
                    page, tok = ch.select_paged(q_select(dirs[-1]))
            if db.faults is not None:
                fired += [list(f) for f in db.faults.fired]
                db.faults = None
        while tok is not None:
            page, tok = ch.next_page(tok)
        ch.flush_queries()
        ch.flush_writes()
        with _uncounted():
            ch.tasks.drain()
        cwr.settle()
        crows = [ch.query_result(q) for q in cq]
        cby = _serving_row_checks(ch, cq, crows)
        aborted = [r for r in crows if r["status"] == "ABORTED"]
        check(ch.stats["wave_faults"] == 3 and len(aborted) == 64
              and all(r["reason"] == "fault:engine.wave" for r in aborted),
              f"chaos: wave_faults {ch.stats['wave_faults']}, "
              f"{len(aborted)} aborted")
        check(restarts == 1 and [f[0] for f in fired] == [
            "engine.wave", "engine.wave", "engine.wave",
            "serve.wave.stall", "serve.continuation.stale"],
            f"chaos: fired {fired}, {restarts} restarts")
        check(not cwr.open and len(cwr.results) == len(cwr.wids),
              "chaos: a write id has no result")
        with _uncounted():
            after = db.query(batch, caps=caps, read_ts=ts0, fused=True,
                             backend="kernel")
        _same(after, base, "chaos: the pinned batch after the storm")
        db.active_query_ts.remove(ts0)
        check(not db.active_query_ts, f"chaos: pins left "
              f"{db.active_query_ts}")
        chaos = dict(waves=len(plan), fired=fired, statuses=dict(cby),
                     wave_faults=ch.stats["wave_faults"],
                     aborted_faults=ch.stats["aborted_faults"],
                     restarts=restarts, checked_dispatches=cchk.checked,
                     writes=len(cwr.wids), pinned_batch_equal=True)
        launches["serving"] = dict(_cuda.LAUNCHES)
        check(chk.checked + cchk.checked > 0, "serving: nothing checked")

        # one read wave at the knee, profiled (no check inside)
        if dev.type == "cuda":
            srv._run = chk.real
            qs = mixed[0]
            for j, q in enumerate(qs[:-1]):
                srv.submit_query(q, tenant=f"t{j % 4}", qclass=classes[j])
            _profile("serving/wave_64", lambda: srv.submit_query(
                qs[-1], tenant="t3", qclass=classes[-1]), p50_wave)
            srv.flush_queries()
    finally:
        TIMED_PATH[0] = None
        serve.time, planner.time, db.compaction_watermark = saved
        db.task_queue = db.faults = None
        timer.restore()
        if rec is not None:
            rec.only = only
    say("SERVE_TIER", cell="serving/mixed", mixed=mix, overload=over,
        chaos=chaos, check_seconds=clock.paused,
        phase_seconds=time.perf_counter() - t_phase,
        reduced="n_shards 256 -> 1")


# ---------------------------------------------------------------------------
# phase 6e: the fleet (launch/cluster.py) on 6d's store
# ---------------------------------------------------------------------------

def _fleet_result(fe, pub, write=False, deadline_s=120.0, sleep_s=0.0):
    """A routed id's one result: polled (flushing the fleet between polls)
    until ``deadline_s``; raises when none comes."""
    get = fe.write_result if write else fe.query_result
    t_end = time.monotonic() + deadline_s
    while True:
        r = get(pub)
        if r is not None:
            return r
        check(time.monotonic() < t_end, f"fleet: no result for {pub}")
        if sleep_s:
            time.sleep(sleep_s)
        else:
            fe.flush()


def _fleet_write(fe, ops, **kw):
    return _fleet_result(fe, fe.submit_write(ops), write=True, **kw)


def _fleet_count(fe, doc, **kw):
    r = _fleet_result(fe, fe.submit_query(doc, budget_ms=1e6), **kw)
    check(r["status"] == "OK" and not r.get("failed"), f"fleet count {r}")
    return int(r["count"])


def _actor_films(akey):
    """The films of actor ``akey``, counted."""
    return {"type": "actor", "id": int(akey),
            "_in_edge": {"type": "film.actor",
                         "_target": {"type": "film", "select": "count"}}}


def _fleet_stream(fe, did):
    """One select paged to its end through the SLB: (rows, read_ts)."""
    import numpy as np
    page, tok = fe.select_paged(q_select(did))
    check(tok is not None, f"fleet select of director {did}: no token")
    ts = fe._tokmeta[tok]["read_ts"]
    got = [page]
    while tok is not None:
        page, tok = fe.next_page(tok)
        got.append(page)
    return np.concatenate(got), ts


def _select_at(db, caps, did, ts, n):
    """The select of director ``did`` at ``ts`` on ``backend="ref"``, with
    room for ``n`` rows."""
    import dataclasses
    res = db.query([q_select(did)], caps=dataclasses.replace(
        caps, results=1 << (n + 1).bit_length()), read_ts=ts, backend="ref")
    check(not res.truncated[0], f"select of director {did}: truncated")
    return res.rows_gid[0][res.rows_gid[0] >= 0]


ENDS = ("served", "aborted_faults", "budget_exhausted", "sheds",
        "read_rejects")     # the one way each read a server took ends


def _admitted(fe) -> dict:
    """{cid: the worker's read counters} over the alive workers."""
    return {c: {k: w[k] for k in ("admitted", "tenant_sheds") + ENDS}
            for c, w in fe.cluster_stats()["workers"].items()}


def phase_fleet(kg, dev, sz, state, launches, rec=None) -> dict:
    """Phase 6e on 6d's store: the A1 fleet (``repro_torch.launch.
    cluster``).  (a) ``A1Frontend(db, 4)`` inproc at 6d's serving settings:
    waves of phase 5's ``mixed`` documents (both key laws) through
    ``submit_query``, a wave of 6b's write mix through ``submit_write``
    and ``pump()`` after each, every coordinator's dispatches held to
    ``backend="ref"`` (:class:`_RefCheck`), every id ending in one result,
    the workers' admissions summing to the routed reads, the reads spread
    over at least 2 workers; a PROFILE of one fleet wave of 64.  (b)
    selects paged by 16 against the select at each token's snapshot, then
    again under a stale-route storm (``cluster.route.stale``), dropped
    frames (``transport.drop``) under a batch of reads, and one owner
    killed mid-stream (``cluster.worker.crash``), each stream bit-identical
    to its clean one; no pin left.  (c) a 5-coordinator fleet on a fake
    membership clock: an acked commit survives its primary's kill (timed
    as ``bench_serve._bench_failover``: kill to the first served write
    against the median of steady single-write waves), a mid-wave crash
    commits once, a deposed zombie is fenced, a lease expires.  (d)
    process mode (:func:`_fleet_process`).  Launches of (a)-(c) count as
    the ``fleet`` path; (e) adds its own after phase 7
    (:func:`phase_fleet_nearest`), which prints the FLEET line.  Returns
    the figures so far."""
    import collections
    import gc
    import numpy as np
    import torch
    from repro_torch.core import faults as faults_mod
    from repro_torch.core.query import planner
    from repro_torch.core.writes import CreateEdge, CreateVertex
    from repro_torch.kernels import _cuda
    from repro_torch.launch import cluster, serve
    db, load, caps = kg.db, state["load"], state["caps"]
    t_phase = time.perf_counter()
    rng = np.random.default_rng(13)
    cfg = dict(caps=caps, budget_ms=100.0, queue_frac=0.1, read_batch=64,
               budget="auto", shared_knee=64, page_size=sz["page_size"])
    classes = ["serve_q1"] * 22 + ["serve_q2"] * 21 + ["serve_q3"] * 21
    mixed = [qs for cell, qs in _batches(kg, rng, -(-sz["waves"] // 2), 64)
             if cell.startswith("mixed")][:sz["waves"]]
    clock = _CheckClock()
    saved = (serve.time, planner.time, cluster.time)
    serve.time = planner.time = cluster.time = clock
    FI = faults_mod.FaultInjector
    only = rec.only if rec is not None else None
    if rec is not None:
        rec.only = set()
    info, fleets, chks = {}, [], []

    def fleet(src, n, **kw):
        t0 = time.perf_counter()
        fe = cluster.A1Frontend(src, n, device=dev, **kw)
        fleets.append(fe)
        chks.extend(_RefCheck(w.coord.server, clock)
                    for w in fe.workers.values())
        return fe, time.perf_counter() - t0

    def close(fe):
        fe.close()
        fleets.remove(fe)

    _cuda.reset_launches()
    TIMED_PATH[0] = "fleet"
    try:
        # (a) mixed traffic through the SLB
        t_part = time.perf_counter()
        fa, start_a = fleet(db, 4, name="fleet_a", **cfg)
        check({id(w.coord.server.db) for w in fa.workers.values()}
              == {id(fa.db)} and fa.db.device == db.device,
              "fleet: the coordinators do not share one store on the card")
        wr = _ServeWrites(load, fa)
        pubs, walls = [], []
        for qs in mixed:
            t0 = time.perf_counter()
            wr.wave()
            pubs += [fa.submit_query(q, tenant=f"t{j % 4}",
                                     qclass=classes[j])
                     for j, q in enumerate(qs)]
            fa.pump()
            walls.append(time.perf_counter() - t0)
            wr.settle()
        fa.flush()
        for _ in range(64):
            if not wr.open:
                break
            wr.settle()
            fa.flush()
        rows = [_fleet_result(fa, p) for p in pubs]
        check(all(fa.query_result(p)["status"] == "UNKNOWN" for p in pubs),
              "fleet: a read id answered twice")
        check(not wr.open and len(wr.results) == len(wr.wids),
              "fleet: a write id has no result")
        by = collections.Counter(r["status"] for r in rows)
        adm = _admitted(fa)
        tot = {k: sum(a[k] for a in adm.values()) for k in next(
            iter(adm.values()))}
        check(sum(tot[k] for k in ENDS) == fa.stats["routed_queries"]
              == len(pubs) and tot["admitted"] <= len(pubs),
              f"fleet: the workers' reads {tot} against "
              f"{fa.stats['routed_queries']} routed, {len(pubs)} sent")
        check(by.get("OK", 0) == tot["served"] + tot["budget_exhausted"]
              and by.get("SHED", 0) == tot["sheds"]
              and by.get("ABORTED", 0) == tot["aborted_faults"],
              f"fleet: results {dict(by)} against {tot}")
        spread = {c: a["admitted"] for c, a in adm.items()}
        check(sum(1 for a in spread.values() if a > 0) >= 2,
              f"fleet: routing pinned one worker {spread}")
        info["a"] = dict(
            waves=len(mixed), reads=len(pubs), statuses=dict(by),
            admitted_by_worker=spread, totals=tot,
            routed=fa.stats["routed_queries"],
            fleet_wave_p50_ms=float(np.median(walls)) * 1e3,
            writes=dict(submitted=len(wr.wids), by_kind=wr.by_kind,
                        statuses=dict(collections.Counter(
                            r["status"] for r in wr.results.values()))),
            start_s=start_a, frames_sent=fa.cluster_stats()["frontend"][
                "frames_sent"], seconds=time.perf_counter() - t_part)
        t_part = time.perf_counter()

        # (b) paging: clean, stale routes, dropped frames, a crash
        dirs = _page_directors(kg, rng, sz["selects"], sz["page_size"])
        clean, paged_rows = {}, 0
        for d in dirs:
            got, ts = _fleet_stream(fa, d)
            check(np.array_equal(got, _select_at(fa.db, caps, d, ts,
                                                 len(got))),
                  f"fleet paging director {d}: differs from its snapshot")
            clean[d] = got
            paged_rows += len(got)
        s0 = dict(fa.stats)
        fa.db.faults = FI(seed=61).inject("cluster.route.stale",
                                          action="race", prob=1.0)
        for d in dirs:
            got, _ = _fleet_stream(fa, d)
            check(np.array_equal(got, clean[d]),
                  f"fleet stale storm: director {d} differs")
        fa.db.faults = None
        stale = fa.stats["stale_routes"] - s0["stale_routes"]
        routes = fa.stats["continuation_routes"] - s0["continuation_routes"]
        check(stale == routes > 0 and fa.stats["takeovers"] == 0,
              f"fleet stale storm: {stale} bounced of {routes}")
        s0, adm0 = dict(fa.stats), _admitted(fa)
        fa.db.faults = FI(seed=62).inject("transport.drop", action="race",
                                          prob=0.1, max_fires=8)
        qs = mixed[0][:sz["drop_queries"]]
        dp = [fa.submit_query(q, tenant=f"t{j % 4}", qclass=classes[j])
              for j, q in enumerate(qs)]
        fa.flush()
        drows = [_fleet_result(fa, p) for p in dp]
        dropped = len(fa.db.faults.fired)
        fa.db.faults = None
        adm1 = _admitted(fa)
        once = sum(adm1[c][k] - adm0[c][k] for c in adm1 for k in ENDS)
        retrans = fa.stats["retransmits"] - s0["retransmits"]
        check(dropped >= 1 and retrans == dropped and once == len(dp),
              f"fleet drops: {dropped} dropped, {retrans} retransmitted, "
              f"{once} admissions for {len(dp)} reads")
        s0 = dict(fa.stats)
        fa.db.faults = FI(seed=63).inject("cluster.worker.crash",
                                          action="race", times=(1,))
        got, _ = _fleet_stream(fa, dirs[0])
        fa.db.faults = None
        check(np.array_equal(got, clean[dirs[0]])
              and fa.stats["takeovers"] - s0["takeovers"] == 1
              and fa.stats["worker_kills"] - s0["worker_kills"] == 1,
              "fleet takeover: the stream after the owner's crash differs")
        check(not fa.db.active_query_ts, f"fleet: pins left "
              f"{fa.db.active_query_ts}")
        info["b"] = dict(
            selects=len(dirs), rows=paged_rows, stale_routes=stale,
            continuation_routes=routes, dropped_frames=dropped,
            retransmits=retrans, drop_reads=len(dp),
            drop_statuses=dict(collections.Counter(
                r["status"] for r in drows)),
            takeovers=fa.stats["takeovers"],
            killed=fa.stats["worker_kills"], pins_left=0,
            seconds=time.perf_counter() - t_part)

        # one fleet wave of 64 at the knee, profiled (no check inside)
        if dev.type == "cuda":
            for c in chks:
                c.srv._run = c.real

            def wave():
                qp = [fa.submit_query(q, tenant=f"t{j % 4}",
                                      qclass=classes[j])
                      for j, q in enumerate(mixed[1])]
                fa.flush()
                for p in qp:
                    _fleet_result(fa, p)
            _profile("fleet/wave_64", wave,
                     info["a"]["fleet_wave_p50_ms"] / 1e3)
            for c in chks:
                c.srv._run = c

        # (c) failover on a fresh 5-coordinator fleet of the same store
        t_part = time.perf_counter()
        t = {"now": 0.0}
        fb, start_b = fleet(fa.db, 5, name="fleet_b",
                            membership_clock=lambda: t["now"],
                            write_deadline_ms=1e9, **cfg)
        close(fa)
        del fa
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        films = list(load.live[-8:])
        check(len(films) >= 4, "fleet: too few live films")
        akey = load._new_key("actor")
        r = _fleet_write(fb, [CreateVertex("actor", akey, {"dob": 1970})])
        check(r["status"] == "COMMITTED", f"fleet: actor create {r}")
        a_gid = r["gids"][0]
        doc = _actor_films(akey)
        acked = _fleet_write(fb, [CreateEdge(films[0], a_gid, "film.actor")])
        check(acked["status"] == "COMMITTED", f"fleet: acked write {acked}")
        _fleet_write(fb, [CreateVertex("actor", load._new_key("actor"))])
        steady = []
        for _ in range(sz["steady"]):
            t0 = time.perf_counter()
            r = _fleet_write(fb, [CreateVertex("actor",
                                               load._new_key("actor"))])
            steady.append(time.perf_counter() - t0)
            check(r["status"] == "COMMITTED", f"fleet: steady write {r}")
        t0 = time.perf_counter()
        fb.kill_worker(fb.membership.primary)
        r = _fleet_write(fb, [CreateEdge(films[1], a_gid, "film.actor")])
        rec_s = time.perf_counter() - t0
        check(r["status"] == "COMMITTED", f"fleet: first write after {r}")
        view = fb.membership.view()
        check(view["leases"][0]["state"] == "evicted" and view["epoch"] == 2
              and view["primary"] == 1 and fb.stats["failovers"] == 1,
              f"fleet: failover view {view}")
        check(_fleet_count(fb, doc) == 2, "fleet: the acked commit was lost")
        steady_s = float(np.median(steady))
        # primary.crash.midwave: committed, never acked; resolved by rid
        fb.db.faults = FI(seed=7).inject("primary.crash.midwave",
                                         times=(0,))
        mid = _fleet_write(fb, [CreateEdge(films[2], a_gid, "film.actor")])
        fired = [list(f) for f in fb.db.faults.fired]
        fb.db.faults = None
        check(fired == [["primary.crash.midwave", 0, "raise"]]
              and mid["status"] == "COMMITTED"
              and fb.stats["failovers"] == 2 and not fb.workers[1].alive
              and _fleet_count(fb, doc) == 3,
              f"fleet mid-wave crash: {mid}, fired {fired}")
        # a deposed zombie: its staged wave is fenced at the commit
        pub = fb.submit_write([CreateEdge(films[3], a_gid, "film.actor")])
        check(fb.write_result(pub) is None, "fleet: the zombie's wave closed")
        zc = fb.membership.primary
        fb._handle_events(fb.membership.evict(zc, reason="partition"))
        zombie = fb.workers[zc].coord
        check(zombie.role == "primary" and fb.membership.primary != zc,
              "fleet: the zombie heard its deposition")
        n = zombie.server.flush_writes()
        check(n == 1 and zombie.server.stats["write_fenced"] == 1
              and _fleet_count(fb, doc) == 3,
              "fleet: the zombie's wave reached the store")
        fenced = fb.write_result(pub)
        check(fenced["status"] == "ABORTED_FAILOVER"
              and fenced["retry_after_ms"] > 0, f"fleet: zombie {fenced}")
        retry = _fleet_write(fb, [CreateEdge(films[3], a_gid,
                                             "film.actor")])
        check(retry["status"] == "COMMITTED" and _fleet_count(fb, doc) == 4,
              f"fleet: zombie retry {retry}")
        # lease expiry on the fake membership clock
        lp = fb.membership.primary
        fb.db.faults = FI(seed=3).inject(
            "membership.heartbeat.drop", action="race",
            times=tuple(2 * i + fb.membership.admitted().index(lp)
                        for i in range(3)))
        states = []
        for now in (0.0, 2.5, 4.6):
            t["now"] = now
            fb.pump()
            states.append(fb.membership.view()["leases"][lp]["state"])
        fb.db.faults = None
        check(states == ["alive", "suspect", "evicted"]
              and fb.membership.primary not in (None, lp)
              and fb.stats["failovers"] == 4,
              f"fleet lease expiry: {states}, {fb.membership.view()}")
        last = _fleet_write(fb, [CreateEdge(films[4], a_gid, "film.actor")])
        check(last["status"] == "COMMITTED" and _fleet_count(fb, doc) == 5,
              f"fleet: write after the lease expiry {last}")
        check(not fb.db.active_query_ts, "fleet (c): pins left")
        info["c"] = dict(
            workers=5, start_s=start_b, failovers=fb.stats["failovers"],
            epoch=fb.membership.epoch, primary=fb.membership.primary,
            steady_write_ms=[s * 1e3 for s in steady],
            steady_p50_ms=steady_s * 1e3, recovery_ms=rec_s * 1e3,
            recovery_ratio=rec_s / steady_s, jax_gate="< 10x",
            midwave=dict(fired=fired, status=mid["status"]),
            zombie=dict(write_fenced=1, status=fenced["status"],
                        retry_after_ms=fenced["retry_after_ms"]),
            lease_states=states,
            checked_dispatches=sum(c.checked for c in chks),
            deadline_skipped_slots=sum(c.skipped for c in chks),
            seconds=time.perf_counter() - t_part)
        launches["fleet"] = dict(_cuda.LAUNCHES)
        TIMED_PATH[0] = None
        src = fb.db
        close(fb)
        del fb
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        serve.time, planner.time, cluster.time = saved
        t_part = time.perf_counter()
        info["d"] = _fleet_process(src, kg, dev, caps, mixed, load, sz)
        info["d"]["seconds"] = time.perf_counter() - t_part
        del src
    finally:
        TIMED_PATH[0] = None
        serve.time, planner.time, cluster.time = saved
        for fe in list(fleets):
            fe.close()
        if rec is not None:
            rec.only = only
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    info["check_seconds"] = clock.paused
    info["phase_seconds"] = time.perf_counter() - t_phase
    return info


def _worker_count(fe, cid, doc, deadline_s=120.0):
    """A count routed to ONE process-mode worker and polled there:
    (count, fast-failed)."""
    resp = fe._rpc(cid, {"op": "query", "doc": doc, "budget_ms": 1e6})
    check(resp is not None and resp["status"] == "OK",
          f"worker {cid}: query {resp}")
    fe._rpc(cid, {"op": "flush"})
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        r = fe._rpc(cid, {"op": "result", "qid": resp["qid"]})
        if r is not None and r.get("result") is not None:
            r = r["result"]
            check(r["status"] == "OK" and not r.get("budget_exhausted"),
                  f"worker {cid}: {r}")
            return int(r["count"]), bool(r["failed"])
        time.sleep(0.005)
    check(False, f"worker {cid} never answered")


def _cluster_warm(fe, docs):
    """benchmarks/bench_serve.py:194-210: every worker, every closable
    wave size."""
    for cid in list(fe.workers):
        for q in range(1, CLUSTER_B + 1):
            qids = []
            for i in range(q):
                resp = fe._rpc(cid, {"op": "query", "doc": docs[i],
                                     "budget_ms": 1e9})
                check(resp["status"] == "OK", f"warm: {resp}")
                qids.append(resp["qid"])
            fe._rpc(cid, {"op": "flush"})
            for qid in qids:
                r = fe._rpc(cid, {"op": "result", "qid": qid})
                check(r["result"]["status"] == "OK", f"warm: {r}")


def _cluster_calibrate(fe, docs, waves=10):
    """bench_serve.py:213-222: a closed loop of full waves -> reads/s."""
    t0 = time.perf_counter()
    for w in range(waves):
        pubs = [fe.submit_query(docs[(w * CLUSTER_B + i) % len(docs)],
                                budget_ms=1e9) for i in range(CLUSTER_B)]
        fe.flush()
        for p in pubs:
            _fleet_result(fe, p, sleep_s=0.001)
    return waves * CLUSTER_B / (time.perf_counter() - t0)


def _cluster_open(fe, docs, rate_qps, n_req, budget_ms):
    """bench_serve.py:225-253: open-loop arrivals through the SLB, each
    request's lateness docked from its budget; goodput counts the answers
    inside their budget."""
    pubs = []
    t0 = time.perf_counter()
    for i in range(n_req):
        sched = t0 + i / rate_qps
        dt = sched - time.perf_counter()
        if dt > 0:
            time.sleep(dt)
        late_ms = max(0.0, (time.perf_counter() - sched) * 1e3)
        pubs.append(fe.submit_query(docs[i % len(docs)],
                                    budget_ms=max(0.0, budget_ms - late_ms)))
    fe.flush()
    rows = [_fleet_result(fe, p, sleep_s=0.001) for p in pubs]
    wall = time.perf_counter() - t0
    ok = sum(r["status"] == "OK" and not r.get("budget_exhausted")
             for r in rows)
    exhausted = sum(bool(r.get("budget_exhausted")) for r in rows)
    return {"goodput": max(ok, 1) / wall, "ok": ok, "exhausted": exhausted,
            "n": n_req, "wall_s": wall}


def _fleet_process(src, kg, dev, caps, mixed, load, sz) -> dict:
    """Phase 6e (d): process mode.  The frontend exports its held slot as
    one shared-memory segment and spawns workers that copy it onto the
    card (one CUDA context each); their kernel launches are their own
    process's and go uncounted.  First ``bench_serve._bench_cluster``: a
    1-worker fleet's closed-loop calibration, then open-loop arrivals at
    1x and 2x of it through 1 and 4 workers (``bench_req`` each); then, on
    the 4-worker fleet: each worker's counts against ``backend="ref"`` on
    the frontend's store, a write shipped through the durable log and
    replayed everywhere before its ack (read-your-write on every worker,
    lag 0, the durable frontier), the owner of a paged select killed and
    taken over (its pin released on the survivors' ``gc_ts``), and a
    commit after the failover."""
    import shutil
    import torch
    from repro_torch.launch import cluster
    store_bytes = src.store.nbytes()
    shm_free = shutil.disk_usage("/dev/shm").free
    dev_free = (torch.cuda.mem_get_info()[0] if dev.type == "cuda"
                else None)
    procs = sz["procs"]
    mem = dict(shm_free_bytes=shm_free, device_free_bytes=dev_free,
               store_bytes=store_bytes, host_copies=2,
               device_copies=procs)
    say("FLEET_MEM", **mem)
    cut = None
    if shm_free < 1.2 * store_bytes or (
            dev_free is not None
            and dev_free < procs * 1.1 * store_bytes + 4e9):
        # the one-shard store does not fit: the durability phase's film KG
        from repro_torch.core.addressing import StoreConfig
        from repro_torch.data.kg import load_film_kg
        small = load_film_kg(**DUR_FULL, seed=5, device=dev,
                             cfg=StoreConfig(**_dur_cfg(DUR_FULL)))
        cut = (f"process mode on a load_film_kg store of "
               f"{small.db.store.nbytes()} bytes: the one-shard store "
               f"({store_bytes} bytes) does not fit")
        src, kg = small.db, small
        mixed = [[q1(k) for k in small.director_keys[:64]]]
    docs = [q for qs in mixed for q in qs]
    ref = {}

    def want(doc):
        key = json.dumps(doc, sort_keys=True)
        if key not in ref:
            res = src.query([doc], caps=caps, fused=True, backend="ref")
            ref[key] = (int(res.counts[0]), bool(res.failed_q[0]))
        return ref[key]
    kw = dict(caps=caps, read_batch=CLUSTER_B, queue_frac=0.5,
              write_batch=1)
    res, qps, budget, out = {}, None, None, {"memory": mem, "cut": cut}
    for nw in (1, procs):
        t0 = time.perf_counter()
        fe = cluster.A1Frontend(src, nw, mode="process", device=dev,
                                name=f"fleet_p{nw}", **kw)
        try:
            out[f"w{nw}"] = dict(start_s=time.perf_counter() - t0,
                                 attach_s=dict(fe.attach_s))
            _cluster_warm(fe, docs)
            if nw == 1:
                qps = _cluster_calibrate(fe, docs)
                budget = max(25.0, 3e3 * CLUSTER_B / qps)
            for mult in (1, 2):
                res[(nw, mult)] = _cluster_open(fe, docs, mult * qps,
                                                sz["bench_req"], budget)
            out[f"w{nw}"]["bench_s"] = time.perf_counter() - t0
            if nw == procs:
                out["checks"] = _process_checks(fe, src, caps, docs, want,
                                                load, kg)
        finally:
            fe.close()
    out.update(calibrated_qps=qps, budget_ms=budget,
               open={f"{m}x_w{n}": r for (n, m), r in sorted(res.items())},
               goodput_ratio_2x=res[(procs, 2)]["goodput"]
               / res[(1, 2)]["goodput"], jax_gate=">= 2.5x (not gated)")
    return out


def _process_checks(fe, src, caps, docs, want, load, kg) -> dict:
    """Phase 6e (d)'s checks on the 4-worker process fleet (see
    :func:`_fleet_process`)."""
    import numpy as np
    from repro_torch.core.writes import CreateEdge, CreateVertex
    counts = {}
    # counts that do not fast-fail (a failed one is hedged at 4x caps):
    # most Zipf starts do at the a1-kg caps, so the active law's first
    sure = []
    for doc in docs[::-1][:512]:
        if len(sure) < 4 and not want(doc)[1]:
            sure.append(doc)
    check(len(sure) == 4, "process: too few counts that do not fast-fail")
    for cid in fe._alive():
        for doc in sure:
            got = _worker_count(fe, cid, doc)
            check(got == want(doc), f"worker {cid}: count {got}, ref "
                  f"{want(doc)}")
        counts[cid] = 4
    # a write shipped and replayed everywhere before its ack
    fkey, akey = load._new_key("film"), load._new_key("actor")
    w1 = _fleet_write(fe, [
        CreateVertex("film", fkey, {"gross": 1.0, "year": 2030, "genre": 0}),
        CreateVertex("actor", akey, {"dob": 1980})], sleep_s=0.001)
    check(w1["status"] == "COMMITTED", f"process write {w1}")
    film, actor = w1["gids"]
    w2 = _fleet_write(fe, [CreateEdge(film, actor, "film.actor")],
                      sleep_s=0.001)
    check(w2["status"] == "COMMITTED", f"process edge write {w2}")
    for cid in fe._alive():
        check(_worker_count(fe, cid, _actor_films(akey)) == (1, False),
              f"worker {cid}: the acked write is not visible")
    st = fe.cluster_stats()
    frontier = fe.rlog.os.get_meta("g.wave_frontier", 0)
    check(st["replication"]["max_lag"] == 0
          and fe.stats["replicated_waves"] >= 2
          and frontier >= st["replication"]["shipped_seq"],
          f"process replication {st['replication']}, frontier {frontier}")
    rep = dict(st["replication"], wave_frontier=frontier,
               replicated_waves=fe.stats["replicated_waves"])
    # the owner of a paged select killed mid-stream
    d = _page_directors(kg, np.random.default_rng(5), 1, 16)[0]
    page, tok = fe.select_paged(q_select(d))
    check(tok is not None, "process select: no token")
    owner = fe._tokmeta[tok]["cid"]
    read_ts = fe._tokmeta[tok]["read_ts"]
    fe.pump()                                    # pins reach the workers
    got = [page]
    fe.kill_worker(owner)
    while tok is not None:
        page, tok = fe.next_page(tok)
        got.append(page)
    got = np.concatenate(got)
    ref_rows = _select_at(src, caps, d, src.clock, len(got))
    check(np.array_equal(got, ref_rows),
          f"process takeover: director {d}'s stream differs")
    check(not fe.db.active_query_ts, "process: pin-of-record left")
    fe.pump()
    survivor = fe._alive()[0]
    hb = fe._rpc(survivor, {"op": "heartbeat", "pins": fe._pins()})
    check(hb["gc_ts"] >= read_ts, f"process: gc_ts {hb['gc_ts']} held "
          f"below the released pin {read_ts}")
    w3 = _fleet_write(fe, [CreateVertex(
        "film", load._new_key("film"),
        {"gross": 2.0, "year": 2031, "genre": 0})], sleep_s=0.001)
    check(w3["status"] == "COMMITTED",
          f"process write after the failover {w3}")
    check(_worker_count(fe, survivor, sure[0]) == want(sure[0]),
          "process: a survivor's read after the failover")
    st = fe.cluster_stats()
    return dict(counts_checked=counts, replication=rep, takeover=dict(
        owner=owner, rows=len(got), takeovers=fe.stats["takeovers"],
        gc_ts=hb["gc_ts"], read_ts=read_ts),
        failovers=fe.stats["failovers"], epoch=st["membership"]["epoch"],
        durable_epoch=fe.rlog.os.get_meta("g.epoch", 0))


def phase_fleet_nearest(db, dev, sizes, launches, caps, info):
    """Phase 6e (e), right after phase 7 on its doc store: JAX's
    acceptance traffic (tests/test_cluster.py:130-177) through a
    4-coordinator inproc fleet: scans and a ``Nearest`` k=4 equal to
    ``backend="ref"`` (every dispatch held to it too), then one doc
    created at the probe vector, the k=1 answer of several coordinators
    at once.  Its launches join the ``fleet`` path.  Prints the FLEET
    line with (a)-(e)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.core.query import planner
    from repro_torch.core.query.executor import QueryCaps
    from repro_torch.core.writes import CreateVertex
    from repro_torch.kernels import _cuda
    from repro_torch.launch import cluster, serve
    t_phase = time.perf_counter()
    qcaps = QueryCaps(**caps)
    d = sizes["d"]
    rng = np.random.default_rng(17)
    clock = _CheckClock()
    saved = (serve.time, planner.time, cluster.time)
    serve.time = planner.time = cluster.time = clock
    _cuda.reset_launches()
    fe = None
    try:
        fe = cluster.A1Frontend(db, 4, device=dev, name="fleet_e",
                                caps=qcaps, read_batch=2, write_batch=1)
        chks = [_RefCheck(w.coord.server, clock)
                for w in fe.workers.values()]
        vec = rng.standard_normal(d).astype(np.float32)

        def scan(k):
            return {"type": "doc", "id": k,
                    "_out_edge": {"type": "doc.tag",
                                  "_target": {"type": "tag",
                                              "select": "count"}}}

        def near(k):
            return {"nearest": {"type": "doc",
                                "vector": [float(x) for x in vec], "k": k},
                    "select": ["key"]}
        keys = [1, 2, 4]
        pubs = [fe.submit_query(scan(k), budget_ms=1e6) for k in keys]
        npub = fe.submit_query(near(4), budget_ms=1e6)
        fe.flush()
        for k, p in zip(keys, pubs):
            r = _fleet_result(fe, p)
            solo = fe.db.query([scan(k)], caps=qcaps, backend="ref")
            check(r["status"] == "OK" and r["count"] == int(solo.counts[0]),
                  f"fleet scan of doc {k}: {r}")
        r = _fleet_result(fe, npub)
        solo = fe.db.query([near(4)], caps=qcaps, backend="ref")
        want4 = sorted(int(x) for x in solo.rows_gid[0] if x >= 0)
        check(r["status"] == "OK" and sorted(r["rows"]) == want4,
              f"fleet Nearest k=4: {r}")
        key = sizes["n_docs"] + 1_000
        attrs = {f"f{i}": float(vec[i]) for i in range(d)}
        w = _fleet_write(fe, [CreateVertex("doc", key,
                                           {**attrs, "x": key, "y": 0})])
        check(w["status"] == "COMMITTED", f"fleet doc write {w}")
        gid = w["gids"][0]
        at_once = [fe.submit_query(near(1), budget_ms=1e6) for _ in range(4)]
        fe.flush()
        cids = sorted({int(p.split(":")[0]) for p in at_once})
        for p in at_once:
            r = _fleet_result(fe, p)
            check(r["status"] == "OK" and r["rows"] == [gid],
                  f"fleet Nearest k=1 after the write: {r}")
        check(len(cids) >= 2, f"fleet: k=1 answered by {cids} only")
        st = fe.cluster_stats()
        check(st["membership"]["epoch"] == 1
              and st["replication"]["max_lag"] == 0, "fleet (e): stats")
        info["e"] = dict(scans=len(keys), nearest_k4=len(want4),
                         k1_coordinators=cids, new_gid=gid,
                         checked_dispatches=sum(c.checked for c in chks),
                         seconds=time.perf_counter() - t_phase)
        for k, v in _cuda.LAUNCHES.items():
            launches.setdefault("fleet", {}).setdefault(k, 0)
            launches["fleet"][k] += v
        info["check_seconds"] += clock.paused
    finally:
        serve.time, planner.time, cluster.time = saved
        if fe is not None:
            fe.close()
        del fe
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    say("FLEET", cell="fleet/mixed", inproc=info["a"], paging=info["b"],
        failover=info["c"], process=info["d"], nearest=info["e"],
        launches=launches["fleet"],
        process_launches="uncounted (each worker process counts its own)",
        check_seconds=info["check_seconds"],
        phase_seconds=info["phase_seconds"] + info["e"]["seconds"],
        reduced="n_shards 256 -> 1")


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
    ``backend="ref"`` on the same card.  Returns the doc store (phase 6e
    (e) serves it through a fleet)."""
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
    return db


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


def _profile(cell, fn, p50_s, warm=False, **extra):
    """Device busy time and kernel launches of one call of ``fn``
    (profiler): the share of it in the port's own kernels, and the busy
    time against the profiled call's wall time and the unprofiled p50
    latency.  The whole table goes to ``profile_<cell>.txt`` in the output
    directory.  Returns {kernel name: launches} of the device events.
    With ``warm`` a first call of ``fn`` runs as the profiler's warm-up
    step (tracing on, its events dropped): late in a run a profile has
    lost the first ~50 kernels of its call (one layer of a prefill)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 if warm else None) as prof:
        if warm:
            fn()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        if warm:
            prof.step()
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


PROFILE_TRIES = 5   # profiles of one call _check_tc_route may take


def _check_tc_route(cell, profiled, launched: dict):
    """The profiled call of a bf16 LM cell ran each flash wrapper's
    tensor-core kernel once a wrapper launch (``launched``: {wrapper:
    launches a call, as ``_lm_launch_check`` holds them}) and never its
    CUDA-core kernel.  ``profiled()`` profiles one call (``_profile``)
    and returns its counts (a warm profile, see ``_profile``).  The
    profiler has lost the first ~50 kernels of a call late in a full run
    on the H100 (23 of 24 tensor-core kernels, none of them the CUDA-core
    kernel); a profile that shows fewer tensor-core kernels than launches
    and no CUDA-core kernel is taken again, up to PROFILE_TRIES in all.  A
    CUDA-core kernel fails at once."""
    import re
    short = []
    for _ in range(PROFILE_TRIES):
        counts = profiled()
        got = {}
        for name in launched:
            got[name] = {k: sum(c for key, c in counts.items()
                                if re.search(rf"\b{k}\b", key))
                         for k in TC_ROUTE[name]}
        for name, n in launched.items():
            tc, cores = TC_ROUTE[name]
            check(got[name][cores] == 0 and got[name][tc] <= n,
                  f"{cell}: {name} launched {n} times, the profile shows "
                  f"{got[name][tc]} {tc} and {got[name][cores]} {cores}")
        if all(got[name][TC_ROUTE[name][0]] == n
               for name, n in launched.items()):
            break
        short.append({name: got[name][TC_ROUTE[name][0]]
                      for name in launched})
    else:
        check(False, f"{cell}: {PROFILE_TRIES} profiles each showed fewer "
              f"tensor-core kernels than the {launched} launched: {short}")
    say("ROUTE", cell=cell, tensor_core_launches=launched,
        profiles_short_of_events=short)


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
    if cfg.dtype == torch.float32:      # in place: no second f32 table
        p["embed"].normal_(generator=gen)
    else:
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
    """max |a - b| / max |b|, or max |a - b| where b is all zeros (a
    gradient leaf the loss does not reach); NaN if either has a non-finite
    value."""
    import torch
    if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
        return float("nan")
    scale = float(b.abs().max()) if b.numel() else 0.0
    return float((a - b).abs().max()) / (scale if scale > 0 else 1.0)


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
        _check_tc_route("lm/prefill_32k", lambda: _profile(
            "lm_prefill_32k", lambda: T.prefill(p, cfg, toks), p50,
            warm=True), {"flash_fwd": cfg.n_layers})
    _dryrun_check(dev, "lm/prefill_32k",
                  lambda p_, t_: T.prefill(p_, cfg, t_), (p, toks))


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
    phase_lm_dist(dev, cfg, p, sizes, launches)
    phase_lm_decode(dev, cfg, p, sizes, launches)
    del p
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    say("LM_PHASE", seconds=time.perf_counter() - t0, config=cfg.name,
        source="src/repro/configs/h2o_danube_3_4b.py")


# ---------------------------------------------------------------------------
# phase 9e, the dist substrate and the dry run's counts: the ring matmul in
# danube's prefill, danube's blocks as a 4-stage pipeline, and the op counts
# of three timed steps against the profiler (_dryrun_check, called by the
# phases that time them: 9, 9b and 9c)
# ---------------------------------------------------------------------------

class _Permutes:
    """An op counter (kernels/_cuda.py::COUNTERS) that counts the lockstep
    ppermutes: each is one hop of the ring."""

    def __init__(self):
        self.hops = 0

    def kernel(self, name, flops, nbytes, dtype):
        pass

    def collective(self, kind, nbytes, group):
        self.hops += kind == "collective-permute"


def _timed_pair(dev, fns: dict, calls: int) -> dict:
    """p50 seconds of each of two functions, called in turns (a, b, b,
    a, ...) after one warm call each."""
    import numpy as np
    secs = {k: [] for k in fns}
    for f in fns.values():
        f()
    _sync(dev)
    order = list(fns)
    for i in range(calls):
        for k in (order if i % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            fns[k]()
            _sync(dev)
            secs[k].append(time.perf_counter() - t0)
    return {k: float(np.median(v)) for k, v in secs.items()}


def phase_lm_dist(dev, cfg, p, sizes, launches):
    """Phase 9e (a) and (b), on phase 9's bf16 weights.  (a) danube's
    prefill of 1 x ``dist_seq`` tokens with ``use_collective_matmul`` under
    ``{"seq": "model"}`` on a (1, 4) mesh (its q/k/v and w1/w3 products run
    the ppermute ring of dist/overlap.py) against the plain prefill.  (b)
    ``pipeline_apply`` over a ("pod", "model") (4, 1) mesh, stage s one
    danube block with layer s's weights, ``dist_micro`` microbatches of 1 x
    ``dist_seq``, against the four blocks in sequence.  The references
    (the plain prefill, the blocks in sequence) run first; the launch
    counts are set to 0 just before the one checked ring prefill and read
    just after, as the ``lm_dist_ring`` path, and likewise around the one
    checked pipeline run, as ``lm_dist_pipeline``; each must be exact.
    The timed pairs come after, uncounted."""
    import dataclasses
    import torch
    from repro_torch.core.backend import resolve
    from repro_torch.core.precision import f32_accumulation
    from repro_torch.dist import mesh as mesh_mod
    from repro_torch.dist.pipeline import pipeline_apply
    from repro_torch.dist.sharding import rules_context
    from repro_torch.kernels import _cuda
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    S, M, calls = sizes["dist_seq"], sizes["dist_micro"], sizes["dist_calls"]
    L = cfg.n_layers

    # (a) the ring matmul
    toks = _lm_tokens(cfg, dev, 1, S, 31)
    cfg_cm = dataclasses.replace(cfg, use_collective_matmul=True)
    mesh = make_test_mesh((1, 4), device=dev)
    hops = _Permutes()

    def ring():
        with mesh, rules_context({"seq": "model"}):
            return T.prefill(p, cfg_cm, toks)[0]
    lp = T.prefill(p, cfg, toks)[0]
    _sync(dev)
    _cuda.reset_launches()
    _cuda.COUNTERS.append(hops)
    try:
        lr = ring()
    finally:
        _cuda.COUNTERS.pop()
    _sync(dev)
    launches["lm_dist_ring"] = dict(_cuda.LAUNCHES)
    # one prefill: two norms a layer and the final one, one attention a
    # layer
    _lm_launch_check(launches, "lm_dist_ring", {
        "rmsnorm_fwd": 2 * L + 1, "flash_fwd": L}, 1, dev)
    err = _rel_err(lr, lp)
    # q, k, v, w1 and w3 a layer, each three hops of a ring of four
    check(hops.hops == 5 * 3 * L,
          f"lm/dist_ring: {hops.hops} ppermute hops")
    check(lr.shape == lp.shape and err <= LM_BF16_TOL,
          f"lm/dist_ring: ring vs plain prefill {err}")
    p50 = _timed_pair(dev, {"plain": lambda: T.prefill(p, cfg, toks),
                            "ring": ring}, calls)
    say("LM_DIST_RING", cell="lm/prefill_4k_ring", mesh=[1, 4],
        rules={"seq": "model"}, seq=S, layers=L,
        ppermute_hops=hops.hops, rel_err_vs_plain=err,
        launches={k: launches["lm_dist_ring"][k] for k in ("rmsnorm_fwd",
                                                           "flash_fwd")},
        tolerance=LM_BF16_TOL, plain_p50_ms=p50["plain"] * 1e3,
        ring_p50_ms=p50["ring"] * 1e3, ring_over_plain=p50["ring"]
        / p50["plain"])

    # (b) the pipeline of four blocks
    be = resolve(None)
    pmesh = make_test_mesh((4, 1), ("pod", "model"), device=dev)
    layer = {n: t.unbind(0) for n, t in p["blocks"][0].items()}
    stage_params = [{n: ts[s % L] for n, ts in layer.items()}
                    for s in mesh_mod.axis_index(pmesh, "pod")]
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None]

    def block(bp, h):
        return T._block(bp, cfg, "dense", h, pos, be)[0]
    mtoks = _lm_tokens(cfg, dev, M, S, 32)
    x = p["embed"][mtoks.long()].to(cfg.dtype)[:, None]    # (M, 1, S, D)

    @torch.no_grad()
    @f32_accumulation()
    def pipe():
        return pipeline_apply(block, stage_params, x, mesh=pmesh,
                              axis="pod", n_stages=4, n_microbatches=M)

    @torch.no_grad()
    @f32_accumulation()
    def sequence():
        out = []
        for m in range(M):
            h = x[m]
            for bp in stage_params:
                h = block(bp, h)
            out.append(h)
        return torch.stack(out)
    want = sequence()
    _sync(dev)
    _cuda.reset_launches()
    outs = pipe()
    _sync(dev)
    launches["lm_dist_pipeline"] = dict(_cuda.LAUNCHES)
    # every stage runs its block at each of the M + 3 ticks: two norms and
    # one attention a block
    _lm_launch_check(launches, "lm_dist_pipeline", {
        "rmsnorm_fwd": 2 * 4, "flash_fwd": 4}, M + 3, dev)
    last = outs[3]
    perr = _rel_err(last, want)
    check(perr <= LM_BF16_TOL and not any(bool(o.any()) for o in outs[:3]),
          f"lm/dist_pipeline: pipeline vs blocks in sequence {perr}")
    del outs, last
    p50p = _timed_pair(dev, {"sequence": sequence, "pipeline": pipe}, calls)
    say("LM_DIST_PIPELINE", cell="lm/pipeline_4x", mesh=[4, 1],
        stages=4, microbatches=M, seq=S, ticks=M + 4 - 1,
        block_calls=4 * (M + 3), rel_err_vs_sequence=perr,
        tolerance=LM_BF16_TOL, sequence_p50_ms=p50p["sequence"] * 1e3,
        pipeline_p50_ms=p50p["pipeline"] * 1e3,
        pipeline_over_sequence=p50p["pipeline"] / p50p["sequence"],
        launches={k: launches["lm_dist_pipeline"][k]
                  for k in ("rmsnorm_fwd", "flash_fwd")})
    del x, want
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    say("LM_DIST_PHASE", seconds=time.perf_counter() - t_phase)


def _dryrun_check(dev, cell, fn, args):
    """Phase 9e (c): ``analyze_ops`` of ``fn(*args)`` on meta copies of
    ``args``, and one call of ``fn(*args)`` under a fresh profiler
    (``with_flops``, the CPU side's aten ops); the matmul flops must agree
    within DRYRUN_FLOP_TOL on the card.  Prints DRYRUN_CHECK with the
    predicted peak bytes beside ``max_memory_allocated``.  The call is one
    more step of the cell."""
    import torch
    from repro_torch.core.tree import map_leaves
    from repro_torch.launch.hloanalysis import analyze_ops
    t0 = time.perf_counter()
    a, _ = analyze_ops(fn, *map_leaves(lambda t: t.to("meta"), args))
    trace_s = time.perf_counter() - t0
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True, with_flops=True) as prof:
        fn(*args)
        _sync(dev)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    measured = sum(e.flops for e in prof.key_averages()
                   if e.key in DRYRUN_MATMULS)
    err = abs(measured - a.matmul_flops) / max(a.matmul_flops, 1.0)
    if dev.type == "cuda":    # on the CPU the kernels' plain versions
        check(err <= DRYRUN_FLOP_TOL,   # add matmuls of their own
              f"{cell}: dry-run matmul flops {a.matmul_flops} vs the "
              f"profiler's {measured}")
    say("DRYRUN_CHECK", cell=cell, predicted_matmul_flops=a.matmul_flops,
        profiler_matmul_flops=measured, rel_err=err,
        tolerance=DRYRUN_FLOP_TOL, kernel_flops=a.kernel_flops,
        kernel_calls=a.kernel_calls, predicted_peak_bytes=a.peak_bytes,
        max_memory_allocated=peak,
        peak_ratio=None if not peak else a.peak_bytes / peak,
        host_reads=a.host_reads, n_ops=a.n_ops, trace_s=trace_s)


# ---------------------------------------------------------------------------
# phase 9d, the LM zoo: qwen3-moe-235b, llama4-maverick, qwen1.5-32b and
# llama3-405b at full width, the depth cut
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _zoo_moe_drops():
    """A context whose value is a list that gets the ``drop_frac`` (a
    tensor: no sync) of every ``moe_ffn`` call a transformer block makes
    inside it."""
    from repro_torch.models import transformer as T
    drops, orig = [], T.moe_ffn

    def counted(*a, **kw):
        y, aux = orig(*a, **kw)
        drops.append(aux["drop_frac"])
        return y, aux
    T.moe_ffn = counted
    try:
        yield drops
    finally:
        T.moe_ffn = orig


@contextlib.contextmanager
def _zoo_routing(replay=None):
    """Routing held equal between two runs of one model.  Without
    ``replay``, a context whose value, ``(log, flips)``, gets the experts
    (``eidx``) of every ``moe._route`` call inside it.  With ``replay`` (a
    log), every call takes the logged experts in turn, with its own
    probabilities and the gates they give, and ``flips`` counts [tokens
    whose own top-k set differed, tokens] over the calls.  Top-k is a step
    function: where a token's k-th and (k+1)-th probabilities lie within
    a rounding of each other, the kernel and ref paths may pick either
    (both right), and the token's output moves by the gate of the expert
    swapped; holding the routing equal leaves what the two paths compute
    differently, the kernels' arithmetic."""
    import torch
    from repro_torch.models import moe
    orig, log, flips = moe._route, [], [0, 0]

    def route(xf, router_w, top_k):
        probs, gate, eidx = orig(xf, router_w, top_k)
        if replay is None:
            log.append(eidx)
            return probs, gate, eidx
        want = replay[len(log)]
        log.append(want)
        flips[0] += int((torch.sort(want, -1).values !=
                         torch.sort(eidx, -1).values).any(-1).sum())
        flips[1] += want[..., 0].numel()
        gate = torch.gather(probs, -1, want)
        return probs, gate / gate.sum(-1, keepdim=True).clamp(min=1e-9), want
    moe._route = route
    try:
        yield log, flips
    finally:
        moe._route = orig


def _drop_stats(drops) -> dict:
    v = [float(d) for d in drops]
    return dict(mean=sum(v) / len(v), max=max(v), calls=len(v)) if v \
        else None


def _zoo_cut(spec, layers: int, reduced: bool):
    """The arch's FULL config cut to ``layers`` (REDUCED under the
    rehearsal, cut alike), with the cut listed."""
    import dataclasses
    cfg = spec.reduced if reduced else spec.model
    n = min(layers, cfg.n_layers)
    return dataclasses.replace(cfg, n_layers=n), \
        [f"n_layers {cfg.n_layers} -> {n}"] if n != cfg.n_layers else []


def _moe_reference(x, router, we1, we3, we2, top_k, cf, groups):
    """An independent MoE layer, float32: softmax routing, ``torch.topk``,
    and for each expert in turn each token's rank among the tokens of its
    group that picked the expert (a cumulative count), the first C kept,
    their gate times the expert's SwiGLU added to the output.  Returns (y,
    aux loss, drop fraction, the kept pairs as token * E + expert,
    sorted)."""
    import torch
    import torch.nn.functional as F
    T, D = x.shape
    E = router.shape[1]
    G = groups if groups and groups > 1 and T % groups == 0 else 1
    Tg = T // G
    C = max(-(-int(cf * Tg * top_k / E) // 8) * 8, 8)
    probs = torch.softmax(x @ router, dim=-1)
    gate, eidx = torch.topk(probs, top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    aux = E * torch.sum(probs.mean(0) *
                        F.one_hot(eidx[:, 0], E).float().mean(0))
    y = torch.zeros_like(x)
    kept = []
    for e in range(E):
        hit = eidx == e
        picked = hit.any(-1).view(G, Tg)
        rank = picked.int().cumsum(1) - 1
        tok = (picked & (rank < C)).view(-1).nonzero()[:, 0]
        w = (gate * hit).sum(-1)[tok]
        xt = x[tok]
        h = F.silu(xt @ we1[e]) * (xt @ we3[e])
        y.index_add_(0, tok, w[:, None] * (h @ we2[e]))
        kept.append(tok * E + e)
    kept = torch.sort(torch.cat(kept)).values
    drop = 1.0 - torch.tensor(float(kept.numel()), device=x.device) / \
        (T * top_k)
    return y, aux, drop, kept


def _moe_dispatch_check(dev, cfg, p, j, tokens: int, groups: int, seed):
    """``moe_ffn`` on one full-width MoE layer (pattern position ``j``,
    cycle 0 of ``p``, float32) over ``tokens`` random tokens against
    :func:`_moe_reference`: the kept pairs and the drop fraction equal,
    the aux loss within 1e-6, the output within LM_F32_TOL."""
    import torch
    from repro_torch.core.precision import f32_accumulation
    from repro_torch.models import moe
    b = {n: p["blocks"][j][n][0] for n in ("router", "we1", "we3", "we2")}
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((tokens, cfg.d_model), generator=gen, device=dev)
    k, cf = cfg.top_k, cfg.capacity_factor
    with f32_accumulation():
        y, aux = moe.moe_ffn(x, b["router"], b["we1"], b["we3"], b["we2"],
                             top_k=k, capacity_factor=cf, groups=groups)
        ry, raux, rdrop, rkept = _moe_reference(
            x, b["router"], b["we1"], b["we3"], b["we2"], k, cf, groups)
        G = groups if groups > 1 and tokens % groups == 0 else 1
        C = moe.expert_capacity(tokens // G, cfg.n_experts, k, cf)
        _, _, eidx = moe._route(x.view(G, tokens // G, -1), b["router"], k)
        _, e_s, t_s, _, keep = moe._dispatch(eidx, C)
        tok = t_s + torch.arange(G, device=dev)[:, None] * (tokens // G)
        kept = torch.sort((tok * cfg.n_experts + e_s)[keep]).values
    check(torch.equal(kept, rkept), f"moe {cfg.name} groups {groups}: the "
          f"kept pairs differ ({kept.numel()} vs {rkept.numel()})")
    check(torch.equal(aux["drop_frac"], rdrop),
          f"moe {cfg.name}: drop_frac {float(aux['drop_frac'])} vs "
          f"{float(rdrop)}")
    aux_err = abs(float(aux["aux_loss"]) - float(raux))
    err = _rel_err(y, ry)
    check(aux_err <= 1e-6 and err <= LM_F32_TOL,
          f"moe {cfg.name} groups {groups}: aux {aux_err}, output {err}")
    return dict(groups=groups, capacity=C, tokens=tokens,
                kept=int(kept.numel()), drop_frac=float(rdrop),
                aux_loss=float(raux), aux_abs_err=aux_err, rel_err=err)


def _zoo_f32_check(dev, spec, sizes):
    """``lm_zoo/<arch>/check_f32``: one cycle of the FULL config in
    float32 over ``check_seq`` positions, ``forward_hidden`` and
    ``prefill`` on the kernel path against ``backend="ref"``; then each
    MoE layer's dispatch against the per-expert reference, grouped and
    (for a grouped config) global."""
    import dataclasses
    import torch
    from repro_torch.models import attention
    from repro_torch.models import transformer as T
    cfg, _ = _zoo_cut(spec, len(spec.model.block_pattern),
                      sizes["reduced"])
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    S = sizes["check_seq"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    p = _lm_weights(cfg32, dev, 40)
    toks = _lm_tokens(cfg, dev, 1, S, 41)
    errs = {}
    # the ref attention a quarter of its query rows at a time (the same
    # arithmetic a row): llama4's float32 cycle holds 73.7 GB of weights
    rows, attention._ROWS = attention._ROWS, 1024
    try:
        with _zoo_moe_drops() as drops, _zoo_routing() as (route, _):
            hk, ak = T.forward_hidden(p, cfg32, toks, backend="kernel")
        with _zoo_routing(route) as (_, flips):
            hr, ar = T.forward_hidden(p, cfg32, toks, backend="ref")
        errs["hidden"] = _rel_err(hk, hr)
        errs["aux"] = abs(float(ak) - float(ar)) / max(abs(float(ar)),
                                                       1e-30)
        del hk, hr
        with _zoo_routing() as (route, _):
            lk, _ = T.prefill(p, cfg32, toks, backend="kernel")
        with _zoo_routing(route) as (_, flips_p):
            lr, _ = T.prefill(p, cfg32, toks, backend="ref")
    finally:
        attention._ROWS = rows
    errs["prefill_logits"] = _rel_err(lk, lr)
    check(lk.shape == (1, cfg.vocab) and
          max(errs.values()) <= LM_F32_TOL,
          f"{spec.arch_id} check_f32: kernel vs ref {errs}")
    moe_checks = []
    for j, kind in enumerate(cfg.block_pattern):
        if kind == "moe":
            for g in dict.fromkeys((cfg.moe_groups, 0)):
                moe_checks.append(_moe_dispatch_check(
                    dev, cfg32, p, j, S, g, 42 + g))
    say("LM_ZOO_CHECK", cell=f"lm_zoo/{spec.arch_id}/check_f32",
        config=cfg.name, layers=cfg.n_layers, seq=S, dtype="float32",
        rel_err=errs, tolerance=LM_F32_TOL, drop_frac=_drop_stats(drops),
        routing_flips=dict(forward=flips, prefill=flips_p),
        moe_dispatch=moe_checks, peak_bytes=torch.cuda.max_memory_allocated()
        if dev.type == "cuda" else None)
    del p, lk, lr
    _free(dev)


def _zoo_moe_grad_check(dev, spec):
    """``lm_zoo/<arch>/grad_bf16``: one MoE layer of the REDUCED config's
    widths in bf16 over 256 tokens, the gradients of ``sum(y * ct) +
    aux_loss`` (x, the router and the experts) on the card against the
    CPU on the same inputs: the card's expert products go through
    ``moe._BmmF32`` (bf16 operands, a float32 product, its own backward),
    the CPU's through float32 casts.  (With top-1 the gate is p / p = 1,
    so y gives the router only rounding noise; the aux loss gives it its
    gradient, as in ``loss_fn``.)  The routing must agree (the drop fraction equal, the
    aux loss within 1e-6), the output within LM_BF16_TOL, each gradient's
    cosine at least TRAIN_MIN_COSINE."""
    import torch
    from repro_torch.models import moe
    cfg = spec.reduced
    D, E, F = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(51)
    shapes = {"x": (256, D), "router": (D, E), "we1": (E, D, F),
              "we3": (E, D, F), "we2": (E, F, D)}
    ins = {n: (torch.randn(sh, generator=gen) * (1.0 if n == "x" else
                                                 sh[-2] ** -0.5))
           .to(torch.bfloat16) for n, sh in shapes.items()}
    ct = torch.randn((256, D), generator=gen)
    out = {}
    for d in (cpu, dev):
        args = [ins[n].to(d).requires_grad_() for n in shapes]
        y, aux = moe.moe_ffn(*args, top_k=cfg.top_k, groups=cfg.moe_groups,
                             capacity_factor=cfg.capacity_factor)
        obj = (y.float() * ct.to(d)).sum() + aux["aux_loss"]
        grads = torch.autograd.grad(obj, args)
        out[d.type] = (y.detach().to(cpu),
                       {k: float(v.detach()) for k, v in aux.items()},
                       [g.to(cpu) for g in grads])
    (yc, ac, gc), (yd, ad, gd) = out["cpu"], out[dev.type]
    err = _rel_err(yd.float(), yc.float())
    cos = {n: _cosine(a, b) for n, a, b in zip(shapes, gd, gc)}
    check(ac["drop_frac"] == ad["drop_frac"] and
          abs(ac["aux_loss"] - ad["aux_loss"]) <= 1e-6 and
          err <= LM_BF16_TOL and min(cos.values()) >= TRAIN_MIN_COSINE,
          f"{spec.arch_id} grad_bf16: aux {ad} vs {ac}, output {err}, "
          f"cosines {cos}")
    say("LM_ZOO_CHECK", cell=f"lm_zoo/{spec.arch_id}/grad_bf16",
        dtype="bfloat16", tokens=256, d_model=D, experts=E, expert_d_ff=F,
        aux=ad, rel_err=err, cosine=cos, tolerance=dict(
            output=LM_BF16_TOL, min_cosine=TRAIN_MIN_COSINE))


def _zoo_decode_consistency(dev, spec, sizes):
    """``lm_zoo/<arch>/decode_consistency``: the FULL config cut to 2
    layers in float32, every decode step from an empty cache against
    ``forward`` at that position.  An MoE output depends on the batch
    through the capacity (JAX's semantics), so the capacity factor is
    doubled until ``forward`` drops no token; both runs' drop fractions
    are printed."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as T
    cfg, cut = _zoo_cut(spec, 2, sizes["reduced"])
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    B, n = sizes["consist"]
    p = _lm_weights(cfg32, dev, 43)
    toks = _lm_tokens(cfg, dev, B, n, 44)
    tried = []
    while True:
        with _zoo_moe_drops() as drops:
            full, _ = T.forward(p, cfg32, toks)
        tried.append((cfg32.capacity_factor, _drop_stats(drops)))
        if max(float(d) for d in drops) == 0.0:
            break
        cfg32 = dataclasses.replace(
            cfg32, capacity_factor=2 * cfg32.capacity_factor)
    cache = T.init_kv_cache(cfg32, B, n, device=dev)
    worst = 0.0
    with _zoo_moe_drops() as dec_drops:
        for t in range(n):
            lg, cache = T.decode_step(p, cfg32, toks[:, t:t + 1], cache, t)
            worst = max(worst, _rel_err(lg, full[:, t]))
    check(worst <= LM_F32_TOL,
          f"{spec.arch_id} decode_consistency: {worst}")
    say("LM_ZOO_CHECK", cell=f"lm_zoo/{spec.arch_id}/decode_consistency",
        config=cfg.name, reduced=cut, dtype="float32", batch=B, steps=n,
        rel_err=worst, tolerance=LM_F32_TOL,
        forward_capacity_factors=tried,
        decode_drop_frac=_drop_stats(dec_drops))
    del p, full, cache
    _free(dev)


def _free(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _zoo_kernel_rows(rec, cell):
    """The recorded flash_fwd and rmsnorm_fwd inputs of a cell's timed
    calls, timed now (ms, the bound and, for flash_fwd, SDPA's fastest
    fused setup on them) and kept for the kernel report's ``at_<cell>``;
    the inputs are let go."""
    import torch
    for name in ("flash_fwd", "rmsnorm_fwd"):
        _, args, kw = rec.extra.pop((name, "lm_zoo"))
        kern = rec.orig[name]

        def call():
            return kern(*args, **kw)
        bound_ms, bound_by = _bound(name, args, kw)
        row = dict(shapes=[tuple(a.shape) for a in _tensors(args)][:3],
                   dtype=str(args[0].dtype), ms=_events_ms(call, n=5),
                   device_ms=_device_ms(call, n=3), bound_ms=bound_ms,
                   bound_by=bound_by)
        lib = _sdpa_call(args, kw, rows=args[0].shape[1], n=3) \
            if name == "flash_fwd" else _library_call(name, args, kw)
        row.update(library=lib[0] if lib else None,
                   library_ms=lib[1] if lib else None)
        ZOO_AT.setdefault(name, {})[cell] = row
        del args, kw
    torch.cuda.empty_cache()


ZOO_AT = {}        # wrapper -> {cell: its timing at that cell's inputs}
ZOO_CELL = [None]  # the LM-zoo cell whose calls the recorder keeps


def _zoo_prefill(dev, spec, layers, sizes, launches, rec):
    """``lm_zoo/<arch>/prefill_32k``: the cell's 32,768 tokens in bf16,
    ``calls`` timed calls after a warm one (launches counted, peak bytes,
    the MoE layers' drop fractions), then against ``backend="ref"`` on the
    same prompt, a profiled call that must run only the tensor-core
    ``flash_fwd``."""
    import numpy as np
    import torch
    from repro_torch.kernels import _cuda
    from repro_torch.models import transformer as T
    cfg, cut = _zoo_cut(spec, layers, sizes["reduced"])
    geo = spec.cell("prefill_32k").geometry
    B, S = 1, sizes.get("seq", geo["seq_len"])
    cell = f"lm_zoo/{spec.arch_id}/prefill_32k"
    t0 = time.perf_counter()
    p = _lm_weights(cfg, dev, 45)
    toks = _lm_tokens(cfg, dev, B, S, 46)
    _sync(dev)
    init_s = time.perf_counter() - t0
    T.prefill(p, cfg, toks)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    ZOO_CELL[0] = cell
    secs = []
    with _zoo_moe_drops() as drops:
        for _ in range(sizes["calls"]):
            t0 = time.perf_counter()
            lk, _ = T.prefill(p, cfg, toks)
            _sync(dev)
            secs.append(time.perf_counter() - t0)
    ZOO_CELL[0] = None
    launches[cell] = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    L = cfg.n_layers
    _lm_launch_check(launches, cell, {"rmsnorm_fwd": 2 * L + 1,
                                      "flash_fwd": L}, len(secs), dev)
    with _zoo_routing() as (route, _):
        lk, _ = T.prefill(p, cfg, toks)
    with _zoo_routing(route) as (_, flips):
        lr, _ = T.prefill(p, cfg, toks, backend="ref")
    err = _rel_err(lk, lr)
    check(lk.shape == (B, cfg.vocab) and err <= LM_BF16_TOL,
          f"{cell}: kernel vs ref {err}")
    swapped = _same_argmax(lk, lr, LM_BF16_TOL * float(lr.abs().max()),
                           cell)
    p50 = float(np.median(secs))
    attn = _attn_flops(cfg, B, S)
    # 2 flops a weight a token, less embed (a gather) and the head, which
    # only the last position goes through
    body = cfg.n_active_params() - 2 * cfg.vocab * cfg.d_model
    flops = 2.0 * (body * S + cfg.d_model * cfg.vocab) * B + attn
    say("LM_ZOO", cell=cell, config=cfg.name,
        source=LM_ZOO_FILES[spec.arch_id], dtype=str(cfg.dtype),
        batch=B, seq=S, layers=L,
        reduced=cut + [f"global_batch {geo['global_batch']} -> {B}"],
        p50_ms=p50 * 1e3, ms=[x * 1e3 for x in secs],
        tokens_per_s=B * S / p50, attn_flops=attn,
        attn_bf16_peak_share=attn / p50 / BF16_OPS_PER_S, flops=flops,
        bf16_peak_share=flops / p50 / BF16_OPS_PER_S, peak_bytes=peak,
        weight_bytes=sum(t.numel() * t.element_size()
                         for _, t in T.leaves(p)),
        init_s=init_s, drop_frac=_drop_stats(drops),
        launches_per_call={k: launches[cell][k] / len(secs)
                           for k in ("rmsnorm_fwd", "flash_fwd")},
        rel_err_vs_ref=err, tolerance=LM_BF16_TOL, routing_flips=flips,
        argmax_ties_swapped=swapped)
    del lk, lr
    if dev.type == "cuda":
        _check_tc_route(cell, lambda: _profile(
            cell.replace("/", "_"), lambda: T.prefill(p, cfg, toks), p50,
            warm=True), {"flash_fwd": L})
        _zoo_kernel_rows(rec, cell)
    rec.extra.pop(("flash_fwd", "lm_zoo"), None)
    rec.extra.pop(("rmsnorm_fwd", "lm_zoo"), None)
    del p
    _free(dev)


def _zoo_decode(dev, spec, layers, sizes, launches):
    """``lm_zoo/<arch>/decode_32k``: the cell's batch of 128 (halved until
    the cache fits) over a 32,768-slot cache filled from a generator (as
    after 32k tokens), ``decode_steps`` greedy steps timed after a warm
    one (launches counted), then one step against ``backend="ref"``."""
    import numpy as np
    import torch
    from repro_torch.kernels import _cuda
    from repro_torch.models import transformer as T
    cfg, cut = _zoo_cut(spec, layers, sizes["reduced"])
    geo = spec.cell("decode_32k").geometry
    B = sizes.get("decode_batch", geo["global_batch"])
    S = sizes.get("seq", geo["seq_len"])
    cell = f"lm_zoo/{spec.arch_id}/decode_32k"
    p = _lm_weights(cfg, dev, 47)
    per_seq = 2 * cfg.n_layers * cfg.n_kv_heads * S * cfg.d_head * 2
    # the f32 copies of one layer's k and v in the decode attention
    temp = 2 * cfg.n_kv_heads * S * cfg.d_head * 4
    if dev.type == "cuda":
        free = torch.cuda.mem_get_info()[0] - (4 << 30)
        while B > 1 and B * (per_seq + temp) > free:
            B //= 2
    cache = T.init_kv_cache(cfg, B, S, device=dev)
    gen = torch.Generator(device=dev).manual_seed(48)
    for k, v in cache:
        k.normal_(generator=gen)
        v.normal_(generator=gen)
    steps = sizes["decode_steps"]
    pos = S - steps - 2
    tok = _lm_tokens(cfg, dev, B, 1, 49)
    lg, cache = T.decode_step(p, cfg, tok, cache, pos)
    tok = lg.argmax(-1, keepdim=True)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    secs = []
    with _zoo_moe_drops() as drops:
        for _ in range(steps):
            pos += 1
            t0 = time.perf_counter()
            lg, cache = T.decode_step(p, cfg, tok, cache, pos)
            tok = lg.argmax(-1, keepdim=True)
            _sync(dev)
            secs.append(time.perf_counter() - t0)
    launches[cell] = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    L = cfg.n_layers
    _lm_launch_check(launches, cell, {"rmsnorm_fwd": 2 * L + 1,
                                      "flash_fwd": 0}, steps, dev)
    pos += 1
    with _zoo_routing() as (route, _):
        lk, cache = T.decode_step(p, cfg, tok, cache, pos)
    with _zoo_routing(route) as (_, flips):
        lr, cache = T.decode_step(p, cfg, tok, cache, pos, backend="ref")
    err = _rel_err(lk, lr)
    check(lk.shape == (B, cfg.vocab) and err <= LM_BF16_TOL,
          f"{cell}: kernel vs ref {err}")
    swapped = _same_argmax(lk, lr, LM_BF16_TOL * float(lr.abs().max()),
                           cell)
    p50 = float(np.median(secs))
    attn = 4.0 * cfg.n_heads * cfg.d_head * (pos + 1) * B * L
    weight_bytes = sum(t.numel() * t.element_size() for _, t in T.leaves(p))
    bound_s = (B * per_seq + weight_bytes) / HBM_BYTES_PER_S
    reduced = cut + ([] if B == geo["global_batch"] else
                     [f"global_batch {geo['global_batch']} -> {B}"])
    say("LM_ZOO", cell=cell, config=cfg.name,
        source=LM_ZOO_FILES[spec.arch_id], dtype=str(cfg.dtype),
        batch=B, cache_slots=S, start_pos=S - steps - 2, steps=len(secs),
        layers=L, reduced=reduced, p50_ms=p50 * 1e3,
        ms=[x * 1e3 for x in secs], tokens_per_s=B / p50, attn_flops=attn,
        attn_bf16_peak_share=attn / p50 / BF16_OPS_PER_S, peak_bytes=peak,
        cache_bytes=B * per_seq, weight_bytes=weight_bytes,
        bytes_bound_ms=bound_s * 1e3, bytes_bound_share=bound_s / p50,
        drop_frac=_drop_stats(drops),
        launches_per_step={k: launches[cell][k] / steps
                           for k in ("rmsnorm_fwd", "flash_fwd")},
        rel_err_vs_ref=err, tolerance=LM_BF16_TOL, routing_flips=flips,
        argmax_ties_swapped=swapped)
    if dev.type == "cuda":
        _profile(cell.replace("/", "_"),
                 lambda: T.decode_step(p, cfg, tok, cache, pos + 1), p50)
    del p, cache, lk, lr
    _free(dev)


# phase 9d's cells: (arch, shape id, layers kept), in the order run; the
# first is the largest float32 check (llama4's one cycle: 73.5 GB of
# weights), run on the emptiest card
LM_ZOO_CELLS = (("llama4-maverick-400b-a17b", "prefill_32k", 2),
                ("qwen3-moe-235b-a22b", "prefill_32k", 4),
                ("qwen3-moe-235b-a22b", "decode_32k", 2),
                ("qwen1.5-32b", "prefill_32k", 8),
                ("llama3-405b", "prefill_32k", 2))
LM_ZOO_FILES = {
    "llama4-maverick-400b-a17b": "src/repro/configs/llama4_maverick_400b.py",
    "qwen3-moe-235b-a22b": "src/repro/configs/qwen3_moe_235b.py",
    "qwen1.5-32b": "src/repro/configs/qwen15_32b.py",
    "llama3-405b": "src/repro/configs/llama3_405b.py"}
LM_ZOO_FULL = dict(reduced=False, calls=8, decode_steps=16, check_seq=4096,
                   consist=(2, 64))
LM_ZOO_REHEARSE = dict(reduced=True, calls=2, decode_steps=3, check_seq=64,
                       consist=(2, 12), seq=96, decode_batch=4)


def phase_lm_zoo(dev, sizes, launches, rec):
    """Phase 9d: per arch, its float32 checks (kernel against ref, MoE
    dispatch against the per-expert reference, decode against forward for
    an arch with a decode cell), then its bf16 cells; each config's
    weights are freed before the next."""
    import torch
    from repro_torch.configs import registry
    t_phase = time.perf_counter()
    _free(dev)
    held = torch.cuda.memory_allocated() if dev.type == "cuda" else None
    rec.only = set()
    done = set()
    for arch, shape_id, layers in LM_ZOO_CELLS:
        spec = registry.get(arch)
        if arch not in done:
            done.add(arch)
            _zoo_f32_check(dev, spec, sizes)
            if "moe" in spec.model.block_pattern:
                _zoo_moe_grad_check(dev, spec)
            if any(a == arch and s == "decode_32k"
                   for a, s, _ in LM_ZOO_CELLS):
                _zoo_decode_consistency(dev, spec, sizes)
        if shape_id == "prefill_32k":
            _zoo_prefill(dev, spec, layers, sizes, launches, rec)
        else:
            _zoo_decode(dev, spec, layers, sizes, launches)
    say("LM_ZOO_PHASE", seconds=time.perf_counter() - t_phase,
        held_before=held, cells=[f"lm_zoo/{a}/{s}" for a, s, _ in
                                 LM_ZOO_CELLS])


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


def _ef_mesh_check(dev, grads, shards: int = 4) -> dict:
    """``ef_compress_grads(axis_name=)`` over ``shards`` shards of one
    gradient tree (``grads``: (name, leaf) pairs), a layer of each leaf at
    a time: shard s holds the gradient times 2 ** (s - 1) (exact in bf16)
    and an error of its own, so every shard has its own scale.  Each
    shard's dequantized gradient and new error must equal the formula
    computed here directly (JAX's: the int32 sum of the int8 payloads times
    the shard's own scale, over the shard count), bit for bit."""
    import torch
    from repro_torch.optim import compression as C
    gen = torch.Generator(device=dev).manual_seed(50)
    t0 = time.perf_counter()
    parts = elems = 0
    for name, leaf in grads:
        for part in _slices(leaf):
            amax = part.float().abs().amax()
            gs = [part * 2.0 ** (s - 1) for s in range(shards)]
            es = [torch.randn(part.shape, generator=gen, device=dev) * amax
                  * 1e-2 for _ in range(shards)]
            dq, err = C.ef_compress_grads([{"g": g} for g in gs],
                                          [{"g": e} for e in es],
                                          axis_name="data")
            gfs = [g.float() + e for g, e in zip(gs, es)]
            scales = [torch.clamp(gf.abs().amax(), min=1e-12) / 127.0
                      for gf in gfs]
            qs = [torch.clamp(torch.round(gf / sc), -127, 127)
                  .to(torch.int8) for gf, sc in zip(gfs, scales)]
            qsum = qs[0].int()
            for q in qs[1:]:
                qsum = qsum + q.int()
            for s in range(shards):
                want_dq = ((qsum.float() * scales[s]) / shards) \
                    .to(part.dtype)
                want_err = gfs[s] - qs[s].float() * scales[s]
                check(torch.equal(dq[s]["g"], want_dq)
                      and torch.equal(err[s]["g"], want_err),
                      f"ef_compress_grads(axis_name=) {name} shard {s}: "
                      f"not the formula")
            parts += 1
            elems += part.numel()
            del gs, es, dq, err, gfs, qs, qsum
    _sync(dev)
    return dict(shards=shards, leaves=len(grads), parts=parts,
                elements=elems, seconds=time.perf_counter() - t0)


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
    say("EF_MESH", cell="lm/train_4k", gradient="the first step's, kernel "
        "path", **_ef_mesh_check(dev, gk))
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
        _check_tc_route("lm/train_4k", lambda: _profile("lm_train_4k",
                                                        step, p50,
                                                        warm=True),
                        {"flash_fwd": 2 * L, "flash_bwd_dkv": L,
                         "flash_bwd_dq": L})
    _dryrun_check(dev, "lm/train_4k",
                  lambda *a: lm_train_step(*a, cfg, ocfg),
                  (p, state, tokens, targets))
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
    grad_tol = ZOO_GRAD_TOL_CELL.get(cell, ZOO_GRAD_TOL)
    check(loss_err <= ZOO_LOSS_TOL
          and all(e <= grad_tol for e in errs.values())
          and (out_err is None or out_err <= ZOO_LOSS_TOL),
          f"{cell}: card vs CPU loss {ld} vs {lc}, logits {out_err}, "
          f"gradients {errs}")
    say("ZOO_CHECK", cell=cell, config=cfg.name, loss_cpu=lc, loss_dev=ld,
        loss_rel_err=loss_err, logits_rel_err=out_err,
        grad_rel_err_max=max(errs.values()), grad_rel_err=errs,
        tolerance=dict(loss=ZOO_LOSS_TOL, grads=grad_tol),
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
              geometry=None, reduced=(), **line):
    """One GNN cell at the config's full widths, ``d_in`` the features of
    its graph (as ``steps.gnn_cell_config`` sets it; NequIP has none):
    ``batch_cpu``, whose first step on the card is checked against the
    CPU, or a synthetic graph of ``geometry`` (the cell's own by default)
    made on the card; then the timed AdamW steps (``line``: more ZOO_TRAIN
    fields).  Returns (params, batch)."""
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
    cfg = (dataclasses.replace(spec.model, d_in=dF)
           if hasattr(spec.model, "d_in") else spec.model)
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
               source=spec.source, edges_per_s=lambda p50: E / p50, **line)
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
    _dryrun_check(dev, "zoo/bst/train_batch",
                  lambda *a: steps.recsys_train_step(*a, cfg, ocfg),
                  (params, state, *batch))
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


def _ship_check(dev, table, hist, shards: int = 4):
    """``a1_ship_lookup`` over ``make_mesh(shards)`` on the card (the
    table's rows in ``shards`` contiguous blocks) with the BST train
    batch's histories as ids, each row's tail padded (row % 4 ids of -1):
    every shard's rows equal ``gspmd_lookup``'s bit for bit."""
    import torch
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.models.embedding import a1_ship_lookup, gspmd_lookup
    B, L = hist.shape
    pad = torch.arange(L, device=hist.device)[None] >= \
        L - (torch.arange(B, device=hist.device) % 4)[:, None]
    ids = torch.where(pad, -1, hist)
    mesh = make_mesh(shards, device=dev)
    with torch.no_grad():
        got = a1_ship_lookup(table, ids, mesh)
        want = gspmd_lookup(table, ids)
    for s, g in enumerate(got):
        check(g.shape == want.shape and torch.equal(g, want),
              f"a1_ship_lookup shard {s}: not gspmd_lookup's rows")
    timing = {}
    if dev.type == "cuda":
        with torch.no_grad():
            timing = dict(
                ship_ms=_events_ms(lambda: a1_ship_lookup(table, ids, mesh),
                                   n=5),
                gspmd_ms=_events_ms(lambda: gspmd_lookup(table, ids), n=5))
    say("SHIP_LOOKUP", table=list(table.shape), ids=list(ids.shape),
        padding=int(pad.sum()), shards=shards, equal=True, **timing)


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


def _sample_geometry(cell, sizes) -> tuple:
    """(base nodes, base edges, features, seeds, fanouts) of a sampled
    cell: its own, or ``sizes["sample_base"]`` with ``gnn_geometry``'s
    reduced cut (8 seeds, fanouts (3, 2), 16 features)."""
    g = cell.geometry
    if sizes["sample_base"] is None:
        return (g["n_base_nodes"], g["n_base_edges"], g["d_feat"],
                g["batch_nodes"], tuple(g["fanout"]))
    return (*sizes["sample_base"], 16, 8, (3, 2))


def _reddit_base(dev, n: int, e: int, d: int, seed: int):
    """The minibatch_lg cell's base graph made on the device by
    ``data/graphs.py::reddit_like``'s law (``synthetic_graph_batch``: e/2
    sources by Zipf weights 1/k^0.8 and uniform destinations, both
    directions; N(0, 1) features; 41 uniform labels) from a
    ``torch.Generator`` (other numbers), and N(0, 1) positions a node
    (MGN's edge inputs).  Returns (src, dst, features, labels,
    positions)."""
    import torch
    check(e % 2 == 0, f"an odd edge count {e}")
    g = torch.Generator(device=dev).manual_seed(seed)
    cdf = torch.cumsum(torch.arange(1, n + 1, dtype=torch.float64,
                                    device=dev).pow(-0.8), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(e // 2, generator=g, dtype=torch.float64, device=dev)
    src = torch.searchsorted(cdf, u, right=True).clamp_(max=n - 1).int()
    del u, cdf
    dst = torch.randint(0, n, (e // 2,), generator=g, device=dev,
                        dtype=torch.int32)
    src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    feat = torch.randn((n, d), generator=g, device=dev)
    labels = torch.randint(0, 41, (n,), generator=g, device=dev,
                           dtype=torch.int32)
    pos = torch.randn((n, 3), generator=g, device=dev)
    return src, dst, feat, labels, pos


def _check_sample(base, sample, fanouts, what) -> None:
    """One fanout sample (seeds, its GraphBatch, its gids) against its base
    graph: on a host copy, the slot layout exactly (seeds first; hop k's
    edge i from slot base_next + i to its parent's slot), and a slot -1
    exactly where its parent is -1 or has no neighbours; on the device,
    every sampled (parent, child) a (src, dst) edge of the base graph
    (``base["keys"]``: src * n + dst sorted), so the child lies in its
    parent's CSR span (the CSR's own keys equal these: ``_sampler_base``),
    and the features, labels and mask gathered by gid."""
    import numpy as np
    import torch
    seeds, batch, gids = sample
    es, ed = batch.edge_src, batch.edge_dst
    g, sh, dh = (t.cpu().numpy() for t in (gids, es, ed))
    B = seeds.shape[0]
    check(np.array_equal(g[:B], seeds.cpu().numpy()), f"{what}: seeds")
    deg = np.diff(base["indptr_h"])
    prev, nxt, nk, eo = 0, B, B, 0
    for f in fanouts:
        parents = g[prev:prev + nk]
        has = (parents >= 0) & (deg[np.maximum(parents, 0)] > 0)
        kids = g[nxt:nxt + nk * f].reshape(nk, f)
        check(bool(((kids >= 0) == has[:, None]).all()),
              f"{what}: a slot is -1 where its parent has neighbours, or "
              f"the reverse")
        want_s = np.where(np.repeat(has, f), nxt + np.arange(nk * f), -1)
        want_d = prev + np.repeat(np.arange(nk), f)
        check(np.array_equal(sh[eo:eo + nk * f], want_s)
              and np.array_equal(dh[eo:eo + nk * f], want_d),
              f"{what}: the hop's slot layout")
        eo, prev, nxt, nk = eo + nk * f, nxt, nxt + nk * f, nk * f
    check(eo == sh.shape[0] and nxt == g.shape[0], f"{what}: slot counts")
    v = es >= 0
    q = gids[ed[v].long()].long() * base["n"] + gids[es[v].long()].long()
    keys = base["keys"]
    pos = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
    check(bool((keys[pos] == q).all()),
          f"{what}: a sampled child is not its parent's neighbour")
    ok = gids >= 0
    rows = torch.where(ok, gids, 0).long()
    check(torch.equal(batch.node_feat, base["feat"][rows] * ok[:, None])
          and torch.equal(batch.labels[:B], base["labels"][seeds.long()])
          and bool((batch.labels[B:] == -1).all())
          and int(batch.train_mask.sum()) == B
          and bool(batch.train_mask[:B].all()),
          f"{what}: features, labels or mask not gathered by gid")


def _sampler_base(dev, sizes):
    """The minibatch_lg base graph on the card (``_reddit_base``), its CSR
    by ``csr_from_coo`` (timed) checked against the edges, and
    ``sample(seed)``: ``batch_nodes`` seeds drawn from a generator of that
    seed, then ``build_sampled_batch`` at the cell's fanouts from the same
    generator, and its gids by ``fanout_sample`` from a copy of the
    generator's state (the same draws, so the same edges, checked).  Takes
    ``sample_calls`` timed samples after a first one, each checked
    (``_check_sample``), and prints SAMPLER.  Returns (sample, base)."""
    import numpy as np
    import torch
    from repro_torch.configs import graphsage_reddit
    from repro_torch.data.sampler import (build_sampled_batch, csr_from_coo,
                                          fanout_sample)
    n, e, d, B, fanouts = _sample_geometry(
        graphsage_reddit.SPEC.cell("minibatch_lg"), sizes)
    t0 = time.perf_counter()
    src, dst, feat, labels, pos = _reddit_base(dev, n, e, d, seed=36)
    keys = torch.sort(src.long() * n + dst.long()).values
    _sync(dev)
    base_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    indptr, indices = csr_from_coo(n, src, dst)
    _sync(dev)
    csr_s = time.perf_counter() - t0
    del src, dst
    rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                   torch.diff(indptr.long()))
    check(int(indptr[-1]) == e and indices.shape[0] == e
          and torch.equal(torch.sort(rows * n + indices.long()).values,
                          keys), "csr_from_coo: the CSR is not the edges")
    del rows
    base = dict(n=n, keys=keys, feat=feat, labels=labels, pos=pos,
                indptr_h=indptr.cpu().numpy())

    def sample(seed, timed=None):
        gen = torch.Generator(device=dev).manual_seed(seed)
        seeds = torch.randperm(n, generator=gen, device=dev)[:B].int()
        state = gen.get_state()
        _sync(dev)
        t0 = time.perf_counter()
        batch = build_sampled_batch(feat, labels, indptr, indices, seeds,
                                    gen, fanouts=fanouts)
        _sync(dev)
        if timed is not None:
            timed.append(time.perf_counter() - t0)
        gen.set_state(state)
        gids, es, ed = fanout_sample(indptr, indices, seeds, gen,
                                     fanouts=fanouts)
        check(torch.equal(es, batch.edge_src)
              and torch.equal(ed, batch.edge_dst),
              f"sample {seed}: fanout_sample's edges differ from the batch's")
        _check_sample(base, (seeds, batch, gids), fanouts, f"sample {seed}")
        return seeds, batch, gids

    secs, valid = [], []
    for i in range(1 + sizes["sample_calls"]):
        _, batch, _ = sample(100 + i, secs if i else None)
        valid.append(int((batch.edge_src >= 0).sum()))
    say("SAMPLER", cell="zoo/graphsage-reddit/minibatch_lg", nodes=n,
        edges=e, d_feat=d, seeds=B, fanouts=list(fanouts),
        node_slots=int(batch.node_feat.shape[0]),
        edge_slots=int(batch.edge_src.shape[0]), valid_edge_slots=valid,
        base_build_s=base_s, csr_build_s=csr_s,
        sample_p50_ms=float(np.median(secs)) * 1e3,
        sample_ms=[x * 1e3 for x in secs], samples_checked=len(valid))
    return sample, base


def _sampled_cells(dev, sizes):
    """graphsage-reddit and meshgraphnet at ``minibatch_lg`` on fanout
    samples of the base graph (``_sampler_base``), each first step checked
    against the CPU on its batch copied there, then timed.  MGN's sample
    is a fresh one, with positions gathered by gid (0 at a -1 slot) and
    (N, 3) N(0, 1) targets."""
    import dataclasses
    import torch
    from repro_torch.configs import graphsage_reddit, meshgraphnet
    sample, base = _sampler_base(dev, sizes)
    _, batch, _ = sample(41)
    _gnn_cell(dev, graphsage_reddit, "minibatch_lg", sizes, 32,
              batch_cpu=batch.to("cpu"))
    del batch
    _, batch, gids = sample(42)
    ok = gids >= 0
    gen = torch.Generator(device=dev).manual_seed(43)
    batch = dataclasses.replace(
        batch, positions=base["pos"][torch.where(ok, gids, 0).long()]
        * ok[:, None],
        labels=torch.randn((gids.shape[0], 3), generator=gen, device=dev))
    del base, sample
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _gnn_cell(dev, meshgraphnet, "minibatch_lg", sizes, 34,
              batch_cpu=batch.to("cpu"))


def _rotation(seed: int):
    """A seeded proper rotation (3, 3) float32 numpy array, as
    ``tests/test_models.py::test_nequip_invariance_and_force_equivariance``
    draws it."""
    import numpy as np
    Q, R = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    Q *= np.sign(np.diag(R))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q.astype(np.float32)


def _nequip_cell(dev, sizes):
    """nequip FULL at ``molecule`` (``molecule_batch`` of the cell's
    geometry): ZOO_CHECK and the timed steps (``_gnn_cell``), then with
    the trained params the forces on the card against the CPU, and on the
    card each molecule's energy invariant and the forces equivariant under
    a seeded rotation plus a translation, within the JAX test's
    tolerances (NEQUIP_TOL)."""
    import dataclasses
    import torch
    from repro_torch.configs import nequip as nequip_conf
    from repro_torch.core.tree import tree_map
    from repro_torch.data.graphs import molecule_batch
    from repro_torch.launch.steps import gnn_geometry
    from repro_torch.models.gnn import nequip
    g = nequip_conf.SPEC.cell("molecule").geometry
    bt = g["batch"] if not sizes["reduced_geometry"] else \
        gnn_geometry(nequip_conf.SPEC.cell("molecule"), True)[3]
    cfg = nequip_conf.FULL
    b_cpu = molecule_batch(bt, g["n_nodes"], g["n_edges"],
                           n_species=cfg.n_species, seed=35, device="cpu")
    params, batch = _gnn_cell(dev, nequip_conf, "molecule", sizes, 35,
                              batch_cpu=b_cpu,
                              molecules_per_s=lambda p50: bt / p50)
    t0 = time.perf_counter()
    f_dev = nequip.forces(params, cfg, batch)
    f_cpu = nequip.forces(tree_map(lambda t: t.cpu(), params), cfg, b_cpu)
    f_err = _rel_err(f_dev.cpu(), f_cpu)
    Qt = torch.from_numpy(_rotation(7).T.copy()).to(dev)
    moved = dataclasses.replace(batch, positions=batch.positions @ Qt
                                + torch.tensor([1.0, 2.0, 3.0], device=dev))
    with torch.no_grad():
        e0 = nequip.forward(params, cfg, batch)
        e1 = nequip.forward(params, cfg, moved)
    e_err = float(((e1 - e0).abs() / torch.clamp(e0.abs(), min=1.0)).max())
    rot_err = float((nequip.forces(params, cfg, moved) - f_dev @ Qt).abs()
                    .max())
    check(f_err <= ZOO_GRAD_TOL and e_err < NEQUIP_TOL["energy"]
          and rot_err < NEQUIP_TOL["forces"],
          f"zoo/nequip/molecule: forces card vs CPU {f_err}, rotated "
          f"energy {e_err}, rotated forces {rot_err}")
    say("NEQUIP_CHECK", cell="zoo/nequip/molecule", molecules=bt,
        atoms=int(batch.positions.shape[0]),
        self_loops=int((batch.edge_src == batch.edge_dst).sum()),
        forces_max=float(f_dev.abs().max()), forces_rel_err=f_err,
        energy_rot_err=e_err, forces_rot_err=rot_err,
        tolerance=dict(forces_card_vs_cpu=ZOO_GRAD_TOL,
                       rotated=NEQUIP_TOL),
        seconds=time.perf_counter() - t0)


def phase_sampler_db(kg, sizes):
    """``fanout_sample_db`` over phase 5's store (after 6e's writes):
    ``sampler_db_seeds`` directors with 15-1,024 films at load (under
    ``get_edges``' 4,096 cap, which the sampler keeps) at the
    minibatch_lg fanouts; the slot layout, and every sampled gid among its
    parent's ``get_edges`` neighbours.  Prints SAMPLER_DB."""
    import numpy as np
    from repro_torch.configs import graphsage_reddit
    from repro_torch.data.sampler import fanout_sample_db
    fanouts = tuple(graphsage_reddit.SPEC.cell("minibatch_lg")
                    .geometry["fanout"])
    e = kg.edges
    m = e["etype"] == kg.db.et("film.director").type_id
    cnt = np.bincount(e["src"][m], minlength=kg.n_directors)
    pick = np.flatnonzero((cnt >= 15) & (cnt <= 1024))
    n = sizes["sampler_db_seeds"]
    check(len(pick) >= n, "sampler_db: too few directors")
    seeds = np.random.default_rng(44).choice(pick, n, replace=False)
    secs = []
    for i in range(sizes["sampler_db_calls"]):
        t0 = time.perf_counter()
        gids, es, ed = fanout_sample_db(kg.db, seeds, fanouts=fanouts,
                                        seed=i)
        secs.append(time.perf_counter() - t0)
        check(gids.shape[0] == n * (1 + fanouts[0] + fanouts[0] * fanouts[1])
              and es.shape == ed.shape
              and es.shape[0] == gids.shape[0] - n
              and np.array_equal(gids[:n], seeds), "sampler_db: layout")
        nbrs = {}
        for s_, d_ in zip(es, ed):
            parent = int(gids[d_])
            if s_ < 0:
                check(parent < 0 or not nbrs.setdefault(
                    parent, {x for x, _ in kg.db.get_edges(parent)}),
                    "sampler_db: -1 under a parent with neighbours")
                continue
            if parent not in nbrs:
                nbrs[parent] = {x for x, _ in kg.db.get_edges(parent)}
            check(int(gids[s_]) in nbrs[parent],
                  f"sampler_db: {int(gids[s_])} is not a neighbour of "
                  f"{parent}")
    say("SAMPLER_DB", seeds=n, fanouts=list(fanouts),
        node_slots=int(gids.shape[0]), valid_edge_slots=int((es >= 0).sum()),
        parents_checked=len(nbrs), ms_per_call=[x * 1e3 for x in secs],
        p50_ms=float(np.median(secs)) * 1e3)


def phase_zoo(dev, sizes, launches, rec):
    """Phase 9c: gcn-cora, graphsage-reddit and bst at full width (see the
    docstring), then the zoo path's two kernels."""
    import torch
    from repro_torch.configs import gcn_cora
    from repro_torch.data.graphs import cora_like
    t_phase = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        check(held < 8 << 30, f"zoo: {held} bytes still held")
    cora = cora_like(sizes["cora_scale"], device="cpu")
    _gnn_cell(dev, gcn_cora, "full_graph_sm", sizes, 31, batch_cpu=cora)
    _sampled_cells(dev, sizes)
    _nequip_cell(dev, sizes)
    p, batch = _gnn_cell(dev, gcn_cora, "ogb_products", sizes, 33,
                         geometry=sizes["ogb"])
    ids, deg = _ell(batch, batch.node_feat.shape[0], sizes["ell_k"])
    ogb = (batch.node_feat, ids, p["w"][0].detach(),
           1.0 / torch.clamp(deg, min=1.0))
    del p, batch, deg
    table_params, hist = _bst_cells(dev, sizes)
    _zoo_kernels(dev, ogb, table_params["item_emb"], hist, launches, rec)
    _ship_check(dev, table_params["item_emb"], hist)
    del table_params
    _zoo_spmm_cross_check(dev, cora.to(dev))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    say("ZOO_PHASE", seconds=time.perf_counter() - t_phase)


def phase_small_reference(dev, launches):
    """A small store: the port's counts against plain set computations;
    the serving tier's mesh launches join ``launches["serving"]``."""
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
    n_write = _small_write_reference(dev, launches)
    say("SMALL_REFERENCE", queries=2 * len(want) + n_near + n_write,
        equal=True)


def _same_db(a, b, what):
    """Two databases' stores (every field, bit for bit), host mirrors and
    wave records are equal."""
    import numpy as np
    if os.path.join(ROOT, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
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


def _small_write_reference(dev, launches) -> int:
    """The CPU tests' seeded op script (``tests/torch_write_script.py``)
    on this device and on the CPU: every store field, host mirror, event
    and wave record equal bit for bit.  Then the film KG of the CPU tests
    loaded through the write path onto 4 shards (equal to the CPU's load),
    one wave of edits (films deleted with their edges, edges created and
    deleted, a film created), and q1 / q2 / q3 through a 4-shard mesh and
    locally, in both budget modes, against set computations over the edge
    list the writes leave; then the same queries served by ``A1Server``
    in waves of 8 through the mesh (``use_spmd=True``) and locally, at a
    fixed wave deadline so that no budget truncates a wave, against the
    same counts (the mesh run's launches join ``launches["serving"]``).
    Returns the number of queries checked."""
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
    from repro_torch.kernels import _cuda
    from repro_torch.launch.serve import A1Server
    served = {}
    for spmd in (False, True):
        kw = dict(use_spmd=True, mesh=make_mesh(4, dev)) if spmd else {}
        srv = A1Server(db, caps=caps, read_batch=8, read_deadline_ms=1e9,
                       **kw)
        _cuda.reset_launches()
        ids = [srv.submit_query(q) for q in qs]
        srv.flush_queries()
        if spmd:
            mesh = dict(_cuda.LAUNCHES)
        rows = [srv.query_result(i) for i in ids]
        check(all(r["status"] == "OK" and not r["failed"] for r in rows)
              and [r["count"] for r in rows] == want,
              f"served small written store, use_spmd={spmd}: "
              f"{[r.get('count') for r in rows]} != {want}")
        served[spmd] = (rows, srv.stats["read_waves"])
        n += len(want)
    check(served[True] == served[False], "served: mesh differs from local")
    db.task_queue = None
    launches["serving"] = {k: launches.get("serving", {}).get(k, 0) + v
                           for k, v in mesh.items()}
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


# ---------------------------------------------------------------------------
# phase 11b: replication, recovery and shared attach
# ---------------------------------------------------------------------------

FILM_SIDE = {"film.director": "in", "film.actor": "out", "film.genre": "out"}


def _dur_cfg(sz) -> dict:
    """One shard at a1-kg's widths and delta caps, sized for the KG."""
    n_v = sum(sz.values())
    return dict(A1_SHARD, cap_v=n_v + 4_096, cap_idx=n_v + 4_096,
                cap_e=10 * sz["n_films"] + 4_096)


def _logical(db, ts):
    """A database's content by logical identity at ``ts``: {(vtype, key):
    (f32 row bits, i32 row)} and the set of (src vtype, src key, etype, dst
    vtype, dst key) edges (read from the film side, which every edge type
    of the film KG touches)."""
    import numpy as np
    from repro_torch.core.addressing import gid_of
    S, cap_v = db.cfg.n_shards, db.cfg.cap_v
    vt = db.store.vtype.cpu().numpy()
    key = db.store.vkey.cpu().numpy()
    cre = db.store.v_create.cpu().numpy()
    dele = db.store.v_delete.cpu().numpy()
    rows = np.flatnonzero((vt >= 0) & (cre <= ts) & (ts < dele))
    gids = [gid_of(int(r) // cap_v, int(r) % cap_v, S) for r in rows]
    ident = {g: (int(vt[r]), int(key[r])) for g, r in zip(gids, rows)}
    f, i, alive = _rows_many(db, gids, ts)
    check(bool(alive.all()), "logical dump: a live row reads dead")
    verts = {ident[g]: (tuple(f[j].view(np.int32).tolist()),
                        tuple(i[j].tolist())) for j, g in enumerate(gids)}
    films = [g for g in gids if ident[g][0] == db.vt("film").type_id]
    edges = set()
    for name, direction in FILM_SIDE.items():
        et = db.et(name).type_id
        for film, nbrs in _edge_sets(db, films, direction, et, ts).items():
            for n in nbrs:
                s_, d_ = (film, n) if direction == "out" else (n, film)
                edges.add((*ident[s_], et, *ident[d_]))
    return verts, edges


def _recovered_counts(db, dev, kg):
    """q1 and q3 counts and fast-fail flags of a film KG's first directors
    and actors, on the kernel path, equal to ``backend="ref"``."""
    from repro_torch.core.query.executor import QueryCaps
    dk = [int(k) for k in kg.director_keys[:32]]
    ak = [int(k) for k in kg.actor_keys[:32]]
    qs = [q1(d) for d in dk] + [q3(d, a) for d, a in zip(dk, ak)]
    caps = QueryCaps(frontier=4096, expand=16384, results=64)
    res = db.query(qs, caps=caps, fused=True, backend="kernel")
    _same(res, db.query(qs, caps=caps, fused=True, backend="ref"),
          "a recovered store's batch")
    check(not res.failed_q.all(), "a recovered store's batch fast-failed")
    return res.counts.tolist(), res.failed_q.tolist()


def phase_durability(dev, sz, launches):
    """Phase 11b: a film KG loaded through ``load_film_kg`` into a database
    whose replication log ships every wave (WAL on disk); ``fail_next`` at
    two points of the load and one dropped ship round after it, then the
    sweeper to lag 0, ``t_R`` never ahead of what shipped.  The ObjectStore
    reloaded from its WAL; ``consistent_recover`` and
    ``best_effort_recover`` onto the card, each equal to the source by
    logical identity and to the same recovery on the CPU field by field;
    then ``export_shared`` / ``attach_shared`` onto the card.  One RECOVER
    line; the launches join phase 6c's (the ``maintenance`` path)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import faults as faults_mod
    from repro_torch.core import recovery
    from repro_torch.core.addressing import StoreConfig
    from repro_torch.core.graphdb import GraphDB
    from repro_torch.core.replication import (ObjectStore, ReplicationLog,
                                              sweeper_task)
    from repro_torch.core.tasks import TaskQueue
    from repro_torch.core.writes import UpdateVertex
    from repro_torch.data.kg import load_film_kg
    from repro_torch.kernels import _cuda
    _cuda.reset_launches()
    t_phase = time.perf_counter()
    cfg = StoreConfig(**_dur_cfg(sz))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_os_")
    try:
        path = os.path.join(tmp, "objectstore")
        store = ObjectStore(path)
        log = ReplicationLog(store, ship_waves=True)
        db = GraphDB(cfg, replication_log=log, device=dev)
        log.db = db
        db.faults = inj = faults_mod.FaultInjector(seed=11)
        waves, max_lag = [0], [0]
        cuts = {3: 1, 10: 2}       # wave -> ObjectStore writes that fail

        def t_r_ok(what):
            t_r = store.get_meta("g.t_R", 0)
            check(all(e.ts > t_r for e in log.entries),
                  f"{what}: t_R {t_r} is ahead of an unshipped entry")
            max_lag[0] = max(max_lag[0], log.lag())
        append = log.append_wave

        def append_wave(rec):
            waves[0] += 1
            if waves[0] in cuts:              # the two cuts of the load
                store.fail_next(cuts[waves[0]])
            append(rec)
            t_r_ok(f"wave {waves[0]}")
        log.append_wave = append_wave
        _sync(dev)
        t0 = time.perf_counter()
        kg = load_film_kg(**sz, seed=2, db=db)
        _sync(dev)
        load_s = time.perf_counter() - t0
        # the last wave's ship round is dropped: the sweeper has work
        inj.inject("replication.ship.drop", action="race",
                   times=(inj.visits("replication.ship.drop"),))
        f0 = kg.n_directors + kg.n_actors + kg.n_genres
        db.write([UpdateVertex(f0 + k, "film", {"gross": 0.5 + k})
                  for k in range(64)])
        check(log.lag() > 0, "the dropped ship round left no lag")
        lag_before = log.lag()
        tq = TaskQueue(db)
        tq.enqueue(sweeper_task(log, budget=4_096))
        sweeps = 0
        while tq.pending():
            tq.pump(1)
            sweeps += 1
            t_r_ok(f"sweep {sweeps}")
        t_r = store.get_meta("g.t_R")
        check(log.lag() == 0 and t_r == db.clock,
              f"the sweeper left lag {log.lag()}, t_R {t_r} of {db.clock}")
        wal_bytes = sum(os.path.getsize(os.path.join(path, f))
                        for f in os.listdir(path))
        again = ObjectStore(path)
        check(again.tables == store.tables and again.meta == store.meta,
              "the ObjectStore reloaded from its WAL differs")
        n_v = sum(sz.values())
        n_e = int(kg.edges["src"].shape[0])
        src = {"consistent": _logical(db, t_r)}
        src["best_effort"] = (src["consistent"] if t_r == db.clock
                              else _logical(db, db.clock))
        src_counts = _recovered_counts(db, dev, kg)
        modes, recovered = {}, {}
        for mode, fn in (("consistent", recovery.consistent_recover),
                         ("best_effort", recovery.best_effort_recover)):
            _sync(dev)
            t0 = time.perf_counter()
            r = fn(again, db, cfg, device=dev)
            _sync(dev)
            secs = time.perf_counter() - t0
            check(r.store.device.type == dev.type,
                  f"{mode} recovery left the device")
            check(_logical(r, r.clock) == src[mode],
                  f"{mode} recovery differs from the source")
            check(_recovered_counts(r, dev, kg) == src_counts,
                  f"{mode} recovery's q1 / q3 counts or flags differ")
            t0 = time.perf_counter()
            on_cpu = fn(again, db, cfg, device="cpu")
            cpu_s = time.perf_counter() - t0
            _same_db(r, on_cpu, f"{mode} recovery on the card and the CPU")
            modes[mode] = dict(seconds=secs, rows_per_s=(n_v + n_e) / secs,
                               cpu_seconds=cpu_s)
            recovered[mode] = r
            del on_cpu
        cache = recovery.FastRestartCache()
        cache.hold("recovered", recovered["consistent"])
        man = cache.export_shared("recovered")
        shm_free = shutil.disk_usage("/dev/shm").free
        try:
            _sync(dev)
            t0 = time.perf_counter()
            a = recovery.attach_shared(man, device=dev)
            _sync(dev)
            attach_s = time.perf_counter() - t0
            b = recovery.attach_shared(man, device=dev)
        finally:
            cache.drop("recovered")
        for x in (a, b):
            check(x.store.device.type == dev.type, "an attach left the card")
            check(_logical(x, x.clock) == src["consistent"],
                  "an attached store differs from the source")
        a.write([UpdateVertex(0, "director", {"dob": 1}),
                 UpdateVertex(1, "director", {"dob": 2})])
        check(_logical(b, b.clock) == src["consistent"],
              "a write to one attached store reached the other")
        check(_recovered_counts(b, dev, kg) == src_counts,
              "an attached store's q1 / q3 counts or flags differ")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k, v in _cuda.LAUNCHES.items():
        launches.setdefault("maintenance", {}).setdefault(k, 0)
        launches["maintenance"][k] += v
    say("RECOVER", vertices=n_v, edges=n_e, waves=waves[0],
        wal_bytes=wal_bytes, t_R=t_r, clock=db.clock, lag_before_sweep=
        lag_before, max_lag=max_lag[0], sweeps=sweeps, lag=log.lag(),
        fired=inj.fired, load_s=load_s, modes=modes,
        export_bytes=max(o + int(np.prod(sh)) * 4 for o, sh, _ in
                         man["fields"].values()), attach_s=attach_s,
        dev_shm_free_bytes=shm_free, config=_dur_cfg(sz),
        phase_seconds=time.perf_counter() - t_phase,
        reduced="n_shards 256 -> 1; 14.5 M vertices -> "
                f"{n_v:,} (the write path's host time: a vertex probe a "
                "create, two header reads an edge)")


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
    operator's own entry repeats its kernels' time, so it is left out, and
    so is a scheduled profile's ``ProfilerStep*`` range on the device."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and (e.self_device_time_total or 0) > 0
            and not e.key.startswith("ProfilerStep")]


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
        # the kernel's own cost function and rate (its meta route reports
        # the same to the dry run): x read and y written once, the scale
        # once; ~4 flops an element, float32 arithmetic
        from repro_torch.kernels.rmsnorm.kernel import (RATE_DTYPE,
                                                        rmsnorm_fwd_cost)
        ops, nbytes = rmsnorm_fwd_cost(args[0])
        t_ops = ops / peak_flops(RATE_DTYPE)
        t_bytes = nbytes / HBM_BYTES_PER_S
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")
    elif name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        # the kernels' own cost function and rate (their meta routes
        # report the same to the dry run): the inputs read and the outputs
        # written once; 4*D flops a live (query, key) pair forward, 8*D for
        # dk and dv, 6*D for dq, at q's dtype's rate (the bf16 tensor
        # cores' on the main path)
        from repro_torch.kernels.flash_attention.kernel import flash_cost
        ops, nbytes = flash_cost(name, args[0], args[1],
                                 causal=kw["causal"], window=kw["window"],
                                 q_offset=kw["q_offset"])
        t_ops = ops / peak_flops(args[0].dtype)
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
    from repro_torch.kernels.flash_attention.kernel import live_pairs
    return live_pairs(Sq, Sk, causal, window, q_offset)


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


def _sdpa_call(args, kw, rows=None, n=20):
    """(label, ms) of F.scaled_dot_product_attention on flash_fwd's inputs
    (the first ``rows`` positions, with ``is_causal`` there when the window
    covers them; else the boolean mask), the fastest of _sdpa_setups, each
    timed over ``n`` calls."""
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
    causal_only = rows and kw["causal"] and kw["q_offset"] == 0 and \
        (kw["window"] <= 0 or kw["window"] >= Sk)
    mask = None if causal_only else attention_mask(
        q.shape[1], Sk, causal=kw["causal"], window=kw["window"],
        q_offset=kw["q_offset"], device=q.device)

    def timer(backend, kk, vv, gqa):
        def call():
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(
                    q4, kk, vv, attn_mask=mask, is_causal=bool(causal_only),
                    scale=kw["scale"], **gqa)
        return lambda: _events_ms(call, n)
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
                       ("maintenance", ("searchsorted_left_ranged", "expand",
                                        "dedup_compact_rows", "sort_rows")),
                       ("serving", ("searchsorted_left_ranged", "expand",
                                    "dedup_compact_rows", "sort_pairs",
                                    "searchsorted_left")),
                       # least-loaded routing puts ~16 reads of a fleet
                       # wave of 64 on each coordinator, under the shared
                       # knee: no shared wave, so no sort_pairs
                       ("fleet", ("searchsorted_left_ranged", "expand",
                                  "dedup_compact_rows", "sort_rows",
                                  "knn_topk")),
                       ("nearest", ("knn_topk", "dedup_compact_rows")),
                       ("nearest_shared", ("knn_topk", "sort_pairs")),
                       ("mesh", ("searchsorted_left", "expand",
                                 "dedup_compact_rows", "sort_rows")),
                       ("mesh_shared", ("searchsorted_left", "sort_pairs",
                                        "expand",
                                        "searchsorted_left_ranged")),
                       ("lm_decode", ("rmsnorm_fwd",)),
                       ("lm_dist_ring", ("rmsnorm_fwd", "flash_fwd")),
                       ("lm_dist_pipeline", ("rmsnorm_fwd", "flash_fwd")),
                       ("lm_train", LM_KERNELS)) + tuple(
            (f"lm_zoo/{a}/{c}", ("rmsnorm_fwd", "flash_fwd")
             if c == "prefill_32k" else ("rmsnorm_fwd",))
            for a, c, _ in LM_ZOO_CELLS):
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
        for cell, at in ZOO_AT.get(name, {}).items():
            row[f"at_{cell}"] = at
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
                    help="without a GPU: phases 4-9d, 11b and 11 at a "
                         "tiny size on the CPU, then exit 1")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.configs import h2o_danube_3_4b as danube
    if not torch.cuda.is_available():
        if not args.rehearse:
            print("chip_smoke: no CUDA device; nothing was run",
                  file=sys.stderr)
            return 1
        dev = torch.device("cpu")
        kg, load_s = phase_load(dev, KG_REHEARSE, dict(
            A1_SHARD, cap_v=20_000, cap_e=80_000, cap_idx=20_000,
            cap_delta=256, cap_idx_delta=256))
        caps = dict(A1_CAPS, frontier=256, expand=1024)
        launches = {}
        batches, results, peak = phase_serve(kg, dev, 1, launches, caps)
        phase_serve_shared(kg, dev, batches, results, peak, launches, caps)
        state = phase_write(kg, dev, WRITE_REHEARSE, launches, caps_kw=caps)
        phase_maintenance(kg, dev, MAINT_REHEARSE, state, launches, load_s)
        phase_serving(kg, dev, SERVE_REHEARSE, state, launches)
        fleet = phase_fleet(kg, dev, FLEET_REHEARSE, state, launches)
        phase_sampler_db(kg, ZOO_REHEARSE)
        docs = phase_nearest(dev, NEAREST_REHEARSE, 1, launches, caps)
        phase_fleet_nearest(docs, dev, NEAREST_REHEARSE, launches, caps,
                            fleet)
        del docs
        kg, _ = phase_load(dev, KG_REHEARSE, dict(A1_MESH, cap_v=5_000,
                                                  cap_e=20_000, cap_idx=5_000),
                           MESH_REDUCED)
        phase_mesh(kg, dev, 1, launches, dict(A1_MESH_CAPS, frontier=256,
                                              expand=1024, bucket=256))
        rec = Recorder()
        rec.only = set()
        phase_lm(dev, danube.REDUCED, LM_REHEARSE, launches, rec)
        phase_lm_zoo(dev, LM_ZOO_REHEARSE, launches, rec)
        phase_lm_train(dev, danube.REDUCED, LM_REHEARSE, launches, rec)
        phase_zoo(dev, ZOO_REHEARSE, launches, rec)
        rec.restore()
        phase_durability(dev, DUR_REHEARSE, launches)
        phase_small_reference(dev, launches)
        print("chip_smoke: CPU rehearsal finished; no GPU result",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (the checkout's package, or fail here)
    dev = torch.device("cuda")
    phase_device()
    phase_build()
    phase_kernel_checks()
    if not args.quick:
        kg, load_s = phase_load(dev, KG_FULL, A1_SHARD)
        rec = Recorder()
        launches = {}
        batches, results, peak = phase_serve(kg, dev, BATCHES, launches)
        phase_serve_shared(kg, dev, batches, results, peak, launches)
        del batches, results
        state = phase_write(kg, dev, WRITE_FULL, launches, rec)
        phase_maintenance(kg, dev, MAINT_FULL, state, launches, load_s, rec)
        phase_serving(kg, dev, SERVE_FULL, state, launches, rec)
        fleet = phase_fleet(kg, dev, FLEET_FULL, state, launches, rec)
        phase_sampler_db(kg, ZOO_FULL)
        del kg, state
        torch.cuda.empty_cache()
        docs = phase_nearest(dev, NEAREST_FULL, BATCHES, launches)
        phase_fleet_nearest(docs, dev, NEAREST_FULL, launches, A1_CAPS,
                            fleet)
        del docs
        torch.cuda.empty_cache()
        kg, _ = phase_load(dev, KG_MESH, A1_MESH, MESH_REDUCED)
        rec.only = {"searchsorted_left"}      # the earlier paths' inputs stay
        phase_mesh(kg, dev, BATCHES, launches)
        del kg
        torch.cuda.empty_cache()
        rec.only = set()                      # phase_lm records its own
        phase_lm(dev, danube.FULL, LM_FULL, launches, rec)
        rec.park(torch.device("cpu"))         # phase 9d needs the memory
        phase_lm_zoo(dev, LM_ZOO_FULL, launches, rec)
        rec.park(dev)
        phase_lm_train(dev, danube.FULL, LM_FULL, launches, rec)
        phase_zoo(dev, ZOO_FULL, launches, rec)
        rec.restore()
        phase_durability(dev, DUR_FULL, launches)
        phase_small_reference(dev, launches)
        phase_kernel_report(launches, rec.best, rec.extra)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
