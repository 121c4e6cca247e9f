"""a1-kg — the paper's own workload (§6) as an architecture config.

Port of ``repro/configs/a1_kg.py``: the Bing film/entertainment knowledge
graph served by A1, one weakly-typed ``entity`` vertex type (~220-byte
payloads -> 32 f32 + 16 i32 columns), paper-scale 3.7 B vertices / 6.2 B
edges over 256 shards.  Shape cells mirror the paper's query classes:

  serve_q1   Q=64  2-hop count     (Fig. 10: "actors who worked with X")
  serve_q2   Q=64  3-hop count     (Fig. 12: "actors who played Batman")
  serve_q3   Q=64  star intersect  (Fig. 13: director AND actor AND genre)
  update     commit-batch apply    (the OLTP write path)
"""
from repro_torch.configs.registry import ArchSpec, ShapeCell, register
from repro_torch.core.addressing import StoreConfig

# paper scale: 3.7B vertices, 6.2B edges (both halves stored) over 256 shards
FULL = StoreConfig(
    n_shards=256,
    cap_v=15_000_000,          # 3.84B vertex slots
    cap_e=50_000_000,          # 12.8B half-edge slots (6.2B edges x 2)
    cap_delta=16_384,
    cap_idx=16_000_000,
    cap_idx_delta=16_384,
    d_f32=32, d_i32=16,        # ~220-byte schematized payload
    replication=1,
)

REDUCED = StoreConfig(n_shards=8, cap_v=512, cap_e=4096, cap_delta=512,
                      cap_idx=1024, cap_idx_delta=256, d_f32=4, d_i32=4)

# A1QL capacity hints sized to the Q1-Q3 working sets: every sort and
# gather of a hop scales with these
_QCAPS = dict(frontier=4096, expand=16384, bucket=256, results=64)

SPEC = register(ArchSpec(
    arch_id="a1-kg", family="a1", model=FULL, reduced=REDUCED,
    shapes=(
        ShapeCell("serve_q1", "a1_serve",
                  dict(n_queries=64, hops=2, caps=_QCAPS)),
        ShapeCell("serve_q2", "a1_serve",
                  dict(n_queries=64, hops=3, caps=_QCAPS)),
        ShapeCell("serve_q3", "a1_serve",
                  dict(n_queries=64, hops=1, star=2, caps=_QCAPS)),
        ShapeCell("update", "a1_update", dict()),
    ),
    source="SIGMOD'20 A1 paper §6",
    note="the reproduction target itself: distributed traversal with query "
         "shipping, MVCC snapshot reads, fast-fail capacities."))
