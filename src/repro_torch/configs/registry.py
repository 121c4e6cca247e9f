"""Architecture registry: arch id -> model config + shape cells.

Port of ``repro/configs/registry.py``: ``ShapeCell``, ``ArchSpec``,
``register`` and the lookup (``get``, ``all_archs``, ``all_cells``), and
the LM, GNN and recsys shape templates.  The lookup imports every config
module (:data:`CONFIG_MODULES`), as the JAX registry does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

_REGISTRY: dict[str, "ArchSpec"] = {}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    shape_id: str
    kind: str                  # 'train' | 'prefill' | 'decode' | ...
    geometry: dict             # family-specific geometry numbers
    skip: Optional[str] = None   # reason string when the cell is N/A


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """An architecture: its full-size config, a reduced config (CPU tests),
    its shape cells and its sharding-rule overrides (``dist/sharding.py``),
    which ``launch/steps.py::build_cell`` scopes to the train cells."""
    arch_id: str
    family: str                # 'lm' | 'gnn' | 'recsys' | 'a1'
    model: Any                 # full-size config
    reduced: Any               # reduced config (CPU tests)
    shapes: tuple              # tuple[ShapeCell, ...]
    source: str = ""
    note: str = ""
    rules_override: dict = dataclasses.field(default_factory=dict)
    # optimizer-state/grad-accum sharding rules (ZeRO-style splits where
    # params and optimizer shard differently)
    opt_rules_override: dict = dataclasses.field(default_factory=dict)

    def cell(self, shape_id: str) -> ShapeCell:
        return cell(self.shapes, shape_id)


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    return _REGISTRY[arch_id]


def all_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) pair, including skipped cells."""
    _ensure_loaded()
    return [(a, c.shape_id) for a in all_archs()
            for c in _REGISTRY[a].shapes]


# the config modules of repro_torch.configs, in the JAX registry's order
CONFIG_MODULES = ("qwen3_moe_235b", "llama4_maverick_400b", "llama3_405b",
                  "h2o_danube_3_4b", "qwen15_32b", "nequip", "gcn_cora",
                  "meshgraphnet", "graphsage_reddit", "bst", "a1_kg")
_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    import importlib
    for mod in CONFIG_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True


def lm_shapes(*, window: int = 0, accum_train: int = 16) -> tuple:
    """The 4 assigned LM cells.  long_500k runs only for sub-quadratic
    attention (SWA); full-attention archs record the skip."""
    long_skip = (None if window > 0 else
                 "pure full-attention arch: 524k-token cell would be "
                 "quadratic; run only for SWA/SSM/linear-attn per assignment")
    return (
        ShapeCell("train_4k", "train",
                  dict(seq_len=4096, global_batch=256,
                       accum=accum_train)),
        ShapeCell("prefill_32k", "prefill",
                  dict(seq_len=32768, global_batch=32)),
        ShapeCell("decode_32k", "decode",
                  dict(seq_len=32768, global_batch=128)),
        ShapeCell("long_500k", "decode",
                  dict(seq_len=524288, global_batch=1), skip=long_skip),
    )


def gnn_shapes(*, d_feat_sm: int, n_classes: int) -> tuple:
    """The 4 assigned GNN cells (geometry is shape-owned; d_feat per cell)."""
    return (
        ShapeCell("full_graph_sm", "graph_train",
                  dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                       n_classes=n_classes)),
        ShapeCell("minibatch_lg", "graph_train",
                  dict(n_base_nodes=232_965, n_base_edges=114_615_892,
                       batch_nodes=1024, fanout=(15, 10), d_feat=602,
                       n_classes=n_classes, sampled=True)),
        ShapeCell("ogb_products", "graph_train",
                  dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                       n_classes=n_classes)),
        ShapeCell("molecule", "graph_train",
                  dict(batch=128, n_nodes=30, n_edges=64, d_feat=8,
                       n_classes=n_classes, molecule=True)),
    )


def recsys_shapes() -> tuple:
    return (
        ShapeCell("train_batch", "train", dict(batch=65_536)),
        ShapeCell("serve_p99", "serve", dict(batch=512)),
        ShapeCell("serve_bulk", "serve", dict(batch=262_144)),
        ShapeCell("retrieval_cand", "retrieval",
                  dict(batch=1, n_candidates=1_000_000)),
    )


def cell(shapes: tuple, shape_id: str) -> ShapeCell:
    for c in shapes:
        if c.shape_id == shape_id:
            return c
    raise KeyError(f"no shape {shape_id!r}")
