"""graphsage-reddit [arXiv:1706.02216; paper]

Port of ``repro/configs/graphsage_reddit.py``: 2 layers, d_hidden 128,
mean aggregator.  The minibatch cell samples fanouts (15, 10) with the
real fanout sampler (``data/sampler.py``), a bounded A1 traversal.
"""
import torch

from repro_torch.configs.registry import ArchSpec, gnn_shapes, register
from repro_torch.models.gnn.sage import SageConfig

FULL = SageConfig(name="graphsage-reddit", n_layers=2, d_in=602,
                  d_hidden=128, n_classes=41, dtype=torch.float32)

REDUCED = SageConfig(name="sage-reduced", n_layers=2, d_in=32, d_hidden=16,
                     n_classes=8, dtype=torch.float32)

SPEC = register(ArchSpec(
    arch_id="graphsage-reddit", family="gnn", model=FULL, reduced=REDUCED,
    shapes=gnn_shapes(d_feat_sm=1433, n_classes=41),
    source="arXiv:1706.02216; verified-tier: paper",
    note="fanout sampling is an A1 multi-hop traversal with per-hop "
         "capacity; sampler: data/sampler.py."))
