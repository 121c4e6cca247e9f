"""meshgraphnet [arXiv:2010.03409; unverified]

Port of ``repro/configs/meshgraphnet.py``: 15 processor layers, d_hidden
128, sum aggregation, 2-layer MLPs.
"""
import torch

from repro_torch.configs.registry import ArchSpec, gnn_shapes, register
from repro_torch.models.gnn.meshgraphnet import MGNConfig

FULL = MGNConfig(name="meshgraphnet", n_layers=15, d_hidden=128,
                 mlp_layers=2, d_in=8, d_edge_in=4, d_out=3,
                 dtype=torch.float32)

REDUCED = MGNConfig(name="mgn-reduced", n_layers=3, d_hidden=32,
                    mlp_layers=2, d_in=8, d_edge_in=4, d_out=3,
                    dtype=torch.float32)

SPEC = register(ArchSpec(
    arch_id="meshgraphnet", family="gnn", model=FULL, reduced=REDUCED,
    shapes=gnn_shapes(d_feat_sm=1433, n_classes=3),
    note="mesh edges live in the A1 CSR store; message passing = edge "
         "enumeration + scatter.",
    source="arXiv:2010.03409; unverified",
))
