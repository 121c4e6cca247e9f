"""gcn-cora [arXiv:1609.02907; paper]

Port of ``repro/configs/gcn_cora.py``: 2 layers, d_hidden 16, sym
aggregation, the classic Kipf & Welling citation-network configuration.
"""
import torch

from repro_torch.configs.registry import ArchSpec, gnn_shapes, register
from repro_torch.models.gnn.gcn import GCNConfig

FULL = GCNConfig(name="gcn-cora", n_layers=2, d_in=1433, d_hidden=16,
                 n_classes=7, norm="sym", dtype=torch.float32)

REDUCED = GCNConfig(name="gcn-reduced", n_layers=2, d_in=64, d_hidden=8,
                    n_classes=7, norm="sym", dtype=torch.float32)

SPEC = register(ArchSpec(
    arch_id="gcn-cora", family="gnn", model=FULL, reduced=REDUCED,
    shapes=gnn_shapes(d_feat_sm=1433, n_classes=7),
    source="arXiv:1609.02907; verified-tier: paper",
    note="full-graph SpMM (gather + index_add message passing; the "
         "segment_spmm kernel behind kernels/segment_spmm/ops.py)."))
