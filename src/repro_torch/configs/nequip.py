"""nequip [arXiv:2101.03164; paper]

Port of ``repro/configs/nequip.py``: 5 interaction layers, hidden mul 32,
l_max=2, 8 RBF, 5 A cutoff, E(3)-tensor-product equivariance.  Graph cells
that lack positions get synthetic 3D coordinates from the data pipeline.
"""
import torch

from repro_torch.configs.registry import ArchSpec, gnn_shapes, register
from repro_torch.models.gnn.nequip import NequIPConfig

FULL = NequIPConfig(name="nequip", n_layers=5, mul=32, l_max=2, n_rbf=8,
                    cutoff=5.0, n_species=8, dtype=torch.float32)

REDUCED = NequIPConfig(name="nequip-reduced", n_layers=2, mul=8, l_max=2,
                       n_rbf=4, cutoff=5.0, n_species=4, dtype=torch.float32)

SPEC = register(ArchSpec(
    arch_id="nequip", family="gnn", model=FULL, reduced=REDUCED,
    shapes=gnn_shapes(d_feat_sm=1433, n_classes=7),
    source="arXiv:2101.03164; verified-tier: paper",
    note="neighbor lists come from the A1 store's edge enumeration; "
         "energies rotation-invariant (property-tested).  eSCN O(L^3) "
         "contraction unnecessary at l_max=2 (paths are tiny).",
))
