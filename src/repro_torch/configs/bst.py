"""bst [arXiv:1905.06874; paper]

Port of ``repro/configs/bst.py``: Behavior Sequence Transformer
(Alibaba), embed_dim 32, seq_len 20, 1 transformer block, 8 heads, MLP
1024-512-256.  The item table is the huge-embedding regime: 10^8 rows
(12.8 GB in float32), on one device here.
"""
import torch

from repro_torch.configs.registry import ArchSpec, recsys_shapes, register
from repro_torch.models.recsys import BSTConfig

FULL = BSTConfig(name="bst", n_items=100_000_000, embed_dim=32, seq_len=20,
                 n_blocks=1, n_heads=8, d_ff=128,
                 mlp_dims=(1024, 512, 256), n_dense=8, dtype=torch.float32)

REDUCED = BSTConfig(name="bst-reduced", n_items=1000, embed_dim=32,
                    seq_len=20, n_blocks=1, n_heads=8, d_ff=64,
                    mlp_dims=(64, 32), n_dense=8, dtype=torch.float32)

SPEC = register(ArchSpec(
    arch_id="bst", family="recsys", model=FULL, reduced=REDUCED,
    shapes=recsys_shapes(),
    source="arXiv:1905.06874; verified-tier: paper",
    note="embedding lookup = A1 vertex read (a row gather on one device); "
         "retrieval_cand = one batched matmul against 1M candidates."))
