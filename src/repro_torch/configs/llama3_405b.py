"""llama3-405b [arXiv:2407.21783; unverified]

Port of ``repro/configs/llama3_405b.py``: 126L d_model=16384 128H (GQA
kv=8) d_head=128 d_ff=53248 vocab=128256.  Dense.
"""
import torch

from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="llama3-405b",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_head=128,
    d_ff=53248, vocab=128256,
    block_pattern=("dense",), dtype=torch.bfloat16, remat=True)

REDUCED = LMConfig(
    name="llama3-reduced",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=256, vocab=512, block_pattern=("dense",), dtype=torch.float32,
    remat=False)

SPEC = register(ArchSpec(
    arch_id="llama3-405b", family="lm", model=FULL, reduced=REDUCED,
    shapes=lm_shapes(window=0, accum_train=16),
    source="arXiv:2407.21783; unverified",
    note="A1 technique inapplicable (dense, no sparse lookup on the hot "
         "path)."))
