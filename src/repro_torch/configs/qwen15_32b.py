"""qwen1.5-32b [hf:Qwen/Qwen1.5-0.5B; hf]

Port of ``repro/configs/qwen15_32b.py``: 64L d_model=5120 40H (GQA kv=40 =
full MHA) d_head=128 d_ff=27392 vocab=152064, QKV bias (the Qwen1.5
signature).
"""
import torch

from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="qwen1.5-32b",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_head=128,
    d_ff=27392, vocab=152064, qkv_bias=True,
    block_pattern=("dense",), dtype=torch.bfloat16, remat=True)

REDUCED = LMConfig(
    name="qwen15-reduced",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=8, d_head=16,
    d_ff=256, vocab=512, qkv_bias=True, block_pattern=("dense",),
    dtype=torch.float32, remat=False)

SPEC = register(ArchSpec(
    arch_id="qwen1.5-32b", family="lm", model=FULL, reduced=REDUCED,
    shapes=lm_shapes(window=0, accum_train=8),
    source="hf:Qwen/Qwen1.5-0.5B (family layout); verified-tier: hf",
    note="QKV bias; kv_heads == heads (MHA); A1 technique inapplicable "
         "(dense)."))
