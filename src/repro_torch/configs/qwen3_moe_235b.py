"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B; hf]

Port of ``repro/configs/qwen3_moe_235b.py``: 94L d_model=4096 64H (GQA
kv=4) d_head=128 vocab=151936, every layer MoE with 128 experts top-8 and a
per-expert d_ff of 1536, dispatched in 16 token groups.  ~235B total /
~22B active.
"""
import torch

from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab=151936,
    block_pattern=("moe",), n_experts=128, top_k=8, expert_d_ff=1536,
    moe_groups=16, dtype=torch.bfloat16, remat=True)

REDUCED = LMConfig(
    name="qwen3-moe-reduced",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=96, vocab=512, block_pattern=("moe",), n_experts=8, top_k=2,
    expert_d_ff=96, dtype=torch.float32, remat=False)

SPEC = register(ArchSpec(
    arch_id="qwen3-moe-235b-a22b", family="lm", model=FULL, reduced=REDUCED,
    shapes=lm_shapes(window=0, accum_train=8),
    source="hf:Qwen/Qwen3-30B-A3B (scaled family layout); verified-tier: hf",
    note="MoE token dispatch = A1 query shipping (tokens sent to their "
         "experts' owners).",
    rules_override={"seq": "model"}))   # sequence parallelism for activations
