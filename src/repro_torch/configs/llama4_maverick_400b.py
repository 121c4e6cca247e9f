"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Port of ``repro/configs/llama4_maverick_400b.py``: 48L d_model=5120 40H
(GQA kv=8) d_head=128 d_ff=8192 vocab=202048, ("dense", "moe") cycles, MoE
with 128 experts top-1 and a per-expert d_ff of 8192 (~400B total, ~17B
active).  The early-fusion modality frontend is a stub, as in the JAX
package (token ids in).
"""
import torch

from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=202048,
    block_pattern=("dense", "moe"), n_experts=128, top_k=1,
    expert_d_ff=8192, dtype=torch.bfloat16, remat=True)

REDUCED = LMConfig(
    name="llama4-reduced",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512, block_pattern=("dense", "moe"), n_experts=8,
    top_k=1, expert_d_ff=128, dtype=torch.float32, remat=False)

SPEC = register(ArchSpec(
    arch_id="llama4-maverick-400b-a17b", family="lm", model=FULL,
    reduced=REDUCED, shapes=lm_shapes(window=0, accum_train=16),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    note="top-1 routing; dense|moe interleave; early-fusion frontend "
         "stubbed."))
