"""h2o-danube-3-4b [arXiv:2401.16818; unverified]

Port of ``repro/configs/h2o_danube_3_4b.py`` (the model configs and the
shape cells; the TPU sharding rules, which only the JAX dry run reads, stay
there).  24L d_model=3840 32H (GQA kv=8) d_head=120 d_ff=10240 vocab=32000
with sliding-window attention (window 4096): the decode KV cache is a
window-bounded ring buffer.
"""
import torch

from repro_torch.configs.registry import lm_shapes
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="h2o-danube-3-4b",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_head=120,
    d_ff=10240, vocab=32000, window=4096,
    block_pattern=("dense",), dtype=torch.bfloat16, remat=True)

REDUCED = LMConfig(
    name="danube-reduced",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=256, vocab=512, window=32, block_pattern=("dense",),
    dtype=torch.float32, remat=False)

SHAPES = lm_shapes(window=4096, accum_train=1)
SOURCE = "arXiv:2401.16818; unverified"
