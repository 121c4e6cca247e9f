"""h2o-danube-3-4b [arXiv:2401.16818; unverified]

Port of ``repro/configs/h2o_danube_3_4b.py``: the model configs, the shape
cells and the train cells' sharding rules (pure data parallelism over the
whole mesh, optimizer state ZeRO-split).  24L d_model=3840 32H (GQA kv=8) d_head=120 d_ff=10240 vocab=32000
with sliding-window attention (window 4096): the decode KV cache is a
window-bounded ring buffer.
"""
import torch

from repro_torch.configs.registry import ArchSpec, lm_shapes, register
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

SPEC = register(ArchSpec(
    arch_id="h2o-danube-3-4b", family="lm", model=FULL, reduced=REDUCED,
    shapes=lm_shapes(window=4096, accum_train=1),
    source="arXiv:2401.16818; unverified",
    note="SWA window 4096; long_500k decode uses the ring-buffer cache "
         "(memory O(window), compute O(window) per token).",
    # a 4B model on a 256-chip pod wants no tensor parallelism at train_4k:
    # pure data parallelism over the whole mesh, params replicated,
    # optimizer states and the grad accumulator ZeRO-split
    rules_override={"fsdp": None, "tensor": None, "heads": None,
                    "kv_heads": None, "ff": None, "vocab": None,
                    "batch": ("pod", "data", "model")},
    opt_rules_override={"fsdp": ("data", "model")}))
SHAPES, SOURCE = SPEC.shapes, SPEC.source
