"""Shape cells of the LM family.

Port of the LM half of ``repro/configs/registry.py`` (``ShapeCell`` and
``lm_shapes``).  ``ArchSpec``, the registry itself and the GNN and recsys
templates come with the slices that port those families.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    shape_id: str
    kind: str                  # 'train' | 'prefill' | 'decode' | ...
    geometry: dict             # family-specific geometry numbers
    skip: Optional[str] = None   # reason string when the cell is N/A


def lm_shapes(*, window: int = 0, accum_train: int = 16) -> tuple:
    """The 4 assigned LM cells.  long_500k runs only for sub-quadratic
    attention (SWA); full-attention archs record the skip."""
    long_skip = (None if window > 0 else
                 "pure full-attention arch: 524k-token cell would be "
                 "quadratic; run only for SWA/SSM/linear-attn per assignment")
    return (
        ShapeCell("train_4k", "train",
                  dict(seq_len=4096, global_batch=256,
                       accum=accum_train)),
        ShapeCell("prefill_32k", "prefill",
                  dict(seq_len=32768, global_batch=32)),
        ShapeCell("decode_32k", "decode",
                  dict(seq_len=32768, global_batch=128)),
        ShapeCell("long_500k", "decode",
                  dict(seq_len=524288, global_batch=1), skip=long_skip),
    )


def cell(shapes: tuple, shape_id: str) -> ShapeCell:
    for c in shapes:
        if c.shape_id == shape_id:
            return c
    raise KeyError(f"no shape {shape_id!r}")
