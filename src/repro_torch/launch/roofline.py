"""Roofline terms of a step on one NVIDIA H100, from the dry run's counts.

Port of ``repro/launch/roofline.py``.  Three terms a step, from the op
counts of ``launch/hloanalysis.py::analyze_ops``:

  compute_s    = sum over dtypes of flops in that dtype / peak_flops(dtype)
  memory_s     = bytes moved / HBM_BW
  collective_s = wire bytes / LINK_BW

Wire bytes are the lockstep collectives' (``dist/mesh.py``), a device's
ring traffic by JAX's model, from one shard's result bytes B and the group
size s:

  all-reduce          2 * B * (s-1)/s     (ring reduce-scatter + all-gather)
  all-gather          B * (s-1)/s
  reduce-scatter      B * (s-1)           (B_full = B * s)
  all-to-all          B * (s-1)/s
  collective-permute  B

The card's peaks live here, in one place (``chip_smoke.py`` imports them):
NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit.  These are predictions from a data sheet, not
measurements: a card set below 700 W runs slower.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict

PEAK_FLOPS = 989e12       # dense bf16 tensor-core FLOP/s
F32_FLOPS = 67e12         # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12          # HBM3 bytes/s
LINK_BW = 450e9           # NVLink bytes/s a direction
HBM_BYTES = 80e9          # device memory of the 80 GB part
TENSOR_CORE_DTYPES = ("bfloat16", "float16")


def peak_flops(dtype) -> float:
    """The card's peak FLOP/s for work in ``dtype`` (a torch dtype or its
    name): the dense tensor-core rate for bfloat16 and float16, the
    float32 rate for every other dtype (PyTorch's default gives a float32
    matmul no TF32, and ``core/precision.py::f32_accumulation`` keeps it
    so)."""
    name = str(dtype).replace("torch.", "")
    return PEAK_FLOPS if name in TENSOR_CORE_DTYPES else F32_FLOPS


def collective_wire_bytes(records, n_devices: int) -> dict:
    """A device's wire bytes by collective kind, their total and the count
    of each kind, from ``records`` of (kind, result bytes, group size or
    None for the whole mesh of ``n_devices``).  Groups of one move
    nothing."""
    out = defaultdict(float)
    counts: Counter = Counter()
    for op, b, group in records:
        s = max(group or n_devices, 1)
        if s == 1:
            continue
        if op == "all-reduce":
            wire = 2.0 * b * (s - 1) / s
        elif op == "all-gather":
            wire = b * (s - 1) / s
        elif op == "reduce-scatter":
            wire = b * (s - 1)
        elif op == "all-to-all":
            wire = b * (s - 1) / s
        else:                                  # collective-permute
            wire = float(b)
        out[op] += wire
        counts[op] += 1
    out_d = dict(out)
    out_d["total"] = sum(out.values())
    out_d["counts"] = dict(counts)
    return out_d


@dataclasses.dataclass
class Roofline:
    flops: float                 # the step's flops on the card
    flops_by_dtype: dict         # the same, by the dtype of their peak
    hbm_bytes: float             # bytes the step's ops move
    wire_bytes: float            # collective wire bytes
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float           # global useful flops (6ND-style)
    useful_ratio: float          # model_flops / (flops * n_devices)
    coll_detail: dict
    mem_stats: dict

    def to_json(self):
        return dataclasses.asdict(self)


def analyze(a, *, n_devices: int = 1, model_flops: float = 0.0) -> Roofline:
    """The roofline of an :class:`~repro_torch.launch.hloanalysis.Analysis`
    (one step traced on ``meta``).  ``mem_stats`` holds the trace's
    argument, output and peak live bytes; ``ca_flops_flat`` and
    ``ca_bytes_flat`` (XLA's loop-blind counts in JAX) are the trace's own
    totals, since the trace runs every loop.  The compute term charges
    each dtype's flops at its own peak (:func:`peak_flops`): a float32 GNN
    or BST step at the float32 rate, an LM step's bf16 matmuls at the
    tensor cores'."""
    flops, hbm, wire = a.flops, a.mem_bytes, a.wire_bytes
    cs = sum(f / peak_flops(d) for d, f in a.flops_by_dtype.items())
    ms, ls = hbm / HBM_BW, wire / LINK_BW
    bn = max((("compute", cs), ("memory", ms), ("collective", ls)),
             key=lambda t: t[1])[0]
    coll = dict(a.coll_detail)
    coll["total"] = wire
    mem = dict(argument_bytes=a.arg_bytes, output_bytes=a.out_bytes,
               temp_bytes=max(a.peak_bytes - a.arg_bytes, 0),
               alias_bytes=a.alias_bytes,
               peak_hbm_gb=a.peak_bytes / 1e9,
               ca_flops_flat=flops, ca_bytes_flat=hbm)
    useful = (model_flops / (flops * n_devices)
              if flops > 0 and n_devices else 0.0)
    return Roofline(flops=flops, flops_by_dtype=dict(a.flops_by_dtype),
                    hbm_bytes=hbm, wire_bytes=wire,
                    compute_s=cs, memory_s=ms, collective_s=ls,
                    bottleneck=bn, model_flops=model_flops,
                    useful_ratio=useful, coll_detail=coll, mem_stats=mem)
