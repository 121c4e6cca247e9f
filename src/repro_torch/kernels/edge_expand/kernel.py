"""Ragged CSR span gather: the CUDA kernel ``csrc/edge_expand.cu`` and its
plain PyTorch version.

Port of ``repro/kernels/edge_expand/kernel.py::expand``.  Given the tile plan
of :func:`repro_torch.kernels.edge_expand.ref.plan`, lane j of output tile t
is edge ``tw[t]*tile + j`` of frontier item ``item[t]``, gathered from each
pool, or -1 (padding tile, lane past the span, or a position outside the
pool).  :func:`expand` runs the plain version for CPU tensors and launches
the kernel for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda

TILE = 128          # the kernel's block width; edges.TILE


def expand_plain(starts, degs, pools, item_of_tile, tw_of_tile, *,
                 tile: int = TILE, cap_tiles: int):
    """Plain PyTorch version: one (cap_tiles, tile) gather per pool."""
    F = degs.shape[0]
    E = pools[0].shape[0]
    dev = degs.device
    if F == 0 or E == 0:
        return tuple(torch.full((cap_tiles * tile,), -1, dtype=torch.int32,
                                device=dev) for _ in pools)
    lane = torch.arange(tile, dtype=torch.int64, device=dev)
    item_c = item_of_tile.clamp(0, F - 1)
    tw = tw_of_tile.long()
    pos = (starts[item_c].long() + tw * tile)[:, None] + lane[None, :]
    ok = (((item_of_tile >= 0) & (item_of_tile < F))[:, None]
          & (lane[None, :] < (degs[item_c].long() - tw * tile)[:, None])
          & (pos >= 0) & (pos < E))
    pos_c = torch.where(ok, pos, 0)
    return tuple(torch.where(ok, p[pos_c], -1).reshape(-1) for p in pools)


def _check(starts, degs, pools, item_of_tile, tw_of_tile, tile, cap_tiles):
    if tile != TILE:
        raise ValueError(f"edge_expand: the kernel takes tile={TILE}, "
                         f"got {tile}")
    if not 1 <= len(pools) <= 4:
        raise ValueError("edge_expand: 1 to 4 pools")
    named = [("starts", starts), ("degs", degs),
             ("item_of_tile", item_of_tile), ("tw_of_tile", tw_of_tile)]
    named += [("pool", p) for p in pools]
    for name, t in named:
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"edge_expand: {name} must be a contiguous 1-D "
                             f"int32 tensor, got {t.dtype} {tuple(t.shape)}")
    if starts.shape != degs.shape:
        raise ValueError("edge_expand: starts and degs must have one shape")
    if item_of_tile.shape != (cap_tiles,) or tw_of_tile.shape != (cap_tiles,):
        raise ValueError("edge_expand: the tile plan must have cap_tiles "
                         "entries")
    if any(p.shape != pools[0].shape for p in pools):
        raise ValueError("edge_expand: pools must have one shape")


def expand(starts, degs, pools, item_of_tile, tw_of_tile, *,
           tile: int = TILE, cap_tiles: int):
    """starts/degs (F,) i32 absolute span offsets/lengths; pools: up to four
    (E,) i32 arrays; item_of_tile/tw_of_tile (cap_tiles,) i32.  Returns one
    (cap_tiles*tile,) i32 tensor per pool."""
    pools = tuple(pools)
    _check(starts, degs, pools, item_of_tile, tw_of_tile, tile, cap_tiles)
    if degs.device.type == "cpu":
        return expand_plain(starts, degs, pools, item_of_tile, tw_of_tile,
                            tile=tile, cap_tiles=cap_tiles)
    _cuda.require_cuda(starts, degs, item_of_tile, tw_of_tile, *pools)
    outs = tuple(torch.empty((cap_tiles * tile,), dtype=torch.int32,
                             device=degs.device) for _ in pools)
    if cap_tiles == 0:
        return outs
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _cuda.function("edge_expand", "edge_expand",
                        [p] * 12 + [i32, i32, i64, i64, p])
    pp = [x.data_ptr() for x in pools]
    oo = [x.data_ptr() for x in outs]
    pp += [pp[0]] * (4 - len(pp))
    oo += [oo[0]] * (4 - len(oo))
    rc = fn(starts.data_ptr(), degs.data_ptr(), item_of_tile.data_ptr(),
            tw_of_tile.data_ptr(), *pp, *oo, len(pools), degs.shape[0],
            pools[0].shape[0], cap_tiles, _cuda.stream_of(degs))
    _cuda.check(rc, "edge_expand")
    _cuda.LAUNCHES["expand"] += 1
    return outs
