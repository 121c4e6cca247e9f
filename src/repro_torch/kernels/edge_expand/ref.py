"""The tile plan of a ragged CSR expansion, in plain PyTorch.

Port of ``repro/kernels/edge_expand/ref.py::plan``: the host-side half of the
edge_expand kernel, run on whatever device the degrees live on.
"""
import torch


def plan(degs, tile: int, cap_tiles: int):
    """Tile plan for a ragged expansion.

    Returns (item_of_tile, tw_of_tile, n_tiles, overflow): which frontier
    item and which tile-within-item each output tile serves.  Items with
    deg 0 get no tiles.  Padding tiles map to item = F (sentinel).
    """
    F = degs.shape[0]
    dev = degs.device
    k = torch.arange(cap_tiles, dtype=torch.int32, device=dev)
    if F == 0:
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return torch.zeros_like(k), torch.zeros_like(k), zero, zero > 0
    tiles_per = (degs + (tile - 1)) // tile
    cum = torch.cumsum(tiles_per, 0, dtype=torch.int32)
    n_tiles = cum[-1]
    item = torch.searchsorted(cum, k, right=True, out_int32=True)
    item_c = torch.clamp(item, max=F - 1)
    tw = k - (cum[item_c] - tiles_per[item_c])
    valid = k < n_tiles
    return (torch.where(valid, item_c, F), torch.where(valid, tw, 0),
            n_tiles, n_tiles > cap_tiles)
