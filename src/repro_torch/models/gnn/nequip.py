"""NequIP (arXiv:2101.03164): O(3)-equivariant interatomic potential.

Port of ``repro/models/gnn/nequip.py``.  Assigned config: 5 interaction
layers, hidden multiplicity 32, l_max = 2, 8 Bessel radial basis
functions, 5 A cutoff, E(3) tensor-product messages (``irreps.py``, the
port's own copy, provides the O(3) algebra):

  * features: dict l -> (N, mul, 2l+1);
  * message on edge (i->j): sum over CG paths (l1, l2 -> l3) of
    R_path(|r|) * CG(feat_i[l1] (x) Y_l2(r_hat)), radial weights from a
    per-path MLP over the Bessel basis with polynomial cutoff;
  * aggregation: an ``index_add`` onto destinations (padding edges into a
    dropped sink row); self-interaction linear mix per l + residual;
    norm-gate nonlinearity (scalars: SiLU; l > 0 scaled by SiLU of channel
    norms);
  * readout: per-atom scalar MLP -> site energies -> per-graph sum; forces
    are -grad_positions (:func:`forces`).

Params are a dict laid out like the JAX pytree: ``embed``, ``layers`` (a
list of ``{"radial_w1", "radial_w2"}`` keyed by path tag ``"l1l2l3"`` and
``{"self", "skip"}`` keyed by ``str(l)``), ``readout_w1``, ``readout_w2``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.backend import resolve_device
from repro_torch.core.precision import f32_accumulation
from repro_torch.core.tree import copy_from_numpy, meta_tree
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.models.gnn.irreps import PATHS, real_cg


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    mul: int = 32                 # hidden multiplicity per l
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 8
    radial_hidden: int = 32
    dtype: Any = torch.float32


_DIMS = {0: 1, 1: 3, 2: 5}


def sh(vec, l: int):
    """Real SH of (E, 3) unit vectors (the torch mirror of
    ``irreps.sh_np``)."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    if l == 0:
        return torch.ones(vec.shape[:-1] + (1,), dtype=vec.dtype,
                          device=vec.device)
    if l == 1:
        return torch.stack([y, z, x], dim=-1)
    s3 = math.sqrt(3.0)
    return torch.stack([
        s3 * x * y, s3 * y * z, 0.5 * (2 * z * z - x * x - y * y),
        s3 * x * z, 0.5 * s3 * (x * x - y * y)], dim=-1)


def bessel_rbf(r, n: int, cutoff: float):
    """Bessel basis with smooth polynomial cutoff (NequIP eq. 6-7)."""
    safe = torch.clamp(r, min=1e-6)
    k = torch.arange(1, n + 1, dtype=torch.float32, device=r.device)
    basis = math.sqrt(2.0 / cutoff) * torch.sin(
        k[None, :] * math.pi * safe[:, None] / cutoff) / safe[:, None]
    u = torch.clamp(r / cutoff, 0, 1)
    fcut = 1 - 10 * u**3 + 15 * u**4 - 6 * u**5      # C^2 polynomial cutoff
    return basis * fcut[:, None]


def _paths(cfg: NequIPConfig):
    return [(l1, l2, l3) for (l1, l2, l3) in PATHS
            if l1 <= cfg.l_max and l2 <= cfg.l_max and l3 <= cfg.l_max]


def _tag(path) -> str:
    return f"{path[0]}{path[1]}{path[2]}"


def param_shapes(cfg: NequIPConfig) -> dict:
    layer = {"radial_w1": {_tag(p): (cfg.n_rbf, cfg.radial_hidden)
                           for p in _paths(cfg)},
             "radial_w2": {_tag(p): (cfg.radial_hidden, cfg.mul)
                           for p in _paths(cfg)},
             "self": {str(l): (cfg.mul, cfg.mul)
                      for l in range(cfg.l_max + 1)},
             "skip": {str(l): (cfg.mul, cfg.mul)
                      for l in range(cfg.l_max + 1)}}
    return {"embed": (cfg.n_species, cfg.mul),
            "layers": [{k: dict(v) for k, v in layer.items()}
                       for _ in range(cfg.n_layers)],
            "readout_w1": (cfg.mul, cfg.mul), "readout_w2": (cfg.mul, 1)}


def param_shape_dtypes(cfg: NequIPConfig) -> dict:
    """The parameter tree as ``meta`` tensors (the dry run's shapes)."""
    return meta_tree(param_shapes(cfg), cfg.dtype)


def init_params(cfg: NequIPConfig, generator: torch.Generator, *,
                device=None):
    """Every leaf N(0, 1) / sqrt(its second-to-last dim) from
    ``generator`` (the JAX law, other numbers), in the JAX draw order."""
    dev = resolve_device(device)

    def nrm(s):
        return (torch.randn(s, generator=generator, device=dev)
                * (s[-2] if len(s) > 1 else s[-1]) ** -0.5).to(cfg.dtype)
    p = {"embed": nrm((cfg.n_species, cfg.mul)), "layers": []}
    for _ in range(cfg.n_layers):
        lp = {"radial_w1": {}, "radial_w2": {}, "self": {}, "skip": {}}
        for path in _paths(cfg):
            lp["radial_w1"][_tag(path)] = nrm((cfg.n_rbf, cfg.radial_hidden))
            lp["radial_w2"][_tag(path)] = nrm((cfg.radial_hidden, cfg.mul))
        for l in range(cfg.l_max + 1):
            lp["self"][str(l)] = nrm((cfg.mul, cfg.mul))
            lp["skip"][str(l)] = nrm((cfg.mul, cfg.mul))
        p["layers"].append(lp)
    p["readout_w1"] = nrm((cfg.mul, cfg.mul))
    p["readout_w2"] = nrm((cfg.mul, 1))
    return p


def params_from_numpy(cfg: NequIPConfig, tree, *, device=None) -> dict:
    """The port's params from a JAX param tree held as numpy arrays, cast
    to ``cfg.dtype`` on ``device``; every leaf a copy."""
    return copy_from_numpy(param_shapes(cfg), tree, cfg.dtype,
                           resolve_device(device))


def _gate(feats):
    """Equivariant nonlinearity: SiLU on scalars, norm-gate on l>0."""
    out = {0: F.silu(feats[0])}
    for l, x in feats.items():
        if l == 0:
            continue
        n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)
        out[l] = x * (F.silu(n) / n)
    return out


def _segment_sum(x, ids, n: int):
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype,
                       device=x.device).index_add(0, ids.long(), x)


@f32_accumulation()
def forward(params, cfg: NequIPConfig, batch: GraphBatch):
    """Returns per-graph energies (n_graphs,)."""
    assert batch.positions is not None
    N = batch.node_feat.shape[0]
    ok = batch.edge_src >= 0
    src = torch.where(ok, batch.edge_src, 0).long()
    dst = torch.where(ok, batch.edge_dst, 0).long()
    # rel is 0 on a self-loop (and a padding edge) whatever the positions:
    # its gradient is taken as the exact 0 (the JAX model's is rounding
    # noise, the two halves of a 1e6-fold gradient of rhat cancelling in
    # one atom's sum)
    rel = torch.where((src == dst)[:, None], 0.0,
                      batch.positions[dst] - batch.positions[src])
    # 1e-12 on each component, as the JAX model adds it: a padding edge or
    # a self-loop (rel = 0) keeps a finite gradient
    r = torch.linalg.vector_norm(rel + 1e-12, dim=-1)
    rhat = rel / torch.clamp(r, min=1e-6)[:, None]
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff) * ok[:, None]
    Y = {l: sh(rhat, l).to(cfg.dtype) for l in range(cfg.l_max + 1)}

    species = batch.node_feat[:, 0].to(torch.int32).long()
    feats = {0: params["embed"][species][:, :, None]}     # (N, mul, 1)
    for l in range(1, cfg.l_max + 1):
        feats[l] = torch.zeros((N, cfg.mul, _DIMS[l]), dtype=cfg.dtype,
                               device=rel.device)

    cg = {p: torch.as_tensor(real_cg(*p)).to(rel.device, cfg.dtype)
          for p in _paths(cfg)}
    edge_mask = ok[:, None, None].to(cfg.dtype)
    sink = torch.where(ok, dst, N)              # padding -> row N, dropped

    for lp in params["layers"]:
        msgs = {l: 0.0 for l in range(cfg.l_max + 1)}
        for path in _paths(cfg):
            l1, l2, l3 = path
            w = F.silu(rbf @ lp["radial_w1"][_tag(path)]) \
                @ lp["radial_w2"][_tag(path)]                # (E, mul)
            fsrc = feats[l1][src]                              # (E, mul, d1)
            m = torch.einsum("emi,ej,ijk->emk", fsrc, Y[l2], cg[path])
            msgs[l3] = msgs[l3] + m * w[:, :, None] * edge_mask
        new = {}
        for l in range(cfg.l_max + 1):
            agg = _segment_sum(msgs[l], sink, N + 1)[:N]
            mixed = torch.einsum("nmi,mk->nki", agg, lp["self"][str(l)])
            skip = torch.einsum("nmi,mk->nki", feats[l], lp["skip"][str(l)])
            new[l] = mixed + skip
        feats = _gate(new)

    site = F.silu(feats[0][:, :, 0] @ params["readout_w1"]) \
        @ params["readout_w2"]                                 # (N, 1)
    gid = (batch.graph_ids if batch.graph_ids is not None
           else torch.zeros((N,), dtype=torch.int32, device=site.device))
    return _segment_sum(site[:, 0], gid, batch.n_graphs)


def loss_fn(params, cfg: NequIPConfig, batch: GraphBatch):
    energy = forward(params, cfg, batch).float()
    target = batch.labels.float()
    mask = batch.train_mask.float()
    mse = torch.sum(((energy - target) ** 2) * mask) / torch.clamp(
        mask.sum(), min=1)
    return mse, {"mse": mse}


def forces(params, cfg: NequIPConfig, batch: GraphBatch):
    """F = -dE/dpositions (the equivariant observable)."""
    with torch.enable_grad():
        pos = batch.positions.detach().requires_grad_(True)
        e = forward(params, cfg, dataclasses.replace(batch, positions=pos))
        (g,) = torch.autograd.grad(e.sum(), pos)
    return -g
