"""PyTorch port, kernel layer: each plain version (what a kernel wrapper runs
on CPU tensors) against the JAX Pallas kernel in interpret mode and against
the JAX ``ref.py`` oracle, on seeded numpy inputs.  Every output is an
integer, so every comparison is exact.  The JAX side runs under ``jax.jit``
(one compile per shape instead of one per eager op).  The CUDA kernels
themselves run only on the GPU, where ``chip_smoke.py`` holds each against
its plain version.
"""
import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dedup_compact import kernel as jdk
from repro.kernels.dedup_compact import ref as jdref
from repro.kernels.edge_expand import kernel as jek
from repro.kernels.edge_expand import ref as jeref
from repro.kernels.sorted_lookup import kernel as jsk
from repro.kernels.sorted_lookup import ref as jsref
from repro_torch.core import backend as backend_mod
from repro_torch.kernels.dedup_compact import kernel as dk
from repro_torch.kernels.dedup_compact import ref as dref
from repro_torch.kernels.edge_expand import kernel as ek
from repro_torch.kernels.edge_expand import ref as eref
from repro_torch.kernels.sorted_lookup import kernel as sk

from test_torch_store_index_edges import one_torch_thread  # noqa: F401

I32MAX = 2**31 - 1
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jit(fn, *static, **fixed):
    """``fn`` with the keyword arguments ``fixed`` bound, jitted with the
    named arguments static."""
    return jax.jit(functools.partial(fn, **fixed), static_argnames=static)


J_RANGED = _jit(jsk.searchsorted_left_ranged, block_q=16, block_k=128,
                interpret=True)
J_RANGED_REF = _jit(jsref.searchsorted_left_ranged)
J_PLAN = _jit(jeref.plan, "tile", "cap_tiles")
J_EXPAND_REF = _jit(jeref.expand, "tile", "cap_tiles")
J_EXPAND = _jit(jek.expand, "tile", "cap_tiles", interpret=True)
J_DEDUP_REF = _jit(jdref.dedup_compact_rows, "cap")
J_DEDUP = _jit(jdk.dedup_compact_rows, "cap", block_r=2, interpret=True)
J_SORT_REF = _jit(jdref.sort_rows)
J_SORT = _jit(jdk.sort_rows, block_r=2, interpret=True)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.int32))


def _eq(torch_out, jax_out):
    assert np.array_equal(torch_out.numpy(), np.asarray(jax_out))


def test_searchsorted_left_ranged_matches_pallas_and_ref():
    rng = np.random.default_rng(0)
    blk, S = 96, 3
    keys = np.sort(rng.integers(-1000, 1000, (S, blk)), axis=1)
    keys[:, -20:] = I32MAX                          # empty index slots
    q = rng.integers(-1100, 1100, 40).astype(np.int32)
    q[:4] = [I32MAX, -2**31, keys[0, 3], keys[2, 50]]
    shard = rng.integers(0, S, q.shape[0])
    lo, hi = shard * blk, shard * blk + blk
    lo[5:8], hi[5:8] = 10, 10                       # empty windows
    hi[8:10] = lo[8:10] - 3                         # hi < lo
    args = [a.reshape(-1).astype(np.int32) for a in (keys, q, lo, hi)]
    got = sk.searchsorted_left_ranged(*map(_t, args))
    _eq(got, J_RANGED(*map(jnp.asarray, args)))
    _eq(got, J_RANGED_REF(*map(jnp.asarray, args)))
    # the ref backend's blocked probe agrees on block-aligned windows
    ok = slice(10, None)
    blocked = backend_mod.searchsorted_blocked(
        _t(args[0]), _t(args[1][ok]), _t(args[2][ok]), block=blk,
        backend=backend_mod.REF)
    assert torch.equal(blocked, got[ok])


@pytest.mark.parametrize("n_pools,cap_extra,pallas", [(4, 5, True),
                                                      (1, -3, False)])
def test_expand_matches_pallas_and_ref(n_pools, cap_extra, pallas):
    """A plan with padding tiles (against the Pallas kernel too) and a
    truncated plan (against the ref oracle)."""
    rng = np.random.default_rng(n_pools)
    F, E, tile = 24, 4096, 128
    degs = rng.integers(0, 300, F).astype(np.int32)
    degs[::5] = 0
    starts = rng.integers(0, E - 301, F).astype(np.int32)
    pools = [rng.integers(-3, 10_000, E).astype(np.int32)
             for _ in range(n_pools)]
    n_tiles = int(((degs + tile - 1) // tile).sum())
    cap_tiles = n_tiles + cap_extra                 # padding / truncation
    item, tw, n, ovf = eref.plan(_t(degs), tile, cap_tiles)
    j_item, j_tw, j_n, j_ovf = J_PLAN(jnp.asarray(degs), tile=tile,
                                      cap_tiles=cap_tiles)
    _eq(item, j_item)
    _eq(tw, j_tw)
    assert int(n) == int(j_n) and bool(ovf) == bool(j_ovf)
    got = ek.expand(_t(starts), _t(degs), [_t(p) for p in pools], item, tw,
                    tile=tile, cap_tiles=cap_tiles)
    want_r, _, _ = J_EXPAND_REF(jnp.asarray(starts), jnp.asarray(degs),
                                tuple(map(jnp.asarray, pools)), tile=tile,
                                cap_tiles=cap_tiles)
    for g, w in zip(got, want_r):
        _eq(g, w)
    if pallas:
        want_k = J_EXPAND(jnp.asarray(starts), jnp.asarray(degs),
                          tuple(map(jnp.asarray, pools)), j_item, j_tw,
                          tile=tile, cap_tiles=cap_tiles)
        for g, w in zip(got, want_k):
            _eq(g, w)


def _rows(rng, R, W):
    x = rng.integers(-2, 40, (R, W)).astype(np.int32)
    x[rng.random((R, W)) < 0.3] = I32MAX             # invalid slots
    if R > 1:
        x[1, :] = I32MAX                             # an all-PAD row
    return x


@pytest.mark.parametrize("R,W,cap,pallas", [
    (3, 37, 64, True),          # W not a power of two, cap > W, all-PAD row
    (5, 100, 16, False), (2, 1, 1, False), (4, 130, 130, False)])
def test_dedup_compact_rows_matches_pallas_and_ref(R, W, cap, pallas):
    """The plain version (the kernel's network) and the ref backend's sort
    oracle, against the JAX ref and, in the first case, the Pallas kernel."""
    rng = np.random.default_rng(R * W + cap)
    x = _rows(rng, R, W)
    got_g, got_n = dk.dedup_compact_rows(_t(x), cap)
    ref_g, ref_n = dref.dedup_compact_rows(_t(x), cap)
    wants = [J_DEDUP_REF(jnp.asarray(x), cap=cap)]
    if pallas:
        wants.append(J_DEDUP(jnp.asarray(x), cap=cap))
    for g, n in wants:
        _eq(got_g, g)
        _eq(got_n, n)
        _eq(ref_g, g)
        _eq(ref_n, n)


@pytest.mark.parametrize("R,W,pallas", [(3, 129, True), (1, 1, False)])
def test_sort_rows_matches_pallas_and_ref(R, W, pallas):
    x = _rows(np.random.default_rng(W), R, W)
    got = dk.sort_rows(_t(x))
    if pallas:
        _eq(got, J_SORT(jnp.asarray(x)))
    want = J_SORT_REF(jnp.asarray(x))
    _eq(got, want)
    _eq(dref.sort_rows(_t(x)), want)


def test_wrappers_take_cpu_or_cuda_only():
    """A wrapper runs the plain version only for CPU tensors; any other
    device must launch the CUDA kernel or raise, never fall back."""
    x = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        dk.sort_rows(x)
    with pytest.raises(ValueError):
        dk.dedup_compact_rows(x, 4)
    k = torch.zeros((8,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        sk.searchsorted_left_ranged(k, k, k, k)
    with pytest.raises(ValueError):
        dk.sort_rows(torch.zeros((2, 8), dtype=torch.int64))


def test_port_imports_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad, bad
