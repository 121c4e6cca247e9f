"""PyTorch port, kernel layer: each plain version (what a kernel wrapper runs
on CPU tensors) against the JAX Pallas kernel in interpret mode and against
the JAX ``ref.py`` oracle, on seeded numpy inputs.  Integer outputs are
compared exactly; ``knn_topk``'s distances follow the port's own summation
order, so they agree with JAX's to rounding (the tolerance in
:func:`assert_knn_close`).  The JAX side runs under ``jax.jit`` (one compile
per shape instead of one per eager op).  The CUDA kernels themselves run
only on the GPU, where ``chip_smoke.py`` holds each against its plain
version.
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
from repro.kernels.knn_topk import kernel as jkk
from repro.kernels.knn_topk import ref as jkref
from repro.kernels.sorted_lookup import kernel as jsk
from repro.kernels.sorted_lookup import ref as jsref
from repro_torch.core import backend as backend_mod
from repro_torch.kernels.dedup_compact import kernel as dk
from repro_torch.kernels.dedup_compact import ref as dref
from repro_torch.kernels.edge_expand import kernel as ek
from repro_torch.kernels.edge_expand import ref as eref
from repro_torch.kernels.knn_topk import kernel as kk
from repro_torch.kernels.knn_topk import ref as kref
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
J_LEFT = _jit(jsk.searchsorted_left, block_q=16, block_k=128, interpret=True)
J_LEFT_REF = _jit(jsref.searchsorted_left)
J_PLAN = _jit(jeref.plan, "tile", "cap_tiles")
J_EXPAND_REF = _jit(jeref.expand, "tile", "cap_tiles")
J_EXPAND = _jit(jek.expand, "tile", "cap_tiles", interpret=True)
J_DEDUP_REF = _jit(jdref.dedup_compact_rows, "cap")
J_DEDUP = _jit(jdk.dedup_compact_rows, "cap", block_r=2, interpret=True)
J_SORT_REF = _jit(jdref.sort_rows)
J_SORT = _jit(jdk.sort_rows, block_r=2, interpret=True)
J_PAIRS_REF = _jit(jdref.sort_pairs)
J_PAIRS = _jit(jdk.sort_pairs, interpret=True)
J_KNN_REF = _jit(jkref.knn_topk, "k")
J_KNN = _jit(jkk.knn_topk, "k", interpret=True)


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


@pytest.mark.parametrize("n,q", [(300, 40), (1, 1), (129, 7)])
def test_searchsorted_left_matches_pallas_and_ref(n, q):
    """The flat probe: a sorted block with duplicates and INT32_MAX pads
    (empty index slots), queries below, above and equal to keys, INT32_MAX
    queries; N not a power of two, N = 1, Q = 1."""
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(-1000, 1000, n))
    keys[n // 2:n // 2 + n // 5] = keys[n // 2]            # duplicates
    keys = np.sort(keys)
    keys[n - n // 7:] = I32MAX                              # pads
    qs = rng.integers(-1100, 1100, q)
    qs[:4] = [I32MAX, -2**31, keys[0], keys[-1]][:q]
    k, qq = (a.astype(np.int32) for a in (keys, qs))
    got = sk.searchsorted_left(_t(k), _t(qq))
    _eq(got, J_LEFT(jnp.asarray(k), jnp.asarray(qq)))
    _eq(got, J_LEFT_REF(jnp.asarray(k), jnp.asarray(qq)))
    assert torch.equal(got, backend_mod.searchsorted(
        _t(k), _t(qq), backend=backend_mod.REF))


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


@pytest.mark.parametrize("W,pallas", [(300, True), (1, False),
                                      (4099, False)])
def test_sort_pairs_matches_pallas_and_ref(W, pallas):
    """Pairs with repeats, ghosts (R, PAD) and the int32 extremes: the
    plain version (the kernel's radix passes over packed keys) and the ref
    backend's library sort, against the JAX ref and the Pallas kernel."""
    rng = np.random.default_rng(W)
    k1 = rng.integers(-3, 9, W).astype(np.int32)
    k2 = rng.integers(-2**31, I32MAX, W, endpoint=True).astype(np.int32)
    k2[::3] = rng.integers(0, 5, k2[::3].shape[0])
    ghost = rng.random(W) < 0.3
    k1[ghost], k2[ghost] = 9, I32MAX
    k1[:2], k2[:2] = [-2**31, I32MAX][:W], [I32MAX, -2**31][:W]
    got = dk.sort_pairs(_t(k1), _t(k2))
    wants = [J_PAIRS_REF(jnp.asarray(k1), jnp.asarray(k2))]
    if pallas:
        wants.append(J_PAIRS(jnp.asarray(k1), jnp.asarray(k2)))
    for w in wants:
        for g, r, x in zip(got, dref.sort_pairs(_t(k1), _t(k2)), w):
            _eq(g, x)
            _eq(r, x)


def _knn_inputs(R, N, D, seed, n_types=3, ts_hi=10):
    """``tests/test_kernels.py``'s generator (duplicate gids, empty slots,
    mixed types and MVCC intervals)."""
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(R, D)).astype(np.float32)
    emb = rng.normal(size=(N, D)).astype(np.float32)
    gid = rng.integers(0, 4 * N, N).astype(np.int32)
    gid[rng.random(N) < 0.2] = -1
    vtype = rng.integers(0, n_types, N).astype(np.int32)
    create = rng.integers(0, ts_hi, N).astype(np.int32)
    delete = np.where(rng.random(N) < 0.3, create + rng.integers(1, ts_hi, N),
                      I32MAX).astype(np.int32)
    q_vt = rng.integers(0, n_types, R).astype(np.int32)
    q_ts = rng.integers(0, ts_hi, R).astype(np.int32)
    return vecs, emb, gid, vtype, create, delete, q_vt, q_ts


def assert_knn_close(got, want):
    """ROADMAP queue 3's rule: the same empty slots; distances within
    rtol=1e-5, atol=1e-4; gids equal except where the two entries swapped
    are within rtol=1e-5, atol=1e-5 of each other."""
    gd, gg = (np.asarray(x) for x in got)
    wd, wg = (np.asarray(x) for x in want)
    empty = np.isinf(wd)
    assert np.array_equal(np.isinf(gd), empty)
    assert np.array_equal(gg[empty], wg[empty])
    np.testing.assert_allclose(gd[~empty], wd[~empty], rtol=1e-5, atol=1e-4)
    swap = gg != wg
    assert np.allclose(gd[swap], wd[swap], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("R,N,D,k,seed,pallas", [
    (1, 83, 12, 15, 4, True),           # the pinned case of queue 3
    (4, 37, 5, 8, 1, False), (3, 5, 4, 16, 2, False),     # k > N: padding
    (70, 300, 8, 1, 3, False),          # rows past one row tile, k = 1
    (1, 700, 32, 8, 5, False)])         # one row: warps over entries
def test_knn_topk_matches_pallas_and_ref(R, N, D, k, seed, pallas):
    args = _knn_inputs(R, N, D, seed)
    got = kk.knn_topk(*map(torch.as_tensor, args), k)
    wants = [J_KNN_REF(*map(jnp.asarray, args), k=k)]
    if pallas:
        wants.append(J_KNN(*map(jnp.asarray, args), k=k))
    for want in wants:
        assert_knn_close(got, want)
    # the ref backend runs the same plain version
    ref = kref.knn_topk(*map(torch.as_tensor, args), k)
    assert torch.equal(ref[0].view(torch.int32), got[0].view(torch.int32))
    assert torch.equal(ref[1], got[1])


_PLAN_CASES = [(64, 4_194_304, 32, 8), (1, 1, 1, 1), (128, 100_003, 32, 4096),
               (3, 0, 4, 2)]
_PLAN_CASES += [(R, N, D, k) for R in (1, 8, 64, 130)
                for k in (1, 8, 32, 33, 4096)
                for N, D in ((4_194_304, 32), (100_003, 12), (1, 4), (0, 8))
                if (R, N, D, k) not in _PLAN_CASES]


@pytest.mark.parametrize("R,N,D,k", _PLAN_CASES)
def test_knn_plan_covers_the_index(R, N, D, k):
    """The kernel's cut of a call: k <= 32 takes the warp-held lists (8
    rows a warp, a list a row a warp over entries; the warps over rows
    follow R), larger k the shared-memory lists (1 row a warp, a list a row
    a chunk); chunks of whole tiles cover the index in about one wave of
    blocks; shared memory and the merge's lists fit."""
    pl = kk.plan(R, N, D, k)
    warp = k <= kk.WARP_K
    we = kk.WARPS // pl["wr"]
    assert pl["route"] == ("warp" if warp else "shared")
    assert pl["rw"] == (8 if warp else 1)
    assert pl["te"] == 32 * pl["et"] * we
    assert pl["rows"] == pl["wr"] * pl["rw"]
    assert pl["lists"] == (we if warp else 1)
    if warp:       # few rows spread the warps over entries, many over rows
        assert pl["rows"] >= min(R, 64) and (R > 8 or pl["wr"] == 1)
        assert pl["et"] * we == max(4, we)
    assert pl["chunk"] % pl["te"] == 0
    assert pl["n_chunks"] * pl["chunk"] >= N > (pl["n_chunks"] - 1) * \
        pl["chunk"] or N == pl["n_chunks"] == 0
    blocks = pl["n_chunks"] * -(-R // pl["rows"])   # one wave
    target = kk.target_blocks(pl["smem"])
    assert kk.SMS <= target <= kk.SMS * kk.MAX_BLOCKS_SM
    assert blocks <= target + -(-R // pl["rows"])
    if N >= 1_000_000:
        assert blocks >= target // 2
    assert pl["n_lists"] == pl["n_chunks"] * pl["lists"]
    assert pl["smem"] == kk.chunk_smem(D, k, pl["wr"]) <= kk.SMEM_MAX
    assert pl["kp"] >= k and pl["group"] >= 2
    assert 8 * pl["group"] * pl["kp"] <= kk.SMEM_MAX
    with pytest.raises(ValueError):
        kk.plan(R, N, D, kk.MAX_K + 1)


def test_knn_python_mirrors_the_source():
    """The plan's copies of the kernel's constants and its shared-memory
    count agree with ``csrc/knn_topk.cu``."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / "knn_topk.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert kk.WARPS == const("kThreads") // 32
    assert kk.STAGES == const("kStages")
    assert kk.WARP_K == const("kWarpK")
    body = re.search(r"long long chunk_smem\(.*?\n}", src, re.S).group(0)
    assert "4 * rows * D4 + kStages * te * (4LL * DS + 16)" in body
    assert "rows * (8LL * m + 12)) + 8 * rows" in body
    assert "__launch_bounds__(kThreads, 2)\n    knn_chunk_kernel" in src
    assert kk.MAX_BLOCKS_SM == 2


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
    with pytest.raises(ValueError):
        dk.sort_pairs(k, k)
    v = torch.zeros((2, 4), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        kk.knn_topk(v, v, k[:2], k[:2], k[:2], k[:2], k[:2], k[:2], 1)


def test_port_imports_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    pkg = ROOT / "src" / "repro_torch"
    for sub in ("configs", "data", "models", "kernels/rmsnorm",
                "kernels/flash_attention"):
        assert any(f.parent == pkg / sub for f in files), sub
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad, bad
