"""PyTorch port, the tensor-core flash kernels (bf16 ``flash_fwd``,
``flash_bwd_dkv`` and ``flash_bwd_dq``, ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``) as far as the CPU can check them.  Their tile loops,
mirrored in Python (``kv_tiles`` and ``q_tiles`` at these kernels' block
sizes, ``tile_class``), against the oracle's mask; and their arithmetic,
emulated here in plain torch step by step as the kernels run it (the
online softmax in exp2 units over each warp's key steps, p and ds rounded
to bf16 before the products),
against ``chip_smoke.py``'s rounding-matched plain versions within its bf16
tolerance (one ulp plus a bound of about one ulp), while a result with one
step left out falls outside it, also at a window of 4,096 keys; and against
the JAX kernels in interpret mode within the rounding of p and ds.  The
CUDA kernels run only on the GPU, where ``chip_smoke.py`` holds them to the
same tolerance.
"""
import functools
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jfk
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ref as fref

from test_torch_store_index_edges import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOG2E = math.log2(math.e)

J_FLASH = jax.jit(functools.partial(jfk.flash_fwd, block_q=64, block_k=64,
                                    interpret=True),
                  static_argnames=("causal", "window", "scale", "q_offset"))
J_FLASH_BWD = jax.jit(functools.partial(jfk.flash_bwd, block_q=64,
                                        block_k=64, interpret=True),
                      static_argnames=("causal", "window", "scale",
                                       "q_offset"))


@pytest.fixture(scope="module")
def cs():
    """chip_smoke.py, for its bf16 tolerance (``_close``, ``_reference``,
    the rounding-matched plain versions)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the tile loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Sq,Sk,q_offset,causal,window", [
    (32768, 32768, 0, True, 4096),    # the main path
    (4096, 4096, 0, True, 128),
    (64, 4096, 4032, True, 4096),
    (300, 1000, 700, True, 0),
    (200, 200, 0, False, 50),
    (130, 130, 0, False, 0),
])
def test_flash_tc_fwd_tiles_cover_the_mask(Sq, Sk, q_offset, causal,
                                           window):
    """flash_fwd_tc_kernel's loops: a q block of TC_BQ rows visits
    ``kv_tiles(bk=TC_BK)`` (at most ceil((window + TC_BQ - 1) / TC_BK) + 1
    under a causal window), every live key of its rows lies in a visited
    tile, and each warp's 32 rows class each visited tile exactly: SKIP
    where no pair is live, FULL where every pair is (whole rows and keys),
    MASKED otherwise."""
    _check_kv_tiles(Sq, Sk, q_offset, causal, window, fk.TC_BQ, fk.TC_BK,
                    fk.TC_WARP_ROWS)


@pytest.mark.parametrize("Sq,Sk,q_offset,causal,window", [
    (4096, 4096, 0, True, 4096),      # the training path
    (300, 1000, 700, True, 0),
    (200, 200, 0, False, 50),
    (10, 20, 20, False, 8),
])
def test_flash_tc_dq_tiles_cover_the_mask(Sq, Sk, q_offset, causal,
                                          window):
    """flash_bwd_dq_tc_kernel's loops: the same, for its q blocks of DQ_BQ
    rows, DQ_BK-key tiles and warps of DQ_WARP_ROWS rows."""
    _check_kv_tiles(Sq, Sk, q_offset, causal, window, fk.DQ_BQ, fk.DQ_BK,
                    fk.DQ_WARP_ROWS)


def _check_kv_tiles(Sq, Sk, q_offset, causal, window, BQ, BK, W):
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    bound = -(-(window + BQ - 1) // BK) + 1
    width = -(-Sk // BK) * BK
    for q0 in range(0, Sq, BQ):
        rows = min(BQ, Sq - q0)
        tiles = fk.kv_tiles(q0, rows, Sk, bk=BK, **kw)
        if causal and window > 0:
            assert len(tiles) <= bound
        m = np.zeros((BQ, width), bool)
        m[:rows, :Sk] = fref.attention_mask(
            rows, Sk, causal=causal, window=window,
            q_offset=q_offset + q0).numpy()
        a, b = tiles.start * BK, tiles.stop * BK
        assert not m[:, :a].any() and not m[:, b:].any()
        blk = m[:, a:b].reshape(BQ // W, W, len(tiles), BK)
        live_any, live_all = blk.any((1, 3)), blk.all((1, 3))
        for w in range(BQ // W):
            for i, t in enumerate(tiles):
                cls = fk.tile_class(q0 + w * W, W, Sq, t * BK, BK, Sk, **kw)
                assert live_any[w, i] == (cls != fk.SKIP), (q0, w, t)
                assert live_all[w, i] == (cls == fk.FULL), (q0, w, t)


@pytest.mark.parametrize("Sq,Sk,q_offset,causal,window", [
    (4096, 4096, 0, True, 4096),      # the training path
    (4096, 4096, 0, True, 128),
    (64, 4096, 4032, True, 4096),
    (300, 1000, 700, True, 0),
    (200, 200, 0, False, 50),
    (130, 130, 0, False, 0),
    (10, 20, 20, False, 8),
])
def test_flash_tc_dkv_tiles_cover_the_mask(Sq, Sk, q_offset, causal,
                                           window):
    """flash_bwd_dkv_tc_kernel's loops: a block of DKV_BK keys visits
    ``q_tiles(bq=DKV_BQ)`` (at most ceil((window + DKV_BK - 1) / DKV_BQ) + 1
    under a causal window), every row that sees one of its keys lies in a
    visited tile, and each warp's 16 keys class each visited tile
    exactly."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    BK, BQ, W = fk.DKV_BK, fk.DKV_BQ, fk.DKV_WARP_KEYS
    bound = -(-(window + BK - 1) // BQ) + 1
    m = np.zeros((-(-Sq // BQ) * BQ, -(-Sk // BK) * BK), bool)
    m[:Sq, :Sk] = fref.attention_mask(Sq, Sk, **kw).numpy()
    for k0 in range(0, Sk, BK):
        tiles = fk.q_tiles(k0, min(BK, Sk - k0), Sq, bq=BQ, **kw)
        if causal and window > 0:
            assert len(tiles) <= bound
        sub = m[:, k0:k0 + BK]
        a, b = tiles.start * BQ, tiles.stop * BQ
        assert not sub[:a].any() and not sub[b:].any()
        blk = sub[a:b].reshape(len(tiles), BQ, BK // W, W)
        live_any, live_all = blk.any((1, 3)), blk.all((1, 3))
        for i, t in enumerate(tiles):
            for w in range(BK // W):
                cls = fk.tile_class(t * BQ, BQ, Sq, k0 + w * W, W, Sk, **kw)
                assert live_any[i, w] == (cls != fk.SKIP), (k0, w, t)
                assert live_all[i, w] == (cls == fk.FULL), (k0, w, t)


# ---------------------------------------------------------------------------
# the rounding: the kernels' arithmetic emulated in plain torch
# ---------------------------------------------------------------------------

def _emulate_fwd(q, k, v, *, causal, window, scale, q_offset=0, drop=None):
    """flash_fwd_tc_kernel's arithmetic: per warp of TC_WARP_ROWS rows, over
    the block's kv tiles by class (a FULL tile in one step at D <= 120,
    else in two 32-key steps), the online softmax in log2 units (running
    max, alpha, l summed from the f32 p) and O += bf16(p) V in f32.
    ``drop``: a (warp's first row, kv tile) tile left out."""
    BHq, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    G = BHq // BHkv
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    c = scale * LOG2E
    wr = fk.TC_WARP_ROWS
    qf = q.float().view(BHkv, G, Sq, D)
    kf, vf = k.float()[:, None], v.float()[:, None]
    out = torch.zeros((BHkv, G, Sq, D))
    lse = torch.zeros((BHkv, G, Sq))
    for q0 in range(0, Sq, fk.TC_BQ):
        rows = min(fk.TC_BQ, Sq - q0)
        tiles = fk.kv_tiles(q0, rows, Sk, bk=fk.TC_BK, **kw)
        for r0 in range(q0, q0 + rows, wr):
            nr = min(wr, Sq - r0)
            m = torch.full((BHkv, G, nr), -1e30)
            l = torch.zeros((BHkv, G, nr))
            acc = torch.zeros((BHkv, G, nr, D))
            for t in tiles:
                k0 = t * fk.TC_BK
                cls = fk.tile_class(r0, wr, Sq, k0, fk.TC_BK, Sk, **kw)
                if cls == fk.SKIP or (r0, t) == drop:
                    continue
                half = cls == fk.MASKED or D > 120
                for ks in ((k0, k0 + 32) if half else (k0,)):
                    nk = min(32 if half else fk.TC_BK, Sk - ks)
                    if nk <= 0:
                        continue
                    s = qf[:, :, r0:r0 + nr] @ \
                        kf[:, :, ks:ks + nk].transpose(-1, -2) * c
                    live = torch.ones((nr, nk), dtype=torch.bool) \
                        if cls == fk.FULL else fref.attention_mask(
                            nr, nk, causal=causal, window=window,
                            q_offset=q_offset + r0 - ks)
                    mx = torch.maximum(m, torch.where(live, s, -math.inf)
                                       .amax(-1))
                    p = torch.where(live, torch.exp2(s - mx[..., None]), 0.0)
                    al = torch.exp2(m - mx)
                    l = l * al + p.sum(-1)
                    acc = acc * al[..., None] + \
                        p.bfloat16().float() @ vf[:, :, ks:ks + nk]
                    m = mx
            lc = torch.clamp(l, min=1e-30)
            out[:, :, r0:r0 + nr] = acc / lc[..., None]
            lse[:, :, r0:r0 + nr] = torch.where(
                l > 0, m * math.log(2.0), -1e30) + torch.log(lc)
    return out.view(BHq, Sq, D).to(q.dtype), lse.view(BHq, Sq)


def _emulate_dkv(q, k, v, do, lse, delta, *, causal, window, scale,
                 q_offset=0, drop=None, blocks=None):
    """flash_bwd_dkv_tc_kernel's arithmetic: per warp of 16 keys, over the
    G q heads and the block's q tiles by class, p = exp2(s c - lse log2 e)
    and ds = p (dp - delta) scale in f32, dV += bf16(p)^T dout and
    dK += bf16(ds)^T q in f32.  ``drop``: a (warp's first key, q head,
    q tile) step left out; ``blocks``: the first keys of the key blocks to
    run (the rest stay 0), every block if None."""
    BHq, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    G = BHq // BHkv
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    c = scale * LOG2E
    wk = fk.DKV_WARP_KEYS
    qg, og = q.float().view(BHkv, G, Sq, D), do.float().view(BHkv, G, Sq, D)
    lg, dg = lse.view(BHkv, G, Sq) * LOG2E, delta.view(BHkv, G, Sq)
    kf, vf = k.float(), v.float()
    dk = torch.zeros((BHkv, Sk, D))
    dv = torch.zeros((BHkv, Sk, D))
    for k0 in (range(0, Sk, fk.DKV_BK) if blocks is None else blocks):
        nk = min(fk.DKV_BK, Sk - k0)
        tiles = fk.q_tiles(k0, nk, Sq, bq=fk.DKV_BQ, **kw)
        for w0 in range(k0, k0 + nk, wk):
            nw = min(wk, Sk - w0)
            kk, vv = kf[:, w0:w0 + nw], vf[:, w0:w0 + nw]
            for g in range(G):
                for t in tiles:
                    q0 = t * fk.DKV_BQ
                    nq = min(fk.DKV_BQ, Sq - q0)
                    cls = fk.tile_class(q0, fk.DKV_BQ, Sq, w0, wk, Sk, **kw)
                    if cls == fk.SKIP or (w0, g, t) == drop:
                        continue
                    qq, oo = qg[:, g, q0:q0 + nq], og[:, g, q0:q0 + nq]
                    st = kk @ qq.transpose(-1, -2)
                    dpt = vv @ oo.transpose(-1, -2)
                    live = torch.ones((nw, nq), dtype=torch.bool) \
                        if cls == fk.FULL else fref.attention_mask(
                            nq, nw, causal=causal, window=window,
                            q_offset=q_offset + q0 - w0).T
                    p = torch.where(live, torch.exp2(
                        st * c - lg[:, g, None, q0:q0 + nq]), 0.0)
                    ds = p * (dpt - dg[:, g, None, q0:q0 + nq]) * scale
                    dv[:, w0:w0 + nw] += p.bfloat16().float() @ oo
                    dk[:, w0:w0 + nw] += ds.bfloat16().float() @ qq
    return dk.to(k.dtype), dv.to(v.dtype)


def _emulate_dq(q, k, v, do, lse, delta, *, causal, window, scale,
                q_offset=0, drop=None):
    """flash_bwd_dq_tc_kernel's arithmetic: per warp of DQ_WARP_ROWS rows,
    over its block's kv tiles by class, p = exp2(s c - lse log2 e) and
    ds = p (dp - delta) scale in f32, dQ += bf16(ds) k in f32.  ``drop``: a
    (warp's first row, kv tile) step left out."""
    BHq, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    G = BHq // BHkv
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    c = scale * LOG2E
    wr = fk.DQ_WARP_ROWS
    qg, og = q.float().view(BHkv, G, Sq, D), do.float().view(BHkv, G, Sq, D)
    lg = lse.view(BHkv, G, Sq, 1) * LOG2E
    dg = delta.view(BHkv, G, Sq, 1)
    kf, vf = k.float()[:, None], v.float()[:, None]
    dq = torch.zeros((BHkv, G, Sq, D))
    for q0 in range(0, Sq, fk.DQ_BQ):
        tiles = fk.kv_tiles(q0, min(fk.DQ_BQ, Sq - q0), Sk, bk=fk.DQ_BK,
                            **kw)
        for r0 in range(q0, min(Sq, q0 + fk.DQ_BQ), wr):
            rs = slice(r0, min(Sq, r0 + wr))
            nr = rs.stop - r0
            for t in tiles:
                k0 = t * fk.DQ_BK
                cls = fk.tile_class(r0, wr, Sq, k0, fk.DQ_BK, Sk, **kw)
                if cls == fk.SKIP or (r0, t) == drop:
                    continue
                ks = slice(k0, min(Sk, k0 + fk.DQ_BK))
                nk = ks.stop - k0
                live = torch.ones((nr, nk), dtype=torch.bool) \
                    if cls == fk.FULL else fref.attention_mask(
                        nr, nk, causal=causal, window=window,
                        q_offset=q_offset + r0 - k0)
                s = qg[:, :, rs] @ kf[:, :, ks].transpose(-1, -2)
                dp = og[:, :, rs] @ vf[:, :, ks].transpose(-1, -2)
                p = torch.where(live, torch.exp2(s * c - lg[:, :, rs]), 0.0)
                ds = p * (dp - dg[:, :, rs]) * scale
                dq[:, :, rs] += ds.bfloat16().float() @ kf[:, :, ks]
    return dq.view(BHq, Sq, D).to(q.dtype)


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16()


# (BHkv, G, Sq, Sk, D, causal, window, q_offset)
ROUNDING_CASES = [
    (2, 2, 300, 300, 24, True, 100, 0),     # window edges, ragged tails
    (1, 4, 100, 400, 32, True, 0, 300),     # q_offset, Sq < a q block
    (2, 1, 150, 150, 17, False, 40, 0),     # odd D, window, not causal
    (1, 2, 10, 20, 8, False, 5, 20),        # rows that see no key
    (1, 2, 200, 200, 128, True, 0, 0),      # D 128: every tile in halves
]


def _fwd_drop(Sq, Sk, kw, q0=None):
    """The first (warp, tile) step of the q block at ``q0`` (the last if
    None) whose rows see a key."""
    q0 = (Sq - 1) // fk.TC_BQ * fk.TC_BQ if q0 is None else q0
    tiles = fk.kv_tiles(q0, min(fk.TC_BQ, Sq - q0), Sk, bk=fk.TC_BK, **kw)
    wr = fk.TC_WARP_ROWS
    return next((r0, t) for r0 in range(q0, min(Sq, q0 + fk.TC_BQ), wr)
                for t in tiles
                if fk.tile_class(r0, wr, Sq, t * fk.TC_BK, fk.TC_BK, Sk,
                                 **kw) != fk.SKIP)


def _dkv_drop(Sq, Sk, kw, k0=0, tile=None):
    """The first (warp, head 0, q tile) step of the key block at ``k0`` (at
    q tile ``tile`` if given) whose keys are seen."""
    tiles = fk.q_tiles(k0, min(fk.DKV_BK, Sk - k0), Sq, bq=fk.DKV_BQ, **kw)
    wk = fk.DKV_WARP_KEYS
    return next((w0, 0, t) for w0 in range(k0, min(Sk, k0 + fk.DKV_BK), wk)
                for t in tiles if tile in (None, t) and
                fk.tile_class(t * fk.DKV_BQ, fk.DKV_BQ, Sq, w0, wk, Sk,
                              **kw) != fk.SKIP)


def _dq_drop(Sq, Sk, kw):
    """The first (warp, kv tile) step of the last q block whose rows see a
    key."""
    q0 = (Sq - 1) // fk.DQ_BQ * fk.DQ_BQ
    tiles = fk.kv_tiles(q0, min(fk.DQ_BQ, Sq - q0), Sk, bk=fk.DQ_BK, **kw)
    wr = fk.DQ_WARP_ROWS
    return next((r0, t) for r0 in range(q0, min(Sq, q0 + fk.DQ_BQ), wr)
                for t in tiles
                if fk.tile_class(r0, wr, Sq, t * fk.DQ_BK, fk.DQ_BK, Sk,
                                 **kw) != fk.SKIP)


def _share(cs, got, want, bound):
    """The largest error of ``got`` as a share of its "tc" tolerance (one
    bf16 ulp plus ``bound``): above 1 where it falls outside."""
    cs.TC_SHARE.pop("share", None)
    try:
        cs._close(got, want, "share", "tc", bound)
    except AssertionError:
        pass
    return cs.TC_SHARE["share"]


def _fails(cs, got, want, tols, bounds):
    """Whether some output of ``got`` falls outside its tolerance."""
    try:
        for g, w, t, b in zip(got, want, tols, bounds):
            cs._close(g, w, "dropped", t, b)
    except AssertionError:
        return True
    return False


def _dkv_inputs(rng, BHkv, G, Sq, Sk, D, kw):
    q, do = (_bf16(rng, (BHkv * G, Sq, D)) for _ in range(2))
    k, v = (_bf16(rng, (BHkv, Sk, D)) for _ in range(2))
    o, lse = fk.flash_fwd_plain(q, k, v, **kw)
    delta = torch.sum(o.float() * do.float(), dim=-1)
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("BHkv,G,Sq,Sk,D,causal,window,qo", ROUNDING_CASES)
def test_flash_tc_fwd_rounding_within_tolerance(cs, BHkv, G, Sq, Sk, D,
                                                causal, window, qo):
    """The emulated kernel against chip_smoke's rounding-matched plain
    version: out within one bf16 ulp plus its bound, lse within 1e-5; with
    one visited (warp, tile) step dropped, out falls outside."""
    rng = np.random.default_rng(Sq + D)
    q, k, v = (_bf16(rng, s) for s in ((BHkv * G, Sq, D), (BHkv, Sk, D),
                                       (BHkv, Sk, D)))
    kw = dict(causal=causal, window=window, scale=D ** -0.5, q_offset=qo)
    want, bounds = cs._reference("flash_fwd", fk.flash_fwd_plain, (q, k, v),
                                 kw)
    tol = cs.FLOAT_TOL["flash_fwd"]["bfloat16"]
    for g, w, t, b, name in zip(_emulate_fwd(q, k, v, **kw), want, tol,
                                bounds, ("out", "lse")):
        cs._close(g, w, f"emulated flash_fwd {name}", t, b)
    drop = _fwd_drop(Sq, Sk, dict(causal=causal, window=window,
                                  q_offset=qo))
    dropped = _emulate_fwd(q, k, v, drop=drop, **kw)
    assert _fails(cs, dropped[:1], want[:1], tol, bounds)


@pytest.mark.parametrize("BHkv,G,Sq,Sk,D,causal,window,qo", ROUNDING_CASES)
def test_flash_tc_dkv_rounding_within_tolerance(cs, BHkv, G, Sq, Sk, D,
                                                causal, window, qo):
    """The emulated dK/dV kernel against chip_smoke's rounding-matched
    plain version, from the plain forward's lse and delta: dk and dv within
    one bf16 ulp plus their bounds; with one (warp, q head, q tile) step
    dropped, dk or dv falls outside."""
    rng = np.random.default_rng(Sk + D)
    kw = dict(causal=causal, window=window, scale=D ** -0.5, q_offset=qo)
    args = _dkv_inputs(rng, BHkv, G, Sq, Sk, D, kw)
    want, bounds = cs._reference("flash_bwd_dkv", fk.flash_bwd_dkv_plain,
                                 args, kw)
    tol = cs.FLOAT_TOL["flash_bwd_dkv"]["bfloat16"]
    for g, w, t, b, name in zip(_emulate_dkv(*args, **kw), want, tol,
                                bounds, ("dk", "dv")):
        cs._close(g, w, f"emulated flash_bwd_dkv {name}", t, b)
    drop = _dkv_drop(Sq, Sk, dict(causal=causal, window=window,
                                  q_offset=qo))
    assert _fails(cs, _emulate_dkv(*args, drop=drop, **kw), want, tol,
                  bounds)


@pytest.mark.parametrize("BHkv,G,Sq,Sk,D,causal,window,qo", ROUNDING_CASES)
def test_flash_tc_dq_rounding_within_tolerance(cs, BHkv, G, Sq, Sk, D,
                                               causal, window, qo):
    """The emulated dQ kernel against chip_smoke's rounding-matched plain
    version, from the plain forward's lse and delta: dq within one bf16 ulp
    plus its bound; with one (warp, kv tile) step dropped, dq falls
    outside."""
    rng = np.random.default_rng(Sq + Sk + D)
    kw = dict(causal=causal, window=window, scale=D ** -0.5, q_offset=qo)
    args = _dkv_inputs(rng, BHkv, G, Sq, Sk, D, kw)
    (want,), (bound,) = cs._reference("flash_bwd_dq", fk.flash_bwd_dq_plain,
                                      args, kw)
    tol = cs.FLOAT_TOL["flash_bwd_dq"]["bfloat16"]
    cs._close(_emulate_dq(*args, **kw), want, "emulated flash_bwd_dq",
              tol[0], bound)
    drop = _dq_drop(Sq, Sk, dict(causal=causal, window=window,
                                 q_offset=qo))
    assert _fails(cs, [_emulate_dq(*args, drop=drop, **kw)], [want], tol,
                  [bound])


@pytest.mark.parametrize("tile", [2, 33, 63])
def test_flash_tc_fwd_drop_at_window_4096(cs, tile):
    """At the main path's window of 4,096 keys (64 rows that each see 4,096
    keys, 66 tiles): the emulated kernel stays within the tolerance, and
    leaving out one tile of one warp, far from the diagonal, fails it."""
    rng = np.random.default_rng(4096)
    D, Sk = 120, 4160
    q = _bf16(rng, (1, 64, D))
    k, v = (_bf16(rng, (1, Sk, D)) for _ in range(2))
    kw = dict(causal=True, window=4096, scale=D ** -0.5, q_offset=4096)
    want, bounds = cs._reference("flash_fwd", fk.flash_fwd_plain, (q, k, v),
                                 kw)
    tol = cs.FLOAT_TOL["flash_fwd"]["bfloat16"]
    for g, w, t, b in zip(_emulate_fwd(q, k, v, **kw), want, tol, bounds):
        cs._close(g, w, "emulated flash_fwd at window 4096", t, b)
    dropped = _emulate_fwd(q, k, v, drop=(0, tile), **kw)
    assert _fails(cs, dropped[:1], want[:1], tol, bounds)


@pytest.mark.parametrize("tile", [33, 48, 64])
def test_flash_tc_dkv_drop_at_window_4096(cs, tile):
    """At train_4k's reach (4,160 rows under a causal window of 4,096): the
    keys of block 2048, seen by 33 q tiles, stay within the tolerance in the
    emulated kernel, and leaving out one q tile of one warp fails it."""
    rng = np.random.default_rng(4097)
    D, S, k0 = 120, 4160, 2048
    kw = dict(causal=True, window=4096, scale=D ** -0.5, q_offset=0)
    args = _dkv_inputs(rng, 1, 1, S, S, D, kw)
    want, bounds = cs._reference("flash_bwd_dkv", fk.flash_bwd_dkv_plain,
                                 args, kw)
    rows = slice(k0, k0 + fk.DKV_BK)
    want, bounds = [t[:, rows] for t in want], [t[:, rows] for t in bounds]
    tol = cs.FLOAT_TOL["flash_bwd_dkv"]["bfloat16"]
    got = _emulate_dkv(*args, blocks=[k0], **kw)
    for g, w, t, b in zip(got, want, tol, bounds):
        cs._close(g[:, rows], w, "emulated flash_bwd_dkv at window 4096", t,
                  b)
    drop = _dkv_drop(S, S, dict(causal=True, window=4096, q_offset=0),
                     k0=k0, tile=tile)
    dropped = _emulate_dkv(*args, drop=drop, blocks=[k0], **kw)
    assert _fails(cs, [t[:, rows] for t in dropped], want, tol, bounds)


@pytest.mark.parametrize("tile", [2, 33, 63])
def test_flash_tc_dq_drop_at_window_4096(cs, tile):
    """At train_4k's reach (64 rows that each see 4,096 keys under a causal
    window of 4,096, 65 tiles): the emulated dQ kernel stays within the
    tolerance, and leaving out one tile of one warp, far from the
    diagonal, fails it by at least 10x."""
    rng = np.random.default_rng(4098)
    D, Sk = 120, 4160
    kw = dict(causal=True, window=4096, scale=D ** -0.5, q_offset=4096)
    args = _dkv_inputs(rng, 1, 1, 64, Sk, D, kw)
    (want,), (bound,) = cs._reference("flash_bwd_dq", fk.flash_bwd_dq_plain,
                                      args, kw)
    assert _share(cs, _emulate_dq(*args, **kw), want, bound) <= 1
    assert _share(cs, _emulate_dq(*args, drop=(0, tile), **kw), want,
                  bound) >= 10


def test_flash_tc_rounding_matches_jax(cs):
    """The emulated kernels against the JAX kernels (interpret mode) on the
    same bf16 inputs: the JAX kernels multiply p and ds in f32, so out, dk,
    dv and dq may differ by the rounding of those operands, 2**-8 of the
    sum of the terms' magnitudes (sum p |v| / l, sum |ds| |q|, sum p
    |dout|, sum |ds| |k|), plus one bf16 ulp; lse within 1e-5."""
    rng = np.random.default_rng(5)
    BHkv, G, S, D = 2, 2, 256, 32
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (BHkv * G, S, D), (BHkv, S, D), (BHkv, S, D), (BHkv * G, S, D)))
    j = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do)]
    t = [torch.from_numpy(a).bfloat16() for a in (q, k, v, do)]
    kw = dict(causal=True, window=96, scale=D ** -0.5, q_offset=0)
    unit = 2.0 ** -8 + cs.SUM_REL
    jout, jlse = J_FLASH(*j[:3], **kw)
    out, lse = _emulate_fwd(*t[:3], **kw)
    terms = fk.flash_fwd_plain(*(x.float() for x in t[:2]),
                               t[2].float().abs(), **kw)[0]
    cs._close(out, torch.from_numpy(np.array(jout.astype(jnp.float32)))
              .bfloat16(), "emulated flash_fwd out vs JAX", "tc",
              unit * terms)
    cs._close(lse, torch.from_numpy(np.array(jlse)),
              "emulated flash_fwd lse vs JAX", (1e-5, 1e-5))
    jl = torch.from_numpy(np.array(jlse))
    jo = torch.from_numpy(np.array(jout.astype(jnp.float32)))
    delta = torch.sum(jo * t[3].float(), dim=-1)
    jdq, jdk, jdv = J_FLASH_BWD(*j[:3], jout, jlse, j[3], **kw)
    args = (*t[:3], t[3], jl, delta)
    # sum |ds| |q| and sum p |dout| over the rows each key sees
    qf, kf, vf, of = (x.float() for x in t)
    s = (qf.view(BHkv, G, S, D) @ kf[:, None].transpose(-1, -2)) * kw["scale"]
    live = fref.attention_mask(S, S, causal=True, window=96)
    p = torch.where(live, torch.exp(s - jl.view(BHkv, G, S, 1)), 0.0)
    ds = p * (of.view(BHkv, G, S, D) @ vf[:, None].transpose(-1, -2)
              - delta.view(BHkv, G, S, 1)) * kw["scale"]
    dk_terms = (ds.abs().transpose(-1, -2) @ qf.view(BHkv, G, S, D).abs()) \
        .sum(1)
    dv_terms = (p.transpose(-1, -2) @ of.view(BHkv, G, S, D).abs()).sum(1)
    dq_terms = (ds.abs() @ kf[:, None].abs()).view(BHkv * G, S, D)
    for g, w, terms, name in zip(
            (*_emulate_dkv(*args, **kw), _emulate_dq(*args, **kw)),
            (jdk, jdv, jdq), (dk_terms, dv_terms, dq_terms),
            ("dk", "dv", "dq")):
        w = torch.from_numpy(np.array(w.astype(jnp.float32))).bfloat16()
        cs._close(g, w, f"emulated flash_bwd {name} vs JAX", "tc",
                  unit * terms)
