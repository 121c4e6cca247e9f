"""PyTorch port, the LM's kernels: ``rmsnorm_fwd``, ``flash_fwd`` and the
two ``flash_bwd`` kernels (what their wrappers run on CPU tensors: the plain
versions), the rmsnorm VJP, the attention oracle and the model's attention,
against the JAX package on seeded numpy inputs.  The JAX kernels run in
interpret mode under ``jax.jit``; the CUDA kernels run only on the GPU,
where ``chip_smoke.py`` holds each against its plain version.  Tolerances:
float32 2e-5 (out), 1e-5 (lse, rmsnorm) and 2e-4 (the attention
gradients), as the JAX kernel tests use; bfloat16 rmsnorm within one bf16
ulp of the JAX kernel (both compute in float32 and round once).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels.flash_attention import kernel as jfk
from repro.kernels.flash_attention import ref as jfref
from repro.kernels.rmsnorm import kernel as jrk
from repro.kernels.rmsnorm import ops as jrops
from repro.kernels.rmsnorm import ref as jrref
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.rmsnorm import kernel as rk
from repro_torch.kernels.rmsnorm import ops as rops
from repro_torch.kernels.rmsnorm import ref as rref
from repro_torch.models import attention as tattn

from test_torch_store_index_edges import one_torch_thread  # noqa: F401

J_RMS = jax.jit(functools.partial(jrk.rmsnorm_fwd, interpret=True))
J_RMS_REF = jax.jit(jrref.rmsnorm)
J_FLASH = jax.jit(functools.partial(jfk.flash_fwd, block_q=64, block_k=64,
                                    interpret=True),
                  static_argnames=("causal", "window", "scale", "q_offset"))
J_FLASH_BWD = jax.jit(functools.partial(jfk.flash_bwd, block_q=64,
                                        block_k=64, interpret=True),
                      static_argnames=("causal", "window", "scale",
                                       "q_offset"))
J_MHA_REF = jax.jit(jfref.mha, static_argnames=("causal", "window",
                                                "q_offset"))


@functools.partial(jax.jit, static_argnames=("causal", "window", "q_offset"))
def J_MHA_REF_VJP(q, k, v, g, *, causal, window, q_offset):
    """(dq, dk, dv) of the oracle: ``jax.vjp`` of ``ref.mha``."""
    return jax.vjp(functools.partial(jfref.mha, causal=causal, window=window,
                                     q_offset=q_offset), q, k, v)[1](g)
J_MHA = jax.jit(jattn.mha, static_argnames=("causal", "window", "q_offset"))

BF16_ULP = 2.0 ** -7       # one bf16 ulp, relative, at worst


def _pair(a, dtype):
    """The same values as a JAX and a torch array of ``dtype``."""
    a = np.asarray(a, np.float32)
    if dtype == "bf16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 128), (3, 17, 256), (64, 512)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_matches_jax(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    jx, tx = _pair(rng.standard_normal(shape), dtype)
    js, ts = _pair(rng.standard_normal(shape[-1:]), dtype)
    got = rk.rmsnorm_fwd(tx, ts)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    if dtype == "f32":
        tol = dict(rtol=1e-5, atol=1e-5)
    else:
        tol = dict(rtol=BF16_ULP, atol=1e-6)
    assert_allclose(_np(got), _np(J_RMS(jx, js)), **tol)
    assert_allclose(_np(got), _np(J_RMS_REF(jx, js)), **tol)
    assert_allclose(_np(rref.rmsnorm(tx, ts)), _np(J_RMS_REF(jx, js)), **tol)


@pytest.mark.parametrize("n,d", [(1, 3840), (7, 120), (5, 1000), (2, 3)])
def test_rmsnorm_widths_and_one_row(n, d):
    """Widths that are not a multiple of the kernel's vector (the tests'
    odd widths), and n = 1 (decode at batch 1)."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    assert_allclose(rk.rmsnorm_fwd(x, s).numpy(),
                    _np(J_RMS_REF(jnp.asarray(x.numpy()),
                                  jnp.asarray(s.numpy()))),
                    rtol=1e-5, atol=1e-5)


def test_rmsnorm_wrapper_checks():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        rk.rmsnorm_fwd(x, torch.zeros(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        rk.rmsnorm_fwd(x, torch.zeros(7))
    with pytest.raises(ValueError):
        rk.rmsnorm_fwd(x.to(torch.int32), torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):          # never a fallback off the CPU
        rk.rmsnorm_fwd(x.to("meta"), torch.zeros(8, device="meta"))


# ---------------------------------------------------------------------------
# flash_fwd
# ---------------------------------------------------------------------------

FLASH_CASES = [                              # test_flash_fwd_bwd_sweep's
    (2, 4, 4, 128, 128, 64, True, 0),
    (2, 4, 2, 128, 128, 64, True, 0),        # GQA
    (1, 8, 2, 256, 256, 32, True, 128),      # GQA + SWA
    (1, 4, 4, 128, 128, 64, False, 0),       # bidirectional
    (1, 4, 2, 64, 256, 32, True, 0),         # chunked decode (q_offset)
]


def _qkv(B, Hq, Hkv, Sq, Sk, D, seed=0, dtype="f32"):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(s), dtype)
            for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window", FLASH_CASES)
def test_flash_fwd_matches_jax(B, Hq, Hkv, Sq, Sk, D, causal, window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, Hq, Hkv, Sq, Sk, D)
    qo = Sk - Sq
    flat = lambda t, H, S: t.reshape(B * H, S, D)      # noqa: E731
    kw = dict(causal=causal, window=window, scale=D ** -0.5, q_offset=qo)
    want, want_lse = J_FLASH(flat(jq, Hq, Sq), flat(jk, Hkv, Sk),
                             flat(jv, Hkv, Sk), **kw)
    got, lse = fk.flash_fwd(flat(tq, Hq, Sq), flat(tk, Hkv, Sk),
                            flat(tv, Hkv, Sk), **kw)
    assert got.dtype == torch.float32 and lse.shape == (B * Hq, Sq)
    assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5, atol=1e-5)
    ref = J_MHA_REF(jq, jk, jv, causal=causal, window=window, q_offset=qo)
    assert_allclose(got.reshape(B, Hq, Sq, D).numpy(), np.asarray(ref),
                    rtol=2e-5, atol=2e-5)
    # the port's oracle and mask against the JAX ones
    assert_allclose(fref.mha(tq, tk, tv, causal=causal, window=window,
                             q_offset=qo).numpy(), np.asarray(ref),
                    rtol=2e-5, atol=2e-5)
    assert np.array_equal(
        fref.attention_mask(Sq, Sk, causal=causal, window=window,
                            q_offset=qo).numpy(),
        np.asarray(jfref.attention_mask(Sq, Sk, causal=causal,
                                        window=window, q_offset=qo)))


def test_flash_fwd_bf16_matches_jax():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 4, 4, 128, 128, 64, seed=3,
                                        dtype="bf16")
    kw = dict(causal=True, window=0, scale=64 ** -0.5)
    want, want_lse = J_FLASH(jq[0], jk[0], jv[0], **kw)
    got, lse = fk.flash_fwd(tq[0].contiguous(), tk[0].contiguous(),
                            tv[0].contiguous(), **kw)
    assert got.dtype == torch.bfloat16
    assert_allclose(_np(got), _np(want), rtol=BF16_ULP, atol=1e-4)
    assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Sq,Sk,q_offset,causal,window", [
    (100, 150, 50, True, 0),          # ragged q and k tails
    (1, 70, 69, True, 33),            # one decode row
    (37, 37, 0, False, 16),           # window without causality
    (5, 300, 0, True, 8),             # rows with keys far past them
])
def test_flash_fwd_ragged_lengths(Sq, Sk, q_offset, causal, window):
    """Lengths that are not a multiple of the kernel's 64-row and 64-key
    tiles: the wrapper takes them (the kernel masks the tails) and the plain
    version it runs here agrees with the oracle; chip_smoke.py holds the
    kernel to the plain version at such lengths."""
    (_, tq), (_, tk), (_, tv) = _qkv(1, 6, 3, Sq, Sk, 24, seed=Sq)
    got, lse = fk.flash_fwd(tq[0], tk[0], tv[0], causal=causal,
                            window=window, scale=24 ** -0.5,
                            q_offset=q_offset)
    want = fref.mha(tq, tk, tv, causal=causal, window=window,
                    q_offset=q_offset)[0]
    assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    assert torch.isfinite(lse).all()


@pytest.mark.parametrize("Sq,Sk,q_offset,causal,window", [
    (32768, 32768, 0, True, 4096),    # the main path
    (4096, 4096, 0, True, 128),
    (64, 4096, 4032, True, 4096),
    (300, 1000, 700, True, 0),
    (200, 200, 0, False, 50),
    (130, 130, 0, False, 0),
])
def test_flash_kv_tiles_cover_the_mask(Sq, Sk, q_offset, causal, window):
    """The kernel's kv loop bounds (mirrored by ``kv_tiles``) visit every
    tile holding a live key of the q block, and at most
    ceil((window + BQ - 1) / BK) + 1 tiles under a causal window."""
    bound = -(-(window + fk.BQ - 1) // fk.BK) + 1
    for q0 in range(0, Sq, fk.BQ):
        rows = min(fk.BQ, Sq - q0)
        tiles = fk.kv_tiles(q0, rows, Sk, causal=causal, window=window,
                            q_offset=q_offset)
        m = fref.attention_mask(rows, Sk, causal=causal, window=window,
                                q_offset=q_offset + q0)
        live = np.flatnonzero(m.any(0).numpy())
        if live.size:
            assert tiles.start <= live[0] // fk.BK
            assert tiles.stop > live[-1] // fk.BK
        if causal and window > 0:
            assert len(tiles) <= bound


def test_kernel_library_names_hash_the_shared_headers(tmp_path,
                                                     monkeypatch):
    """A kernel library's name hashes its source, every ``csrc/*.cuh`` and
    the flags, so that an edited shared header (``flash_mma.cuh``) builds
    every source anew instead of reusing a stale library."""
    from repro_torch.kernels import _cuda
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _cuda._lib_path("a")
    assert _cuda._lib_path("a") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _cuda._lib_path("a")
    assert second != first and second.parent == first.parent
    (tmp_path / "g.cuh").write_text("")
    third = _cuda._lib_path("a")
    assert third != second
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _cuda._lib_path("a") not in (first, second, third)


def test_flash_wrapper_checks():
    q = torch.zeros((4, 8, 16))
    k = torch.zeros((2, 8, 16))
    kw = dict(causal=True, window=0, scale=0.25)
    with pytest.raises(ValueError):
        fk.flash_fwd(q, torch.zeros((3, 8, 16)), torch.zeros((3, 8, 16)),
                     **kw)
    with pytest.raises(ValueError):
        fk.flash_fwd(torch.zeros((4, 8, 130)), torch.zeros((2, 8, 130)),
                     torch.zeros((2, 8, 130)), **kw)
    with pytest.raises(ValueError):
        fk.flash_fwd(q, k.bfloat16(), k, **kw)
    with pytest.raises(ValueError):
        fk.flash_fwd(q, torch.zeros((2, 0, 16)), torch.zeros((2, 0, 16)),
                     **kw)
    with pytest.raises(ValueError):          # never a fallback off the CPU
        fk.flash_fwd(q.to("meta"), k.to("meta"), k.to("meta"), **kw)


def test_ops_are_forward_only(monkeypatch):
    """The ops' backward goes through the kernels' side of the seam: the
    attention's through the ``flash_bwd`` wrapper once, RMSNorm's through
    the analytic ``rmsnorm_vjp``; the gradients equal autograd through the
    plain oracles.  (The name dates from when the ops had no backward.)"""
    calls = {"flash_bwd": 0, "rmsnorm_vjp": 0}
    for mod, name in ((fk, "flash_bwd"), (rops, "rmsnorm_vjp")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    x.requires_grad_()
    s.requires_grad_()
    g = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    got = torch.autograd.grad(rops.rmsnorm(x, s), (x, s), g)
    want = torch.autograd.grad(rref.rmsnorm(x, s), (x, s), g)
    for a, b in zip(got, want):
        assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    (_, tq), (_, tk), (_, tv) = _qkv(1, 4, 2, 24, 24, 8, seed=8)
    qkv = [t.requires_grad_() for t in (tq, tk, tv)]
    do = torch.from_numpy(rng.standard_normal((1, 4, 24, 8)).astype(
        np.float32))
    got = torch.autograd.grad(fops.mha(*qkv, True, 16), qkv, do)
    want = torch.autograd.grad(fref.mha(*qkv, causal=True, window=16), qkv,
                               do)
    for a, b in zip(got, want):
        assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)
    assert calls == {"flash_bwd": 1, "rmsnorm_vjp": 1}


# ---------------------------------------------------------------------------
# flash_bwd and the rmsnorm VJP
# ---------------------------------------------------------------------------

def _flat_bwd_inputs(q, k, v, do, B, Hq, Hkv, Sq, Sk, D):
    return (q.reshape(B * Hq, Sq, D), k.reshape(B * Hkv, Sk, D),
            v.reshape(B * Hkv, Sk, D), do.reshape(B * Hq, Sq, D))


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window", FLASH_CASES)
def test_flash_bwd_matches_jax(B, Hq, Hkv, Sq, Sk, D, causal, window):
    """flash_bwd (its plain version here) against the JAX kernels in
    interpret mode, from the same forward out and lse, and against
    ``jax.vjp`` of the oracle."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, Hq, Hkv, Sq, Sk, D, seed=Sq + D)
    jdo, tdo = _pair(np.random.default_rng(D).standard_normal(
        (B, Hq, Sq, D)), "f32")
    qo = Sk - Sq
    kw = dict(causal=causal, window=window, scale=D ** -0.5, q_offset=qo)
    jf = _flat_bwd_inputs(jq, jk, jv, jdo, B, Hq, Hkv, Sq, Sk, D)
    out, lse = J_FLASH(*jf[:3], **kw)
    want = J_FLASH_BWD(*jf[:3], out, lse, jf[3], **kw)
    tf = _flat_bwd_inputs(tq, tk, tv, tdo, B, Hq, Hkv, Sq, Sk, D)
    tout = torch.from_numpy(np.array(out))
    delta = torch.sum(tout * tf[3], dim=-1)
    got = fk.flash_bwd(*tf, torch.from_numpy(np.array(lse)), delta, **kw)
    oracle = J_MHA_REF_VJP(jq, jk, jv, jdo, causal=causal, window=window,
                           q_offset=qo)
    for g, w, r, x in zip(got, want, oracle, (tq, tk, tv)):
        assert g.shape == x.reshape(g.shape).shape and g.dtype == x.dtype
        assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)
        assert_allclose(g.reshape(x.shape).numpy(), np.asarray(r),
                        rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("Sq,Sk,q_offset,causal,window", [
    (100, 150, 50, True, 0),          # ragged q and k tails
    (1, 70, 69, True, 33),            # one decode row
    (37, 37, 0, False, 16),           # window without causality
    (10, 20, 20, False, 8),           # rows 7-9 see no key
])
def test_flash_bwd_ragged_lengths(Sq, Sk, q_offset, causal, window):
    """Lengths that are not a multiple of the kernels' 64-row and 64-key
    tiles, against ``jax.vjp`` of the oracle; where some rows see no key,
    against the JAX kernels (one block each way): the kernels give such a
    row p = 0, so no gradient, where the oracle's softmax spreads it evenly
    over every key."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 6, 3, Sq, Sk, 24, seed=Sq + 1)
    jdo, tdo = _pair(np.random.default_rng(Sk).standard_normal(
        (1, 6, Sq, 24)), "f32")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = fk.flash_fwd(tq[0], tk[0], tv[0], scale=24 ** -0.5, **kw)
    delta = torch.sum(out * tdo[0], dim=-1)
    got = fk.flash_bwd(tq[0], tk[0], tv[0], tdo[0].contiguous(), lse, delta,
                       scale=24 ** -0.5, **kw)
    dead = ~fref.attention_mask(Sq, Sk, **kw).any(1)
    if dead.any():
        jout, jlse = J_FLASH(jq[0], jk[0], jv[0], scale=24 ** -0.5, **kw)
        want = [w[None] for w in J_FLASH_BWD(jq[0], jk[0], jv[0], jout, jlse,
                                             jdo[0], scale=24 ** -0.5, **kw)]
        assert not bool(got[0][:, dead].any())
    else:
        want = J_MHA_REF_VJP(jq, jk, jv, jdo, **kw)
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w)[0], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("Sq,Sk,q_offset,causal,window", [
    (4096, 4096, 0, True, 4096),      # the training path
    (4096, 4096, 0, True, 128),
    (64, 4096, 4032, True, 4096),
    (300, 1000, 700, True, 0),
    (200, 200, 0, False, 50),
    (130, 130, 0, False, 0),
    (10, 20, 20, False, 8),
])
def test_flash_q_tiles_cover_the_mask(Sq, Sk, q_offset, causal, window):
    """The dK/dV kernel's q loop bounds (mirrored by ``q_tiles``) visit
    every tile holding a row that sees a key of the k tile, and at most
    ceil((window + BK - 1) / BQ) + 1 tiles under a causal window."""
    bound = -(-(window + fk.BK - 1) // fk.BQ) + 1
    m = fref.attention_mask(Sq, Sk, causal=causal, window=window,
                            q_offset=q_offset).numpy()
    for k0 in range(0, Sk, fk.BK):
        cols = min(fk.BK, Sk - k0)
        tiles = fk.q_tiles(k0, cols, Sq, causal=causal, window=window,
                           q_offset=q_offset)
        live = np.flatnonzero(m[:, k0:k0 + cols].any(1))
        if live.size:
            assert tiles.start <= live[0] // fk.BQ
            assert tiles.stop > live[-1] // fk.BQ
        if causal and window > 0:
            assert len(tiles) <= bound


def test_flash_bwd_wrapper_checks():
    q = torch.zeros((4, 8, 16))
    k = torch.zeros((2, 8, 16))
    lse = torch.zeros((4, 8))
    kw = dict(causal=True, window=0, scale=0.25)
    with pytest.raises(ValueError):          # dout unlike q
        fk.flash_bwd(q, k, k, q[:, :4].contiguous(), lse, lse, **kw)
    with pytest.raises(ValueError):          # lse not float32 (BHq, Sq)
        fk.flash_bwd(q, k, k, q, lse.double(), lse, **kw)
    with pytest.raises(ValueError):
        fk.flash_bwd(q, k, k, q, lse, lse[:, :7].contiguous(), **kw)
    with pytest.raises(ValueError):          # never a fallback off the CPU
        fk.flash_bwd(*(t.to("meta") for t in (q, k, k, q, lse, lse)), **kw)
    # on CPU tensors each kernel's wrapper gives its part of flash_bwd's
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
            for t in (q, k, k, q, lse, lse)]
    dq, dk, dv = fk.flash_bwd(*args, **kw)
    assert torch.equal(fk.flash_bwd_dq(*args, **kw), dq)
    for a, b in zip(fk.flash_bwd_dkv(*args, **kw), (dk, dv)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(8, 128), (3, 17, 256)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_vjp_matches_jax(shape, dtype):
    """The analytic backward against ``jax.vjp`` of the JAX op (its
    ``custom_vjp``): f32 within 1e-5; bf16 within one ulp of each output's
    scale (both compute in f32 and round once)."""
    rng = np.random.default_rng(len(shape))
    jx, tx = _pair(rng.standard_normal(shape), dtype)
    js, ts = _pair(1 + 0.1 * rng.standard_normal(shape[-1:]), dtype)
    jg, tg = _pair(rng.standard_normal(shape), dtype)
    _, vjp = jax.vjp(jrops.rmsnorm, jx, js)
    tx.requires_grad_()
    ts.requires_grad_()
    got = torch.autograd.grad(rops.rmsnorm(tx, ts), (tx, ts), tg)
    for g, w in zip(got, vjp(jg)):
        assert g.dtype == tx.dtype
        w = _np(w)
        tol = 1e-5 if dtype == "f32" else \
            2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        assert_allclose(_np(g), w, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# models.attention.mha
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Hq,Hkv,S,D,window,rows", [
    (2, 4, 2, 128, 16, 0, None),
    (1, 8, 2, 256, 32, 64, None),
    (1, 2, 1, 4096, 8, 1000, None),     # two 2048-key chunks
    (1, 2, 1, 4096, 8, 1000, 1024),     # and four query passes that skip
])
def test_model_attention_matches_jax(B, Hq, Hkv, S, D, window, rows,
                                     monkeypatch):
    """Both backends against the JAX model's attention (its chunked jnp
    path on the CPU)."""
    if rows:
        monkeypatch.setattr(tattn, "_ROWS", rows)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, Hq, Hkv, S, S, D, seed=S + D)
    want = np.asarray(J_MHA(jq, jk, jv, causal=True, window=window))
    for be in ("ref", "kernel"):
        got = tattn.mha(tq, tk, tv, causal=True, window=window, backend=be)
        assert got.shape == (B, Hq, S, D)
        assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5, err_msg=be)
