"""PyTorch port, the zoo's kernels: ``embedding_bag`` and ``segment_spmm``
(what their wrappers run on CPU tensors: the plain versions) and their
``ops`` gradients, against the JAX package on numpy-seeded inputs (the
cases of ``tests/test_kernels.py``'s sweeps).  The JAX kernels run in
interpret mode under ``jax.jit``; the CUDA kernels run only on the GPU,
where ``chip_smoke.py`` holds each against its plain version.

Tolerances: the plain versions sum in float32 in the JAX kernels' order,
so float32 agrees with the interpret-mode kernel within 1e-6 and with
``ref.py`` (whose reductions may pair terms otherwise) within 1e-5;
bfloat16 within one bf16 ulp of the kernel (both round one f32 value) and
3e-2 of ``ref.py`` (which sums in bf16, the JAX test's bound).  bf16 mean
is held to the kernel alone: ``ref.py`` divides the bf16 sum in bf16, and
the port follows the kernel.  The W product sums in another order than
XLA's dot: 3e-5 relative, as the JAX test allows.  Gradients 1e-5 (1e-4
for segment_spmm, as the JAX test).
"""
import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels.embedding_bag import kernel as jek
from repro.kernels.embedding_bag import ops as jeops
from repro.kernels.embedding_bag import ref as jeref
from repro.kernels.segment_spmm import kernel as jsk
from repro.kernels.segment_spmm import ops as jsops
from repro.kernels.segment_spmm import ref as jsref
from repro_torch.kernels import _cuda
from repro_torch.kernels.embedding_bag import kernel as ek
from repro_torch.kernels.embedding_bag import ops as eops
from repro_torch.kernels.embedding_bag import ref as eref
from repro_torch.kernels.segment_spmm import kernel as sk
from repro_torch.kernels.segment_spmm import ops as sops
from repro_torch.kernels.segment_spmm import ref as sref

from test_torch_store_index_edges import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
BF16_ULP = 2.0 ** -7          # relative: one bf16 ulp is 2^-8 to 2^-7


def _t(a):
    """numpy (ml_dtypes bf16 included) -> torch."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _table(rng, V, D, dtype):
    a = rng.normal(size=(V, D)).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


@functools.lru_cache(maxsize=None)
def _jax_bag(mode):
    return jax.jit(functools.partial(jek.embedding_bag, mode=mode,
                                     interpret=True))


@pytest.mark.parametrize("V,D,B,L", [(100, 128, 8, 4), (531, 256, 16, 7)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_plain_matches_jax(V, D, B, L, mode, dtype):
    rng = np.random.default_rng(V + B)
    tab = _table(rng, V, D, dtype)
    ids = rng.integers(-1, V, (B, L)).astype(np.int32)
    ids[0] = -1                                        # an empty bag
    got = ek.embedding_bag(_t(tab), _t(ids), mode=mode)
    assert got.dtype == _t(tab).dtype and got.shape == (B, D)
    kern = _f32(_jax_bag(mode)(jnp.asarray(tab), jnp.asarray(ids)))
    assert not np.any(_f32(got)[0])
    if dtype == "float32":
        assert_allclose(_f32(got), kern, rtol=1e-6, atol=1e-7)
        assert_allclose(_f32(got), _f32(jeref.embedding_bag(
            jnp.asarray(tab), jnp.asarray(ids), mode=mode)),
            rtol=1e-5, atol=1e-5)
    else:
        assert_allclose(_f32(got), kern, rtol=BF16_ULP, atol=0)
        if mode == "sum":
            assert_allclose(_f32(got), _f32(jeref.embedding_bag(
                jnp.asarray(tab), jnp.asarray(ids), mode=mode)),
                rtol=3e-2, atol=3e-2)
    # the port's own oracle is the JAX ref.py in PyTorch
    want = eref.embedding_bag(_t(tab), _t(ids), mode=mode)
    tol = 1e-5 if dtype == "float32" else 3e-2
    if dtype == "float32" or mode == "sum":
        assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_grad_matches_jax(mode):
    rng = np.random.default_rng(3)
    tab = rng.normal(size=(50, 64)).astype(np.float32)
    ids = rng.integers(-1, 50, (4, 5)).astype(np.int32)
    ids[1] = -1
    gout = rng.normal(size=(4, 64)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jeops.embedding_bag(
        t, jnp.asarray(ids), mode) * gout))(jnp.asarray(tab))
    t = _t(tab).requires_grad_()
    (eops.embedding_bag(t, _t(ids), mode) * _t(gout)).sum().backward()
    assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_spmm(use_w, use_norm):
    def f(x, ids, w, norm):
        return jsk.segment_spmm(x, ids, w if use_w else None,
                                norm if use_norm else None, interpret=True)
    return jax.jit(f)


@pytest.mark.parametrize("N,D,R,K,Dout", [(64, 64, 16, 4, 32),
                                          (200, 128, 50, 9, 128)])
@pytest.mark.parametrize("use_w,use_norm", [(True, True), (False, False),
                                            (True, False), (False, True)])
def test_segment_spmm_plain_matches_jax(N, D, R, K, Dout, use_w, use_norm):
    rng = np.random.default_rng(N + K)
    x = rng.normal(size=(N, D)).astype(np.float32)
    ids = rng.integers(-1, N, (R, K)).astype(np.int32)
    ids[0] = -1                                        # no neighbours
    w = (rng.normal(size=(D, Dout)) * 0.1).astype(np.float32)
    norm = rng.uniform(size=R).astype(np.float32)
    wt, nt = (_t(w) if use_w else None), (_t(norm) if use_norm else None)
    got = sk.segment_spmm(_t(x), _t(ids), wt, nt)
    assert got.shape == (R, Dout if use_w else D)
    kern = np.asarray(_jax_spmm(use_w, use_norm)(x, ids, w, norm))
    ref = np.asarray(jsref.segment_spmm(x, ids, w if use_w else None,
                                        norm if use_norm else None))
    tol = dict(rtol=3e-5, atol=1e-5) if use_w else dict(rtol=1e-6, atol=1e-7)
    assert_allclose(got.numpy(), kern, **tol)
    assert_allclose(got.numpy(), ref, rtol=3e-5, atol=1e-5)
    assert_allclose(got.numpy(), sref.segment_spmm(_t(x), _t(ids), wt,
                                                   nt).numpy(),
                    rtol=3e-5, atol=1e-5)
    assert not np.any(got.numpy()[0])


def test_segment_spmm_bf16_matches_the_jax_kernel():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(64, 48)).astype(ml_dtypes.bfloat16)
    ids = rng.integers(-1, 64, (16, 5)).astype(np.int32)
    w = (rng.normal(size=(48, 24)) * 0.1).astype(ml_dtypes.bfloat16)
    norm = rng.uniform(size=16).astype(np.float32)
    got = sk.segment_spmm(_t(x), _t(ids), _t(w), _t(norm))
    assert got.dtype == torch.bfloat16
    kern = _f32(_jax_spmm(True, True)(x, ids, w, norm))
    assert_allclose(_f32(got), kern, rtol=BF16_ULP, atol=1e-5)


@pytest.mark.parametrize("use_norm", [True, False])
def test_segment_spmm_grads_match_jax(use_norm):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(40, 32)).astype(np.float32)
    ids = rng.integers(-1, 40, (12, 5)).astype(np.int32)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    norm = rng.uniform(size=12).astype(np.float32) if use_norm else None
    gout = rng.normal(size=(12, 16)).astype(np.float32)
    jn = None if norm is None else jnp.asarray(norm)
    want = jax.grad(lambda x, w: jnp.sum(jsops.segment_spmm(
        x, jnp.asarray(ids), w, jn) * gout), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    (sops.segment_spmm(xt, _t(ids), wt, None if norm is None else _t(norm))
     * _t(gout)).sum().backward()
    for g, jg in zip((xt.grad, wt.grad), want):
        assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("use_norm", [True, False])
def test_segment_spmm_grad_without_w(use_norm):
    """No W: the JAX backward raises (``g @ w.T`` with w None); the port's
    is the natural gradient, held against autograd through its ref.py."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(30, 24)).astype(np.float32)
    ids = rng.integers(-1, 30, (10, 3)).astype(np.int32)
    norm = _t(rng.uniform(size=10).astype(np.float32)) if use_norm else None
    gout = _t(rng.normal(size=(10, 24)).astype(np.float32))
    grads = []
    for fn in (sops.segment_spmm, sref.segment_spmm):
        xt = _t(x).requires_grad_()
        (fn(xt, _t(ids), None, norm) * gout).sum().backward()
        grads.append(xt.grad)
    assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=1e-6,
                    atol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((4, 8))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ek.embedding_bag(x, ids.long())
    with pytest.raises(ValueError, match="mode"):
        ek.embedding_bag(x, ids, mode="max")
    with pytest.raises(ValueError, match="float32 or"):
        sk.segment_spmm(x.double(), ids)
    with pytest.raises(ValueError, match=r"\(D, Dout\)"):
        sk.segment_spmm(x, ids, torch.zeros((7, 2)))
    with pytest.raises(ValueError, match=r"\(R,\)"):
        sk.segment_spmm(x, ids, None, torch.ones(3))
    assert torch.equal(sk.segment_spmm(torch.zeros((4, 0)), ids,
                                       torch.zeros((0, 5))),
                       torch.zeros((2, 5)))


def _pallas_call_sites():
    sites = set()
    for path in sorted((ROOT / "src/repro/kernels").rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if re.search(r"\bpl\.pallas_call\(", line):
                sites.add(f"{path.relative_to(ROOT)}:{i}")
    return sites


def test_chip_smoke_reports_every_tpu_kernel():
    """``chip_smoke.py``'s kernel table names all thirteen ``pallas_call``
    sites, each under a wrapper whose launches ``_cuda`` counts, on a path
    and from a CUDA source that ``_cuda`` builds."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sites = _pallas_call_sites()
    assert len(sites) == 13
    assert {rep for _, rep in cs.KERNELS.values()} == sites
    assert set(cs.KERNELS) == set(cs.PATH_OF) == set(_cuda.LAUNCHES)
    for name, (src, _) in cs.KERNELS.items():
        assert (ROOT / src).exists(), src
        assert pathlib.Path(src).stem in _cuda.SOURCES
    assert cs.PATH_OF["segment_spmm"] == cs.PATH_OF["embedding_bag"] == "zoo"
