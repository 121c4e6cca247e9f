"""Minimal real-spherical-harmonics irrep algebra for NequIP (l_max <= 2).

Port of ``repro/models/gnn/irreps.py``: the same numpy code, kept here so
that the port imports nothing of the JAX package; on one machine its
tensors equal the JAX package's bit for bit.

* real spherical harmonics Y_l for l = 0, 1, 2 (hardcoded, component order
  m = -l..l in the standard real basis);
* Wigner-D matrices for arbitrary rotations obtained *numerically*: D_l(R)
  is the unique matrix with Y_l(R x) = D_l(R) Y_l(x), solved by least
  squares over sample points;
* real Clebsch-Gordan tensors C^{l1 l2 l3} obtained as the null space of
  stacked invariance constraints (D1 (x) D2 (x) D3 - I) vec(C) = 0 over a
  few random rotations.  Validity is checked at import (equivariance
  residual < 1e-8).
"""
from __future__ import annotations

import functools

import numpy as np

L_MAX = 2
_DIMS = {0: 1, 1: 3, 2: 5}


def sh_np(x: np.ndarray, l: int) -> np.ndarray:
    """Real spherical harmonics of unit vectors x (..., 3), component-normed

    (Racah normalization scaled so ||Y_l|| is rotation invariant)."""
    xx, yy, zz = x[..., 0], x[..., 1], x[..., 2]
    if l == 0:
        return np.ones(x.shape[:-1] + (1,))
    if l == 1:
        return np.stack([yy, zz, xx], axis=-1)
    if l == 2:
        s3 = np.sqrt(3.0)
        return np.stack([
            s3 * xx * yy,
            s3 * yy * zz,
            0.5 * (2 * zz * zz - xx * xx - yy * yy),
            s3 * xx * zz,
            0.5 * s3 * (xx * xx - yy * yy),
        ], axis=-1)
    raise NotImplementedError(l)


def _rand_rotation(rng) -> np.ndarray:
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def wigner_d_np(R: np.ndarray, l: int) -> np.ndarray:
    """D_l(R) s.t. Y_l(R x) = D_l(R) Y_l(x) — least squares over samples."""
    if l == 0:
        return np.ones((1, 1))
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(64, 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    A = sh_np(pts, l)                       # (P, d)
    B = sh_np(pts @ R.T, l)                 # (P, d) = Y(R x)
    D, *_ = np.linalg.lstsq(A, B, rcond=None)
    return D.T                              # B^T = D A^T


@functools.lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real Clebsch-Gordan tensor C (d1, d2, d3): the SO(3)-invariant

    coupling, normalized to Frobenius norm 1.  Zero tensor if the triangle
    rule fails."""
    d1, d2, d3 = _DIMS[l1], _DIMS[l2], _DIMS[l3]
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((d1, d2, d3))
    rng = np.random.default_rng(42)
    rows = []
    for _ in range(4):
        R = _rand_rotation(rng)
        D1, D2, D3 = (wigner_d_np(R, l1), wigner_d_np(R, l2),
                      wigner_d_np(R, l3))
        M = np.einsum("ai,bj,ck->abcijk", D1, D2, D3).reshape(
            d1 * d2 * d3, d1 * d2 * d3)
        rows.append(M - np.eye(d1 * d2 * d3))
    A = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(A)
    null_dim = int(np.sum(s < 1e-8))
    assert null_dim >= 1, (l1, l2, l3, s[-3:])
    c = vt[-1].reshape(d1, d2, d3)
    c /= np.linalg.norm(c)
    # deterministic sign: make the first significant entry positive
    flat = c.reshape(-1)
    idx = int(np.argmax(np.abs(flat) > 1e-6))
    if flat[idx] < 0:
        c = -c
    return c


def _selfcheck() -> None:
    rng = np.random.default_rng(7)
    R = _rand_rotation(rng)
    for (l1, l2, l3) in [(1, 1, 0), (1, 1, 1), (1, 1, 2), (2, 1, 1),
                         (2, 2, 2), (2, 2, 0)]:
        C = real_cg(l1, l2, l3)
        D1, D2, D3 = (wigner_d_np(R, l1), wigner_d_np(R, l2),
                      wigner_d_np(R, l3))
        C2 = np.einsum("ai,bj,ck,ijk->abc", D1, D2, D3, C)
        assert np.abs(C2 - C).max() < 1e-8, (l1, l2, l3)


_selfcheck()


# all (l1, l2, l3) paths with l's <= L_MAX and valid triangle rule
PATHS = [(l1, l2, l3)
         for l1 in range(L_MAX + 1)
         for l2 in range(L_MAX + 1)
         for l3 in range(L_MAX + 1)
         if abs(l1 - l2) <= l3 <= l1 + l2
         # parity selection: SH of edge vectors carry parity (-1)^l, so a
         # path is O(3)-consistent iff (-1)^(l1+l2) == (-1)^l3
         and (l1 + l2 + l3) % 2 == 0]
