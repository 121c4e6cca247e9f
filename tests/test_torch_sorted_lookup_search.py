"""PyTorch port, the warp-cooperative ``searchsorted_left`` kernel
(``csrc/sorted_lookup.cu``) as far as the CPU can check it: its 32-ary
search, emulated here in torch with the warp's 32 lanes as a vector axis,
against the plain version (and ``torch.searchsorted``) bit for bit where its
rounds change shape (N = 1, 32, 33, 34, 1089 = 33^2, 1090), on runs of
equal keys across its probe points, on all-pad arrays and on 2^24 keys; and
against the JAX kernel in interpret mode at the small sizes (it does
O(Q N) work).  The CUDA kernel runs only on the GPU, where ``chip_smoke.py``
holds it to the same kinds of cases.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sorted_lookup import kernel as jsk
from repro_torch.kernels.sorted_lookup import kernel as sk

from test_torch_store_index_edges import one_torch_thread  # noqa: F401

I32MAX = 2**31 - 1
LANES = 32
JAX_KEYS, JAX_QUERIES = 2048, 128     # one interpret-mode shape for all
J_LEFT = jax.jit(functools.partial(jsk.searchsorted_left, block_q=64,
                                   block_k=JAX_KEYS, interpret=True))


def _warp_search(keys, queries):
    """searchsorted_left_kernel for every query at once, a (Q, 32) grid of
    lanes: while a query's range [a, b] is wider than 32, lane i probes
    a + (i + 1) (b - a) // 33 and the count c of probes below the query
    narrows it to [p(c - 1) + 1, p(c)]; then lane i reads a + i.  Returns
    (counts as int32, the most 32-wide rounds any query took)."""
    n = keys.shape[0]
    a = torch.zeros(queries.shape, dtype=torch.int64)
    if n == 0:
        return a.to(torch.int32), 0
    lane = torch.arange(LANES, dtype=torch.int64)
    b, v, kl = torch.full_like(a, n), queries.long()[:, None], keys.long()
    rounds = 0
    while bool(((b - a) > LANES).any()):
        wide, w = (b - a) > LANES, b - a
        probe = a[:, None] + (lane + 1) * w[:, None] // 33
        c = (kl[probe.clamp(max=n - 1)] < v).sum(1)
        lo = torch.where(c == 0, a, a + c * w // 33 + 1)
        hi = torch.where(c == LANES, b, a + (c + 1) * w // 33)
        a, b = torch.where(wide, lo, a), torch.where(wide, hi, b)
        rounds += 1
    idx = a[:, None] + lane
    lt = (idx < b[:, None]) & (kl[idx.clamp(max=n - 1)] < v)
    return (a + lt.sum(1)).to(torch.int32), rounds


def _max_rounds(n):
    """The most 32-wide rounds a query can take over n keys: a round leaves
    at most ceil(w / 33) of a range of width w."""
    r = 0
    while n > LANES:
        n, r = -(-n // 33), r + 1
    return r


def _probe_runs(rng, n):
    """Sorted keys with runs of equal keys across the first round's probe
    points ((i + 1) n // 33), and queries on, below and above each run."""
    keys = np.sort(rng.integers(-2**31, I32MAX, n))
    pts = np.array([(i + 1) * n // 33 for i in range(32)])
    for p in pts[::3]:
        keys[max(0, p - 2):p + 3] = keys[p]
    vals = keys[pts].astype(np.int64)
    return keys, np.clip(np.concatenate([vals, vals - 1, vals + 1]),
                         -2**31, I32MAX)


def _case(kind, n, rng):
    if kind == "random":
        keys = np.sort(rng.integers(-50, 50 + n, n))     # duplicates
        if n > 8:
            keys[-(n // 8):] = I32MAX                     # empty slots
        qs = rng.integers(-60, 60 + n, 40)
        qs[:4] = [I32MAX, -2**31, keys[0], keys[-1]]
        return keys, qs
    if kind == "runs":
        return _probe_runs(rng, n)
    if kind == "all_pad":
        return np.full(n, I32MAX), np.array([I32MAX, 0, -2**31, I32MAX - 1])
    raise ValueError(kind)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.int32))


@pytest.mark.parametrize("kind", ["random", "runs", "all_pad"])
@pytest.mark.parametrize("n", [1, 32, 33, 34, 1089, 1090])
def test_warp_search_matches_plain_and_jax(kind, n):
    """The emulated warp search equals the plain version, the library
    search and the JAX kernel (interpret mode; keys padded with INT32_MAX,
    which no query passes) bit for bit."""
    rng = np.random.default_rng(n)
    keys, qs = _case(kind, n, rng)
    assert (np.diff(keys) >= 0).all()
    k, q = _t(keys), _t(qs)
    got, rounds = _warp_search(k, q)
    assert rounds <= _max_rounds(n)
    want = sk.searchsorted_left_plain(k, q)
    assert torch.equal(got, want)
    assert torch.equal(got, sk.searchsorted_left(k, q))
    assert torch.equal(got, torch.searchsorted(k, q, out_int32=True))
    jk = np.full(JAX_KEYS, I32MAX, np.int32)
    jk[:n] = keys
    jq = np.full(JAX_QUERIES, I32MAX, np.int32)
    jq[:len(qs)] = qs
    jout = np.asarray(J_LEFT(jnp.asarray(jk), jnp.asarray(jq)))[:len(qs)]
    np.testing.assert_array_equal(got.numpy(), jout)


def test_warp_search_empty_index():
    got, rounds = _warp_search(_t(np.zeros(0)), _t([0, I32MAX, -2**31]))
    assert rounds == 0 and got.tolist() == [0, 0, 0]


@pytest.mark.parametrize("kind", ["random", "runs"])
def test_warp_search_at_2_24_keys(kind):
    """One shard's index block at 2^24 keys: the emulated search equals the
    plain version in 4 rounds of 32 spread probes (then one of adjacent
    keys), where a binary search makes 25 dependent loads."""
    rng = np.random.default_rng(24)
    n = 2**24
    if kind == "runs":
        keys, qs = _probe_runs(rng, n)
    else:
        keys = np.sort(rng.integers(-2**31, I32MAX, n))
        keys[n // 3:n // 3 + n // 10] = keys[n // 3]
        keys[-(n // 8):] = I32MAX
        qs = rng.integers(-2**31, I32MAX, 128)
        qs[:5] = [I32MAX, -2**31, keys[0], keys[n // 3], keys[0] - 1]
    k, q = _t(keys), _t(qs)
    got, rounds = _warp_search(k, q)
    assert rounds <= _max_rounds(n) == 4
    assert torch.equal(got, sk.searchsorted_left_plain(k, q))
    assert torch.equal(got, torch.searchsorted(k, q, out_int32=True))
