"""PyTorch port, the warp-cooperative search of both ``sorted_lookup``
kernels (``csrc/sorted_lookup.cu``: ``searchsorted_left`` over one flat
array and ``searchsorted_left_ranged`` inside each query's window, one
routine) as far as the CPU can check it: its 32-ary search, emulated here
in torch with the warp's 32 lanes as a vector axis, against the plain
versions (and ``torch.searchsorted``, per window for the ranged probe) bit
for bit where its rounds change shape (N or a window's width = 0, 1, 32,
33, 34, 1089 = 33^2, 1090), on runs of equal keys across its probe points,
on all-pad arrays and windows, on windows clipped at either end and on 2^24
keys; and against the JAX kernels in interpret mode at the small sizes
(they do O(Q N) work).  The emulation also checks that every key it reads
lies inside the query's window.  The CUDA kernels run only on the GPU,
where ``chip_smoke.py`` holds them to the same kinds of cases.
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
RANGED_QUERIES = 256                  # the ranged kernel's one shape
J_RANGED = jax.jit(functools.partial(jsk.searchsorted_left_ranged,
                                     block_q=64, block_k=JAX_KEYS,
                                     interpret=True))


def _warp_rounds(kl, v, a, b):
    """The warp search of every query at once, a (Q, 32) grid of lanes, in
    [a, b) (int64): while a query's range [a, b] is wider than 32, lane i
    probes a + (i + 1) (b - a) // 33 and the count c of probes below the
    query narrows it to [p(c - 1) + 1, p(c)]; then lane i reads a + i if
    a + i < b.  Every key read must lie in the query's window [a0, b0).
    Returns (answers, the most 32-wide rounds any query took)."""
    n = kl.shape[0]
    a0, b0 = a, b
    lane = torch.arange(LANES, dtype=torch.int64)
    rounds = 0
    while bool(((b - a) > LANES).any()):
        wide, w = (b - a) > LANES, b - a
        probe = a[:, None] + (lane + 1) * w[:, None] // 33
        read = probe[wide]
        assert bool(((read >= a0[wide, None]) & (read < b0[wide, None]))
                    .all())
        c = (kl[probe.clamp(max=n - 1)] < v).sum(1)
        lo = torch.where(c == 0, a, a + c * w // 33 + 1)
        hi = torch.where(c == LANES, b, a + (c + 1) * w // 33)
        a, b = torch.where(wide, lo, a), torch.where(wide, hi, b)
        rounds += 1
    idx = a[:, None] + lane
    inside = idx < b[:, None]
    assert bool(((idx >= a0[:, None]) & (idx < b0[:, None]) | ~inside).all())
    lt = inside & (kl[idx.clamp(min=0, max=max(n - 1, 0))] < v)
    return a + lt.sum(1), rounds


def _warp_search(keys, queries):
    """searchsorted_left_kernel for every query at once.  Returns (counts
    as int32, the most 32-wide rounds any query took)."""
    n = keys.shape[0]
    a = torch.zeros(queries.shape, dtype=torch.int64)
    if n == 0:
        return a.to(torch.int32), 0
    got, rounds = _warp_rounds(keys.long(), queries.long()[:, None], a,
                               torch.full_like(a, n))
    return got.to(torch.int32), rounds


def _warp_search_ranged(keys, queries, lo, hi):
    """searchsorted_left_ranged_kernel for every query at once, inside its
    window clipped as the kernel clips it: a = max(lo, 0), b = max(min(hi,
    n), a).  Returns (window-relative counts as int32, most rounds)."""
    n = keys.shape[0]
    a = lo.long().clamp(min=0)
    b = torch.maximum(hi.long().clamp(max=n), a)
    if n == 0:
        return torch.zeros_like(queries), 0
    got, rounds = _warp_rounds(keys.long(), queries.long()[:, None], a, b)
    return (got - a).to(torch.int32), rounds


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


def _sorted_keys(rng, n):
    """n sorted keys with duplicates, from a walk of small steps (no sort)."""
    return np.cumsum(rng.integers(0, 3, n)) - n


def _window_queries(rng, keys, a, w):
    """Queries for the window [a, a + w): its probe points' keys, each
    minus and plus one, its ends, the int32 extremes, random ones."""
    win = keys[a:a + w]
    pts = [(i + 1) * w // 33 for i in range(32)] if w > LANES else \
        list(range(w))
    vals = win[pts].astype(np.int64)
    ends = np.array([win[0], win[-1]] if w else [], np.int64)
    qs = np.concatenate([vals, vals - 1, vals + 1, ends,
                         [I32MAX, -2**31], rng.integers(-w - 5, w + 5, 6)])
    return np.clip(qs, -2**31, I32MAX)


def _ranged_case(kind, w, rng):
    """keys (n,) sorted within every window, and (queries, lo, hi)."""
    if kind == "blocks":          # shard-major: windows of width w, sorted
        S = max(1, min(4 if w < 16 else 2, JAX_KEYS // max(w, 1)))
        keys = np.concatenate([np.sort(rng.integers(-5 * w - 9, 5 * w + 9, w))
                               for _ in range(S)] or [np.zeros(0)])
        if w > 8:
            keys[w - w // 8:w] = I32MAX               # empty slots
        qs, lo, hi = [], [], []
        for s in range(S):
            q = _window_queries(rng, keys, s * w, w)
            qs.append(q)
            lo.append(np.full(q.shape, s * w))
            hi.append(np.full(q.shape, s * w + w))
        qs, lo, hi = map(np.concatenate, (qs, lo, hi))
        return keys, qs, lo, hi
    n = min(JAX_KEYS, 2 * w + 50)
    keys = _sorted_keys(rng, n)
    if kind == "runs":            # runs of equal keys across the probe points
        a = (n - w) // 2
        for i in range(0, 32, 3):
            p = a + (i + 1) * w // 33
            keys[max(a, p - 2):min(a + w, p + 3)] = keys[p]
        keys = np.maximum.accumulate(keys)
        q = _window_queries(rng, keys, a, w)
        return keys, q, np.full(q.shape, a), np.full(q.shape, a + w)
    if kind == "edges":           # clipped at both ends, at n, hi < lo, PAD
        keys[n - n // 5:] = I32MAX
        win = [(-7, w - 7), (n - w + 9, n + 9), (n - w, n), (-3, n + 3),
               (w, w - 5), (n + 4, n + 4 + w), (n - n // 5, n)]
        qs, lo, hi = [], [], []
        for l, h in win:
            q = _window_queries(rng, keys, min(max(l, 0), n), max(
                0, min(h, n) - max(l, 0)))
            if len(q) > 36:       # its ends, the extremes, 26 of the rest
                q = np.concatenate([q[-10:], rng.choice(q[:-10], 26,
                                                        replace=False)])
            qs.append(q)
            lo.append(np.full(q.shape, l))
            hi.append(np.full(q.shape, h))
        return keys, *map(np.concatenate, (qs, lo, hi))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["blocks", "runs", "edges"])
@pytest.mark.parametrize("w", [0, 1, 32, 33, 34, 1089, 1090])
def test_ranged_warp_search_matches_plain_and_jax(kind, w):
    """The emulated windowed search equals the plain version, the library
    search of each window and the JAX ranged kernel (interpret mode; keys
    padded with INT32_MAX past n, which no window reaches after
    clipping) bit for bit; the width form gives the same answers."""
    rng = np.random.default_rng(w + len(kind))
    keys, qs, lo, hi = _ranged_case(kind, w, rng)
    k, q, l, h = _t(keys), _t(qs), _t(lo), _t(hi)
    got, rounds = _warp_search_ranged(k, q, l, h)
    assert rounds <= _max_rounds(max(1, len(keys)))
    assert torch.equal(got, sk.searchsorted_left_ranged_plain(k, q, l, h))
    assert torch.equal(got, sk.searchsorted_left_ranged(k, q, l, h))
    n = len(keys)
    want = [torch.searchsorted(
        k[min(max(a, 0), n):max(min(b, n), max(a, 0))], q[i:i + 1],
        out_int32=True) for i, (a, b) in enumerate(zip(lo, hi))]
    assert torch.equal(got, torch.cat(want) if want else got)
    if kind == "blocks":
        assert torch.equal(got, sk.searchsorted_left_ranged(k, q, l, width=w))
    assert len(qs) <= RANGED_QUERIES and n <= JAX_KEYS
    jk = np.full(JAX_KEYS, I32MAX, np.int32)
    jk[:n] = keys
    pad = RANGED_QUERIES - len(qs)
    jq, jl, jh = (np.concatenate([x, np.zeros(pad, x.dtype)]).astype(np.int32)
                  for x in (qs, lo, hi))
    jh = np.minimum(jh, n)         # windows past n end at n, as clipped
    jout = np.asarray(J_RANGED(*map(jnp.asarray, (jk, jq, jl, jh))))
    np.testing.assert_array_equal(got.numpy(), jout[:len(qs)])


def test_ranged_warp_search_at_2_24_keys():
    """One window of 2^24 keys (one shard's index block) inside a longer
    array, and one ending at n: 4 rounds of 32 spread probes and one of
    adjacent keys, equal to the plain version and the library search."""
    rng = np.random.default_rng(2)
    n = 2**24 + 1000
    keys = _sorted_keys(rng, n)
    keys[-(n // 8):] = I32MAX
    qs = np.concatenate([_window_queries(rng, keys, 500, 2**24),
                         _window_queries(rng, keys, 1000, n - 1000)])
    m = len(qs) // 2
    lo = np.where(np.arange(len(qs)) < m, 500, 1000)
    hi = np.where(np.arange(len(qs)) < m, 500 + 2**24, n)
    k, q, l, h = _t(keys), _t(qs), _t(lo), _t(hi)
    got, rounds = _warp_search_ranged(k, q, l, h)
    assert rounds == _max_rounds(2**24) == 4
    assert torch.equal(got, sk.searchsorted_left_ranged_plain(k, q, l, h))
    want = torch.cat([torch.searchsorted(k[500:500 + 2**24], q[:m],
                                         out_int32=True),
                      torch.searchsorted(k[1000:], q[m:], out_int32=True)])
    assert torch.equal(got, want)
