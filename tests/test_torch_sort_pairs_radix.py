"""PyTorch port, the radix ``sort_pairs`` kernel (``csrc/sort_pairs.cu``) as
far as the CPU can check it: the kernel emulated step by step in numpy at a
tiny tile (so that a sort spans many tiles): the histogram blocks' counts of
all eight digits, pass 0's reduction into offsets and the mask of digits
that vary, and for each varying digit the per-warp ranks (the lanes of one
digit grouped as ``__match_any_sync`` groups them), the tiles' counts found
by decoupled look-back in a shuffled completion order, the tile placed in
digit order and written out by runs, and the two key buffers' parity (the
buffers start as garbage, so a pass that read the wrong one would show).
The emulation and ``sort_pairs_plain`` are held bit for bit against
``jax.lax.sort((k1, k2), num_keys=2)`` and, at one small width, against the
Pallas kernel in interpret mode.  The CUDA kernel runs only on the GPU,
where ``chip_smoke.py`` holds it to the same kinds of cases.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dedup_compact import kernel as jdk
from repro_torch.kernels.dedup_compact import kernel as dk

from test_torch_store_index_edges import one_torch_thread  # noqa: F401

I32MIN, I32MAX = -2**31, 2**31 - 1
LANES = 32
SRC = pathlib.Path(dk.__file__).resolve().parents[2] / "csrc" / "sort_pairs.cu"
J_SORT = jax.jit(lambda a, b: jax.lax.sort((a, b), num_keys=2))
J_PAIRS = jax.jit(lambda a, b: jdk.sort_pairs(a, b, interpret=True))
GARBAGE = np.uint64(0x5A5A5A5A5A5A5A5A)


def _pack(k1, k2):
    hi = (k1.astype(np.int64).astype(np.uint32) ^ np.uint32(0x80000000))
    lo = (k2.astype(np.int64).astype(np.uint32) ^ np.uint32(0x80000000))
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def _unpack(key):
    hi = (key >> np.uint64(32)).astype(np.uint32) ^ np.uint32(0x80000000)
    lo = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32) ^ \
        np.uint32(0x80000000)
    return hi.view(np.int32), lo.view(np.int32)


def _digit(key, d):
    return ((key >> np.uint64(8 * d)) & np.uint64(255)).astype(np.int64)


def _hist(key, hist_keys, max_blocks):
    """radix_hist_kernel: block g counts the chunks of ``hist_keys`` keys
    the grid-stride loop gives it (chunk c to block c % G); part[g, d, b]."""
    W = key.shape[0]
    G = min(-(-W // hist_keys), max_blocks)
    blk = (np.arange(W) // hist_keys) % G
    part = np.zeros((G, dk.DIGITS, dk.RADIX), np.int64)
    for d in range(dk.DIGITS):
        np.add.at(part[:, d], (blk, _digit(key, d)), 1)
    return part


def _warp_ranks(dg, valid, wh):
    """One item of one warp: each lane's rank among the warp's keys of its
    digit so far; the leader (lowest lane) of each digit's lanes adds them
    to the warp's counts ``wh``."""
    same = (dg[:, None] == dg[None, :]) & valid[:, None] & valid[None, :]
    below = np.tril(np.ones((LANES, LANES), bool), -1)   # lane l' < l
    lt = (same & below).sum(1)
    before = np.where(valid, wh[np.where(valid, dg, 0)], 0)
    lead = valid & (lt == 0)
    wh[dg[lead]] = before[lead] + same[lead].sum(1)
    return before + lt


def _look_back(counts, rng, look=4):
    """Each tile's exclusive prefix per bucket by decoupled look-back: every
    tile publishes its own counts (flag A; tile 0 its prefix, flag P), then
    the tiles finish in a shuffled order, each adding the words of the
    tiles before it, ``look`` at a time, until a P."""
    n_tiles = counts.shape[0]
    flag = np.full(n_tiles, "A")
    flag[0] = "P"
    val = counts.copy()
    prefix = np.zeros_like(counts)
    for t in rng.permutation(np.arange(1, n_tiles)):
        u, done = t - 1, False
        while not done:
            for _ in range(look):
                prefix[t] += val[u]
                u -= 1
                if flag[u + 1] == "P":
                    done = True
                    break
        flag[t], val[t] = "P", prefix[t] + counts[t]
    return prefix


def emulate(k1, k2, *, warps=2, items=1, hist_keys=128, hist_max=3, seed=0):
    """The radix kernel on numpy arrays, step by step; returns (o1, o2) and
    the mask of digits that ran."""
    rng = np.random.default_rng(seed)
    key0 = _pack(np.asarray(k1), np.asarray(k2))
    W = key0.shape[0]
    tile = warps * LANES * items
    assert hist_keys >= tile          # pass-0 tile g adds block g's counts
    part = _hist(key0, hist_keys, hist_max)
    total = part.sum(0)                                # pass 0's reduction
    const = (total == W).any(1)
    offs = np.cumsum(total, 1) - total
    mask = sum(1 << d for d in range(dk.DIGITS) if not const[d])
    o1 = np.full(W, 0x77, np.int32)
    o2 = np.full(W, 0x77, np.int32)
    if mask == 0:
        return np.asarray(k1, np.int32), np.asarray(k2, np.int32), mask
    buf = [np.full(W, GARBAGE), np.full(W, GARBAGE)]
    n_tiles = -(-W // tile)
    for p in range(dk.DIGITS):
        if not mask >> p & 1:
            continue
        r = bin(mask & ((1 << p) - 1)).count("1")
        first, last = r == 0, (mask >> (p + 1)) == 0
        src = key0 if first else buf[(r + 1) & 1]
        assert not (src == GARBAGE).any()
        counts = np.zeros((n_tiles, dk.RADIX), np.int64)
        tiles = []
        for t in range(n_tiles):
            base, n = t * tile, min(tile, W - t * tile)
            whist = np.zeros((warps, dk.RADIX), np.int64)
            rank = np.zeros((warps, items, LANES), np.int64)
            keys = np.zeros((warps, items, LANES), np.uint64)
            for w in range(warps):
                for j in range(items):
                    i = w * LANES * items + j * LANES + np.arange(LANES)
                    valid = i < n
                    keys[w, j, valid] = src[base + i[valid]]
                    dg = np.where(valid, _digit(keys[w, j], p), 256)
                    rank[w, j] = _warp_ranks(dg, valid, whist[w])
            counts[t] = whist.sum(0)
            tiles.append((base, n, keys, rank, whist))
        prefix = _look_back(counts, rng)
        dst = buf[r & 1]
        for t, (base, n, keys, rank, whist) in enumerate(tiles):
            warp_off = np.cumsum(whist, 0) - whist
            excl = np.cumsum(counts[t]) - counts[t]
            glob = offs[p] + prefix[t] - excl
            s_keys = np.full(n, GARBAGE)
            for w in range(warps):
                for j in range(items):
                    i = w * LANES * items + j * LANES + np.arange(LANES)
                    v = i < n
                    dg = _digit(keys[w, j, v], p)
                    s_keys[excl[dg] + warp_off[w, dg] + rank[w, j, v]] = \
                        keys[w, j, v]
            assert not (s_keys == GARBAGE).any()
            pos = glob[_digit(s_keys, p)] + np.arange(n)
            if last:
                o1[pos], o2[pos] = _unpack(s_keys)
            else:
                dst[pos] = s_keys
    return o1, o2, mask


def _case(kind, W, rng):
    if kind == "random":              # every digit varies: eight passes
        return (rng.integers(I32MIN, I32MAX, W, endpoint=True),
                rng.integers(I32MIN, I32MAX, W, endpoint=True))
    if kind == "equal":
        return np.full(W, 7), np.full(W, -3)
    if kind == "one_digit":           # only digit 1 of k2
        return np.full(W, 5), rng.integers(0, 256, W) << 8
    if kind == "k1_only":
        return rng.integers(-40, 40, W), np.full(W, I32MAX)
    if kind == "ghosts":              # (seg, gid) with 99 % ghosts (R, PAD)
        k1 = rng.integers(0, 64, W)
        k2 = rng.integers(0, 14_500_000, W)
        ghost = rng.random(W) < 0.99
        k1[ghost], k2[ghost] = 64, I32MAX
        return k1, k2
    if kind == "extremes":            # the sign flips, negative k1
        ext = np.array([I32MIN, I32MIN + 1, -1, 0, 1, I32MAX - 1, I32MAX])
        return rng.choice(ext, W), rng.choice(ext, W)
    raise ValueError(kind)


def _check(k1, k2, **kw):
    k1 = np.asarray(k1, np.int32)
    k2 = np.asarray(k2, np.int32)
    o1, o2, mask = emulate(k1, k2, **kw)
    j1, j2 = (np.asarray(x) for x in J_SORT(jnp.asarray(k1), jnp.asarray(k2)))
    np.testing.assert_array_equal(o1, j1)
    np.testing.assert_array_equal(o2, j2)
    p1, p2 = dk.sort_pairs_plain(torch.as_tensor(k1), torch.as_tensor(k2))
    np.testing.assert_array_equal(p1.numpy(), j1)
    np.testing.assert_array_equal(p2.numpy(), j2)
    assert mask == dk.radix_mask(dk.radix_keys(torch.as_tensor(k1),
                                               torch.as_tensor(k2)))
    return mask


@pytest.mark.parametrize("kind,W,want_mask", [
    ("random", 1, 0), ("equal", 1000, 0), ("one_digit", 700, 0b10),
    ("k1_only", 500, None), ("ghosts", 3000, None), ("extremes", 640, None),
    ("random", 1000, 0xFF)])
def test_radix_emulation_matches_jax(kind, W, want_mask):
    """The emulated kernel at 64 keys a tile (many tiles, offsets across
    them) and ``sort_pairs_plain`` equal ``jax.lax.sort``; the mask is the
    digits that vary."""
    rng = np.random.default_rng(W)
    mask = _check(*_case(kind, W, rng))
    if want_mask is not None:
        assert mask == want_mask
    if kind == "k1_only":
        assert mask >> 4 and not mask & 0xF      # only high-word digits
    if kind == "ghosts":                         # the main path's digits
        assert mask & 0b11111 and not mask >> 5


@pytest.mark.parametrize("W", [63, 64, 65, 129, dk.SMALL_MAX - 1,
                               dk.SMALL_MAX, dk.SMALL_MAX + 1])
def test_radix_emulation_widths(W):
    """Widths around the emulated tile and around the one-launch threshold
    (the wrapper's routing point): the (seg, gid) law of the main path."""
    rng = np.random.default_rng(W)
    _check(*_case("ghosts" if W > 200 else "random", W, rng))


def test_radix_emulation_at_the_kernel_tile():
    """The kernel's own shapes (8 warps x 8 keys a thread, histogram
    blocks of 4,096 keys) over several tiles."""
    rng = np.random.default_rng(3)
    W = 3 * dk.TILE + 17
    k1, k2 = _case("ghosts", W, rng)
    k2[: W // 3] = rng.integers(I32MIN, I32MAX, W // 3)
    _check(k1, k2, warps=8, items=8, hist_keys=dk.HIST_KEYS,
           hist_max=dk.HIST_MAX_BLOCKS)


def test_plain_matches_the_pallas_kernel():
    """``sort_pairs_plain`` against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(200)
    k1, k2 = (np.asarray(x, np.int32) for x in _case("extremes", 200, rng))
    k1[::5] = rng.integers(0, 9, k1[::5].shape[0])
    p = dk.sort_pairs_plain(torch.as_tensor(k1), torch.as_tensor(k2))
    for got, want in zip(p, J_PAIRS(jnp.asarray(k1), jnp.asarray(k2))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_python_mirrors_the_source():
    """The wrapper's copies of the kernel's shapes (tile, histogram blocks,
    the one-launch threshold) and its scratch size agree with the source."""
    src = SRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert dk.TILE == const("kThreads") * const("kItems")
    assert dk.HIST_KEYS == const("kHistThreads") * const("kHistItems")
    assert dk.HIST_KEYS >= dk.TILE
    assert dk.HIST_MAX_BLOCKS == const("kHistMaxBlocks")
    assert dk.SMALL_MAX == const("kSmallMax")
    assert 8 * dk.SMALL_MAX <= 48 * 1024
    assert const("kHeader") == 32
    W = 442_624
    n_tiles, n_hist = -(-W // dk.TILE), -(-W // dk.HIST_KEYS)
    assert dk.radix_scratch_bytes(W) == 16 * W + 4 * (
        n_hist * 2048 + 32 + 2048 + 8 * n_tiles * 256)
