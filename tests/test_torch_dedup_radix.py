"""PyTorch port, the radix ``dedup_compact_rows`` kernel
(``csrc/dedup_compact.cu``) as far as the CPU can check it: the plain
version (PAD dropped, one stable reorder per digit pass of (key - row min),
then the first-of-run compaction) against the JAX ref on rows over the
full int32 range, negative values, -1 as a row's smallest value, constant,
all-PAD and one-key rows, rows whose range needs 1 to 4 digit passes, cap
at and past the width, W = 0 and widths past the emulated tile edges; one
case against the Pallas kernel in interpret mode; and the kernel emulated
step by step in numpy at a small block (the routine both kernels share,
radix_sort_row: per-warp segments and 16-bit digit counts, the bucket
scan, the ranked scatter, the A/B buffer rule; then the dedup's
first-of-run count and write by warps, or the sort's write of A and PAD),
the gathered keys shuffled (their order in the kernel is that of its
atomics).  The CUDA kernel runs only on the GPU, where ``chip_smoke.py``
holds it to the same kinds of cases.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.dedup_compact import kernel as dk

from test_torch_kernels import J_DEDUP, J_DEDUP_REF
from test_torch_store_index_edges import one_torch_thread  # noqa: F401

I32MIN, I32MAX = -2**31, 2**31 - 1
PAD = I32MAX
SRC = pathlib.Path(dk.__file__).resolve().parents[2] / "csrc" / \
    "dedup_compact.cu"


def _rows(W, rng):
    """One row of each kind (its digit passes beside it), 30 % PAD where
    the kind allows."""
    def some(lo, hi):
        return rng.integers(lo, hi, W, endpoint=True)
    kinds = [
        ("full int32 range", some(I32MIN, I32MAX - 1), 4),
        ("negative", some(-50, 50), 1),
        ("-1 smallest", np.where(rng.random(W) < 0.2, -1, some(0, 200)), 1),
        ("constant", np.full(W, 7), 0),
        ("all PAD", np.full(W, PAD), 0),
        ("1 digit", some(1000, 1255), 1),
        ("2 digits", some(0, 65_535), 2),
        ("3 digits (gids)", some(0, 14_500_063), 3),
        ("4 digits", np.where(rng.random(W) < 0.5, I32MIN, I32MAX - 1), 4),
        ("one key", np.where(np.arange(W) == W // 2, -9, PAD), 0),
        ("only -1", np.full(W, -1), 0),
        ("-1 and 5", np.where(rng.random(W) < 0.5, -1, 5), 1),
    ]
    x = np.stack([k[1] for k in kinds]).astype(np.int64)
    pad = rng.random(x.shape) < 0.3
    pad[[3, 9, 10]] = False
    x[pad] = PAD
    x[1, :2] = [-50, 50][:W]            # keep the kind's range
    return x.astype(np.int32), [k[0] for k in kinds], [k[2] for k in kinds]


def _assert_matches_jax(x, cap):
    got_g, got_n = dk.dedup_compact_rows(torch.as_tensor(x), cap)
    want_g, want_n = J_DEDUP_REF(jnp.asarray(x), cap=cap)
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    return got_g.numpy(), got_n.numpy()


@pytest.mark.parametrize("W,cap", [(300, 64), (300, 300), (300, 512),
                                   (1025, 100)])
def test_plain_matches_jax_ref(W, cap):
    """Every row kind at a cap below, at and past the width, and past the
    emulated tile edges; the digit passes are those the range needs."""
    rng = np.random.default_rng(W + cap)
    x, names, passes = _rows(W, rng)
    g, n = _assert_matches_jax(x, cap)
    assert dk.dedup_passes(torch.as_tensor(x)).tolist() == passes
    assert n[names.index("all PAD")] == 0 and n[names.index("only -1")] == 0
    assert n[names.index("constant")] == 1 and n[names.index("one key")] == 1
    assert n[names.index("-1 and 5")] == 1           # -1 in slot 0: dropped
    assert g[names.index("-1 and 5"), 0] == 5


def test_plain_w0_r0_and_one_column():
    for x in (np.zeros((3, 0), np.int32), np.zeros((0, 4), np.int32),
              np.array([[PAD], [-1], [4]], np.int32)):
        _assert_matches_jax(x, 5)


def test_plain_matches_the_pallas_kernel():
    """The plain version against the TPU kernel in interpret mode."""
    x, _, _ = _rows(37, np.random.default_rng(37))
    got_g, got_n = dk.dedup_compact_rows(torch.as_tensor(x[:4]), 40)
    want_g, want_n = J_DEDUP(jnp.asarray(x[:4]), cap=40)
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


# ---------------------------------------------------------------------------
# the kernel, emulated
# ---------------------------------------------------------------------------

def _radix_pass(src, n_src, mn, shift, warps, items, drop_pad):
    """radix_pass: warp w counts its segment's digits (16-bit counts), the
    bucket scan gives starts, each warp writes its keys 32 at a time, each
    group ranked by its lanes of one digit; returns dst (garbage past n)."""
    threads = warps * 32
    seg = -(-n_src // threads) * 32
    keys = [src[min(n_src, w * seg):min(n_src, w * seg + seg)]
            for w in range(warps)]
    valid = [k != PAD if drop_pad else np.ones(len(k), bool) for k in keys]
    digit = [((k.astype(np.int64) - mn) & 0xFFFFFFFF) >> shift & 255
             for k in keys]
    hist = np.zeros((warps, 256), np.int64)
    for w in range(warps):
        for base in range(0, len(keys[w]), 32 * items):   # loads, then groups
            for j in range(items):
                sl = slice(base + 32 * j, base + 32 * j + 32)
                np.add.at(hist[w], digit[w][sl][valid[w][sl]], 1)
    total = hist.sum(0)
    warp_start = np.cumsum(hist, 0) - hist          # inside each bucket
    assert warp_start.max() < 2**16                 # 16-bit counts
    start = np.cumsum(total) - total
    dst = np.full(max(1, int(total.sum())), 0x5A5A5A5A, np.int64)
    for w in range(warps):
        run = warp_start[w].copy()
        for g0 in range(0, len(keys[w]), 32):
            v, d = keys[w][g0:g0 + 32], digit[w][g0:g0 + 32]
            ok = valid[w][g0:g0 + 32]
            for lane in np.flatnonzero(ok):          # rank among the peers
                peers_below = (ok[:lane] & (d[:lane] == d[lane])).sum()
                dst[start[d[lane]] + run[d[lane]] + peers_below] = v[lane]
            np.add.at(run, d[ok], 1)
    return dst


def emulate_row(x, *, warps=4, items=2, key_cap=None, seed=0,
                a_global="global"):
    """radix_sort_row (steps 1 and 2, shared by both kernels) on one row;
    returns (A[0, n) after the passes or None when there are none, n, the
    valid keys' min, passes, the buffers the passes wrote).  ``a_global``
    names the global row A lies in when n > key_cap: a scratch row for the
    dedup, the output row for the sort."""
    rng = np.random.default_rng(seed)
    w = x.shape[0]
    if key_cap is None:
        key_cap = 2 * w
    x = x.astype(np.int64)
    v = x[x != PAD]
    n = v.shape[0]
    gather = n <= key_cap // 2           # all valid keys gathered
    if n == 0 or v.min() == v.max():
        return None, n, int(v[0]) if n else PAD, 0, []
    mn = int(v.min())
    span = int(v.max()) - mn
    passes = (span.bit_length() + 7) // 8
    wrote = []
    src, n_src = (rng.permutation(v), n) if gather else (x, w)
    for p in range(passes):
        into_a = (passes - 1 - p) % 2 == 0
        where = "smem" if gather or (n <= key_cap if into_a
                                     else 2 * n <= key_cap) else \
            (a_global if into_a else "global")
        wrote.append(("A" if into_a else "B", where))
        src = _radix_pass(src, n_src, mn, 8 * p, warps, items,
                          drop_pad=p == 0 and not gather)[:n]
        n_src = n
    assert wrote[-1][0] == "A"
    return src, n, mn, passes, wrote


def emulate(x, cap, *, warps=4, items=2, key_cap=None, seed=0):
    """dedup_radix_kernel on one row; returns (out, count, passes, the
    buffers the passes wrote)."""
    threads = warps * 32
    a, n, mn, passes, wrote = emulate_row(x, warps=warps, items=items,
                                          key_cap=key_cap, seed=seed)
    out = np.full(cap, PAD, np.int64)
    if passes == 0:
        total = int(n > 0 and mn != -1)
        out[:min(total, cap)] = mn
        return out, total, 0, []
    seg = -(-n // threads) * 32
    prev = np.concatenate([[-1], a[:-1]])
    first = a != prev
    counts = [int(first[w_ * seg:w_ * seg + seg].sum()) for w_ in range(warps)]
    rank = np.cumsum(counts) - counts
    for w_ in range(warps):
        sl = slice(w_ * seg, w_ * seg + seg)
        at = rank[w_] + np.cumsum(first[sl]) - 1
        keep = first[sl] & (at < cap)
        out[at[keep]] = a[sl][keep]
    return out, int(sum(counts)), passes, wrote


def emulate_sort(x, *, warps=4, items=2, key_cap=None, seed=0):
    """sort_radix_kernel on one row: radix_sort_row with the output row as
    A's global row, then A[0, n) (n copies of the min when there are no
    passes) and PAD after it; returns (out, passes, the buffers the passes
    wrote)."""
    a, n, mn, passes, wrote = emulate_row(x, warps=warps, items=items,
                                          key_cap=key_cap, seed=seed,
                                          a_global="out")
    out = np.full(x.shape[0], PAD, np.int64)
    out[:n] = mn if passes == 0 else a
    return out, passes, wrote


@pytest.mark.parametrize("W", [1, 31, 32, 33, 255, 256, 257, 300, 1025])
def test_emulated_kernel_matches_plain(W):
    """The emulated kernel equals the plain version on every row kind, with
    the valid keys gathered (both buffers in shared memory) and read from
    the row (the second buffer, or both, in the scratch rows)."""
    rng = np.random.default_rng(W)
    x, _, _ = _rows(W, rng)
    passes = dk.dedup_passes(torch.as_tensor(x)).tolist()
    cap = max(1, W // 3)
    g, n = (t.numpy() for t in dk.dedup_compact_rows(torch.as_tensor(x), cap))
    for r in range(x.shape[0]):
        for key_cap in (2 * W, W, W // 2 - 1):
            out, count, p, wrote = emulate(x[r], cap, key_cap=key_cap,
                                           seed=r)
            np.testing.assert_array_equal(out, g[r])
            assert count == n[r] and p == passes[r]
            nv = int((x[r] != PAD).sum())
            if key_cap // 2 < nv <= key_cap:   # pass 0 reads the row, B
                # lies in the scratch rows: every other pass writes there
                assert sum(wh == "global" for _, wh in wrote) == p // 2


def test_python_mirrors_the_source():
    """The wrapper's copies of the kernel's shapes (threads, shared memory,
    scratch words) agree with the source, and the widest row keeps the
    16-bit digit counts."""
    src = SRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert dk.DEDUP_THREADS == const("kDedupThreads")
    assert dk.DEDUP_THREADS_SMALL == const("kDedupThreadsSmall")
    assert dk.DEDUP_SMALL_W == const("kDedupSmallW")
    assert dk.SMEM_MAX == const("kSmemMax") and dk.RADIX == const("kRadix")
    assert dk.DEDUP_RED == const("kRed")
    assert dk.MAX_W < 2**16
    assert dk.dedup_key_cap(36_866) == 53_632
    assert dk.dedup_scratch_words(128, 36_866) == 128 * 36_866
    assert dk.dedup_scratch_words(2, dk.MAX_W) == 2 * 2 * dk.MAX_W
    assert dk.dedup_scratch_words(4, 16_384) == 0
    assert dk.dedup_key_cap(100) == 200
    # one radix routine for both kernels: a single radix_pass and buffer
    # rule, called from the sort's and the dedup's kernel; no bitonic
    # network is left; the sort's scratch is B's rows alone (A's global
    # row is its output row) and its C entry takes no virtual width
    assert src.count("void radix_pass(") == 1
    assert src.count("__device__ SortedRow radix_sort_row(") == 1
    assert src.count("A = n <= key_cap ? keys : a_glob;") == 1
    for kern in ("sort_radix_kernel", "dedup_radix_kernel"):
        body = src.split(f"\n{kern}(")[1].split("\n}\n")[0]
        assert body.count("radix_sort_row(") == 1, kern
    sort_body = src.split("\nsort_radix_kernel(")[1].split("\n}\n")[0]
    assert "key_cap, o,\n" in sort_body
    assert "bitonic_sort_shared" not in src and "sort_rows_kernel" not in src
    entry = re.search(r'extern "C" int sort_rows\(([^)]*)\)', src).group(1)
    assert len(entry.split(",")) == len(dk._SORT_ARGS) == 7
    assert "w2" not in entry
    assert "2LL * w <= l.key_cap ? 0 : (long long)n_rows * w;" in src
    assert dk.sort_scratch_words(64, 8192) == 0
    assert dk.sort_scratch_words(4, 26_816) == 0
    assert dk.sort_scratch_words(4, 26_817) == 4 * 26_817
    assert dk.sort_scratch_words(2, dk.MAX_W) == 2 * dk.MAX_W
