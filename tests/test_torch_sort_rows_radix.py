"""PyTorch port, the radix ``sort_rows`` kernel (``csrc/dedup_compact.cu``,
``sort_radix_kernel``) as far as the CPU can check it: the plain version
(PAD dropped, one stable reorder per digit pass of (key - row min), PAD
after the valid keys) bit for bit against the jitted JAX ref, ``torch.sort``
and the port's ref backend on rows of 0 to 4 digit passes, negative keys
and the int32 extremes, all-PAD and one-key rows and the star merge's
layout (Bmax sorted-unique runs with PAD between them), R = 0 and W = 0;
one case against the Pallas kernel in interpret mode; and the kernel
emulated step by step (``test_torch_dedup_radix``'s emulation of the
routine it shares with the dedup, then its own last write) with its key
buffers in shared memory, one of them in a scratch row, and the first in
the output row.  Also: ``chip_smoke.py``'s PROFILE lines count every
``__global__`` kernel of the port as its own.  The CUDA kernel runs only
on the GPU, where ``chip_smoke.py`` holds it to the same kinds of cases.
"""
import importlib.util
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.dedup_compact import kernel as dk
from repro_torch.kernels.dedup_compact import ref as dref

from test_torch_dedup_radix import _rows, emulate_sort
from test_torch_kernels import J_SORT, J_SORT_REF
from test_torch_store_index_edges import one_torch_thread  # noqa: F401

PAD = 2**31 - 1
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cs():
    """chip_smoke.py, for its merge layout and its profile's kernel names."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _all_kinds(W, rng, cs):
    """Every row kind of the dedup tests (0 to 4 passes, negative keys, the
    int32 extremes, all-PAD and one-key rows) and two rows of the merge
    layout (Bmax sorted-unique runs of width F, PAD between them)."""
    x, _, passes = _rows(W, rng)
    bmax = 2 if W % 2 == 0 else (3 if W % 3 == 0 else 1)
    merge = cs._merge_layout(rng, 2, bmax, W // bmax)
    return np.concatenate([x, merge.astype(np.int32)]), passes


def _assert_sorts(x):
    got = dk.sort_rows(torch.as_tensor(x))
    want = np.asarray(J_SORT_REF(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, torch.sort(torch.as_tensor(x), dim=1).values)
    assert torch.equal(got, dref.sort_rows(torch.as_tensor(x)))
    return got.numpy()


@pytest.mark.parametrize("W", [1, 31, 2048, 2049, 8192])
def test_plain_matches_jax_torch_and_ref_backend(W, cs):
    """Every row kind, its digit passes those its range needs (from 31
    columns, where each kind's range shows)."""
    x, passes = _all_kinds(W, np.random.default_rng(W), cs)
    got = _assert_sorts(x)
    if W > 1:
        assert dk.dedup_passes(torch.as_tensor(x)).tolist()[:len(passes)] \
            == passes
    assert (got[4] == PAD).all()                      # the all-PAD row


def test_plain_r0_w0_and_extremes():
    """R = 0, W = 0, and a row of the int32 extremes with PAD among them."""
    for x in (np.zeros((0, 5), np.int32), np.zeros((3, 0), np.int32),
              np.array([[PAD, -2**31, PAD - 1, -2**31, 0, PAD, -1]],
                       np.int32)):
        _assert_sorts(x)


def test_plain_matches_the_pallas_kernel(cs):
    """The plain version against the TPU kernel in interpret mode."""
    x, _ = _all_kinds(100, np.random.default_rng(100), cs)
    x = x[[0, 1, 4, 8, 9, -1]]
    np.testing.assert_array_equal(dk.sort_rows(torch.as_tensor(x)).numpy(),
                                  np.asarray(J_SORT(jnp.asarray(x))))


@pytest.mark.parametrize("W", [33, 257])
def test_emulated_kernel_matches_plain(W, cs):
    """The emulated sort kernel equals the plain version on every row kind,
    with both key buffers in shared memory, the second in a scratch row
    and the first in the output row (every other pass writing there)."""
    x, _ = _all_kinds(W, np.random.default_rng(W + 1), cs)
    want = dk.sort_rows(torch.as_tensor(x)).numpy()
    passes = dk.dedup_passes(torch.as_tensor(x)).tolist()
    for r in range(x.shape[0]):
        nv = int((x[r] != PAD).sum())
        for key_cap in (2 * W, W, W // 2 - 1):
            out, p, wrote = emulate_sort(x[r], key_cap=key_cap, seed=r)
            np.testing.assert_array_equal(out, want[r])
            assert p == passes[r]
            if nv > key_cap and p:            # A is the output row
                assert ("A", "out") in wrote
                assert sum(wh != "smem" for _, wh in wrote) == p


def test_profile_counts_every_port_kernel(cs):
    """PROFILE's own kernels are every ``__global__`` function of the
    port's CUDA sources, by name: the renamed radix kernels among them,
    and a name that merely contains another's is not taken for it."""
    names = set()
    n_global = 0
    for path in (ROOT / "src" / "repro_torch" / "csrc").glob("*.cu*"):
        src = path.read_text()
        n_global += src.count("__global__")
        for at in re.finditer(r"__global__", src):
            head = re.sub(r"__launch_bounds__\([^)]*\)", "",
                          src[at.end():at.end() + 300])
            names.add(head.split("(")[0].split()[-1])
    assert len(names) == n_global
    assert names == set(cs.OWN_KERNELS)
    assert {"dedup_radix_kernel", "knn_merge_warp_kernel",
            "sort_radix_kernel", "segment_spmm_kernel",
            "embedding_bag_kernel"} <= names
    for name in names:
        assert cs._is_own(f"void (anonymous namespace)::{name}<4, 8>(int)")
        assert cs._is_own(f"(anonymous namespace)::{name}(int const*, int)")
        assert cs._is_own(f"_ZN12_GLOBAL__N_1{len(name)}{name}EPKi")
    assert not cs._is_own("(anonymous namespace)::knn_merge_kernel_v2(int)")
    assert not cs._is_own("void at::native::vectorized_elementwise_kernel"
                          "<4, at::native::FillFunctor<int> >(int)")
