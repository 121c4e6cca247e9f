"""PyTorch port, the fanout sampler (``data/sampler.py``): ``csr_from_coo``,
``fanout_sample`` / ``sample_layers`` given JAX's own draws, and
``build_sampled_batch``, bit for bit, on a graph whose last nodes have no
out-edges, from seeds with a -1 among them (JAX's gathers wrap and clamp
there; the port's clamp first); ``fanout_sample_db`` over a film KG that
the port's write path loads, bit for bit against JAX's over the same KG;
and the JAX layout test on the port's own draws.  The JAX side is the
committed fixture (``tests/fixtures/torch_zoo_rest``); only
``csr_from_coo``, numpy on the host, runs live.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_zoo_rest_script as script
from repro.data import sampler as jsampler
from repro_torch.core.addressing import StoreConfig
from repro_torch.data import sampler as tsampler
from repro_torch.data.kg import load_film_kg

from test_torch_store_index_edges import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_zoo_rest"


@pytest.fixture(scope="module")
def jax_side():
    meta = json.loads((FIXTURE / "zoo_rest.json").read_text())
    with np.load(FIXTURE / "zoo_rest.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return meta, arrays


def _csr():
    src, dst = script.sample_graph()
    return tsampler.csr_from_coo(script.SAMPLE["n"], torch.from_numpy(src),
                                 torch.from_numpy(dst))


def test_csr_from_coo_equals_jax(jax_side):
    _, arrays = jax_side
    src, dst = script.sample_graph()
    indptr, indices = _csr()
    jp, ji = jsampler.csr_from_coo(script.SAMPLE["n"], src, dst)
    for got, want in ((indptr, jp), (indices, ji)):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(indptr.numpy(), arrays["sample/indptr"])
    assert np.array_equal(indices.numpy(), arrays["sample/indices"])
    # numpy inputs take the device argument
    ip2, ix2 = tsampler.csr_from_coo(script.SAMPLE["n"], src, dst,
                                     device="cpu")
    assert torch.equal(ip2, indptr) and torch.equal(ix2, indices)
    # the graph has what the cases need: zero-degree nodes, the last too
    deg = np.diff(indptr.numpy())
    assert deg[-1] == 0 and (deg == 0).sum() >= 3


def _draws(arrays):
    return [torch.from_numpy(arrays[f"sample/draws/{h}"])
            for h in range(len(script.SAMPLE["fanouts"]))]


def test_sample_from_jax_draws_is_bit_equal(jax_side):
    _, arrays = jax_side
    indptr, indices = _csr()
    seeds = torch.tensor(script.SAMPLE_SEEDS, dtype=torch.int32)
    gids, es, ed = tsampler.sample_layers(indptr, indices, seeds,
                                          _draws(arrays))
    for got, name in ((gids, "gids"), (es, "edge_src"), (ed, "edge_dst")):
        assert got.dtype == torch.int32, name
        assert np.array_equal(got.numpy(), arrays[f"sample/{name}"]), name
    # the -1 seed and the zero-degree seeds sampled nothing
    B, f1 = len(script.SAMPLE_SEEDS), script.SAMPLE["fanouts"][0]
    deg = np.diff(indptr.numpy())
    for i, s in enumerate(script.SAMPLE_SEEDS):
        hop1 = gids[B + i * f1:B + (i + 1) * f1]
        assert bool((hop1 < 0).all()) == (s < 0 or deg[s] == 0), s
    with pytest.raises(ValueError):
        tsampler.sample_layers(indptr, indices, seeds[:3], _draws(arrays))


def test_build_sampled_batch_is_bit_equal(jax_side):
    """``build_sampled_batch``'s assembly (``sampled_batch``) of the
    sample from JAX's draws."""
    _, arrays = jax_side
    indptr, indices = _csr()
    feats, labels = script.sample_data()
    seeds = torch.tensor(script.SAMPLE_SEEDS, dtype=torch.int32)
    b = tsampler.sampled_batch(
        torch.from_numpy(feats), torch.from_numpy(labels), seeds,
        *tsampler.sample_layers(indptr, indices, seeds, _draws(arrays)))
    for name in ("node_feat", "edge_src", "edge_dst", "labels",
                 "train_mask"):
        got, want = getattr(b, name).numpy(), arrays[f"sample/batch/{name}"]
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name


def test_fanout_sample_db_is_bit_equal(jax_side):
    """Over the KG the port's write path loads (equal to JAX's field by
    field, ``test_torch_writes.py``), the same ``get_edges`` lists and the
    same ``default_rng`` picks."""
    meta, arrays = jax_side
    kg = load_film_kg(**script.DB_KG, cfg=StoreConfig(**script.DB_CFG),
                      device="cpu")
    assert kg.db.clock == meta["sample_db_clock"]
    for i, (seeds, fanouts, etype, seed) in enumerate(script.DB_CASES):
        out = tsampler.fanout_sample_db(kg.db, seeds, fanouts=fanouts,
                                        etype=etype, seed=seed, cap=1)
        for name, got in zip(("gids", "edge_src", "edge_dst"), out):
            want = arrays[f"sample_db/{i}/{name}"]
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                (i, name)
        assert (out[0][len(seeds):] >= 0).any()


def test_sampler_layered_layout():
    """The JAX test (tests/test_models.py) on the port's own draws, plus
    the slot layout and the masks."""
    rng = np.random.default_rng(0)
    N = 50
    src = rng.integers(0, N, 400).astype(np.int32)
    dst = rng.integers(0, N, 400).astype(np.int32)
    indptr, indices = tsampler.csr_from_coo(N, torch.from_numpy(src),
                                            torch.from_numpy(dst))
    seeds = torch.from_numpy(rng.choice(N, 8, replace=False)
                             .astype(np.int32))
    gen = torch.Generator().manual_seed(0)
    gids, es, ed = tsampler.fanout_sample(indptr, indices, seeds, gen,
                                          fanouts=(4, 3))
    assert gids.shape[0] == 8 * (1 + 4 + 12)
    assert es.shape == ed.shape == (8 * 4 + 32 * 3,)
    ip, ix, g = indptr.numpy(), indices.numpy(), gids.numpy()
    for e_s, e_d in zip(es.numpy(), ed.numpy()):
        if e_s < 0:
            continue
        child, parent = g[e_s], g[e_d]
        if parent < 0:
            continue
        assert child in ix[ip[parent]:ip[parent + 1]]
    slots = np.arange(8 + 32, 8 + 32 + 96)
    assert np.array_equal(ed.numpy()[32:], 8 + np.repeat(np.arange(32), 3))
    assert np.array_equal(np.where(es.numpy()[32:] >= 0, slots, -1),
                          es.numpy()[32:])
    # the same generator seed gives the same sample
    again = tsampler.fanout_sample(indptr, indices, seeds,
                                   torch.Generator().manual_seed(0),
                                   fanouts=(4, 3))
    assert all(torch.equal(a, b) for a, b in zip((gids, es, ed), again))
    r = tsampler.hop_draws(torch.Generator().manual_seed(1), 64, 8)
    assert r.dtype == torch.int32 and int(r.min()) >= 0
