"""PyTorch port, the LM serving slice: ``forward``, ``prefill`` and a
ring-wrapping ``decode_step`` run of the transformer against the JAX
package, from the same weights carried across by ``params_from_numpy``.

Every leaf is drawn from a numpy seed, ``embed`` and the ln scales included:
the init law's embedding is all ones, under which the output ignores the
tokens and a wrong embedding gather would pass (ROADMAP queue 3).  The JAX
side runs under ``jax.jit`` (one compile per shape).  Tolerance rtol 1e-4 /
atol 2e-4, as the JAX model tests use.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import h2o_danube_3_4b as jcfg
from repro.configs import registry as jreg
from repro.data import tokens as jtokens
from repro.models import transformer as JT
from repro_torch.configs import h2o_danube_3_4b as tcfg
from repro_torch.configs import registry as treg
from repro_torch.data import tokens as ttokens
from repro_torch.models import transformer as T

from test_torch_store_index_edges import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=2e-4)


def _pair_configs():
    """(JAX config, port config): danube REDUCED (2 layers, window 32) and
    a dense 4-layer config with qkv bias and full attention."""
    tiny = dict(name="tiny", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                d_head=16, d_ff=128, vocab=256, qkv_bias=True, remat=False)
    return {"reduced": (jcfg.REDUCED, tcfg.REDUCED),
            "qkv_bias": (JT.LMConfig(**tiny, dtype=jnp.float32),
                         T.LMConfig(**tiny, dtype=torch.float32))}


def numpy_params(cfg, seed: int) -> dict:
    """Every leaf from a numpy seed: embed N(0, 1), ln scales
    1 + 0.1 N(0, 1), biases 0.1 N(0, 1), matrices N(0, 1) * fan_in^-0.5."""
    rng = np.random.default_rng(seed)
    out = {"blocks": [{} for _ in cfg.block_pattern]}
    for path, shape in T.leaves(T.param_shapes(cfg)):
        name = path[-1]
        z = rng.standard_normal(shape)
        if name == "embed":
            a = z
        elif name in ("ln1", "ln2", "ln_f"):
            a = 1 + 0.1 * z
        elif name in ("bq", "bk", "bv"):
            a = 0.1 * z
        else:
            a = z * shape[-2] ** -0.5
        T._set(out, path, a.astype(np.float32))
    return out


@pytest.fixture(scope="module", params=["reduced", "qkv_bias"])
def pair(request):
    jc, tc = _pair_configs()[request.param]
    tree = numpy_params(tc, seed=len(request.param))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = T.params_from_numpy(tc, tree, device="cpu")
    return jc, tc, jp, tp


def _tokens(cfg, B, S, seed):
    return ttokens._synth_batch(np.random.default_rng(seed), B, S, cfg.vocab)


def test_forward_and_prefill_match_jax(pair):
    jc, tc, jp, tp = pair
    toks = _tokens(tc, 2, 48, 0)
    want = np.asarray(jax.jit(lambda p, t: JT.forward(p, jc, t)[0])(
        jp, jnp.asarray(toks)))
    for be in ("kernel", "ref"):
        got, aux = T.forward(tp, tc, torch.from_numpy(toks), backend=be)
        assert got.dtype == torch.float32 and float(aux) == 0.0
        assert_allclose(got.numpy(), want, err_msg=be, **TOL)
    want_p = np.asarray(jax.jit(lambda p, t: JT.prefill(p, jc, t)[0])(
        jp, jnp.asarray(toks)))
    got_p, _ = T.prefill(tp, tc, torch.from_numpy(toks))
    assert got_p.shape == (2, tc.vocab)
    assert_allclose(got_p.numpy(), want_p, **TOL)
    # the weights make the tokens matter: another prompt, other logits
    other, _ = T.prefill(tp, tc, torch.from_numpy(_tokens(tc, 2, 48, 1)))
    assert float((other - got_p).abs().max()) > 1e-2


def test_decode_matches_jax_step_by_step(pair):
    """48 greedy-free steps (the tokens are given): past the 32-slot ring of
    REDUCED, which wraps, and through the 48-slot cache of full
    attention."""
    jc, tc, jp, tp = pair
    B, n = 2, 48
    toks = _tokens(tc, B, n, 2)
    jcache = JT.init_kv_cache(jc, B, 64 if tc.window else n)
    tcache = T.init_kv_cache(tc, B, 64 if tc.window else n, device="cpu")
    assert [tuple(a.shape) for kv in jcache for a in kv] == \
        [tuple(a.shape) for kv in tcache for a in kv]
    assert tcache[0][0].shape[3] == (tc.window or n)
    step = jax.jit(lambda p, t, c, pos: JT.decode_step(p, jc, t, c, pos))
    for t in range(n):
        jl, jcache = step(jp, jnp.asarray(toks[:, t:t + 1]), jcache,
                          jnp.int32(t))
        tl, tcache = T.decode_step(tp, tc, torch.from_numpy(
            toks[:, t:t + 1]), tcache, t)
        assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {t}",
                        **TOL)
    for (jk, jv), (tk, tv) in zip(jcache, tcache):
        assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    # the last step sees what the forward pass sees at the last position
    full, _ = T.forward(tp, tc, torch.from_numpy(toks))
    assert_allclose(tl.numpy(), full[:, -1].numpy(), **TOL)


def test_init_params_law_and_shapes():
    """The port's init law gives the JAX tree's shapes and dtypes, ones
    where JAX puts ones (the ln scales and, by the same rule, ``embed``;
    here also the biases, whose last axis equals d_model), and
    N(0, fan_in^-1) draws elsewhere."""
    for jc, tc in _pair_configs().values():
        got = T.init_params(tc, torch.Generator().manual_seed(0),
                            device="cpu")
        want = jax.eval_shape(lambda: JT.init_params(jc, jax.random.key(0)))
        want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
        got_leaves = list(T.leaves(got))
        assert len(got_leaves) == len(want_leaves)
        for (path, t), (_, w) in zip(got_leaves, want_leaves):
            assert tuple(t.shape) == w.shape, path
            assert t.dtype == torch.float32 and w.dtype == jnp.float32
            shape = tuple(t.shape)
            if len(shape) <= 2 and shape[-1] == tc.d_model:
                assert bool((t == 1).all()), path
            else:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                std = float(t.std()) * fan_in ** 0.5
                assert 0.8 < std < 1.2, (path, std)
    assert bool((got["embed"] == 1).all())
    bf = dataclasses.replace(tcfg.REDUCED, dtype=torch.bfloat16)
    p = T.init_params(bf, torch.Generator().manual_seed(1), device="cpu")
    assert all(t.dtype == torch.bfloat16 for _, t in T.leaves(p))


def test_params_from_numpy_takes_bf16_trees():
    """A JAX tree in bfloat16 (``jax.device_get`` gives ml_dtypes arrays)
    comes across bit for bit."""
    jc = dataclasses.replace(jcfg.REDUCED, dtype=jnp.bfloat16)
    tc = dataclasses.replace(tcfg.REDUCED, dtype=torch.bfloat16)
    tree = jax.device_get(JT.init_params(jc, jax.random.key(3)))
    got = T.params_from_numpy(tc, tree, device="cpu")
    wq = np.asarray(tree["blocks"][0]["wq"], np.float32)
    assert got["blocks"][0]["wq"].dtype == torch.bfloat16
    assert np.array_equal(got["blocks"][0]["wq"].float().numpy(), wq)
    tree["head"] = tree["head"][:, :-1]
    with pytest.raises(ValueError):
        T.params_from_numpy(tc, tree, device="cpu")


def test_configs_and_cells_match_jax():
    for name in ("FULL", "REDUCED"):
        jc, tc = getattr(jcfg, name), getattr(tcfg, name)
        for f in dataclasses.fields(JT.LMConfig):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.n_params() == jc.n_params()
        assert tc.n_active_params() == jc.n_active_params()
    assert tcfg.FULL.n_params() == 3_961_839_360
    assert tcfg.FULL.dtype == torch.bfloat16
    assert tcfg.REDUCED.dtype == torch.float32
    jshapes = jreg.lm_shapes(window=4096, accum_train=1)
    assert [dataclasses.astuple(c) for c in tcfg.SHAPES] == \
        [dataclasses.astuple(c) for c in jshapes]
    assert treg.cell(tcfg.SHAPES, "decode_32k").geometry == dict(
        seq_len=32768, global_batch=128)
    assert np.array_equal(
        ttokens._synth_batch(np.random.default_rng(5), 3, 100, 32000),
        jtokens._synth_batch(np.random.default_rng(5), 3, 100, 32000))


def test_moe_and_collective_matmul_raise():
    toks = torch.zeros((1, 4), dtype=torch.long)
    moe = T.LMConfig(n_layers=2, d_model=16, n_heads=2, n_kv_heads=1,
                     d_head=8, d_ff=32, vocab=32, block_pattern=("moe",),
                     n_experts=2, top_k=1, expert_d_ff=8,
                     dtype=torch.float32)
    params = T.init_params(moe, torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="moe.py"):
        T.forward(params, moe, toks)
    with pytest.raises(NotImplementedError, match="moe.py"):
        T.decode_step(params, moe, toks[:, :1],
                      T.init_kv_cache(moe, 1, 4, device="cpu"), 0)
    cm = dataclasses.replace(tcfg.REDUCED, use_collective_matmul=True)
    with pytest.raises(NotImplementedError, match="overlap"):
        T.prefill(T.init_params(cm, torch.Generator().manual_seed(0),
                                device="cpu"), cm, toks)


def test_entry_points_default_to_cuda():
    """The entry points that place tensors default to the GPU and raise
    without one: they never carry on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device works")
    cfg = tcfg.REDUCED
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_kv_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.params_from_numpy(cfg, numpy_params(cfg, 0))


def test_kernel_backend_goes_through_the_kernel_wrappers(monkeypatch):
    """On the kernel backend every RMSNorm and attention of a prefill goes
    through the ``rmsnorm_fwd`` and ``flash_fwd`` wrappers (2L + 1 and L
    calls), and a decode step through ``rmsnorm_fwd`` only; the ref
    backend through neither.  chip_smoke.py counts the launches on the
    card the same way."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    calls = {"rmsnorm_fwd": 0, "flash_fwd": 0}
    for mod, name in ((rk, "rmsnorm_fwd"), (fk, "flash_fwd")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    cfg = tcfg.REDUCED
    params = T.params_from_numpy(cfg, numpy_params(cfg, 1), device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 1, 16, 3))
    T.prefill(params, cfg, toks, backend="ref")
    assert calls == {"rmsnorm_fwd": 0, "flash_fwd": 0}
    T.prefill(params, cfg, toks)
    L = cfg.n_layers
    assert calls == {"rmsnorm_fwd": 2 * L + 1, "flash_fwd": L}
    T.decode_step(params, cfg, toks[:, :1],
                  T.init_kv_cache(cfg, 1, 16, device="cpu"), 0)
    assert calls == {"rmsnorm_fwd": 2 * (2 * L + 1), "flash_fwd": L}


def test_entry_points_sum_matmuls_in_f32(monkeypatch):
    """``forward``, ``prefill``, ``decode_step`` and ``value_and_grad``
    (its backward and the remat recompute in it included) run with TF32
    and the reduced-precision bf16 reduction off (the JAX package's f32
    accumulation), and give the caller's settings back afterwards."""
    m = torch.backends.cuda.matmul
    monkeypatch.setattr(m, "allow_tf32", True)
    monkeypatch.setattr(m, "allow_bf16_reduced_precision_reduction", True)
    seen = []

    def norm(*a, _fn=T._rmsnorm, **kw):
        seen.append((m.allow_tf32, m.allow_bf16_reduced_precision_reduction))
        return _fn(*a, **kw)
    monkeypatch.setattr(T, "_rmsnorm", norm)
    cfg = tcfg.REDUCED
    params = T.params_from_numpy(cfg, numpy_params(cfg, 1), device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 1, 8, 4))
    cache = T.init_kv_cache(cfg, 1, 8, device="cpu")
    remat = dataclasses.replace(cfg, remat=True)
    L = cfg.n_layers
    # forward: 2L + 1 norms; the remat recompute in the backward: 2L more
    for n, call in ((2 * L + 1, lambda: T.forward(params, cfg, toks)),
                    (2 * L + 1, lambda: T.prefill(params, cfg, toks)),
                    (2 * L + 1, lambda: T.decode_step(params, cfg,
                                                      toks[:, :1], cache, 0)),
                    (4 * L + 1, lambda: T.value_and_grad(params, remat, toks,
                                                         toks))):
        seen.clear()
        call()
        assert len(seen) == n and set(seen) == {(False, False)}
        assert (m.allow_tf32, m.allow_bf16_reduced_precision_reduction) == \
            (True, True)
