"""PyTorch port, the LM training slice: ``loss_fn`` and its gradients,
rematerialisation, ``lm_train_step`` against the JAX package's jitted
``train_4k`` cell, and ``run_training``.

Weights come from a numpy seed (``test_torch_lm.numpy_params``) through
``params_from_numpy``, tokens and targets from a numpy seed with some
targets -1 (masked).  The JAX side runs on the CPU under ``jax.jit``: its
model takes the oracle attention and the jnp rmsnorm with the analytic
VJP; the port's ``kernel`` backend takes the flash kernels' plain versions
and the same VJP, its ``ref`` backend PyTorch autograd through the chunked
recurrence.  Tolerances: loss rtol 1e-5; gradients rtol 1e-4 / atol 1e-6
(float32 sums of up to a few thousand terms in another order, gradients of
order 1e-2); after three optimizer steps, moments within 1e-5 of each
leaf's largest magnitude, and parameters within 1e-6 except where a
gradient lies within rounding of 0: AdamW's early steps move a parameter by
about +-lr whatever the size of its gradient, so there the two sides may
step apart by up to 2 lr a step (at most one element in 10,000 of a leaf).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import registry as jreg
from repro.dist.sharding import rules_context
from repro.launch import steps as jsteps
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro_torch.configs import h2o_danube_3_4b as tcfg
from repro_torch.configs.registry import cell
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as topt

from test_torch_lm import _pair_configs, numpy_params
from test_torch_store_index_edges import one_torch_thread  # noqa: F401

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _batch(cfg, shape, seed):
    """(tokens, targets) int32 of ``shape``: uniform ids, targets the next
    token, about one in eight -1."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, shape[:-1] + (shape[-1] + 1,))
    tgt = toks[..., 1:].copy()
    tgt[rng.random(tgt.shape) < 0.125] = -1
    return toks[..., :-1].astype(np.int32), tgt.astype(np.int32)


def _leaves(tree):
    return [t for _, t in T.leaves(tree)]


@pytest.fixture(scope="module", params=["reduced", "qkv_bias"])
def pair(request):
    jc, tc = _pair_configs()[request.param]
    tree = numpy_params(tc, seed=len(request.param) + 3)
    return jc, tc, tree


def test_loss_and_grads_match_jax(pair):
    """Both backends' loss, metrics and every gradient leaf against
    ``jax.value_and_grad(loss_fn)``."""
    jc, tc, tree = pair
    toks, tgt = _batch(tc, (2, 40), 0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, t, y: JT.loss_fn(p, jc, t, y), has_aux=True))(
        jax.tree.map(jnp.asarray, tree), toks, tgt)
    params = T.params_from_numpy(tc, tree, device="cpu")
    before = [t.clone() for t in _leaves(params)]
    for be in ("kernel", "ref"):
        (loss, m), grads = T.value_and_grad(
            params, tc, torch.from_numpy(toks), torch.from_numpy(tgt),
            backend=be)
        assert_allclose(float(loss), float(jl), rtol=1e-5, err_msg=be)
        assert_allclose(float(m["nll"]), float(jm["nll"]), rtol=1e-5)
        assert float(m["aux"]) == float(jm["aux"]) == 0.0
        got, want = _leaves(grads), jax.tree.leaves(jg)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            assert_allclose(g.numpy(), np.asarray(w), err_msg=be,
                            **GRAD_TOL)
    # the caller's tensors are neither changed nor marked
    for a, b in zip(_leaves(params), before):
        assert torch.equal(a, b) and not a.requires_grad
    loss2, _ = T.loss_fn(params, tc, torch.from_numpy(toks),
                         torch.from_numpy(tgt))
    assert_allclose(float(loss2), float(jl), rtol=1e-5)


def test_remat_recomputes_and_changes_no_gradient(monkeypatch):
    """A gradient on the kernel backend goes through the kernel wrappers:
    2L + 1 ``rmsnorm_fwd``, L ``flash_fwd`` and L ``flash_bwd`` (one launch
    of each backward kernel on the card); ``remat=True`` runs each block's
    forward again in the backward (2L more ``rmsnorm_fwd`` and L more
    ``flash_fwd``: the launch counts chip_smoke.py checks a train step)
    and gives the gradients of
    ``remat=False`` bit for bit."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    names = ((rk, "rmsnorm_fwd"), (fk, "flash_fwd"), (fk, "flash_bwd"))
    calls = {}
    for mod, name in names:
        def counted(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    cfg = tcfg.REDUCED
    L = cfg.n_layers
    params = T.params_from_numpy(cfg, numpy_params(cfg, 5), device="cpu")
    toks, tgt = (torch.from_numpy(a) for a in _batch(cfg, (2, 48), 1))
    out = {}
    for remat in (False, True):
        calls.update({name: 0 for _, name in names})
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = T.value_and_grad(params, c, toks, tgt)
        assert calls == {"rmsnorm_fwd": (4 if remat else 2) * L + 1,
                         "flash_fwd": (2 if remat else 1) * L,
                         "flash_bwd": L}
    assert torch.equal(out[True][0][0], out[False][0][0])
    for a, b in zip(_leaves(out[True][1]), _leaves(out[False][1])):
        assert torch.equal(a, b)


def _jax_train_cell(accum: int):
    """The JAX package's jitted train step of h2o-danube-3-4b's
    ``train_4k`` at REDUCED (4 x 64 tokens a step) with ``accum``
    micro-batches, on a 1 x 1 mesh."""
    spec = jreg.get("h2o-danube-3-4b")
    mesh = make_test_mesh((1, 1), ("data", "model"))
    if accum == 1:
        c = jsteps.build_cell("h2o-danube-3-4b", "train_4k", mesh,
                              reduced=True)
        fn = c.fn
    else:
        shape = dataclasses.replace(spec.cell("train_4k"), geometry=dict(
            spec.cell("train_4k").geometry, accum=accum))
        c = jsteps._lm_cell(spec, shape, mesh, reduced=True)

        def fn(*a, _inner=c.fn):
            with rules_context(dict(spec.rules_override)):
                return _inner(*a)
    return mesh, c, jax.jit(fn)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_the_jax_cell(accum):
    """Three steps on three batches: loss, gnorm, every parameter and both
    moments, the port's step updating in place."""
    mesh, jcell, jstep = _jax_train_cell(accum)
    cfg = tcfg.REDUCED
    shape = jcell.args[2].shape
    geo = tsteps.train_geometry(dataclasses.replace(
        cell(tcfg.SHAPES, "train_4k"), geometry=dict(
            cell(tcfg.SHAPES, "train_4k").geometry, accum=accum)),
        reduced=True)
    assert geo == shape == (accum, 4 // accum, 64)
    tree = numpy_params(cfg, 6)
    ocfg = tsteps.pick_opt(cfg.n_params())
    assert ocfg == topt.AdamWConfig()
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init_opt_state(jp, jsteps.pick_opt(cfg.n_params()))
    tp = T.params_from_numpy(cfg, tree, device="cpu")
    ts = topt.init_opt_state(tp, ocfg)
    for i in range(3):
        toks, tgt = _batch(cfg, shape, 10 + i)
        with mesh:
            jp, js, jm = jstep(jp, js, toks, tgt)
        tp, ts, tm = tsteps.lm_train_step(
            tp, ts, torch.from_numpy(toks), torch.from_numpy(tgt), cfg,
            ocfg)
        assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]), rtol=1e-4)
    assert int(ts.step) == int(js.step) == 3
    for g, w in zip(_leaves(tp), jax.tree.leaves(jp)):
        d = np.abs(g.numpy() - np.asarray(w))
        assert d.max() <= 3 * 2 * ocfg.lr
        assert (d > 1e-6).sum() <= max(1, d.size // 10_000)
    for name in ("m", "v"):
        for g, w in zip(_leaves(getattr(ts, name)),
                        jax.tree.leaves(getattr(js, name))):
            w = np.asarray(w)
            assert_allclose(g.numpy(), w, rtol=0,
                            atol=1e-5 * np.abs(w).max())


def test_non_finite_loss_updates_nothing():
    """The circuit breaker: a step whose loss is not finite leaves the
    parameters and the optimizer state as they were."""
    cfg = tcfg.REDUCED
    tree = numpy_params(cfg, 7)
    tree["head"][0, 0] = np.inf
    params = T.params_from_numpy(cfg, tree, device="cpu")
    ocfg = tsteps.pick_opt(cfg.n_params())
    state = topt.init_opt_state(params, ocfg)
    before = [t.clone() for t in _leaves(params)]
    toks, tgt = (torch.from_numpy(a) for a in _batch(cfg, (1, 2, 16), 2))
    params, state, m = tsteps.lm_train_step(params, state, toks, tgt, cfg,
                                            ocfg)
    assert not np.isfinite(float(m["loss"]))
    assert int(state.step) == 0
    for a, b in zip(_leaves(params), before):
        assert torch.equal(a, b)


def test_run_training_lm_and_what_it_refuses(capsys, tmp_path):
    out = ttrain.run_training("h2o-danube-3-4b", steps=3, log_every=1,
                              device="cpu")
    assert set(out) == {"loss", "gnorm"}
    assert all(np.isfinite(v) for v in out.values())
    assert capsys.readouterr().out.count("loss=") == 3
    # every arch trains now, and checkpoints: a resume past the last save
    # runs no step when the run has reached its end
    ttrain.run_training("h2o-danube-3-4b", steps=1, device="cpu",
                        ckpt_dir=str(tmp_path), ckpt_every=1)
    assert ttrain.run_training("h2o-danube-3-4b", steps=1, device="cpu",
                               ckpt_dir=str(tmp_path)) == {}
    assert "resumed from step 1" in capsys.readouterr().out
    for arch in ("no-such-arch", "a1-kg"):       # a1-kg is not a trained arch
        with pytest.raises(KeyError):
            ttrain.run_training(arch, steps=1, device="cpu")
    if not torch.cuda.is_available():        # the default device is the GPU
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.run_training("h2o-danube-3-4b", steps=1)
