"""PyTorch port, the optimizers, schedules, gradient compression and the
token pipeline against the JAX package on seeded numpy inputs.

The port updates in place over slices of each leaf (``CHUNK``); the JAX
functions return new trees.  Tolerances: the float32 elementwise updates
rtol 1e-6 / atol 1e-7 (XLA may fuse a multiply and an add where PyTorch
rounds twice, and ``b ** step`` may differ in the last bit); the global
norm rtol 1e-6 (another summation order); bfloat16 moments within one bf16
ulp of the leaf's scale (both round float32 values that may differ in
their last bits, and a moment one ulp apart carries into the next step's,
where ``b1 * m + (1 - b1) * g`` may cancel).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.data import tokens as jtokens
from repro.optim import compression as jcomp
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.core.tree import leaves
from repro_torch.data import tokens as ttokens
from repro_torch.optim import compression as tcomp
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

from test_torch_store_index_edges import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"embed": (300, 32), "ln": (32,),
          "blocks": [{"w1": (3, 32, 160), "w2": (3, 160, 130)}]}


def _tree(seed, scale=1.0, shapes=SHAPES):
    """A tree of numpy float32 arrays with the layout of ``shapes``."""
    rng = np.random.default_rng(seed)
    out = {"blocks": [{} for _ in shapes["blocks"]]}
    for path, shape in leaves(shapes):
        t = out
        for key in path[:-1]:
            t = t[key]
        t[path[-1]] = (scale * rng.standard_normal(shape)).astype(np.float32)
    return out


def _torch(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.from_numpy(a.copy()).to(dtype), tree)


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _assert_trees(got, want, **tol):
    g = [t for _, t in leaves(got)]
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == b.shape
        assert_allclose(_np(a), _np(b), **tol)


def _bf16_ulp_close(got, want):
    """Within one bf16 ulp of each leaf's largest magnitude."""
    for a, b in zip([t for _, t in leaves(got)], jax.tree.leaves(want)):
        b = _np(b)
        ulp = 2.0 ** (np.floor(np.log2(max(np.abs(b).max(), 1e-30))) - 7)
        assert (np.abs(_np(a) - b) <= ulp).all()


@pytest.mark.parametrize("state_dtype", ["f32", "bf16"])
def test_adamw_matches_jax(state_dtype, monkeypatch):
    """Four AdamW steps (the last one clipped: gradients of norm ~100 >
    1), with slices small enough that every stacked leaf is updated in
    several pieces."""
    monkeypatch.setattr(topt, "CHUNK", 5000)
    tdt = torch.float32 if state_dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if state_dtype == "f32" else jnp.bfloat16
    tcfg = topt.AdamWConfig(state_dtype=tdt)
    jcfg = jopt.AdamWConfig(state_dtype=jdt)
    p0 = _tree(0)
    tp, jp = _torch(p0), _jax(p0)
    ts, js = topt.init_opt_state(tp, tcfg), jopt.init_opt_state(jp, jcfg)
    step = jax.jit(lambda p, g, s: jopt.opt_update(p, g, s, jcfg))
    for i, scale in enumerate((1e-3, 1e-2, 1e-3, 1.0)):
        g = _tree(10 + i, scale)
        tp, ts, tn = topt.opt_update(tp, _torch(g), ts, tcfg)
        jp, js, jn = step(jp, _jax(g), js)
        assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert int(ts.step) == int(js.step) == i + 1
        if state_dtype == "f32":
            _assert_trees(tp, jp, **F32)
            _assert_trees(ts.m, js.m, **F32)
            _assert_trees(ts.v, js.v, rtol=1e-6, atol=1e-12)
        else:
            # a moment one bf16 ulp apart moves its parameter by up to
            # lr * 2**-7 a step
            _assert_trees(tp, jp, rtol=1e-6, atol=(i + 1) * 3e-4 * 2 ** -7)
            assert all(t.dtype == torch.bfloat16 for _, t in leaves(ts.m))
            _bf16_ulp_close(ts.m, js.m)
            _bf16_ulp_close(ts.v, js.v)


def test_adamw_slices_change_no_value(monkeypatch):
    """The in-place update over slices gives the values of one pass over
    each whole leaf, bit for bit (gradients below the clipping norm, whose
    sum over slices is taken in another order)."""
    cfg = topt.AdamWConfig()
    out = []
    for chunk in (1 << 30, 700):
        monkeypatch.setattr(topt, "CHUNK", chunk)
        p = _torch(_tree(1))
        s = topt.init_opt_state(p, cfg)
        for i in range(3):
            p, s, _ = topt.opt_update(p, _torch(_tree(20 + i, 1e-3)), s, cfg)
        out.append([t for _, t in leaves([p, s.m, s.v])])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_adafactor_matches_jax():
    """Adafactor on factored leaves (both trailing axes >= 128: ``w2``)
    and unfactored ones, over three steps."""
    tcfg, jcfg = topt.AdafactorConfig(), jopt.AdafactorConfig()
    p0 = _tree(2)
    tp, jp = _torch(p0), _jax(p0)
    ts, js = topt.init_opt_state(tp, tcfg), jopt.init_opt_state(jp, jcfg)
    assert isinstance(ts.v["blocks"][0]["w2"], tuple)
    assert not isinstance(ts.v["blocks"][0]["w1"], tuple)
    step = jax.jit(lambda p, g, s: jopt.opt_update(p, g, s, jcfg))
    for i in range(3):
        g = _tree(30 + i, 1e-2)
        tp, ts, tn = topt.opt_update(tp, _torch(g), ts, tcfg)
        jp, js, jn = step(jp, _jax(g), js)
        assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_trees(tp, jp, rtol=1e-6, atol=1e-6)
    vr, vc = ts.v["blocks"][0]["w2"]
    jvr, jvc = js.v["blocks"][0]["w2"]
    assert_allclose(vr.numpy(), np.asarray(jvr), rtol=1e-5, atol=1e-12)
    assert_allclose(vc.numpy(), np.asarray(jvc), rtol=1e-5, atol=1e-12)
    assert_allclose(ts.v["ln"].numpy(), np.asarray(js.v["ln"]), rtol=1e-5,
                    atol=1e-12)


@pytest.mark.parametrize("scale,max_norm", [(1.0, 1.0), (1e-3, 1.0),
                                            (1.0, 0.0)])
def test_clip_by_global_norm_matches_jax(scale, max_norm):
    g = _tree(3, scale)
    tg = _torch(g)
    got, tn = topt.clip_by_global_norm(tg, max_norm)
    want, jn = jopt.clip_by_global_norm(_jax(g), max_norm)
    assert got is tg                               # scaled in place
    assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert_allclose(float(topt.global_norm(_torch(g))),
                    float(jopt.global_norm(_jax(g))), rtol=1e-6)
    _assert_trees(got, want, **F32)


def test_schedules_match_jax():
    for s in (0, 1, 7, 50, 99, 100, 150):
        ts, js = torch.tensor(s, dtype=torch.int32), jnp.int32(s)
        assert_allclose(
            float(tsched.cosine_schedule(ts, total_steps=100)),
            float(jsched.cosine_schedule(js, total_steps=100)), rtol=1e-6)
        assert_allclose(
            float(tsched.linear_warmup_cosine(ts, warmup_steps=10,
                                              total_steps=100)),
            float(jsched.linear_warmup_cosine(js, warmup_steps=10,
                                              total_steps=100)), rtol=1e-6)


def test_ef_compress_grads_matches_jax():
    """Two rounds of int8 error feedback: the dequantized gradients and the
    carried errors (equal int8 codes: a code is a rounding of the same
    float32 quotient)."""
    g = _tree(4, 1e-2)
    tg, te = _torch(g), tcomp.init_error_state(_torch(g))
    jg, je = _jax(g), jcomp.init_error_state(_jax(g))
    for _ in range(2):
        tq, te = tcomp.ef_compress_grads(tg, te)
        jq, je = jcomp.ef_compress_grads(jg, je)
        _assert_trees(tq, jq, rtol=1e-6, atol=1e-9)
        _assert_trees(te, je, rtol=1e-6, atol=1e-9)
    x = torch.from_numpy(g["embed"])
    q, s = tcomp.compress_int8(x)
    jq8, js8 = jcomp.compress_int8(jnp.asarray(g["embed"]))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(),
                                                    np.asarray(jq8))
    # over a mesh of shards that hold the same gradient and error, the
    # psum of the int8 payloads over the shard count is each payload again
    mq, me = tcomp.ef_compress_grads([tg] * 2, [te] * 2, axis_name="data")
    want_q, want_e = tcomp.ef_compress_grads(tg, te)
    for s in range(2):
        _assert_trees(mq[s], want_q, rtol=0, atol=0)
        _assert_trees(me[s], want_e, rtol=0, atol=0)


def test_token_pipeline_matches_jax():
    """The same integers as the JAX generator for the same seed, int32 on
    the requested device; closing the iterator stops its producer."""
    import threading
    it = ttokens.token_pipeline(batch=3, seq=40, vocab=500, seed=9,
                                device="cpu")
    jit_ = jtokens.token_pipeline(batch=3, seq=40, vocab=500, seed=9)
    for _ in range(3):
        (x, y), (jx, jy) = next(it), next(jit_)
        assert x.dtype == torch.int32 and x.shape == (3, 40)
        assert np.array_equal(x.numpy(), np.asarray(jx))
        assert np.array_equal(y.numpy(), np.asarray(jy))
        assert torch.equal(x[:, 1:], y[:, :-1])
    assert any(t.name == "token_pipeline" for t in threading.enumerate())
    it.close()
    assert not any(t.name == "token_pipeline"
                   for t in threading.enumerate())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            next(ttokens.token_pipeline(batch=1, seq=4, vocab=10))
