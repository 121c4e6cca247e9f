"""PyTorch port, checkpoints (``ckpt/manager.py``) and the trainer's resume:
the three checkpoint tests of ``tests/test_substrate.py`` on the port's
manager; checkpoints that the JAX manager writes from numpy trees restore
bit for bit in the port's, and the reverse (one on-disk format: manifest,
paths, bf16 as uint16 bits); ``save`` snapshots before it returns, so an
in-place update right after it does not reach the disk; a failed write is
raised by ``wait``; and ``run_training(ckpt_dir=)`` resumes bit for bit.
The JAX manager runs live on numpy trees (no JAX program is compiled).
"""
import dataclasses
import os
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt.manager import CheckpointManager as JaxManager
from repro.optim import optimizers as jopt
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.core.tree import leaves
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.optim import optimizers as topt

from test_torch_store_index_edges import one_torch_thread  # noqa: F401


def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(8, dtype=torch.float32),
            "b": {"c": torch.ones((4, 4), dtype=torch.bfloat16)}}
    for step in (10, 20, 30):
        mgr.save(step, tree, meta={"step": step}, blocking=True)
    assert mgr.steps() == [20, 30]           # keep=2
    restored, manifest = mgr.restore(tree)
    assert manifest["step"] == 30 and manifest["meta"] == {"step": 30}
    for (pa, a), (pb, b) in zip(leaves(tree), leaves(restored)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
    assert mgr.restore(tree, step=20)[1]["step"] == 20
    assert CheckpointManager(str(tmp_path / "empty")).restore(tree) == \
        (None, None)


def test_checkpoint_atomic_publish(tmp_path):
    """A crash mid-write never corrupts the published checkpoint."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = {"a": torch.ones(4)}
    mgr.save(1, tree, blocking=True)
    # simulate a torn write: leftover tmp dir must be ignored
    os.makedirs(os.path.join(str(tmp_path), ".tmp_ckpt_2"), exist_ok=True)
    assert mgr.latest_step() == 1
    restored, _ = mgr.restore(tree)
    assert restored is not None and torch.equal(restored["a"], tree["a"])
    mgr.save(2, {"a": torch.zeros(4)}, blocking=True)   # over the torn dir
    assert mgr.steps() == [1, 2]
    assert not os.path.exists(os.path.join(str(tmp_path), ".tmp_ckpt_2"))


def test_restore_onto_a_device(tmp_path):
    """``device=`` in place of JAX's ``shardings=``; by default each leaf
    goes to its template leaf's device."""
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    mgr.save(5, tree, blocking=True)
    restored, _ = mgr.restore(tree, device="cpu")
    assert restored["w"].device.type == "cpu"
    assert torch.equal(restored["w"], tree["w"])
    restored, _ = mgr.restore({"w": torch.empty(0, device="meta")})
    assert restored["w"].device.type == "meta"
    assert restored["w"].shape == (4, 4)


def _trees():
    """The same (params, AdamW state) tree for both packages, from numpy:
    f32 and bf16 leaves, a list, a scalar int32 step."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    b = [rng.standard_normal(4).astype(np.float32),
         rng.standard_normal(2).astype(np.float32)]
    e = rng.standard_normal((5, 2)).astype(np.float32)
    e16 = e.astype(ml_dtypes.bfloat16)
    jp = {"w": w, "b": b, "emb": e16}
    js = jopt.OptState(step=np.int32(7),
                       m={"w": w * 2, "b": [x * 2 for x in b], "emb": e * 2},
                       v={"w": w * w, "b": [x * x for x in b], "emb": e * e})

    def t(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    tp = {"w": t(w), "b": [t(x) for x in b], "emb": t(e16)}
    ts = topt.OptState(step=torch.tensor(7, dtype=torch.int32),
                       m=_map(t, js.m), v=_map(t, js.v))
    return (jp, js), (tp, ts)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def _flat(tree):
    """[(path, numpy array)] of either package's (params, OptState)."""
    params, st = tree
    return [(p, _np(a)) for p, a in leaves([params, st.m, st.v, st.step])]


def _same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert np.array_equal(x, y), p


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jtree, ttree = _trees()
    JaxManager(str(tmp_path)).save(3, jtree, meta={"arch": "x"},
                                   blocking=True)
    got, manifest = CheckpointManager(str(tmp_path)).restore(ttree)
    assert manifest["step"] == 3 and manifest["meta"] == {"arch": "x"}
    assert isinstance(got, tuple) and isinstance(got[1], topt.OptState)
    assert got[0]["emb"].dtype == torch.bfloat16
    _same(got, ttree)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jtree, ttree = _trees()
    CheckpointManager(str(tmp_path)).save(4, ttree, meta={"loss": 1.5},
                                          blocking=True)
    got, manifest = JaxManager(str(tmp_path)).restore(jtree)
    assert manifest["step"] == 4 and manifest["meta"] == {"loss": 1.5}
    assert got[0]["emb"].dtype == jnp.bfloat16
    _same(got, jtree)
    # the same manifest, file for file, as JAX's own save of the tree
    JaxManager(str(tmp_path / "j")).save(4, jtree, meta={"loss": 1.5},
                                         blocking=True)
    for d in (tmp_path / "ckpt_4", tmp_path / "j" / "ckpt_4"):
        assert (d / "manifest.json").exists()
    assert (tmp_path / "ckpt_4" / "manifest.json").read_text() == \
        (tmp_path / "j" / "ckpt_4" / "manifest.json").read_text()


def test_save_snapshots_before_returning(tmp_path, monkeypatch):
    """The train steps update in place: an update right after ``save``
    must not reach the checkpoint (a CPU tensor's ``.cpu()`` is itself).
    The writer is held until the update is done."""
    mgr = CheckpointManager(str(tmp_path))
    updated, write = threading.Event(), mgr._write

    def held(*a):
        assert updated.wait(timeout=30)
        write(*a)
    monkeypatch.setattr(mgr, "_write", held)
    tree = {"w": torch.zeros(1 << 16), "s": torch.zeros((), dtype=torch.int32)}
    mgr.save(1, tree)
    tree["w"].add_(1.0)
    tree["s"].add_(1)
    updated.set()
    mgr.wait()
    restored, _ = mgr.restore(tree)
    assert float(restored["w"].abs().max()) == 0.0
    assert int(restored["s"]) == 0


def test_wait_raises_the_writers_error(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))

    def fail(*a):
        raise OSError("disk full")
    monkeypatch.setattr(mgr, "_write", fail)
    mgr.save(1, {"a": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                      # raised once


def test_run_training_loop_with_resume(tmp_path, capsys):
    """6 steps saving every 3, then a resume to 9: the checkpoint at 9
    equals, bit for bit, 3 steps of the port's own from the one at 6 on
    the batches a restarted source feeds (from ``seed`` again, as in
    JAX)."""
    arch, d = "nequip", str(tmp_path)
    m1 = ttrain.run_training(arch, steps=6, ckpt_dir=d, ckpt_every=3,
                             log_every=100, device="cpu")
    assert CheckpointManager(d).steps() == [3, 6]
    m2 = ttrain.run_training(arch, steps=9, ckpt_dir=d, ckpt_every=3,
                             log_every=100, device="cpu")
    assert "resumed from step 6" in capsys.readouterr().out
    assert np.isfinite(m1["loss"]) and np.isfinite(m2["loss"])
    mgr = CheckpointManager(d)
    assert mgr.steps() == [3, 6, 9]
    spec = ttrain.registry.get(arch)
    cfg = tsteps.gnn_cell_config(spec.reduced, spec.shapes[0], True)
    ocfg = topt.AdamWConfig()
    template = tsteps.gnn_module(cfg).init_params(
        cfg, torch.Generator().manual_seed(1), device="cpu")
    template = (template, topt.init_opt_state(template, ocfg))
    (params, state), man6 = mgr.restore(template, step=6)
    assert man6["meta"]["arch"] == arch
    batches = ttrain._gnn_batches(cfg, tsteps.gnn_geometry(spec.shapes[0],
                                                           True), 0,
                                  torch.device("cpu"))
    for _ in range(3):
        params, state, m = tsteps.gnn_train_step(params, state,
                                                 *next(batches), cfg, ocfg)
    assert float(m["loss"]) == m2["loss"]
    (p9, s9), man9 = mgr.restore(template, step=9)
    assert man9["meta"]["loss"] == m2["loss"]
    assert int(s9.step) == int(state.step) == 9
    for a, b in zip(leaves([params, state.m, state.v]),
                    leaves([p9, s9.m, s9.v])):
        assert torch.equal(a[1], b[1]), a[0]
    assert dataclasses.is_dataclass(s9)
