"""Training checkpoint/restart.

Port of ``repro/ckpt/manager.py``, for the trainer on one device:
  * async save: ``save`` copies the tree to host memory before it returns
    (the train steps update parameters and moments in place, so the
    snapshot must not share their storage) and a worker thread writes it
    to disk, one save in flight;
  * atomic publish (write to a tmp dir, rename) so a crash mid-save never
    corrupts the latest checkpoint;
  * keep-N retention;
  * ``restore`` rebuilds the tree of a template and puts each leaf on a
    device (the template leaf's, or ``device=``); the JAX manager's
    ``shardings=`` re-shards instead, which one device does not need.

The format on disk is the JAX manager's, so that a checkpoint written by
either package restores in the other: ``manifest.json`` (``step``,
``meta``, and ``leaves``: ``path``, ``file``, ``dtype``, ``shape`` a leaf)
and one ``leaf_<i>.npy`` a leaf, in ``jax.tree.flatten`` order; a bfloat16
leaf is stored as its ``uint16`` bits with the dtype name ``"bfloat16"``.
Paths are printed as JAX prints them: ``['key']`` for a dict entry,
``[i]`` for a list or tuple item, ``.name`` for a dataclass field (the
optimizer state), joined by ``/``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch


def _flatten_with_paths(tree, prefix=()):
    """[(path string, leaf)] in ``jax.tree.flatten`` order: dict keys
    sorted, list and tuple items and dataclass fields in order; ``None``
    is an empty subtree."""
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", t) for i, t in enumerate(tree)]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f".{f.name}", getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif tree is None:
        return []
    else:
        return [("/".join(prefix), tree)]
    return [x for k, t in items for x in _flatten_with_paths(t, prefix + (k,))]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(template, dict):
        vals = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: vals[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(t, leaves) for t in template)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    if template is None:
        return None
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    """A numpy copy of ``leaf`` that shares no storage with it (bfloat16
    as its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.cpu().numpy()
        return a.copy() if t.device.type == "cpu" else a
    return np.array(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).split(".")[-1]
    return np.asarray(leaf).dtype.name


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, *, meta: Optional[dict] = None,
             blocking: bool = False) -> None:
        """Snapshot to host memory synchronously, write to disk async."""
        self.wait()                      # one in-flight save at a time
        host = [(p, _to_host(leaf), _dtype_name(leaf))
                for p, leaf in _flatten_with_paths(tree)]

        def work():
            try:
                self._write(step, host, meta or {})
                self._retain()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _write(self, step: int, host: list, meta: dict) -> None:
        tmp = os.path.join(self.dir, f".tmp_ckpt_{step}")
        final = os.path.join(self.dir, f"ckpt_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "meta": meta, "leaves": []}
        for i, (p, arr, dtype_name) in enumerate(host):
            fn = f"leaf_{i}.npy"
            if dtype_name == "bfloat16":
                arr = arr.view(np.uint16)
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append(
                {"path": p, "file": fn, "dtype": dtype_name,
                 "shape": list(arr.shape)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)            # atomic publish

    def _retain(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"ckpt_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for fn in os.listdir(self.dir):
            if fn.startswith("ckpt_"):
                out.append(int(fn.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template, *, step: Optional[int] = None, device=None):
        """Rebuild the tree: ``template`` provides the structure, values
        and dtypes come from disk.  Each leaf goes to ``device``, or to the
        template leaf's device (a tensor's; the CPU for anything else).
        Returns (tree, manifest), or (None, None) with no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        d = os.path.join(self.dir, f"ckpt_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        out = []
        for p, tmpl in _flatten_with_paths(template):
            e = by_path[p]
            arr = np.load(os.path.join(d, e["file"]))
            if e["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            dev = (torch.device(device) if device is not None else
                   tmpl.device if isinstance(tmpl, torch.Tensor) else
                   torch.device("cpu"))
            out.append(t.to(dev))
        return _unflatten(template, iter(out)), manifest
