"""Production and test meshes: named lockstep meshes.

Port of ``repro/launch/mesh.py``.  Single pod: 16 x 16 = 256 shards over
("data", "model").  Multi-pod: 2 x 16 x 16 = 512 shards over ("pod",
"data", "model"); the "pod" axis is outer data parallelism or pipeline
stages for training and the cross-datacenter replica of the A1 store.
Each builds a :class:`~repro_torch.dist.mesh.ShardMesh` whose shards all
sit on the device the caller names: ``cuda`` by default (raises without a
GPU), ``cpu`` for the tests, ``meta`` for the dry run, which allocates
nothing.  Functions, not constants: importing this module touches no
device.
"""
from __future__ import annotations

import math

from repro_torch.core.backend import resolve_device
from repro_torch.dist.mesh import ShardMesh


def _mesh(shape, axes, device) -> ShardMesh:
    shape, axes = tuple(shape), tuple(axes)
    return ShardMesh((resolve_device(device),) * math.prod(shape), axes,
                     shape)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), device=None):
    """A small named mesh (the tests pass ``device="cpu"``)."""
    return _mesh(shape, axes, device)
