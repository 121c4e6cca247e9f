"""Addressing: the FaRM 64-bit (region, offset) pointer, adapted to shards.

Port of ``repro/core/addressing.py``.  A gid encodes its owner shard
arithmetically, so pointer -> owner resolution is a local computation:

    gid   = slot * n_shards + shard        (global vertex id, int32)
    owner = gid %  n_shards                (which shard holds the record)
    slot  = gid // n_shards                (offset within the shard)

The helpers work on Python ints and on int32 tensors alike.
"""
from __future__ import annotations

import dataclasses

import numpy as np

NULL = np.int32(-1)            # null pointer / empty slot marker
TS_INF = np.int32(2**31 - 1)   # "live forever" delete timestamp
TS_ZERO = np.int32(0)


def owner_of(gid, n_shards: int):
    """Shard that owns a global id."""
    return gid % n_shards


def slot_of(gid, n_shards: int):
    """Local slot of a global id within its owner shard."""
    return gid // n_shards


def gid_of(shard, slot, n_shards: int):
    """Compose a global id from (shard, slot)."""
    return slot * n_shards + shard


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """Static layout of a sharded graph store (the FaRM region geometry).

    Capacities are *per shard*; every device tensor derived from this config
    has a static shape, and running out of capacity surfaces as a fast-fail
    flag."""

    n_shards: int = 1            # number of storage shards
    cap_v: int = 1024            # vertex slots per shard
    cap_e: int = 8192            # out-edge CSR pool entries per shard
    cap_delta: int = 1024        # edge delta-log entries per shard
    cap_idx: int = 2048          # primary-index entries per shard
    cap_idx_delta: int = 512     # primary-index delta entries per shard
    cap_vec: int = 0             # vector-index entries per shard (0 = off)
    d_f32: int = 4               # float32 attribute columns per vertex
    d_i32: int = 4               # int32 attribute columns per vertex
    d_ef32: int = 0              # float32 attribute columns per edge
    with_in_edges: bool = True   # maintain incoming half-edges (reverse CSR)
    replication: int = 1         # in-pod replica groups (fault domains)

    @property
    def total_v(self) -> int:
        return self.n_shards * self.cap_v

    @property
    def total_e(self) -> int:
        return self.n_shards * self.cap_e

    def row_of_gid(self, gid):
        """Row index into the flat (shard-major) vertex arrays."""
        return (gid % self.n_shards) * self.cap_v + gid // self.n_shards

    def indptr_row(self, gid):
        """Row into the flat indptr array (shard-major, cap_v+1 per shard)."""
        return (gid % self.n_shards) * (self.cap_v + 1) + gid // self.n_shards

    def validate(self) -> None:
        assert self.n_shards >= 1
        assert self.cap_v >= 1 and self.cap_e >= 1
        assert self.cap_v * self.n_shards < 2**31, "gid space overflow"


def ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m
