"""Embedding-table lookup.

Port of ``gspmd_lookup`` from ``repro/models/embedding.py``: a plain row
gather, padding ids (< 0) giving zero rows.  On one device the table is
not sharded, so the gather is local.  The query-shipping lookup over a
mesh, ``a1_ship_lookup``, comes with ROADMAP queue 1 item 12b.
"""
from __future__ import annotations


def gspmd_lookup(table, ids):
    """table (V, D), ids (...) -> (..., D); ids < 0 give zero rows."""
    ok = ids >= 0
    safe = ids.clamp(min=0).long()
    return table[safe] * ok[..., None].to(table.dtype)
