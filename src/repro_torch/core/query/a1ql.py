"""A1QL: the MQL-like JSON traversal language (§3.4, Fig. 8).

A query is a nested JSON document; each nesting level is one traversal step.
Example (the paper's "actors who worked with Steven Spielberg", Fig. 8):

    {"type": "director", "id": 4242,
     "_out_edge": {"type": "film.director",
                   "_target": {"type": "film",
                               "_out_edge": {"type": "film.actor",
                                             "_target": {"select": "count"}}}}}

Supported constructs:
  * ``type`` / ``id``           — start vertex via primary index
  * ``_out_edge`` / ``_in_edge``— traverse typed (or any: type "*") edges
  * ``_target``                 — the next level; may carry ``type`` (target
                                  vertex type check) and ``filter``
  * ``filter``                  — {"attr": name, "op": ..., "value": v}
  * ``select``                  — "count" | "*" | [attr, ...]  (terminal)
  * ``{"intersect": [q1, q2, ...], "select": ...}`` — star pattern (Q3):
    vertices reached by *every* branch.  Stars do not nest.
  * ``{"nearest": {"type": t, "vector": [...], "k": n}, ...}`` — k-NN probe
    root over ``t``'s vector index, replacing ``type``/``id``; the chain
    (if any) continues from the k seed vertices.  Not allowed inside
    intersect branches.
  * ``hints``                   — {"frontier"|"expand"|"results"|"bucket":
                                  n, ...}: per-plan §3.4 capacity overrides
                                  (the paper's optional query hints map 1:1
                                  onto our static working-set knobs).  May
                                  sit at the terminal node and/or the query
                                  root; per-key merge, root wins.  Stars
                                  carry hints at the root only (branch
                                  hints are a ParseError).

The parser resolves names against the catalog and produces one typed
logical-plan IR tree (:mod:`repro_torch.core.query.ir`) per query — the paper's
logical plan; A1 has no optimizer ("most queries are straightforward and
executed without any optimization").  Chains and star patterns are the same
tree shape; ``ir.lower`` produces the physical plan + runtime start keys the
executors compile.  ``Plan``/``Hop``/``Pred`` are re-exported here for the
executor layer.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.query import ir
from repro_torch.core.query.ir import (  # noqa: F401 (re-export)
    _OPS, CapHints, Hop, Plan, Pred)


class ParseError(ValueError):
    pass


def _parse_pred(db, vtype_name: Optional[str], node) -> Pred:
    attr, op, val = node.get("attr"), node.get("op", "=="), node.get("value")
    if op not in _OPS:
        raise ParseError(f"bad op {op!r}")
    if attr == "key" or vtype_name is None:
        return Pred("key", 0, op, float(val))
    a = db.vt(vtype_name).attr(attr)
    return Pred(a.kind, a.col, op, float(val))


_HINT_KEYS = ("frontier", "expand", "results", "bucket")


def _parse_hints(node) -> CapHints:
    h = node.get("hints")
    if not h:
        return ir.NO_HINTS
    bad = set(h) - set(_HINT_KEYS)
    if bad:
        raise ParseError(f"unknown hint(s) {sorted(bad)}; "
                         f"valid: {_HINT_KEYS}")
    vals = {}
    for k, v in h.items():
        try:
            iv = int(v)
        except (TypeError, ValueError):
            raise ParseError(f"hint {k!r} must be a positive int, "
                             f"got {v!r}") from None
        # reject bools and non-integral floats (int() would silently
        # truncate 7.9 -> 7); integral floats (64.0) are fine — JSON
        if isinstance(v, bool) or iv != v or iv <= 0:
            raise ParseError(f"hint {k!r} must be a positive int, got {v!r}")
        vals[k] = iv
    return CapHints(**vals)


def _parse_cursor(q) -> int:
    """Root-level ``gid_cursor``: a runtime final predicate ``gid > cursor``
    (deep-pagination refills page in O(page) without retracing — the cursor
    never enters the physical plan)."""
    v = q.get("gid_cursor")
    if v is None:
        return -1
    if isinstance(v, bool) or not isinstance(v, int) or v < 0:
        raise ParseError(f"gid_cursor must be a non-negative int, got {v!r}")
    return int(v)


def parse(db, q: dict):
    """Parse one A1QL document into its logical-plan IR root."""
    if "intersect" in q:
        branches = []
        for b in q["intersect"]:
            if "intersect" in b:
                raise ParseError("nested intersect is not supported")
            if "nearest" in b:
                raise ParseError(
                    "nearest is not supported in intersect branches")
            body, leaf = _parse_chain(db, b)
            if "hints" in b or "hints" in leaf[0]:
                raise ParseError("hints belong on the star root, "
                                 "not its branches")
            branches.append(body)
        node = ir.Intersect(branches=tuple(branches))
        if "filter" in q:
            node = ir.Filter(child=node,
                             pred=_parse_pred(db, q.get("type"), q["filter"]))
        return _terminal(db, q, node, vtype_name=q.get("type"))
    body, leaf = _parse_chain(db, q)
    if isinstance(body, ir.Scan):
        raise ParseError("query needs at least one traversal step")
    return _terminal(db, leaf[0], body, vtype_name=leaf[1], root=q)


def _parse_chain(db, q: dict):
    """Parse a chain document body.  Returns (body node, (leaf dict, leaf
    vertex-type name)) — the leaf carries the terminal/final filter."""
    node = q
    if "nearest" in q:
        # k-NN probe root replacing {'type', 'id'}: the chain continues from
        # the k seed vertices exactly as it would from a scanned one
        body, vtype_name = _parse_nearest(db, q)
    else:
        if "type" not in q or "id" not in q:
            raise ParseError("query must start with {'type', 'id'}")
        vt = db.vt(q["type"])
        vtype_name = q["type"]
        body = ir.Scan(vtype=vt.type_id, key=int(q["id"]))
    while True:
        edge_key = ("_out_edge" if "_out_edge" in node
                    else "_in_edge" if "_in_edge" in node else None)
        if edge_key is None:
            return body, (node, vtype_name)
        if node is not q and "hints" in node:
            # ``node`` has an outgoing step, so it is an intermediate
            # _target — hints only bind at the root or the terminal
            raise ParseError("hints belong on the query root or the "
                             "terminal node, not an intermediate step")
        e = node[edge_key]
        et_name = e.get("type", "*")
        etid = -1 if et_name == "*" else db.et(et_name).type_id
        tgt = e.get("_target", {})
        t_name = tgt.get("type")
        t_id = db.vt(t_name).type_id if t_name else -1
        body = ir.Expand(child=body,
                         direction="out" if edge_key == "_out_edge" else "in",
                         etype=etid, target_vtype=t_id)
        if "filter" in tgt:
            body = ir.Filter(child=body,
                             pred=_parse_pred(db, t_name, tgt["filter"]))
        node = tgt
        vtype_name = t_name


def _parse_nearest(db, q: dict):
    """Validate a ``"nearest"`` root document -> (ir.Nearest, vtype name)."""
    spec = q["nearest"]
    if "type" in q or "id" in q:
        raise ParseError("'nearest' replaces the {'type', 'id'} root")
    if not isinstance(spec, dict) or "type" not in spec or "vector" not in spec:
        raise ParseError("nearest needs {'type', 'vector'[, 'k']}")
    vt = db.vt(spec["type"])
    if vt.type_id not in db._vindexed:
        raise ParseError(
            f"vertex type {spec['type']!r} has no vector index; "
            "call GraphDB.vector_index() first")
    k = spec.get("k", 1)
    if isinstance(k, bool) or not isinstance(k, int) or k < 1:
        raise ParseError(f"nearest k must be a positive int, got {k!r}")
    vec = spec["vector"]
    if (not isinstance(vec, (list, tuple))
            or len(vec) != db.cfg.d_f32
            or not all(isinstance(x, (int, float)) and not isinstance(x, bool)
                       for x in vec)):
        raise ParseError(
            f"nearest vector must be {db.cfg.d_f32} numbers "
            f"(the type's f32 payload width)")
    body = ir.Nearest(vtype=vt.type_id, k=int(k),
                      vector=tuple(float(x) for x in vec))
    return body, spec["type"]


def _terminal(db, node, body, vtype_name: Optional[str], root=None):
    term, kinds, cols = _parse_select(db, node, vtype_name=vtype_name)
    hints = _parse_hints(node)
    cursor = _parse_cursor(root if root is not None else node)
    if root is not None and root is not node:
        # chains: hints may sit at the terminal AND/OR the root; per-key
        # merge with the ROOT winning, so a caller can wrap any document
        # with an override (serve's continuation refills do exactly this)
        hints = hints.override(_parse_hints(root))
    if term == "count":
        return ir.Count(child=body, hints=hints, gid_cursor=cursor)
    return ir.Select(child=body, kinds=kinds, cols=cols, hints=hints,
                     gid_cursor=cursor)


def parse_legacy(db, q: dict):
    """Historical entry point: returns ``(plan, start_key)`` for chains and
    ``(plan, [branch keys])`` for stars.  Prefer :func:`parse` + ``ir.lower``.
    """
    lo = ir.lower(parse(db, q))
    if lo.is_intersect:
        return lo.plan, list(lo.keys)
    return lo.plan, lo.keys[0]


def _parse_select(db, node, vtype_name: Optional[str] = None):
    sel = node.get("select", "count")
    if sel == "count":
        return "count", (), ()
    if sel == "*" or sel == ["*"]:
        if vtype_name is None:
            return "select", ("key",), (0,)
        vt = db.vt(vtype_name)
        kinds = ("key",) + tuple(a.kind for a in vt.attrs)
        cols = (0,) + tuple(a.col for a in vt.attrs)
        return "select", kinds, cols
    if isinstance(sel, (list, tuple)):
        kinds, cols = [], []
        for name in sel:
            if name == "key":
                kinds.append("key")
                cols.append(0)
            else:
                a = db.vt(vtype_name).attr(name)
                kinds.append(a.kind)
                cols.append(a.col)
        return "select", tuple(kinds), tuple(cols)
    raise ParseError(f"bad select {sel!r}")
