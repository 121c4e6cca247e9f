"""A1QL v2: the typed logical-plan IR (§3.4).

A1 compiles every query — chain traversals *and* star patterns — into one
small operator set (index scan -> edge enumeration -> predicate evaluation ->
dedup -> aggregate).  This module is that operator set as a typed tree, the
single representation every entry point shares:

  * :class:`Scan`      — start vertex via the primary index (one probe);
  * :class:`Expand`    — one typed edge-enumeration step over the child's
                         frontier (direction, edge type, target-type check);
  * :class:`Filter`    — predicate evaluation on the child's frontier;
  * :class:`Intersect` — star pattern (Q3): vertices reached by *every*
                         branch.  Branches are chain bodies; nesting stars
                         inside stars is rejected at parse time;
  * :class:`Select` / :class:`Count` — the aggregate terminals.  Terminals
    are the tree roots and carry the per-plan :class:`CapHints` (the paper's
    optional query hints map 1:1 onto our static §3.4 capacity knobs).

``a1ql.parse`` produces one IR root per query — chains and stars are the
same tree shape instead of the historical ``(plan, int)`` vs ``(plan, list)``
tuple split.  The executors run *lowered* physical plans (:class:`Plan`,
a flat hop list per chain unit); :func:`lower` produces one
:class:`Lowered` per root: the physical plan, the runtime start key(s) (one
per chain unit — a star contributes one per branch), and the cap hints.

Signatures
----------
``node.signature()`` is the *structural* key: it keeps tree shape, hop
directions, and predicate kinds/ops but drops runtime values (start keys,
predicate constants).  Two queries with equal signatures group into the same
fusion family; program-cache identity is the full lowered ``Plan`` (which
bakes edge types and predicate constants into the compiled program) — keys
always stay runtime data, so re-keying a query never retraces.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

_OPS = ("==", "!=", "<", "<=", ">", ">=")


# ---------------------------------------------------------------------------
# the physical (lowered) form — what the executors compile
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Pred:
    kind: str        # 'f32' | 'i32' | 'key'
    col: int
    op: str
    val: float


@dataclasses.dataclass(frozen=True)
class Hop:
    direction: str               # 'out' | 'in'
    etype: int                   # resolved edge-type id, -1 = any
    target_vtype: int = -1       # -1 = unchecked
    pred: Optional[Pred] = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """Lowered physical plan: a flat chain (or intersect-of-chains).

    This is what the compiled programs are keyed on; start keys are *not*
    part of it (they stay runtime data)."""
    start_vtype: int
    hops: tuple[Hop, ...]
    terminal: str                        # 'count' | 'select'
    select_kind: tuple = ()              # per col: 'f32'|'i32'|'key'
    select_cols: tuple = ()              # column ids (parallel to kinds)
    branches: tuple["Plan", ...] = ()    # intersect-of-branches when set
    final_pred: Optional[Pred] = None
    nearest_k: int = 0                   # >0: k-NN probe root (no start key);
                                         # the query vector stays runtime data

    @property
    def is_intersect(self) -> bool:
        return bool(self.branches)

    def chain_units(self) -> tuple["Plan", ...]:
        """The probe/hop units this plan contributes to the fused waves:

        one per branch for a star, the plan itself for a chain."""
        return self.branches if self.branches else (self,)

    def signature(self):
        """Structural key (no runtime values) — see module docstring."""
        if self.is_intersect:
            return ("intersect", tuple(b.signature() for b in self.branches),
                    self.terminal, self.select_kind, self.select_cols,
                    _psig(self.final_pred))
        return ("chain", self.nearest_k,
                tuple((h.direction, _psig(h.pred)) for h in self.hops),
                self.terminal, self.select_kind, self.select_cols,
                _psig(self.final_pred))


def _psig(p: Optional[Pred]):
    return None if p is None else (p.kind, p.op)


# ---------------------------------------------------------------------------
# cap hints
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CapHints:
    """Per-plan §3.4 capacity-knob overrides (the A1QL ``hints`` document).

    ``None`` means "use the caller's cap".  Hints participate in the fusion
    group key, so queries sharing hints fuse and parity with per-query
    execution is preserved (every query still runs at exactly the budget it
    would get alone)."""
    frontier: Optional[int] = None
    expand: Optional[int] = None
    results: Optional[int] = None
    bucket: Optional[int] = None

    def apply(self, caps):
        """Overlay onto a QueryCaps-like frozen dataclass."""
        over = {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}
        return dataclasses.replace(caps, **over) if over else caps

    def override(self, over: "CapHints") -> "CapHints":
        """Per-key merge where ``over`` wins (root hints over leaf hints)."""
        vals = {k: (o if (o := getattr(over, k)) is not None
                    else getattr(self, k))
                for k in ("frontier", "expand", "results", "bucket")}
        if all(v is None for v in vals.values()):
            return NO_HINTS
        return CapHints(**vals)


NO_HINTS = CapHints()


# ---------------------------------------------------------------------------
# the logical IR nodes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scan:
    """Primary-index probe: the start vertex of one chain unit."""
    vtype: int
    key: int

    def signature(self):
        return ("scan",)


@dataclasses.dataclass(frozen=True)
class Nearest:
    """k-NN probe root: seed the chain with the ``k`` nearest vector-indexed
    vertices of ``vtype`` (squared-L2 over the f32 payload, ties broken by
    ascending gid).  Like start keys, ``vector`` is runtime data — only
    ``k`` enters the physical plan."""
    vtype: int
    k: int
    vector: tuple                # tuple[float, ...] query embedding

    def signature(self):
        return ("nearest", self.k)


@dataclasses.dataclass(frozen=True)
class Expand:
    """One edge-enumeration step over ``child``'s frontier."""
    child: "Body"
    direction: str               # 'out' | 'in'
    etype: int                   # -1 = any
    target_vtype: int = -1       # -1 = unchecked

    def signature(self):
        return ("expand", self.direction, self.child.signature())


@dataclasses.dataclass(frozen=True)
class Filter:
    """Predicate evaluation on ``child``'s frontier."""
    child: "Body"
    pred: Pred

    def signature(self):
        return ("filter", self.pred.kind, self.pred.op,
                self.child.signature())


@dataclasses.dataclass(frozen=True)
class Intersect:
    """Star pattern: vertices reached by every branch (chain bodies only)."""
    branches: tuple["Body", ...]

    def signature(self):
        return ("intersect", tuple(b.signature() for b in self.branches))


@dataclasses.dataclass(frozen=True)
class Count:
    """Terminal: count the final frontier.

    ``gid_cursor`` (-1 = none) is a *runtime* final predicate
    ``gid > cursor`` — like start keys it never enters the physical plan,
    so continuation refills with moving cursors reuse compiled programs."""
    child: "Body"
    hints: CapHints = NO_HINTS
    gid_cursor: int = -1

    def signature(self):
        return ("count", self.child.signature())


@dataclasses.dataclass(frozen=True)
class Select:
    """Terminal: materialize rows (gid + the named attribute columns).

    ``gid_cursor``: see :class:`Count` — runtime data, not plan identity."""
    child: "Body"
    kinds: tuple = ()            # per col: 'f32'|'i32'|'key'
    cols: tuple = ()
    hints: CapHints = NO_HINTS
    gid_cursor: int = -1

    def signature(self):
        return ("select", self.kinds, self.cols, self.child.signature())


Body = Union[Scan, Nearest, Expand, Filter, Intersect]
Node = Union[Body, Count, Select]
TERMINALS = (Count, Select)


def is_root(node) -> bool:
    return isinstance(node, TERMINALS)


# ---------------------------------------------------------------------------
# lowering: IR tree -> physical Plan + runtime keys
# ---------------------------------------------------------------------------

class LoweringError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Lowered:
    """One query, lowered: physical plan + runtime start key(s) + hints.

    ``keys`` holds one start key per chain unit (1 for a chain, one per
    branch for a star) — always a tuple, never the historical int-vs-list
    split.  ``cursor`` is the runtime gid-cursor (-1 = none)."""
    plan: Plan
    keys: tuple[int, ...]
    hints: CapHints = NO_HINTS
    cursor: int = -1
    vecs: tuple = ()             # per chain unit: None | tuple[float, ...]
                                 # (query embeddings for Nearest-rooted units;
                                 # () from legacy adapters means all-None)

    @property
    def is_intersect(self) -> bool:
        return self.plan.is_intersect


def _lower_chain(body):
    """Walk a chain body (Scan or Nearest at the leaf) ->
    ``(start_vtype, hops, key, nearest_k, vec)``."""
    rev_hops: list[Hop] = []
    node = body
    pending_pred: Optional[Pred] = None
    while True:
        if isinstance(node, Filter):
            if pending_pred is not None:
                raise LoweringError("stacked filters on one step")
            pending_pred = node.pred
            node = node.child
        elif isinstance(node, Expand):
            rev_hops.append(Hop(direction=node.direction, etype=node.etype,
                                target_vtype=node.target_vtype,
                                pred=pending_pred))
            pending_pred = None
            node = node.child
        elif isinstance(node, Scan):
            if pending_pred is not None:
                raise LoweringError("filter on the scan step")
            return node.vtype, tuple(reversed(rev_hops)), node.key, 0, None
        elif isinstance(node, Nearest):
            if pending_pred is not None:
                raise LoweringError("filter on the nearest step")
            return (node.vtype, tuple(reversed(rev_hops)), -1,
                    int(node.k), tuple(float(x) for x in node.vector))
        elif isinstance(node, Intersect):
            raise LoweringError("nested intersect is not supported")
        else:
            raise LoweringError(f"bad chain node {type(node).__name__}")


def lower(root) -> Lowered:
    """Lower one IR root (a terminal node) to its physical plan + keys."""
    if not is_root(root):
        raise LoweringError(
            f"plan root must be Count or Select, got {type(root).__name__}")
    if isinstance(root, Count):
        terminal, kinds, cols = "count", (), ()
    else:
        terminal, kinds, cols = "select", root.kinds, root.cols
    body = root.child
    final_pred = None
    if isinstance(body, Filter) and isinstance(body.child, Intersect):
        final_pred = body.pred
        body = body.child
    if isinstance(body, Intersect):
        if len(body.branches) < 2:
            raise LoweringError("intersect needs at least two branches")
        chains, keys = [], []
        for br in body.branches:
            vt, hops, key, nk, _vec = _lower_chain(br)
            if nk:
                raise LoweringError(
                    "nearest is not supported in intersect branches")
            if not hops:
                raise LoweringError("intersect branch needs a traversal step")
            chains.append(Plan(start_vtype=vt, hops=hops, terminal=terminal,
                               select_kind=kinds, select_cols=cols))
            keys.append(key)
        plan = Plan(start_vtype=-1, hops=(), terminal=terminal,
                    select_kind=kinds, select_cols=cols,
                    branches=tuple(chains), final_pred=final_pred)
        return Lowered(plan=plan, keys=tuple(keys), hints=root.hints,
                       cursor=root.gid_cursor,
                       vecs=(None,) * len(chains))
    vt, hops, key, nk, vec = _lower_chain(body)
    if not hops and not nk:
        # a Nearest root is itself the probe step; a bare Scan is not
        raise LoweringError("query needs at least one traversal step")
    plan = Plan(start_vtype=vt, hops=hops, terminal=terminal,
                select_kind=kinds, select_cols=cols, final_pred=final_pred,
                nearest_k=nk)
    return Lowered(plan=plan, keys=(key,), hints=root.hints,
                   cursor=root.gid_cursor, vecs=(vec,))


def from_legacy(plan: Plan, key_or_keys) -> Lowered:
    """Adapt the historical ``(plan, key-or-list)`` parse output."""
    if plan.is_intersect:
        keys = tuple(int(k) for k in key_or_keys)
    else:
        keys = (int(key_or_keys),)
    return Lowered(plan=plan, keys=keys)
