"""TQL scan planner: chunk-statistics predicate pushdown (data skipping).

Delta-Lake-style file skipping, adapted to Deep Lake's chunked tensor layout:
each chunk carries :class:`~repro.core.chunks.ChunkStats` (element-wise
lo/hi bounds, NaN / empty-sample flags).  Before ``Executor.run`` evaluates a
``WHERE`` clause, :func:`plan_where` walks the predicate AST with interval
arithmetic over those bounds and classifies every row of the view into one of
three verdicts, grouped by the tuple of chunks the row lives in:

* **prune**  — the predicate is certainly False for every row of the group;
  the chunks are never fetched or decoded;
* **sure**   — certainly True; rows are kept without evaluating the predicate;
* **verify** — unknown; rows are evaluated normally (the only rows whose
  chunks are fetched during WHERE).

Soundness rules (all conservative — unknown always falls back to verify):

* a row's truth is ``_truthy(value)`` = "all elements non-zero, empty is
  False", so a comparison is certainly-True only when the whole stats
  interval satisfies it and certainly-False only when none of it can;
* NaN elements make ``== < <= > >=`` possibly-False and ``!=`` possibly-True
  (IEEE semantics); possibly-empty samples make any comparison
  possibly-False;
* ``tensor = literal`` / ``tensor IN [...]`` / ``CONTAINS(tensor, literal)``
  additionally consult the chunk's membership sketch
  (:meth:`~repro.core.chunks.ChunkStats.might_contain`): a value the sketch
  *proves absent* yields a definitive verdict (false positives merely cost a
  verify), with the empty-sample outcome derived from ``min_elems`` because
  empty samples contribute no sketch values — ``x == v`` and
  ``CONTAINS(x, v)`` are False on an empty sample but ``x IN [...]`` is
  True (``isin(empty, ...).all()`` is vacuously True);
* expressions the planner cannot analyze (UDFs, subscripts,
  string literals, ...) evaluate to the unknown interval TOP;
* computed values (literals the engine may cast to float32, arithmetic,
  MEAN/STD/SQRT/CAST_FLOAT) are widened outward by the worst-case float32
  evaluation rounding, and arithmetic that could overflow int64 becomes TOP
  — interval math in float64 alone would flip verdicts at bound-hugging
  predicates;
* a predicate containing RANDOM() disables planning entirely: evaluating it
  over a subset would change the random stream and thus the result.

Intervals use ``lo > hi`` to mean "no non-NaN numeric values" (e.g. MEAN of a
chunk of empty samples): comparisons then draw outcomes only from the
NaN/empty flags.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional

import numpy as np

from .. import telemetry
from .ast_nodes import (BinOp, Call, ListExpr, Literal, Node, TensorRef,
                        UnaryOp)
from ..chunks import ChunkStats, _hi_bound, _lo_bound

_CMP_OPS = ("==", "!=", ">", ">=", "<", "<=")

# The engine may evaluate in float32 (NEP-50 weak scalars keep a float32
# column float32), so every interval that models a *computed* value must be
# widened outward by the worst-case evaluation rounding, or a bound-hugging
# predicate could flip a verdict (e.g. float32(0.4 + 2**24) == 2**24).
_EPS32 = float(np.finfo(np.float32).eps)     # one-rounding relative error
_EPS_MEAN = 64 * _EPS32                      # pairwise-sum error, n <= 2**64
_EPS_STD = 256 * _EPS32                      # sum-of-squares + sqrt margin
_TINY32 = float(np.finfo(np.float32).tiny)   # absolute floor (subnormals)
_INT_GUARD = float(2 ** 62)                  # int64 arithmetic may overflow


def _pad(lo: float, hi: float, rel: float = _EPS32):
    """Widen [lo, hi] outward by the evaluation rounding margin; None means
    the magnitude is large enough that int64 overflow could wrap (→ TOP)."""
    m = max(abs(lo), abs(hi))
    if m >= _INT_GUARD:
        return None
    pad = rel * m + _TINY32
    return lo - pad, hi + pad

BOTH: FrozenSet[bool] = frozenset((True, False))
ONLY_T: FrozenSet[bool] = frozenset((True,))
ONLY_F: FrozenSet[bool] = frozenset((False,))


@dataclass(frozen=True)
class Interval:
    """Bounds on every element an expression can produce for rows of one
    chunk group.  ``known=False`` is TOP: nothing can be said."""

    lo: float = -math.inf
    hi: float = math.inf
    has_nan: bool = True
    maybe_empty: bool = True
    known: bool = False

    @property
    def has_values(self) -> bool:
        return self.known and self.lo <= self.hi

    def is_point(self) -> bool:
        return self.has_values and self.lo == self.hi \
            and not self.has_nan and not self.maybe_empty


TOP = Interval()


def _point(v: float) -> Interval:
    return Interval(float(v), float(v), has_nan=False, maybe_empty=False,
                    known=True)


def interval_from_stats(stats) -> Interval:
    """Map a ChunkStats record (or None) to the planner's interval domain."""
    if stats is None or not stats.exact:
        return TOP
    maybe_empty = stats.min_elems == 0 or stats.count == 0
    if stats.lo is None:  # no inspectable numeric values (all NaN / empty)
        return Interval(math.inf, -math.inf, has_nan=stats.nan_count > 0,
                        maybe_empty=maybe_empty, known=True)
    return Interval(float(stats.lo), float(stats.hi),
                    has_nan=stats.nan_count > 0, maybe_empty=maybe_empty,
                    known=True)


# ------------------------------------------------------------ interval algebra
def _flags(a: Interval, b: Interval) -> Dict[str, bool]:
    return {"has_nan": a.has_nan or b.has_nan,
            "maybe_empty": a.maybe_empty or b.maybe_empty}


def _arith(op: str, a: Interval, b: Interval) -> Interval:
    if not a.known or not b.known:
        return TOP
    if not a.has_values or not b.has_values:
        # one side is only-NaN/empty: result values are NaN or empty
        return Interval(math.inf, -math.inf, known=True, **_flags(a, b))
    if op == "+":
        lo, hi = a.lo + b.lo, a.hi + b.hi
    elif op == "-":
        lo, hi = a.lo - b.hi, a.hi - b.lo
    elif op == "*":
        prods = (a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi)
        lo, hi = min(prods), max(prods)
    elif op == "/":
        if b.lo <= 0 <= b.hi:
            return TOP  # division by (possibly) zero: anything can happen
        quots = (a.lo / b.lo, a.lo / b.hi, a.hi / b.lo, a.hi / b.hi)
        lo, hi = min(quots), max(quots)
    else:  # '%' and anything exotic
        return TOP
    if math.isnan(lo) or math.isnan(hi):
        return TOP
    padded = _pad(lo, hi)
    if padded is None:
        return TOP
    return Interval(*padded, known=True, **_flags(a, b))


def _neg(a: Interval) -> Interval:
    if not a.known:
        return TOP
    if not a.has_values:
        return a
    return Interval(-a.hi, -a.lo, has_nan=a.has_nan,
                    maybe_empty=a.maybe_empty, known=True)


def _cmp_truth(a: Interval, b: Interval, op: str) -> FrozenSet[bool]:
    if not a.known or not b.known:
        return BOTH
    out = set()
    if a.has_values and b.has_values:
        if op in ("<", ">"):
            lt = (a, b) if op == "<" else (b, a)
            if lt[0].hi < lt[1].lo:
                out.add(True)
            elif lt[0].lo >= lt[1].hi:
                out.add(False)
            else:
                out.update(BOTH)
        elif op in ("<=", ">="):
            le = (a, b) if op == "<=" else (b, a)
            if le[0].hi <= le[1].lo:
                out.add(True)
            elif le[0].lo > le[1].hi:
                out.add(False)
            else:
                out.update(BOTH)
        elif op == "==":
            if a.lo == a.hi == b.lo == b.hi:
                out.add(True)
            elif a.hi < b.lo or a.lo > b.hi:
                out.add(False)
            else:
                out.update(BOTH)
        elif op == "!=":
            if a.hi < b.lo or a.lo > b.hi:
                out.add(True)
            elif a.lo == a.hi == b.lo == b.hi:
                out.add(False)
            else:
                out.update(BOTH)
        else:
            return BOTH
    if a.has_nan or b.has_nan:
        out.add(True if op == "!=" else False)
    if a.maybe_empty or b.maybe_empty:
        out.add(False)  # empty comparison result -> _truthy is False
    return frozenset(out) if out else BOTH


def _truthify(iv: Interval) -> FrozenSet[bool]:
    """Possible row truth values of a non-comparison expression (§executor
    semantics: all elements non-zero; empty is False; NaN is truthy)."""
    if not iv.known:
        return BOTH
    out = set()
    if iv.has_values:
        if iv.lo > 0 or iv.hi < 0:
            out.add(True)
        elif iv.lo == 0 == iv.hi:
            out.add(False)
        else:
            out.update(BOTH)
    if iv.has_nan:
        out.add(True)
    if iv.maybe_empty:
        out.add(False)
    return frozenset(out) if out else BOTH


def _bool_interval(t: FrozenSet[bool]) -> Interval:
    if t == ONLY_T:
        return _point(1.0)
    if t == ONLY_F:
        return _point(0.0)
    return Interval(0.0, 1.0, has_nan=False, maybe_empty=False, known=True)


# ------------------------------------------------------------- membership
#: literal values the int sketch domain can reason about: actual chunk
#: elements are int64-representable integers, so an equal-comparing literal
#: either maps to one ("int") or provably equals no element ("never") —
#: anything murkier (strings, huge ints, non-finite) bails ("bail").
def _member_value(v):
    if isinstance(v, bool):
        return "int", int(v)
    if isinstance(v, (int, np.integer)):
        iv = int(v)
        return ("int", iv) if -(2 ** 63) <= iv < 2 ** 63 else ("bail", None)
    if isinstance(v, float):
        if not math.isfinite(v):
            return "bail", None
        if not float(v).is_integer():
            return "never", None  # non-integral: equals no int element
        iv = int(v)
        # integral but outside int64: a uint64 element CAN equal it under
        # the executor's float comparison — bail, never claim absence
        return ("int", iv) if -(2 ** 63) <= iv < 2 ** 63 else ("bail", None)
    return "bail", None


def _ref_and_literal(a: Node, b: Node):
    if isinstance(a, TensorRef) and isinstance(b, Literal):
        return a, b
    if isinstance(b, TensorRef) and isinstance(a, Literal):
        return b, a
    return None, None


# --------------------------------------------------------------- AST analysis
class _Analyzer:
    def __init__(self, env: Dict[str, Interval],
                 sketches: Optional[Dict[str, Optional[ChunkStats]]] = None
                 ) -> None:
        self.env = env
        self.sketches = sketches or {}

    # -- truth ---------------------------------------------------------------
    def truth(self, node: Node) -> FrozenSet[bool]:
        if isinstance(node, BinOp):
            if node.op in ("and", "or"):
                lt, rt = self.truth(node.left), self.truth(node.right)
                if node.op == "and":
                    return frozenset(a and b for a in lt for b in rt)
                return frozenset(a or b for a in lt for b in rt)
            if node.op in _CMP_OPS:
                base = _cmp_truth(self.interval(node.left),
                                  self.interval(node.right), node.op)
                memb = self._membership(node)
                if memb is not None:
                    # both are sound supersets of the possible row truths,
                    # so their intersection is too (guard the impossible)
                    both = base & memb
                    return both if both else base
                return base
            if node.op == "in":
                memb = self._membership(node)
                if memb is not None:
                    return memb
        if isinstance(node, Call):
            memb = self._membership(node)
            if memb is not None:
                return memb
        if isinstance(node, UnaryOp) and node.op == "not":
            return frozenset(not v for v in self.truth(node.operand))
        return _truthify(self.interval(node))

    # -- membership sketches -------------------------------------------------
    def _sketch_for(self, name: str, dom: str) -> Optional[ChunkStats]:
        st = self.sketches.get(name)
        if st is None or not st.sketch_usable(dom):
            return None
        return st

    @staticmethod
    def _maybe_empty(st: ChunkStats) -> bool:
        return st.min_elems == 0 or st.count == 0

    def _membership(self, node: Node) -> Optional[FrozenSet[bool]]:
        """Sketch verdict for ``=``/``!=``/``IN``/``CONTAINS`` over one base
        tensor and literal values; None = the sketch cannot refine.  All
        branches mirror the executor's row semantics exactly (`_truthy`
        over elementwise comparison; ``isin(sample, list).all()``;
        ``CONTAINS``'s text/elementwise split)."""
        if isinstance(node, BinOp) and node.op in ("==", "!="):
            ref, lit = _ref_and_literal(node.left, node.right)
            if ref is None:
                return None
            kind, v = _member_value(lit.value)
            if kind == "bail":
                return None
            st = self._sketch_for(ref.name, "int")
            if st is None:
                return None
            if kind == "int" and st.might_contain(v):
                return None
            # v provably equals no element of any sample in the chunk
            if node.op == "==":
                return ONLY_F          # empty samples are False too
            out = {True}               # all elements differ -> row True
            if self._maybe_empty(st):
                out.add(False)         # ...but an empty comparison is False
            return frozenset(out)
        if isinstance(node, BinOp) and node.op == "in" \
                and isinstance(node.left, TensorRef) \
                and isinstance(node.right, ListExpr):
            if not all(isinstance(it, Literal) for it in node.right.items):
                return None
            vals = []
            for it in node.right.items:
                kind, v = _member_value(it.value)
                if kind == "bail":
                    return None
                if kind == "int":
                    vals.append(v)     # "never" values match no element
            st = self._sketch_for(node.left.name, "int")
            if st is None:
                return None
            if not any(st.might_contain(v) for v in vals):
                # no element of any sample is in the list
                out = {False}
                if self._maybe_empty(st):
                    out.add(True)      # isin(empty, ...).all() is True
                return frozenset(out)
            if st.dct is not None and set(st.dct) <= set(vals):
                return ONLY_T          # every element everywhere is listed
            return None
        if isinstance(node, Call) and node.name.upper() == "CONTAINS" \
                and len(node.args) == 2 \
                and isinstance(node.args[0], TensorRef) \
                and isinstance(node.args[1], Literal):
            name, needle = node.args[0].name, node.args[1].value
            if isinstance(needle, str):
                # text domain: dictionary only (a bloom of whole strings
                # cannot answer substring probes); "" is in every string
                st = self._sketch_for(name, "str")
                if st is None or st.dct is None or needle == "":
                    return None
                hits = sum(needle in s for s in st.dct)
                if hits == 0:
                    return ONLY_F      # empty samples decode to "" -> False
                if hits == len(st.dct) and not self._maybe_empty(st):
                    return ONLY_T
                return None
            kind, v = _member_value(needle)
            if kind == "bail":
                return None
            st = self._sketch_for(name, "int")
            if st is None:
                return None
            if kind == "never":        # non-integral float: in no int sample
                return ONLY_F
            if not st.might_contain(v):
                return ONLY_F          # isin(v, empty).all() is False too
            if st.dct == [v] and not self._maybe_empty(st):
                return ONLY_T          # the only element value everywhere
            return None
        return None

    # -- intervals -----------------------------------------------------------
    def interval(self, node: Node) -> Interval:
        if isinstance(node, Literal):
            if isinstance(node.value, bool):
                return _point(1.0 if node.value else 0.0)
            if isinstance(node.value, (int, float)):
                # the engine may cast the literal to a column's float32: the
                # operand is then float32(v), so the interval is the exact
                # hull of both representations (a point when v is exact in
                # float32 — keeps integer comparisons decisively 'sure')
                v = node.value
                f32 = float(np.float32(v))
                if math.isnan(f32):
                    return TOP
                return Interval(_lo_bound(min(v, f32)),
                                _hi_bound(max(v, f32)),
                                has_nan=False, maybe_empty=False, known=True)
            return TOP
        if isinstance(node, TensorRef):
            return self.env.get(node.name, TOP)
        if isinstance(node, UnaryOp):
            if node.op == "-":
                return _neg(self.interval(node.operand))
            return _bool_interval(
                frozenset(not v for v in self.truth(node.operand)))
        if isinstance(node, BinOp):
            if node.op in ("and", "or") or node.op in _CMP_OPS:
                return _bool_interval(self.truth(node))
            return _arith(node.op, self.interval(node.left),
                          self.interval(node.right))
        if isinstance(node, Call):
            return self._call(node)
        return TOP  # Index, ListExpr, SliceSpec, unknown nodes

    def _call(self, node: Call) -> Interval:
        name = node.name.upper()
        if name in ("MEAN", "MIN", "MAX", "STD") and len(node.args) == 1:
            a = self.interval(node.args[0])
            if not a.known:
                return TOP
            if name == "STD":
                lo, hi = (0.0, a.hi - a.lo) if a.has_values else (math.inf,
                                                                  -math.inf)
            else:
                lo, hi = (a.lo, a.hi) if a.has_values else (math.inf,
                                                            -math.inf)
            # reductions of an empty sample yield NaN on both execution
            # paths (functions._reduce_all), folded into has_nan below
            if name in ("MEAN", "STD") and lo <= hi:
                # accumulating reductions round beyond the element bounds
                padded = _pad(lo, hi, _EPS_MEAN if name == "MEAN" else _EPS_STD)
                if padded is None:
                    return TOP
                lo, hi = padded
            return Interval(lo, hi,
                            has_nan=a.has_nan or a.maybe_empty,
                            maybe_empty=False, known=True)
        if name == "ABS" and len(node.args) == 1:
            a = self.interval(node.args[0])
            if not a.known:
                return TOP
            if not a.has_values:
                return a
            lo = 0.0 if a.lo <= 0 <= a.hi else min(abs(a.lo), abs(a.hi))
            return Interval(lo, max(abs(a.lo), abs(a.hi)), has_nan=a.has_nan,
                            maybe_empty=a.maybe_empty, known=True)
        if name == "SQRT" and len(node.args) == 1:
            a = self.interval(node.args[0])
            if not a.known:
                return TOP
            if not a.has_values:
                return a
            padded = _pad(math.sqrt(max(a.lo, 0.0)), math.sqrt(max(a.hi, 0.0)))
            if padded is None:
                return TOP
            return Interval(*padded,
                            has_nan=a.has_nan or a.lo < 0,
                            maybe_empty=a.maybe_empty, known=True)
        if name == "CAST_FLOAT" and len(node.args) == 1:
            a = self.interval(node.args[0])
            if not a.known or not a.has_values:
                return a if a.known else TOP
            padded = _pad(a.lo, a.hi)  # the cast rounds to float32
            if padded is None:
                return TOP
            return Interval(*padded, has_nan=a.has_nan,
                            maybe_empty=a.maybe_empty, known=True)
        if name in ("ANY", "ALL") and len(node.args) == 1:
            a = self.interval(node.args[0])
            if not a.known:
                return TOP
            out = set()
            if a.has_values:
                if a.lo > 0 or a.hi < 0:
                    out.add(True)
                elif a.lo == 0 == a.hi:
                    out.add(False)
                else:
                    out.update(BOTH)
            if a.has_nan:
                out.add(True)  # NaN is non-zero
            if a.maybe_empty:
                # np.any(empty) is False, np.all(empty) is True
                out.add(name == "ALL")
            return _bool_interval(frozenset(out) if out else BOTH)
        return TOP


# -------------------------------------------------------------------- planning
@dataclass
class ScanPlan:
    """Row-position partition of a view under a WHERE predicate."""

    n_rows: int
    pruned: np.ndarray        # positions certainly False  (never fetched)
    sure: np.ndarray          # positions certainly True   (kept, not evaluated)
    verify: np.ndarray        # positions needing evaluation
    groups: int               # distinct chunk-combinations examined
    groups_decided: int       # groups with a definitive (non-verify) verdict
    chunks_total: int         # chunks the view touches across planned tensors
    chunks_pruned: int        # chunks no surviving candidate row needs
    tensors: List[str]        # tensors whose stats were consulted
    chunks_consulted: int = 0      # distinct (tensor, chunk) stats lookups
    chunks_stats_missing: int = 0  # lookups without a usable (exact) record
    chunks_sketchless: int = 0     # usable records predating the sketches
    # aggregation pushdown (set by the executor after the fold): chunk
    # groups whose partial aggregates came straight from ChunkStats with
    # zero payload fetches
    agg_groups_stats_answered: int = 0

    @property
    def effective(self) -> bool:
        return len(self.pruned) > 0 or len(self.sure) > 0

    @property
    def stats_coverage(self) -> float:
        """Fraction of consulted chunks with usable stats — 0.0 on a
        pre-stats dataset, 1.0 after the maintenance backfill job."""
        if not self.chunks_consulted:
            return 1.0
        return 1.0 - self.chunks_stats_missing / self.chunks_consulted

    @property
    def sketch_coverage(self) -> float:
        """Fraction of consulted chunks written sketch-aware — below 1.0
        the membership pushdown (=/IN/CONTAINS) degrades to verify on the
        legacy records until ``backfill_stats`` lifts them."""
        if not self.chunks_consulted:
            return 1.0
        return 1.0 - ((self.chunks_stats_missing + self.chunks_sketchless)
                      / self.chunks_consulted)

    def report(self) -> dict:
        return {
            "rows": self.n_rows,
            "rows_pruned": int(len(self.pruned)),
            "rows_sure": int(len(self.sure)),
            "rows_verify": int(len(self.verify)),
            "groups": self.groups,
            "groups_decided": self.groups_decided,
            "chunks_total": self.chunks_total,
            "chunks_pruned": self.chunks_pruned,
            "chunks_consulted": self.chunks_consulted,
            "chunks_stats_missing": self.chunks_stats_missing,
            "chunks_sketchless": self.chunks_sketchless,
            "agg_groups_stats_answered": self.agg_groups_stats_answered,
            "stats_coverage": self.stats_coverage,
            "sketch_coverage": self.sketch_coverage,
            "tensors": list(self.tensors),
        }


def plan_where(view, where: Node) -> Optional[ScanPlan]:
    """Classify every row of ``view`` under ``where`` using chunk statistics.

    Statistics come from :meth:`DatasetView.scan_source
    <repro.core.views.DatasetView.scan_source>`: on a committed
    (manifest-covered) dataset the chunk-boundary table and per-chunk
    records ride in the manifest's column-statistics section, so planning
    runs straight off the cold open — zero tensor binds, zero storage
    requests (plan-at-open).  Legacy/stale nodes fall back to binding.

    Returns None when planning is impossible or meaningless: no base tensors
    referenced, RANDOM() present, or indices outside a tensor's range.  A
    returned plan is always sound: pruned rows are certainly False, sure rows
    certainly True, under the executor's `_truthy` row semantics.
    """
    # registry counter, not ad-hoc: the serving bench asserts a cached
    # plan's repeat query performs zero planner work via this exact key
    telemetry.registry().counter("tql.plans").inc()
    if where is None or len(view) == 0 or where.calls("RANDOM"):
        return None
    names = [n for n in _referenced(where)
             if n not in view.derived and n in view.tensor_names]
    if not names:
        return None
    sources = {}
    ord_cols = []
    for n in names:
        src = view.scan_source(n)
        try:
            ords = src.ords_of(view.indices)
        except IndexError:
            return None
        sources[n] = src
        ord_cols.append(ords)
    key_matrix = np.stack(ord_cols, axis=1)  # (rows, tensors)
    _uniq, inverse = np.unique(key_matrix, axis=0, return_inverse=True)
    stats_cache: Dict[tuple, tuple] = {}
    # stats-coverage accounting: how many consulted chunks carried a usable
    # record (on manifest datasets the sidecar is served straight from the
    # consolidated snapshot; the maintenance backfill job drives the
    # missing count of a pre-stats dataset to zero) — and how many of those
    # predate the membership sketches (same backfill lifts them)
    coverage = {"consulted": 0, "missing": 0, "sketchless": 0}

    def leaf(tname: str, chunk_ord: int):
        k = (tname, chunk_ord)
        if k not in stats_cache:
            st = sources[tname].stats_of(chunk_ord)
            coverage["consulted"] += 1
            if st is None or not st.exact:
                coverage["missing"] += 1
            elif not st.sketched:
                coverage["sketchless"] += 1
            stats_cache[k] = (interval_from_stats(st), st)
        return stats_cache[k]

    verdicts = np.empty(len(_uniq), dtype=np.int8)  # 0 prune, 1 sure, 2 verify
    decided = 0
    for g, key in enumerate(_uniq):
        env: Dict[str, Interval] = {}
        sketches: Dict[str, Optional[ChunkStats]] = {}
        for j, n in enumerate(names):
            env[n], sketches[n] = leaf(n, int(key[j]))
        t = _Analyzer(env, sketches).truth(where)
        if t == ONLY_F:
            verdicts[g] = 0
            decided += 1
        elif t == ONLY_T:
            verdicts[g] = 1
            decided += 1
        else:
            verdicts[g] = 2
    row_verdict = verdicts[inverse]
    positions = np.arange(len(view))
    pruned = positions[row_verdict == 0]
    sure = positions[row_verdict == 1]
    verify = positions[row_verdict == 2]
    # chunk accounting: chunks no candidate (sure|verify) row ever needs
    candidates = row_verdict != 0
    chunks_total = 0
    chunks_pruned = 0
    for j in range(key_matrix.shape[1]):
        col = key_matrix[:, j]
        all_chunks = np.unique(col)
        live_chunks = np.unique(col[candidates]) if candidates.any() \
            else np.empty(0)
        chunks_total += len(all_chunks)
        chunks_pruned += len(all_chunks) - len(live_chunks)
    return ScanPlan(
        n_rows=len(view), pruned=pruned, sure=sure, verify=verify,
        groups=len(_uniq), groups_decided=decided,
        chunks_total=chunks_total, chunks_pruned=chunks_pruned,
        tensors=names, chunks_consulted=coverage["consulted"],
        chunks_stats_missing=coverage["missing"],
        chunks_sketchless=coverage["sketchless"])


def group_key_intervals(view, pipe, key_expr: Node) -> List[Interval]:
    """Per-chunk-group interval of an ``ORDER BY`` key expression, under
    the same soundness rules as :func:`plan_where` (float32-rounding
    widened, int64-overflow guarded, NaN/empty flags) — the bound source
    for the executor's top-k chunk skipping.  ``pipe`` is the
    :class:`~repro.core.pipeline.ScanPipeline` built over ``view`` for the
    key's base tensors; group ``g``'s interval bounds every key value a row
    of that group can produce, so a group whose bound cannot beat the
    running k-th-element cutoff is never streamed."""
    sources = {n: view.scan_source(n) for n in pipe.names}
    cache: Dict[tuple, Interval] = {}
    out: List[Interval] = []
    for g in range(pipe.n_groups):
        env: Dict[str, Interval] = {}
        for n, o in zip(pipe.names, pipe.group_ords(g)):
            k = (n, o)
            if k not in cache:
                cache[k] = interval_from_stats(sources[n].stats_of(o))
            env[n] = cache[k]
        out.append(_Analyzer(env).interval(key_expr))
    return out


def _referenced(node: Node) -> List[str]:
    names: List[str] = []
    for r in node.find(TensorRef):
        if r.name not in names:
            names.append(r.name)
    return names
