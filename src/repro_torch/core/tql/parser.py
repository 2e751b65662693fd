"""TQL recursive-descent parser (§4.3).

Grammar (SQL subset + tensor extensions):

    query      := SELECT items FROM IDENT [VERSION STRING] clause* EOF
    clause     := WHERE expr
                | GROUP BY expr (',' expr)*
                | ORDER BY expr [ASC|DESC]
                | ARRANGE BY expr
                | SAMPLE BY expr [REPLACE (TRUE|FALSE)]
                | LIMIT INT [OFFSET INT]
    items      := '*' | expr [AS IDENT] (',' expr [AS IDENT])*
    expr       := or_expr
    or_expr    := and_expr (OR and_expr)*
    and_expr   := not_expr (AND not_expr)*
    not_expr   := NOT not_expr | cmp_expr
    cmp_expr   := add_expr ((==|!=|>|>=|<|<=|IN) add_expr)?
    add_expr   := mul_expr (('+'|'-') mul_expr)*
    mul_expr   := unary (('*'|'/'|'%') unary)*
    unary      := '-' unary | postfix
    postfix    := primary ('[' subscripts ']')*
    primary    := NUMBER | STRING | TRUE|FALSE|NULL | list | call | tensor | '(' expr ')'
    subscripts := sub (',' sub)* ; sub := expr | [expr]':'[expr][':'[expr]]

Each clause may appear at most once (a duplicate raises
:class:`TQLSyntaxError` instead of silently overwriting the first), and
``LIMIT``/``OFFSET`` operands must be non-negative integers.

GROUP BY is genuine aggregation, not a reorder alias:

* with ``GROUP BY k1, k2, ...`` every SELECT item must be either a
  grouping-key expression (by structure, or by alias naming a key) or a
  bare aggregate call -- ``COUNT()`` (zero arguments), ``SUM(e)``,
  ``MIN(e)``, ``MAX(e)``, ``AVG(e)`` (exactly one argument).  There is no
  HAVING clause, so that key-coverage rule is the whole validation story.
* an ungrouped query whose SELECT items are *all* aggregate calls
  (``SELECT COUNT(), MAX(x) FROM ds``) aggregates the entire result set
  into a single row.
* aggregation queries reject ``ORDER BY`` / ``ARRANGE BY`` / ``SAMPLE
  BY`` (there are no per-row results left to order or sample); ``LIMIT``
  and ``OFFSET`` apply to the aggregated group rows.

Outside aggregation SELECT items, ``SUM``/``MIN``/``MAX``/``MEAN`` keep
their per-row element-reduction meaning from :mod:`.functions` (e.g. in a
WHERE clause, ``SUM(x) > 4`` reduces one sample at a time); ``AVG`` and
zero-argument ``COUNT`` exist only as aggregates.
"""

from __future__ import annotations

from typing import List, Optional

from .ast_nodes import (AGGREGATE_FUNCS, Aggregate, BinOp, Call, Index,
                        ListExpr, Literal, Node, Query, SelectItem, SliceSpec,
                        TensorRef, UnaryOp)
from .lexer import Token, TQLSyntaxError, tokenize


class Parser:
    def __init__(self, text: str) -> None:
        self.tokens = tokenize(text)
        self.i = 0

    # ------------------------------------------------------------- plumbing
    @property
    def cur(self) -> Token:
        return self.tokens[self.i]

    def advance(self) -> Token:
        tok = self.cur
        self.i += 1
        return tok

    def accept(self, kind: str, value: Optional[str] = None) -> Optional[Token]:
        if self.cur.kind == kind and (value is None or self.cur.value == value):
            return self.advance()
        return None

    def expect(self, kind: str, value: Optional[str] = None) -> Token:
        tok = self.accept(kind, value)
        if tok is None:
            raise TQLSyntaxError(
                f"expected {value or kind} at pos {self.cur.pos}, got "
                f"{self.cur.value!r}")
        return tok

    def kw(self, word: str) -> Optional[Token]:
        return self.accept("KEYWORD", word)

    # --------------------------------------------------------------- query
    def parse_query(self) -> Query:
        self.expect("KEYWORD", "SELECT")
        items = self.parse_select_items()
        q = Query(items=items)
        if self.kw("FROM"):
            q.source = self.expect("IDENT").value
            if self.kw("VERSION"):
                q.version = self.expect("STRING").value
        seen: set = set()

        def once(clause: str) -> None:
            if clause in seen:
                raise TQLSyntaxError(f"duplicate {clause} clause")
            seen.add(clause)

        while True:
            if self.kw("WHERE"):
                once("WHERE")
                q.where = self.parse_expr()
            elif self.kw("GROUP"):
                once("GROUP BY")
                self.expect("KEYWORD", "BY")
                q.group_by = [self.parse_expr()]
                while self.accept("OP", ","):
                    q.group_by.append(self.parse_expr())
            elif self.kw("ORDER"):
                once("ORDER BY")
                self.expect("KEYWORD", "BY")
                q.order_by = self.parse_expr()
                if self.kw("DESC"):
                    q.order_desc = True
                else:
                    self.kw("ASC")
            elif self.kw("ARRANGE"):
                once("ARRANGE BY")
                self.expect("KEYWORD", "BY")
                q.arrange_by = self.parse_expr()
            elif self.kw("SAMPLE"):
                once("SAMPLE BY")
                self.expect("KEYWORD", "BY")
                q.sample_by = self.parse_expr()
                if self.kw("REPLACE"):
                    tok = self.expect("KEYWORD")
                    if tok.value not in ("TRUE", "FALSE"):
                        raise TQLSyntaxError("REPLACE expects TRUE or FALSE")
                    q.sample_replace = tok.value == "TRUE"
            elif self.kw("LIMIT"):
                once("LIMIT")
                q.limit = self._int_operand("LIMIT")
                if self.kw("OFFSET"):
                    q.offset = self._int_operand("OFFSET")
            else:
                break
        self.expect("EOF")
        self._resolve_aggregation(q)
        return q

    def _int_operand(self, clause: str) -> int:
        tok = self.expect("NUMBER")
        v = float(tok.value)
        if not v.is_integer():
            raise TQLSyntaxError(
                f"{clause} expects an integer, got {tok.value!r}")
        n = int(v)
        if n < 0:
            raise TQLSyntaxError(f"{clause} must be non-negative, got {n}")
        return n

    # --------------------------------------------------- aggregation shaping
    def _resolve_aggregation(self, q: Query) -> None:
        """Turn aggregate SELECT items into :class:`Aggregate` nodes and
        validate the aggregation query shape (see module docstring)."""

        def as_aggregate(expr: Node) -> Optional[Aggregate]:
            if not (isinstance(expr, Call) and expr.name in AGGREGATE_FUNCS):
                return None
            if expr.name == "COUNT":
                if expr.args:
                    raise TQLSyntaxError(
                        "COUNT() takes no arguments (it counts group rows)")
                return Aggregate("COUNT", None)
            if len(expr.args) != 1:
                raise TQLSyntaxError(
                    f"aggregate {expr.name} takes exactly one argument")
            return Aggregate(expr.name, expr.args[0])

        aggs = [as_aggregate(it.expr) for it in q.items]
        grouped = q.group_by is not None
        # Ungrouped: aggregation semantics only when EVERY item is an
        # aggregate call (so `SELECT SUM(x) ...` aggregates but the legacy
        # per-row `SELECT MEAN(images) / 255.0 ...` is untouched).  COUNT()
        # can only be an aggregate, so a mixed ungrouped select is an error.
        if not grouped:
            if all(a is not None for a in aggs) and aggs:
                for it, a in zip(q.items, aggs):
                    it.expr = a
            elif any(a is not None and a.func == "COUNT" for a in aggs):
                raise TQLSyntaxError(
                    "COUNT() outside GROUP BY requires every SELECT item "
                    "to be an aggregate")
            return

        # GROUP BY present: items are aggregates or grouping keys.
        if q.arrange_by is not None:
            raise TQLSyntaxError("ARRANGE BY cannot be combined with GROUP BY")
        if q.order_by is not None:
            raise TQLSyntaxError("ORDER BY cannot be combined with GROUP BY")
        if q.sample_by is not None:
            raise TQLSyntaxError("SAMPLE BY cannot be combined with GROUP BY")
        keys = q.group_by
        key_reprs = {repr(k) for k in keys}
        key_names = {k.name for k in keys if isinstance(k, TensorRef)}
        for it, a in zip(q.items, aggs):
            if it.is_star:
                raise TQLSyntaxError("SELECT * cannot be used with GROUP BY")
            if a is not None:
                it.expr = a
                continue
            matches_key = (repr(it.expr) in key_reprs
                           or (it.alias is not None and it.alias in key_names)
                           or (isinstance(it.expr, TensorRef)
                               and it.expr.name in key_names))
            if not matches_key:
                raise TQLSyntaxError(
                    "non-aggregated SELECT item must appear in GROUP BY "
                    f"(offending item: {it.alias or repr(it.expr)})")

    def parse_select_items(self) -> List[SelectItem]:
        if self.accept("OP", "*"):
            return [SelectItem(Literal("*"), None)]
        items = [self.parse_select_item()]
        while self.accept("OP", ","):
            items.append(self.parse_select_item())
        return items

    def parse_select_item(self) -> SelectItem:
        expr = self.parse_expr()
        alias = None
        if self.kw("AS"):
            alias = self.expect("IDENT").value
        return SelectItem(expr, alias)

    # ----------------------------------------------------------- expressions
    def parse_expr(self) -> Node:
        return self.parse_or()

    def parse_or(self) -> Node:
        left = self.parse_and()
        while self.kw("OR"):
            left = BinOp("or", left, self.parse_and())
        return left

    def parse_and(self) -> Node:
        left = self.parse_not()
        while self.kw("AND"):
            left = BinOp("and", left, self.parse_not())
        return left

    def parse_not(self) -> Node:
        if self.kw("NOT"):
            return UnaryOp("not", self.parse_not())
        return self.parse_cmp()

    def parse_cmp(self) -> Node:
        left = self.parse_add()
        for op in ("==", "!=", ">=", "<=", ">", "<"):
            if self.accept("OP", op):
                return BinOp(op, left, self.parse_add())
        if self.kw("IN"):
            return BinOp("in", left, self.parse_add())
        return left

    def parse_add(self) -> Node:
        left = self.parse_mul()
        while True:
            if self.accept("OP", "+"):
                left = BinOp("+", left, self.parse_mul())
            elif self.accept("OP", "-"):
                left = BinOp("-", left, self.parse_mul())
            else:
                return left

    def parse_mul(self) -> Node:
        left = self.parse_unary()
        while True:
            if self.accept("OP", "*"):
                left = BinOp("*", left, self.parse_unary())
            elif self.accept("OP", "/"):
                left = BinOp("/", left, self.parse_unary())
            elif self.accept("OP", "%"):
                left = BinOp("%", left, self.parse_unary())
            else:
                return left

    def parse_unary(self) -> Node:
        if self.accept("OP", "-"):
            return UnaryOp("-", self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self) -> Node:
        node = self.parse_primary()
        while self.accept("OP", "["):
            parts = [self.parse_subscript()]
            while self.accept("OP", ","):
                parts.append(self.parse_subscript())
            self.expect("OP", "]")
            node = Index(node, parts)
        return node

    def parse_subscript(self) -> SliceSpec:
        start = stop = step = None
        if self.cur.kind == "OP" and self.cur.value == ":":
            pass
        else:
            start = self.parse_expr()
        if self.accept("OP", ":"):
            if not (self.cur.kind == "OP" and self.cur.value in (":", "]", ",")):
                stop = self.parse_expr()
            if self.accept("OP", ":"):
                if not (self.cur.kind == "OP" and self.cur.value in ("]", ",")):
                    step = self.parse_expr()
            return SliceSpec(start, stop, step, True)
        return SliceSpec(start, None, None, False)

    def parse_primary(self) -> Node:
        tok = self.cur
        if tok.kind == "NUMBER":
            self.advance()
            text = tok.value
            return Literal(float(text) if any(c in text for c in ".eE") else int(text))
        if tok.kind == "STRING":
            self.advance()
            return Literal(tok.value)
        if tok.kind == "KEYWORD" and tok.value in ("TRUE", "FALSE", "NULL"):
            self.advance()
            return Literal({"TRUE": True, "FALSE": False, "NULL": None}[tok.value])
        if self.accept("OP", "("):
            e = self.parse_expr()
            self.expect("OP", ")")
            return e
        if self.accept("OP", "["):
            items = []
            if not (self.cur.kind == "OP" and self.cur.value == "]"):
                items.append(self.parse_expr())
                while self.accept("OP", ","):
                    items.append(self.parse_expr())
            self.expect("OP", "]")
            return ListExpr(items)
        if tok.kind == "IDENT":
            self.advance()
            if self.accept("OP", "("):
                args = []
                if not (self.cur.kind == "OP" and self.cur.value == ")"):
                    args.append(self.parse_expr())
                    while self.accept("OP", ","):
                        args.append(self.parse_expr())
                self.expect("OP", ")")
                return Call(tok.value.upper(), args)
            return TensorRef(tok.value)
        raise TQLSyntaxError(f"unexpected {tok.value!r} at pos {tok.pos}")


def parse(text: str) -> Query:
    return Parser(text).parse_query()


def parse_expression(text: str) -> Node:
    p = Parser(text)
    node = p.parse_expr()
    p.expect("EOF")
    return node
