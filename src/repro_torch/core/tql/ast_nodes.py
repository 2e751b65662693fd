"""TQL abstract syntax tree (§4.3)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple, Union


class Node:
    def walk(self):
        yield self
        for f in self.__dataclass_fields__:  # type: ignore[attr-defined]
            v = getattr(self, f)
            for item in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(item, Node):
                    yield from item.walk()

    def find(self, cls):
        """Yield every descendant (including self) of the given node type."""
        for n in self.walk():
            if isinstance(n, cls):
                yield n

    def calls(self, name: str) -> bool:
        """True if any Call node in the subtree invokes ``name`` (upper-cased
        match; used by the scan planner to detect RANDOM() and friends)."""
        return any(c.name.upper() == name.upper() for c in self.find(Call))


@dataclass
class Literal(Node):
    value: Any  # int | float | str | bool | None


@dataclass
class TensorRef(Node):
    name: str


@dataclass
class ListExpr(Node):
    items: List[Node]


@dataclass
class UnaryOp(Node):
    op: str  # '-' | 'not'
    operand: Node


@dataclass
class BinOp(Node):
    op: str  # + - * / % == != > >= < <= and or
    left: Node
    right: Node


@dataclass
class Call(Node):
    name: str
    args: List[Node]


@dataclass
class SliceSpec(Node):
    start: Optional[Node]
    stop: Optional[Node]
    step: Optional[Node]
    is_slice: bool  # False => single-index subscript


@dataclass
class Index(Node):
    base: Node
    parts: List[SliceSpec]


#: aggregate functions recognised in SELECT items (GROUP BY queries and
#: all-aggregate ungrouped selects).  These are *query-level* folds over
#: every element of every row in a group -- distinct from the per-row
#: element reductions of the same name in :mod:`.functions` (``SUM(x)``
#: in a WHERE clause still reduces one sample; ``MEAN`` stays per-row,
#: the aggregate spelling of the arithmetic mean is ``AVG``).
AGGREGATE_FUNCS = ("COUNT", "SUM", "MIN", "MAX", "AVG")


@dataclass
class Aggregate(Node):
    """A resolved aggregate SELECT item: COUNT() / SUM(x) / MIN(x) /
    MAX(x) / AVG(x).  ``arg`` is None only for COUNT."""
    func: str
    arg: Optional[Node] = None


@dataclass
class SelectItem(Node):
    expr: Node           # may be Literal('*') for star
    alias: Optional[str]

    @property
    def is_star(self) -> bool:
        return isinstance(self.expr, Literal) and self.expr.value == "*"


@dataclass
class Query(Node):
    items: List[SelectItem]
    source: str = "dataset"
    version: Optional[str] = None
    where: Optional[Node] = None
    group_by: Optional[List[Node]] = None
    order_by: Optional[Node] = None
    order_desc: bool = False
    arrange_by: Optional[Node] = None
    sample_by: Optional[Node] = None
    sample_replace: bool = True
    limit: Optional[int] = None
    offset: int = 0

    @property
    def is_aggregate(self) -> bool:
        """True when the query runs the aggregation path: it has a GROUP BY
        clause, or every SELECT item is a bare aggregate call (ungrouped
        scalar aggregation, e.g. ``SELECT COUNT(), MAX(x) FROM ds``)."""
        return self.group_by is not None or any(
            isinstance(it.expr, Aggregate) for it in self.items)

    def referenced_tensors(self) -> List[str]:
        names = []
        for n in self.find(TensorRef):
            if n.name not in names:
                names.append(n.name)
        return names
