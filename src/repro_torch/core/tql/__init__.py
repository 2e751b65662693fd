"""Tensor Query Language (§4.3): SQL + NumPy-style tensor ops, compiled to a
computational graph executed on numpy or delegated to XLA via jax."""

from .ast_nodes import Aggregate, Query
from .executor import Executor, execute_query
from .functions import register_function
from .lexer import TQLSyntaxError
from .parser import parse, parse_expression
from .planner import Interval, ScanPlan, interval_from_stats, plan_where

__all__ = ["Aggregate", "Executor", "Interval", "Query", "ScanPlan",
           "TQLSyntaxError", "execute_query", "interval_from_stats", "parse",
           "parse_expression", "plan_where", "register_function"]
