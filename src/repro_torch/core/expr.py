"""Serializable predicate / projection expressions.

These are the vertices' payloads for Filter/Map operators in a COOK DAG
(paper §III-B).  Expressions are a small closed algebra — column refs,
literals, comparisons, arithmetic, boolean connectives, string ops — so that
a server can (a) evaluate them vectorized over columnar batches and
(b) reason about them for predicate pushdown (referenced_columns).

They are wire-serializable as JSON and never carry executable code: COOK
payloads are *data*, which is what makes cross-domain offload safe.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.batch import Column, RecordBatch
from repro_torch.core.errors import PlanError, TypeMismatchError

__all__ = ["Expr", "col", "lit", "and_", "or_", "not_"]

_CMP = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
}
_ARITH = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "mod": lambda a, b: a % b,
}
_BOOL = {"and": np.logical_and, "or": np.logical_or}


class Expr:
    """Expression node: op + children/args, JSON-serializable."""

    __slots__ = ("op", "args")

    def __init__(self, op: str, args: tuple):
        self.op = op
        self.args = args

    # -- builders (chainable sugar) -----------------------------------------
    def _bin(self, op, other) -> "Expr":
        return Expr(op, (self, _wrap(other)))

    def __eq__(self, o):  # type: ignore[override]
        return self._bin("eq", o)

    def __ne__(self, o):  # type: ignore[override]
        return self._bin("ne", o)

    def __lt__(self, o):
        return self._bin("lt", o)

    def __le__(self, o):
        return self._bin("le", o)

    def __gt__(self, o):
        return self._bin("gt", o)

    def __ge__(self, o):
        return self._bin("ge", o)

    def __add__(self, o):
        return self._bin("add", o)

    def __sub__(self, o):
        return self._bin("sub", o)

    def __mul__(self, o):
        return self._bin("mul", o)

    def __truediv__(self, o):
        return self._bin("div", o)

    def __mod__(self, o):
        return self._bin("mod", o)

    def __and__(self, o):
        return self._bin("and", o)

    def __or__(self, o):
        return self._bin("or", o)

    def __invert__(self):
        return Expr("not", (self,))

    def isin(self, values) -> "Expr":
        return Expr("isin", (self, tuple(values)))

    def contains(self, needle: str) -> "Expr":
        return Expr("contains", (self, needle))

    def startswith(self, prefix: str) -> "Expr":
        return Expr("startswith", (self, prefix))

    def length(self) -> "Expr":
        return Expr("length", (self,))

    def __hash__(self):
        return hash((self.op, str(self.args)))

    # -- analysis -------------------------------------------------------------
    def referenced_columns(self) -> set:
        out = set()
        stack = [self]
        while stack:
            e = stack.pop()
            if not isinstance(e, Expr):
                continue
            if e.op == "col":
                out.add(e.args[0])
            else:
                stack.extend(a for a in e.args if isinstance(a, Expr))
        return out

    # -- evaluation (vectorized over a RecordBatch) ----------------------------
    def evaluate(self, batch: RecordBatch) -> np.ndarray:
        return _eval(self, batch)

    # -- wire -------------------------------------------------------------------
    def to_json(self):
        def enc(a):
            if isinstance(a, Expr):
                return a.to_json()
            if isinstance(a, tuple):
                return {"$tuple": [enc(x) for x in a]}
            if isinstance(a, (bytes, bytearray)):
                return {"$bytes": bytes(a).hex()}
            return a

        return {"$op": self.op, "args": [enc(a) for a in self.args]}

    @staticmethod
    def from_json(d) -> "Expr":
        def dec(a):
            if isinstance(a, dict) and "$op" in a:
                return Expr.from_json(a)
            if isinstance(a, dict) and "$tuple" in a:
                return tuple(dec(x) for x in a["$tuple"])
            if isinstance(a, dict) and "$bytes" in a:
                return bytes.fromhex(a["$bytes"])
            return a

        if not (isinstance(d, dict) and "$op" in d):
            raise PlanError(f"malformed expression payload: {d!r}")
        return Expr(d["$op"], tuple(dec(a) for a in d["args"]))

    def __repr__(self):  # pragma: no cover - cosmetic
        if self.op == "col":
            return f"col({self.args[0]!r})"
        if self.op == "lit":
            return repr(self.args[0])
        return f"{self.op}({', '.join(map(repr, self.args))})"


def col(name: str) -> Expr:
    return Expr("col", (name,))


def lit(v) -> Expr:
    return Expr("lit", (v,))


def and_(*exprs: Expr) -> Expr:
    out = exprs[0]
    for e in exprs[1:]:
        out = out & e
    return out


def or_(*exprs: Expr) -> Expr:
    out = exprs[0]
    for e in exprs[1:]:
        out = out | e
    return out


def not_(e: Expr) -> Expr:
    return ~e


def _wrap(v) -> Expr:
    return v if isinstance(v, Expr) else lit(v)


def _as_comparable(colobj: Column):
    """Var-width columns compare as python object arrays (strings)."""
    if colobj.dtype.is_varwidth:
        return np.asarray(colobj.to_pylist(), dtype=object)
    return colobj.values


def _eval(e: Expr, batch: RecordBatch):
    op = e.op
    if op == "col":
        return _as_comparable(batch.column(e.args[0]))
    if op == "lit":
        return e.args[0]
    if op in _CMP:
        a, b = _eval(e.args[0], batch), _eval(e.args[1], batch)
        return np.asarray(_CMP[op](a, b), dtype=bool)
    if op in _ARITH:
        a, b = _eval(e.args[0], batch), _eval(e.args[1], batch)
        return _ARITH[op](a, b)
    if op in _BOOL:
        a, b = _eval(e.args[0], batch), _eval(e.args[1], batch)
        return _BOOL[op](np.asarray(a, bool), np.asarray(b, bool))
    if op == "not":
        return np.logical_not(np.asarray(_eval(e.args[0], batch), bool))
    if op == "isin":
        a = _eval(e.args[0], batch)
        vals = set(e.args[1])
        return np.asarray([x in vals for x in np.asarray(a).tolist()], dtype=bool)
    if op == "contains":
        a = _eval(e.args[0], batch)
        needle = e.args[1]
        return np.asarray([needle in (x or "") for x in a.tolist()], dtype=bool)
    if op == "startswith":
        a = _eval(e.args[0], batch)
        pre = e.args[1]
        return np.asarray([(x or "").startswith(pre) for x in a.tolist()], dtype=bool)
    if op == "length":
        a = e.args[0]
        if isinstance(a, Expr) and a.op == "col":
            c = batch.column(a.args[0])
            if c.dtype.is_varwidth:
                return (c.offsets[1:] - c.offsets[:-1]).astype(np.int64)
        return np.asarray([len(x) for x in np.asarray(_eval(a, batch)).tolist()], np.int64)
    raise TypeMismatchError(f"unknown expression op {op!r}")
