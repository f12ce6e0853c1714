"""Plain numpy reference of a COOK described in data: an optional
``project`` (the projected columns alone, as ``keep=False``), a ``filter``,
a ``group_by`` and its aggregates, over the table's numpy columns.

A query is JSON (a workload's ``query``):

    {"project": {"p": ["col", "pressure"], "tk": ["add", ["col", "temp"], 273.15]},
     "filter": ["gt", ["col", "p"], "$thr"],
     "group_by": ["st"],
     "agg": {"n": ["count"], "lo": ["min", "p"], "m": ["mean", "tk"]}}

An expression is ``["col", name]``, a number, ``"$thr"`` (the request's
threshold) or ``[op, a, b]`` with op one of add, sub, mul, div and the
comparisons gt, ge, lt, le, eq, ne.  The semantics are those DACP states
for a COOK: numpy's arithmetic and comparisons on the columns with the
literal as a Python number; groups in the order their key first appears
among the surviving rows; count and integer sums as int64; min and max in
the column's own type; float sums, and the mean's sum, in float64, where
each morsel's partial sum adds its rows in order from +0.0 and the
partials add in morsel order (what static morsels guarantee: the same
bytes whatever the worker count); the mean that sum over the count.
Imports nothing of the program.
"""

from __future__ import annotations

import operator

import numpy as np

_OPS = {"add": operator.add, "sub": operator.sub, "mul": operator.mul, "div": operator.truediv,
        "gt": operator.gt, "ge": operator.ge, "lt": operator.lt, "le": operator.le, "eq": operator.eq,
        "ne": operator.ne}


def evaluate(expr, cols: dict, thr: float):
    if expr == "$thr":
        return thr
    if isinstance(expr, (int, float)):
        return expr
    if expr[0] == "col":
        return cols[expr[1]]
    return _OPS[expr[0]](evaluate(expr[1], cols, thr), evaluate(expr[2], cols, thr))


def _state(fn: str, dtype, sum_dtype):
    """(accumulator type, identity) of an aggregate over a column of ``dtype``."""
    if fn == "count":
        return np.int64, 0
    if fn in ("sum", "mean"):
        return (np.int64, 0) if fn == "sum" and dtype.kind in "iub" else (sum_dtype, 0.0)
    if dtype.kind in "iub":
        return np.int64, np.iinfo(np.int64).max if fn == "min" else np.iinfo(np.int64).min
    return np.float64, np.inf if fn == "min" else -np.inf


_COMBINE = {"count": np.add, "sum": np.add, "mean": np.add, "min": np.minimum, "max": np.maximum}


def run(query: dict, parts: list, thr: float, morsel_rows: int, sum_dtype=np.float64) -> dict:
    """{column: numpy array} of the reply over ``parts`` (dicts of numpy
    columns, each part cut into morsels of ``morsel_rows``).  ``sum_dtype``
    is the float sums' accumulator (float64 as stated; the control passes
    float32)."""
    keys, aggs = query["group_by"], query["agg"]
    first: dict = {}
    acc: dict = {}
    types: dict = {}
    count = np.zeros(0, np.int64)
    for table in parts:
        rows = len(next(iter(table.values())))
        for start in range(0, rows, morsel_rows):
            m = {k: v[start : start + morsel_rows] for k, v in table.items()}
            if "project" in query:
                m = {k: np.asarray(evaluate(e, m, thr)) for k, e in query["project"].items()}
            if "filter" in query:
                keep = np.asarray(evaluate(query["filter"], m, thr), bool)
                m = {k: v[keep] for k, v in m.items()}
            if len(m[keys[0]]) == 0:
                continue
            gid = _group_ids(first, [m[k] for k in keys])
            ng = len(first)
            count = np.concatenate([count, np.zeros(ng - len(count), np.int64)])
            count += np.bincount(gid, minlength=ng)
            for name, (fn, *column) in aggs.items():
                vals = m[column[0]] if column else None
                types.setdefault(name, None if vals is None else vals.dtype)
                adt, init = _state(fn, types[name], sum_dtype)
                part = np.full(ng, init, adt)
                if fn == "count":
                    part += np.bincount(gid, minlength=ng)
                else:
                    (np.add if fn in ("sum", "mean") else _COMBINE[fn]).at(part, gid, vals.astype(adt))
                cur = acc.get(name, np.zeros(0, adt))
                cur = np.concatenate([cur, np.full(ng - len(cur), init, adt)])
                acc[name] = _COMBINE[fn](cur, part).astype(adt)
    out = {}
    for i, k in enumerate(keys):
        out[k] = np.asarray([t[i] for t in first], dtype=_key_dtype(parts, query, k))
    for name, (fn, *_column) in aggs.items():
        vals = acc.get(name, np.zeros(0))
        if fn == "count":
            out[name] = vals.astype(np.int64)
        elif fn == "mean":
            out[name] = vals.astype(np.float64) / np.maximum(count, 1)
        elif fn == "sum":
            out[name] = vals.astype(np.int64 if types[name].kind in "iub" else np.float64)
        else:
            out[name] = vals.astype(types[name])
    return out


def _group_ids(first: dict, cols: list) -> np.ndarray:
    """Each row's group, interning new key tuples in ``first`` in the order
    they first appear."""
    keys = cols[0] if len(cols) == 1 else np.rec.fromarrays(cols)
    uniq, at, inv = np.unique(keys, return_index=True, return_inverse=True)
    tuples = [tuple(u) if len(cols) > 1 else (u,) for u in uniq.tolist()]
    ids = np.empty(len(uniq), np.int64)
    for j in np.argsort(at, kind="stable").tolist():
        ids[j] = first.setdefault(tuples[j], len(first))
    return ids[inv.reshape(-1)]


def _key_dtype(parts: list, query: dict, key: str):
    probe = {k: v[:1] for k, v in parts[0].items()}
    if "project" in query:
        return np.asarray(evaluate(query["project"][key], probe, 0.0)).dtype
    return probe[key].dtype
