"""COOK task DAGs  G = (V, E)   (paper §III-B).

Vertices are standardized *operators* (Filter, Select, Project, Map, ...);
edges are streaming SDF flows.  A DAG is pure data (JSON) — no executable
payload crosses the wire — which is what makes computation offload to a
remote data center safe and schedulable.

Node operator vocabulary (closed set, versioned):

    source    params: {uri}                      0 inputs
    filter    params: {predicate: Expr}          1 input
    select    params: {columns: [str]}           1 input
    project   params: {exprs: {name: Expr}, keep: bool}  1 input
    map       params: {fn: str, fn_params: {}}   1 input   (registered fn name)
    rebatch   params: {rows: int}                1 input
    limit     params: {n: int}                   1 input
    union     params: {}                         N inputs
    aggregate params: {keys: [str],              1 input
                       aggs: {out: {fn, column}},
                       mode: full|partial|final}
    join      params: {on: [str]}                2 inputs  (inner equi-join;
                                                 left = probe, right = build)
    exchange  params: {uri, token}               0 inputs  (planner-inserted pull edge)

``aggregate`` modes implement distributed partial aggregation: ``full`` is
the user-facing op; the optimizer may split it into per-branch ``partial``
aggregates (emitting decomposed state: sums + counts for mean) combined by
one ``final`` aggregate above the cross-domain merge, so exchanges carry
partial aggregates instead of raw rows.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field

from repro_torch.core.errors import PlanError
from repro_torch.core.expr import Expr

__all__ = ["Node", "Dag", "OPS"]

OPS = {
    "source": (0, 0),
    "filter": (1, 1),
    "select": (1, 1),
    "project": (1, 1),
    "map": (1, 1),
    "rebatch": (1, 1),
    "limit": (1, 1),
    "union": (1, 64),
    "aggregate": (1, 1),
    "join": (2, 2),
    "exchange": (0, 0),
}

_counter = itertools.count()


def _fresh_id(op: str) -> str:
    return f"{op}_{next(_counter)}"


@dataclass
class Node:
    id: str
    op: str
    params: dict = field(default_factory=dict)
    inputs: list = field(default_factory=list)

    def to_json(self) -> dict:
        params = {}
        for k, v in self.params.items():
            if isinstance(v, Expr):
                params[k] = {"$expr": v.to_json()}
            elif isinstance(v, dict) and all(isinstance(x, Expr) for x in v.values()):
                params[k] = {"$exprmap": {n: e.to_json() for n, e in v.items()}}
            else:
                params[k] = v
        return {"id": self.id, "op": self.op, "params": params, "inputs": list(self.inputs)}

    @staticmethod
    def from_json(d: dict) -> "Node":
        params = {}
        for k, v in d.get("params", {}).items():
            if isinstance(v, dict) and "$expr" in v:
                params[k] = Expr.from_json(v["$expr"])
            elif isinstance(v, dict) and "$exprmap" in v:
                params[k] = {n: Expr.from_json(e) for n, e in v["$exprmap"].items()}
            else:
                params[k] = v
        return Node(id=d["id"], op=d["op"], params=params, inputs=list(d.get("inputs", [])))


class Dag:
    """A validated operator DAG with a single output node."""

    def __init__(self, nodes: dict, output: str):
        self.nodes: dict = dict(nodes)
        self.output = output
        self.validate()

    # -- construction helpers ---------------------------------------------------
    @staticmethod
    def build() -> "DagBuilder":
        return DagBuilder()

    def validate(self) -> None:
        if self.output not in self.nodes:
            raise PlanError(f"output node {self.output!r} missing")
        for n in self.nodes.values():
            if n.op not in OPS:
                raise PlanError(f"unknown operator {n.op!r} in node {n.id}")
            lo, hi = OPS[n.op]
            if not (lo <= len(n.inputs) <= hi):
                raise PlanError(f"node {n.id} op {n.op} takes [{lo},{hi}] inputs, got {len(n.inputs)}")
            for i in n.inputs:
                if i not in self.nodes:
                    raise PlanError(f"node {n.id} references missing input {i!r}")
        # acyclicity + reachability
        order = self.topological_order()
        reachable = self._reachable_from_output()
        unreachable = set(self.nodes) - reachable
        if unreachable:
            # prune silently: planner fragments legitimately drop nodes
            for u in unreachable:
                del self.nodes[u]
        assert order is not None

    def topological_order(self) -> list:
        indeg = {i: 0 for i in self.nodes}
        out_edges: dict = {i: [] for i in self.nodes}
        for n in self.nodes.values():
            for i in n.inputs:
                indeg[n.id] += 1
                out_edges[i].append(n.id)
        ready = sorted(i for i, d in indeg.items() if d == 0)
        order = []
        while ready:
            u = ready.pop()
            order.append(u)
            for v in out_edges[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
        if len(order) != len(self.nodes):
            raise PlanError("cycle detected in DAG")
        return order

    def _reachable_from_output(self) -> set:
        seen = set()
        stack = [self.output]
        while stack:
            u = stack.pop()
            if u in seen:
                continue
            seen.add(u)
            stack.extend(self.nodes[u].inputs)
        return seen

    # -- analysis ------------------------------------------------------------------
    def sources(self) -> list:
        return [n for n in self.nodes.values() if n.op in ("source", "exchange")]

    def consumers_of(self, node_id: str) -> list:
        return [n for n in self.nodes.values() if node_id in n.inputs]

    # -- wire -------------------------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "version": 2,  # v2: aggregate/join joined the operator vocabulary
            "output": self.output,
            "nodes": [self.nodes[i].to_json() for i in self.topological_order()],
        }

    def to_bytes(self) -> bytes:
        return json.dumps(self.to_json(), separators=(",", ":")).encode()

    @staticmethod
    def from_json(d: dict) -> "Dag":
        nodes = {nd["id"]: Node.from_json(nd) for nd in d["nodes"]}
        return Dag(nodes, d["output"])

    @staticmethod
    def from_bytes(b: bytes) -> "Dag":
        return Dag.from_json(json.loads(b.decode()))

    def copy(self) -> "Dag":
        return Dag.from_json(self.to_json())


class DagBuilder:
    """Imperative builder used by the client's chainable API."""

    def __init__(self):
        self.nodes: dict = {}

    def add(self, op: str, params: dict | None = None, inputs: list | None = None, id: str | None = None) -> str:
        nid = id or _fresh_id(op)
        self.nodes[nid] = Node(id=nid, op=op, params=params or {}, inputs=list(inputs or []))
        return nid

    def source(self, uri: str) -> str:
        return self.add("source", {"uri": str(uri)})

    def finish(self, output: str) -> Dag:
        return Dag(self.nodes, output)
