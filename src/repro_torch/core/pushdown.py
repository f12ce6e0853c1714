"""Predicate / projection pushdown (paper §III-B: GET supports predicate
pushdown "circumventing the movement of massive datasets across the network").

Rewrite rules applied to a COOK DAG before scheduling:

  R1 filter∘filter          → filter(p ∧ q)                (merge)
  R2 filter∘select          → select∘filter                (if pred cols ⊆ selected)
  R3 filter∘map             → map∘filter                   (if pred cols ∩ map.writes = ∅)
  R4 filter∘rebatch         → rebatch∘filter               (always legal; filter earlier)
  R5 filter∘union           → union(filter, filter, ...)   (distribute)
  R6 column pruning         → source gains params["columns"] = required set
  R7 filter∘source          → source gains params["predicate"] (scan-level pushdown)
  R8 limit∘select/map/rebatch → pushed below when row-count-preserving
  R9 aggregate(full)∘union  → aggregate(final)∘union(aggregate(partial), ...)
     — distributed partial aggregation: after planning, the partials sit
     in-situ with their sources, so cross-domain exchanges carry partial
     aggregates (≤ one row per group per branch) instead of raw rows
  R10 filter∘aggregate      → aggregate∘filter             (if pred cols ⊆ group keys)
  R11 projection pruning through join/aggregate — required_columns knows
     which input columns a join (keys + consumer needs) and an aggregate
     (keys + agg sources) actually read; sources treat the pruned set as
     advisory (scan keeps the intersection with its real schema)

The rewrites are purely structural (Exprs are data), so the *same* optimizer
runs on the client before COOK submission and on the server before execution.
"""

from __future__ import annotations

from repro_torch.core.dag import Dag, Node
from repro_torch.core.expr import Expr
from repro_torch.core.operators import get_map

__all__ = ["optimize", "required_columns"]

_ROWCOUNT_PRESERVING = {"select", "project", "map", "rebatch"}


def optimize(dag: Dag, max_passes: int = 12) -> Dag:
    dag = dag.copy()
    for _ in range(max_passes):
        changed = False
        changed |= _merge_adjacent_filters(dag)
        changed |= _push_filters_down(dag)
        changed |= _split_aggregate_below_union(dag)
        changed |= _sink_into_sources(dag)
        if not changed:
            break
    _prune_columns(dag)
    dag.validate()
    return dag


# ---------------------------------------------------------------------------
def _single_consumer(dag: Dag, nid: str) -> bool:
    return len(dag.consumers_of(nid)) == 1 and nid != dag.output


def _rewire(dag: Dag, old_top: str, new_top: str) -> None:
    """Point every consumer of old_top at new_top (and the output)."""
    for n in dag.nodes.values():
        n.inputs = [new_top if i == old_top else i for i in n.inputs]
    if dag.output == old_top:
        dag.output = new_top


def _merge_adjacent_filters(dag: Dag) -> bool:
    changed = False
    for n in list(dag.nodes.values()):
        if n.op != "filter" or n.id not in dag.nodes:
            continue
        (child_id,) = n.inputs
        child = dag.nodes[child_id]
        if child.op == "filter" and _single_consumer(dag, child_id):
            n.params["predicate"] = child.params["predicate"] & n.params["predicate"]
            n.inputs = list(child.inputs)
            del dag.nodes[child_id]
            changed = True
    return changed


def _push_filters_down(dag: Dag) -> bool:
    changed = False
    for n in list(dag.nodes.values()):
        if n.id not in dag.nodes or n.op != "filter":
            continue
        (child_id,) = n.inputs
        child = dag.nodes.get(child_id)
        if child is None or not _single_consumer(dag, child_id):
            continue
        pred: Expr = n.params["predicate"]
        cols = pred.referenced_columns()
        swap = False
        if child.op == "select" and cols <= set(child.params["columns"]):
            swap = True
        elif child.op == "project":
            introduced = set(child.params["exprs"].keys())
            if child.params.get("keep", True) and not (cols & introduced):
                swap = True
        elif child.op == "map":
            mf = get_map(child.params["fn"])
            if not (cols & set(mf.writes)):
                swap = True
        elif child.op == "rebatch":
            swap = True
        elif child.op == "aggregate":
            # R10: a filter on the group keys commutes with the aggregation
            if cols <= set(child.params["keys"]):
                swap = True
        elif child.op == "union":
            # distribute: union(filter(a), filter(b), ...)
            new_ids = []
            for i, inp in enumerate(child.inputs):
                fid = f"{n.id}_u{i}"
                dag.nodes[fid] = Node(fid, "filter", {"predicate": pred}, [inp])
                new_ids.append(fid)
            child.inputs = new_ids
            _rewire(dag, n.id, child.id)
            del dag.nodes[n.id]
            changed = True
            continue
        if swap:
            # filter(child(x)) -> child(filter(x))
            grand = list(child.inputs)
            n.inputs = grand
            child.inputs = [n.id]
            _rewire(dag, n.id, child.id)
            # undo the self-loop introduced by rewire on child
            child.inputs = [n.id]
            changed = True
    return changed


def _split_aggregate_below_union(dag: Dag) -> bool:
    """R9: distributed partial aggregation.

    ``aggregate(full)`` directly above a ``union`` splits into per-branch
    ``partial`` aggregates combined by one ``final`` aggregate above the
    union.  The planner then places each partial in-situ with its branch's
    sources, so a cross-domain exchange ships at most one row per group per
    branch instead of the branch's raw rows.
    """
    changed = False
    for n in list(dag.nodes.values()):
        if n.id not in dag.nodes or n.op != "aggregate" or n.params.get("mode", "full") != "full":
            continue
        (child_id,) = n.inputs
        child = dag.nodes.get(child_id)
        if child is None or child.op != "union" or not _single_consumer(dag, child_id):
            continue
        if child.params.get("partition"):
            # a partition-parallel reassembly union: its branches are
            # disjoint part ranges of ONE scan, ordered so the merged stream
            # is byte-identical to the unsplit plan.  Splitting the
            # aggregate here would change the float fold order vs the
            # single-flow plan, breaking that guarantee for zero shipping
            # benefit (the branches are same-domain exchanges).
            continue
        keys = list(n.params["keys"])
        aggs = n.params["aggs"]
        new_inputs = []
        for i, inp in enumerate(child.inputs):
            pid = f"{n.id}_p{i}"
            dag.nodes[pid] = Node(
                pid,
                "aggregate",
                {"keys": list(keys), "aggs": {k: dict(v) for k, v in aggs.items()}, "mode": "partial"},
                [inp],
            )
            new_inputs.append(pid)
        child.inputs = new_inputs
        n.params["mode"] = "final"
        changed = True
    return changed


def _sink_into_sources(dag: Dag) -> bool:
    """R7: a filter directly above a source becomes the source's scan predicate."""
    changed = False
    for n in list(dag.nodes.values()):
        if n.id not in dag.nodes or n.op != "filter":
            continue
        (child_id,) = n.inputs
        child = dag.nodes.get(child_id)
        if child is None or child.op != "source" or not _single_consumer(dag, child_id):
            continue
        pred = n.params["predicate"]
        if "predicate" in child.params:
            child.params["predicate"] = child.params["predicate"] & pred
        else:
            child.params["predicate"] = pred
        _rewire(dag, n.id, child_id)
        del dag.nodes[n.id]
        changed = True
    return changed


# ---------------------------------------------------------------------------
def required_columns(dag: Dag) -> dict:
    """Map node-id -> set of columns required from that node's *output*.

    ``None`` means "all columns" (semantics-opaque consumer).
    """
    req: dict = {nid: set() for nid in dag.nodes}
    opaque: dict = {nid: False for nid in dag.nodes}
    order = dag.topological_order()
    # output consumer needs everything the output produces
    opaque[dag.output] = True
    for nid in reversed(order):
        n = dag.nodes[nid]
        need_all = opaque[nid]
        need = req[nid]
        for inp in n.inputs:
            if n.op == "select":
                for c in n.params["columns"]:
                    req[inp].add(c)
            elif n.op == "filter":
                req[inp] |= n.params["predicate"].referenced_columns()
                req[inp] |= need
                if need_all:
                    opaque[inp] = True
            elif n.op == "project":
                introduced = set(n.params["exprs"].keys())
                for e in n.params["exprs"].values():
                    req[inp] |= e.referenced_columns()
                if n.params.get("keep", True):
                    req[inp] |= need - introduced  # introduced cols don't exist below
                    if need_all:
                        opaque[inp] = True
            elif n.op == "map":
                mf = get_map(n.params["fn"])
                if "*" in mf.reads:
                    opaque[inp] = True
                else:
                    req[inp] |= set(mf.reads)
                    req[inp] |= need - set(mf.writes)
                    if need_all:
                        opaque[inp] = True
            elif n.op == "aggregate":
                # R11: an aggregate reads exactly its keys + agg sources —
                # consumer needs above it never reach the input
                req[inp] |= set(n.params["keys"])
                mode = n.params.get("mode", "full")
                for out, spec in n.params["aggs"].items():
                    if mode == "final":
                        if spec["fn"] == "mean":
                            req[inp] |= {f"{out}__psum", f"{out}__pcnt"}
                        else:
                            req[inp].add(out)
                    elif spec.get("column") is not None:
                        req[inp].add(spec["column"])
            elif n.op == "join":
                # R11: each side needs the join keys plus whatever the
                # consumer needs; the pruned set is advisory at the scan, so
                # naming a column that lives on the other side is harmless.
                req[inp] |= set(n.params["on"])
                req[inp] |= need
                # right-side collisions surface as "<name>_r": map them back
                req[inp] |= {c[:-2] for c in need if c.endswith("_r")}
                if need_all:
                    opaque[inp] = True
            else:  # rebatch/limit/union: passthrough
                req[inp] |= need
                if need_all:
                    opaque[inp] = True
    return {nid: (None if opaque[nid] else req[nid]) for nid in dag.nodes}


def _prune_columns(dag: Dag) -> None:
    """R6: record the required column set on each source for scan pruning."""
    req = required_columns(dag)
    for n in dag.nodes.values():
        if n.op in ("source", "exchange"):
            need = req[n.id]
            if need is not None:
                have = n.params.get("predicate")
                cols = set(need)
                if have is not None:
                    cols |= have.referenced_columns()
                n.params["columns"] = sorted(cols)
