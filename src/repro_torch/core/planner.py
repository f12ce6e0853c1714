"""Cross-domain task planning (paper §III-D).

A logical COOK DAG references sources in several data centers ("domains" =
``host:port`` authorities).  The planner decomposes it into **physical
sub-tasks** such that every operator executes *in-situ* in the domain that
owns its upstream data ("move operators, not data").  Edges that cross a
domain boundary become **exchange** leaves: the downstream fragment pulls the
upstream fragment's result stream with a scheduler-minted flow token.

Assignment rule (greedy in-situ): a node inherits its inputs' domain while
they agree; the first node whose inputs span domains (e.g. a cross-center
``union``) — and anything above it — runs at the *consumer* domain.  This is
exactly the paper's Fig. 3 decomposition.

Exception (v2): a ``join`` whose inputs span domains runs at its **left
(probe) input's domain** rather than the consumer's — only the build side
crosses the network, and an aggregate above the join stays in-situ with the
probe data.  Callers put the larger input on the left.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from repro_torch.core import uri as urimod
from repro_torch.core.dag import Dag, Node
from repro_torch.core.errors import PlanError

__all__ = ["SubTask", "Plan", "plan", "assign_domains", "partition_plan", "CLIENT_DOMAIN"]

CLIENT_DOMAIN = "client"


@dataclass
class SubTask:
    id: str
    domain: str  # "host:port" authority, or CLIENT_DOMAIN
    dag: Dag
    depends_on: list = field(default_factory=list)  # upstream subtask ids

    @property
    def result_resource(self) -> str:
        """Catalog path under which this sub-task's stream is published."""
        return f"/.flow/{self.id}"

    def result_uri(self) -> str:
        host, _, port = self.domain.partition(":")
        return f"dacp://{host}:{port or urimod.DEFAULT_PORT}{self.result_resource}"

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "domain": self.domain,
            "dag": self.dag.to_json(),
            "depends_on": list(self.depends_on),
        }

    @staticmethod
    def from_json(d: dict) -> "SubTask":
        return SubTask(d["id"], d["domain"], Dag.from_json(d["dag"]), list(d.get("depends_on", [])))


@dataclass
class Plan:
    subtasks: list  # dependency order (upstream first); last one is the root
    root_id: str

    @property
    def root(self) -> SubTask:
        return next(s for s in self.subtasks if s.id == self.root_id)

    def by_id(self, sid: str) -> SubTask:
        return next(s for s in self.subtasks if s.id == sid)

    def to_json(self) -> dict:
        return {"root": self.root_id, "subtasks": [s.to_json() for s in self.subtasks]}

    def to_bytes(self) -> bytes:
        return json.dumps(self.to_json(), separators=(",", ":")).encode()

    @staticmethod
    def from_json(d: dict) -> "Plan":
        return Plan([SubTask.from_json(s) for s in d["subtasks"]], d["root"])


def assign_domains(dag: Dag, client_domain: str = CLIENT_DOMAIN, placement=None) -> dict:
    """Node id -> domain, by the greedy in-situ rule.

    ``placement`` is the mesh's load/replica-aware hook: for a merge node
    whose inputs span domains (the spot the greedy rule would hand to the
    consumer), ``placement(candidates)`` may pick any candidate domain —
    the input domains plus the consumer — using what the mesh knows (bytes
    hosted, heartbeat queue depth).  Returning ``None``, or a domain not in
    the candidate list, falls back to the client-named consumer domain, so
    a mesh with no stats degrades to the paper's Fig. 3 behavior exactly.
    """
    domains: dict = {}
    for nid in dag.topological_order():
        n = dag.nodes[nid]
        if n.op in ("source", "exchange"):
            domains[nid] = urimod.parse(n.params["uri"]).authority
        else:
            ins = {domains[i] for i in n.inputs}
            if len(ins) == 1:
                domains[nid] = ins.pop()
            elif n.op == "join":
                # cross-domain join: probe in-situ, ship only the build side
                domains[nid] = domains[n.inputs[0]]
            else:
                chosen = None
                if placement is not None:
                    candidates = sorted(ins | {client_domain})
                    chosen = placement(candidates)
                    if chosen not in candidates:
                        chosen = None  # stale/garbage hint: keep the default
                domains[nid] = chosen if chosen is not None else client_domain
    return domains


def plan(dag: Dag, client_domain: str = CLIENT_DOMAIN, placement=None) -> Plan:
    dag.validate()
    domains = assign_domains(dag, client_domain, placement=placement)
    subtasks: dict = {}
    order: list = []

    def ensure_subtask(producer_id: str) -> SubTask:
        sid = f"st_{producer_id}"
        if sid in subtasks:
            return subtasks[sid]
        frag_nodes, deps = _fragment(producer_id)
        st = SubTask(id=sid, domain=domains[producer_id], dag=Dag(frag_nodes, producer_id), depends_on=deps)
        subtasks[sid] = st
        order.append(st)
        return st

    def _fragment(root_id: str):
        dom = domains[root_id]
        nodes: dict = {}
        deps: list = []

        def walk(nid: str) -> None:
            if nid in nodes:
                return
            node = dag.nodes[nid]
            new_inputs = []
            for i in node.inputs:
                if domains[i] == dom:
                    walk(i)
                    new_inputs.append(i)
                else:
                    up = ensure_subtask(i)  # recurses; upstream registered first
                    if up.id not in deps:
                        deps.append(up.id)
                    ex_id = f"ex__{up.id}__{nid}"
                    nodes[ex_id] = Node(
                        ex_id,
                        "exchange",
                        {"uri": up.result_uri(), "producer": up.id, "token": None},
                        [],
                    )
                    new_inputs.append(ex_id)
            nodes[nid] = Node(node.id, node.op, dict(node.params), new_inputs)

        walk(root_id)
        return nodes, deps

    root = ensure_subtask(dag.output)
    if not order or order[-1].id != root.id:
        raise PlanError("planner produced inconsistent subtask order")
    return Plan(subtasks=order, root_id=root.id)


# ---------------------------------------------------------------------------
# Partition-parallel SUBMIT (mesh tentpole): split one domain's columnar scan
# into K child flows over disjoint part ranges.
# ---------------------------------------------------------------------------
MAX_PARTITIONS = 64  # union arity cap (core.dag.OPS)


def partition_plan(plan: Plan, part_count_fn, k: int) -> Plan:
    """Split eligible sub-task scans into up to ``k`` partition-parallel
    child sub-tasks over disjoint, contiguous part ranges.

    ``part_count_fn(uri) -> int | None`` answers "how many part files does
    this columnar dataset have" from catalog metadata (local walk or a
    federated DESCRIBE) — ``None`` marks the source ineligible (not
    columnar, unknown dataset, unreachable domain).

    Eligibility is deliberately narrow: a sub-task with exactly ONE source
    node, over a columnar dataset with >= 2 parts, not already split.  The
    child dags replicate that source node *exactly* (including any
    optimizer-pushed ``columns``/``predicate``) plus a ``part_range``; the
    parent's source is replaced by an ordered ``union`` of exchange leaves
    marked ``partition: True`` so no rewrite (R9) crosses it.  Because
    columnar batches never span part files and the executor drains union
    branches in strict input order, the merged stream — and everything the
    parent computes from it — is byte-identical to the unsplit plan, while
    the K child flows scan/decode their ranges concurrently.
    """
    if k < 2:
        return plan
    out: list = []
    for st in plan.subtasks:
        out.extend(_partition_subtask(st, part_count_fn, k))
        out.append(st)
    return Plan(subtasks=out, root_id=plan.root_id)


def _partition_subtask(st: SubTask, part_count_fn, k: int) -> list:
    sources = [n for n in st.dag.nodes.values() if n.op == "source"]
    if len(sources) != 1:
        return []
    src = sources[0]
    if "part_range" in src.params:  # already a partition child: never re-split
        return []
    try:
        n_parts = part_count_fn(src.params["uri"])
    except Exception:  # noqa: BLE001 - eligibility probe must never fail a plan
        return []
    if n_parts is None or n_parts < 2:
        return []
    k_eff = min(int(k), int(n_parts), MAX_PARTITIONS)
    if k_eff < 2:
        return []
    children: list = []
    ex_ids: list = []
    for i in range(k_eff):
        lo = i * n_parts // k_eff
        hi = (i + 1) * n_parts // k_eff
        if hi <= lo:
            continue
        cid = f"{st.id}_p{i}"
        cnode = Node(src.id, "source", {**dict(src.params), "part_range": [lo, hi]}, [])
        child = SubTask(id=cid, domain=st.domain, dag=Dag({src.id: cnode}, src.id))
        children.append(child)
        ex_id = f"ex__{cid}"
        st.dag.nodes[ex_id] = Node(
            ex_id,
            "exchange",
            {"uri": child.result_uri(), "producer": cid, "token": None},
            [],
        )
        ex_ids.append(ex_id)
    union_id = f"{src.id}__partition"
    st.dag.nodes[union_id] = Node(union_id, "union", {"partition": True}, ex_ids)
    for n in st.dag.nodes.values():
        if n.id != union_id:
            n.inputs = [union_id if i == src.id else i for i in n.inputs]
    if st.dag.output == src.id:
        st.dag.output = union_id
    del st.dag.nodes[src.id]
    st.dag.validate()
    st.depends_on = list(st.depends_on) + [c.id for c in children]
    return children
