"""SDF Engine — the core kernel of faird (paper §IV-B).

Responsibilities:
  * lazy materialization: resolving a URI / registering a DAG does **not**
    read data; physical bytes move only when the output stream is pulled;
  * schema-aware columnar operator execution (delegates to
    ``repro_torch.core.operators`` — Filter/Select/Map/... run vectorized on the
    columnar layout);
  * the **flow table** — now owned by ``repro_torch.server.flows.FlowManager``:
    published sub-task result streams stay token-gated with TTL (the
    reverse-supply rendezvous used by cross-domain plans) and additionally
    carry the full flow lifecycle (states, seq-numbered resumable buffers,
    CANCEL propagation); the engine keeps thin delegating wrappers so the
    pre-flow API (``publish_flow``/``take_flow``/...) is unchanged;
  * pushdown: every DAG is re-optimized server-side before execution (the
    optimizer is pure DAG→DAG, identical on client and server).
"""

from __future__ import annotations

import os
import time

from repro_torch.core.dag import Dag, Node
from repro_torch.core.errors import ResourceNotFound, TokenError
from repro_torch.core.executor import ExecutorConfig, ExecutorStats, execute_parallel
from repro_torch.core.operators import execute
from repro_torch.core.pushdown import optimize
from repro_torch.core.sdf import StreamingDataFrame
from repro_torch.core.tokens import TokenAuthority
from repro_torch.core.uri import parse as parse_uri
from repro_torch.server import datasource
from repro_torch.server.catalog import Catalog
from repro_torch.server.flows import FLOW_TTL_S, FlowManager

__all__ = ["SDFEngine", "FLOW_TTL_S"]


class SDFEngine:
    def __init__(
        self,
        authority: str,
        catalog: Catalog,
        tokens: TokenAuthority,
        remote_pull=None,
        aliases=None,
        executor: ExecutorConfig | None = None,
        flows: FlowManager | None = None,
    ):
        self.authority = authority
        self.aliases = aliases if aliases is not None else {authority}
        self.catalog = catalog
        self.tokens = tokens
        # remote_pull(uri_str, token_raw, columns, predicate) -> SDF; injected
        # by the server so the engine can resolve exchange leaves cross-domain.
        self.remote_pull = remote_pull
        # morsel-executor configuration (worker count, morsel rows, compute
        # backend); num_workers=0 falls back to the reference pull chain.
        self.executor = executor if executor is not None else ExecutorConfig()
        # stats of the most recent parallel COOK (tuned morsel size etc.);
        # entries land as the lazy result stream is consumed
        self.last_executor_stats: ExecutorStats | None = None
        # lifecycle owner of every COOK/SUBMIT flow on this server
        self.flows = flows if flows is not None else FlowManager(authority)

    # -- GET path -----------------------------------------------------------------
    def open_uri(
        self,
        uri_str: str,
        columns=None,
        predicate=None,
        batch_rows: int | None = None,
        strict_columns: bool = True,
        part_range=None,
    ) -> StreamingDataFrame:
        uri = parse_uri(uri_str)
        if uri.segments and uri.segments[0] == ".flow":
            if len(uri.segments) != 2:
                raise ResourceNotFound(f"bad flow uri {uri_str}")
            return self.take_flow(uri.segments[1])
        ds, path = self.catalog.resolve_uri(uri)
        if ds is None:
            return self.catalog.discovery_sdf()
        kwargs = {}
        if batch_rows:
            kwargs["batch_rows"] = int(batch_rows)
        return datasource.scan_path(
            path,
            columns=columns,
            predicate=predicate,
            strict_columns=strict_columns,
            scan_workers=self.executor.scan_workers,
            part_range=part_range,
            **kwargs,
        )

    # -- COOK path -----------------------------------------------------------------
    def execute_dag(self, dag: Dag, stats: ExecutorStats | None = None, cancel=None) -> StreamingDataFrame:
        """Optimize + lazily execute a (fragment) DAG against this domain.

        ``stats`` collects this run's executor observability (flows pass a
        per-flow instance so STATUS reports live progress); ``cancel`` is
        the flow-lifecycle cancellation event threaded into every pipeline
        stage of the parallel executor."""
        dag = optimize(dag)

        def resolver(node: Node) -> StreamingDataFrame:
            if node.op == "source":
                uri = parse_uri(node.params["uri"])
                if uri.authority not in self.aliases:
                    # a mis-planned fragment: pull remotely rather than fail
                    return self._remote(node)
                return self.open_uri(
                    node.params["uri"],
                    columns=node.params.get("columns"),
                    predicate=node.params.get("predicate"),
                    strict_columns=False,  # optimizer-pruned hints, not user input
                    part_range=node.params.get("part_range"),
                )
            if node.op == "exchange":
                return self._remote(node)
            raise ResourceNotFound(f"unresolvable leaf {node.op}")

        if self.executor.num_workers <= 0:
            return execute(dag, resolver)  # reference single-threaded pull chain
        if stats is None:
            stats = ExecutorStats()
        self.last_executor_stats = stats
        return execute_parallel(dag, resolver, self.executor, stats=stats, cancel=cancel)

    def source_version(self, uri_str: str) -> dict | None:
        """Version stamp for a plan-cache fingerprint's source leaf: the
        dataset's catalog stats (file count / byte total / latest mtime —
        os.stat only, no data files opened).  None marks the leaf
        unversionable — remote authority, ``.flow`` pseudo-URIs, unknown
        datasets, the discovery root — which makes the plan uncacheable:
        we must never serve stale results for data we cannot version."""
        try:
            uri = parse_uri(uri_str)
        except Exception:  # noqa: BLE001 - malformed uri: the plan will fail anyway
            return None
        if uri.authority not in self.aliases:
            return None
        if uri.segments and uri.segments[0] == ".flow":
            return None
        try:
            ds, path = self.catalog.resolve_uri(uri)
        except ResourceNotFound:
            return None
        if ds is None:
            return None  # discovery root: contents change with the catalog
        stats = self.catalog.dataset_stats(ds)
        out = {"n_files": stats.get("n_files"), "bytes": stats.get("bytes"), "mtime": stats.get("mtime")}
        try:
            if path and os.path.exists(path):
                from repro_torch.server import adapters

                # per-source adapter stamp: st_mtime_ns catches same-size
                # rewrites that the dataset-level float-seconds mtime misses
                out["source"] = adapters.resolve(path).version()
        except OSError:
            pass
        return out

    def _remote(self, node: Node) -> StreamingDataFrame:
        if self.remote_pull is None:
            raise ResourceNotFound(f"no remote pull configured for {node.params.get('uri')}")
        return self.remote_pull(
            node.params["uri"],
            node.params.get("token"),
            node.params.get("columns"),
            node.params.get("predicate"),
        )

    # -- flow table (delegated to the FlowManager) ---------------------------------
    def publish_flow(self, flow_id: str, factory, ttl_s: float = FLOW_TTL_S, owner: str = "") -> str:
        """Register a lazily-evaluated stream; returns the raw pull token.

        The factory may accept ``stats``/``cancel`` keyword arguments (flow
        lifecycle hooks); plain zero-argument factories (the pre-flow API)
        keep working unchanged."""
        token = self.tokens.mint_flow_token(flow_id, resource=f"/.flow/{flow_id}", ttl_s=ttl_s)
        # decide the calling convention ONCE from the signature — catching
        # TypeError at call time would misread a TypeError raised inside the
        # factory body as a signature mismatch and run the factory twice
        import inspect

        try:
            params = inspect.signature(factory).parameters.values()
            takes_hooks = any(
                p.kind == inspect.Parameter.VAR_KEYWORD or p.name in ("stats", "cancel") for p in params
            )
        except (TypeError, ValueError):
            takes_hooks = False

        def factory_with_hooks(stats=None, cancel=None, _f=factory):
            if takes_hooks:
                return _f(stats=stats, cancel=cancel)
            return _f()

        self.flows.publish(flow_id, factory_with_hooks, token.raw, ttl_s, owner=owner)
        return token.raw

    def take_flow(self, flow_id: str) -> StreamingDataFrame:
        fl = self._published(flow_id)
        return self.flows.take(fl)

    def _published(self, flow_id: str):
        try:
            fl = self.flows.get(flow_id)
        except ResourceNotFound:
            raise ResourceNotFound(f"no published flow {flow_id!r}") from None
        if fl.kind != "submit":
            raise ResourceNotFound(f"no published flow {flow_id!r}")
        return fl

    def verify_flow_token(self, flow_id: str, token_raw: str | None) -> None:
        if token_raw is None:
            raise TokenError(f"flow {flow_id} requires a token")
        claims = self.tokens.verify(token_raw, resource=f"/.flow/{flow_id}", verb="GET")
        # flows are pullable ONLY with the single-purpose token minted at
        # schedule time — a wildcard session token must not read exchanges
        if claims.get("res") == "*":
            raise TokenError(f"flow {flow_id} requires its scoped flow token")

    def drop_flow(self, flow_id: str) -> None:
        self.flows.drop(flow_id)

    def flow_stats(self) -> dict:
        """Per-flow pull/row accounting (exchange-traffic observability).
        Uses the manager's read-only snapshot — monitoring must not refresh
        idle clocks or it would keep abandoned flows alive."""
        return {
            fl.flow_id: {
                "pulls": fl.pulls,
                "rows_out": fl.rows_out + fl.rows_emitted,
                "expires_at": fl.expires_at,
                "state": fl.state,
            }
            for fl in self.flows.records()
            if fl.kind == "submit"
        }

    def executor_stats(self) -> dict:
        """Morsel-executor observability for the most recent parallel COOK:
        per-pipeline morsel counts and the (auto-)tuned morsel size."""
        st = self.last_executor_stats
        return st.to_dict() if st is not None else {"pipelines": []}

    # -- DESCRIBE path ------------------------------------------------------------
    def describe_uri(self, uri_str: str, subject: str | None = None) -> dict:
        """Schema + stats + policy for a URI, answered from catalog metadata.

        ``.flow`` URIs describe the published stream (id, TTL, pull count)
        without activating it; everything else delegates to the catalog's
        metadata-only describe — the data path (``datasource.scan_path``)
        is never invoked.
        """
        uri = parse_uri(uri_str)
        if uri.segments and uri.segments[0] == ".flow":
            if len(uri.segments) != 2:
                raise ResourceNotFound(f"bad flow uri {uri_str}")
            flow = self._published(uri.segments[1])
            flow_id = flow.flow_id
            ttl = max(0.0, flow.expires_at - time.time()) if flow.expires_at else 0.0
            return {
                "uri": uri_str,
                "kind": "flow",
                "dataset": None,
                "path": f".flow/{flow_id}",
                "schema": None,  # activating the factory would move data
                "stats": {
                    "pulls": flow.pulls,
                    "rows_out": flow.rows_out,
                    "ttl_s": ttl,
                    "state": flow.state,
                },
                "policy": {"public": False, "allowed_subjects": [f"flow:{flow_id}"]},
                "metadata": {},
            }
        return self.catalog.describe(uri, subject=subject)

    def flow_ids(self) -> list:
        return [fl.flow_id for fl in self.flows.records() if fl.kind == "submit"]
