"""Plan-fingerprint result cache (multi-tenant serving, paper §III-D).

Fleets of agents hammering shared datasets issue the *same* hot COOKs over
and over.  Instead of re-executing, the server canonicalizes every COOK DAG
into a stable **fingerprint** — op tree + literals + the source datasets'
versions — and attaches identical plans to one shared flow:

  * the first START reserves the fingerprint and runs the plan once;
  * concurrent identical STARTs attach to the still-running flow as extra
    consumers (independent FETCH cursors on one buffer);
  * completed cacheable flows are retained up to ``DACP_PLAN_CACHE_BYTES``
    so a later identical COOK replays instantly from the buffer.

**Canonicalization.**  The DAG is optimizer-normalized first, then hashed
bottom-up so node ids and JSON ordering never matter.  Commutative
expression operands (``and``/``or``/``eq``/``ne``/``add``/``mul``) and
``union`` inputs are sorted by their canonical encoding; ``join`` inputs are
order-sensitive (left = probe, right = build) and are preserved.  Literals
are type-tagged (``1`` ≠ ``1.0`` ≠ ``"1"``) so differing literals never
collide.  Advisory ``columns`` on source leaves are excluded — the optimizer
recomputes them from the plan, so they carry no semantic content.

**Invalidation.**  Each source leaf's fingerprint includes its dataset
version (mtime / byte total / file count from catalog stats), so any write
to a source dataset changes the fingerprint and the stale entry simply stops
being reachable — it ages out via LRU/TTL.  Plans reading another domain
(exchange leaves, or sources this server cannot version) are uncacheable.

The cache maps fingerprint → flow id; flow buffers themselves stay owned by
the FlowManager.  Eviction returns victim flow ids for the *caller* to
demote — the cache never calls into the manager (lock-ordering: the cache
lock is a leaf)."""

from __future__ import annotations

import hashlib
import threading
import time

from repro_torch.core.dag import Dag
from repro_torch.core.env import env_bytes, env_float
from repro_torch.core.expr import Expr
from repro_torch.core.pushdown import optimize

__all__ = ["PlanCache", "fingerprint"]

# operand order never changes the result for these expression ops
_COMMUTATIVE = {"and", "or", "eq", "ne", "add", "mul"}

# advisory params the optimizer recomputes from the plan — no semantic content
_ADVISORY_PARAMS = {"source": ("columns",), "exchange": ("columns",)}


def _canon_value(v) -> str:
    """Type-tagged canonical encoding of a literal / param scalar.

    The type tag keeps ``1``, ``1.0``, ``True`` and ``"1"`` distinct — a
    fingerprint collision between them would serve wrong cached results."""
    if isinstance(v, Expr):
        return _canon_expr(v)
    if isinstance(v, bool):
        return f"b:{v}"
    if isinstance(v, int):
        return f"i:{v}"
    if isinstance(v, float):
        return f"f:{v!r}"
    if isinstance(v, str):
        return f"s:{v!r}"
    if isinstance(v, (bytes, bytearray)):
        return f"x:{bytes(v).hex()}"
    if v is None:
        return "n:"
    if isinstance(v, (list, tuple)):
        return "t:(" + ",".join(_canon_value(x) for x in v) + ")"
    if isinstance(v, dict):
        items = sorted((str(k), _canon_value(x)) for k, x in v.items())
        return "d:{" + ",".join(f"{k}={x}" for k, x in items) + "}"
    return f"o:{type(v).__name__}:{v!r}"


def _canon_expr(e: Expr) -> str:
    args = [_canon_value(a) for a in e.args]
    if e.op in _COMMUTATIVE:
        args.sort()
    return f"e:{e.op}(" + ",".join(args) + ")"


def _canon_params(op: str, params: dict) -> str:
    skip = _ADVISORY_PARAMS.get(op, ())
    items = sorted((k, _canon_value(v)) for k, v in params.items() if k not in skip)
    return ",".join(f"{k}={v}" for k, v in items)


def fingerprint(dag: Dag, source_version=None):
    """-> (fp_hex | None, cacheable: bool).

    ``source_version(uri_str) -> dict | None`` supplies each source leaf's
    dataset version (catalog stats); returning ``None`` marks the plan
    uncacheable (unversionable source — remote authority, raw path, flow).
    Exchange leaves are always uncacheable: their payload is another
    domain's transient flow.  ``fp`` is still returned for uncacheable
    plans (``None`` only on canonicalization failure) so callers can log it.
    """
    try:
        dag = optimize(dag.copy())  # canonical form: pushdown + pruned columns
    except Exception:  # noqa: BLE001 - an unoptimizable plan is simply uncached
        return None, False
    cacheable = True
    hashes: dict = {}
    for nid in dag.topological_order():
        n = dag.nodes[nid]
        inputs = [hashes[i] for i in n.inputs]
        if n.op == "union":
            inputs.sort()  # union is commutative; join stays order-sensitive
        extra = ""
        if n.op == "exchange":
            cacheable = False
        elif n.op == "source":
            version = source_version(n.params["uri"]) if source_version is not None else None
            if version is None:
                cacheable = False
            else:
                extra = "|v=" + _canon_value(version)
        payload = f"{n.op}|{_canon_params(n.op, n.params)}{extra}|" + "|".join(inputs)
        hashes[nid] = hashlib.sha256(payload.encode()).hexdigest()
    return hashes[dag.output], cacheable


class _Entry:
    __slots__ = ("flow_id", "created_at", "last_hit", "expires_at", "nbytes", "hits", "committed")

    def __init__(self, flow_id: str, ttl_s: float):
        self.flow_id = flow_id
        self.created_at = time.time()
        self.last_hit = self.created_at
        self.expires_at = self.created_at + ttl_s
        self.nbytes = 0
        self.hits = 0
        self.committed = False  # False while the reserved flow is still running


class PlanCache:
    """fingerprint → flow-id table with a retained-byte budget.

    ``DACP_PLAN_CACHE_BYTES`` bounds the total bytes of completed flows kept
    for replay (0 disables caching entirely); ``DACP_PLAN_CACHE_TTL`` bounds
    how long a completed entry may serve hits.  Running (reserved, not yet
    committed) entries don't count against the byte budget — they exist so
    concurrent identical STARTs collapse onto one execution."""

    def __init__(self, budget_bytes: int | None = None, ttl_s: float | None = None):
        self.budget_bytes = (
            budget_bytes if budget_bytes is not None else env_bytes("DACP_PLAN_CACHE_BYTES")
        )
        self.ttl_s = ttl_s if ttl_s is not None else env_float("DACP_PLAN_CACHE_TTL")
        self._table: dict = {}  # fp -> _Entry
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    @property
    def enabled(self) -> bool:
        return self.budget_bytes > 0

    # ------------------------------------------------------------------ lookup/reserve
    def lookup_or_reserve(self, fp: str, new_flow_id: str):
        """Atomically: return the live entry's flow id (hit), or reserve
        ``new_flow_id`` under ``fp`` and return None (miss — caller starts
        the flow).  Ghost entries (flow reaped server-side) are the caller's
        to detect; ``invalidate`` then clears the way for a re-reserve."""
        now = time.time()
        with self._lock:
            e = self._table.get(fp)
            if e is not None and e.committed and e.expires_at < now:
                del self._table[fp]
                e = None
            if e is not None:
                e.hits += 1
                e.last_hit = now
                self.hits += 1
                return e.flow_id
            self._table[fp] = _Entry(new_flow_id, self.ttl_s)
            self.misses += 1
            return None

    def commit(self, fp: str, flow_id: str, nbytes: int) -> list:
        """A reserved flow completed with ``nbytes`` of retained results.
        Accounts it against the budget; returns victim flow ids (LRU order,
        oldest hit first) the caller must demote.  An entry larger than the
        whole budget is its own victim — never cached."""
        with self._lock:
            e = self._table.get(fp)
            if e is None or e.flow_id != flow_id:
                return [flow_id]  # superseded (invalidated mid-run): don't retain
            e.nbytes = int(nbytes)
            e.committed = True
            e.expires_at = time.time() + self.ttl_s
            if e.nbytes > self.budget_bytes:
                del self._table[fp]
                self.evictions += 1
                return [flow_id]
            victims = []
            total = sum(x.nbytes for x in self._table.values() if x.committed)
            if total > self.budget_bytes:
                by_age = sorted(
                    ((f, x) for f, x in self._table.items() if x.committed and f != fp),
                    key=lambda kv: kv[1].last_hit,
                )
                for f, x in by_age:
                    if total <= self.budget_bytes:
                        break
                    del self._table[f]
                    total -= x.nbytes
                    victims.append(x.flow_id)
                    self.evictions += 1
            return victims

    def invalidate(self, fp: str, flow_id: str | None = None) -> None:
        """Drop an entry (ghost flow, failed/cancelled run, demotion).  With
        ``flow_id`` given, only drop if the entry still points at it — a
        re-reserved fingerprint must not lose its new flow."""
        with self._lock:
            e = self._table.get(fp)
            if e is not None and (flow_id is None or e.flow_id == flow_id):
                del self._table[fp]
                self.invalidations += 1

    def entries(self) -> dict:
        with self._lock:
            return {fp: e.flow_id for fp, e in self._table.items()}

    def stats(self) -> dict:
        with self._lock:
            committed = [e for e in self._table.values() if e.committed]
            return {
                "entries": len(self._table),
                "retained_bytes": sum(e.nbytes for e in committed),
                "budget_bytes": self.budget_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
            }
