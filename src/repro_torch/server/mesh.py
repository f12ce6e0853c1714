"""Federated catalog mesh: peer registry, health, scatter-gather discovery.

DACP's collaboration story (paper §III) is cross-*domain*: discovery and
in-situ computation across scientific data centers.  Before the mesh, the
coordinator only spanned domains a client named explicitly and LIST/DESCRIBE
answered from one server's catalog.  The ``MeshRegistry`` makes faird
servers aware of each other:

  * **peer registry** — a static peer list (``DACP_PEERS``) names the other
    authorities in the mesh; peers are reached through the server's existing
    ``Network`` fabric, so every mesh call rides the same persistent
    multiplexed v2 sessions as scheduler SUBMITs and exchange pulls.
  * **heartbeat** — a background daemon probes each peer with PING every
    ``DACP_MESH_HEARTBEAT`` seconds and keeps per-peer state:
    ``UP`` (last probe succeeded) → ``DEGRADED`` (1..N-1 consecutive
    misses) → ``DOWN`` (``DACP_MESH_DOWN_AFTER`` consecutive misses).
    Probes also record the peer's round-trip time and flow-table queue
    depth, which feeds load-aware placement.
  * **federated LIST / DESCRIBE** — scatter-gather over the peer list with
    a per-peer deadline (``DACP_MESH_TIMEOUT``).  A peer that is down or
    misses the deadline degrades the answer instead of failing it: its
    entries are omitted and its name lands in the response's ``degraded``
    list.  Answers are cached for ``DACP_MESH_CACHE_TTL`` seconds; a local
    PUT invalidates the cache immediately through the catalog's
    invalidation listeners (``Catalog.on_invalidate``), so a federated
    answer never serves pre-write stats after a local write.
  * **placement** (``choose_domain``) — the planner's hook for replica- and
    load-aware fragment placement: among candidate domains for a
    cross-domain merge, prefer the one hosting the most bytes per unit of
    queue depth ("run the partial where the bytes or the idle workers
    are").  With no recorded stats it returns ``None`` and the planner
    falls back to the client-named consumer domain.

Scatter requests carry ``scope="local"`` so a peer answers from its own
catalog only — the recursion guard that keeps a mesh of mutually-peered
servers from fanning out forever.
"""

from __future__ import annotations

import threading
import time

from repro_torch.core.env import env_float, env_int
from repro_torch.core.errors import DacpError

__all__ = ["MeshRegistry", "PEER_UP", "PEER_DEGRADED", "PEER_DOWN"]

PEER_UP = "UP"
PEER_DEGRADED = "DEGRADED"
PEER_DOWN = "DOWN"


class MeshRegistry:
    def __init__(
        self,
        authority: str,
        catalog,
        network_fn,
        peers,
        heartbeat_s: float | None = None,
        timeout_s: float | None = None,
        cache_ttl_s: float | None = None,
        down_after: int | None = None,
        local_load_fn=None,
        clock=time.time,
    ):
        self.authority = authority
        self.catalog = catalog
        # late-bound: the cluster wires ``server.network`` after construction
        self._network_fn = network_fn
        self.peers = [p.strip() for p in peers if p.strip() and p.strip() != authority]
        self.heartbeat_s = env_float("DACP_MESH_HEARTBEAT") if heartbeat_s is None else float(heartbeat_s)
        self.timeout_s = env_float("DACP_MESH_TIMEOUT") if timeout_s is None else float(timeout_s)
        self.cache_ttl_s = env_float("DACP_MESH_CACHE_TTL") if cache_ttl_s is None else float(cache_ttl_s)
        self.down_after = env_int("DACP_MESH_DOWN_AFTER") if down_after is None else int(down_after)
        # local queue depth for placement scoring (the server passes its
        # flow-table's active count); peers report theirs via heartbeat
        self._local_load_fn = local_load_fn
        self._clock = clock
        self._lock = threading.Lock()
        # peer -> {"state", "misses", "last_ok", "rtt_s", "queue_depth", "bytes", "error"}
        self._peer_state: dict = {
            p: {
                "state": PEER_UP,  # optimistic until a probe says otherwise
                "misses": 0,
                "last_ok": None,
                "rtt_s": None,
                "queue_depth": None,
                "bytes": None,
                "error": None,
            }
            for p in self.peers
        }
        self._fed_cache: dict = {}  # ("list", prefix) / ("describe", uri) -> (expires_at, payload)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Start the background heartbeat (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._heartbeat_loop, name=f"mesh-heartbeat-{self.authority}", daemon=True
            )
        self._thread.start()

    def stop(self) -> None:
        with self._lock:
            t, self._thread = self._thread, None
        self._stop.set()
        if t is not None:
            t.join(timeout=self.timeout_s)

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            self.probe_once()

    # ------------------------------------------------------------------ probing
    def probe_once(self) -> dict:
        """One heartbeat round over every peer; returns the state snapshot.
        Tests call this directly for deterministic transitions."""
        network = self._network_fn()
        if network is not None:
            self._scatter({p: (lambda p=p: self._probe_peer(network, p)) for p in self.peers})
        return self.peer_states()

    def _probe_peer(self, network, peer: str):
        t0 = time.perf_counter()
        try:
            info = network.ping(peer, timeout=self.timeout_s)
        except (DacpError, OSError) as e:
            self._record_failure(peer, e)
            return e
        self._record_ok(peer, info, time.perf_counter() - t0)
        return info

    def _record_ok(self, peer: str, info: dict | None, rtt_s: float) -> None:
        with self._lock:
            st = self._peer_state.setdefault(peer, {})
            st.update(state=PEER_UP, misses=0, last_ok=self._clock(), rtt_s=rtt_s, error=None)
            if info is not None:
                flows = info.get("flows") or {}
                try:
                    st["queue_depth"] = int(flows.get("active", 0) or 0)
                except (TypeError, ValueError):
                    pass

    def _record_failure(self, peer: str, err: Exception) -> None:
        with self._lock:
            st = self._peer_state.setdefault(peer, {})
            st["misses"] = int(st.get("misses", 0)) + 1
            st["state"] = PEER_DOWN if st["misses"] >= self.down_after else PEER_DEGRADED
            st["error"] = str(err)

    def peer_states(self) -> dict:
        """Snapshot for the PING surface and federated-answer metadata."""
        with self._lock:
            return {p: dict(st) for p, st in self._peer_state.items()}

    # ------------------------------------------------------------------ scatter
    def _scatter(self, calls: dict) -> dict:
        """Run each zero-arg call on its own thread under a shared deadline.

        Returns whatever completed in time (peer -> result-or-exception); a
        late call keeps running on its daemon thread and still updates peer
        state / caches when it lands — this answer just reports the peer
        degraded instead of waiting for it.
        """
        out: dict = {}
        out_lock = threading.Lock()

        def run(peer, fn):
            try:
                r = fn()
            except Exception as e:  # noqa: BLE001 - degradation, not failure
                r = e
            with out_lock:
                out[peer] = r

        threads = {p: threading.Thread(target=run, args=(p, fn), daemon=True) for p, fn in calls.items()}
        for t in threads.values():
            t.start()
        deadline = time.monotonic() + self.timeout_s
        for t in threads.values():
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        with out_lock:
            return dict(out)

    # ------------------------------------------------------------------ federation
    def federated_list(self, prefix: str | None = None, offset: int = 0, limit: int | None = None) -> dict:
        """Union of the local catalog and every reachable peer's (paged).

        Entries gain an ``authority`` field; unreachable peers land in
        ``degraded`` (partial results, never an exception).  The merged
        entry list is cached for ``cache_ttl_s`` and dropped on local PUT.
        """
        offset = max(0, int(offset))
        key = ("list", prefix)
        now = self._clock()
        with self._lock:
            hit = self._fed_cache.get(key)
        if hit is not None and hit[0] > now:
            entries, degraded = hit[1]
        else:
            entries, degraded = self._gather_entries(prefix)
            with self._lock:
                self._fed_cache[key] = (now + self.cache_ttl_s, (entries, degraded))
        total = len(entries)
        page = entries[offset:] if limit is None else entries[offset : offset + max(0, int(limit))]
        next_offset = offset + len(page)
        return {
            "authority": self.authority,
            "federated": True,
            "entries": [dict(e) for e in page],
            "total": total,
            "offset": offset,
            "next_offset": next_offset if next_offset < total else None,
            "degraded": sorted(degraded),
            "peers": self.peer_states(),
        }

    def _gather_entries(self, prefix: str | None):
        entries = [
            {**e, "authority": self.authority} for e in self.catalog.list_entries(prefix=prefix)["entries"]
        ]
        network = self._network_fn()
        if network is None:
            return sorted(entries, key=_entry_key), list(self.peers)
        results = self._scatter(
            {p: (lambda p=p: self._fetch_peer_list(network, p, prefix)) for p in self.peers}
        )
        degraded = []
        for peer in self.peers:
            page = results.get(peer)
            if isinstance(page, dict):
                entries.extend({**e, "authority": peer} for e in page.get("entries", []))
            else:  # exception, or absent = missed the deadline
                degraded.append(peer)
        entries.sort(key=_entry_key)
        return entries, degraded

    def _fetch_peer_list(self, network, peer: str, prefix: str | None) -> dict:
        t0 = time.perf_counter()
        try:
            page = network.client_for(peer).list(prefix=prefix, scope="local")
        except (DacpError, OSError) as e:
            self._record_failure(peer, e)
            raise
        self._record_ok(peer, None, time.perf_counter() - t0)
        if prefix is None:
            # total catalog bytes hosted at the peer — placement's signal
            # for "where the bytes are"
            total = sum(int(e.get("bytes", 0) or 0) for e in page.get("entries", []))
            with self._lock:
                self._peer_state.setdefault(peer, {})["bytes"] = total
        return page

    def federated_describe(self, uri_str: str, peer: str) -> dict:
        """DESCRIBE forwarded to the peer that owns the URI, TTL-cached.
        Raises ``DacpError`` when the peer is unreachable — unlike LIST, a
        single-URI answer cannot be partial."""
        key = ("describe", uri_str)
        now = self._clock()
        with self._lock:
            hit = self._fed_cache.get(key)
        if hit is not None and hit[0] > now:
            return dict(hit[1])
        network = self._network_fn()
        if network is None:
            raise DacpError(f"no network fabric to reach {peer} for DESCRIBE")
        results = self._scatter({peer: (lambda: self._fetch_peer_describe(network, peer, uri_str))})
        r = results.get(peer)
        if not isinstance(r, dict):
            detail = f": {r}" if r is not None else " (timed out)"
            raise DacpError(f"peer {peer} unavailable for DESCRIBE {uri_str}{detail}")
        with self._lock:
            self._fed_cache[key] = (now + self.cache_ttl_s, r)
        return dict(r)

    def _fetch_peer_describe(self, network, peer: str, uri_str: str) -> dict:
        t0 = time.perf_counter()
        try:
            d = network.client_for(peer).describe(uri_str, scope="local")
        except (DacpError, OSError) as e:
            self._record_failure(peer, e)
            raise
        self._record_ok(peer, None, time.perf_counter() - t0)
        return d

    def invalidate_local(self, _dataset: str | None = None) -> None:
        """Catalog-invalidation listener: a local PUT changed stats that are
        baked into cached federated answers, so drop them all — the next
        LIST/DESCRIBE re-gathers instead of serving pre-write numbers."""
        with self._lock:
            self._fed_cache.clear()

    # ------------------------------------------------------------------ placement
    def choose_domain(self, candidates) -> str | None:
        """Pick where a cross-domain merge fragment should run.

        Score = bytes hosted / (1 + queue depth): prefer the domain holding
        the most data per unit of load.  Peer bytes come from the most
        recent federated LIST, queue depth from heartbeat PINGs; the local
        authority is scored from its own catalog and flow table.  ``None``
        (no candidate has recorded stats, or a candidate is DOWN-only)
        defers to the planner's default — the client-named domain.
        """
        best, best_score = None, 0.0
        for d in candidates:
            info = self._domain_info(d)
            if info is None:
                continue
            bytes_hosted, depth = info
            score = float(bytes_hosted) / (1.0 + max(0, depth))
            if score > best_score:
                best, best_score = d, score
        return best

    def _domain_info(self, domain: str):
        if domain == self.authority:
            total = 0
            for name in self.catalog.names():
                try:
                    total += int(self.catalog.dataset_stats(self.catalog.get(name)).get("bytes", 0))
                except OSError:  # racing deletes: skip, don't fail placement
                    continue
            depth = 0
            if self._local_load_fn is not None:
                try:
                    depth = int(self._local_load_fn())
                except Exception:  # noqa: BLE001 - placement is advisory
                    depth = 0
            return (total, depth)
        with self._lock:
            st = self._peer_state.get(domain)
            if st is None or st.get("state") == PEER_DOWN or st.get("bytes") is None:
                return None
            return (int(st["bytes"]), int(st.get("queue_depth") or 0))


def _entry_key(e: dict):
    return (e.get("authority", ""), e.get("name", ""))
