"""Network fabric: authority -> client factory, with replica registry.

The scheduler and servers resolve peers through a ``Network`` so the same
code runs over in-process channel pairs (tests, co-hosted data plane,
benchmarks without kernel TCP noise) and real TCP sockets.

Clients are cached per authority and each owns a persistent multiplexed v2
session, so every consumer of the fabric (scheduler submits, engine exchange
pulls, user verbs) shares one live channel per peer.  ``close_all`` tears the
sessions down politely (BYE).

Replicas: scientific data centers mirror datasets; ``add_replica`` records
that an authority's data is also served elsewhere.  The scheduler uses this
for fail-over and straggler re-issue.
"""

from __future__ import annotations

import threading

from repro_torch.core.errors import ResourceNotFound
from repro_torch.client.client import DacpClient
from repro_torch.transport.channel import channel_pair, connect_tcp

__all__ = ["Network", "LocalNetwork", "TcpNetwork"]


class Network:
    def __init__(self):
        self._replicas: dict = {}

    def client_for(self, authority: str) -> DacpClient:  # pragma: no cover - interface
        raise NotImplementedError

    def add_replica(self, authority: str, replica_authority: str) -> None:
        self._replicas.setdefault(authority, []).append(replica_authority)

    def replicas_of(self, authority: str) -> list:
        return list(self._replicas.get(authority, []))

    def ping(self, authority: str, timeout: float = 5.0) -> dict:
        return self.client_for(authority).ping(timeout=timeout)

    def close_all(self) -> None:
        """BYE + teardown for every cached client session."""
        for client in list(getattr(self, "_clients", {}).values()):
            try:
                client.close()
            except Exception:  # teardown is best-effort
                pass


class LocalNetwork(Network):
    """In-process cluster: every server is an object; channels are queue pairs."""

    def __init__(self):
        super().__init__()
        self._servers: dict = {}
        self._down: set = set()
        self._clients: dict = {}
        self._lock = threading.Lock()

    def register(self, server) -> None:
        with self._lock:
            self._servers[server.authority] = server
            server.network = self

    def set_down(self, authority: str, down: bool = True) -> None:
        """Fault injection for tests/benchmarks.  Taking a server down also
        severs any cached client's live session (a crash, not a polite BYE)."""
        with self._lock:
            (self._down.add if down else self._down.discard)(authority)
            client = self._clients.pop(authority, None) if down else None
        if client is not None:
            try:
                client.close()
            except Exception:
                pass

    def server(self, authority: str):
        return self._servers[authority]

    def authorities(self) -> list:
        return sorted(self._servers)

    def client_for(self, authority: str) -> DacpClient:
        # construct-under-lock: concurrent callers (scheduler waves) must
        # share ONE client/session per authority, never race-create two
        with self._lock:
            if authority in self._clients and authority not in self._down:
                return self._clients[authority]
            try:
                srv = self._servers[authority]
            except KeyError:
                raise ResourceNotFound(f"no server registered at {authority!r}") from None

            def factory():
                if authority in self._down:
                    raise ResourceNotFound(f"server {authority} is down")
                client_end, server_end = channel_pair()
                t = threading.Thread(target=srv.handle_channel, args=(server_end,), daemon=True)
                t.start()
                return client_end

            client = DacpClient(factory, authority=authority)
            self._clients[authority] = client
            return client


class TcpNetwork(Network):
    """authority strings are real host:port endpoints."""

    def __init__(self, subject: str = "anonymous", credential: str | None = None):
        super().__init__()
        self.subject = subject
        self.credential = credential
        self._clients: dict = {}
        self._lock = threading.Lock()

    def client_for(self, authority: str) -> DacpClient:
        with self._lock:
            if authority in self._clients:
                return self._clients[authority]
            host, _, port = authority.partition(":")

            def factory():
                return connect_tcp(host, int(port))

            client = DacpClient(factory, authority=authority, subject=self.subject, credential=self.credential)
            self._clients[authority] = client
            return client
