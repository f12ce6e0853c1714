"""Elastic data-shard assignment via rendezvous (HRW) hashing.

Scientific corpora are file sets served by faird nodes; training hosts each
consume a disjoint shard.  Rendezvous hashing gives:

  * determinism — every host computes the same assignment with no
    coordinator;
  * minimal churn — when a host dies or joins, only the files owned by the
    affected host move (≈ 1/n of the data), which is what makes mid-run
    elasticity cheap;
  * weighting — hosts can advertise capacity weights (stragglers get less).

``plan_recovery`` diffs two assignments and reports exactly which files
must be re-read after a membership change.
"""

from __future__ import annotations

import hashlib

__all__ = ["assign_shards", "owner_of", "plan_recovery"]


def _score(key: str, host: str) -> float:
    h = hashlib.blake2b(f"{key}::{host}".encode(), digest_size=8).digest()
    v = int.from_bytes(h, "big") / float(1 << 64)
    return v


def owner_of(key: str, hosts: list, weights: dict | None = None) -> str:
    """Weighted HRW: draw u~U(0,1) per (key, host); cost = -ln(u)/w is
    Exp(w)-distributed, and the MINIMUM cost wins with P ∝ w."""
    import math

    best, best_cost = None, float("inf")
    for host in hosts:
        w = (weights or {}).get(host, 1.0)
        if w <= 0:
            continue
        cost = -math.log(max(_score(key, host), 1e-12)) / w
        if cost < best_cost:
            best, best_cost = host, cost
    if best is None:
        raise ValueError("no live hosts")
    return best


def assign_shards(files: list, hosts: list, weights: dict | None = None) -> dict:
    """-> {host: [files]} (deterministic, minimal-churn)."""
    out = {h: [] for h in hosts}
    for f in files:
        out[owner_of(f, hosts, weights)].append(f)
    return out


def plan_recovery(files: list, old_hosts: list, new_hosts: list, weights: dict | None = None) -> dict:
    """Files whose owner changed: {file: (old_owner|None, new_owner)}."""
    moved = {}
    for f in files:
        old = owner_of(f, old_hosts, weights) if old_hosts else None
        new = owner_of(f, new_hosts, weights)
        if old != new:
            moved[f] = (old, new)
    return moved
