"""Short-lived HMAC access tokens (paper §III-C/D).

The interaction model: connect → exchange credentials → receive a short-lived
token → present the token on every GET/PUT/COOK.  During cross-domain
scheduling, downstream nodes must present a *flow token* minted by the
scheduler to pull from upstream nodes; flow tokens are scoped to a single
(resource, verb) pair so a leaked token cannot be replayed elsewhere.

Tokens are `payload_b64.hmac_sha256(secret, payload)` — stateless to verify,
so any replica of a server can validate pulls without shared session state.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time

from repro_torch.core.errors import TokenError

__all__ = ["TokenAuthority", "Token"]

_SKEW = 2.0  # seconds of clock skew tolerated


class Token:
    __slots__ = ("raw", "claims")

    def __init__(self, raw: str, claims: dict):
        self.raw = raw
        self.claims = claims

    @property
    def subject(self) -> str:
        return self.claims.get("sub", "")

    def __str__(self) -> str:
        return self.raw


class TokenAuthority:
    """Mints and verifies scoped, expiring tokens."""

    def __init__(self, secret: bytes | None = None, ttl_s: float = 300.0):
        self.secret = secret if secret is not None else os.urandom(32)
        self.ttl_s = float(ttl_s)
        self._revoked: set = set()

    # -- mint ------------------------------------------------------------------
    def mint(
        self,
        subject: str,
        resource: str = "*",
        verbs: tuple = ("GET", "PUT", "COOK"),
        ttl_s: float | None = None,
    ) -> Token:
        now = time.time()
        claims = {
            "sub": subject,
            "res": resource,
            "verbs": sorted(verbs),
            "iat": now,
            "exp": now + (self.ttl_s if ttl_s is None else float(ttl_s)),
            "jti": base64.urlsafe_b64encode(os.urandom(9)).decode(),
        }
        payload = base64.urlsafe_b64encode(
            json.dumps(claims, separators=(",", ":"), sort_keys=True).encode()
        ).decode()
        sig = self._sign(payload)
        return Token(f"{payload}.{sig}", claims)

    def mint_flow_token(self, subtask_id: str, resource: str, ttl_s: float = 120.0) -> Token:
        """Single-purpose pull token for one inter-domain exchange edge."""
        return self.mint(subject=f"flow:{subtask_id}", resource=resource, verbs=("GET",), ttl_s=ttl_s)

    # -- verify -------------------------------------------------------------------
    def verify(self, raw: str | Token, resource: str = "*", verb: str = "GET") -> dict:
        raw = raw.raw if isinstance(raw, Token) else raw
        try:
            payload, sig = raw.rsplit(".", 1)
        except (ValueError, AttributeError):
            raise TokenError("malformed token") from None
        if not hmac.compare_digest(sig, self._sign(payload)):
            raise TokenError("bad token signature")
        try:
            claims = json.loads(base64.urlsafe_b64decode(payload.encode()).decode())
        except Exception:
            raise TokenError("undecodable token payload") from None
        if claims.get("jti") in self._revoked:
            raise TokenError("token revoked")
        if time.time() > float(claims.get("exp", 0)) + _SKEW:
            raise TokenError("token expired")
        if verb not in claims.get("verbs", []):
            raise TokenError(f"token not valid for {verb}")
        scope = claims.get("res", "")
        if scope != "*" and not _resource_match(scope, resource):
            raise TokenError(f"token scoped to {scope!r}, not {resource!r}")
        return claims

    def revoke(self, token: str | Token) -> None:
        raw = token.raw if isinstance(token, Token) else token
        try:
            payload, _ = raw.rsplit(".", 1)
            claims = json.loads(base64.urlsafe_b64decode(payload.encode()).decode())
            self._revoked.add(claims.get("jti"))
        except Exception:  # revoking garbage is a no-op
            pass

    def _sign(self, payload: str) -> str:
        return hmac.new(self.secret, payload.encode(), hashlib.sha256).hexdigest()


def _resource_match(scope: str, resource: str) -> bool:
    """Prefix scoping: a token for /ds matches /ds and /ds/sub/file."""
    scope = scope.rstrip("/")
    resource = resource.rstrip("/")
    return resource == scope or resource.startswith(scope + "/")
