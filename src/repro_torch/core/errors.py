"""DACP protocol error hierarchy.

Errors carry a wire-serializable ``code`` so servers can frame them back to
clients without losing the category (paper §III-C: phased interaction must
surface auth/addressing failures distinctly from execution failures).
"""

from __future__ import annotations


class DacpError(Exception):
    """Base class for every protocol-level error."""

    code = "DACP_ERROR"

    def to_wire(self) -> dict:
        return {"code": self.code, "message": str(self)}

    @staticmethod
    def from_wire(payload: dict) -> "DacpError":
        code = payload.get("code", "DACP_ERROR")
        msg = payload.get("message", "")
        cls = _CODE_TO_CLS.get(code, DacpError)
        return cls(msg)


class SchemaError(DacpError):
    """Schema mismatch / malformed schema."""

    code = "SCHEMA"


class TypeMismatchError(SchemaError):
    code = "TYPE_MISMATCH"


class ResourceNotFound(DacpError):
    """URI did not resolve to a dataset / SDF."""

    code = "NOT_FOUND"


class PermissionDenied(DacpError):
    code = "PERMISSION"


class TokenError(PermissionDenied):
    """Missing / expired / forged access token."""

    code = "TOKEN"


class PlanError(DacpError):
    """Malformed or unschedulable COOK DAG."""

    code = "PLAN"


class TransportError(DacpError):
    """Framing / channel-level failure."""

    code = "TRANSPORT"


class SubTaskFailed(DacpError):
    """A physical sub-task exhausted its retries."""

    code = "SUBTASK"


class FlowCancelled(DacpError):
    """A flow was cancelled (client CANCEL verb or server-side teardown).

    Raised by executor pipelines when their flow's cancel event fires, and
    framed to consumers of a cancelled stream.  Clients must treat it as
    terminal — unlike ``TransportError`` it is never retried/resumed."""

    code = "FLOW_CANCELLED"


_CODE_TO_CLS = {
    c.code: c
    for c in (
        DacpError,
        SchemaError,
        TypeMismatchError,
        ResourceNotFound,
        PermissionDenied,
        TokenError,
        PlanError,
        TransportError,
        SubTaskFailed,
        FlowCancelled,
    )
}
