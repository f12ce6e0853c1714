"""Central registry of every ``DACP_*`` environment knob.

Every env-tunable in the tree is declared HERE, once, with its type,
default, and doc string — and read exclusively through the validated
warn-and-fallback accessors below.  Three things hang off the registry:

  * the accessors (``env_int``/``env_bytes``/…): a garbage or
    out-of-range value warns and falls back to the registered default
    instead of raising deep inside engine construction (the PR-3
    env-knob pattern, now in one place);
  * the README "Environment knobs" table is *generated* from it
    (``python -m repro_torch.core.env --markdown``), so docs cannot drift;
  * ``tools/dacpcheck``'s env pass fails CI on any raw
    ``os.environ`` read of a ``DACP_*`` name outside this module, and
    on any registered knob missing from the README table.

Reading an UNREGISTERED name through an accessor raises ``KeyError``
immediately: registration is the API, not a convention.

This module must stay import-light (os/warnings only) and must not
create locks at import time — it is imported by ``core.lockcheck``
before the lock wrappers install.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass

__all__ = [
    "Knob",
    "REGISTRY",
    "env_int",
    "env_bytes",
    "env_float",
    "env_str",
    "env_bool",
    "env_dir",
    "env_devices",
    "env_weights",
    "env_morsel_rows",
    "knob_default",
    "parse_weights",
    "markdown_table",
    "check_table",
]


@dataclass(frozen=True)
class Knob:
    name: str
    kind: str  # int | bytes | float | str | bool | dir | devices | weights | morsel_rows
    default: object  # value, or zero-arg callable evaluated per read
    doc: str
    minimum: int | None = None  # int knobs: values below warn + fall back

    def default_value(self):
        return self.default() if callable(self.default) else self.default

    def forms(self) -> str:
        """Human-readable accepted-forms note for the generated table."""
        return {
            "int": "integer",
            "bytes": "`262144` / `256KB` / `16m` / `1g`",
            "float": "positive number (seconds)",
            "str": "string",
            "bool": "`1`/`true`/`yes`/`on` (else off)",
            "dir": "existing writable directory",
            "devices": "comma-separated device indices (`0,1`)",
            "weights": "`alice=4,bob=1`",
            "morsel_rows": "positive integer or `auto`",
        }[self.kind]


REGISTRY: dict[str, Knob] = {}


def _register(name: str, kind: str, default, doc: str, minimum: int | None = None) -> str:
    assert name not in REGISTRY, name
    REGISTRY[name] = Knob(name, kind, default, doc, minimum)
    return name


# --- executor / kernels ----------------------------------------------------
_register(
    "DACP_EXECUTOR_WORKERS",
    "int",
    lambda: min(4, os.cpu_count() or 1),
    "Morsel worker threads per pipeline stage (default `min(4, cpus)`; "
    "`1` = sequential in-line, `0` = reference pull chain).",
    minimum=0,
)
_register(
    "DACP_MORSEL_ROWS",
    "morsel_rows",
    65536,
    "Rows per morsel, or `auto` for the adaptive latency-model sizer.",
)
_register(
    "DACP_BACKEND",
    "str",
    "auto",
    "Compute backend: `numpy` | `torch` | `auto` (`auto` is `torch`, on the "
    "executor's explicit device: CUDA unless the caller asks for the CPU).",
)
_register(
    "DACP_DEVICES",
    "devices",
    None,
    "CUDA device indices that fused-pipeline stages round-robin staged "
    "uploads across (default: the executor's device). Unused until the "
    "fused chain is ported.",
)
_register(
    "DACP_SCAN_WORKERS",
    "int",
    4,
    "Parallel file readers inside datasource scans.",
    minimum=1,
)
# --- format adapters -------------------------------------------------------
_register(
    "DACP_JSONL_SNIFF_LINES",
    "int",
    256,
    "Lines sampled for JSONL schema inference when no sidecar index "
    "exists (fields are unioned and numeric dtypes widened across the "
    "sample).",
    minimum=1,
)
_register(
    "DACP_JSONL_BLOCK_ROWS",
    "int",
    4096,
    "Rows per block in the JSONL sidecar index — the unit of stats-based "
    "block skipping and of `part_range` splits.",
    minimum=16,
)
_register(
    "DACP_JSONL_INDEX",
    "bool",
    True,
    "Build/use the `_<name>.zdx.json` sidecar line-offset + block-stats "
    "index for JSONL scans (off = plain streaming scan).",
)
_register(
    "DACP_SQLITE_PART_ROWS",
    "int",
    1 << 16,
    "Rows per `part_range` split unit for partition-parallel scans of "
    "SQLite/SDIF containers.",
    minimum=1,
)
# --- memory budget / spill -------------------------------------------------
_register(
    "DACP_MEMORY_BUDGET",
    "bytes",
    0,
    "Byte budget for breaker build states before grace-hash spill "
    "(`0` = unbounded).",
)
_register(
    "DACP_SPILL_DIR",
    "dir",
    None,
    "Directory for spill partition files (default: system temp dir).",
)
# --- flow serving ----------------------------------------------------------
_register(
    "DACP_FLOW_BUFFER",
    "bytes",
    32 << 20,
    "Per-flow result-buffer bound; producers block above it until "
    "consumers ack.",
)
_register(
    "DACP_FLOW_TTL",
    "float",
    60.0,
    "Idle seconds before an unattached flow is reaped.",
)
_register(
    "DACP_FLOW_QUOTA_SLOTS",
    "int",
    0,
    "Total concurrent producer slots across all tenants (`0` = unlimited).",
    minimum=0,
)
_register(
    "DACP_FLOW_QUOTA_CONCURRENCY",
    "int",
    0,
    "Per-tenant concurrent producer cap (`0` = unlimited).",
    minimum=0,
)
_register(
    "DACP_FLOW_QUOTA_BYTES",
    "bytes",
    0,
    "Per-tenant unacked buffered-byte quota (`0` = unlimited).",
)
_register(
    "DACP_FLOW_QUOTA_WEIGHTS",
    "weights",
    None,
    "Stride-scheduler weights per tenant; unlisted tenants get weight 1.",
)
# --- plan cache ------------------------------------------------------------
_register(
    "DACP_PLAN_CACHE_BYTES",
    "bytes",
    64 << 20,
    "Retained result bytes for the plan-fingerprint cache (`0` disables).",
)
_register(
    "DACP_PLAN_CACHE_TTL",
    "float",
    600.0,
    "Seconds a committed cache entry may serve before expiry.",
)
# --- federated catalog mesh ------------------------------------------------
_register(
    "DACP_PEERS",
    "str",
    "",
    "Comma-separated peer authorities (`h2:3101,h3:3101`) forming this "
    "server's catalog mesh; empty disables federation.",
)
_register(
    "DACP_MESH_CACHE_TTL",
    "float",
    10.0,
    "Seconds a federated LIST/DESCRIBE answer may be served from the "
    "mesh cache before peers are re-queried.",
)
_register(
    "DACP_MESH_TIMEOUT",
    "float",
    2.0,
    "Per-peer deadline for mesh scatter-gather and heartbeat probes; a "
    "peer that misses it is reported degraded, not waited for.",
)
_register(
    "DACP_MESH_HEARTBEAT",
    "float",
    5.0,
    "Seconds between background heartbeat probes of mesh peers.",
)
_register(
    "DACP_MESH_DOWN_AFTER",
    "int",
    3,
    "Consecutive failed probes before a peer transitions DEGRADED -> DOWN.",
    minimum=1,
)
_register(
    "DACP_PARTITION_PARALLEL",
    "int",
    0,
    "Split an eligible columnar scan into up to K partition-parallel child "
    "flows over disjoint part ranges (`0`/`1` = off); results stay "
    "byte-identical to the single-flow plan.",
    minimum=0,
)
# --- diagnostics -----------------------------------------------------------
_register(
    "DACP_LOCKCHECK",
    "bool",
    False,
    "Wrap `threading` locks to record the observed lock-acquisition "
    "order (see `tools/dacpcheck`).",
)
_register(
    "DACP_LOCKCHECK_OUT",
    "str",
    "dacpcheck-observed.json",
    "Where the lock-order recorder dumps its observed-edges graph "
    "(unioned into the file if it already exists).",
)


def _knob(name: str, kind: str) -> Knob:
    try:
        k = REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"{name} is not a registered DACP env knob; declare it in repro_torch.core.env"
        ) from None
    if k.kind != kind:
        raise KeyError(f"{name} is registered as kind={k.kind!r}, read as {kind!r}")
    return k


def knob_default(name: str):
    """The registered default (evaluated if callable) — for code that needs
    the fallback value itself, e.g. ``DEFAULT_MORSEL_ROWS``."""
    return REGISTRY[name].default_value()


def env_int(name: str) -> int:
    """Validated integer env read: garbage or below-minimum values warn
    and fall back to the registered default instead of raising."""
    k = _knob(name, "int")
    default = k.default_value()
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        v = int(raw)
    except ValueError:
        warnings.warn(f"{name}={raw!r} is not an integer; using {default}", stacklevel=2)
        return default
    if k.minimum is not None and v < k.minimum:
        warnings.warn(f"{name}={v} is below the minimum {k.minimum}; using {default}", stacklevel=2)
        return default
    return v


_BYTE_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}


def parse_bytes(raw: str) -> int:
    """``262144`` / ``256k`` / ``256KB`` / ``0.5m`` / ``1g`` → bytes.
    Raises ``ValueError`` on garbage or negative values."""
    s = raw.strip().lower()
    if s.endswith("b"):
        s = s[:-1]
    mult = 1
    if s and s[-1] in _BYTE_SUFFIX:
        mult = _BYTE_SUFFIX[s[-1]]
        s = s[:-1]
    v = float(s) if "." in s else int(s)
    if v < 0:
        raise ValueError(f"negative byte size {raw!r}")
    return int(v * mult)


def env_bytes(name: str) -> int:
    """Validated byte-size env read (suffix forms per ``parse_bytes``);
    garbage or negative values warn and fall back."""
    k = _knob(name, "bytes")
    default = k.default_value()
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        return parse_bytes(raw)
    except ValueError:
        warnings.warn(f"{name}={raw!r} is not a byte size; using {default}", stacklevel=2)
        return default


def env_float(name: str) -> float:
    """Validated positive-float env read; non-numbers and values <= 0
    warn/fall back to the registered default."""
    k = _knob(name, "float")
    default = k.default_value()
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        v = float(raw)
    except ValueError:
        warnings.warn(f"{name}={raw!r} is not a number; using {default}", stacklevel=2)
        return default
    return v if v > 0 else default


def env_str(name: str) -> str:
    k = _knob(name, "str")
    raw = os.environ.get(name)
    return k.default_value() if raw is None or raw == "" else raw


_TRUE = {"1", "true", "yes", "on"}


def env_bool(name: str) -> bool:
    k = _knob(name, "bool")
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return bool(k.default_value())
    return raw.strip().lower() in _TRUE


def env_dir(name: str) -> str | None:
    """Validated directory env read: a missing or unwritable directory
    warns at config construction and falls back to the default (None =
    the system temp dir) instead of failing mid-flight."""
    _knob(name, "dir")
    raw = os.environ.get(name)
    if not raw:
        return None
    if not os.path.isdir(raw) or not os.access(raw, os.W_OK):
        warnings.warn(
            f"{name}={raw!r} is not a writable directory; using the system temp dir",
            stacklevel=2,
        )
        return None
    return raw


def env_devices(name: str) -> tuple | None:
    """Validated device-list env read: comma-separated non-negative CUDA
    device indices; garbage warns and falls back to None (default device)."""
    _knob(name, "devices")
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return None
    try:
        vals = tuple(int(p) for p in raw.split(",") if p.strip() != "")
    except ValueError:
        warnings.warn(
            f"{name}={raw!r} is not a comma-separated list of device indices; ignoring",
            stacklevel=2,
        )
        return None
    if not vals or any(v < 0 for v in vals):
        warnings.warn(f"{name}={raw!r} must list non-negative device indices; ignoring", stacklevel=2)
        return None
    return vals


def parse_weights(raw: str | None, knob: str = "DACP_FLOW_QUOTA_WEIGHTS") -> dict:
    """``"alice=4,bob=1"`` → {"alice": 4.0, "bob": 1.0}; malformed entries
    warn and fall back to weight 1 (the env-knob validation pattern)."""
    out: dict = {}
    if not raw or not raw.strip():
        return out
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, val = part.partition("=")
        try:
            if not eq:
                raise ValueError("missing '='")
            w = float(val)
            if w <= 0:
                raise ValueError("weight must be > 0")
        except ValueError as e:
            warnings.warn(
                f"{knob} entry {part!r} is invalid ({e}); using weight 1",
                stacklevel=2,
            )
            continue
        out[name.strip()] = w
    return out


def env_weights(name: str) -> dict:
    _knob(name, "weights")
    return parse_weights(os.environ.get(name), knob=name)


def env_morsel_rows(name: str):
    """``auto`` or a validated positive integer (registered default on
    garbage / non-positive values)."""
    k = _knob(name, "morsel_rows")
    default = k.default_value()
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    if raw.strip().lower() == "auto":
        return "auto"
    try:
        v = int(raw)
    except ValueError:
        warnings.warn(f"{name}={raw!r} is not an integer; using {default}", stacklevel=2)
        return default
    if v < 1:
        warnings.warn(f"{name}={v} is below the minimum 1; using {default}", stacklevel=2)
        return default
    return v


# ---------------------------------------------------------------------------
# README table generation
# ---------------------------------------------------------------------------
def _default_str(k: Knob) -> str:
    if callable(k.default):
        return "`min(4, cpus)`" if k.name == "DACP_EXECUTOR_WORKERS" else "computed"
    d = k.default
    if d is None:
        return "unset"
    if isinstance(d, bool):
        return "`1`" if d else "off"
    if isinstance(d, int) and d >= 1 << 20 and d % (1 << 20) == 0:
        return f"`{d >> 20}MB`"
    return f"`{d}`"


def markdown_table() -> str:
    """The docs "Environment knobs" table, generated from the registry
    (lives between the markers in docs/operations.md)."""
    lines = [
        "| Variable | Default | Accepted forms | Meaning |",
        "|---|---|---|---|",
    ]
    for k in REGISTRY.values():
        doc = k.doc.replace("|", "\\|")
        lines.append(f"| `{k.name}` | {_default_str(k)} | {k.forms()} | {doc} |")
    return "\n".join(lines)


ENV_TABLE_BEGIN = "<!-- env-table:begin -->"
ENV_TABLE_END = "<!-- env-table:end -->"


def check_table(path: str) -> str | None:
    """None when the table between the markers in ``path`` matches the
    registry, else a human-readable reason — the CI docs-staleness gate."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        return f"cannot read {path}: {e}"
    lo = text.find(ENV_TABLE_BEGIN)
    hi = text.find(ENV_TABLE_END)
    if lo < 0 or hi < 0 or hi < lo:
        return f"{path} is missing the {ENV_TABLE_BEGIN} / {ENV_TABLE_END} markers"
    if text[lo + len(ENV_TABLE_BEGIN) : hi].strip() != markdown_table().strip():
        return (
            f"the env-knob table in {path} is stale; regenerate it with "
            "`PYTHONPATH=src python -m repro_torch.core.env` and paste between the markers"
        )
    return None


if __name__ == "__main__":
    import sys

    if len(sys.argv) >= 3 and sys.argv[1] == "--check":
        reason = check_table(sys.argv[2])
        if reason is not None:
            print(reason, file=sys.stderr)
            raise SystemExit(1)
        print(f"{sys.argv[2]}: env-knob table matches the registry")
    else:
        print(markdown_table())
