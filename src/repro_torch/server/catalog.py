"""Dataset catalog: logical collections with inherited metadata + policy.

Paper §III-C: a Dataset is "a logical collection unit for SDFs.  It supports
the definition of shared metadata or permission policies at the collection
level, enabling all enclosed SDFs to automatically inherit this contextual
information."

Resolution of ``dacp://host:port/<seg...>``:
  * zero segments            → the discovery SDF (list of datasets)
  * first segment = dataset  → remaining path resolved inside its root
  * ``.flow/<id>``           → a published sub-task stream (scheduler use)

The catalog is also the backing store for the v2 discovery verbs:

  * ``list_entries`` — paged catalog enumeration (LIST).  Pure metadata:
    dataset names, policy visibility, file counts and byte totals from
    ``os.stat`` — data files are never opened.
  * ``describe``     — schema + stats + policy for one URI (DESCRIBE).
    Schemas and per-format stats come from the format adapter registry's
    *bounded* metadata reads — sidecars (``_schema.json``, JSONL block
    indexes), file headers (npy/npz, Parquet footers), container catalogs
    (SQLite ``PRAGMA table_info``), or a capped row/line sample — cached by
    ``(path, mtime, size)`` and never from streaming the data path.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import dtypes
from repro_torch.core.errors import PermissionDenied, ResourceNotFound
from repro_torch.core.schema import Field, Schema
from repro_torch.core.sdf import StreamingDataFrame
from repro_torch.core.uri import DacpUri

__all__ = ["Policy", "Dataset", "Catalog"]


@dataclass(frozen=True)
class Policy:
    public: bool = True
    allowed_subjects: tuple = ()  # token subjects, when not public

    def check(self, subject: str) -> None:
        if self.public:
            return
        if subject in self.allowed_subjects or subject.startswith("flow:"):
            return
        raise PermissionDenied(f"subject {subject!r} not allowed by dataset policy")


@dataclass
class Dataset:
    name: str
    root: str  # filesystem root
    metadata: dict = field(default_factory=dict)
    policy: Policy = field(default_factory=Policy)

    def resolve(self, subpath: str) -> str:
        p = os.path.normpath(os.path.join(self.root, subpath)) if subpath else self.root
        rootp = os.path.normpath(self.root)
        if not (p == rootp or p.startswith(rootp + os.sep)):
            raise PermissionDenied(f"path escape blocked: {subpath!r}")
        return p


STATS_TTL_S = 5.0  # dataset_stats walk cache (LIST hits every entry)


class Catalog:
    def __init__(self):
        self._datasets: dict = {}
        self._lock = threading.Lock()
        self._schema_cache: dict = {}  # path -> (mtime, size, Schema | None)
        self._stats_cache: dict = {}  # root -> (expires_at, stats dict)
        # invalidation fan-out: the mesh layer (and anything else caching
        # derived answers) registers a callback fired after a local write
        # drops the stats cache, so federated answers never outlive a PUT
        self._invalidation_listeners: list = []

    def register(self, ds: Dataset) -> Dataset:
        with self._lock:
            self._datasets[ds.name] = ds
        return ds

    def register_path(self, name: str, root: str, metadata: dict | None = None, policy: Policy | None = None) -> Dataset:
        return self.register(Dataset(name, root, metadata or {}, policy or Policy()))

    def get(self, name: str) -> Dataset:
        try:
            return self._datasets[name]
        except KeyError:
            raise ResourceNotFound(f"no dataset {name!r}") from None

    def names(self) -> list:
        return sorted(self._datasets)

    def resolve_uri(self, uri: DacpUri):
        """-> (dataset | None, fs_path | None).  None dataset = discovery root."""
        if not uri.segments:
            return None, None
        ds = self.get(uri.segments[0])
        return ds, ds.resolve("/".join(uri.segments[1:]))

    # -- discovery SDF (GET on the server root) ---------------------------------
    DISCOVERY_SCHEMA = Schema(
        [
            Field("dataset", dtypes.STRING),
            Field("root", dtypes.STRING),
            Field("n_files", dtypes.INT64),
            Field("bytes", dtypes.INT64),
            Field("metadata", dtypes.STRING),
        ]
    )

    def discovery_sdf(self) -> StreamingDataFrame:
        import json as _json

        names = self.names()

        def stats(ds: Dataset):
            n, total = 0, 0
            for dirpath, _d, files in os.walk(ds.root):
                for fn in files:
                    n += 1
                    try:
                        total += os.path.getsize(os.path.join(dirpath, fn))
                    except OSError:
                        pass
            return n, total

        def gen():
            from repro_torch.core.batch import RecordBatch

            rows = {"dataset": [], "root": [], "n_files": [], "bytes": [], "metadata": []}
            for nm in names:
                ds = self.get(nm)
                n, b = stats(ds)
                rows["dataset"].append(nm)
                rows["root"].append(ds.root)
                rows["n_files"].append(n)
                rows["bytes"].append(b)
                rows["metadata"].append(_json.dumps(ds.metadata, sort_keys=True))
            rows["n_files"] = np.asarray(rows["n_files"], np.int64)
            rows["bytes"] = np.asarray(rows["bytes"], np.int64)
            yield RecordBatch.from_pydict(rows, self.DISCOVERY_SCHEMA)

        return StreamingDataFrame(self.DISCOVERY_SCHEMA, gen)

    # -- discovery verbs (LIST / DESCRIBE) ---------------------------------------
    def dataset_stats(self, ds: Dataset) -> dict:
        """File count + byte total from os.stat — data files are never opened.
        The directory walk is cached for STATS_TTL_S (LIST touches every
        entry; large trees must not be re-walked per page)."""
        import time as _time

        now = _time.time()
        with self._lock:
            hit = self._stats_cache.get(ds.root)
        if hit is not None and hit[0] > now:
            return dict(hit[1])
        n, total, latest = 0, 0, 0.0
        for dirpath, _d, files in os.walk(ds.root):
            for fn in files:
                try:
                    st = os.stat(os.path.join(dirpath, fn))
                except OSError:
                    continue
                n += 1
                total += st.st_size
                latest = max(latest, st.st_mtime)
        stats = {"n_files": n, "bytes": total, "mtime": latest}
        with self._lock:
            self._stats_cache[ds.root] = (now + STATS_TTL_S, stats)
        return dict(stats)

    def on_invalidate(self, listener) -> None:
        """Register ``listener(dataset_name)`` to fire after a local write
        invalidates a dataset's cached stats (mesh caches hook in here)."""
        with self._lock:
            self._invalidation_listeners.append(listener)

    def invalidate_stats(self, ds: Dataset) -> None:
        """Drop the cached walk for a dataset (called after a PUT lands).
        Without this, a write inside the STATS_TTL_S window would leave the
        plan cache fingerprinting — and serving — the pre-write version.
        Listeners (the mesh layer's federated-answer cache) fire after the
        drop, outside the lock — a listener may take its own locks."""
        with self._lock:
            self._stats_cache.pop(ds.root, None)
            listeners = list(self._invalidation_listeners)
        for fn in listeners:
            fn(ds.name)

    def list_entries(self, prefix: str | None = None, offset: int = 0, limit: int | None = None) -> dict:
        """Paged catalog enumeration (the LIST verb's payload).

        Returns every dataset name for findability — non-public datasets are
        listed (with ``public: false``) but DESCRIBE enforces their policy.
        """
        names = [n for n in self.names() if prefix is None or n.startswith(prefix)]
        total = len(names)
        offset = max(0, int(offset))
        page = names[offset:] if limit is None else names[offset : offset + max(0, int(limit))]
        entries = []
        for nm in page:
            ds = self.get(nm)
            entries.append(
                {
                    "name": nm,
                    "public": ds.policy.public,
                    "metadata": dict(ds.metadata),
                    **self.dataset_stats(ds),
                }
            )
        next_offset = offset + len(page)
        return {
            "entries": entries,
            "total": total,
            "offset": offset,
            "next_offset": next_offset if next_offset < total else None,
        }

    def describe(self, uri: DacpUri, subject: str | None = None) -> dict:
        """Schema + stats + policy for a URI, without streaming any data.

        Schemas are resolved from metadata only: sidecar ``_schema.json``
        (columnar datasets), static framing rules (file-list directories),
        or the file's format adapter (bounded header/sidecar/sample reads,
        cached by path + mtime + size) — the data path is never streamed.
        """
        if not uri.segments:
            return {
                "uri": str(uri),
                "kind": "root",
                "datasets": self.names(),
                "schema": self.DISCOVERY_SCHEMA.to_json(),
                "stats": {"n_datasets": len(self.names())},
                "policy": {"public": True, "allowed_subjects": []},
                "metadata": {},
            }
        ds = self.get(uri.segments[0])
        if subject is not None or not ds.policy.public:
            ds.policy.check(subject or "")
        subpath = "/".join(uri.segments[1:])
        path = ds.resolve(subpath)
        if not os.path.exists(path):
            raise ResourceNotFound(f"no such path: {uri}")
        out = {
            "uri": str(uri),
            "kind": "dataset" if not subpath else ("dir" if os.path.isdir(path) else "file"),
            "dataset": ds.name,
            "path": subpath,
            "policy": {"public": ds.policy.public, "allowed_subjects": list(ds.policy.allowed_subjects)},
            "metadata": dict(ds.metadata),
        }
        if os.path.isdir(path):
            stats = self.dataset_stats(Dataset(ds.name, path))
            schema, rows = self._dir_schema(path)
            from repro_torch.server.datasource import part_count

            parts = part_count(path)
            if parts is not None:
                # partition-parallel eligibility: a remote coordinator reads
                # the part count from DESCRIBE instead of walking the tree
                stats["parts"] = parts
        else:
            st = os.stat(path)
            stats = {"n_files": 1, "bytes": st.st_size, "mtime": st.st_mtime}
            schema, fmt_stats = self._sniff_schema(path)
            rows = None
            if fmt_stats:
                # per-format adapter stats (format name, row counts, part /
                # row-group / block counts, cheap column min-max)
                fmt = dict(fmt_stats)
                rows = fmt.pop("rows", None)
                fmt.pop("bytes", None)  # os.stat already reported it
                stats.update(fmt)
        if rows is not None:
            stats["rows"] = rows
        out["stats"] = stats
        out["schema"] = schema.to_json() if schema is not None else None
        return out

    # -- schema sniffing (bounded metadata reads, cached) -----------------------
    _FILELIST_SCHEMA = Schema(
        [
            Field("name", dtypes.STRING),
            Field("path", dtypes.STRING),
            Field("format", dtypes.STRING),
            Field("size", dtypes.INT64),
            Field("mtime", dtypes.FLOAT64),
            Field("content", dtypes.BINARY),
        ]
    )
    def _dir_schema(self, path: str):
        sidecar = os.path.join(path, "_schema.json")
        if os.path.exists(sidecar):
            import json as _json

            with open(sidecar) as f:
                return Schema.from_json(_json.load(f)), None
        # plain directory -> file-list framing (static schema, no file access)
        return self._FILELIST_SCHEMA, None

    def _sniff_schema(self, path: str):
        """(Schema | None, adapter stats | None) from the format adapter's
        *bounded* metadata reads (headers, sidecars, a capped sample — never
        the data path), cached by (path, mtime, size)."""
        try:
            st = os.stat(path)
        except OSError:
            return None, None
        key = (st.st_mtime, st.st_size)
        cached = self._schema_cache.get(path)
        if cached is not None and cached[0] == key:
            return cached[1], cached[2]
        schema, fmt_stats = self._sniff_schema_uncached(path)
        with self._lock:
            self._schema_cache[path] = (key, schema, fmt_stats)
        return schema, fmt_stats

    @staticmethod
    def _sniff_schema_uncached(path: str):
        from repro_torch.server import adapters

        try:
            adapter = adapters.resolve(path)
        except Exception:  # noqa: BLE001 - describe must not fail on odd files
            return None, None
        try:
            schema = adapter.schema()
        except Exception:  # noqa: BLE001 - malformed source: schema unknown
            schema = None
        try:
            fmt_stats = adapter.stats()
        except Exception:  # noqa: BLE001 - stats are best-effort
            fmt_stats = {"format": adapter.format}
        return schema, fmt_stats
