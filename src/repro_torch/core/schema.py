"""Schema S = {(attr_1, tau_1), ..., (attr_m, tau_m)}  (paper §III-A eq. 2).

A Schema is an ordered list of named, typed fields.  It travels ahead of the
frame stream (one schema frame, then batch frames) so the receiver can
interpret every batch without side-channel metadata — the paper's fix for
"data and metadata are fragmented in the access path".
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field

from repro_torch.core import dtypes
from repro_torch.core.dtypes import DType
from repro_torch.core.errors import SchemaError

__all__ = ["Field", "Schema"]


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DType
    nullable: bool = False
    metadata: tuple = ()  # tuple of (key, value) pairs; hashable

    def to_json(self) -> dict:
        d = {"name": self.name, "dtype": self.dtype.name, "nullable": self.nullable}
        if self.metadata:
            d["metadata"] = dict(self.metadata)
        return d

    @staticmethod
    def from_json(d: dict) -> "Field":
        return Field(
            name=d["name"],
            dtype=dtypes.resolve(d["dtype"]),
            nullable=bool(d.get("nullable", False)),
            metadata=tuple(sorted((d.get("metadata") or {}).items())),
        )


class Schema:
    """Ordered, uniquely-named, typed field list."""

    __slots__ = ("fields", "_index")

    def __init__(self, fields):
        fields = list(fields)
        norm = []
        for f in fields:
            if isinstance(f, Field):
                norm.append(f)
            elif isinstance(f, tuple) and len(f) >= 2:
                norm.append(Field(f[0], dtypes.resolve(f[1]), *f[2:]))
            else:
                raise SchemaError(f"cannot interpret schema field {f!r}")
        names = [f.name for f in norm]
        if len(set(names)) != len(names):
            dup = sorted({n for n in names if names.count(n) > 1})
            raise SchemaError(f"duplicate column names {dup}")
        self.fields: tuple = tuple(norm)
        self._index = {f.name: i for i, f in enumerate(self.fields)}

    # -- access -------------------------------------------------------------
    @property
    def names(self) -> list:
        return [f.name for f in self.fields]

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def field(self, name: str) -> Field:
        try:
            return self.fields[self._index[name]]
        except KeyError:
            raise SchemaError(f"no column {name!r}; have {self.names}") from None

    def index(self, name: str) -> int:
        try:
            return self._index[name]
        except KeyError:
            raise SchemaError(f"no column {name!r}; have {self.names}") from None

    def dtype(self, name: str) -> DType:
        return self.field(name).dtype

    # -- algebra ------------------------------------------------------------
    def select(self, names) -> "Schema":
        return Schema([self.field(n) for n in names])

    def rename(self, mapping: dict) -> "Schema":
        return Schema(
            [
                Field(mapping.get(f.name, f.name), f.dtype, f.nullable, f.metadata)
                for f in self.fields
            ]
        )

    def append(self, f: Field) -> "Schema":
        return Schema(list(self.fields) + [f])

    def equals(self, other: "Schema", check_metadata: bool = False) -> bool:
        if len(self) != len(other):
            return False
        for a, b in zip(self.fields, other.fields):
            if a.name != b.name or a.dtype != b.dtype or a.nullable != b.nullable:
                return False
            if check_metadata and a.metadata != b.metadata:
                return False
        return True

    def __eq__(self, other) -> bool:
        return isinstance(other, Schema) and self.equals(other)

    def __hash__(self) -> int:
        return hash(self.fields)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        cols = ", ".join(f"{f.name}:{f.dtype.name}" for f in self.fields)
        return f"Schema({cols})"

    # -- wire ---------------------------------------------------------------
    def to_json(self) -> list:
        return [f.to_json() for f in self.fields]

    def to_bytes(self) -> bytes:
        return json.dumps(self.to_json(), separators=(",", ":")).encode()

    @staticmethod
    def from_json(items) -> "Schema":
        return Schema([Field.from_json(d) for d in items])

    @staticmethod
    def from_bytes(b: bytes) -> "Schema":
        return Schema.from_json(json.loads(b.decode()))
