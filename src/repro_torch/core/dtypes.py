"""DACP scientific type system (paper §III-A, eq. 2).

The paper's critique of REST/JSON is that JSON has one ``Number`` type; DACP
schemas must distinguish int8 from uint64 from float16.  We therefore define an
explicit closed set of primitive types, each with a stable wire name, a numpy
dtype for columnar buffers, and a fixed byte width (var-width types use an
offsets+data representation, see ``repro_torch.core.batch``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["DType", "resolve", "from_numpy", "PRIMITIVES", "BINARY", "STRING"]


@dataclass(frozen=True)
class DType:
    """A DACP primitive type.

    name:      stable wire identifier (``"float32"``, ``"binary"``, ...)
    np_dtype:  numpy dtype used for the column buffer (``object`` is never
               used; var-width types store uint8 data + int64 offsets)
    width:     bytes per value for fixed-width types, ``None`` for var-width
    """

    name: str
    np_name: str
    width: int | None

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(self.np_name)

    @property
    def is_varwidth(self) -> bool:
        return self.width is None

    @property
    def is_numeric(self) -> bool:
        return not self.is_varwidth and self.name != "bool"

    @property
    def is_float(self) -> bool:
        return self.name.startswith("float") or self.name == "bfloat16"

    @property
    def is_integer(self) -> bool:
        return self.name.startswith(("int", "uint"))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"dtype<{self.name}>"


def _fixed(name: str, np_name: str | None = None) -> DType:
    np_name = np_name or name
    return DType(name, np_name, np.dtype(np_name).itemsize)


INT8 = _fixed("int8")
INT16 = _fixed("int16")
INT32 = _fixed("int32")
INT64 = _fixed("int64")
UINT8 = _fixed("uint8")
UINT16 = _fixed("uint16")
UINT32 = _fixed("uint32")
UINT64 = _fixed("uint64")
FLOAT16 = _fixed("float16")
FLOAT32 = _fixed("float32")
FLOAT64 = _fixed("float64")
BOOL = _fixed("bool")
# Variable-width binary blob (the File-List-Framing content column) and utf8.
BINARY = DType("binary", "uint8", None)
STRING = DType("string", "uint8", None)

PRIMITIVES: dict[str, DType] = {
    t.name: t
    for t in (
        INT8,
        INT16,
        INT32,
        INT64,
        UINT8,
        UINT16,
        UINT32,
        UINT64,
        FLOAT16,
        FLOAT32,
        FLOAT64,
        BOOL,
        BINARY,
        STRING,
    )
}


def resolve(name: str | DType) -> DType:
    """Resolve a wire name (or pass through a DType) to a DType."""
    if isinstance(name, DType):
        return name
    try:
        return PRIMITIVES[name]
    except KeyError:
        raise KeyError(f"unknown DACP dtype {name!r}; known: {sorted(PRIMITIVES)}") from None


def from_numpy(dt: np.dtype) -> DType:
    """Map a numpy dtype onto the DACP type system."""
    dt = np.dtype(dt)
    if dt.kind in ("S", "U", "O"):
        return STRING
    name = dt.name
    if name not in PRIMITIVES:
        raise KeyError(f"numpy dtype {dt} has no DACP primitive")
    return PRIMITIVES[name]
