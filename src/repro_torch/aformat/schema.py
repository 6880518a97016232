"""Minimal Arrow-like schema/type system.

Types: int32, int64, float32, float64, bool, string.  Columns are numpy
arrays (strings use object/str arrays externally; the file format stores
them Arrow-style as offsets + utf8 bytes).
"""

from __future__ import annotations

import dataclasses

import numpy as np

_TYPES = {
    "int32": np.dtype("<i4"),
    "int64": np.dtype("<i8"),
    "float32": np.dtype("<f4"),
    "float64": np.dtype("<f8"),
    "bool": np.dtype("?"),
    "string": None,  # offsets + utf8 payload
}


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    type: str
    nullable: bool = False

    def __post_init__(self):
        if self.type not in _TYPES:
            raise ValueError(f"unsupported type {self.type!r}")

    @property
    def numpy_dtype(self):
        return _TYPES[self.type]

    def to_json(self):
        return {"name": self.name, "type": self.type,
                "nullable": self.nullable}

    @staticmethod
    def from_json(d):
        return Field(d["name"], d["type"], d.get("nullable", False))


@dataclasses.dataclass(frozen=True)
class Schema:
    fields: tuple[Field, ...]

    def __post_init__(self):
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate field names: {names}")

    def __iter__(self):
        return iter(self.fields)

    def __len__(self):
        return len(self.fields)

    @property
    def names(self):
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def select(self, names) -> "Schema":
        return Schema(tuple(self.field(n) for n in names))

    def to_json(self):
        return {"fields": [f.to_json() for f in self.fields]}

    @staticmethod
    def from_json(d):
        return Schema(tuple(Field.from_json(f) for f in d["fields"]))


def schema(*pairs, nullable=()) -> Schema:
    """schema(("a","int64"), ("b","float32"), ...)."""
    return Schema(tuple(Field(n, t, n in nullable) for n, t in pairs))


def infer_type(arr: np.ndarray) -> str:
    if arr.dtype == np.dtype("?"):
        return "bool"
    if arr.dtype.kind in ("U", "O", "T"):
        return "string"
    for name, dt in _TYPES.items():
        if dt is not None and arr.dtype == dt:
            return name
    if arr.dtype.kind == "i":
        return "int64"
    if arr.dtype.kind == "f":
        return "float64"
    raise TypeError(f"cannot infer arrow type for dtype {arr.dtype}")
