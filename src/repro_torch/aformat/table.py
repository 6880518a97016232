"""Columnar in-memory table (the Arrow analogue) + IPC wire format.

The IPC wire format is intentionally simple and *uncompressed* (header JSON
+ raw little-endian buffers) — mirroring Apache Arrow's design point that
the paper leans on: scan results travel in a larger-but-zero-decode format,
so pushdown trades network bytes for client CPU (their Fig. 5, 100%
selectivity case).
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from repro_torch.aformat.schema import Field, Schema, infer_type


def _to_string_buffers(arr) -> tuple[np.ndarray, bytes]:
    vals = [("" if v is None else str(v)).encode("utf-8") for v in arr]
    offsets = np.zeros(len(vals) + 1, np.int64)
    np.cumsum([len(v) for v in vals], out=offsets[1:])
    return offsets, b"".join(vals)


def strings_from_buffers(offsets: np.ndarray, payload: bytes,
                         n: int) -> np.ndarray:
    """Arrow-style (byte offsets, UTF-8 payload) -> (n,) object array of
    str.  The payload is decoded *once* and sliced by character offsets —
    equal to the byte offsets for pure-ASCII payloads (the common case),
    otherwise mapped through a vectorized count of UTF-8 continuation
    bytes — instead of one ``bytes.decode`` call per row."""
    out = np.empty(n, object)
    if n == 0:
        return out
    text = payload.decode("utf-8")
    if len(text) == len(payload):          # ASCII: offsets line up 1:1
        char_off = offsets
    else:
        lead = (np.frombuffer(payload, np.uint8) & 0xC0) != 0x80
        cum = np.zeros(len(payload) + 1, np.int64)
        np.cumsum(lead, out=cum[1:])
        char_off = cum[np.asarray(offsets[:n + 1], np.int64)]
    starts = char_off[:n].tolist()
    ends = char_off[1:n + 1].tolist()
    out[:] = [text[s:e] for s, e in zip(starts, ends)]
    return out


def _from_string_buffers(offsets: np.ndarray, payload: bytes) -> np.ndarray:
    return strings_from_buffers(offsets, payload, len(offsets) - 1)


@dataclasses.dataclass
class Column:
    field: Field
    values: np.ndarray                    # object array for strings
    validity: np.ndarray | None = None    # bool mask; None = all valid

    def __post_init__(self):
        if self.field.type == "string":
            if self.values.dtype.kind not in ("O", "U", "T"):
                raise TypeError("string column needs object/str array")
            if self.values.dtype.kind != "O":
                self.values = self.values.astype(object)
        else:
            self.values = np.ascontiguousarray(
                self.values, self.field.numpy_dtype)
        if self.validity is not None:
            self.validity = np.ascontiguousarray(self.validity, "?")
            if self.validity.all():
                self.validity = None

    def __len__(self):
        return len(self.values)

    def take(self, idx) -> "Column":
        v = None if self.validity is None else self.validity[idx]
        return Column(self.field, self.values[idx], v)

    def nbytes(self) -> int:
        if self.field.type == "string":
            return int(sum(len(str(v)) for v in self.values)) + 8 * (
                len(self.values) + 1)
        n = self.values.nbytes
        if self.validity is not None:
            n += self.validity.nbytes
        return n


class Table:
    def __init__(self, schema: Schema, columns: Sequence[Column]):
        if len(schema) != len(columns):
            raise ValueError("schema/column mismatch")
        lens = {len(c) for c in columns}
        if len(lens) > 1:
            raise ValueError(f"ragged columns: {lens}")
        self.schema = schema
        self.columns = list(columns)

    # -- construction --------------------------------------------------------
    @staticmethod
    def from_pydict(data: Mapping[str, Any], schema: Schema | None = None
                    ) -> "Table":
        cols, fields = [], []
        for name, raw in data.items():
            arr = np.asarray(raw)
            if schema is not None:
                f = schema.field(name)
            else:
                f = Field(name, infer_type(arr))
            if f.type != "string":
                arr = arr.astype(f.numpy_dtype)
            cols.append(Column(f, arr))
            fields.append(f)
        sch = schema if schema is not None else Schema(tuple(fields))
        ordered = [cols[[f.name for f in fields].index(f2.name)]
                   for f2 in sch] if schema is not None else cols
        return Table(sch, ordered)

    def to_pydict(self):
        return {f.name: self.column(f.name).values
                for f in self.schema}

    # -- basic ops ------------------------------------------------------------
    def __len__(self):
        return len(self.columns[0]) if self.columns else 0

    @property
    def num_rows(self):
        return len(self)

    def column(self, name: str) -> Column:
        return self.columns[self.schema.index(name)]

    def select(self, names: Iterable[str]) -> "Table":
        names = list(names)
        return Table(self.schema.select(names),
                     [self.column(n) for n in names])

    def filter(self, mask: np.ndarray) -> "Table":
        idx = np.nonzero(np.asarray(mask, "?"))[0]
        return self.take(idx)

    def take(self, idx) -> "Table":
        return Table(self.schema, [c.take(idx) for c in self.columns])

    def slice(self, start: int, length: int) -> "Table":
        idx = slice(start, start + length)
        return Table(self.schema, [Column(c.field, c.values[idx],
                                          None if c.validity is None
                                          else c.validity[idx])
                                   for c in self.columns])

    def head(self, n: int) -> "Table":
        """The first min(n, len) rows — the LIMIT row-budget slice; a
        no-op (self) when the table is already within budget."""
        if len(self) <= n:
            return self
        return self.slice(0, n)

    def nbytes(self) -> int:
        return sum(c.nbytes() for c in self.columns)

    @staticmethod
    def concat(tables: Sequence["Table"]) -> "Table":
        if not tables:
            raise ValueError("concat of zero tables")
        sch = tables[0].schema
        cols = []
        for i, f in enumerate(sch):
            vals = np.concatenate([t.columns[i].values for t in tables])
            vs = [t.columns[i].validity for t in tables]
            if any(v is not None for v in vs):
                validity = np.concatenate(
                    [np.ones(len(t.columns[i]), "?") if v is None else v
                     for t, v in zip(tables, vs)])
            else:
                validity = None
            cols.append(Column(f, vals, validity))
        return Table(sch, cols)

    def equals(self, other: "Table") -> bool:
        if self.schema != other.schema or len(self) != len(other):
            return False
        for a, b in zip(self.columns, other.columns):
            va = np.ones(len(a), "?") if a.validity is None else a.validity
            vb = np.ones(len(b), "?") if b.validity is None else b.validity
            if not np.array_equal(va, vb):
                return False
            if a.field.type == "string":
                if not all((x == y) or not m for x, y, m in
                           zip(a.values, b.values, va)):
                    return False
            elif a.field.type in ("float32", "float64"):
                av, bv = a.values[va], b.values[vb]
                if not np.allclose(av, bv, equal_nan=True):
                    return False
            else:
                if not np.array_equal(a.values[va], b.values[vb]):
                    return False
        return True

    # -- IPC wire format -------------------------------------------------------
    def to_ipc(self) -> bytes:
        buffers: list[bytes] = []
        meta_cols = []
        for c in self.columns:
            entry: dict = {"name": c.field.name}
            if c.field.type == "string":
                offsets, payload = _to_string_buffers(c.values)
                entry["buffers"] = [len(buffers), len(buffers) + 1]
                buffers.append(offsets.tobytes())
                buffers.append(payload)
            else:
                entry["buffers"] = [len(buffers)]
                buffers.append(np.ascontiguousarray(c.values).tobytes())
            if c.validity is not None:
                entry["validity"] = len(buffers)
                buffers.append(np.packbits(c.validity).tobytes())
            meta_cols.append(entry)
        header = json.dumps({
            "schema": self.schema.to_json(),
            "num_rows": len(self),
            "columns": meta_cols,
            "buffer_lengths": [len(b) for b in buffers],
        }).encode()
        return (b"AIPC" + struct.pack("<I", len(header)) + header
                + b"".join(buffers))

    @staticmethod
    def from_ipc(data: bytes) -> "Table":
        if data[:4] != b"AIPC":
            raise ValueError("bad IPC magic")
        (hlen,) = struct.unpack_from("<I", data, 4)
        header = json.loads(data[8:8 + hlen])
        sch = Schema.from_json(header["schema"])
        n = header["num_rows"]
        lens = header["buffer_lengths"]
        offs = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        base = 8 + hlen

        def buf(i):
            return data[base + offs[i]:base + offs[i + 1]]

        cols = []
        for f, entry in zip(sch, header["columns"]):
            if f.type == "string":
                oi, pi = entry["buffers"]
                offsets = np.frombuffer(buf(oi), np.int64)
                values = _from_string_buffers(offsets, buf(pi))
            else:
                values = np.frombuffer(
                    buf(entry["buffers"][0]), f.numpy_dtype)[:n].copy()
            validity = None
            if "validity" in entry:
                validity = np.unpackbits(
                    np.frombuffer(buf(entry["validity"]), np.uint8))[:n]
                validity = validity.astype("?")
            cols.append(Column(f, values, validity))
        return Table(sch, cols)
