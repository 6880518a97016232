"""ARW1 — the Parquet-analogue binary columnar file format.

Layout (byte order little-endian):

    [b"ARW1"]
    row group 0: column chunk 0 buffers | column chunk 1 buffers | ...
    row group 1: ...
    [footer JSON]
    [uint32 footer length][b"ARW1"]

The footer carries the schema, per-row-group / per-column-chunk byte ranges,
encodings, codecs and min/max/null statistics — everything needed for
predicate pushdown (read footer, prune row groups on stats, read only the
projected column chunks).  Structurally faithful to Apache Parquet; not
byte-compatible (Thrift is not the paper's contribution — DESIGN.md §6).
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Sequence

import numpy as np

from repro_torch.aformat import compression, encodings, indexes
from repro_torch.aformat import decode as decode_mod
from repro_torch.aformat.schema import Schema
from repro_torch.aformat.statistics import ColumnStats, compute_stats
from repro_torch.aformat.table import Column, Table

MAGIC = b"ARW1"


@dataclasses.dataclass
class ChunkMeta:
    offset: int                 # absolute file offset of first buffer
    buffer_lengths: list[int]   # compressed buffer lengths, in order
    encoding: str
    codec: str
    stats: ColumnStats
    #: Versioned physical-design index block (bloom + distinct count);
    #: None on footers written before index blocks existed, and on
    #: blocks whose version this reader does not understand.
    index: "indexes.ColumnIndex | None" = None

    def to_json(self, *, include_indexes: bool = True):
        d = {"offset": self.offset, "buffer_lengths": self.buffer_lengths,
             "encoding": self.encoding, "codec": self.codec,
             "stats": self.stats.to_json()}
        if include_indexes and self.index is not None:
            d["index"] = self.index.to_json()
        return d

    @staticmethod
    def from_json(d):
        return ChunkMeta(d["offset"], d["buffer_lengths"], d["encoding"],
                         d["codec"], ColumnStats.from_json(d["stats"]),
                         indexes.ColumnIndex.from_json(d.get("index")))


@dataclasses.dataclass
class RowGroupMeta:
    num_rows: int
    offset: int
    total_bytes: int
    chunks: list[ChunkMeta]     # one per schema field, in order

    def to_json(self, *, include_indexes: bool = True):
        return {"num_rows": self.num_rows, "offset": self.offset,
                "total_bytes": self.total_bytes,
                "chunks": [c.to_json(include_indexes=include_indexes)
                           for c in self.chunks]}

    @staticmethod
    def from_json(d):
        return RowGroupMeta(d["num_rows"], d["offset"], d["total_bytes"],
                            [ChunkMeta.from_json(c) for c in d["chunks"]])

    def column_stats(self, schema: Schema) -> dict[str, ColumnStats]:
        """Per-column stats with the chunk's index block (if any) riding
        along — every pruning choke point receives this mapping, so a
        footer that carries indexes makes ``Expr.prune`` index-aware
        with no signature change anywhere."""
        out = {}
        for f, c in zip(schema, self.chunks):
            if c.stats.index is not c.index:
                c.stats.index = c.index
            out[f.name] = c.stats
        return out


@dataclasses.dataclass
class FileMeta:
    schema: Schema
    row_groups: list[RowGroupMeta]
    num_rows: int
    created_by: str = "repro-arw1"

    def to_json(self, *, include_indexes: bool = True):
        return {"schema": self.schema.to_json(),
                "row_groups": [r.to_json(include_indexes=include_indexes)
                               for r in self.row_groups],
                "num_rows": self.num_rows, "created_by": self.created_by}

    @staticmethod
    def from_json(d):
        return FileMeta(Schema.from_json(d["schema"]),
                        [RowGroupMeta.from_json(r) for r in d["row_groups"]],
                        d["num_rows"], d.get("created_by", "?"))

    def serialize(self, *, include_indexes: bool = True) -> bytes:
        """``include_indexes=False`` strips the (possibly kilobytes-long)
        bloom blocks — the wire form for request payloads and metadata
        replies, where min/max stats are all the receiver prunes with."""
        return json.dumps(
            self.to_json(include_indexes=include_indexes)).encode()

    @staticmethod
    def deserialize(b: bytes) -> "FileMeta":
        return FileMeta.from_json(json.loads(b))


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def encode_row_group(part: Table, codec: str, *, build_indexes: bool = True,
                     advise: bool = False) -> tuple[bytes, RowGroupMeta]:
    """Encode one row group; ChunkMeta offsets are relative to the group.

    ``build_indexes`` attaches a per-column bloom/distinct index block to
    each chunk's footer entry.  ``advise=True`` swaps the one-shot
    ``choose_encoding`` heuristic for the measured advisor (encode every
    candidate, keep the cheapest — the compaction write path)."""
    out = bytearray()
    chunks = []
    for col in part.columns:
        if advise:
            from repro_torch.aformat import advisor as advisor_mod

            advice = advisor_mod.advise_column(
                col.field.type, col.values, codec)
            enc, bufs = advice.encoding, list(advice.buffers)
        else:
            enc = encodings.choose_encoding(col.field.type, col.values)
            try:
                bufs = encodings.encode(col.field.type, enc, col.values)
            except ValueError:  # e.g. DELTA overflow found on full data
                enc = encodings.PLAIN
                bufs = encodings.encode(col.field.type, enc, col.values)
        if col.validity is not None:
            bufs.append(np.packbits(col.validity).tobytes())
        comp = [compression.compress(codec, b) for b in bufs]
        meta = ChunkMeta(len(out), [len(b) for b in comp], enc, codec,
                         compute_stats(col),
                         indexes.ColumnIndex.build(col)
                         if build_indexes else None)
        for b in comp:
            out.extend(b)
        chunks.append(meta)
    return bytes(out), RowGroupMeta(len(part), 0, len(out), chunks)


def _shift_group(rg: RowGroupMeta, offset: int) -> RowGroupMeta:
    return RowGroupMeta(rg.num_rows, offset, rg.total_bytes, [
        ChunkMeta(c.offset + offset, c.buffer_lengths, c.encoding, c.codec,
                  c.stats, c.index) for c in rg.chunks])


def iter_row_groups(table: Table, row_group_rows: int):
    n = len(table)
    if n == 0:
        yield table
        return
    for start in range(0, n, row_group_rows):
        yield table.slice(start, min(row_group_rows, n - start))


def write_table(table: Table, *, row_group_rows: int = 65536,
                codec: str = compression.ZLIB,
                pad_row_groups_to: int = 0,
                build_indexes: bool = True, advise: bool = False) -> bytes:
    """Serialize a table.  ``pad_row_groups_to`` pads every row group to a
    multiple of that many bytes — the Striped layout's equal-size row-group
    rewrite (paper Fig. 3).  ``build_indexes``/``advise`` are the
    physical-design knobs (bloom index blocks; measured encoding
    selection — see ``repro_torch.aformat.advisor``)."""
    out = bytearray(MAGIC)
    groups: list[RowGroupMeta] = []
    for part in iter_row_groups(table, row_group_rows):
        data, rg = encode_row_group(part, codec,
                                    build_indexes=build_indexes,
                                    advise=advise)
        g_off = len(out)
        out.extend(data)
        total = rg.total_bytes
        if pad_row_groups_to and total % pad_row_groups_to:
            pad = pad_row_groups_to - total % pad_row_groups_to
            out.extend(b"\x00" * pad)
            total += pad
        shifted = _shift_group(rg, g_off)
        shifted.total_bytes = total
        groups.append(shifted)
    footer = FileMeta(table.schema, groups, len(table)).serialize()
    out.extend(footer)
    out.extend(struct.pack("<I", len(footer)))
    out.extend(MAGIC)
    return bytes(out)


# ---------------------------------------------------------------------------
# Reader — operates on any random-access source (file bytes, object view)
# ---------------------------------------------------------------------------


class RandomAccessSource:
    """Interface: read(offset, length) -> bytes; size() -> int."""

    def read(self, offset: int, length: int) -> bytes:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError


class BytesSource(RandomAccessSource):
    def __init__(self, data: bytes):
        self._d = data

    def read(self, offset, length):
        return self._d[offset:offset + length]

    def size(self):
        return len(self._d)


def read_footer(src: RandomAccessSource) -> FileMeta:
    sz = src.size()
    tail = src.read(sz - 8, 8)
    if tail[4:] != MAGIC:
        raise ValueError("bad ARW1 trailing magic")
    (flen,) = struct.unpack("<I", tail[:4])
    return FileMeta.deserialize(src.read(sz - 8 - flen, flen))


def read_column(src: RandomAccessSource, meta: FileMeta, rg: RowGroupMeta,
                name: str, backend=None) -> Column:
    """Decode one column chunk through a decode backend (host by
    default — see ``repro_torch.aformat.decode``)."""
    return decode_mod.resolve_backend(backend).decode_column(
        decode_mod.read_chunk(src, meta, rg, name))


def _n_data_buffers(field_type: str, encoding: str) -> int:
    # kept as an alias: the layout rule moved to the decode-engine layer
    return decode_mod.n_data_buffers(field_type, encoding)


def scan_row_group(src: RandomAccessSource, meta: FileMeta, rg: RowGroupMeta,
                   columns: Sequence[str] | None = None,
                   predicate=None, backend=None) -> Table:
    """Decode + filter + project one row group (the scan_op payload).
    ``backend`` picks the decode engine (None -> the NumPy host path;
    "torch" routes DICT decode / predicate / selection through the
    ``repro_torch.kernels`` CUDA kernels, with per-column host routes)."""
    return decode_mod.resolve_backend(backend).scan_row_group(
        src, meta, rg, columns, predicate)


def scan_file(src: RandomAccessSource, columns=None, predicate=None,
              meta: FileMeta | None = None, backend=None) -> Table:
    """Whole-file scan with row-group pruning (predicate pushdown)."""
    from repro_torch.aformat.expressions import ALL, NONE

    meta = meta or read_footer(src)
    parts = []
    for rg in meta.row_groups:
        if predicate is not None:
            verdict = predicate.prune(rg.column_stats(meta.schema))
            if verdict == NONE:
                continue
            pred = None if verdict == ALL else predicate
        else:
            pred = None
        parts.append(scan_row_group(src, meta, rg, columns, pred,
                                    backend=backend))
    if not parts:
        names = list(columns) if columns is not None else meta.schema.names
        sch = meta.schema.select(names)
        return Table(sch, [Column(f, np.empty(0, object)
                                  if f.type == "string"
                                  else np.empty(0, f.numpy_dtype))
                           for f in sch])
    return Table.concat(parts)
