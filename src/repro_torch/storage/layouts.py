"""The paper's two file-layout designs (§2.3).

Striped (Fig. 3): the table is rewritten so every row group is padded to a
common object-aligned size; CephFS striping then puts exactly one row group
per RADOS object.  Row group 0 shares its object with the 4-byte magic; the
footer lands in the final object(s).  The writer returns the client-side
rowgroup -> object map, which is also persisted as an xattr.

Split (Fig. 4): a file with R row groups becomes R single-row-group ARW1
files plus one ``.index`` file holding the parent schema + per-row-group
stats — so predicate pushdown survives the split.
"""

from __future__ import annotations

import dataclasses
import json
import struct

from repro_torch.aformat import compression, parquet
from repro_torch.aformat.statistics import ColumnStats
from repro_torch.aformat.table import Table
from repro_torch.storage.cephfs import CephFS

ALIGN = 4096


@dataclasses.dataclass
class StripedFile:
    path: str
    stripe_unit: int
    num_row_groups: int
    rg_objects: list[int]        # row group i -> object index
    footer_objects: list[int]


def write_striped(fs: CephFS, path: str, table: Table, *,
                  row_group_rows: int = 65536,
                  codec: str = compression.ZLIB,
                  object_size: int | None = None) -> StripedFile:
    parts = list(parquet.iter_row_groups(table, row_group_rows))
    encoded = [parquet.encode_row_group(p, codec) for p in parts]
    raw_max = max(len(d) for d, _ in encoded)
    # stripe unit: padded row-group size, object-aligned; rg0 shares its
    # stripe with the leading magic.
    su = -(-(raw_max + len(parquet.MAGIC)) // ALIGN) * ALIGN
    if object_size is not None:
        # the "one row group per object" invariant is load-bearing for
        # every pushdown path: an encoded group too big for its object
        # would be split mid-chunk and unscannable storage-side.  Detect
        # the bad knob combination at write time, loudly.
        if object_size % ALIGN:
            raise ValueError(
                f"object_size={object_size} must be a multiple of the "
                f"{ALIGN}-byte object alignment")
        if su > object_size:
            raise ValueError(
                f"write_striped({path!r}): row_group_rows="
                f"{row_group_rows} encodes a row group of {raw_max} "
                f"bytes ({su} after magic+alignment), which cannot fit "
                f"the requested object_size={object_size}; lower "
                f"row_group_rows or raise object_size so every row "
                f"group stays inside one object")
        su = object_size
    out = bytearray(parquet.MAGIC)
    groups = []
    for i, (data, rg) in enumerate(encoded):
        target = i * su + (len(parquet.MAGIC) if i == 0 else 0)
        out.extend(b"\x00" * (target - len(out)))
        shifted = parquet._shift_group(rg, len(out))
        out.extend(data)
        shifted.total_bytes = su
        groups.append(shifted)
    out.extend(b"\x00" * (len(parts) * su - len(out)))
    footer = parquet.FileMeta(table.schema, groups, len(table)).serialize()
    footer_start = len(out)
    out.extend(footer)
    out.extend(struct.pack("<I", len(footer)))
    out.extend(parquet.MAGIC)
    rg_objects = list(range(len(parts)))
    footer_objects = list(range(footer_start // su,
                                (len(out) - 1) // su + 1))
    meta = StripedFile(path, su, len(parts), rg_objects, footer_objects)
    fs.write_file(path, bytes(out), stripe_unit=su, xattrs={
        "layout": "striped",
        "stripe_unit": su,
        "rg_objects": rg_objects,
        "footer_objects": footer_objects,
    })
    return meta


def read_striped_footer(fs: CephFS, path: str) -> parquet.FileMeta:
    """Read the footer from the *last object(s)* only, via striping
    metadata — no full-file read (paper: 'the last object ... is read')."""
    ino = fs.stat(path)
    next_obj = ino.object_count - 1
    last = fs.store.get(fs.object_name(ino, next_obj))
    next_obj -= 1
    if len(last) < 8:
        last = fs.store.get(fs.object_name(ino, next_obj)) + last
        next_obj -= 1
    if last[-4:] != parquet.MAGIC:
        raise ValueError("bad striped footer magic")
    (flen,) = struct.unpack("<I", last[-8:-4])
    while flen + 8 > len(last) and next_obj >= 0:
        # footer spills across objects (index blocks make big footers):
        # keep prepending earlier objects until the length is covered
        last = fs.store.get(fs.object_name(ino, next_obj)) + last
        next_obj -= 1
    return parquet.FileMeta.deserialize(last[-8 - flen:-8])


# ---------------------------------------------------------------------------
# Split layout
# ---------------------------------------------------------------------------


def _index_payload(schema, rg_files, rg_metas) -> bytes:
    return json.dumps({
        "schema": schema.to_json(),
        "row_groups": [
            {"file": f, "num_rows": rg.num_rows,
             "stats": {name: st.to_json() for name, st in
                       rg.column_stats(schema).items()}}
            for f, rg in zip(rg_files, rg_metas)],
    }).encode()


@dataclasses.dataclass
class SplitIndex:
    schema: object
    row_groups: list[dict]   # {"file", "num_rows", "stats": {col: ColumnStats}}

    @staticmethod
    def deserialize(data: bytes) -> "SplitIndex":
        from repro_torch.aformat.schema import Schema

        d = json.loads(data)
        sch = Schema.from_json(d["schema"])
        rgs = []
        for rg in d["row_groups"]:
            rgs.append({
                "file": rg["file"], "num_rows": rg["num_rows"],
                "stats": {k: ColumnStats.from_json(v)
                          for k, v in rg["stats"].items()},
            })
        return SplitIndex(sch, rgs)


def write_split(fs: CephFS, path: str, table: Table, *,
                row_group_rows: int = 65536,
                codec: str = compression.ZLIB,
                object_size: int | None = None) -> str:
    """Writes R single-row-group files + ``<path>.index``; returns the
    index path (dataset discovery finds only .index files, paper Fig. 4).

    ``object_size``, when given, pins every split file's stripe unit; a
    row group whose encoded file exceeds it is a hard error (the
    row-group-within-one-object invariant that all pushdown relies on).
    """
    if object_size is not None and object_size % ALIGN:
        raise ValueError(
            f"object_size={object_size} must be a multiple of the "
            f"{ALIGN}-byte object alignment")
    parts = list(parquet.iter_row_groups(table, row_group_rows))
    rg_files, rg_metas = [], []
    for i, part in enumerate(parts):
        sub = parquet.write_table(part, row_group_rows=max(len(part), 1),
                                  codec=codec)
        sub_path = f"{path}.rg{i:05d}.arw"
        # one object per split file: stripe unit >= file size, aligned
        su = max(ALIGN, -(-len(sub) // ALIGN) * ALIGN)
        if object_size is not None:
            if su > object_size:
                raise ValueError(
                    f"write_split({path!r}): row_group_rows="
                    f"{row_group_rows} encodes row group {i} into "
                    f"{len(sub)} bytes ({su} aligned), which cannot fit "
                    f"the requested object_size={object_size}; lower "
                    f"row_group_rows or raise object_size so every row "
                    f"group stays inside one object")
            su = object_size
        fs.write_file(sub_path, sub, stripe_unit=su,
                      xattrs={"layout": "split-part", "parent": path})
        rg_files.append(sub_path)
        rg_metas.append(parquet.read_footer(
            parquet.BytesSource(sub)).row_groups[0])
    index_path = f"{path}.index"
    fs.write_file(index_path, _index_payload(table.schema, rg_files,
                                             rg_metas),
                  xattrs={"layout": "split-index", "parent": path})
    return index_path


def read_split_index(fs: CephFS, index_path: str) -> SplitIndex:
    return SplitIndex.deserialize(fs.read_file(index_path))


# ---------------------------------------------------------------------------
# Flat layout — the paper's §3 experimental configuration: one ARW1 file per
# object (stripe unit >= file size), single or few row groups per file.
# ---------------------------------------------------------------------------


def write_flat(fs: CephFS, path: str, table: Table, *,
               row_group_rows: int = 65536,
               codec: str = compression.ZLIB,
               build_indexes: bool = True,
               advise: bool = False) -> parquet.FileMeta:
    """Write ``table`` as one self-contained single-object ARW1 file.
    Returns the file's footer (the mutable-dataset append path embeds it
    in the manifest so discovery never re-reads the file).
    ``build_indexes``/``advise`` pass through to
    :func:`parquet.write_table` (bloom index blocks; measured encoding
    selection)."""
    data = parquet.write_table(table, row_group_rows=row_group_rows,
                               codec=codec, build_indexes=build_indexes,
                               advise=advise)
    su = max(ALIGN, -(-len(data) // ALIGN) * ALIGN)
    fs.write_file(path, data, stripe_unit=su, xattrs={"layout": "flat"})
    return parquet.read_footer(parquet.BytesSource(data))
