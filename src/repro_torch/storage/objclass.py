"""Object-class methods (the Ceph ObjectClass SDK analogue).

``scan_op`` is the paper's core: it runs the *same* aformat scan code that a
client would run, but against the object's bytes on the storage node, and
returns the filtered/projected result in IPC (Arrow) wire format.

The scan path is cache-aware: parsed footers are memoized per
(osd, object, version) so repeat scans of a hot object skip the
metadata-decode step entirely; any overwrite bumps the object version and
naturally invalidates the entry.

Registered methods receive (ObjectHandle, payload dict) and return bytes.
"""

from __future__ import annotations

import json
import struct
import threading
import zlib
from collections import OrderedDict

from repro_torch.aformat import parquet
from repro_torch.aformat.aggregate import (AggSpec, AggState, CardinalityError,
                                     needed_columns, partial_aggregate,
                                     partial_from_stats)
from repro_torch.aformat.expressions import Expr, NONE
from repro_torch.aformat.table import Table
from repro_torch.storage.objstore import ObjectStore, ObjectHandle

#: agg_op's reply when the group-by bound is exceeded: the client must
#: fall back to a scan (spill-to-scan).
SPILL = json.dumps({"spill": True}).encode()

# -- storage-side footer cache ----------------------------------------------
# Keyed by (osd_id, object name, object version): a new write produces a new
# version, so stale footers age out of the LRU rather than being served.
_FOOTER_CACHE: OrderedDict[tuple, parquet.FileMeta] = OrderedDict()
_FOOTER_CACHE_CAP = 1024
_FOOTER_LOCK = threading.Lock()


def cached_footer(obj: ObjectHandle) -> parquet.FileMeta:
    """Parse (or recall) the footer of a self-contained ARW1 object."""
    key = (obj.osd_uid, obj.name, obj.version())
    with _FOOTER_LOCK:
        meta = _FOOTER_CACHE.get(key)
        if meta is not None:
            _FOOTER_CACHE.move_to_end(key)
            return meta
    meta = parquet.read_footer(obj)
    with _FOOTER_LOCK:
        _FOOTER_CACHE[key] = meta
        while len(_FOOTER_CACHE) > _FOOTER_CACHE_CAP:
            _FOOTER_CACHE.popitem(last=False)
    return meta


def _payload_footer(obj: ObjectHandle, payload: dict) -> parquet.FileMeta:
    """Footer from the payload (striped layout ships the parent's) or from
    the object itself via the version-keyed cache."""
    raw = payload.get("footer")
    if raw:
        return parquet.FileMeta.deserialize(
            raw.encode() if isinstance(raw, str) else raw)
    return cached_footer(obj)


def scan_op(obj: ObjectHandle, payload: dict) -> bytes:
    """Scan a self-contained ARW1 object: decode + filter + project.

    payload: {"columns": [...]|None, "predicate": expr-json|None,
              "limit": int|None (row budget: stop decoding row groups once
              met, ship at most that many rows — limit pushdown),
              "footer": serialized FileMeta|None (striped layout passes the
              parent footer; split layout objects carry their own)}
    """
    meta = _payload_footer(obj, payload)
    predicate = Expr.from_json(payload.get("predicate"))
    columns = payload.get("columns")
    limit = payload.get("limit")
    row_groups = payload.get("row_groups")  # indices within this object
    metas = (meta.row_groups if row_groups is None
             else [meta.row_groups[i] for i in row_groups])
    parts = []
    rows = 0
    for rg in metas:
        if predicate is not None:
            # storage-side stats skip: a row group whose min/max prove the
            # predicate (e.g. a pushed semi-join key filter) matches no
            # rows is never decoded
            if predicate.prune(rg.column_stats(meta.schema)) == NONE:
                continue
        # storage nodes decode on the host path (default backend): an
        # OSD has no accelerator, so the CUDA decode engine exists
        # only behind the *client-side* formats (aformat.decode)
        part = parquet.scan_row_group(obj, meta, rg, columns, predicate)
        parts.append(part)
        rows += len(part)
        if limit is not None and rows >= limit:
            break                       # budget met: skip later row groups
    table = Table.concat(parts) if parts else None
    if table is not None and limit is not None:
        table = table.head(limit)       # ship only the budgeted rows
    if table is None:
        sel = columns or meta.schema.names
        import numpy as np

        from repro_torch.aformat.table import Column
        sch = meta.schema.select(sel)
        table = Table(sch, [Column(f, np.empty(0, object if f.type == "string"
                                               else f.numpy_dtype))
                            for f in sch])
    return table.to_ipc()


def stat_op(obj: ObjectHandle, payload: dict) -> bytes:
    """Return the footer (metadata) of an ARW1 object — used by the split
    layout's .index discovery."""
    meta = cached_footer(obj)
    return meta.serialize()


def _run_agg(obj: ObjectHandle, meta: parquet.FileMeta,
             specs: list[AggSpec], group_by: str | None, pred,
             metas, max_groups: int | None) -> AggState:
    """The shared storage-side aggregation kernel: per row group, answer
    from footer stats where provable (ungrouped + no predicate), else
    decode only the referenced columns, filter, and fold into the partial
    state.  Raises CardinalityError past ``max_groups``."""
    state = AggState.empty(specs, group_by)
    cols = needed_columns(specs, group_by, meta.schema, pred)
    for rg in metas:
        part = None
        if pred is None and group_by is None:
            part = partial_from_stats(specs,
                                      rg.column_stats(meta.schema),
                                      rg.num_rows, meta.schema)
        if part is None:
            t = parquet.scan_row_group(obj, meta, rg, cols, pred)
            part = partial_aggregate(t, specs, group_by,
                                     max_groups=max_groups)
        state.merge(part)
        if max_groups is not None and state.num_groups > max_groups:
            raise CardinalityError(
                f"group-by {group_by!r}: object-level cardinality "
                f"exceeds {max_groups}")
    return state


def agg_op(obj: ObjectHandle, payload: dict) -> bytes:
    """Partial aggregation on the storage node: decode only the referenced
    columns, filter, fold into an AggState, ship back the compact
    serialized partial state (the client merges states across objects).

    payload: {"aggs": [AggSpec json...], "group_by": str|None,
              "predicate": expr-json|None, "row_groups": [...]|None,
              "footer": serialized FileMeta|None,
              "max_groups": int|None (group-cardinality bound)}

    A fragment whose group-by cardinality exceeds ``max_groups`` returns
    the SPILL marker instead — the client falls back to a scan
    (spill-to-scan), so a hostile key can never balloon node memory or
    the wire payload.  ``rowcount_op`` is the degenerate ungrouped
    COUNT(*) case of this method."""
    meta = _payload_footer(obj, payload)
    specs = [AggSpec.from_json(s) for s in payload["aggs"]]
    group_by = payload.get("group_by")
    pred = Expr.from_json(payload.get("predicate"))
    row_groups = payload.get("row_groups")
    metas = (meta.row_groups if row_groups is None
             else [meta.row_groups[i] for i in row_groups])
    try:
        state = _run_agg(obj, meta, specs, group_by, pred, metas,
                         payload.get("max_groups"))
    except CardinalityError:
        return SPILL
    return state.serialize()


def rowcount_op(obj: ObjectHandle, payload: dict) -> bytes:
    """COUNT(*) [WHERE pred] on the storage node — kept for its tiny
    ``{"rows": n}`` wire contract, now the degenerate case of the agg_op
    kernel (same code path, one count cell, no grouping)."""
    meta = _payload_footer(obj, payload)
    pred = Expr.from_json(payload.get("predicate"))
    row_groups = payload.get("row_groups")
    metas = (meta.row_groups if row_groups is None
             else [meta.row_groups[i] for i in row_groups])
    state = _run_agg(obj, meta, [AggSpec("count")], None, pred, metas,
                     None)
    return json.dumps({"rows": state.cells[0]}).encode()


def compact_op(store: ObjectStore, obj: ObjectHandle,
               payload: dict) -> bytes:
    """Merge co-located small row groups into right-sized ones ON the
    storage node (the mutable-dataset compaction offload).

    payload: {"sources": [{"name": object-name, "keep": expr-json|None},
                          ...],
              "target": object name for the rewritten ARW1 file,
              "row_group_rows": int, "codec": str,
              "advise": bool — re-encode each column into the measured
              encoding advisor's pick (repro_torch.aformat.advisor) instead of
              the one-shot heuristic}

    Every source must be a self-contained ARW1 object held by THIS OSD
    (co-located; the driver groups victims by holder).  The node decodes
    each source (applying the per-source ``keep`` predicate, i.e.
    NOT(tombstone), so deleted rows are physically dropped), concatenates,
    re-encodes at ``row_group_rows`` — statistics are regenerated by the
    encoder — and writes the new object back into the cluster directly
    (``store.put``: an OSD-to-OSD transfer, not a client round-trip).

    Only metadata returns to the client: ``{"ok": true, "rows": n,
    "size": bytes, "bytes_before": source row-group bytes,
    "encodings": {column: encoding chosen for the rewrite},
    "footer": FileMeta json}``.  The raw row-group bytes never cross the
    client wire in either direction (the reply footer is serialized
    *without* index blocks — the new object's own footer keeps them for
    storage-side pruning).  A source this OSD does not hold returns
    ``{"ok": false, "missing": [...]}`` — the driver re-plans or falls
    back to a client-side rewrite.

    Source bytes are read via :meth:`ObjectHandle.peek_all` (cluster-
    internal traffic, like scrub/recovery): compaction must not inflate
    the client-visible read counters."""
    sources = payload["sources"]
    missing = [s["name"] for s in sources
               if not (s["name"] == obj.name
                       or _peer_held(obj, s["name"]))]
    if missing:
        return json.dumps({"ok": False, "missing": missing}).encode()
    parts = []
    bytes_before = 0
    for s in sources:
        handle = obj if s["name"] == obj.name else obj.open_peer(s["name"])
        src = parquet.BytesSource(handle.peek_all())
        meta = parquet.read_footer(src)
        keep = Expr.from_json(s.get("keep"))
        for rg in meta.row_groups:
            bytes_before += rg.total_bytes
            parts.append(parquet.scan_row_group(src, meta, rg, None, keep))
    merged = Table.concat(parts) if parts else None
    rows = len(merged) if merged is not None else 0
    if rows == 0:          # everything tombstoned: nothing to rewrite
        return json.dumps({"ok": True, "rows": 0, "size": 0,
                           "bytes_before": bytes_before,
                           "encodings": {}, "footer": None}).encode()
    data = parquet.write_table(merged,
                               row_group_rows=payload["row_group_rows"],
                               codec=payload.get("codec", "zlib"),
                               advise=bool(payload.get("advise")))
    store.put(payload["target"], data)
    meta = parquet.read_footer(parquet.BytesSource(data))
    encodings = {f.name: c.encoding
                 for f, c in zip(meta.schema, meta.row_groups[0].chunks)}
    return json.dumps({"ok": True, "rows": rows, "size": len(data),
                       "bytes_before": bytes_before,
                       "encodings": encodings,
                       "footer": meta.to_json(include_indexes=False)
                       }).encode()


def _peer_held(obj: ObjectHandle, name: str) -> bool:
    try:
        obj.open_peer(name)
        return True
    except KeyError:
        return False


def checksum_op(obj: ObjectHandle, payload: dict) -> bytes:
    data = obj.read_all()
    return struct.pack("<I", zlib.crc32(data))


def read_op(obj: ObjectHandle, payload: dict) -> bytes:
    """Plain byte read through the cls interface (offset/length payload)."""
    off = int(payload.get("offset", 0))
    ln = payload.get("length")
    return obj.read(off, ln if ln is None else int(ln))


def register_default_classes(store: ObjectStore):
    store.register_cls("scan_op", scan_op)
    store.register_cls("stat_op", stat_op)
    store.register_cls("agg_op", agg_op)
    store.register_cls("rowcount_op", rowcount_op)
    store.register_cls("checksum_op", checksum_op)
    store.register_cls("read_op", read_op)
    # compact_op writes the rewritten object back into the cluster, so it
    # closes over the store (the Ceph cls SDK's ioctx write-back analogue)
    store.register_cls("compact_op",
                       lambda obj, payload: compact_op(store, obj, payload))
    return store
