"""Dataset / Scanner — the Arrow Dataset API analogue (paper §2.2).

Discovery maps a CephFS prefix to a list of self-contained Fragments for
any of the three layouts (flat single-object files, striped, split).
Queries are built lazily through :meth:`Dataset.query` (select / filter /
limit / aggregate / count / join — joins push the build side's keys into
the probe scan as an IN-list or bloom filter), optimized as a logical
plan, and lowered to
per-fragment physical tasks run by the one shared streaming executor
(``repro_torch.dataset.plan``) through whichever FileFormat placement the
caller picked:

* ``format="parquet"``   — client-side decode (the paper's baseline),
* ``format="pushdown"``  — storage-side ``scan_op`` (the paper's RADOS
  Parquet),
* ``format="adaptive"``  — per-fragment placement decided at runtime by
  the :class:`~repro_torch.dataset.scheduler.ScanScheduler` from live OSD load,
  with hedged storage scans and an LRU columnar result cache (this repo's
  extension past the paper's static-placement limitation).

:class:`Scanner` survives as the eager compatibility wrapper: each of its
verbs builds the equivalent lazy query and runs it, so every optimization
written for the plan layer (pruning, projection/limit pushdown, metadata
rewrites) applies to all verbs at once.
"""

from __future__ import annotations

import struct
from typing import Iterator, Sequence

from repro_torch.aformat import parquet
from repro_torch.aformat.aggregate import DEFAULT_MAX_GROUPS
from repro_torch.aformat.expressions import Expr
from repro_torch.aformat.schema import Schema
from repro_torch.aformat.table import Table
from repro_torch.dataset.format import FileFormat, resolve_format
from repro_torch.dataset.fragment import Fragment
from repro_torch.dataset.plan import Query, ScanMetrics
from repro_torch.storage import layouts
from repro_torch.storage.cephfs import CephFS


# ---------------------------------------------------------------------------
# Discovery
# ---------------------------------------------------------------------------


class Dataset:
    def __init__(self, fs: CephFS, schema: Schema,
                 fragments: list[Fragment], *, layout: str,
                 discovery_bytes: int = 0):
        self.fs = fs
        self.schema = schema
        self._fragments = fragments
        self.layout = layout
        self.discovery_bytes = discovery_bytes

    def fragments(self) -> list[Fragment]:
        return list(self._fragments)

    @property
    def num_rows(self) -> int:
        return sum(f.num_rows for f in self._fragments)

    def query(self, *, format: FileFormat | str = "pushdown",
              num_threads: int = 16, queue_depth: int = 4,
              decode_backend=None, tenant=None) -> Query:
        """Start a lazy query: ``ds.query().select(...).filter(...)
        .limit(n)`` / ``.aggregate(...)`` / ``.count()``, executed via
        ``to_table`` / ``to_batches`` / ``to_scalar`` and inspectable via
        ``explain()``.  ``format`` picks the placement exactly as in
        :meth:`scanner`; ``decode_backend`` picks the client-side decode
        engine (None for the CUDA kernels of ``repro_torch.kernels`` on
        the card, "numpy" for the host path) for the "parquet" and
        "adaptive" formats.  ``tenant`` tags the run for multi-tenant
        QoS: a tenant name, a :class:`~repro_torch.dataset.qos.TaskContext`
        (usually ``TenantRegistry.context(name)`` — weight, lane,
        deadline), or None for the default tenant."""
        return Query(self, format=format, num_threads=num_threads,
                     queue_depth=queue_depth,
                     decode_backend=decode_backend, tenant=tenant)

    def scanner(self, *, format: FileFormat | str = "pushdown",
                columns: Sequence[str] | None = None,
                predicate: Expr | None = None,
                num_threads: int = 16, queue_depth: int = 4,
                decode_backend=None, tenant=None) -> "Scanner":
        """Build a Scanner.  ``format`` is a FileFormat instance or one of
        "parquet" (client-side), "pushdown" (storage-side), "adaptive"
        (scheduler-placed; pass an ``AdaptiveFormat`` instance instead to
        keep its result cache warm across scans).  ``decode_backend``
        picks the client-side decode engine exactly as in :meth:`query`;
        ``tenant`` tags every verb's run for multi-tenant QoS exactly as
        in :meth:`query`."""
        return Scanner(self,
                       resolve_format(format,
                                      decode_backend=decode_backend),
                       columns, predicate, num_threads=num_threads,
                       queue_depth=queue_depth, tenant=tenant)


def _footer_tail_bytes(fs: CephFS, path: str) -> tuple[parquet.FileMeta, int]:
    """Read just the footer of a flat ARW1 file through CephFS (two range
    reads: length word, then the footer) — returns (meta, bytes_read)."""
    size = fs.file_size(path)
    tail = fs.read_range(path, size - 8, 8)
    (flen,) = struct.unpack("<I", tail[:4])
    raw = fs.read_range(path, size - 8 - flen, flen)
    return parquet.FileMeta.deserialize(raw), flen + 8


def dataset(fs: CephFS, prefix: str, layout: str = "auto") -> Dataset:
    """Discover a dataset under ``prefix``.

    A prefix that carries a snapshot log (``MutableDataset.create`` /
    ``append``) is discovered through its *manifest*, not by re-listing
    the prefix: one HEAD read materializes the current snapshot with
    every footer embedded — exact under concurrent appends, and
    uncommitted or retired data files are invisible.

    Otherwise: auto = split if ``.index`` files exist, else striped if
    the files carry the striped xattr, else flat.
    """
    if layout in ("auto", "mutable"):
        from repro_torch.dataset import snapshot as snapshot_mod

        if snapshot_mod.is_mutable(fs, prefix):
            return snapshot_mod.MutableDataset.open(fs, prefix).as_of()
        if layout == "mutable":
            raise FileNotFoundError(
                f"no mutable dataset (snapshot log) at {prefix!r}")
    paths = fs.listdir(prefix)
    if not paths:
        raise FileNotFoundError(f"no files under {prefix!r}")
    index_paths = [p for p in paths if p.endswith(".index")]
    if layout == "auto":
        if index_paths:
            layout = "split"
        elif any(fs.stat(p).xattrs.get("layout") == "striped"
                 for p in paths):
            layout = "striped"
        else:
            layout = "flat"

    if layout == "split":
        return _discover_split(fs, index_paths)
    if layout == "striped":
        striped = [p for p in paths
                   if fs.stat(p).xattrs.get("layout") == "striped"]
        return _discover_striped(fs, striped)
    flat = [p for p in paths if p.endswith(".arw")
            and fs.stat(p).xattrs.get("layout") not in ("split-part",
                                                        "split-index")]
    return _discover_flat(fs, flat)


def _discover_flat(fs, paths) -> Dataset:
    frags: list[Fragment] = []
    schema = None
    disc = 0
    for path in sorted(paths):
        meta, nbytes = _footer_tail_bytes(fs, path)
        disc += nbytes
        schema = schema or meta.schema
        ino = fs.stat(path)
        for i, rg in enumerate(meta.row_groups):
            obj_idx = rg.offset // ino.stripe_unit
            end_obj = (rg.offset + rg.total_bytes - 1) // ino.stripe_unit
            if obj_idx != end_obj:
                raise ValueError(
                    f"{path}: row group {i} spans objects; write flat "
                    "files with write_flat (single object) or use the "
                    "striped/split layouts")
            frags.append(Fragment(
                path, obj_idx, i, rg.num_rows,
                stats=rg.column_stats(meta.schema),
                footer=None, client_meta=meta, client_rg_index=i))
    return Dataset(fs, schema, frags, layout="flat", discovery_bytes=disc)


def _discover_striped(fs, paths) -> Dataset:
    frags: list[Fragment] = []
    schema = None
    disc = 0
    for path in sorted(paths):
        meta = layouts.read_striped_footer(fs, path)
        ino = fs.stat(path)
        su = ino.stripe_unit
        disc += len(meta.serialize()) + 8
        schema = schema or meta.schema
        for i, rg in enumerate(meta.row_groups):
            obj_idx = rg.offset // su
            # rebase the row group's chunk offsets to the object's origin
            rebased = parquet._shift_group(rg, -obj_idx * su)
            sub = parquet.FileMeta(meta.schema, [rebased], rg.num_rows)
            frags.append(Fragment(
                path, obj_idx, 0, rg.num_rows,
                stats=rg.column_stats(meta.schema),
                footer=sub, client_meta=meta, client_rg_index=i))
    return Dataset(fs, schema, frags, layout="striped",
                   discovery_bytes=disc)


def _discover_split(fs, index_paths) -> Dataset:
    frags: list[Fragment] = []
    schema = None
    disc = 0
    for ipath in sorted(index_paths):
        raw = fs.read_file(ipath)
        disc += len(raw)
        index = layouts.SplitIndex.deserialize(raw)
        schema = schema or index.schema
        for rg in index.row_groups:
            frags.append(Fragment(
                rg["file"], 0, 0, rg["num_rows"], stats=rg["stats"],
                footer=None, client_meta=None, client_rg_index=0))
    return Dataset(fs, schema, frags, layout="split", discovery_bytes=disc)


# ---------------------------------------------------------------------------
# Scanner — eager compatibility wrappers over the lazy query plan
# ---------------------------------------------------------------------------


class Scanner:
    """Eager facade over :class:`~repro_torch.dataset.plan.Query`.

    Every verb builds the equivalent lazy query, runs it through the one
    optimizer + streaming executor, and snapshots that execution's
    :class:`ScanMetrics` into ``self.metrics`` (the last run's record —
    re-running a verb on the same Scanner never double-counts).  Prefer
    ``Dataset.query()`` for new code; these verbs stay for the paper's
    original API shape.
    """

    def __init__(self, ds: Dataset, fmt: FileFormat,
                 columns: Sequence[str] | None, predicate: Expr | None, *,
                 num_threads: int = 16, queue_depth: int = 4, tenant=None):
        self.ds = ds
        self.fmt = fmt
        self.columns = list(columns) if columns is not None else None
        self.predicate = predicate
        self.num_threads = num_threads
        self.queue_depth = queue_depth
        self.tenant = tenant
        self.metrics = ScanMetrics(discovery_bytes=ds.discovery_bytes)

    def query(self) -> Query:
        """The lazy query equivalent to this Scanner's columns/predicate
        (the verbs below all lower through it)."""
        q = Query(self.ds, format=self.fmt, num_threads=self.num_threads,
                  queue_depth=self.queue_depth, tenant=self.tenant)
        if self.predicate is not None:
            q = q.filter(self.predicate)
        if self.columns is not None:
            q = q.select(self.columns)
        return q

    def explain(self) -> str:
        """Render the plan this Scanner's ``to_table`` would run."""
        return self.query().explain()

    def _run(self, q: Query, result):
        self.metrics = q.metrics
        return result

    def to_batches(self, *, max_inflight: int | None = None
                   ) -> Iterator[Table]:
        """Stream the scan as an iterator of per-fragment Tables in
        completion order.  In-flight work is bounded by ``max_inflight``
        (default: the scanner's ``num_threads``) and driven by
        consumption: a paused consumer pauses the scan after at most
        ``max_inflight`` buffered fragments.  Empty fragments are
        skipped."""
        q = self.query()
        batches = q.to_batches(max_inflight=max_inflight)
        self.metrics = q.metrics      # mutated live as batches stream
        return batches

    def to_table(self) -> Table:
        """Materialize the full result (plan order)."""
        q = self.query()
        return self._run(q, q.to_table())

    def aggregate(self, aggs, *, group_by: str | None = None,
                  max_groups: int = DEFAULT_MAX_GROUPS) -> Table:
        """SUM/MIN/MAX/MEAN/COUNT — optionally GROUP BY one key column —
        with storage-side partial aggregation (see ``Query.aggregate``):
        stats-pruned, footer-metadata-answered where provable, fanned out
        through the shared executor, partial states merged in completion
        order."""
        q = self.query().aggregate(aggs, group_by=group_by,
                                   max_groups=max_groups)
        return self._run(q, q.to_table())

    def count_rows(self) -> int:
        """COUNT(*): the degenerate ungrouped aggregate.  Stats-provable
        fragments are answered from metadata with zero I/O; the rest ship
        only integers (``rowcount_op`` for the static pushdown format,
        placement-priced / hedged / result-cached through the scheduler
        for ``format="adaptive"``); only the client-side format decodes a
        column to count it."""
        q = self.query().count()
        return self._run(q, int(q.to_scalar()))
