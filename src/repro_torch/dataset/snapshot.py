"""Mutable datasets: a snapshot log over the object store (MVCC for scans).

The write path so far was write-once (``write_striped/split/flat`` emit a
file exactly once); this module makes a dataset *evolve* while every
reader keeps exact, repeatable results:

manifest log
    A dataset prefix owns a HEAD object and one immutable manifest
    object per snapshot, all stored directly in the object store (never
    listed through the CephFS namespace — discovery reads manifests, it
    does not re-list the prefix).  A manifest names the data files
    (with their full footers embedded, so building a snapshot's
    fragments needs zero reads of the data files) and the delete
    tombstones.

optimistic commits
    ``append`` / ``delete`` / ``compact`` prepare their data out of
    line, then commit by compare-and-swap on the HEAD object
    (``ObjectStore.put_if_version`` — the existing per-object version
    counters are the commit token).  A lost race re-reads HEAD, rebases
    the manifest mutation, and retries; writers never block readers.

snapshot isolation
    ``as_of(snapshot_id)`` materializes one manifest into an immutable
    :class:`~repro_torch.dataset.dataset.Dataset`; ``query()`` resolves HEAD
    once, so a running query (or a long ``to_batches`` stream) is pinned
    to the snapshot it started from no matter how many commits land
    under it.

deletes as tombstones
    ``delete(predicate)`` commits a tombstone; fragments from files
    older than the tombstone carry it (``Fragment.tombstone``) and the
    query optimizer conjoins ``NOT(tombstone)`` into their residual
    predicate — deleted rows never resurface at any placement, and
    stats pruning stays exact.  Compaction physically drops the rows
    and retires tombstones that no remaining file predates.

storage-side compaction (``compact_op``)
    Continuous ingest produces many small row groups — the
    fragmentation that dominates scan cost.  ``compact()`` picks victim
    files from the row-group size histogram, groups them by the OSD
    that holds them, and asks *that node* to merge them
    (``compact_op`` in ``storage/objclass.py``): decode, drop
    tombstoned rows, re-encode right-sized groups, regenerate stats,
    and write the new object back into the cluster — only the new
    file's footer metadata ever crosses the client wire.  The rewrite
    commits as a new snapshot; readers pinned to older snapshots keep
    their files until ``expire()`` garbage-collects them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import secrets
from typing import Callable, Sequence

from repro_torch.aformat import compression, parquet
from repro_torch.aformat.expressions import Expr, Not, Or
from repro_torch.aformat.schema import Schema
from repro_torch.aformat.table import Table
from repro_torch.dataset.dataset import Dataset
from repro_torch.dataset.fragment import Fragment
from repro_torch.dataset.qos import TaskContext, as_task_context
from repro_torch.storage.cephfs import CephFS
from repro_torch.storage.layouts import ALIGN, write_flat
from repro_torch.storage.objstore import ObjectNotFound, VersionConflictError

HEAD_TAG = "snapmeta"


class CommitConflict(RuntimeError):
    """An optimistic commit kept losing the HEAD race (append/delete
    rebase automatically; compaction aborts when its victim set or the
    tombstone set changed underneath it — re-run ``compact()``)."""


def head_object(prefix: str) -> str:
    return f"{HEAD_TAG}!{prefix.rstrip('/')}!HEAD"


def log_object(prefix: str, snapshot_id: int) -> str:
    return f"{HEAD_TAG}!{prefix.rstrip('/')}!{snapshot_id:010d}"


def is_mutable(fs: CephFS, prefix: str) -> bool:
    """True if ``prefix`` carries a snapshot log (a reachable HEAD
    object) — the discovery hook ``repro_torch.dataset.dataset.dataset``
    checks before falling back to prefix listing."""
    return fs.store.exists(head_object(prefix))


# ---------------------------------------------------------------------------
# Manifest model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DataFile:
    """One immutable data file of a snapshot, footer embedded so a
    snapshot materializes without touching the file's objects."""

    path: str
    rows: int
    added_at: int  # snapshot id that introduced the file
    stripe_unit: int
    footer: parquet.FileMeta

    def to_json(self) -> dict:
        return {
            "path": self.path,
            "rows": self.rows,
            "added_at": self.added_at,
            "stripe_unit": self.stripe_unit,
            "footer": self.footer.to_json(),
        }

    @staticmethod
    def from_json(d: dict) -> "DataFile":
        return DataFile(
            d["path"],
            d["rows"],
            d["added_at"],
            d["stripe_unit"],
            parquet.FileMeta.from_json(d["footer"]),
        )


@dataclasses.dataclass
class Tombstone:
    """A delete: rows matching ``predicate`` are gone from every file
    that existed when it committed (``added_at < at``)."""

    at: int  # snapshot id of the delete commit
    predicate: Expr

    def to_json(self) -> dict:
        return {"at": self.at, "predicate": self.predicate.to_json()}

    @staticmethod
    def from_json(d: dict) -> "Tombstone":
        return Tombstone(d["at"], Expr.from_json(d["predicate"]))


@dataclasses.dataclass
class Manifest:
    """One snapshot's complete state: files + tombstones (+ the dataset
    schema, pinned by the first append and kept even when every file is
    later deleted or compacted away)."""

    snapshot_id: int = 0
    parent: int = -1
    files: list[DataFile] = dataclasses.field(default_factory=list)
    tombstones: list[Tombstone] = dataclasses.field(default_factory=list)
    dataset_schema: "Schema | None" = None

    def serialize(self) -> bytes:
        return json.dumps(
            {
                "snapshot_id": self.snapshot_id,
                "parent": self.parent,
                "files": [f.to_json() for f in self.files],
                "tombstones": [t.to_json() for t in self.tombstones],
                "schema": self.dataset_schema.to_json()
                if self.dataset_schema is not None
                else None,
            }
        ).encode()

    @staticmethod
    def deserialize(raw: bytes) -> "Manifest":
        d = json.loads(raw)
        return Manifest(
            d["snapshot_id"],
            d["parent"],
            [DataFile.from_json(f) for f in d["files"]],
            [Tombstone.from_json(t) for t in d["tombstones"]],
            Schema.from_json(d["schema"])
            if d.get("schema") is not None
            else None,
        )

    @property
    def physical_rows(self) -> int:
        """Stored rows, before tombstone filtering."""
        return sum(f.rows for f in self.files)

    def schema(self):
        if self.dataset_schema is not None:
            return self.dataset_schema
        return self.files[0].footer.schema if self.files else None

    def tombstone_for(self, f: DataFile) -> Expr | None:
        """The combined delete predicate applicable to ``f`` (tombstones
        committed after the file was added)."""
        preds = [t.predicate for t in self.tombstones if f.added_at < t.at]
        if not preds:
            return None
        combined = preds[0]
        for p in preds[1:]:
            combined = Or(combined, p)
        return combined


@dataclasses.dataclass
class CompactionReport:
    """What one ``compact()`` run did, with the wire-cost split that is
    the whole point: ``request_bytes + reply_bytes`` is everything that
    crossed the client wire (payload JSON out, footer metadata back);
    ``rewritten_bytes`` moved OSD-to-OSD inside the cluster."""

    snapshot_id: int
    files_in: int = 0
    files_out: int = 0
    rows: int = 0
    groups: int = 0
    fallbacks: int = 0  # client-side rewrites (co-location race)
    request_bytes: int = 0
    reply_bytes: int = 0
    fallback_wire_bytes: int = 0  # raw bytes a client-side rewrite moved
    rewritten_bytes: int = 0  # new objects' bytes (cluster-internal)
    tombstones_dropped: int = 0
    #: Physical-design accounting: source vs rewritten row-group data
    #: bytes, and the encoding the (advisor-driven) rewrite chose per
    #: column — how much the re-encode actually saved.
    bytes_before: int = 0
    bytes_after: int = 0
    encodings: dict = dataclasses.field(default_factory=dict)

    @property
    def wire_bytes(self) -> int:
        return self.request_bytes + self.reply_bytes + \
            self.fallback_wire_bytes


# ---------------------------------------------------------------------------
# The mutable dataset
# ---------------------------------------------------------------------------


class MutableDataset:
    """Transactional append/delete/compact over one dataset prefix.

    All data files are flat ARW1 files (one object per file, every row
    group inside it) so each row group stays a self-contained pushdown
    fragment.  Readers go through :meth:`as_of` / :meth:`query`, which
    pin one snapshot for the lifetime of the query.
    """

    def __init__(self, fs: CephFS, prefix: str):
        self.fs = fs
        self.prefix = prefix.rstrip("/")
        self.commit_conflicts = 0  # lost CAS races (all verbs)

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def create(cls, fs: CephFS, prefix: str) -> "MutableDataset":
        """Initialize an empty snapshot log at ``prefix`` (snapshot 0)."""
        md = cls(fs, prefix)
        genesis = Manifest(snapshot_id=0, parent=-1)
        try:
            fs.store.put_if_version(
                head_object(md.prefix), genesis.serialize(), 0
            )
        except VersionConflictError:
            raise FileExistsError(
                f"mutable dataset already exists at {prefix!r}"
            ) from None
        fs.store.put(log_object(md.prefix, 0), genesis.serialize())
        return md

    @classmethod
    def open(cls, fs: CephFS, prefix: str) -> "MutableDataset":
        md = cls(fs, prefix)
        md._read_head()  # raises if absent
        return md

    # -- snapshot log ------------------------------------------------------
    def _read_head(self) -> tuple[Manifest, int]:
        """Current manifest + the HEAD object version (the CAS token).
        Version is read *before* content: a commit landing in between
        makes the CAS fail and retry, never commit over unseen state."""
        name = head_object(self.prefix)
        version = self.fs.store.version_of(name)
        if version == 0:
            raise FileNotFoundError(
                f"no mutable dataset at {self.prefix!r} "
                "(MutableDataset.create it first)"
            )
        raw = self.fs.store.get(name)
        return Manifest.deserialize(raw), version

    def _commit(
        self,
        mutate: Callable[[Manifest], Manifest],
        *,
        max_retries: int = 32,
    ) -> Manifest:
        """Optimistic commit loop: read HEAD @ v, rebase the mutation on
        it, CAS @ v.  ``mutate`` gets the current manifest and returns
        the successor (``snapshot_id`` must be ``head + 1``); it runs
        again from scratch on every retry, so it must be pure."""
        for _ in range(max_retries):
            head, version = self._read_head()
            new = mutate(head)
            if new.snapshot_id != head.snapshot_id + 1:
                raise ValueError(
                    "mutate() must advance snapshot_id by exactly one"
                )
            try:
                self.fs.store.put_if_version(
                    head_object(self.prefix), new.serialize(), version
                )
            except VersionConflictError:
                self.commit_conflicts += 1
                continue
            self.fs.store.put(
                log_object(self.prefix, new.snapshot_id), new.serialize()
            )
            return new
        raise CommitConflict(
            f"commit on {self.prefix!r} lost {max_retries} CAS races"
        )

    def snapshot(self) -> int:
        """Current HEAD snapshot id."""
        return self._read_head()[0].snapshot_id

    @property
    def schema(self):
        return self._read_head()[0].schema()

    # -- writes ------------------------------------------------------------
    def append(
        self,
        table: Table,
        *,
        row_group_rows: int = 65536,
        codec: str = compression.ZLIB,
    ) -> int:
        """Commit ``table`` as a new data file; returns the snapshot id.
        The file is written before the commit, so a lost CAS race only
        retries the (tiny) manifest swap, never the data write.  A
        commit that fails outright (schema mismatch, exhausted retries)
        unlinks the file again — an uncommitted file is referenced by no
        manifest, so nothing else could ever reclaim it."""
        if len(table) == 0:
            raise ValueError("append() of an empty table")
        path = f"{self.prefix}/data/a{secrets.token_hex(6)}.arw"
        meta = write_flat(
            self.fs, path, table, row_group_rows=row_group_rows,
            codec=codec,
        )
        su = self.fs.stat(path).stripe_unit

        def mutate(head: Manifest) -> Manifest:
            self._check_schema(head, meta.schema)
            sid = head.snapshot_id + 1
            return Manifest(
                sid,
                head.snapshot_id,
                head.files + [DataFile(path, len(table), sid, su, meta)],
                list(head.tombstones),
                head.schema() or meta.schema,
            )

        try:
            return self._commit(mutate).snapshot_id
        except Exception:
            self.fs.unlink(path)
            raise

    def delete(self, predicate: Expr) -> int:
        """Commit a tombstone: rows matching ``predicate`` disappear
        from every snapshot >= the returned id (logical delete; bytes
        are reclaimed by ``compact()`` + ``expire()``)."""
        if not isinstance(predicate, Expr):
            raise TypeError("delete() takes an Expr predicate")

        def mutate(head: Manifest) -> Manifest:
            schema = head.schema()
            if schema is not None:
                for col in sorted(predicate.columns()):
                    schema.field(col)  # raises on unknown column
            sid = head.snapshot_id + 1
            return Manifest(
                sid,
                head.snapshot_id,
                list(head.files),
                head.tombstones + [Tombstone(sid, predicate)],
                head.schema(),
            )

        return self._commit(mutate).snapshot_id

    def _check_schema(self, head: Manifest, schema) -> None:
        current = head.schema()
        if current is not None and current != schema:
            raise ValueError(
                f"append() schema mismatch: dataset has "
                f"{[f.name for f in current]}, append has "
                f"{[f.name for f in schema]}"
            )

    # -- reads -------------------------------------------------------------
    def as_of(self, snapshot_id: int | None = None) -> Dataset:
        """Materialize one snapshot as an immutable Dataset (fragments
        built purely from the manifest's embedded footers — no data-file
        reads).  ``None`` = current HEAD."""
        head, _ = self._read_head()
        if snapshot_id is None or snapshot_id == head.snapshot_id:
            manifest = head
        else:
            try:
                raw = self.fs.store.get(
                    log_object(self.prefix, snapshot_id)
                )
            except (KeyError, ObjectNotFound):
                raise KeyError(
                    f"snapshot {snapshot_id} of {self.prefix!r} is "
                    "unknown or expired"
                ) from None
            manifest = Manifest.deserialize(raw)
        return self._materialize(manifest)

    def _materialize(self, manifest: Manifest) -> Dataset:
        frags: list[Fragment] = []
        schema = manifest.schema()
        for f in manifest.files:
            meta = f.footer
            tomb = manifest.tombstone_for(f)
            for i, rg in enumerate(meta.row_groups):
                obj_idx = rg.offset // f.stripe_unit
                end_obj = (rg.offset + rg.total_bytes - 1) // f.stripe_unit
                if obj_idx != end_obj:
                    raise ValueError(
                        f"{f.path}: row group {i} spans objects — the "
                        "manifest references a non-self-contained file"
                    )
                frags.append(
                    Fragment(
                        f.path,
                        obj_idx,
                        i,
                        rg.num_rows,
                        stats=rg.column_stats(meta.schema),
                        footer=None,
                        client_meta=meta,
                        client_rg_index=i,
                        tombstone=tomb,
                    )
                )
        ds = Dataset(
            self.fs,
            schema,
            frags,
            layout="mutable",
            discovery_bytes=len(manifest.serialize()),
        )
        ds.snapshot_id = manifest.snapshot_id
        return ds

    def query(self, **kwargs):
        """A lazy query pinned to the snapshot current *now*: commits
        landing while it plans or streams are invisible to it."""
        return self.as_of().query(**kwargs)

    def scanner(self, **kwargs):
        """Eager Scanner over a pinned snapshot (see :meth:`query`)."""
        return self.as_of().scanner(**kwargs)

    # -- compaction --------------------------------------------------------
    def compact(
        self,
        *,
        target_rows: int = 65536,
        min_fill: float = 0.5,
        codec: str = compression.ZLIB,
        client_fallback: bool = True,
        tenant=None,
        advisor: bool = True,
    ) -> CompactionReport:
        """Merge small row groups into right-sized ones, storage-side.

        ``advisor=True`` (the default) makes the rewrite the measured
        encoding advisor's customer: each column re-encodes into the
        cheapest candidate ``repro_torch.aformat.advisor`` finds, and the
        report carries ``bytes_before``/``bytes_after``/``encodings``
        so the savings are observable.  ``advisor=False`` keeps the
        one-shot ``choose_encoding`` heuristic.

        Victims come from the row-group size histogram: files whose mean
        row group is under ``min_fill * target_rows`` rows, plus any
        file with an applicable tombstone (rewriting drops the deleted
        rows physically).  Victims are grouped by the OSD that will run
        ``compact_op`` (the first up holder — the same replica
        ``cls_call`` picks), so every merge happens between co-located
        objects with no data movement to the client; the node ships back
        only the new file's footer.  The rewrite commits as one new
        snapshot; old files stay on disk for snapshot readers until
        :meth:`expire`.

        If the cluster changed between planning and execution (an OSD
        died, a replica moved) a group can stop being co-located;
        ``client_fallback=True`` rewrites those groups through the
        client (bytes over the wire, counted in the report), otherwise
        they are skipped this run.

        Compaction is a first-class *background* tenant: by default
        every ``compact_op`` runs as tenant ``"compaction"`` on the
        ``background`` lane, and when ``tenant`` carries a
        :class:`~repro_torch.dataset.qos.TenantRegistry` context its calls go
        through the cluster's shared admission controller — maintenance
        waits behind every foreground scan instead of hitting OSDs
        ungated."""
        if tenant is None:
            ctx = TaskContext(tenant="compaction", lane="background")
        else:
            ctx = as_task_context(tenant)
        if ctx.admission is None and ctx.registry is not None:
            ctx = dataclasses.replace(
                ctx, admission=ctx.registry.controller(self.fs.store))
        head, _ = self._read_head()
        report = CompactionReport(snapshot_id=head.snapshot_id)
        groups = self._plan_groups(head, target_rows, min_fill)
        if not groups:
            return report

        retired: set[str] = set()
        new_files: list[DataFile] = []
        for osd_id, group in groups:
            report.groups += 1
            ok, df = self._compact_group(
                head, osd_id, group, target_rows, codec, client_fallback,
                report, ctx, advisor,
            )
            if not ok:
                continue  # co-location race, no fallback: victims stay
            retired |= {f.path for f in group}
            if df is not None:  # None = every row was tombstoned away
                new_files.append(df)
        if not retired:
            return report
        planned_tombs = [t.to_json() for t in head.tombstones]

        def mutate(cur: Manifest) -> Manifest:
            live = {f.path for f in cur.files}
            if not retired <= live:
                raise CommitConflict(
                    "compaction victims changed under us (concurrent "
                    "compact?) — re-run compact()"
                )
            if [t.to_json() for t in cur.tombstones] != planned_tombs:
                raise CommitConflict(
                    "tombstones changed during compaction — re-run "
                    "compact() so the rewrite sees the new deletes"
                )
            sid = cur.snapshot_id + 1
            files = [f for f in cur.files if f.path not in retired]
            for df in new_files:
                files.append(dataclasses.replace(df, added_at=sid))
            tombs = [
                t
                for t in cur.tombstones
                if any(f.added_at < t.at for f in files)
            ]
            report.tombstones_dropped = len(cur.tombstones) - len(tombs)
            return Manifest(sid, cur.snapshot_id, files, tombs,
                            cur.schema())

        try:
            new = self._commit(mutate)
        except CommitConflict:
            # the rewrite is orphaned, not committed: drop its files so
            # they cannot leak storage, then surface the conflict
            for df in new_files:
                if self.fs.exists(df.path):
                    self.fs.unlink(df.path)
            raise
        report.snapshot_id = new.snapshot_id
        report.files_in = len(retired)
        report.files_out = len(new_files)
        report.rows = sum(df.rows for df in new_files)
        return report

    def _plan_groups(
        self, head: Manifest, target_rows: int, min_fill: float
    ) -> list[tuple[int, list[DataFile]]]:
        """Victim selection + co-location grouping.

        Victims (row-group size histogram: mean group under the fill
        threshold, or any applicable tombstone) are binned onto OSDs
        greedily over their *replica sets* — every object has
        ``replication`` candidate holders, so preferring the candidate
        whose bin is already largest packs far more victims per
        ``compact_op`` call than naive primary-only grouping.  Returns
        (executing osd id, files) groups."""
        threshold = min_fill * target_rows
        victims: list[DataFile] = []
        for f in head.files:
            rg_rows = [rg.num_rows for rg in f.footer.row_groups]
            small = sum(rg_rows) / len(rg_rows) < threshold
            if small or head.tombstone_for(f) is not None:
                victims.append(f)
        bins: dict[int, list[DataFile]] = {}
        for f in victims:
            holders = self._holders(f)
            if not holders:
                continue  # every replica down: nothing to do this run
            osd_id = max(
                holders, key=lambda o: (len(bins.get(o, ())), -o)
            )
            bins.setdefault(osd_id, []).append(f)
        groups = []
        for osd_id, files in sorted(bins.items()):
            multi_rg = any(len(f.footer.row_groups) > 1 for f in files)
            tombed = any(head.tombstone_for(f) is not None for f in files)
            if len(files) >= 2 or tombed or multi_rg:
                groups.append((osd_id, files))
        return groups

    def _object_of(self, f: DataFile) -> str:
        return self.fs.object_names(f.path)[0]

    def _holders(self, f: DataFile) -> list[int]:
        """Up OSDs holding this file's object (compact_op candidates)."""
        name = self._object_of(f)
        return [
            osd.osd_id
            for osd in self.fs.store.acting_set(name)
            if not osd.down and osd.contains(name)
        ]

    def _compact_group(
        self,
        head: Manifest,
        osd_id: int,
        group: Sequence[DataFile],
        target_rows: int,
        codec: str,
        client_fallback: bool,
        report: CompactionReport,
        ctx: TaskContext,
        advisor: bool = True,
    ) -> tuple[bool, DataFile | None]:
        """Rewrite one co-located victim group.  Returns (ok, file):
        ``(True, DataFile)`` on a successful rewrite, ``(True, None)``
        when every row was tombstoned away (victims retire with no
        successor), ``(False, None)`` when the group could not be
        rewritten (co-location race without a client fallback)."""
        path = f"{self.prefix}/data/c{secrets.token_hex(6)}.arw"
        ino_num = self.fs.reserve_ino()
        target = f"{ino_num:x}.{0:08x}"
        sources = []
        for f in group:
            tomb = head.tombstone_for(f)
            sources.append(
                {
                    "name": self._object_of(f),
                    "keep": Not(tomb).to_json() if tomb is not None
                    else None,
                }
            )
        payload = {
            "sources": sources,
            "target": target,
            "row_group_rows": target_rows,
            "codec": codec,
            "advise": advisor,
        }
        report.request_bytes += len(json.dumps(payload).encode())
        gate = (ctx.admission.admit(osd_id, ctx)
                if ctx.admission is not None else contextlib.nullcontext())
        with gate:
            raw, _osd_id, _el = self.fs.store.cls_call(
                sources[0]["name"], "compact_op", payload,
                prefer_osd=self.fs.store.osds[osd_id],
                tenant=ctx.tenant, lane=ctx.lane,
            )
        report.reply_bytes += len(raw)
        reply = json.loads(raw)
        if not reply.get("ok"):
            if not client_fallback:
                return False, None
            return True, self._compact_client(
                head, group, path, target_rows, codec, report, advisor
            )
        report.bytes_before += reply.get("bytes_before", 0)
        for col, enc in reply.get("encodings", {}).items():
            report.encodings[col] = enc
        if reply["rows"] == 0:
            return True, None
        size = reply["size"]
        su = max(ALIGN, -(-size // ALIGN) * ALIGN)
        self.fs.register_file(
            path, ino_num, size, su,
            xattrs={"layout": "flat", "compacted_from": len(group)},
        )
        report.rewritten_bytes += size
        footer = parquet.FileMeta.from_json(reply["footer"])
        report.bytes_after += sum(
            rg.total_bytes for rg in footer.row_groups
        )
        return True, DataFile(path, reply["rows"], 0, su, footer)

    def _compact_client(
        self,
        head: Manifest,
        group: Sequence[DataFile],
        path: str,
        target_rows: int,
        codec: str,
        report: CompactionReport,
        advisor: bool = True,
    ) -> DataFile | None:
        """Client-side rewrite fallback: the same merge, but the raw
        bytes round-trip through the client (read data + write new
        file) — the cost ``compact_op`` exists to avoid, kept for
        co-location races and as the benchmark's comparison arm."""
        report.fallbacks += 1
        parts = []
        for f in group:
            data = self.fs.read_file(f.path)
            report.fallback_wire_bytes += len(data)
            src = parquet.BytesSource(data)
            tomb = head.tombstone_for(f)
            keep = Not(tomb) if tomb is not None else None
            for rg in f.footer.row_groups:
                report.bytes_before += rg.total_bytes
                parts.append(
                    parquet.scan_row_group(src, f.footer, rg, None, keep)
                )
        merged = Table.concat(parts) if parts else None
        if merged is None or len(merged) == 0:
            return None
        meta = write_flat(
            self.fs, path, merged, row_group_rows=target_rows,
            codec=codec, advise=advisor,
        )
        report.bytes_after += sum(
            rg.total_bytes for rg in meta.row_groups
        )
        for f_, c in zip(meta.schema, meta.row_groups[0].chunks):
            report.encodings[f_.name] = c.encoding
        ino = self.fs.stat(path)
        report.fallback_wire_bytes += ino.size
        report.rewritten_bytes += ino.size
        return DataFile(path, len(merged), 0, ino.stripe_unit, meta)

    # -- garbage collection ------------------------------------------------
    def expire(self, retain_from: int | None = None) -> list[str]:
        """Physically remove data files unreachable from every snapshot
        >= ``retain_from`` (default: HEAD only) and drop the expired
        manifest log objects.  Readers pinned to older snapshots lose
        them — call only once those readers are done.  Unlinking bumps
        the deleted objects' versions, so any result-cache entry derived
        from them can never be served again."""
        head, _ = self._read_head()
        if retain_from is None:
            retain_from = head.snapshot_id
        retain_from = min(retain_from, head.snapshot_id)
        keep: set[str] = {f.path for f in head.files}
        all_paths: set[str] = set(keep)
        for sid in range(0, head.snapshot_id + 1):
            try:
                raw = self.fs.store.get(log_object(self.prefix, sid))
            except (KeyError, ObjectNotFound):
                continue
            manifest = Manifest.deserialize(raw)
            paths = {f.path for f in manifest.files}
            all_paths |= paths
            if sid >= retain_from:
                keep |= paths
            else:
                self.fs.store.delete(log_object(self.prefix, sid))
        removed = []
        for path in sorted(all_paths - keep):
            if self.fs.exists(path):
                self.fs.unlink(path)
                removed.append(path)
        return removed
