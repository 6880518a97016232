"""FileFormat: where a fragment's scan executes.

``ParquetFormat``          — client-side scan: column-chunk bytes travel
                             over the wire, decode/filter burn client CPU.
``PushdownParquetFormat``  — the paper's contribution: ``scan_op`` runs on
                             the storage node holding the object; only the
                             filtered/projected Arrow-IPC result travels.
``AdaptiveFormat``         — per-fragment placement chosen at runtime by a
                             ScanScheduler from live OSD load, with hedged
                             storage scans and an LRU result cache
                             (``repro_torch.dataset.scheduler``).

Switching the format argument switches the placement — nothing else in the
Dataset/Scanner API changes (paper §2.2, RadosParquetFileFormat).

Task options travel on one :class:`~repro_torch.dataset.qos.TaskContext` passed
as the single ``ctx`` argument of ``scan_fragment`` / ``aggregate_fragment``
/ ``execute_task`` — admission controller, live row budget, selectivity
hint, and the tenant/lane/deadline identity the QoS machinery reads.  The
old ``admission=`` / ``limit=`` / ``selectivity_hint=`` kwarg tail and
pre-TaskContext subclass overrides are adapted by a one-release
compatibility shim that warns (``repro_torch.dataset.qos.resolve_context``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import threading
import time
import warnings
from typing import Any, Sequence

from repro_torch.aformat import decode as decode_mod
from repro_torch.aformat import parquet
from repro_torch.aformat.aggregate import (AggSpec, AggState, DEFAULT_MAX_GROUPS,
                                     needed_columns, partial_aggregate)
from repro_torch.aformat.expressions import Expr
from repro_torch.aformat.table import Table
from repro_torch.dataset.fragment import Fragment
from repro_torch.dataset.qos import TaskContext, resolve_context
from repro_torch.storage.cephfs import CephFS, DirectObjectAccess, FileSource


@dataclasses.dataclass
class TaskRecord:
    """Per-fragment accounting — feeds the Fig. 5/6 performance model."""

    where: str            # "client" or "osd"
    node: int             # osd id (-1 for client-only work)
    cpu_s: float          # decode/filter CPU burned at `where`
    wire_bytes: int       # bytes that crossed the network to the client
    client_cpu_s: float   # residual client CPU (IPC decode / materialize)
    rows_out: int
    hedged: bool = False
    cached: bool = False  # served from the columnar result cache


# -- one-release override shim ------------------------------------------------
# Format subclasses written before TaskContext declare the old kwarg tail
# (`admission=`, `limit=`, ...).  The executor detects them by signature
# (no `ctx` parameter), warns once per class, and calls them old-style
# with whatever subset of the tail they accept.

_CTX_AWARE: dict[tuple[type, str], bool] = {}
_LEGACY_WARNED: set[tuple[type, str]] = set()


def _takes_ctx(cls: type, name: str) -> bool:
    key = (cls, name)
    hit = _CTX_AWARE.get(key)
    if hit is None:
        params = inspect.signature(getattr(cls, name)).parameters
        hit = "ctx" in params
        _CTX_AWARE[key] = hit
    return hit


def _legacy_call_kwargs(cls: type, name: str, ctx: TaskContext) -> dict:
    if (cls, name) not in _LEGACY_WARNED:
        _LEGACY_WARNED.add((cls, name))
        warnings.warn(
            f"{cls.__name__}.{name} overrides the pre-TaskContext "
            f"signature; adapt it to accept `ctx` (this shim is "
            f"one release only)", DeprecationWarning, stacklevel=4)
    params = inspect.signature(getattr(cls, name)).parameters
    kwargs: dict[str, Any] = {}
    if "admission" in params:
        kwargs["admission"] = ctx.admission
    if ctx.limit is not None and "limit" in params:
        kwargs["limit"] = ctx.limit
    if ctx.selectivity_hint is not None and "selectivity_hint" in params:
        kwargs["selectivity_hint"] = ctx.selectivity_hint
    return kwargs


def _call_scan(fmt: "FileFormat", fs: CephFS, frag: Fragment, columns,
               predicate, ctx: TaskContext):
    """Dispatch to ``fmt.scan_fragment`` through the override shim."""
    if _takes_ctx(type(fmt), "scan_fragment"):
        return fmt.scan_fragment(fs, frag, columns, predicate, ctx)
    return fmt.scan_fragment(
        fs, frag, columns, predicate,
        **_legacy_call_kwargs(type(fmt), "scan_fragment", ctx))


class FileFormat:
    """Scan a fragment; returns (Table, TaskRecord).

    ``ctx`` (a :class:`~repro_torch.dataset.qos.TaskContext` or None) carries
    every task option: the admission controller bounding in-flight
    fragment operations per storage node, the live row budget, the
    selectivity hint, and the tenant/lane/deadline QoS identity.  Every
    format acquires a slot on the node it is about to touch — storage-side
    cls calls and client-side byte pulls alike."""

    name = "abstract"

    def scan_fragment(self, fs: CephFS, frag: Fragment,
                      columns: Sequence[str] | None,
                      predicate: Expr | None,
                      ctx: TaskContext | None = None,
                      **legacy) -> tuple[Table, TaskRecord]:
        raise NotImplementedError

    def aggregate_fragment(self, fs: CephFS, frag: Fragment,
                           specs: Sequence[AggSpec], group_by: str | None,
                           predicate: Expr | None, *, schema,
                           max_groups: int = DEFAULT_MAX_GROUPS,
                           ctx: TaskContext | None = None,
                           **legacy) -> tuple[AggState, TaskRecord]:
        """Partial-aggregate one fragment; returns (AggState, TaskRecord).
        ``schema`` is the dataset schema (split-layout fragments carry no
        client-side footer of their own).  The default is the client-side
        path — scan the needed columns, fold locally — so every format
        answers ``Scanner.aggregate``."""
        ctx = resolve_context(ctx, legacy)
        return aggregate_client(self, fs, frag, specs, group_by,
                                predicate, schema=schema, ctx=ctx)

    def execute_task(self, fs: CephFS, task,
                     ctx: TaskContext | None = None, **legacy):
        """The single physical-task entry point the shared query executor
        routes through: one ``FragmentTask`` in (see ``dataset.plan``),
        one (Table | AggState, TaskRecord) out.  Dispatches to the
        format's ``scan_fragment`` / ``aggregate_fragment`` placement
        with the task's own limit / selectivity hint folded into ``ctx``
        (pre-TaskContext subclass overrides go through the one-release
        shim)."""
        ctx = resolve_context(ctx, legacy)
        if task.kind == "scan":
            hint = getattr(task, "selectivity_hint", None)
            if task.limit is not None or hint is not None:
                ctx = dataclasses.replace(
                    ctx,
                    limit=task.limit if task.limit is not None
                    else ctx.limit,
                    selectivity_hint=hint if hint is not None
                    else ctx.selectivity_hint)
            return _call_scan(self, fs, task.fragment, task.columns,
                              task.predicate, ctx)
        if _takes_ctx(type(self), "aggregate_fragment"):
            return self.aggregate_fragment(
                fs, task.fragment, task.specs, task.group_by,
                task.predicate, schema=task.schema,
                max_groups=task.max_groups, ctx=ctx)
        return self.aggregate_fragment(
            fs, task.fragment, task.specs, task.group_by, task.predicate,
            schema=task.schema, max_groups=task.max_groups,
            **_legacy_call_kwargs(type(self), "aggregate_fragment", ctx))

    def explain_task(self, fs: CephFS, task) -> str:
        """One-line placement/cache/hedge annotation for ``explain()``."""
        return f"placement={self.name}"


def resolve_format(format: "FileFormat | str",
                   decode_backend=None) -> "FileFormat":
    """Resolve the Scanner/Query ``format`` argument: a FileFormat
    instance passes through; a known name constructs a fresh instance; an
    unknown value raises a ValueError naming the choices.

    ``decode_backend`` (None / "numpy" / "torch" / a DecodeBackend)
    picks the *client-side* decode engine: it configures the constructed
    ``ParquetFormat`` or ``AdaptiveFormat`` (whose storage side always
    runs the host path — OSDs have no accelerator).  It cannot be
    combined with an already-built instance or with the pure
    storage-side "pushdown" format."""
    if isinstance(format, FileFormat):
        if decode_backend is not None:
            raise ValueError(
                "decode_backend= cannot reconfigure an existing FileFormat "
                "instance; pass it to the format's constructor instead")
        return format
    choices = {"parquet": ParquetFormat, "pushdown": PushdownParquetFormat,
               "adaptive": AdaptiveFormat}
    if isinstance(format, str) and format in choices:
        if decode_backend is not None:
            if format == "pushdown":
                raise ValueError(
                    "decode_backend= does not apply to format='pushdown': "
                    "scan_op decodes on the storage node, which keeps the "
                    "host (numpy) path")
            return choices[format](decode_backend=decode_backend)
        return choices[format]()
    raise ValueError(
        f"unknown format {format!r}: pass one of "
        f"{sorted(choices)} or a FileFormat instance")


def is_degenerate_count(specs: Sequence[AggSpec],
                        group_by: str | None) -> bool:
    """Ungrouped bare COUNT(*): the case with the tiny ``rowcount_op``
    ``{"rows": n}`` wire contract (an integer, not a partial state)."""
    return (group_by is None and len(specs) == 1
            and specs[0].op == "count" and specs[0].column is None)


def count_state(n: int) -> AggState:
    """The degenerate COUNT(*) partial state for ``n`` matched rows."""
    return AggState([AggSpec("count")], None, cells=[int(n)], rows=int(n))


def aggregate_client(fmt: FileFormat, fs: CephFS, frag: Fragment,
                     specs, group_by, predicate, *, schema,
                     ctx: TaskContext | None = None,
                     **legacy) -> "tuple[AggState, TaskRecord]":
    """Client-side aggregation over any format's scan path: pull only the
    referenced columns through ``scan_fragment`` and fold them locally
    (no cardinality bound — the client owns its memory)."""
    ctx = resolve_context(ctx, legacy)
    cols = needed_columns(specs, group_by, schema, predicate)
    # an aggregate folds the fragment's full matching rows — the scan
    # below must not inherit a row budget from the context
    scan_ctx = dataclasses.replace(ctx, limit=None)
    tbl, rec = _call_scan(fmt, fs, frag, cols, predicate, scan_ctx)
    t0 = time.perf_counter()
    state = partial_aggregate(tbl, specs, group_by)
    fold = time.perf_counter() - t0
    # the fold burns client CPU; it counts toward cpu_s only when the
    # record's `where` IS the client (a pushdown spill keeps its cpu_s as
    # the OSD's decode time)
    rec = dataclasses.replace(
        rec, cpu_s=rec.cpu_s + (fold if rec.where == "client" else 0.0),
        client_cpu_s=rec.client_cpu_s + fold, rows_out=state.rows)
    return state, rec


def _admit_fragment(fs: CephFS, frag: Fragment, ctx: TaskContext):
    """Slot on the OSD this fragment's bytes live on (no-op without an
    admission controller on the context)."""
    if ctx.admission is None:
        return contextlib.nullcontext()
    name = fs.object_names(frag.path)[frag.obj_idx]
    return ctx.admission.admit_object(name, ctx)


class ParquetFormat(FileFormat):
    """Client-side scan: read (compressed) column chunks through CephFS,
    decode + filter on the client.  ``decode_backend`` picks the decode
    engine — None (the default) builds ``TorchBackend("cuda")``, which
    routes DICT decode / predicate evaluation / selection through the
    ``repro_torch.kernels`` CUDA kernels on the card; "numpy" (or
    ``TorchBackend(device="cpu")``) keeps the scan on the host
    (``repro_torch.aformat.decode``)."""

    name = "parquet"

    def __init__(self, *, decode_backend=None):
        # the client defaults to the card; the storage side (scan_op)
        # resolves None to the host path
        self.decode_backend = decode_mod.resolve_backend(
            "torch" if decode_backend is None else decode_backend)

    def scan_fragment(self, fs, frag, columns, predicate, ctx=None,
                      **legacy):
        ctx = resolve_context(ctx, legacy)
        wire = 0

        def on_read(n):
            nonlocal wire
            wire += n

        src = FileSource(fs, frag.path, on_read=on_read)
        with _admit_fragment(fs, frag, ctx):
            t0 = time.perf_counter()
            meta = frag.client_meta
            if meta is None:
                meta = parquet.read_footer(src)
            rg = meta.row_groups[frag.client_rg_index]
            tbl = parquet.scan_row_group(src, meta, rg, columns, predicate,
                                         backend=self.decode_backend)
            if ctx.limit is not None:
                # the raw chunk bytes already crossed the wire (client
                # placement decodes whole chunks); the slice only trims
                # what the caller materializes
                tbl = tbl.head(ctx.limit)
            cpu = time.perf_counter() - t0
        rec = TaskRecord("client", -1, cpu, wire, cpu, len(tbl))
        return tbl, rec

    def describe_backend(self, task) -> str:
        """The decode backend's static routing for ``task``'s fragment
        (per-column kernel-vs-host fallbacks, predicate lowering) — the
        ``backend=`` annotation in ``explain()``.  Split-layout fragments
        carry no client-side footer, so their per-column routing resolves
        at scan time."""
        frag = task.fragment
        meta = frag.client_meta if frag.client_meta is not None \
            else frag.footer
        if meta is None:
            return f"{self.decode_backend.name}(meta@scan)"
        rg_index = frag.client_rg_index if frag.client_meta is not None \
            else 0
        columns = task.columns if task.kind == "scan" else None
        return self.decode_backend.describe(
            meta, meta.row_groups[rg_index], columns, task.predicate)

    def explain_task(self, fs, task):
        return f"placement=client backend={self.describe_backend(task)}"


def scan_payload(frag: Fragment, columns, predicate,
                 limit: int | None = None) -> dict[str, Any]:
    """The ``scan_op`` request for one fragment — shared by the static
    pushdown format and the adaptive scheduler so the wire contract can
    never diverge between the two.  ``limit`` is the scan's remaining row
    budget: the storage node stops decoding once it is met and ships at
    most that many rows."""
    payload: dict[str, Any] = {
        "columns": list(columns) if columns is not None else None,
        "predicate": predicate.to_json() if predicate is not None else None,
        "row_groups": [frag.rg_in_object],
    }
    if limit is not None:
        payload["limit"] = int(limit)
    if frag.footer is not None:
        # wire form: bloom index blocks stripped — the OSD prunes with
        # min/max stats (and its own object footer, which keeps them)
        payload["footer"] = frag.footer.serialize(include_indexes=False)
    return payload


def agg_payload(frag: Fragment, specs: Sequence[AggSpec],
                group_by: str | None, predicate: Expr | None,
                max_groups: int) -> dict[str, Any]:
    """The ``agg_op`` request for one fragment — shared by the static
    pushdown format and the adaptive scheduler (same wire-contract rule
    as :func:`scan_payload`)."""
    payload: dict[str, Any] = {
        "aggs": [s.to_json() for s in specs],
        "group_by": group_by,
        "predicate": predicate.to_json() if predicate is not None else None,
        "row_groups": [frag.rg_in_object],
        "max_groups": max_groups,
    }
    if frag.footer is not None:
        # wire form: bloom index blocks stripped — the OSD prunes with
        # min/max stats (and its own object footer, which keeps them)
        payload["footer"] = frag.footer.serialize(include_indexes=False)
    return payload


def parse_agg_reply(raw: bytes) -> "AggState | None":
    """Decode an ``agg_op`` reply; None means the storage node spilled
    (group cardinality over the bound) and the caller must fall back to a
    scan."""
    if json.loads(raw).get("spill"):
        return None
    return AggState.deserialize(raw)


class PushdownParquetFormat(FileFormat):
    """Storage-side scan (the paper's RADOS Parquet): invoke ``scan_op`` on
    the object through DirectObjectAccess; the node decodes/filters and
    returns Arrow IPC; the client only deserializes buffers."""

    name = "pushdown"

    def __init__(self, *, hedge_threshold_s: float | None = None):
        self.hedge_threshold_s = hedge_threshold_s

    def scan_fragment(self, fs, frag, columns, predicate, ctx=None,
                      **legacy):
        # the hint prices placement choices; a static placement ignores it
        ctx = resolve_context(ctx, legacy)
        doa = DirectObjectAccess(fs)
        payload = scan_payload(frag, columns, predicate, ctx.limit)
        with _admit_fragment(fs, frag, ctx):
            if self.hedge_threshold_s is not None:
                result, osd_id, el, hedged = doa.call_hedged(
                    frag.path, frag.obj_idx, "scan_op", payload,
                    hedge_threshold_s=self.hedge_threshold_s,
                    tenant=ctx.tenant, lane=ctx.lane)
            else:
                result, osd_id, el = doa.call(frag.path, frag.obj_idx,
                                              "scan_op", payload,
                                              tenant=ctx.tenant,
                                              lane=ctx.lane)
                hedged = False
        t0 = time.perf_counter()
        tbl = Table.from_ipc(result)
        client_cpu = time.perf_counter() - t0
        rec = TaskRecord("osd", osd_id, el, len(result), client_cpu,
                         len(tbl), hedged=hedged)
        return tbl, rec

    def aggregate_fragment(self, fs, frag, specs, group_by, predicate, *,
                           schema, max_groups=DEFAULT_MAX_GROUPS,
                           ctx=None, **legacy):
        """``agg_op`` on the storage node: only the serialized partial
        state crosses the wire.  A SPILL reply (cardinality over
        ``max_groups``) falls back to the storage-side *scan* — filtered
        columns ship, the client folds them (spill-to-scan).  The
        degenerate ungrouped COUNT(*) keeps the historic ``rowcount_op``
        contract: a bare integer on the wire, not a partial state."""
        ctx = resolve_context(ctx, legacy)
        if is_degenerate_count(specs, group_by):
            return self._count_fragment(fs, frag, predicate, ctx)
        doa = DirectObjectAccess(fs)
        payload = agg_payload(frag, specs, group_by, predicate, max_groups)
        with _admit_fragment(fs, frag, ctx):
            if self.hedge_threshold_s is not None:
                raw, osd_id, el, hedged = doa.call_hedged(
                    frag.path, frag.obj_idx, "agg_op", payload,
                    hedge_threshold_s=self.hedge_threshold_s,
                    tenant=ctx.tenant, lane=ctx.lane)
            else:
                raw, osd_id, el = doa.call(frag.path, frag.obj_idx,
                                           "agg_op", payload,
                                           tenant=ctx.tenant, lane=ctx.lane)
                hedged = False
        t0 = time.perf_counter()
        state = parse_agg_reply(raw)
        if state is None:
            state, rec = aggregate_client(self, fs, frag, specs, group_by,
                                          predicate, schema=schema,
                                          ctx=ctx)
            # the refused agg_op reply still crossed the wire
            rec = dataclasses.replace(
                rec, wire_bytes=rec.wire_bytes + len(raw), hedged=hedged)
            return state, rec
        client_cpu = time.perf_counter() - t0
        rec = TaskRecord("osd", osd_id, el, len(raw), client_cpu,
                         state.rows, hedged=hedged)
        return state, rec

    def _count_fragment(self, fs, frag, predicate, ctx: TaskContext):
        """COUNT(*) [WHERE pred] via ``rowcount_op``: only an integer
        crosses the wire."""
        doa = DirectObjectAccess(fs)
        payload: dict[str, Any] = {
            "predicate": predicate.to_json()
            if predicate is not None else None,
            "row_groups": [frag.rg_in_object],
        }
        if frag.footer is not None:
            payload["footer"] = frag.footer.serialize(
                include_indexes=False)
        with _admit_fragment(fs, frag, ctx):
            if self.hedge_threshold_s is not None:
                raw, osd_id, el, hedged = doa.call_hedged(
                    frag.path, frag.obj_idx, "rowcount_op", payload,
                    hedge_threshold_s=self.hedge_threshold_s,
                    tenant=ctx.tenant, lane=ctx.lane)
            else:
                raw, osd_id, el = doa.call(frag.path, frag.obj_idx,
                                           "rowcount_op", payload,
                                           tenant=ctx.tenant, lane=ctx.lane)
                hedged = False
        n = json.loads(raw)["rows"]
        rec = TaskRecord("osd", osd_id, el, len(raw), 0.0, n,
                         hedged=hedged)
        return count_state(n), rec

    def explain_task(self, fs, task):
        hedge = (f" hedge@{self.hedge_threshold_s}s"
                 if self.hedge_threshold_s is not None else "")
        return f"placement=osd{hedge}"


class AdaptiveFormat(FileFormat):
    """Runtime per-fragment placement (the adaptive scheduler's front-end).

    Each fragment is routed storage-side or client-side by a
    ``ScanScheduler`` reading live OSD load (``ObjectStore.load_of``),
    with hedged storage scans and an LRU columnar result cache.  Keep one
    instance across scans to retain the cache and the learned rate
    estimates; pass ``scheduler=`` to share a scheduler between formats.
    """

    name = "adaptive"

    def __init__(self, scheduler: "Any | None" = None, *,
                 decode_backend=None, **scheduler_kwargs):
        # one scheduler per cluster: scanning dataset A then dataset B on
        # different clusters must not rebuild (and so lose) either
        # scheduler's cache and learned rates
        if scheduler is not None and decode_backend is not None:
            raise ValueError(
                "pass decode_backend to the ScanScheduler constructor "
                "when supplying a scheduler instance")
        if decode_backend is not None:
            # the client side of every scheduler this format builds runs
            # this decode engine; the storage side always stays on the
            # host path (scan_op runs on the OSD)
            scheduler_kwargs["decode_backend"] = decode_backend
        self._schedulers: dict[int, Any] = \
            {id(scheduler.fs): scheduler} if scheduler is not None else {}
        self._kwargs = scheduler_kwargs
        self._bind_lock = threading.Lock()

    def scheduler_for(self, fs: CephFS):
        """The scheduler bound to ``fs`` (created on first use)."""
        from repro_torch.dataset.scheduler import ScanScheduler
        with self._bind_lock:
            sched = self._schedulers.get(id(fs))
            if sched is None:
                sched = ScanScheduler(fs, **self._kwargs)
                self._schedulers[id(fs)] = sched
            return sched

    def scan_fragment(self, fs, frag, columns, predicate, ctx=None,
                      **legacy):
        ctx = resolve_context(ctx, legacy)
        return self.scheduler_for(fs).scan_fragment(frag, columns,
                                                    predicate, ctx)

    def aggregate_fragment(self, fs, frag, specs, group_by, predicate, *,
                           schema, max_groups=DEFAULT_MAX_GROUPS,
                           ctx=None, **legacy):
        ctx = resolve_context(ctx, legacy)
        return self.scheduler_for(fs).aggregate_fragment(
            frag, specs, group_by, predicate, schema=schema,
            max_groups=max_groups, ctx=ctx)

    def explain_task(self, fs, task):
        """Live placement estimate + result-cache probe for explain().
        The probe mirrors the executor's key choice exactly (scan /
        degenerate-count / aggregate); for limited scans it uses the
        plan-time budget, which is what the first-issued tasks run
        with."""
        sched = self.scheduler_for(fs)
        frag = task.fragment
        est = sched.estimate(frag)
        if task.kind == "scan":
            key = sched.cache_key(frag, task.columns, task.predicate,
                                  task.limit)
        elif is_degenerate_count(task.specs, task.group_by):
            key = sched.count_cache_key(frag, task.predicate)
        else:
            key = sched.agg_cache_key(frag, task.specs, task.group_by,
                                      task.max_groups, task.predicate)
        cached = sched.cache.contains(key)
        # name the decode engine each side would run: the storage side is
        # always the host path, the client side is whatever backend the
        # scheduler's client format carries (with its per-column
        # kernel-vs-host routing)
        backend = sched._client_fmt.describe_backend(task)
        return (f"placement={est.where} est_osd={est.est_osd_s * 1e3:.2f}ms "
                f"est_client={est.est_client_s * 1e3:.2f}ms "
                f"pressure={est.pressure:.2f} "
                f"cached={'yes' if cached else 'no'} "
                f"backend[client]={backend} backend[osd]=numpy")

    def stats(self) -> dict:
        """Decision/hedge/cache counters, summed across every cluster
        this format has scanned."""
        out: dict[str, Any] = {}
        for sched in self._schedulers.values():
            for key, val in sched.stats().items():
                if isinstance(val, dict):
                    agg = out.setdefault(key, {})
                    for k, v in val.items():
                        agg[k] = agg.get(k, 0) + v
                else:
                    out[key] = out.get(key, 0) + val
        return out
