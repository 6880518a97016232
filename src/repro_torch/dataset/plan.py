"""Lazy query plans: one logical IR, one optimizer, one executor.

Every Scanner verb used to carry its own prune/fan-out body, so each new
optimization had to be written three times (``to_table``, ``aggregate``,
``count_rows``).  This module replaces those verb-private paths with a
declarative pipeline:

builder (``Dataset.query()``)
    ``ds.query().select(cols).filter(pred).limit(n)`` /
    ``.aggregate(aggs, group_by=...)`` / ``.count()`` construct a small
    logical-plan IR (Scan / Filter / Project / Aggregate / Limit nodes,
    plus Count sugar) without touching storage.

optimizer (``lower``)
    Named passes rewrite the logical plan and lower it to per-fragment
    physical tasks: ``rewrite_count`` (COUNT(*) is the degenerate
    ungrouped aggregate), ``pushdown_projection`` (decode only referenced
    columns), ``prune_fragments`` (footer-stats pruning; ALL-verdicts
    drop the residual predicate), ``rewrite_metadata_aggregate``
    (aggregates provable from footer stats never touch storage), and
    ``pushdown_limit`` (a row budget truncates the task list at plan time
    and rides into ``scan_op`` so storage nodes stop decoding early).

executor (``execute_scan`` / ``execute_aggregate``)
    One shared streaming engine (the backpressured, admission-bounded
    engine from the streaming-scan PR) runs the physical tasks for every
    verb and every placement via ``FileFormat.execute_task``.  A limit is
    a live row budget: once met, no further fragments are issued and
    still-queued work is cancelled.

``Query.explain()`` renders the logical plan, the optimizer's decisions,
and the per-fragment physical tasks with their placement/cache/hedge
state — the debugging and benchmarking surface for all of the above.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from itertools import islice
from typing import Any, Iterator, Sequence

import numpy as np

from repro_torch.aformat.aggregate import (
    AggSpec,
    AggState,
    DEFAULT_MAX_GROUPS,
    needed_columns,
    parse_aggs,
    partial_from_stats,
)
from repro_torch.aformat.expressions import (ALL, And, BloomIn, Cmp, Expr, IsIn,
                                       NONE, Not, Or)
from repro_torch.aformat.schema import Field, Schema
from repro_torch.aformat.table import Column, Table
from repro_torch.dataset.admission import AdmissionController, AdmissionTimeout
from repro_torch.dataset.format import TaskRecord, resolve_format
from repro_torch.dataset.fragment import Fragment
from repro_torch.dataset.qos import Shed, TaskContext, as_task_context

#: Distinct build-key cardinality at or below which the semi-join pass
#: pushes an exact IN-list into the probe scan; above it, a bloom filter
#: (approximate on the wire, re-verified at the client hash probe).
IN_LIST_MAX = 256

# ---------------------------------------------------------------------------
# Logical plan IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlanNode:
    """Base logical-plan node.  The tree is linear (each node has one
    input); ``Scan`` is the leaf."""

    def children(self) -> list["PlanNode"]:
        return []


@dataclasses.dataclass
class Scan(PlanNode):
    """Leaf: read a Dataset's fragments.  ``columns`` is filled in by the
    projection-pushdown pass (None = every column)."""

    dataset: Any
    columns: tuple[str, ...] | None = None


@dataclasses.dataclass
class Filter(PlanNode):
    input: PlanNode
    predicate: Expr

    def children(self):
        return [self.input]


@dataclasses.dataclass
class Project(PlanNode):
    input: PlanNode
    columns: tuple[str, ...]

    def children(self):
        return [self.input]


@dataclasses.dataclass
class Aggregate(PlanNode):
    input: PlanNode
    specs: tuple[AggSpec, ...]
    group_by: str | None = None
    max_groups: int = DEFAULT_MAX_GROUPS

    def children(self):
        return [self.input]


@dataclasses.dataclass
class Limit(PlanNode):
    input: PlanNode
    n: int

    def children(self):
        return [self.input]


@dataclasses.dataclass
class Count(PlanNode):
    """Builder sugar for ``.count()``; the ``rewrite_count`` pass lowers
    it to the degenerate ungrouped COUNT(*) Aggregate."""

    input: PlanNode

    def children(self):
        return [self.input]


@dataclasses.dataclass
class Join(PlanNode):
    """Hash join: ``input`` is the probe side (streamed), ``build_query``
    a whole separate Query whose result is hashed on ``on_right``.  The
    join lowers per side — the build side runs first, then the semi-join
    pass turns its keys into an IN-list or bloom filter conjoined into
    the probe scan so OSDs drop non-matching rows before IPC."""

    input: PlanNode
    build_query: Any  # Query (may scan a different Dataset)
    on_left: str
    on_right: str
    how: str = "inner"  # "inner" | "left" | "semi"

    def children(self):
        return [self.input]


def render_expr(e: Expr | None) -> str:
    if e is None:
        return "true"
    if isinstance(e, Cmp):
        return f"{e.column} {e.op} {e.value!r}"
    if isinstance(e, And):
        return f"({render_expr(e.lhs)} & {render_expr(e.rhs)})"
    if isinstance(e, Or):
        return f"({render_expr(e.lhs)} | {render_expr(e.rhs)})"
    if isinstance(e, Not):
        return f"~({render_expr(e.expr)})"
    if isinstance(e, IsIn):
        if len(e.values) > 8:
            return f"{e.column} in <{len(e.values)}-key list>"
        return f"{e.column} in {e.values!r}"
    if isinstance(e, BloomIn):
        return (
            f"{e.column} in bloom({e.count} keys, {e.num_bits} bits, "
            f"digest={e.digest()})"
        )
    return repr(e)


def render_plan(root: PlanNode) -> list[str]:
    """Indented one-node-per-line rendering of a logical plan.  Join
    nodes branch: the probe subtree renders inline, the build side under
    an indented ``build:`` header."""

    def label(n: PlanNode) -> str:
        if isinstance(n, Scan):
            ds = n.dataset
            cols = "*" if n.columns is None else ", ".join(n.columns)
            return (
                f"Scan[{ds.layout}, fragments={len(ds._fragments)}, "
                f"rows={ds.num_rows}, columns={cols}]"
            )
        if isinstance(n, Filter):
            return f"Filter[{render_expr(n.predicate)}]"
        if isinstance(n, Project):
            return f"Project[{', '.join(n.columns)}]"
        if isinstance(n, Aggregate):
            aggs = ", ".join(s.name for s in n.specs)
            by = f", group_by={n.group_by}" if n.group_by else ""
            return f"Aggregate[{aggs}{by}]"
        if isinstance(n, Limit):
            return f"Limit[n={n.n}]"
        if isinstance(n, Count):
            return "Count[]"
        if isinstance(n, Join):
            return f"Join[{n.how}, {n.on_left} = {n.on_right}]"
        return type(n).__name__

    lines: list[str] = []

    def walk(node: PlanNode | None, depth: int):
        while node is not None:
            lines.append("  " * depth + label(node))
            if isinstance(node, Join):
                walk(node.input, depth + 1)
                lines.append("  " * (depth + 1) + "build:")
                walk(node.build_query._root, depth + 2)
                return
            kids = node.children()
            node = kids[0] if kids else None
            depth += 1

    walk(root, 0)
    return lines


# ---------------------------------------------------------------------------
# Optimizer passes (logical -> logical, then logical -> physical)
# ---------------------------------------------------------------------------


def rewrite_count(root: PlanNode) -> PlanNode:
    """COUNT(*) is the degenerate ungrouped aggregate: rewrite the Count
    sugar node so one aggregation path serves both verbs (and the
    metadata / ``rowcount_op`` fast paths apply automatically)."""
    if isinstance(root, Count):
        return Aggregate(root.input, (AggSpec("count"),), None)
    kids = root.children()
    if kids:
        root.input = rewrite_count(kids[0])  # type: ignore[attr-defined]
    return root


@dataclasses.dataclass
class _QuerySpec:
    """A validated, normalized view of the (linear) logical plan."""

    scan: Scan
    predicate: Expr | None
    project: tuple[str, ...] | None
    aggregate: Aggregate | None
    limit: int | None


def _decompose(root: PlanNode) -> _QuerySpec:
    predicate: Expr | None = None
    project: tuple[str, ...] | None = None
    aggregate: Aggregate | None = None
    limit: int | None = None
    seen_relational = False
    node = root
    while not isinstance(node, Scan):
        if isinstance(node, Limit):
            if aggregate is not None:
                # a Limit *below* the aggregate would mean "aggregate
                # any n rows" — refused at build time too (see
                # Query._require_unlimited)
                raise ValueError(
                    "aggregate()/count() over a limit()ed input is not "
                    "supported"
                )
            limit = node.n if limit is None else min(limit, node.n)
        elif isinstance(node, Aggregate):
            if aggregate is not None:
                raise ValueError("nested aggregates are not supported")
            if seen_relational:
                raise ValueError(
                    "filter()/select() above aggregate() is not supported"
                )
            aggregate = node
        elif isinstance(node, Project):
            seen_relational = True
            if project is None:  # outermost projection wins
                project = tuple(node.columns)
        elif isinstance(node, Filter):
            seen_relational = True
            predicate = (
                node.predicate
                if predicate is None
                else And(node.predicate, predicate)
            )
        elif isinstance(node, Count):
            raise ValueError("Count node left in plan: run rewrite_count")
        elif isinstance(node, Join):
            raise ValueError(
                "join plans lower per side; run them via Query.to_table()"
                "/to_batches()/explain()"
            )
        else:
            raise ValueError(f"unknown plan node {type(node).__name__}")
        node = node.children()[0]
    return _QuerySpec(node, predicate, project, aggregate, limit)


def pushdown_projection(
    spec: _QuerySpec, schema
) -> tuple[tuple[str, ...] | None, str]:
    """Columns the scan must decode: for a plain scan, the projected
    output columns (predicate columns are decoded transiently by
    ``scan_row_group`` itself); for an aggregate, exactly the columns the
    aggregate kernel references.  Returns (columns, explain note)."""
    if spec.aggregate is not None:
        if schema is None or len(schema) == 0:
            # an empty dataset (e.g. a mutable dataset before its first
            # append) has no columns to decode — and no tasks to decode
            # them in; only schema-free aggregates (COUNT(*)) get here,
            # the builder rejects column-referencing ones up front
            return None, "empty dataset: nothing to decode"
        cols = tuple(
            needed_columns(
                list(spec.aggregate.specs),
                spec.aggregate.group_by,
                schema,
                spec.predicate,
            )
        )
        return cols, f"aggregate references [{', '.join(cols)}]"
    if spec.project is not None:
        return spec.project, f"scan ships [{', '.join(spec.project)}]"
    return None, "no projection (all columns ship)"


@dataclasses.dataclass
class FragmentDecision:
    """One fragment's fate through the optimizer, for ``explain()``."""

    fragment: Fragment
    action: str  # "pruned" | "metadata" | "task" | "limit-dropped"
    detail: str = ""


def _stats_only(stats):
    """The same per-column stats with index blocks detached — used to
    attribute a NONE verdict to min/max stats vs the bloom index."""
    return {
        k: dataclasses.replace(st, index=None)
        if getattr(st, "index", None) is not None
        else st
        for k, st in stats.items()
    }


def prune_fragments(
    fragments: Sequence[Fragment], predicate: Expr | None
) -> tuple[list[tuple[Fragment, Expr | None]], list[FragmentDecision]]:
    """Footer-stats pruning: NONE-verdict fragments are dropped, ALL
    verdicts drop the residual predicate (the fragment is taken whole).

    Snapshot tombstones (``Fragment.tombstone``) are folded in here —
    the one choke point every verb and placement lowers through: a
    fragment whose stats prove the tombstone deletes *every* row is
    dropped; one whose stats prove it deletes *none* scans clean; the
    rest carry ``NOT(tombstone)`` conjoined into their residual
    predicate, so deleted rows are filtered at whatever placement runs
    the scan.  Fragment stats are physical (pre-delete), which keeps
    both verdicts exact: NONE/ALL over a superset of the live rows still
    hold for the live rows.
    """
    survivors: list[tuple[Fragment, Expr | None]] = []
    decisions: list[FragmentDecision] = []
    for frag in fragments:
        pred = predicate
        tomb = frag.tombstone
        if tomb is not None and frag.stats:
            verdict = tomb.prune(frag.stats)
            if verdict == NONE:
                tomb = None  # stats prove no deleted rows live here
            elif verdict == ALL:
                decisions.append(
                    FragmentDecision(
                        frag, "pruned", "tombstone deletes every row"
                    )
                )
                continue
        if pred is not None and frag.stats:
            verdict = pred.prune(frag.stats)
            if verdict == NONE:
                # attribute the NONE: re-prune with the index blocks
                # detached — only when min/max alone could NOT prove it
                # did the bloom index earn the skip (cheap: pruned
                # fragments only)
                detail = "stats prove NONE"
                if pred.prune(_stats_only(frag.stats)) != NONE:
                    detail = "bloom index proves NONE"
                decisions.append(FragmentDecision(frag, "pruned", detail))
                continue
            if verdict == ALL:
                pred = None
        if tomb is not None:
            anti = Not(tomb)
            pred = anti if pred is None else And(pred, anti)
        survivors.append((frag, pred))
    return survivors, decisions


def rewrite_metadata_aggregate(
    survivors: Sequence[tuple[Fragment, Expr | None]],
    specs: Sequence[AggSpec],
    group_by: str | None,
    schema,
) -> tuple[
    list[tuple[Fragment, Expr | None]], AggState, list[FragmentDecision]
]:
    """Zero-I/O rewrite: ungrouped aggregates over predicate-free
    fragments answerable from footer statistics merge straight into the
    seed state; only the rest become physical tasks."""
    state = AggState.empty(list(specs), group_by)
    remaining: list[tuple[Fragment, Expr | None]] = []
    decisions: list[FragmentDecision] = []
    for frag, pred in survivors:
        if pred is None and group_by is None:
            part = None
            if frag.stats:
                part = partial_from_stats(
                    list(specs), frag.stats, frag.num_rows, schema
                )
            elif all(s.op == "count" and s.column is None for s in specs):
                part = AggState(
                    list(specs),
                    None,
                    cells=[int(frag.num_rows) for _ in specs],
                    rows=frag.num_rows,
                )
            if part is not None:
                state.merge(part)
                decisions.append(
                    FragmentDecision(
                        frag, "metadata", f"footer answers {frag.num_rows} rows"
                    )
                )
                continue
        remaining.append((frag, pred))
    return remaining, state, decisions


def pushdown_limit(
    survivors: Sequence[tuple[Fragment, Expr | None]], limit: int | None
) -> tuple[
    list[tuple[Fragment, Expr | None]], list[FragmentDecision], int | None
]:
    """Plan-time limit truncation: walking plan order, once predicate-free
    fragments alone guarantee ``limit`` rows, every later fragment is
    dropped before any I/O is planned for it.  The returned budget is
    enforced again at run time (early exit) for the fragments that carry
    residual predicates."""
    if limit is None:
        return list(survivors), [], None
    kept: list[tuple[Fragment, Expr | None]] = []
    decisions: list[FragmentDecision] = []
    guaranteed = 0
    for frag, pred in survivors:
        if guaranteed >= limit:
            decisions.append(
                FragmentDecision(
                    frag, "limit-dropped", f"{guaranteed} rows already sure"
                )
            )
            continue
        kept.append((frag, pred))
        if pred is None:
            guaranteed += frag.num_rows
    return kept, decisions, limit


# ---------------------------------------------------------------------------
# Physical plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FragmentTask:
    """One unit of physical work: scan or partially aggregate one
    fragment at whatever placement the FileFormat picks.  ``limit`` is
    refreshed by the executor to the live remaining row budget just
    before the task is issued."""

    index: int
    kind: str  # "scan" | "aggregate"
    fragment: Fragment
    columns: Sequence[str] | None = None
    predicate: Expr | None = None
    specs: Sequence[AggSpec] | None = None
    group_by: str | None = None
    max_groups: int = DEFAULT_MAX_GROUPS
    schema: Any = None
    limit: int | None = None
    #: Expected surviving-row fraction when a semi-join key filter was
    #: pushed into this task — lets the adaptive scheduler price the
    #: reduced reply bytes without waiting for EWMA history.
    selectivity_hint: float | None = None


@dataclasses.dataclass
class PhysicalPlan:
    """The optimized, lowered plan: per-fragment tasks plus everything
    the optimizer already answered without I/O."""

    kind: str  # "scan" | "aggregate"
    dataset: Any
    tasks: list[FragmentTask]
    decisions: list[FragmentDecision]
    passes: list[str]
    columns: list[str] | None = None  # scan output projection
    specs: list[AggSpec] | None = None
    group_by: str | None = None
    max_groups: int = DEFAULT_MAX_GROUPS
    limit: int | None = None
    metadata_state: AggState | None = None
    metadata_answers: int = 0
    fragments_total: int = 0
    fragments_pruned: int = 0
    #: Of the pruned fragments, how many only the bloom index refuted
    #: (min/max stats alone returned SOME).
    fragments_index_pruned: int = 0


def partition_tasks(
    tasks: Sequence[FragmentTask], dp_size: int
) -> list[list[int]]:
    """Deterministic row-balanced partition of a plan's task list across
    ``dp_size`` data-parallel shards.

    Greedy LPT on ``fragment.num_rows``: tasks are placed largest-first
    onto the currently lightest shard, so shard loads stay within one
    fragment of each other without any coordination.  Ties break on
    shard index and task index, making the assignment a pure function of
    (task row counts, dp_size) — every rank computes the same partition
    independently, which is what lets a restored or re-sharded reader
    reproduce it exactly.

    Returns per-shard lists of *indices into* ``tasks``, each sorted
    ascending (plan order within a shard).  Empty shards are legal:
    with fewer tasks than shards the tail shards simply get ``[]``.
    """
    if dp_size <= 0:
        raise ValueError(f"dp_size must be >= 1, got {dp_size}")
    shards: list[list[int]] = [[] for _ in range(dp_size)]
    if not tasks:
        return shards
    order = sorted(
        range(len(tasks)),
        key=lambda i: (-tasks[i].fragment.num_rows, i),
    )
    heap = [(0, s) for s in range(dp_size)]  # (rows assigned, shard idx)
    for i in order:
        rows, s = heapq.heappop(heap)
        shards[s].append(i)
        heapq.heappush(heap, (rows + tasks[i].fragment.num_rows, s))
    for shard in shards:
        shard.sort()
    return shards


def lower(root: PlanNode) -> PhysicalPlan:
    """Run every optimizer pass and lower the logical plan to per-fragment
    physical tasks."""
    passes: list[str] = []
    had_count = isinstance(root, Count) or any(
        isinstance(n, Count) for n in _walk(root)
    )
    root = rewrite_count(root)
    if had_count:
        passes.append("count-as-aggregate: COUNT(*) lowered to Aggregate")
    spec = _decompose(root)
    ds = spec.scan.dataset
    schema = ds.schema

    scan_cols, note = pushdown_projection(spec, schema)
    spec.scan.columns = scan_cols
    passes.append(f"projection-pushdown: {note}")

    fragments = list(ds._fragments)
    survivors, prune_dec = prune_fragments(fragments, spec.predicate)
    n_all = sum(
        1
        for (f, p) in survivors
        if p is None and spec.predicate is not None
    )
    n_index = sum(
        1 for d in prune_dec if d.detail == "bloom index proves NONE"
    )
    passes.append(
        f"stats-pruning: {len(prune_dec)} of {len(fragments)} fragments "
        f"pruned ({n_index} by bloom index), {n_all} predicate-free "
        "after ALL verdicts"
    )

    decisions = list(prune_dec)
    meta_state: AggState | None = None
    meta_answers = 0
    if spec.aggregate is not None:
        agg = spec.aggregate
        survivors, meta_state, meta_dec = rewrite_metadata_aggregate(
            survivors, agg.specs, agg.group_by, schema
        )
        meta_answers = len(meta_dec)
        decisions.extend(meta_dec)
        passes.append(
            f"metadata-rewrite: {meta_answers} fragments answered from "
            "footer stats (zero I/O)"
        )
        tasks = [
            FragmentTask(
                i,
                "aggregate",
                frag,
                predicate=pred,
                specs=list(agg.specs),
                group_by=agg.group_by,
                max_groups=agg.max_groups,
                schema=schema,
            )
            for i, (frag, pred) in enumerate(survivors)
        ]
        limit = spec.limit  # applies to the finalized table client-side
    else:
        survivors, limit_dec, limit = pushdown_limit(survivors, spec.limit)
        if spec.limit is not None:
            passes.append(
                f"limit-pushdown: row budget {spec.limit}; plan truncated "
                f"to {len(survivors)} tasks ({len(limit_dec)} dropped), "
                "budget rides into scan_op"
            )
        decisions.extend(limit_dec)
        tasks = [
            FragmentTask(
                i,
                "scan",
                frag,
                columns=list(scan_cols) if scan_cols is not None else None,
                predicate=pred,
                limit=limit,
            )
            for i, (frag, pred) in enumerate(survivors)
        ]
    decisions.extend(
        FragmentDecision(t.fragment, "task", render_expr(t.predicate))
        for t in tasks
    )
    return PhysicalPlan(
        kind="scan" if spec.aggregate is None else "aggregate",
        dataset=ds,
        tasks=tasks,
        decisions=decisions,
        passes=passes,
        columns=list(scan_cols)
        if scan_cols is not None and spec.aggregate is None
        else None,
        specs=list(spec.aggregate.specs) if spec.aggregate else None,
        group_by=spec.aggregate.group_by if spec.aggregate else None,
        max_groups=spec.aggregate.max_groups
        if spec.aggregate
        else DEFAULT_MAX_GROUPS,
        limit=limit if spec.aggregate is None else spec.limit,
        metadata_state=meta_state,
        metadata_answers=meta_answers,
        fragments_total=len(fragments),
        fragments_pruned=len(prune_dec),
        fragments_index_pruned=n_index,
    )


def _walk(root: PlanNode) -> Iterator[PlanNode]:
    node: PlanNode | None = root
    while node is not None:
        yield node
        kids = node.children()
        node = kids[0] if kids else None


# ---------------------------------------------------------------------------
# Scan metrics (every verb records these uniformly)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScanMetrics:
    tasks: list[TaskRecord] = dataclasses.field(default_factory=list)
    fragments_total: int = 0
    fragments_pruned: int = 0
    fragments_index_pruned: int = 0  # pruned by bloom index, not min/max
    metadata_answers: int = 0  # fragments answered from footer stats
    discovery_bytes: int = 0
    rows: int = 0
    wall_s: float = 0.0
    admission: dict = dataclasses.field(default_factory=dict)
    #: Build-side metrics of a join run (its own scan), kept separate so
    #: probe-side wire bytes stay directly comparable across strategies.
    build: "ScanMetrics | None" = None
    tenant: str = "default"
    lane: str = "bulk"
    #: Set when the run was deadline-shed (the run verbs return it too).
    shed: Shed | None = None

    @property
    def client_cpu_s(self) -> float:
        return sum(t.client_cpu_s for t in self.tasks)

    @property
    def osd_cpu_s(self) -> float:
        return sum(t.cpu_s for t in self.tasks if t.where == "osd")

    @property
    def wire_bytes(self) -> int:
        return self.discovery_bytes + sum(t.wire_bytes for t in self.tasks)

    @property
    def cache_hits(self) -> int:
        return sum(1 for t in self.tasks if t.cached)

    @property
    def hedged_tasks(self) -> int:
        return sum(1 for t in self.tasks if t.hedged)

    def summary(self) -> dict:
        d = {
            "tenant": self.tenant,
            "lane": self.lane,
            "fragments": self.fragments_total,
            "pruned": self.fragments_pruned,
            "index_pruned": self.fragments_index_pruned,
            "metadata_answers": self.metadata_answers,
            "rows": self.rows,
            "wire_bytes": self.wire_bytes,
            "client_cpu_s": round(self.client_cpu_s, 4),
            "osd_cpu_s": round(self.osd_cpu_s, 4),
            "wall_s": round(self.wall_s, 4),
            "cache_hits": self.cache_hits,
            "hedged": self.hedged_tasks,
            "admission_waits": self.admission.get("waits", 0),
            "admission_wait_s": self.admission.get("wait_s", 0.0),
            "preemptions": self.admission.get("preemptions", 0),
            "sheds": self.admission.get("sheds", 0),
        }
        if self.shed is not None:
            d["shed"] = str(self.shed)
        if self.build is not None:
            d["build"] = self.build.summary()
        return d


# ---------------------------------------------------------------------------
# The shared streaming executor
# ---------------------------------------------------------------------------


def _admission_delta(before: dict, after: dict) -> dict:
    """This run's share of a (possibly shared, possibly long-lived)
    admission controller's counters."""
    d = {"slots_per_osd": after["slots_per_osd"]}
    for k in ("admitted", "waits", "wait_s", "preemptions", "sheds"):
        v = after[k] - before[k]
        d[k] = round(v, 6) if k == "wait_s" else v
    return d


def stream_tasks(
    plan: PhysicalPlan,
    fmt,
    metrics: ScanMetrics,
    *,
    max_inflight: int,
    queue_depth: int,
    ctx: TaskContext | None = None,
) -> Iterator[tuple[FragmentTask, Any]]:
    """Run the plan's fragment tasks through ``fmt.execute_task`` with at
    most ``max_inflight`` in flight, issuing new work only as finished
    work is consumed (backpressure) and per-OSD pressure bounded by one
    shared AdmissionController.

    Yields (task, Table | AggState) in completion order.  For scan plans
    with a limit, the live row budget stops issuance the moment it is
    met and cancels still-queued tasks — fragments past the budget are
    never scanned.

    ``ctx`` is the run's :class:`~repro_torch.dataset.qos.TaskContext`.  With a
    registry attached, admission goes through the cluster's shared
    weighted-fair controller (every tenant arbitrated together);
    otherwise a run-private controller reproduces the historic
    single-tenant behavior.  A run that cannot meet ``ctx.deadline_s``
    stops issuing work and records a typed :class:`Shed` on
    ``metrics.shed`` — the stream simply ends early; the run verbs turn
    it into their return value."""
    ds = plan.dataset
    ctx = ctx if ctx is not None else TaskContext()
    if ctx.admission is not None:
        admission = ctx.admission
    elif ctx.registry is not None:
        admission = ctx.registry.controller(ds.fs.store)
    else:
        admission = AdmissionController(ds.fs.store, queue_depth)
    t0 = time.perf_counter()
    ctx = dataclasses.replace(
        ctx, admission=admission,
        started_at=t0 if ctx.started_at is None else ctx.started_at)
    lock = threading.Lock()
    remaining = plan.limit if plan.kind == "scan" else None
    completed = 0
    total = len(plan.tasks)

    def shed(reason: str):
        metrics.shed = Shed(ctx.tenant, ctx.lane, reason, ctx.deadline_s,
                            ctx.elapsed_s(), completed, total)

    def over_deadline() -> bool:
        r = ctx.remaining_s()
        return r is not None and r <= 0

    def run(task: FragmentTask):
        out, rec = fmt.execute_task(ds.fs, task, ctx)
        with lock:
            metrics.tasks.append(rec)
        return task, out

    before = admission.stats()
    try:
        tasks = plan.tasks
        if max_inflight <= 1 or len(tasks) <= 1:
            for task in tasks:
                if remaining is not None:
                    if remaining <= 0:
                        return
                    task.limit = remaining
                if over_deadline():
                    shed(f"deadline expired with {total - completed} "
                         f"tasks left")
                    return
                try:
                    task, out = run(task)
                except AdmissionTimeout as e:
                    shed(f"admission timeout on osd.{e.osd_id} after "
                         f"{e.waited_s * 1e3:.1f}ms queued")
                    return
                completed += 1
                if remaining is not None:
                    remaining -= len(out)
                yield task, out
            return
        it = iter(tasks)

        def submit(pool, task):
            if remaining is not None:
                task.limit = remaining
            return pool.submit(run, task)

        with ThreadPoolExecutor(max_workers=max_inflight) as pool:
            pending = {
                submit(pool, t) for t in islice(it, max_inflight)
            }
            try:
                while pending:
                    done, pending = wait(
                        pending, return_when=FIRST_COMPLETED
                    )
                    for fut in done:
                        try:
                            task, out = fut.result()
                        except AdmissionTimeout as e:
                            shed(f"admission timeout on osd.{e.osd_id} "
                                 f"after {e.waited_s * 1e3:.1f}ms queued")
                            return
                        completed += 1
                        if remaining is not None:
                            remaining -= len(out)
                        if (remaining is None or remaining > 0) \
                                and not over_deadline():
                            nxt = next(it, None)
                            if nxt is not None:
                                pending.add(submit(pool, nxt))
                        yield task, out
                        if remaining is not None and remaining <= 0:
                            return  # budget met: cancel queued work
                        if over_deadline() and completed < total:
                            shed(f"deadline expired with "
                                 f"{total - completed} tasks left")
                            return
            finally:
                for fut in pending:  # consumer stopped early / budget met
                    fut.cancel()
    finally:
        metrics.wall_s = time.perf_counter() - t0
        metrics.admission = _admission_delta(before, admission.stats())
        if ctx.registry is not None:
            ctx.registry.record(metrics)


def empty_table(schema, columns: Sequence[str] | None) -> Table:
    if schema is None:  # e.g. a mutable dataset with no appends yet
        from repro_torch.aformat.schema import Schema

        return Table(Schema(()), [])
    names = list(columns) if columns is not None else schema.names
    sch = schema.select(names)
    return Table(
        sch,
        [
            Column(
                f,
                np.empty(0, object if f.type == "string" else f.numpy_dtype),
            )
            for f in sch
        ],
    )


# ---------------------------------------------------------------------------
# Joins: build-side hashing, semi-join pushdown, probe-side assembly
# ---------------------------------------------------------------------------

_JOIN_HOWS = ("inner", "left", "semi")
_INT_TYPES = {"int8", "int16", "int32", "int64"}


@dataclasses.dataclass
class _PostOps:
    """Filter/Project/Limit nodes sitting *above* a Join: they run on the
    assembled join output, client-side."""

    predicate: Expr | None
    project: tuple[str, ...] | None
    limit: int | None


def _split_join(root: PlanNode) -> tuple[_PostOps, Join, PlanNode]:
    """Split a join plan into (post-join ops, join node, probe subtree)."""
    predicate: Expr | None = None
    project: tuple[str, ...] | None = None
    limit: int | None = None
    node = root
    while not isinstance(node, Join):
        if isinstance(node, Limit):
            limit = node.n if limit is None else min(limit, node.n)
        elif isinstance(node, Project):
            if project is None:  # outermost projection wins
                project = tuple(node.columns)
        elif isinstance(node, Filter):
            predicate = (
                node.predicate
                if predicate is None
                else And(node.predicate, predicate)
            )
        else:
            raise ValueError(
                f"{type(node).__name__} above a join is not supported"
            )
        node = node.children()[0]
    return _PostOps(predicate, project, limit), node, node.input


def _join_fields(join: Join):
    """Output shape of a join: (probe output names, [(build column,
    renamed output Field)], all output Fields).

    Semi joins emit probe columns only.  Inner/left emit probe columns
    then build columns minus the build key (it duplicates the probe
    key); build names clashing with an already-used name get ``_right``
    suffixed until unique."""
    pspec = _decompose(_copy_plan(join.input))
    bspec = _decompose(_copy_plan(join.build_query._root))
    probe_ds, build_ds = pspec.scan.dataset, bspec.scan.dataset
    probe_names = (
        list(pspec.project)
        if pspec.project is not None
        else list(probe_ds.schema.names)
    )
    probe_fields = [probe_ds.schema.field(n) for n in probe_names]
    if join.how == "semi":
        return probe_names, [], probe_fields
    build_names = (
        list(bspec.project)
        if bspec.project is not None
        else list(build_ds.schema.names)
    )
    used = set(probe_names)
    pairs: list[tuple[str, Field]] = []
    for n in build_names:
        if n == join.on_right:
            continue
        f = build_ds.schema.field(n)
        out = n
        while out in used:
            out += "_right"
        used.add(out)
        # a left join's unmatched probe rows null the build columns
        pairs.append(
            (n, Field(out, f.type, f.nullable or join.how == "left"))
        )
    return probe_names, pairs, probe_fields + [f for _, f in pairs]


@dataclasses.dataclass
class JoinStrategy:
    """What the semi-join pass decided, for explain() and tests."""

    how: str
    on_left: str
    on_right: str
    build_rows: int
    distinct_keys: int
    pushdown: str  # "inlist" | "bloom" | "none"
    reason: str = ""  # why pushdown is "none"
    key_filter: Expr | None = None
    selectivity_hint: float | None = None


def _choose_strategy(
    join: Join, probe_limit: int | None, probe_rows: int,
    build_rows: int, distinct: np.ndarray,
) -> JoinStrategy:
    """The semi-join pushdown pass: inner/semi joins turn the build keys
    into a probe-side filter — an exact IN-list when small, a bloom
    filter when large.  Left joins keep every probe row, and a probe
    limit means "any n probe rows" *before* the join, which a pushed
    filter would silently change — both run unfiltered."""
    n = len(distinct)
    base = dict(how=join.how, on_left=join.on_left, on_right=join.on_right,
                build_rows=build_rows, distinct_keys=n)
    if join.how == "left":
        return JoinStrategy(
            **base, pushdown="none",
            reason="left join keeps every probe row")
    if probe_limit is not None:
        return JoinStrategy(
            **base, pushdown="none",
            reason="probe-side limit pins pre-join row selection")
    hint = min(1.0, max(n, 1) / max(1, probe_rows))
    if n <= IN_LIST_MAX:
        values = [
            v.item() if isinstance(v, np.generic) else v for v in distinct
        ]
        return JoinStrategy(
            **base, pushdown="inlist",
            key_filter=IsIn(join.on_left, values), selectivity_hint=hint)
    return JoinStrategy(
        **base, pushdown="bloom",
        key_filter=BloomIn.build(join.on_left, distinct),
        selectivity_hint=hint)


def _linear_root(
    spec: _QuerySpec,
    columns: Sequence[str] | None,
    extra_pred: Expr | None = None,
) -> PlanNode:
    """Rebuild a linear logical plan from a decomposed side of a join,
    with the pushed key filter (if any) conjoined into the predicate so
    ``prune_fragments`` and ``scan_op`` see one composed residual."""
    root: PlanNode = Scan(spec.scan.dataset)
    pred = spec.predicate
    if extra_pred is not None:
        pred = extra_pred if pred is None else And(pred, extra_pred)
    if pred is not None:
        root = Filter(root, pred)
    if columns is not None:
        root = Project(root, tuple(columns))
    if spec.limit is not None:
        root = Limit(root, spec.limit)
    return root


def _key_validity(col: Column) -> np.ndarray:
    """Join-key semantics: null keys never match, and neither do NaNs
    (SQL equality, matching the NumPy reference)."""
    valid = (
        np.ones(len(col.values), "?")
        if col.validity is None
        else col.validity.astype(bool)
    )
    if col.field.type in ("float32", "float64"):
        valid = valid & ~np.isnan(col.values)
    return valid


@dataclasses.dataclass
class _JoinContext:
    how: str
    on_left: str
    probe_names: list[str]
    build_pairs: list  # [(build column name, renamed output Field)]
    fields: list  # joined output Fields
    build_tbl: Table
    index: dict  # key -> [build row idx], build-row order
    distinct: np.ndarray  # exact distinct non-null build keys
    strategy: JoinStrategy


def _gather_build(ctx: _JoinContext, bi: np.ndarray) -> list[Column]:
    """Gather build-side output columns by row index; ``-1`` marks an
    unmatched probe row (left join): null, zero-filled storage."""
    matched = bi >= 0
    safe = np.where(matched, bi, 0)
    out: list[Column] = []
    for name, field in ctx.build_pairs:
        col = ctx.build_tbl.column(name)
        if len(col.values) == 0:
            vals = (
                np.array([""] * len(bi), object)
                if field.type == "string"
                else np.zeros(len(bi), field.numpy_dtype)
            )
            out.append(Column(field, vals, np.zeros(len(bi), "?")))
            continue
        vals = col.values[safe]
        valid = (
            np.ones(len(bi), "?")
            if col.validity is None
            else col.validity[safe].astype(bool)
        )
        if not matched.all():
            vals = vals.copy()
            vals[~matched] = "" if field.type == "string" else 0
            valid = valid & matched
        out.append(Column(field, vals, valid))
    return out


def _join_batch(tbl: Table, ctx: _JoinContext) -> Table:
    """Probe one batch against the built table.  Probe rows keep their
    scan order; a probe row's matches come out in build-row order —
    deterministic, so the differential harness can assert exact
    equality."""
    kcol = tbl.column(ctx.on_left)
    kvalid = _key_validity(kcol)
    kvals = kcol.values
    probe = tbl.select(ctx.probe_names)
    if ctx.how == "semi":
        mask = np.zeros(len(tbl), "?")
        if len(ctx.distinct):
            # exact membership: bloom false positives die here
            mask = np.isin(kvals, ctx.distinct) & kvalid
        return probe.filter(mask)
    pidx: list[int] = []
    bidx: list[int] = []
    for i in range(len(tbl)):
        rows = ctx.index.get(kvals[i]) if kvalid[i] else None
        if rows:
            pidx.extend([i] * len(rows))
            bidx.extend(rows)
        elif ctx.how == "left":
            pidx.append(i)
            bidx.append(-1)
    pi = np.asarray(pidx, np.int64)
    bi = np.asarray(bidx, np.int64)
    cols = list(probe.take(pi).columns) + _gather_build(ctx, bi)
    return Table(Schema(tuple(ctx.fields)), cols)


def _empty_join_table(ctx: _JoinContext) -> Table:
    return Table(
        Schema(tuple(ctx.fields)),
        [
            Column(
                f,
                np.empty(0, object if f.type == "string" else f.numpy_dtype),
            )
            for f in ctx.fields
        ],
    )


def _apply_post(tbl: Table, post: _PostOps) -> Table:
    if post.predicate is not None:
        tbl = tbl.filter(post.predicate.evaluate(tbl))
    if post.project is not None:
        tbl = tbl.select(list(post.project))
    if post.limit is not None:
        tbl = tbl.head(post.limit)
    return tbl


# ---------------------------------------------------------------------------
# The Query builder
# ---------------------------------------------------------------------------


class Query:
    """Lazy, composable query over a Dataset.

    Builder verbs (``select`` / ``filter`` / ``limit`` / ``aggregate`` /
    ``count``) only grow the logical plan; nothing touches storage until
    ``to_table`` / ``to_batches`` / ``to_scalar`` runs it through the
    optimizer and the shared streaming executor.  ``explain()`` shows
    what would run.  ``metrics`` holds the last execution's ScanMetrics
    (each run gets a fresh snapshot)."""

    def __init__(
        self,
        ds,
        *,
        format="pushdown",
        num_threads: int = 16,
        queue_depth: int = 4,
        decode_backend=None,
        tenant=None,
        _root: PlanNode | None = None,
        _scalar: bool = False,
    ):
        self.ds = ds
        self.fmt = resolve_format(format, decode_backend=decode_backend)
        self.num_threads = num_threads
        self.queue_depth = queue_depth
        self.ctx = as_task_context(tenant)
        self._root = _root if _root is not None else Scan(ds)
        self._scalar = _scalar
        self.metrics = ScanMetrics(discovery_bytes=ds.discovery_bytes)

    # -- builder -----------------------------------------------------------
    def _derive(self, root: PlanNode, *, scalar: bool | None = None):
        q = Query.__new__(Query)
        q.ds = self.ds
        q.fmt = self.fmt
        q.num_threads = self.num_threads
        q.queue_depth = self.queue_depth
        q.ctx = self.ctx
        q._root = root
        q._scalar = self._scalar if scalar is None else scalar
        q.metrics = ScanMetrics(discovery_bytes=self.ds.discovery_bytes)
        return q

    @property
    def _has_aggregate(self) -> bool:
        return any(
            isinstance(n, (Aggregate, Count)) for n in _walk(self._root)
        )

    def _join_node(self) -> Join | None:
        for n in _walk(self._root):
            if isinstance(n, Join):
                return n
        return None

    def _require_relational(self, verb: str):
        if self._has_aggregate:
            raise ValueError(
                f"{verb} cannot be applied after aggregate()/count()"
            )

    def _require_no_join(self, verb: str):
        if self._join_node() is not None:
            raise ValueError(f"{verb} over a join is not supported")

    def _require_unlimited(self, verb: str):
        # aggregating "any n rows" has no well-defined answer here: the
        # executor would have to fold a nondeterministic subset.  Refuse
        # rather than silently aggregate the whole input.  (limit() on
        # top of an aggregate — trimming the finalized group rows — is
        # fine and stays supported.)
        if any(isinstance(n, Limit) for n in _walk(self._root)):
            raise ValueError(f"{verb} over a limit()ed input is not supported")

    def select(self, *columns) -> "Query":
        """Project the output to ``columns`` (names; the last select
        wins).  Accepts either ``select("a", "b")`` or a single
        list/tuple."""
        self._require_relational("select()")
        if len(columns) == 1 and isinstance(columns[0], (list, tuple)):
            columns = tuple(columns[0])
        if not columns:
            raise ValueError("select() needs at least one column")
        for c in columns:
            if not isinstance(c, str):
                raise TypeError(
                    f"select() takes column names, got {type(c).__name__}"
                )
        join = self._join_node()
        if join is not None:
            # post-join projection: validate against the join's output
            # shape (probe columns + renamed build columns)
            names = {f.name for f in _join_fields(join)[2]}
            for c in columns:
                if c not in names:
                    raise KeyError(
                        f"select({c!r}): not a join output column "
                        f"(have {sorted(names)})"
                    )
            return self._derive(Project(self._root, tuple(columns)))
        if self.ds.schema is None:
            raise ValueError("select() on a dataset with no schema "
                             "(empty dataset)")
        for c in columns:
            self.ds.schema.field(c)  # validate early
        return self._derive(Project(self._root, tuple(columns)))

    def filter(self, predicate: Expr) -> "Query":
        """Keep rows matching ``predicate``; chained filters AND."""
        self._require_relational("filter()")
        if not isinstance(predicate, Expr):
            raise TypeError("filter() takes an Expr predicate")
        return self._derive(Filter(self._root, predicate))

    def limit(self, n: int) -> "Query":
        """At most ``n`` rows (any n rows: fragment completion order is
        nondeterministic, like SQL LIMIT without ORDER BY)."""
        if not isinstance(n, int) or n <= 0:
            raise ValueError(f"limit must be a positive int, got {n!r}")
        return self._derive(Limit(self._root, n))

    def aggregate(
        self,
        aggs,
        *,
        group_by: str | None = None,
        max_groups: int = DEFAULT_MAX_GROUPS,
    ) -> "Query":
        """SUM/MIN/MAX/MEAN/COUNT, optionally GROUP BY one key column."""
        self._require_relational("aggregate()")
        self._require_no_join("aggregate()")
        self._require_unlimited("aggregate()")
        specs = parse_aggs(aggs)
        if not specs:
            raise ValueError("aggregate() needs at least one aggregate")
        refs_columns = group_by is not None or any(
            s.column is not None for s in specs
        )
        if self.ds.schema is None and refs_columns:
            raise ValueError(
                "aggregate() referencing columns on a dataset with no "
                "schema (empty dataset); only COUNT(*) is answerable"
            )
        for s in specs:
            if s.column is not None:
                self.ds.schema.field(s.column)
        if group_by is not None:
            self.ds.schema.field(group_by)
        return self._derive(
            Aggregate(self._root, tuple(specs), group_by, max_groups)
        )

    def count(self) -> "Query":
        """COUNT(*): a scalar query (``to_scalar`` returns the int)."""
        self._require_relational("count()")
        self._require_no_join("count()")
        self._require_unlimited("count()")
        return self._derive(Count(self._root), scalar=True)

    def join(self, other: "Query", *, on, how: str = "inner") -> "Query":
        """Hash-join this query (the probe side) against ``other`` (the
        build side).  ``on`` is a key column name present on both sides,
        or a ``(left, right)`` pair; ``how`` is ``"inner"``, ``"left"``
        or ``"semi"`` (semi keeps probe rows with ≥1 match, emits probe
        columns only).

        Execution is storage-native for inner/semi joins: the build
        side runs first, its distinct keys become an IN-list (small) or
        bloom filter (large) conjoined into the probe scan's residual
        predicate, so storage nodes drop non-matching rows before IPC.
        Null and NaN keys never match.  A probe row's matches surface
        in build-row order, making results exactly reproducible."""
        self._require_relational("join()")
        self._require_no_join("join() (nested joins)")
        if not isinstance(other, Query):
            raise TypeError(
                f"join() takes a Query build side, got "
                f"{type(other).__name__}"
            )
        if how not in _JOIN_HOWS:
            raise ValueError(f"how must be one of {_JOIN_HOWS}, got {how!r}")
        if other._has_aggregate:
            raise ValueError(
                "join() build side cannot be an aggregate/count query"
            )
        if other._join_node() is not None:
            raise ValueError("join() build side cannot itself be a join")
        if any(isinstance(n, Limit) for n in _walk(other._root)):
            raise ValueError(
                "join() build side with limit() is not supported (the "
                "build keys would be a nondeterministic subset)"
            )
        if isinstance(on, str):
            on_left = on_right = on
        else:
            try:
                on_left, on_right = on
            except (TypeError, ValueError):
                raise ValueError(
                    "on must be a column name or a (left, right) pair"
                ) from None
        if self.ds.schema is None or other.ds.schema is None:
            raise ValueError(
                "join() needs a schema on both sides (empty dataset)"
            )
        lf = self.ds.schema.field(on_left)
        rf = other.ds.schema.field(on_right)
        compatible = lf.type == rf.type or (
            lf.type in _INT_TYPES and rf.type in _INT_TYPES
        )
        if not compatible:
            raise TypeError(
                f"join key types differ: {on_left} is {lf.type}, "
                f"{on_right} is {rf.type}"
            )
        return self._derive(
            Join(self._root, other, on_left, on_right, how)
        )

    # -- plan access -------------------------------------------------------
    def logical_plan(self) -> PlanNode:
        return self._root

    def physical_plan(self) -> PhysicalPlan:
        """Optimize + lower (no execution)."""
        return lower(_copy_plan(self._root))

    # -- execution ---------------------------------------------------------
    def _begin(self, plan: PhysicalPlan) -> ScanMetrics:
        """Fresh per-execution metrics snapshot; ``self.metrics`` always
        refers to the latest run."""
        m = ScanMetrics(
            discovery_bytes=self.ds.discovery_bytes,
            fragments_total=plan.fragments_total,
            fragments_pruned=plan.fragments_pruned,
            fragments_index_pruned=plan.fragments_index_pruned,
            metadata_answers=plan.metadata_answers,
            tenant=self.ctx.tenant,
            lane=self.ctx.lane,
        )
        self.metrics = m
        return m

    # -- join execution ----------------------------------------------------
    def _prepare_join(self):
        """Run the build side, pick the pushdown strategy, lower the
        probe side with the key filter conjoined in.  Returns
        (probe PhysicalPlan, _JoinContext, build Query, _PostOps)."""
        post, join, probe_root = _split_join(_copy_plan(self._root))
        pspec = _decompose(probe_root)
        bspec = _decompose(_copy_plan(join.build_query._root))
        probe_ds = pspec.scan.dataset

        bcols = None
        if bspec.project is not None:
            bcols = list(bspec.project)
            if join.on_right not in bcols:
                bcols.append(join.on_right)
        bq = join.build_query._derive(_linear_root(bspec, bcols))
        build_tbl = bq.to_table()

        probe_names, pairs, fields = _join_fields(join)
        kcol = build_tbl.column(join.on_right)
        valid = _key_validity(kcol)
        index: dict = {}
        for i in np.flatnonzero(valid):
            index.setdefault(kcol.values[i], []).append(int(i))
        distinct = (
            np.unique(kcol.values[valid])
            if valid.any()
            else kcol.values[:0]
        )

        strategy = _choose_strategy(
            join, pspec.limit, probe_ds.num_rows, len(build_tbl), distinct
        )
        pcols = None
        if pspec.project is not None:
            pcols = list(pspec.project)
            if join.on_left not in pcols:
                pcols.append(join.on_left)
        plan = lower(_linear_root(pspec, pcols, strategy.key_filter))
        if strategy.selectivity_hint is not None:
            for t in plan.tasks:
                t.selectivity_hint = strategy.selectivity_hint
        ctx = _JoinContext(
            join.how, join.on_left, probe_names, pairs, fields,
            build_tbl, index, distinct, strategy,
        )
        return plan, ctx, bq, post

    def _join_to_table(self) -> "Table | Shed":
        plan, ctx, bq, post = self._prepare_join()
        metrics = self._begin(plan)
        metrics.build = bq.metrics
        parts = sorted(
            stream_tasks(
                plan,
                self.fmt,
                metrics,
                max_inflight=self.num_threads,
                queue_depth=self.queue_depth,
                ctx=self.ctx,
            ),
            key=lambda p: p[0].index,
        )
        if metrics.shed is not None:
            # a shed join probe is never degraded: a partial probe side
            # would silently drop matches
            return metrics.shed
        if plan.limit is not None:
            # probe-side limit: trim the probe rows first (the budget is
            # on probe rows), then join once
            tables = [t for _, t in parts if len(t)]
            probe_tbl = (
                Table.concat(tables)
                if tables
                else empty_table(plan.dataset.schema, plan.columns)
            )
            joined = [_join_batch(probe_tbl.head(plan.limit), ctx)]
        else:
            joined = [_join_batch(t, ctx) for _, t in parts]
        tables = [t for t in joined if len(t)]
        result = (
            Table.concat(tables) if tables else _empty_join_table(ctx)
        )
        result = _apply_post(result, post)
        metrics.rows = len(result)
        return result

    def _join_batches(self, max_inflight: int | None) -> Iterator[Table]:
        plan, ctx, bq, post = self._prepare_join()
        metrics = self._begin(plan)
        metrics.build = bq.metrics

        def gen():
            if plan.limit is not None:
                # probe-side limit: materialized path (single batch out)
                parts = sorted(
                    stream_tasks(
                        plan,
                        self.fmt,
                        metrics,
                        max_inflight=max_inflight or self.num_threads,
                        queue_depth=self.queue_depth,
                        ctx=self.ctx,
                    ),
                    key=lambda p: p[0].index,
                )
                if metrics.shed is not None:
                    return
                tables = [t for _, t in parts if len(t)]
                probe_tbl = (
                    Table.concat(tables)
                    if tables
                    else empty_table(plan.dataset.schema, plan.columns)
                )
                result = _apply_post(
                    _join_batch(probe_tbl.head(plan.limit), ctx), post
                )
                metrics.rows = len(result)
                if len(result):
                    yield result
                return
            remaining = post.limit
            for _task, tbl in stream_tasks(
                plan,
                self.fmt,
                metrics,
                max_inflight=max_inflight or self.num_threads,
                queue_depth=self.queue_depth,
                ctx=self.ctx,
            ):
                part = _join_batch(tbl, ctx)
                if post.predicate is not None:
                    part = part.filter(post.predicate.evaluate(part))
                if post.project is not None:
                    part = part.select(list(post.project))
                if remaining is not None:
                    part = part.head(remaining)
                    remaining -= len(part)
                if len(part):
                    metrics.rows += len(part)
                    yield part
                if remaining is not None and remaining <= 0:
                    return  # post-limit met: cancel still-queued probes

        return gen()

    def to_batches(
        self, *, max_inflight: int | None = None
    ) -> Iterator[Table]:
        """Stream per-fragment Tables in completion order under the row
        budget; empty fragments are skipped.  Join queries stream the
        probe side against the built hash table (probe-side limits
        materialize first)."""
        if self._join_node() is not None:
            return self._join_batches(max_inflight)
        plan = lower(_copy_plan(self._root))
        if plan.kind != "scan":
            raise ValueError(
                "to_batches() streams scans; aggregate queries "
                "materialize via to_table()"
            )
        metrics = self._begin(plan)
        remaining = plan.limit

        def gen():
            nonlocal remaining
            for _task, tbl in stream_tasks(
                plan,
                self.fmt,
                metrics,
                max_inflight=max_inflight or self.num_threads,
                queue_depth=self.queue_depth,
                ctx=self.ctx,
            ):
                if remaining is not None:
                    tbl = tbl.head(remaining)
                    remaining -= len(tbl)
                if len(tbl):
                    metrics.rows += len(tbl)
                    yield tbl

        return gen()

    def to_table(self) -> "Table | Shed":
        """Materialize the result (scan plans reassemble fragments in
        plan order; aggregates finalize the merged partial state; joins
        assemble probe batches against the built hash table).

        A run that misses its ``TaskContext`` deadline returns a typed
        :class:`Shed` instead of a table; under
        ``shed_policy="degrade"`` a shed *scan* carries the fragments
        completed before the deadline as ``shed.partial``."""
        if self._join_node() is not None:
            return self._join_to_table()
        plan = lower(_copy_plan(self._root))
        metrics = self._begin(plan)
        if plan.kind == "aggregate":
            state = plan.metadata_state
            for _task, part in stream_tasks(
                plan,
                self.fmt,
                metrics,
                max_inflight=self.num_threads,
                queue_depth=self.queue_depth,
                ctx=self.ctx,
            ):
                state.merge(part)  # completion order
            if metrics.shed is not None:
                # a partial aggregate is a wrong answer, not a degraded
                # one — sheds of aggregate plans never carry a partial
                return metrics.shed
            metrics.rows = state.rows
            out = state.finalize(self.ds.schema)
            if plan.limit is not None:
                out = out.head(plan.limit)
            return out
        parts = sorted(
            stream_tasks(
                plan,
                self.fmt,
                metrics,
                max_inflight=self.num_threads,
                queue_depth=self.queue_depth,
                ctx=self.ctx,
            ),
            key=lambda p: p[0].index,
        )
        if metrics.shed is not None:
            if self.ctx.shed_policy == "degrade":
                tables = [t for _, t in parts if len(t)]
                metrics.shed.partial = (
                    Table.concat(tables)
                    if tables
                    else empty_table(self.ds.schema, plan.columns)
                )
            return metrics.shed
        tables = [t for _, t in parts if len(t)]
        result = (
            Table.concat(tables)
            if tables
            else empty_table(self.ds.schema, plan.columns)
        )
        if plan.limit is not None:
            result = result.head(plan.limit)
        metrics.rows = len(result)
        return result

    def to_scalar(self):
        """Run a single-cell query (e.g. ``count()``) to its scalar —
        or the :class:`Shed` if the run missed its deadline."""
        out = self.to_table()
        if isinstance(out, Shed):
            return out
        if len(out) != 1 or len(out.schema) != 1:
            raise ValueError(
                f"to_scalar() needs a 1x1 result, got "
                f"{len(out)}x{len(out.schema)}"
            )
        v = out.columns[0].values[0]
        return v.item() if isinstance(v, np.generic) else v

    # -- explain -----------------------------------------------------------
    def _physical_lines(
        self, plan: PhysicalPlan, max_fragments: int
    ) -> list[str]:
        lines = ["== physical plan =="]
        budget = (
            f", row_budget={plan.limit}" if plan.limit is not None else ""
        )
        qos = ""
        if self.ctx.tenant != "default" or self.ctx.deadline_s is not None:
            qos = f", tenant={self.ctx.tenant}/{self.ctx.lane}"
            if self.ctx.deadline_s is not None:
                qos += (f", deadline={self.ctx.deadline_s * 1e3:.0f}ms"
                        f"/{self.ctx.shed_policy}")
        lines.append(
            f"executor: streaming, format={self.fmt.name}, "
            f"max_inflight={self.num_threads}, "
            f"queue_depth={self.queue_depth}/OSD{budget}{qos}"
        )
        idx = (
            f" ({plan.fragments_index_pruned} by bloom index)"
            if plan.fragments_index_pruned
            else ""
        )
        lines.append(
            f"fragments: {plan.fragments_total} total, "
            f"{plan.fragments_pruned} pruned{idx}, "
            f"{plan.metadata_answers} metadata-answered, "
            f"{len(plan.tasks)} tasks"
        )
        shown = 0
        for task in plan.tasks:
            if shown >= max_fragments:
                lines.append(f"  ... (+{len(plan.tasks) - shown} more tasks)")
                break
            frag = task.fragment
            where = self.fmt.explain_task(self.ds.fs, task)
            lim = f" limit<={task.limit}" if task.limit is not None else ""
            lines.append(
                f"  [{task.index}] {task.kind} {frag.path}#{frag.obj_idx} "
                f"rows={frag.num_rows} pred={render_expr(task.predicate)}"
                f"{lim} | {where}"
            )
            shown += 1
        return lines

    def _explain_join(self, *, max_fragments: int) -> str:
        plan, ctx, _bq, _post = self._prepare_join()
        s = ctx.strategy
        lines = ["== logical plan =="]
        lines += render_plan(self._root)
        lines.append("== join ==")
        lines.append(
            f"- strategy: hash {s.how} join on {s.on_left} = {s.on_right}; "
            f"build side {s.build_rows} rows, {s.distinct_keys} distinct "
            "keys"
        )
        if s.pushdown == "inlist":
            lines.append(
                f"- semijoin-pushdown: IN-list({s.distinct_keys} keys) "
                f"conjoined into probe scan (selectivity hint "
                f"{s.selectivity_hint:.4f})"
            )
        elif s.pushdown == "bloom":
            bf = s.key_filter
            lines.append(
                f"- semijoin-pushdown: bloom({bf.num_bits} bits, "
                f"{bf.num_hashes} hashes, digest={bf.digest()}) conjoined "
                f"into probe scan (selectivity hint "
                f"{s.selectivity_hint:.4f})"
            )
        else:
            lines.append(f"- semijoin-pushdown: none ({s.reason})")
        lines.append("== optimizer ==")
        lines += [f"- {p}" for p in plan.passes]
        lines += self._physical_lines(plan, max_fragments)
        pruned = [d for d in plan.decisions if d.action == "pruned"]
        shown = 0
        for d in pruned:
            if shown >= max_fragments:
                lines.append(f"  ... (+{len(pruned) - shown} more pruned)")
                break
            lines.append(
                f"  [-] pruned {d.fragment.path}#{d.fragment.obj_idx} "
                f"({d.detail})"
            )
            shown += 1
        return "\n".join(lines)

    def explain(self, *, max_fragments: int = 12) -> str:
        """Render the logical plan, the optimizer passes, and the lowered
        physical tasks with per-fragment placement/cache/hedge state.

        Join plans add a ``== join ==`` section (strategy + pushdown
        decision); rendering it *runs the build side*, because the
        pushed filter is its keys."""
        if self._join_node() is not None:
            return self._explain_join(max_fragments=max_fragments)
        lines = ["== logical plan =="]
        lines += render_plan(self._root)
        plan = lower(_copy_plan(self._root))
        lines.append("== optimizer ==")
        lines += [f"- {p}" for p in plan.passes]
        lines += self._physical_lines(plan, max_fragments)
        pruned = [d for d in plan.decisions if d.action == "pruned"]
        shown = 0
        for d in pruned:
            if shown >= max_fragments:
                lines.append(f"  ... (+{len(pruned) - shown} more pruned)")
                break
            lines.append(
                f"  [-] pruned {d.fragment.path}#{d.fragment.obj_idx} "
                f"({d.detail})"
            )
            shown += 1
        return "\n".join(lines)


def _copy_plan(root: PlanNode) -> PlanNode:
    """Executions must not mutate the builder's logical plan (passes
    annotate Scan nodes, the executor refreshes task limits)."""
    if isinstance(root, Scan):
        return Scan(root.dataset, root.columns)
    kids = root.children()
    clone = dataclasses.replace(root)
    if kids:
        clone.input = _copy_plan(kids[0])  # type: ignore[attr-defined]
    return clone
