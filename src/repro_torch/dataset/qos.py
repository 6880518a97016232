"""Multi-tenant QoS: the TaskContext boundary, tenant registry, and the
typed ``Shed`` result.

One dataclass — :class:`TaskContext` — is how *every* task option
reaches the execution stack.  It collapses the kwarg tail that used to
grow on ``FileFormat.scan_fragment`` / ``aggregate_fragment`` /
``execute_task`` (``admission=``, ``limit=``, ``selectivity_hint=``, and
now tenant / lane / deadline) into one argument with one signature
across all three formats, the adaptive scheduler, and the streaming
executor.

:class:`TenantRegistry` is the control plane: it holds each tenant's
:class:`TenantSpec` (weight, priority lane, deadline, cache budget),
hands out one shared
:class:`~repro_torch.dataset.admission.AdmissionController` per cluster so
every tenant's scans are arbitrated by the same weighted-fair slot
allocator, and rolls completed runs up into ``by_tenant()``.

A query that cannot meet its deadline returns a :class:`Shed` — a typed
result carrying tenant, lane, reason, and progress — instead of raising
from a worker thread; under ``shed_policy="degrade"`` a scan's ``Shed``
also carries the partial table assembled before the deadline hit.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Any

from repro_torch.dataset.admission import (AdmissionController, DEFAULT_LANE,
                                     LANES)

__all__ = ["INGEST_TENANT", "LANES", "Shed", "TaskContext", "TenantRegistry",
           "TenantSpec", "as_task_context", "ingest_context",
           "resolve_context"]

_UNSET = object()

#: The tenant name training ingest runs as by default — a bulk-lane
#: large-batch reader that weighted-fair admission arbitrates against
#: interactive scanners (see :func:`ingest_context`).
INGEST_TENANT = "ingest"


@dataclasses.dataclass
class TaskContext:
    """Everything a fragment task runs *as*: identity (tenant, lane,
    weight), obligations (deadline, shed policy), and the per-task
    options the executor threads through (admission controller, live row
    budget, selectivity hint).  ``TaskContext()`` is the default tenant
    and reproduces the historic single-tenant behavior exactly."""

    tenant: str = "default"
    lane: str = DEFAULT_LANE
    weight: float = 1.0
    deadline_s: float | None = None
    shed_policy: str = "reject"          # "reject" | "degrade"
    admission: AdmissionController | None = None
    limit: int | None = None
    selectivity_hint: float | None = None
    registry: "TenantRegistry | None" = None
    started_at: float | None = None      # perf_counter at execution start

    def elapsed_s(self) -> float:
        if self.started_at is None:
            return 0.0
        return time.perf_counter() - self.started_at

    def remaining_s(self) -> float | None:
        """Seconds left on the deadline (None = no deadline armed)."""
        if self.deadline_s is None or self.started_at is None:
            return None
        return self.deadline_s - self.elapsed_s()


@dataclasses.dataclass
class Shed:
    """A query rejected (or degraded) because it could not meet its
    deadline at current load — returned by the run verbs in place of a
    table, never raised.  ``partial`` carries the fragments completed
    before the shed under ``shed_policy="degrade"`` (scans only)."""

    tenant: str
    lane: str
    reason: str
    deadline_s: float
    elapsed_s: float
    completed_tasks: int
    total_tasks: int
    partial: Any = None

    def __str__(self):
        return (f"Shed(tenant={self.tenant!r}, lane={self.lane}, "
                f"{self.completed_tasks}/{self.total_tasks} tasks in "
                f"{self.elapsed_s * 1e3:.1f}ms of {self.deadline_s * 1e3:.1f}"
                f"ms: {self.reason})")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's registered QoS contract."""

    name: str
    weight: float = 1.0
    lane: str = DEFAULT_LANE
    deadline_s: float | None = None
    cache_bytes: int | None = None       # per-tenant result-cache budget
    shed_policy: str = "reject"


class TenantRegistry:
    """The tenants sharing a cluster and the machinery they share.

    ``register()`` declares a tenant; ``context()`` mints the
    :class:`TaskContext` its queries run under; ``controller()`` returns
    the one :class:`AdmissionController` per cluster through which every
    registered tenant's storage work is arbitrated (the whole point —
    per-scan controllers cannot see each other's load).  Completed runs
    are recorded automatically by the executor; ``by_tenant()`` merges
    those rollups with the controllers' live admission stats."""

    def __init__(self, *, slots_per_osd: int = 4, preempt_slack: int = 1):
        self.slots_per_osd = slots_per_osd
        self.preempt_slack = preempt_slack
        self._specs: dict[str, TenantSpec] = {
            "default": TenantSpec("default")}
        self._controllers: dict[int, AdmissionController] = {}
        self._rollup: dict[str, dict] = {}
        self._lock = threading.Lock()

    def register(self, name: str, *, weight: float = 1.0,
                 lane: str = DEFAULT_LANE,
                 deadline_s: float | None = None,
                 cache_bytes: int | None = None,
                 shed_policy: str = "reject") -> TenantSpec:
        if lane not in LANES:
            raise ValueError(f"lane must be one of {LANES}, got {lane!r}")
        if not weight > 0:
            raise ValueError(f"weight must be > 0, got {weight!r}")
        if shed_policy not in ("reject", "degrade"):
            raise ValueError(
                f"shed_policy must be 'reject' or 'degrade', "
                f"got {shed_policy!r}")
        spec = TenantSpec(name, weight, lane, deadline_s, cache_bytes,
                          shed_policy)
        with self._lock:
            self._specs[name] = spec
        return spec

    def ensure(self, name: str, **kwargs) -> TenantSpec:
        """``register()`` if the tenant is not yet known, else the
        existing spec unchanged — idempotent registration for callers
        (like the ingest reader) that may race or restart."""
        with self._lock:
            spec = self._specs.get(name)
        if spec is not None:
            return spec
        return self.register(name, **kwargs)

    def spec(self, name: str) -> TenantSpec:
        """The registered spec, or an unweighted bulk default for an
        unknown tenant (unregistered traffic is assumed analytics)."""
        with self._lock:
            spec = self._specs.get(name)
        return spec if spec is not None else TenantSpec(name)

    def context(self, name: str, *, deadline_s=_UNSET) -> TaskContext:
        """A TaskContext running as tenant ``name`` under its registered
        contract; ``deadline_s=`` overrides the spec's per-query."""
        s = self.spec(name)
        return TaskContext(
            tenant=s.name, lane=s.lane, weight=s.weight,
            deadline_s=s.deadline_s if deadline_s is _UNSET else deadline_s,
            shed_policy=s.shed_policy, registry=self)

    def controller(self, store) -> AdmissionController:
        """The shared per-cluster admission controller (created on first
        use, one per ObjectStore)."""
        with self._lock:
            ctrl = self._controllers.get(id(store))
            if ctrl is None:
                ctrl = AdmissionController(
                    store, self.slots_per_osd,
                    preempt_slack=self.preempt_slack)
                self._controllers[id(store)] = ctrl
            return ctrl

    def record(self, metrics) -> None:
        """Fold one completed run's ScanMetrics into the per-tenant
        rollup (called by the streaming executor)."""
        with self._lock:
            r = self._rollup.setdefault(metrics.tenant, {
                "runs": 0, "rows": 0, "wire_bytes": 0, "wall_s": 0.0,
                "cache_hits": 0, "sheds": 0})
            r["runs"] += 1
            # recorded from the executor's finally, before the run verb
            # trims/sets metrics.rows — sum the per-task counts instead
            r["rows"] += metrics.rows or sum(t.rows_out
                                             for t in metrics.tasks)
            r["wire_bytes"] += metrics.wire_bytes
            r["wall_s"] += metrics.wall_s
            r["cache_hits"] += metrics.cache_hits
            r["sheds"] += 1 if metrics.shed is not None else 0

    def by_tenant(self) -> dict:
        """Per-tenant QoS report: run rollups merged with the live
        admission stats of every controller this registry owns."""
        out: dict[str, dict] = {}
        with self._lock:
            for tenant, r in self._rollup.items():
                d = dict(r)
                d["wall_s"] = round(d["wall_s"], 6)
                out[tenant] = d
            controllers = list(self._controllers.values())
        for ctrl in controllers:
            for tenant, st in ctrl.stats()["by_tenant"].items():
                d = out.setdefault(tenant, {})
                adm = d.setdefault("admission", {
                    "admitted": 0, "waits": 0, "wait_s": 0.0,
                    "preemptions": 0, "sheds": 0})
                for k, v in st.items():
                    adm[k] = round(adm[k] + v, 6) if k == "wait_s" \
                        else adm[k] + v
        return out


def ingest_context(registry: TenantRegistry | None = None, *,
                   tenant: str = INGEST_TENANT,
                   weight: float = 1.0) -> TaskContext:
    """The TaskContext a training reader scans under: a ``bulk``-lane
    tenant.  With a registry, the tenant is (idempotently) registered
    and the context carries the registry, so ingest admission goes
    through the cluster's shared weighted-fair controller and interactive
    tenants keep their priority-lane edge.  Without one, a standalone
    bulk context (run-private admission, historic behavior)."""
    if registry is None:
        return TaskContext(tenant=tenant, lane="bulk", weight=weight)
    registry.ensure(tenant, weight=weight, lane="bulk")
    return registry.context(tenant)


def as_task_context(value) -> TaskContext:
    """Normalize the ``tenant=`` argument of ``Dataset.query`` /
    ``Scanner``: None (default tenant), a tenant name, or a full
    TaskContext."""
    if value is None:
        return TaskContext()
    if isinstance(value, TaskContext):
        return value
    if isinstance(value, str):
        return TaskContext(tenant=value)
    raise TypeError(
        f"tenant= takes a TaskContext, a tenant name, or None; "
        f"got {type(value).__name__}")


def resolve_context(ctx=None, legacy: dict | None = None) -> TaskContext:
    """The one-release compatibility shim behind every format entry
    point: normalizes ``ctx`` to a TaskContext and adapts the old kwarg
    tail (``admission=`` / ``limit=`` / ``selectivity_hint=``) — or an
    AdmissionController passed positionally where ``ctx`` now lives —
    with a DeprecationWarning."""
    if ctx is not None and not isinstance(ctx, TaskContext):
        if hasattr(ctx, "admit_object"):   # old positional admission=
            warnings.warn(
                "passing an AdmissionController positionally is "
                "deprecated; pass a TaskContext (TaskContext(admission=...))",
                DeprecationWarning, stacklevel=3)
            ctx = TaskContext(admission=ctx)
        else:
            raise TypeError(
                f"ctx must be a TaskContext or None, "
                f"got {type(ctx).__name__}")
    if legacy:
        unknown = set(legacy) - {"admission", "limit", "selectivity_hint"}
        if unknown:
            raise TypeError(
                f"unexpected keyword arguments {sorted(unknown)}; task "
                f"options travel on TaskContext")
        warnings.warn(
            "the admission=/limit=/selectivity_hint= kwarg tail is "
            "deprecated; pass one TaskContext instead "
            "(repro_torch.dataset.qos.TaskContext)",
            DeprecationWarning, stacklevel=3)
        ctx = dataclasses.replace(
            ctx if ctx is not None else TaskContext(),
            **{k: v for k, v in legacy.items() if v is not None})
    return ctx if ctx is not None else TaskContext()
