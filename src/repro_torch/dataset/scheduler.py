"""Adaptive scan scheduling: per-fragment placement, hedging, result cache.

The paper's limitation (§4, Fig. 5/6) is that the offload decision is
*static*: ``PushdownParquetFormat`` always scans on the storage node,
``ParquetFormat`` always on the client — but pushdown only wins while the
storage-side CPUs have headroom.  Once OSDs saturate (many clients, or a
straggling node), shipping raw bytes and decoding locally is faster.

:class:`ScanScheduler` turns that decision into a feedback loop, per
fragment, at scan time:

placement
    Price both placements per fragment as amortized cost on the
    bottleneck resource (the same k-server view as
    ``storage.perfmodel``), and run the scan wherever the estimate is
    lower:

    * ``est_storage = max(decode_s * pressure / storage_threads,
      ipc_out_bytes / net_bw)`` — storage CPU is shared by every tenant
      (pressure scales with their in-flight queue depth), the client NIC
      carries only the filtered result;
    * ``est_client = max(raw_in_bytes / net_bw, decode_s /
      client_threads)`` — private client resources, but the NIC carries
      the raw bytes and the client burns the decode itself.

    ``pressure`` comes from :meth:`ObjectStore.load_of` — straggle factor
    scaled by in-flight queue depth — minimized over the fragment's up
    replicas (hedging can reach the fastest one).  Decode rates are
    estimated *per side*: the storage nodes always run the host (numpy)
    decode path, while the client runs whatever ``decode_backend`` its
    format carries (by default the CUDA engine on the card), so one
    shared EWMA would average two different
    regimes into a number that prices both sides wrong.  Each side's
    EWMA is seeded with its backend's ``decode_rate_prior``; a completed
    scan updates its own side's estimate, and also the other side's when
    the client runs the host (numpy) engine — the same code the OSD
    runs, so observations transfer.  The output-size ratio is a property
    of the data, not the backend, so it stays shared.

hedging
    Storage-side scans carry a deadline of ``hedge_multiplier`` x the
    rolling *median per-byte* storage-scan latency, scaled by the
    fragment's size (size-normalized so big fragments aren't mistaken
    for stragglers; median rather than a high quantile because a
    straggler serving >5% of scans would drag a p95/p99 deadline above
    its own latency and never get hedged).  A call exceeding the
    deadline is re-issued to a replica and the faster result wins
    (``DirectObjectAccess.call_hedged``).  If the storage path fails
    outright (all replicas down mid-scan) the fragment falls back to the
    client-side path.

result cache
    Decoded results are kept as Arrow-IPC bytes in an LRU
    (:class:`ResultCache`) keyed by
    ``(object, version, footer_hash, row_group, columns, predicate_json)``.
    Repeat scans — the common case for dashboard / training-epoch
    workloads — are served without touching the storage tier at all.
    Overwrites bump the object version (``ObjectStore.version_of``) so a
    stale result can never be served.

The scheduler is exposed through ``AdaptiveFormat`` (``format="adaptive"``
on :meth:`Dataset.scanner`), so it drops into the existing Dataset API the
same way the two static placements do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import threading
import time
from collections import OrderedDict, deque
from typing import Sequence

from repro_torch.aformat.aggregate import (AggState, DEFAULT_MAX_GROUPS,
                                     needed_columns, partial_aggregate)
from repro_torch.aformat.expressions import Expr
from repro_torch.aformat.table import Table
from repro_torch.dataset.admission import LANE_PRIORITY
from repro_torch.dataset.format import (ParquetFormat, TaskRecord, agg_payload,
                                  count_state, is_degenerate_count,
                                  parse_agg_reply, scan_payload)
from repro_torch.dataset.fragment import Fragment
from repro_torch.dataset.qos import TaskContext, resolve_context
from repro_torch.storage.cephfs import CephFS, DirectObjectAccess
from repro_torch.storage.objstore import ObjectNotFound, OSDDownError

GBE10 = 10e9 / 8                 # modeled client NIC (paper testbed)
DEFAULT_DECODE_RATE = 150e6      # storage-side (host/numpy) bytes/s prior
                                 # until the EWMA warms up; the client
                                 # side is seeded from its decode
                                 # backend's own decode_rate_prior
DEFAULT_OUT_RATIO = 1.0          # decoded-IPC-bytes per stored-byte prior:
                                 # neutral, so the cold-start estimates tie
                                 # and the tie-break prefers storage-side
                                 # (no exploration penalty on an idle
                                 # cluster; the first scan teaches the
                                 # real ratio either way)


def modeled_latency(t: TaskRecord, net_bw: float = GBE10) -> float:
    """Per-fragment scan latency under the paper's cluster model: measured
    CPU seconds plus modeled wire time (storage-device time is not modeled,
    matching ``storage.perfmodel``)."""
    if t.cached:
        return t.client_cpu_s
    if t.where == "client":
        return t.wire_bytes / net_bw + t.cpu_s
    return t.cpu_s + t.wire_bytes / net_bw + t.client_cpu_s


class _Ewma:
    """Exponentially weighted running estimate with a cold-start prior."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self._v: float | None = None

    def update(self, x: float):
        self._v = x if self._v is None else \
            self.alpha * x + (1 - self.alpha) * self._v

    def value(self, default: float) -> float:
        return default if self._v is None else self._v


class _CacheShard:
    __slots__ = ("od", "nbytes", "budget")

    def __init__(self, budget: int):
        self.od: OrderedDict[tuple, bytes] = OrderedDict()
        self.nbytes = 0
        self.budget = budget


class ResultCache:
    """Byte-bounded LRU of decoded scan results (Arrow IPC bytes), with
    per-tenant budgets.

    Keys carry the object version, so an overwrite invalidates implicitly:
    the new scan misses, and the stale entry ages out of the LRU.

    Each tenant's entries live in their own LRU shard bounded by that
    tenant's registered ``cache_bytes`` budget (default: the full
    capacity), and eviction under a tenant's budget only recycles *that
    tenant's* entries — a bulk scanner churning through cold data cannot
    evict the interactive working set.  ``capacity_bytes`` stays the
    global backstop: if the shards together outgrow it, the shard using
    the largest fraction of its own budget shrinks first.  A single
    (default) tenant therefore behaves exactly like the historic
    one-LRU cache."""

    def __init__(self, capacity_bytes: int = 256 << 20):
        self.capacity_bytes = capacity_bytes
        self._shards: dict[str, _CacheShard] = {}
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: tuple, tenant: str = "default") -> bytes | None:
        with self._lock:
            sh = self._shards.get(tenant)
            data = sh.od.get(key) if sh is not None else None
            if data is None:
                self.misses += 1
                return None
            sh.od.move_to_end(key)
            self.hits += 1
            return data

    def _evict_one(self, sh: _CacheShard):
        _, ev = sh.od.popitem(last=False)
        sh.nbytes -= len(ev)
        self._bytes -= len(ev)
        self.evictions += 1

    def put(self, key: tuple, data: bytes, tenant: str = "default",
            budget: int | None = None):
        with self._lock:
            sh = self._shards.get(tenant)
            if sh is None:
                sh = _CacheShard(self.capacity_bytes)
                self._shards[tenant] = sh
            if budget is not None:
                sh.budget = min(budget, self.capacity_bytes)
            if len(data) > sh.budget:
                return
            old = sh.od.pop(key, None)
            if old is not None:
                sh.nbytes -= len(old)
                self._bytes -= len(old)
            sh.od[key] = data
            sh.nbytes += len(data)
            self._bytes += len(data)
            while sh.nbytes > sh.budget and sh.od:
                self._evict_one(sh)
            while self._bytes > self.capacity_bytes:
                pool = [s for s in self._shards.values() if s.od]
                if not pool:
                    break
                self._evict_one(max(pool, key=lambda s:
                                    (s.nbytes / max(1, s.budget), s.nbytes)))

    def contains(self, key: tuple, tenant: str | None = None) -> bool:
        """Membership probe that neither recences the entry nor perturbs
        the hit/miss counters — ``explain()`` uses it.  Without a tenant
        it answers "cached for anyone?"."""
        with self._lock:
            if tenant is not None:
                sh = self._shards.get(tenant)
                return sh is not None and key in sh.od
            return any(key in s.od for s in self._shards.values())

    def __len__(self):
        return sum(len(s.od) for s in self._shards.values())

    @property
    def nbytes(self) -> int:
        return self._bytes

    def stats(self) -> dict:
        with self._lock:
            return {"entries": sum(len(s.od)
                                   for s in self._shards.values()),
                    "bytes": self._bytes,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}

    def by_tenant(self) -> dict:
        """Per-tenant shard occupancy (entries / bytes / budget)."""
        with self._lock:
            return {t: {"entries": len(s.od), "bytes": s.nbytes,
                        "budget": s.budget}
                    for t, s in self._shards.items()}


@dataclasses.dataclass
class PlacementEstimate:
    """One placement decision with the estimates that produced it."""

    where: str                   # "osd" or "client"
    est_osd_s: float
    est_client_s: float
    in_bytes: int
    pressure: float


class ScanScheduler:
    """Feedback-controlled fragment placement over one cluster (CephFS).

    Thread-safe; intended to be shared across scans so the latency
    history, rate estimators, and result cache persist (a Scanner is
    per-query, the scheduler is per-cluster).
    """

    def __init__(self, fs: CephFS, *, net_bw: float = GBE10,
                 client_threads: int = 16,
                 cache_bytes: int = 256 << 20,
                 hedge_multiplier: float = 3.0,
                 hedge_min_s: float = 1e-3,
                 history: int = 256,
                 decode_backend=None):
        self.fs = fs
        self.store = fs.store
        self.doa = DirectObjectAccess(fs)
        self.net_bw = net_bw
        self.client_threads = client_threads
        self.cache = ResultCache(cache_bytes)
        self.hedge_multiplier = hedge_multiplier
        self.hedge_min_s = hedge_min_s
        # the client side scans through this decode engine; the storage
        # side always runs the host path (scan_op on the OSD), so the
        # two sides' decode rates are estimated separately, each seeded
        # with its own backend's prior
        self._client_fmt = ParquetFormat(decode_backend=decode_backend)
        self._decode_rate_osd = _Ewma()      # bytes/s, storage-side host
        self._decode_rate_client = _Ewma()   # bytes/s, client backend
        self._client_rate_prior = \
            self._client_fmt.decode_backend.decode_rate_prior
        self._out_ratio = _Ewma()            # ipc-out bytes per in byte
        self._osd_lat: deque[float] = deque(maxlen=history)  # s per byte
        self._lock = threading.Lock()
        self.decisions = {"osd": 0, "client": 0, "cache": 0}
        self.hedges = 0
        self.fallbacks = 0
        self.spills = 0         # agg_op group-cardinality spill-to-scan

    # -- signals & estimates ---------------------------------------------------
    def _object_name(self, frag: Fragment) -> str:
        return self.fs.object_names(frag.path)[frag.obj_idx]

    def _frag_bytes(self, frag: Fragment) -> int:
        """Stored bytes this fragment's scan must touch."""
        if frag.footer is not None:                  # striped: rebased meta
            return frag.footer.row_groups[0].total_bytes
        if frag.client_meta is not None:             # flat: parent footer
            return frag.client_meta.row_groups[frag.client_rg_index] \
                .total_bytes
        # split: the object *is* the row group (plus a small footer)
        return self.store.stat(self._object_name(frag))

    def pressure_of(self, frag: Fragment,
                    ctx: TaskContext | None = None) -> float:
        """Min pressure over the fragment's up replicas: hedging lets the
        storage path reach the fastest copy, so the optimistic replica is
        the one the estimate should price.  With a QoS context the
        pressure is *lane-visible* (see :meth:`_tenant_pressure`)."""
        name = self._object_name(frag)
        loads = [self.store.load_of(o) for o in self.store.acting_set(name)
                 if not o.down]
        if not loads:
            return float("inf")
        return min(self._tenant_pressure(l, ctx) for l in loads)

    @staticmethod
    def _tenant_pressure(load, ctx: TaskContext | None) -> float:
        """Per-tenant placement pressure: a tenant prices an OSD by the
        in-flight work that can actually delay it — its own lane and
        higher-priority lanes.  Admission arbitration keeps lower lanes
        from queuing ahead of it, so one bulk tenant's flood on a hot
        OSD must not flip everyone's pushdown-vs-client crossover.
        Unattributed external load (``OSD.background_load``) is assumed
        bulk.  Without a QoS registry on the context the classic
        every-tenant pressure returns unchanged."""
        if ctx is None or ctx.registry is None \
                or load.by_tenant is None or load.down:
            return load.pressure
        rank = LANE_PRIORITY.get(ctx.lane, 1)
        visible = sum(n for (_t, lane), n in load.by_tenant.items()
                      if LANE_PRIORITY.get(lane, 1) <= rank)
        if rank >= 1:                       # bulk and background lanes
            visible += load.external
        qd = visible / max(1, load.threads)
        return load.straggle_factor * (1.0 + qd)

    def storage_threads(self) -> int:
        """Aggregate scan-thread capacity of the up part of the cluster."""
        return sum(o.threads for o in self.store.osds if not o.down) or 1

    def estimate(self, frag: Fragment, *,
                 out_bytes: float | None = None,
                 selectivity_hint: float | None = None,
                 ctx: TaskContext | None = None) -> PlacementEstimate:
        """Price both placements for this fragment from live load and the
        learned decode-rate / selectivity estimates.

        Costs are amortized over the parallelism each side offers
        (k-server view, as in ``storage.perfmodel``): storage decode
        spreads over the cluster's threads but is inflated by multi-tenant
        pressure; client decode spreads over the client's private threads
        but its NIC must carry the raw bytes.  ``out_bytes`` overrides the
        learned selectivity estimate when the caller knows the result size
        (an aggregate ships back a constant few bytes);
        ``selectivity_hint`` scales the learned output ratio instead when
        the caller knows the surviving-row fraction (a semi-join filter
        pushed into the scan), so the reduced reply bytes price in before
        any EWMA history exists.

        Each side is priced with its *own* decode rate: the storage side
        with the host-path estimate, the client side with its decode
        backend's — a client whose backend carries a faster prior prices
        its decode cheaper, so the crossover to client placement moves
        earlier, before a single observation lands."""
        in_bytes = self._frag_bytes(frag)
        rate_osd = self._decode_rate_osd.value(DEFAULT_DECODE_RATE)
        rate_client = self._decode_rate_client.value(
            self._client_rate_prior)
        decode_osd_s = in_bytes / max(rate_osd, 1.0)
        decode_client_s = in_bytes / max(rate_client, 1.0)
        if out_bytes is None:
            out_bytes = in_bytes * self._out_ratio.value(DEFAULT_OUT_RATIO)
            if selectivity_hint is not None:
                out_bytes *= min(1.0, max(0.0, selectivity_hint))
        pressure = self.pressure_of(frag, ctx)
        est_osd = max(decode_osd_s * pressure / self.storage_threads(),
                      out_bytes / self.net_bw)
        est_client = max(in_bytes / self.net_bw,
                         decode_client_s / max(1, self.client_threads))
        where = "osd" if est_osd <= est_client else "client"
        return PlacementEstimate(where, est_osd, est_client, in_bytes,
                                 pressure)

    def _observe(self, side: str, in_bytes: int, decode_s: float,
                 out_bytes: int):
        """Feed one completed scan into ``side``'s decode-rate EWMA and
        the shared output-ratio EWMA (a property of the data).  When the
        client runs the host (numpy) engine — the same code the OSD
        runs — the observation teaches *both* estimators; with an
        accelerator backend the engines differ, so observations stay on
        their own side."""
        if decode_s > 0 and in_bytes > 0:
            rate = in_bytes / decode_s
            host_client = self._client_fmt.decode_backend.name == "numpy"
            with self._lock:
                if host_client or side == "osd":
                    self._decode_rate_osd.update(rate)
                if host_client or side == "client":
                    self._decode_rate_client.update(rate)
                self._out_ratio.update(out_bytes / in_bytes)

    def _hedge_deadline(self, in_bytes: int) -> float | None:
        """``hedge_multiplier`` x the median recent *per-byte* storage-scan
        latency, scaled by this fragment's size — size-normalized so a
        legitimately large fragment is not mistaken for a straggler, and
        median-based so stragglers polluting the history cannot raise the
        bar above themselves.  None while the history is too cold."""
        with self._lock:
            if len(self._osd_lat) < 8:
                return None
            rate = sorted(self._osd_lat)[len(self._osd_lat) // 2]
            return max(self.hedge_min_s,
                       self.hedge_multiplier * rate * max(1, in_bytes))

    # -- cache keys -------------------------------------------------------------
    def cache_key(self, frag: Fragment, columns: Sequence[str] | None,
                  predicate: Expr | None,
                  limit: int | None = None) -> tuple:
        name = self._object_name(frag)
        version = self.store.version_of(name)
        footer_hash = ""
        if frag.footer is not None:
            footer_hash = hashlib.blake2s(frag.footer.serialize(),
                                          digest_size=8).hexdigest()
        cols = tuple(columns) if columns is not None else None
        pred_json = json.dumps(predicate.to_json(), sort_keys=True) \
            if predicate is not None else ""
        if len(pred_json) > 160:
            # semi-join key filters (IN-lists, bloom bit arrays) can be
            # kilobytes of JSON; key on a content digest instead so cache
            # entries stay cheap while different filters never collide
            pred_json = "digest:" + hashlib.blake2s(
                pred_json.encode(), digest_size=16).hexdigest()
        # limit is part of the identity: a truncated result must never be
        # served to an unbounded scan (or to a larger budget)
        return (name, version, footer_hash, frag.rg_in_object, cols,
                pred_json, limit)

    def agg_cache_key(self, frag: Fragment, specs, group_by,
                      max_groups: int, predicate: Expr | None) -> tuple:
        spec_key = ("__agg__",
                    json.dumps([s.to_json() for s in specs]
                               + [group_by, max_groups], sort_keys=True))
        return self.cache_key(frag, spec_key, predicate)

    # -- the scan ---------------------------------------------------------------
    def scan_fragment(self, frag: Fragment,
                      columns: Sequence[str] | None,
                      predicate: Expr | None,
                      ctx: TaskContext | None = None,
                      **legacy) -> tuple[Table, TaskRecord]:
        """Cache lookup -> placement decision -> (hedged) execution.

        Returns the same (Table, TaskRecord) contract as a FileFormat, so
        ``AdaptiveFormat`` is a drop-in placement.  ``ctx`` carries every
        task option: its admission controller bounds in-flight work per
        OSD (a cache hit never takes a slot), its ``limit`` rides into
        ``scan_op`` (the node stops decoding at the budget) and keys the
        result cache, and its ``selectivity_hint`` (a semi-join filter's
        expected surviving fraction) prices the placement only — results
        are identical either way, so it stays out of the cache key.  The
        tenant identity keys the cache shard and tags the storage call
        for per-tenant load accounting."""
        ctx = resolve_context(ctx, legacy)
        key = self.cache_key(frag, columns, predicate, ctx.limit)
        ipc = self.cache.get(key, tenant=ctx.tenant)
        if ipc is not None:
            t0 = time.perf_counter()
            tbl = Table.from_ipc(ipc)
            cpu = time.perf_counter() - t0
            with self._lock:
                self.decisions["cache"] += 1
            rec = TaskRecord("client", -1, cpu, 0, cpu, len(tbl),
                             cached=True)
            return tbl, rec

        est = self.estimate(frag, selectivity_hint=ctx.selectivity_hint,
                            ctx=ctx)
        with self._admit(frag, ctx):
            if est.where == "osd":
                try:
                    tbl, rec, ipc = self._scan_osd(frag, columns,
                                                   predicate, est, ctx)
                except (OSDDownError, ObjectNotFound):
                    # storage path unavailable (e.g. every replica died
                    # after the estimate): client-side reads via failover
                    with self._lock:
                        self.fallbacks += 1
                    tbl, rec, ipc = self._scan_client(frag, columns,
                                                      predicate, ctx)
            else:
                tbl, rec, ipc = self._scan_client(frag, columns, predicate,
                                                  ctx)
        self._cache_put(key, ipc, ctx)
        return tbl, rec

    def _admit(self, frag: Fragment, ctx: TaskContext):
        if ctx.admission is None:
            return contextlib.nullcontext()
        return ctx.admission.admit_object(self._object_name(frag), ctx)

    def _cache_put(self, key: tuple, data: bytes, ctx: TaskContext):
        budget = None
        if ctx.registry is not None:
            budget = ctx.registry.spec(ctx.tenant).cache_bytes
        self.cache.put(key, data, tenant=ctx.tenant, budget=budget)

    def _scan_osd(self, frag, columns, predicate, est,
                  ctx: TaskContext | None = None):
        ctx = ctx if ctx is not None else TaskContext()
        limit = ctx.limit
        payload = scan_payload(frag, columns, predicate, limit)
        deadline = self._hedge_deadline(est.in_bytes)
        if deadline is None:
            result, osd_id, el = self.doa.call(frag.path, frag.obj_idx,
                                               "scan_op", payload,
                                               tenant=ctx.tenant,
                                               lane=ctx.lane)
            hedged = False
        else:
            result, osd_id, el, hedged = self.doa.call_hedged(
                frag.path, frag.obj_idx, "scan_op", payload,
                hedge_threshold_s=deadline, tenant=ctx.tenant,
                lane=ctx.lane)
        t0 = time.perf_counter()
        tbl = Table.from_ipc(result)
        client_cpu = time.perf_counter() - t0
        sf = self.store.osds[osd_id].straggle_factor
        with self._lock:
            self.decisions["osd"] += 1
            if hedged:
                self.hedges += 1
            if limit is None:
                self._osd_lat.append(el / max(1, est.in_bytes))
        # el is straggle-inflated; divide it out so the decode-rate
        # estimate stays a property of the data, not of the slow node.
        # limit-truncated scans skip the estimators: their early-exit
        # decode time and clipped output would teach the EWMAs that
        # fragments are cheaper/smaller than they are.
        if limit is None:
            self._observe("osd", est.in_bytes, el / max(sf, 1e-9),
                          len(result))
        rec = TaskRecord("osd", osd_id, el, len(result), client_cpu,
                         len(tbl), hedged=hedged)
        return tbl, rec, result

    def _scan_client(self, frag, columns, predicate,
                     ctx: TaskContext | None = None):
        ctx = ctx if ctx is not None else TaskContext()
        # the scheduler already holds this fragment's admission slot:
        # strip the controller so the client format cannot deadlock
        # re-admitting against the same OSD
        tbl, rec = self._client_fmt.scan_fragment(
            self.fs, frag, columns, predicate,
            dataclasses.replace(ctx, admission=None))
        ipc = tbl.to_ipc()
        with self._lock:
            self.decisions["client"] += 1
        # both paths feed the estimators in the *same units*: stored
        # fragment bytes in, Arrow-IPC bytes out — but each side updates
        # only its own decode-rate EWMA (the client may run an
        # accelerator decode backend the storage nodes don't have);
        # truncated scans are excluded for the same reason as in
        # _scan_osd
        if ctx.limit is None:
            self._observe("client", self._frag_bytes(frag), rec.cpu_s,
                          len(ipc))
        return tbl, rec, ipc

    # -- aggregate pushdown -----------------------------------------------------
    _ROWCOUNT_COLS = ("__rowcount__",)   # cache-key column sentinel: a
                                         # count shares nothing with a scan

    def count_cache_key(self, frag: Fragment,
                        predicate: Expr | None) -> tuple:
        return self.cache_key(frag, self._ROWCOUNT_COLS, predicate)

    def count_fragment(self, frag: Fragment, predicate: Expr | None,
                       ctx: TaskContext | None = None,
                       **legacy) -> tuple[int, TaskRecord]:
        """COUNT(*) for one fragment with the same placement machinery as
        a scan: priced (with the aggregate's tiny result size), hedged,
        and result-cached — so ``count_rows`` under ``format="adaptive"``
        ships integers, not materialized tables.

        Returns (row count, TaskRecord)."""
        ctx = resolve_context(ctx, legacy)
        if predicate is None:       # metadata answers; no I/O at all
            return frag.num_rows, TaskRecord("client", -1, 0.0, 0, 0.0,
                                             frag.num_rows, cached=True)
        key = self.count_cache_key(frag, predicate)
        cached = self.cache.get(key, tenant=ctx.tenant)
        if cached is not None:
            n = int(json.loads(cached)["rows"])
            with self._lock:
                self.decisions["cache"] += 1
            return n, TaskRecord("client", -1, 0.0, 0, 0.0, n, cached=True)

        # an aggregate returns a constant-size payload: the storage-side
        # estimate carries ~no wire cost, so pushdown wins unless the
        # nodes are badly saturated
        est = self.estimate(frag, out_bytes=32, ctx=ctx)
        with self._admit(frag, ctx):
            if est.where == "osd":
                try:
                    n, rec, raw = self._count_osd(frag, predicate, est,
                                                  ctx)
                except (OSDDownError, ObjectNotFound):
                    with self._lock:
                        self.fallbacks += 1
                    n, rec, raw = self._count_client(frag, predicate, ctx)
            else:
                n, rec, raw = self._count_client(frag, predicate, ctx)
        self._cache_put(key, raw, ctx)
        return n, rec

    def _count_osd(self, frag, predicate, est,
                   ctx: TaskContext | None = None):
        ctx = ctx if ctx is not None else TaskContext()
        payload: dict = {
            "predicate": predicate.to_json()
            if predicate is not None else None,
            "row_groups": [frag.rg_in_object],
        }
        if frag.footer is not None:
            payload["footer"] = frag.footer.serialize()
        deadline = self._hedge_deadline(est.in_bytes)
        if deadline is None:
            raw, osd_id, el = self.doa.call(frag.path, frag.obj_idx,
                                            "rowcount_op", payload,
                                            tenant=ctx.tenant,
                                            lane=ctx.lane)
            hedged = False
        else:
            raw, osd_id, el, hedged = self.doa.call_hedged(
                frag.path, frag.obj_idx, "rowcount_op", payload,
                hedge_threshold_s=deadline, tenant=ctx.tenant,
                lane=ctx.lane)
        n = int(json.loads(raw)["rows"])
        with self._lock:
            self.decisions["osd"] += 1
            if hedged:
                self.hedges += 1
        # counts decode a single column: their latency is not a full-scan
        # observation, so neither the hedge history nor the decode-rate
        # EWMA is updated here
        rec = TaskRecord("osd", osd_id, el, len(raw), 0.0, n,
                         hedged=hedged)
        return n, rec, raw

    def aggregate_fragment(self, frag: Fragment, specs, group_by,
                           predicate, *, schema,
                           max_groups: int = DEFAULT_MAX_GROUPS,
                           ctx: TaskContext | None = None,
                           **legacy) -> "tuple[AggState, TaskRecord]":
        """Partial aggregation with the full placement machinery: priced
        with the aggregate's few-byte result size (so pushdown wins
        unless storage is badly saturated), hedged past the straggler
        deadline, and result-cached under the version-keyed LRU keyed by
        the aggregate spec.  Returns (AggState, TaskRecord)."""
        ctx = resolve_context(ctx, legacy)
        if is_degenerate_count(specs, group_by):
            # the unified executor lowers count_rows to this degenerate
            # aggregate; keep the integer-on-the-wire rowcount machinery
            # (placement-priced, hedged, result-cached)
            n, rec = self.count_fragment(frag, predicate, ctx)
            return count_state(n), rec
        key = self.agg_cache_key(frag, specs, group_by, max_groups,
                                 predicate)
        cached = self.cache.get(key, tenant=ctx.tenant)
        if cached is not None:
            state = AggState.deserialize(cached)
            with self._lock:
                self.decisions["cache"] += 1
            return state, TaskRecord("client", -1, 0.0, 0, 0.0,
                                     state.rows, cached=True)

        # an aggregate's reply is a partial state — never the decoded
        # columns: ~64B of JSON envelope plus ~48B per group, with the
        # group count capped by the cardinality bound (assume a few dozen
        # when the true cardinality is unknown)
        groups_est = min(max_groups, 64) if group_by else 0
        est = self.estimate(frag, out_bytes=64 + 48 * groups_est, ctx=ctx)
        with self._admit(frag, ctx):
            if est.where == "osd":
                try:
                    state, rec = self._agg_osd(frag, specs, group_by,
                                               predicate, est, schema,
                                               max_groups, ctx)
                except (OSDDownError, ObjectNotFound):
                    with self._lock:
                        self.fallbacks += 1
                    state, rec = self._agg_client(frag, specs, group_by,
                                                  predicate, schema, ctx)
            else:
                state, rec = self._agg_client(frag, specs, group_by,
                                              predicate, schema, ctx)
        self._cache_put(key, state.serialize(), ctx)
        return state, rec

    def _agg_osd(self, frag, specs, group_by, predicate, est, schema,
                 max_groups, ctx: TaskContext):
        payload = agg_payload(frag, specs, group_by, predicate, max_groups)
        deadline = self._hedge_deadline(est.in_bytes)
        if deadline is None:
            raw, osd_id, el = self.doa.call(frag.path, frag.obj_idx,
                                            "agg_op", payload,
                                            tenant=ctx.tenant,
                                            lane=ctx.lane)
            hedged = False
        else:
            raw, osd_id, el, hedged = self.doa.call_hedged(
                frag.path, frag.obj_idx, "agg_op", payload,
                hedge_threshold_s=deadline, tenant=ctx.tenant,
                lane=ctx.lane)
        state = parse_agg_reply(raw)
        with self._lock:
            if hedged:
                self.hedges += 1
            if state is not None:
                self.decisions["osd"] += 1
        if state is None:
            # cardinality spill -> the storage-side *scan*: scan_op still
            # filters and projects on the OSD (only the needed columns'
            # matching rows ship) and the client folds them unbounded.
            # _scan_osd books the placement decision; the refused agg_op
            # reply bytes still crossed the wire (its decode time lands
            # in the node's busy_s like any other cls call).
            with self._lock:
                self.spills += 1
            cols = needed_columns(specs, group_by, schema, predicate)
            tbl, rec, _ = self._scan_osd(frag, cols, predicate, est,
                                         dataclasses.replace(ctx,
                                                             limit=None))
            t0 = time.perf_counter()
            state = partial_aggregate(tbl, specs, group_by)
            fold = time.perf_counter() - t0
            rec = dataclasses.replace(
                rec, wire_bytes=rec.wire_bytes + len(raw),
                client_cpu_s=rec.client_cpu_s + fold,
                rows_out=state.rows, hedged=rec.hedged or hedged)
            return state, rec
        # like counts, aggregates decode a column subset: not a full-scan
        # observation, so the hedge history / decode-rate EWMAs stay put
        rec = TaskRecord("osd", osd_id, el, len(raw), 0.0, state.rows,
                         hedged=hedged)
        return state, rec

    def _agg_client(self, frag, specs, group_by, predicate, schema,
                    ctx: TaskContext):
        cols = needed_columns(specs, group_by, schema, predicate)
        tbl, rec = self._client_fmt.scan_fragment(
            self.fs, frag, cols, predicate,
            dataclasses.replace(ctx, admission=None, limit=None))
        t0 = time.perf_counter()
        state = partial_aggregate(tbl, specs, group_by)
        fold = time.perf_counter() - t0
        with self._lock:
            self.decisions["client"] += 1
        return state, TaskRecord("client", -1, rec.cpu_s + fold,
                                 rec.wire_bytes,
                                 rec.client_cpu_s + fold, state.rows)

    def _count_client(self, frag, predicate, ctx: TaskContext | None = None):
        """Fallback count: client-side decode of just the (first)
        predicate column (``count_fragment`` answered the predicate-less
        case from metadata already)."""
        ctx = ctx if ctx is not None else TaskContext()
        cols = sorted(predicate.columns())[:1]
        tbl, rec = self._client_fmt.scan_fragment(
            self.fs, frag, cols, predicate,
            dataclasses.replace(ctx, admission=None, limit=None))
        n = len(tbl)
        with self._lock:
            self.decisions["client"] += 1
        raw = json.dumps({"rows": n}).encode()
        return n, TaskRecord("client", -1, rec.cpu_s, rec.wire_bytes,
                             rec.client_cpu_s, n), raw

    # -- reporting ---------------------------------------------------------------
    def stats(self) -> dict:
        return {"decisions": dict(self.decisions), "hedges": self.hedges,
                "fallbacks": self.fallbacks, "spills": self.spills,
                "cache": self.cache.stats()}
