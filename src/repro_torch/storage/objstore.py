"""RADOS-analogue programmable object store.

Real data structures and byte-level semantics; the transport is in-process.
Objects are placed on OSDs via PG hashing + a deterministic CRUSH-like
replica permutation, written with 3-way replication, and read from the
primary with automatic failover to replicas.  Every OSD tracks busy-time
and byte counters — the inputs to the paper's Fig.-6 CPU-utilization
reproduction — and supports failure + straggler injection.

Two pieces feed the adaptive scan scheduler
(``repro_torch.dataset.scheduler``):

* **Load accounting** — each OSD tracks in-flight object-class calls
  (queued + executing) and caps concurrent execution at its thread count;
  ``ObjectStore.load_of`` snapshots (busy_s, inflight, straggle_factor)
  into an :class:`OSDLoad` whose ``pressure`` is the scheduler's
  saturation signal.
* **Object versions** — every ``put``/``delete`` bumps a per-object
  version counter; ``ObjectStore.version_of`` exposes it so decoded
  result caches are invalidated by overwrites.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import threading
import time
import zlib
from typing import Any, Callable

DEFAULT_PG_NUM = 128


class OSDDownError(RuntimeError):
    pass


class ObjectNotFound(KeyError):
    pass


class VersionConflictError(RuntimeError):
    """Optimistic-commit failure: the object's cluster version moved past
    the version the writer read (``ObjectStore.put_if_version``)."""

    def __init__(self, name: str, expected: int, actual: int):
        super().__init__(
            f"version conflict on {name!r}: expected {expected}, "
            f"found {actual}")
        self.name = name
        self.expected = expected
        self.actual = actual


@dataclasses.dataclass
class OSDStats:
    bytes_stored: int = 0
    objects: int = 0
    reads: int = 0
    writes: int = 0
    cls_calls: int = 0
    busy_s: float = 0.0
    bytes_read: int = 0
    bytes_written: int = 0
    bytes_returned: int = 0
    hedge_wasted_s: float = 0.0   # busy time burned by losing hedge calls
                                  # (duplicated work, Fig.-6 accounting)
    repaired: int = 0             # objects healed onto this OSD by recovery


@dataclasses.dataclass(frozen=True)
class OSDLoad:
    """Point-in-time load snapshot of one OSD (``ObjectStore.load_of``).

    ``inflight`` counts object-class calls queued *or* executing on the
    node; ``pressure`` is the service-time inflation the scheduler should
    expect relative to an idle node: the straggle factor scaled by how
    oversubscribed the node's thread pool is.
    """

    osd_id: int
    busy_s: float
    inflight: int
    threads: int
    straggle_factor: float
    down: bool = False
    by_tenant: Any = None       # {(tenant, lane): inflight} snapshot, or None
    external: int = 0           # simulated external clients' in-flight calls

    @property
    def pressure(self) -> float:
        if self.down:
            return float("inf")
        qd = self.inflight / max(1, self.threads)
        return self.straggle_factor * (1.0 + qd)


class OSD:
    """One storage node: object map + counters + failure/straggler knobs.

    Object-class execution is bounded by ``threads`` concurrent calls
    (``_cls_sem``); calls beyond that queue and show up in ``inflight`` —
    the queue-depth signal the adaptive scheduler reads via ``load_of``.
    """

    _uids = itertools.count()    # process-unique ids (cache keys must not
                                 # collide across clusters sharing osd_ids)

    def __init__(self, osd_id: int, threads: int = 8):
        self.osd_id = osd_id
        self.uid = next(OSD._uids)
        self.threads = threads
        self._objects: dict[str, bytes] = {}
        self._versions: dict[str, int] = {}
        self._lock = threading.Lock()
        self.stats = OSDStats()
        self.down = False
        self.straggle_factor = 1.0   # >1 = this node is slow (hedging tests)
        self.max_straggle_delay_s = 0.25   # cap on the *real* injected wall
                                     # delay per cls call, so pathological
                                     # factors (1e6 in tests) model huge
                                     # service times without actually
                                     # sleeping them out
        self.inflight = 0            # cls calls queued + executing
        self.inflight_tags: dict[tuple[str, str], int] = {}
                                     # in-flight split by (tenant, lane) —
                                     # the per-tenant load signal behind
                                     # lane-visible placement pricing
        self.background_load = 0     # simulated external clients' in-flight
                                     # cls calls (multi-tenant benchmarks)
        self._cls_sem = threading.BoundedSemaphore(max(1, threads))

    def _check(self):
        if self.down:
            raise OSDDownError(f"osd.{self.osd_id} is down")

    def put(self, name: str, data: bytes):
        self._check()
        with self._lock:
            old = self._objects.get(name)
            self._objects[name] = bytes(data)
            self._versions[name] = self._versions.get(name, 0) + 1
            self.stats.writes += 1
            self.stats.bytes_written += len(data)
            self.stats.bytes_stored += len(data) - (len(old) if old else 0)
            if old is None:
                self.stats.objects += 1

    def get(self, name: str, offset: int = 0, length: int | None = None
            ) -> bytes:
        self._check()
        with self._lock:
            if name not in self._objects:
                raise ObjectNotFound(name)
            data = self._objects[name]
            self.stats.reads += 1
            end = len(data) if length is None else offset + length
            out = data[offset:end]
            self.stats.bytes_read += len(out)
            return out

    def stat(self, name: str) -> int:
        self._check()
        with self._lock:
            if name not in self._objects:
                raise ObjectNotFound(name)
            return len(self._objects[name])

    def delete(self, name: str):
        self._check()
        with self._lock:
            if name in self._objects:
                data = self._objects.pop(name)
                self._versions[name] = self._versions.get(name, 0) + 1
                self.stats.bytes_stored -= len(data)
                self.stats.objects -= 1

    def contains(self, name: str) -> bool:
        with self._lock:
            return name in self._objects

    def peek(self, name: str) -> bytes:
        """Read object bytes for cluster-internal traffic (scrub, recovery)
        without touching the client-visible read counters — Fig.-6 replays
        ``reads``/``bytes_read`` as client load, and background maintenance
        must not pollute them."""
        self._check()
        with self._lock:
            if name not in self._objects:
                raise ObjectNotFound(name)
            return self._objects[name]

    def repair(self, name: str, data: bytes | None, version: int):
        """Install (or, with ``data=None``, remove) an object copy at an
        exact peer version — the recovery path.  Unlike ``put`` this never
        *bumps* the version counter: recovery restores replica agreement,
        it is not a new write, so result/footer caches keyed on the
        version must not be spuriously invalidated."""
        with self._lock:
            old = self._objects.get(name)
            if data is None:
                if old is not None:
                    self._objects.pop(name)
                    self.stats.bytes_stored -= len(old)
                    self.stats.objects -= 1
            else:
                self._objects[name] = bytes(data)
                self.stats.bytes_stored += len(data) - \
                    (len(old) if old is not None else 0)
                if old is None:
                    self.stats.objects += 1
            self._versions[name] = version
            self.stats.repaired += 1

    def version(self, name: str) -> int:
        """Monotonic per-object write counter (0 = never written here)."""
        with self._lock:
            return self._versions.get(name, 0)

    def list_objects(self) -> list[str]:
        with self._lock:
            return sorted(self._objects)


def _hash32(s: str) -> int:
    return int.from_bytes(hashlib.blake2s(s.encode(),
                                          digest_size=4).digest(), "little")


class ObjectStore:
    """PG-mapped, replicated object store over N OSDs."""

    def __init__(self, num_osds: int, *, replication: int = 3,
                 pg_num: int = DEFAULT_PG_NUM, threads_per_osd: int = 8):
        if num_osds < 1:
            raise ValueError("need at least one OSD")
        self.osds = [OSD(i, threads_per_osd) for i in range(num_osds)]
        self.replication = min(replication, num_osds)
        self.pg_num = pg_num
        self._cls: dict[str, Callable] = {}
        self._cas_lock = threading.Lock()   # serializes put_if_version —
                                # the primary-OSD write-serialization point

    # -- placement -------------------------------------------------------------
    def pg_of(self, name: str) -> int:
        return _hash32(name) % self.pg_num

    def acting_set(self, name: str) -> list[OSD]:
        """CRUSH-like: deterministic pseudo-random replica set for the PG."""
        pg = self.pg_of(name)
        n = len(self.osds)
        seed = _hash32(f"pg:{pg}")
        order = sorted(range(n), key=lambda i: _hash32(f"{seed}:{i}"))
        return [self.osds[i] for i in order[: self.replication]]

    def primary_of(self, name: str) -> OSD:
        return self.acting_set(name)[0]

    # -- I/O ---------------------------------------------------------------------
    def put(self, name: str, data: bytes):
        acting = self.acting_set(name)
        wrote = 0
        for osd in acting:
            try:
                osd.put(name, data)
                wrote += 1
            except OSDDownError:
                continue
        quorum = (self.replication // 2) + 1
        if wrote < quorum:
            raise OSDDownError(
                f"write quorum failed for {name}: {wrote}/{quorum}")

    def get(self, name: str, offset: int = 0, length: int | None = None
            ) -> bytes:
        err: Exception | None = None
        for osd in self.acting_set(name):
            try:
                return osd.get(name, offset, length)
            except OSDDownError as e:   # failover to replica
                err = e
            except ObjectNotFound as e:
                err = e
        raise err if err else ObjectNotFound(name)

    def stat(self, name: str) -> int:
        err: Exception | None = None
        for osd in self.acting_set(name):
            try:
                return osd.stat(name)
            except (OSDDownError, ObjectNotFound) as e:
                err = e
        raise err if err else ObjectNotFound(name)

    def delete(self, name: str) -> int:
        """Delete the object from every reachable acting replica.  Returns
        the number of replicas that actually dropped a copy; a down
        replica keeps its (now-stale) copy and counters until
        :meth:`recover_osd` reconciles it by version."""
        dropped = 0
        for osd in self.acting_set(name):
            try:
                held = osd.contains(name)
                osd.delete(name)
                dropped += held
            except OSDDownError:
                pass
        return dropped

    def exists(self, name: str) -> bool:
        """True if any *up* acting replica holds the object.  Down OSDs
        are excluded: their object map is unreachable and may hold ghost
        copies of objects deleted while they were down — membership must
        reflect what the cluster can actually serve."""
        return any(not o.down and o.contains(name)
                   for o in self.acting_set(name))

    def put_if_version(self, name: str, data: bytes,
                       expected_version: int) -> int:
        """Optimistic-concurrency write: install ``data`` only if the
        object's cluster version (:meth:`version_of`) still equals
        ``expected_version`` (0 = object must not exist yet).  The
        check-and-write is serialized store-wide — the analogue of the
        primary OSD ordering all writes to one object — so two writers
        racing on the same head object cannot both win.  Returns the new
        version; raises :class:`VersionConflictError` on a lost race.

        This is the commit primitive of the snapshot/manifest layer
        (``repro_torch.dataset.snapshot``): read head @ v, prepare, commit iff
        still @ v."""
        with self._cas_lock:
            actual = self.version_of(name)
            if actual != expected_version:
                raise VersionConflictError(name, expected_version, actual)
            self.put(name, data)
            return self.version_of(name)

    def version_of(self, name: str) -> int:
        """Cluster-wide object version: the max per-replica write counter.
        Any overwrite (or delete) advances it — result-cache keys carry it
        so stale decoded results can never be served."""
        return max((o.version(name) for o in self.acting_set(name)),
                   default=0)

    # -- load signals (adaptive scheduler inputs) -------------------------------
    def load_of(self, osd: "OSD | int") -> OSDLoad:
        """Snapshot one OSD's load: busy seconds, in-flight cls queue depth,
        straggle factor.  ``OSDLoad.pressure`` condenses these into the
        expected service-time inflation the scan scheduler compares against
        a client-side scan."""
        o = self.osds[osd] if isinstance(osd, int) else osd
        with o._lock:
            tags = dict(o.inflight_tags) if o.inflight_tags else None
        return OSDLoad(o.osd_id, o.stats.busy_s,
                       o.inflight + o.background_load, o.threads,
                       o.straggle_factor, o.down, tags, o.background_load)

    def list_objects(self) -> list[str]:
        names: set[str] = set()
        for o in self.osds:
            if not o.down:
                names.update(o.list_objects())
        return sorted(names)

    # -- object classes (the Ceph ObjectClass SDK analogue) ---------------------
    def register_cls(self, method: str, fn: Callable):
        self._cls[method] = fn

    def cls_call(self, name: str, method: str, payload: dict | None = None,
                 *, prefer_osd: OSD | None = None, tenant: str = "default",
                 lane: str = "bulk") -> Any:
        """Execute a registered object-class method ON the storage node
        holding the object.  Returns (result, osd_id, elapsed_s).

        ``tenant``/``lane`` tag the call in the node's per-tenant in-flight
        accounting (``OSD.inflight_tags``, snapshotted by :meth:`load_of`)
        so placement pricing can see *whose* work is queued where."""
        if method not in self._cls:
            raise KeyError(f"no object class method {method!r}")
        acting = self.acting_set(name)
        candidates = ([prefer_osd] if prefer_osd is not None else []) + acting
        err: Exception | None = None
        tag = (tenant, lane)
        for osd in candidates:
            if osd.down or not osd.contains(name):
                continue
            with osd._lock:          # queued: visible to load_of immediately
                osd.inflight += 1
                osd.inflight_tags[tag] = osd.inflight_tags.get(tag, 0) + 1
            try:
                with osd._cls_sem:   # per-OSD concurrency = thread count
                    t0 = time.perf_counter()
                    try:
                        result = self._cls[method](ObjectHandle(osd, name),
                                                   payload or {})
                    except OSDDownError as e:
                        err = e
                        continue
                    raw = time.perf_counter() - t0
                    el = raw * osd.straggle_factor
                    if osd.straggle_factor > 1.0:
                        # a straggler is *actually* slow: burn bounded real
                        # wall time while holding the execution slot, so
                        # hedging races have something real to overlap
                        time.sleep(min(el - raw, osd.max_straggle_delay_s))
            finally:
                with osd._lock:
                    osd.inflight -= 1
                    n = osd.inflight_tags.get(tag, 0) - 1
                    if n > 0:
                        osd.inflight_tags[tag] = n
                    else:
                        osd.inflight_tags.pop(tag, None)
            osd.stats.cls_calls += 1
            osd.stats.busy_s += el
            if isinstance(result, (bytes, bytearray)):
                osd.stats.bytes_returned += len(result)
            return result, osd.osd_id, el
        raise err if err else ObjectNotFound(name)

    # -- health ------------------------------------------------------------------
    def fail_osd(self, osd_id: int):
        self.osds[osd_id].down = True

    def recover_osd(self, osd_id: int) -> int:
        """Bring an OSD back and re-sync every object it participates in.

        Recovery compares this replica against its up peers by *version*
        (every overwrite while the node was down advanced the peers') and,
        at equal versions, by checksum (bit rot).  Missing and stale copies
        are both healed via :meth:`OSD.repair`, which installs the bytes at
        the authoritative peer version rather than ``put``-bumping it —
        a recovery must restore agreement, not look like a new write that
        spuriously invalidates result/footer caches.  Objects deleted
        while the node was down are removed.  Returns objects healed."""
        me = self.osds[osd_id]
        me.down = False
        healed = 0
        # union of what the cluster knows and what this OSD holds: a local
        # object deleted cluster-wide while we were down is only visible
        # on our side
        names = set(self.list_objects()) | set(me.list_objects())
        for name in sorted(names):
            acting = self.acting_set(name)
            if me not in acting:
                continue
            peers = [o for o in acting
                     if o is not me and not o.down]
            holders = [o for o in peers if o.contains(name)]
            if holders:
                best = max(holders, key=lambda o: o.version(name))
                bv = best.version(name)
                if not me.contains(name):
                    me.repair(name, best.peek(name), bv)
                    healed += 1
                elif me.version(name) < bv or \
                        zlib.crc32(me.peek(name)) != \
                        zlib.crc32(best.peek(name)):
                    me.repair(name, best.peek(name), bv)
                    healed += 1
            else:
                # no up peer holds it: deleted while we were down if any
                # peer's version counter moved past ours
                pv = max((o.version(name) for o in peers), default=0)
                if me.contains(name) and pv > me.version(name):
                    me.repair(name, None, pv)
                    healed += 1
        return healed

    def scrub(self) -> list[str]:
        """Verify replica consistency via checksums; returns bad objects.
        Reads replicas through :meth:`OSD.peek` so background verification
        never inflates the client-visible ``reads``/``bytes_read`` stats
        the Fig.-6 accounting replays."""
        bad = []
        for name in self.list_objects():
            sums = set()
            for osd in self.acting_set(name):
                if osd.down or not osd.contains(name):
                    continue
                sums.add(zlib.crc32(osd.peek(name)))
            if len(sums) > 1:
                bad.append(name)
        return bad

    def total_stats(self) -> OSDStats:
        agg = OSDStats()
        for o in self.osds:
            for f in dataclasses.fields(OSDStats):
                setattr(agg, f.name,
                        getattr(agg, f.name) + getattr(o.stats, f.name))
        return agg


class ObjectHandle:
    """File-like random-access view of one object on one OSD — the
    RandomAccessObject of the paper: lets the embedded access library run
    unmodified against object bytes (implements RandomAccessSource)."""

    def __init__(self, osd: OSD, name: str):
        self._osd = osd
        self.name = name

    @property
    def osd_id(self) -> int:
        return self._osd.osd_id

    @property
    def osd_uid(self) -> int:
        return self._osd.uid

    def version(self) -> int:
        """Write counter of this replica — cache keys for anything derived
        from the object's bytes (parsed footers, decoded results)."""
        return self._osd.version(self.name)

    def read(self, offset: int, length: int) -> bytes:
        return self._osd.get(self.name, offset, length)

    def size(self) -> int:
        return self._osd.stat(self.name)

    def read_all(self) -> bytes:
        return self._osd.get(self.name)

    def open_peer(self, name: str) -> "ObjectHandle":
        """Handle to another object co-located on this same OSD — the
        mechanism ``compact_op`` uses to merge neighbouring small objects
        without any bytes leaving the node.  Raises ObjectNotFound if
        this OSD holds no copy (the caller planned a non-co-located
        group and must fall back)."""
        if not self._osd.contains(name):
            raise ObjectNotFound(name)
        return ObjectHandle(self._osd, name)

    def peek_all(self) -> bytes:
        """Whole-object read for cluster-internal maintenance traffic
        (compaction, like scrub/recovery) — bypasses the client-visible
        ``reads``/``bytes_read`` counters the Fig.-6 accounting replays
        as client load."""
        return self._osd.peek(self.name)
