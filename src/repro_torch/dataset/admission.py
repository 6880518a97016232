"""Multi-tenant admission control: weighted-fair per-OSD slots with
priority lanes, preemption, and deadline-aware waiting.

Every placement ultimately lands fragment work on the storage node that
holds the object: a pushdown scan burns the node's CPU in ``scan_op``, a
client-side scan pulls the raw column bytes off the same node, and the
adaptive scheduler does one or the other per fragment.  The admission
controller bounds how many fragment operations stay outstanding against
any one OSD (``slots_per_osd``) — and, when several tenants share the
controller (a :class:`~repro_torch.dataset.qos.TenantRegistry` hands one per
cluster), it decides *whose* work gets the next slot:

priority lanes
    ``interactive`` > ``bulk`` > ``background``.  A free slot never goes
    to a lane while a higher lane is waiting, and an interactive arrival
    may (a) jump a queue of lower-lane waiters and (b) oversubscribe the
    node by up to ``preempt_slack`` extra slots — both are counted as
    ``preemptions``, the signal that the lane actually displaced someone.
    ``compact_op`` traffic rides the ``background`` lane (see
    ``MutableDataset.compact``), so maintenance can never starve a scan.

weighted fairness
    Within a lane, the next slot goes to the waiting tenant with the
    lowest ``inflight / weight`` share on that OSD (FIFO between equal
    shares), so under saturation the slot split converges to the
    registered weights.

deadline-aware waiting
    A waiter whose :class:`~repro_torch.dataset.qos.TaskContext` deadline
    expires while queued is removed and raises :class:`AdmissionTimeout`;
    the streaming executor converts it into a typed ``Shed`` result —
    the query is rejected *at the queue*, before burning storage CPU it
    can no longer use in time.

Every acquisition records its wall ``wait_s`` (not just a blocked/not
counter): queue *time* is the latency signal deadline shedding and the
multi-tenant benchmark's p99 claims are built on.  ``admit(osd_id)``
without a context keeps the legacy single-tenant behavior (default
tenant, ``bulk`` lane, weight 1) byte-for-byte.
"""

from __future__ import annotations

import contextlib
import threading
import time

from repro_torch.storage.objstore import ObjectStore

#: Priority lanes, highest priority first.
LANES = ("interactive", "bulk", "background")
LANE_PRIORITY = {name: rank for rank, name in enumerate(LANES)}
DEFAULT_LANE = "bulk"


class AdmissionTimeout(Exception):
    """A waiter's deadline expired while queued for an OSD slot.  The
    executor catches this and surfaces a typed ``Shed`` result; it never
    escapes to user code."""

    def __init__(self, osd_id: int, tenant: str, waited_s: float):
        super().__init__(
            f"tenant {tenant!r} deadline expired after waiting "
            f"{waited_s * 1e3:.1f}ms for a slot on osd.{osd_id}")
        self.osd_id = osd_id
        self.tenant = tenant
        self.waited_s = waited_s


class _Waiter:
    __slots__ = ("tenant", "rank", "weight", "seq", "granted", "preempting")

    def __init__(self, tenant: str, rank: int, weight: float, seq: int):
        self.tenant = tenant
        self.rank = rank
        self.weight = weight
        self.seq = seq
        self.granted = False
        self.preempting = False


class _OsdSlots:
    """Slot state for one OSD: a condition variable, per-tenant in-flight
    counts, and the waiter queue the grant policy picks from."""

    def __init__(self, slots: int, slack: int):
        self.slots = slots
        self.slack = slack
        self.cond = threading.Condition()
        self.inflight = 0
        self.by_tenant: dict[str, int] = {}
        self.waiters: list[_Waiter] = []
        self._seq = 0

    def _take(self, tenant: str):
        self.inflight += 1
        self.by_tenant[tenant] = self.by_tenant.get(tenant, 0) + 1

    def _pick(self) -> _Waiter:
        """Highest lane first; within the lane, the tenant with the
        smallest weighted share of this OSD's slots; FIFO between equal
        shares."""
        return min(self.waiters, key=lambda w: (
            w.rank, self.by_tenant.get(w.tenant, 0) / w.weight, w.seq))

    def _pump(self):
        granted = False
        while self.waiters and self.inflight < self.slots:
            w = self._pick()
            self.waiters.remove(w)
            w.granted = True
            self._take(w.tenant)
            granted = True
        if granted:
            self.cond.notify_all()

    def acquire(self, tenant: str, rank: int, weight: float,
                remaining_s) -> tuple[bool, bool, float]:
        """Block until granted; returns (waited, preempted, wait_s).
        ``remaining_s`` is a 0-arg callable giving the seconds left on
        the caller's deadline (or None for no deadline)."""
        t0 = time.perf_counter()
        with self.cond:
            if self.inflight < self.slots and not self.waiters:
                self._take(tenant)
                return False, False, 0.0
            if (rank == 0 and self.inflight < self.slots + self.slack
                    and not any(w.rank == 0 for w in self.waiters)):
                # interactive preemption: jump the lower-lane queue and,
                # when the node is full, oversubscribe into the slack
                self._take(tenant)
                return False, True, 0.0
            self._seq += 1
            w = _Waiter(tenant, rank, weight, self._seq)
            self.waiters.append(w)
            self._pump()          # a slot may have freed since the check
            while not w.granted:
                timeout = remaining_s()
                if timeout is not None and timeout <= 0:
                    self.waiters.remove(w)
                    raise AdmissionTimeout(-1, tenant,
                                           time.perf_counter() - t0)
                self.cond.wait(timeout)
            return True, w.preempting, time.perf_counter() - t0

    def release(self, tenant: str):
        with self.cond:
            self.inflight -= 1
            n = self.by_tenant.get(tenant, 0) - 1
            if n > 0:
                self.by_tenant[tenant] = n
            else:
                self.by_tenant.pop(tenant, None)
            self._pump()


class _NoDeadline:
    __slots__ = ()

    def __call__(self):
        return None


_NO_DEADLINE = _NoDeadline()


class AdmissionController:
    """Weighted-fair, lane-prioritized per-OSD in-flight slots shared by
    every placement (see the module docstring for the policy).

    ``admit(osd_id, ctx)`` is a context manager holding one slot on that
    node for the duration of the fragment operation; ``ctx`` is a
    :class:`~repro_torch.dataset.qos.TaskContext` (or None for the legacy
    single-tenant behavior).  ``waits`` counts acquisitions that blocked,
    ``wait_s`` their summed queue time — the backpressure signals
    surfaced in scan metrics.
    """

    def __init__(self, store: ObjectStore, slots_per_osd: int = 4, *,
                 preempt_slack: int = 1):
        self.store = store
        self.slots_per_osd = max(1, slots_per_osd)
        self.preempt_slack = max(0, preempt_slack)
        self._slots: dict[int, _OsdSlots] = {}
        self._lock = threading.Lock()
        self.admitted = 0
        self.waits = 0
        self.wait_s = 0.0
        self.preemptions = 0
        self.sheds = 0
        self._by_tenant: dict[str, dict] = {}

    def _osd(self, osd_id: int) -> _OsdSlots:
        with self._lock:
            st = self._slots.get(osd_id)
            if st is None:
                st = _OsdSlots(self.slots_per_osd, self.preempt_slack)
                self._slots[osd_id] = st
            return st

    def _tenant_stats(self, tenant: str) -> dict:
        st = self._by_tenant.get(tenant)
        if st is None:
            st = {"admitted": 0, "waits": 0, "wait_s": 0.0,
                  "preemptions": 0, "sheds": 0}
            self._by_tenant[tenant] = st
        return st

    @contextlib.contextmanager
    def admit(self, osd_id: int, ctx=None):
        tenant = "default" if ctx is None else ctx.tenant
        rank = LANE_PRIORITY[DEFAULT_LANE] if ctx is None else \
            LANE_PRIORITY.get(ctx.lane, LANE_PRIORITY[DEFAULT_LANE])
        weight = 1.0 if ctx is None else max(ctx.weight, 1e-9)
        remaining = _NO_DEADLINE
        if ctx is not None and ctx.deadline_s is not None:
            remaining = ctx.remaining_s
        st = self._osd(osd_id)
        try:
            waited, preempted, wait_s = st.acquire(tenant, rank, weight,
                                                   remaining)
        except AdmissionTimeout as e:
            e.osd_id = osd_id
            with self._lock:
                self.sheds += 1
                self.waits += 1
                self.wait_s += e.waited_s
                ts = self._tenant_stats(tenant)
                ts["sheds"] += 1
                ts["waits"] += 1
                ts["wait_s"] += e.waited_s
            raise
        with self._lock:
            self.admitted += 1
            self.waits += 1 if waited else 0
            self.wait_s += wait_s
            self.preemptions += 1 if preempted else 0
            ts = self._tenant_stats(tenant)
            ts["admitted"] += 1
            ts["waits"] += 1 if waited else 0
            ts["wait_s"] += wait_s
            ts["preemptions"] += 1 if preempted else 0
        try:
            yield
        finally:
            st.release(tenant)

    @contextlib.contextmanager
    def admit_object(self, name: str, ctx=None):
        """Admit against the node a fragment operation will land on: the
        first up replica holding the object (the same choice ``get`` and
        ``cls_call`` make)."""
        target = next((o for o in self.store.acting_set(name)
                       if not o.down and o.contains(name)), None)
        if target is None:           # failover path decides; don't gate
            yield
            return
        with self.admit(target.osd_id, ctx):
            yield

    def stats(self) -> dict:
        with self._lock:
            return {"slots_per_osd": self.slots_per_osd,
                    "admitted": self.admitted, "waits": self.waits,
                    "wait_s": round(self.wait_s, 6),
                    "preemptions": self.preemptions, "sheds": self.sheds,
                    "by_tenant": {t: dict(s)
                                  for t, s in self._by_tenant.items()}}
