"""CephFS shim: POSIX-ish files striped over RADOS objects, plus the
DirectObjectAccess API that translates filenames to object IDs and invokes
object-class methods on them (paper §2.2).

Striping: file bytes are cut into ``stripe_unit``-sized objects named
``<ino>.<%08x index>``; the MDS table maps path -> (ino, size, stripe_unit,
object_count).  This is the metadata DirectObjectAccess leverages.
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Any, Callable

from repro_torch.storage.objstore import ObjectNotFound, ObjectStore

DEFAULT_STRIPE_UNIT = 4 * 1024 * 1024


@dataclasses.dataclass
class Inode:
    ino: int
    path: str
    size: int
    stripe_unit: int
    object_count: int
    xattrs: dict[str, Any] = dataclasses.field(default_factory=dict)


class CephFS:
    """Filesystem facade over an ObjectStore."""

    def __init__(self, store: ObjectStore,
                 stripe_unit: int = DEFAULT_STRIPE_UNIT):
        self.store = store
        self.default_stripe_unit = stripe_unit
        self._mds: dict[str, Inode] = {}
        self._next_ino = 0x10000
        self._lock = threading.Lock()

    # -- namespace ----------------------------------------------------------
    def _alloc_ino(self) -> int:
        with self._lock:
            self._next_ino += 1
            return self._next_ino

    def exists(self, path: str) -> bool:
        return path in self._mds

    def listdir(self, prefix: str) -> list[str]:
        prefix = prefix.rstrip("/") + "/" if prefix else ""
        return sorted(p for p in self._mds if p.startswith(prefix))

    def stat(self, path: str) -> Inode:
        if path not in self._mds:
            raise FileNotFoundError(path)
        return self._mds[path]

    def unlink(self, path: str):
        for name in self.object_names(path):
            self.store.delete(name)
        del self._mds[path]

    # -- data path ------------------------------------------------------------
    def object_name(self, ino: Inode, idx: int) -> str:
        return f"{ino.ino:x}.{idx:08x}"

    def object_names(self, path: str) -> list[str]:
        ino = self.stat(path)
        return [self.object_name(ino, i) for i in range(ino.object_count)]

    def write_file(self, path: str, data: bytes,
                   stripe_unit: int | None = None,
                   xattrs: dict | None = None) -> Inode:
        su = stripe_unit or self.default_stripe_unit
        if path in self._mds:
            self.unlink(path)
        ino = Inode(self._alloc_ino(), path, len(data), su,
                    max(1, -(-len(data) // su)), dict(xattrs or {}))
        for i in range(ino.object_count):
            chunk = data[i * su:(i + 1) * su]
            self.store.put(self.object_name(ino, i), chunk)
        self._mds[path] = ino
        return ino

    def reserve_ino(self) -> int:
        """Allocate an inode number without installing a path yet — the
        first half of a storage-side write: the client derives the target
        object name (``f"{ino:x}.{idx:08x}"``) before any bytes exist,
        hands it to an object-class method that writes the data inside
        the cluster, then installs the path with :meth:`register_file`."""
        return self._alloc_ino()

    def register_file(self, path: str, ino_num: int, size: int,
                      stripe_unit: int,
                      xattrs: dict | None = None) -> Inode:
        """Install MDS metadata for a file whose object bytes were
        written inside the storage tier (``compact_op``) — a pure
        metadata operation: no data bytes cross the client wire."""
        if path in self._mds:
            raise FileExistsError(path)
        if size <= 0 or stripe_unit <= 0:
            raise ValueError(f"register_file({path!r}): need positive "
                             f"size/stripe_unit, got {size}/{stripe_unit}")
        ino = Inode(ino_num, path, size, stripe_unit,
                    max(1, -(-size // stripe_unit)), dict(xattrs or {}))
        with self._lock:
            self._mds[path] = ino
        return ino

    def read_file(self, path: str) -> bytes:
        ino = self.stat(path)
        parts = []
        for i in range(ino.object_count):
            parts.append(self.store.get(self.object_name(ino, i)))
        return b"".join(parts)[: ino.size]

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        """Random-access read through the striping map."""
        ino = self.stat(path)
        su = ino.stripe_unit
        end = min(offset + length, ino.size)
        out = bytearray()
        idx = offset // su
        while offset < end:
            within = offset - idx * su
            take = min(su - within, end - offset)
            out += self.store.get(self.object_name(ino, idx), within, take)
            offset += take
            idx += 1
        return bytes(out)

    def file_size(self, path: str) -> int:
        return self.stat(path).size


class FileSource:
    """RandomAccessSource over a CephFS file (client-side scan path)."""

    def __init__(self, fs: CephFS, path: str,
                 on_read: Callable[[int], None] | None = None):
        self.fs = fs
        self.path = path
        self._size = fs.file_size(path)
        self._on_read = on_read

    def read(self, offset: int, length: int) -> bytes:
        data = self.fs.read_range(self.path, offset, length)
        if self._on_read:
            self._on_read(len(data))
        return data

    def size(self) -> int:
        return self._size


class DirectObjectAccess:
    """Filename -> object IDs translation + cls invocation (paper §2.2).

    This is the key mechanism: clients keep a filesystem view while
    manipulating the underlying RADOS objects directly.
    """

    def __init__(self, fs: CephFS):
        self.fs = fs
        self.store = fs.store

    def object_ids(self, path: str) -> list[str]:
        return self.fs.object_names(path)

    def stat_object(self, path: str, idx: int) -> int:
        return self.store.stat(self.fs.object_names(path)[idx])

    def call(self, path: str, idx: int, method: str,
             payload: dict | None = None, *, tenant: str = "default",
             lane: str = "bulk"):
        """Invoke an object-class method on the idx-th object of a file.
        Returns (result_bytes, osd_id, elapsed_s).  ``tenant``/``lane``
        tag the node's per-tenant in-flight accounting."""
        names = self.fs.object_names(path)
        return self.store.cls_call(names[idx], method, payload,
                                   tenant=tenant, lane=lane)

    def call_last(self, path: str, method: str, payload=None, *,
                  tenant: str = "default", lane: str = "bulk"):
        names = self.fs.object_names(path)
        return self.store.cls_call(names[-1], method, payload,
                                   tenant=tenant, lane=lane)

    def call_hedged(self, path: str, idx: int, method: str,
                    payload: dict | None = None, *,
                    hedge_threshold_s: float = 0.05,
                    tenant: str = "default", lane: str = "bulk"):
        """Straggler-mitigated cls call with *first-wins racing*: issue the
        call on the primary; if it has not completed within the hedge
        deadline, issue the same call on a replica **while the primary is
        still running** and return whichever finishes first.  Wall time is
        therefore ``min(primary, deadline + backup)`` — never the sum.

        The loser keeps running on its node (an in-flight cls call cannot
        be revoked, exactly as in Ceph): its service time still lands in
        the node's ``busy_s`` and is additionally recorded as
        ``hedge_wasted_s`` — the duplicated storage CPU hedging trades for
        tail latency.

        Returns (result, osd_id, elapsed_s, hedged_bool)."""
        name = self.fs.object_names(path)[idx]
        store = self.store

        acting = store.acting_set(name)
        # the OSD cls_call will execute on: first up replica holding the
        # object (needed up front so the hedge goes somewhere *else*)
        primary = next((o for o in acting
                        if not o.down and o.contains(name)), None)
        fut1 = _hedge_pool().submit(
            lambda: store.cls_call(name, method, payload, tenant=tenant,
                                   lane=lane))
        done, _ = futures_wait([fut1], timeout=hedge_threshold_s)
        if fut1 in done or primary is None:
            result, osd_id, el = fut1.result()   # may raise: no racing yet
            return result, osd_id, el, False

        backup = next((o for o in acting
                       if o.osd_id != primary.osd_id and not o.down
                       and o.contains(name)), None)
        if backup is None:
            result, osd_id, el = fut1.result()
            return result, osd_id, el, False
        fut2 = _hedge_pool().submit(
            lambda: store.cls_call(name, method, payload, prefer_osd=backup,
                                   tenant=tenant, lane=lane))

        pending = {fut1, fut2}
        err: Exception | None = None
        winner: Future | None = None
        losers: list[Future] = []
        while pending and winner is None:
            done, pending = futures_wait(pending,
                                         return_when=FIRST_COMPLETED)
            for fut in done:
                exc = fut.exception()
                if exc is not None:
                    err = exc
                elif winner is None:
                    winner = fut
                else:
                    losers.append(fut)
        if winner is None:
            raise err if err else ObjectNotFound(name)
        waste = _account_hedge_waste(store)
        for loser in pending:          # still running: book when it lands
            loser.add_done_callback(waste)
        for loser in losers:           # finished in the same wait round
            waste(loser)
        result, osd_id, el = winner.result()
        return result, osd_id, el, True


def _account_hedge_waste(store: ObjectStore):
    """Done-callback for a losing hedge call: its service time is
    duplicated storage CPU — book it on the node that burned it."""

    def cb(fut: Future):
        if fut.cancelled() or fut.exception() is not None:
            return
        _, osd_id, el = fut.result()
        osd = store.osds[osd_id]
        with osd._lock:     # callbacks run on foreign hedge-pool threads
            osd.stats.hedge_wasted_s += el

    return cb


_HEDGE_POOL: ThreadPoolExecutor | None = None
_HEDGE_POOL_LOCK = threading.Lock()


def _hedge_pool() -> ThreadPoolExecutor:
    """Process-wide executor for racing hedged cls calls.  Sized well past
    any single scan's parallelism: a slot is held for the full (possibly
    straggling) call, and an exhausted pool would serialize the very races
    it exists to run."""
    global _HEDGE_POOL
    with _HEDGE_POOL_LOCK:
        if _HEDGE_POOL is None:
            _HEDGE_POOL = ThreadPoolExecutor(max_workers=128,
                                             thread_name_prefix="hedge")
        return _HEDGE_POOL
