"""The paper's primary contribution, as a composable module.

"Towards an Arrow-native Storage System" contributes a *design paradigm*:
embed the stock data-access library into a programmable object store so
that dataset scanning (decode + filter + project) can execute at either
placement behind one API.  The pieces:

  ObjectStore / ObjectHandle   programmable store + RandomAccessObject
  register_default_classes     the ObjectClass SDK methods (scan_op, ...)
  CephFS / DirectObjectAccess  POSIX shim + filename->object translation
  write_striped / write_split / write_flat   self-contained-fragment layouts
  dataset / Query / Scanner    the Dataset API (lazy query plans)
  ParquetFormat                client-side scan      (their baseline)
  PushdownParquetFormat        storage-side scan     (their RADOS Parquet)
  AdaptiveFormat / ScanScheduler   runtime placement from live OSD load,
                               with hedged scans + a columnar result cache

``make_cluster`` assembles the standard stack used by the examples, tests
and benchmarks.
"""

from __future__ import annotations

from repro_torch.dataset import (AdaptiveFormat, AggSpec, CommitConflict, Dataset,
                           MutableDataset, ParquetFormat,
                           PushdownParquetFormat, Query, ScanScheduler,
                           Scanner, Shed, TaskContext, TenantRegistry,
                           TenantSpec, dataset)
from repro_torch.storage.cephfs import CephFS, DirectObjectAccess
from repro_torch.storage.layouts import write_flat, write_split, write_striped
from repro_torch.storage.objclass import register_default_classes
from repro_torch.storage.objstore import ObjectStore


def make_cluster(num_osds: int = 8, *, replication: int = 3,
                 threads_per_osd: int = 8) -> CephFS:
    """ObjectStore + default object classes + CephFS, ready to use."""
    store = ObjectStore(num_osds, replication=replication,
                        threads_per_osd=threads_per_osd)
    register_default_classes(store)
    return CephFS(store)


__all__ = ["AggSpec", "Dataset", "MutableDataset", "CommitConflict",
           "ParquetFormat", "PushdownParquetFormat", "AdaptiveFormat",
           "Query", "ScanScheduler", "Scanner", "dataset", "CephFS",
           "DirectObjectAccess", "write_flat", "write_split",
           "write_striped", "register_default_classes", "ObjectStore",
           "make_cluster",
           "Shed", "TaskContext", "TenantRegistry", "TenantSpec"]
