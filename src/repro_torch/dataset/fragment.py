"""Fragments: the self-contained scan units of a Dataset.

A Fragment is exactly the paper's unit of parallelism — one row group,
guaranteed (by the Striped / Split / Flat layouts) to live inside a single
RADOS object, so it can be scanned either by the client (reading bytes
through CephFS) or by the storage node itself (``scan_op`` via
DirectObjectAccess) without touching any other object.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from repro_torch.aformat import parquet
from repro_torch.aformat.expressions import Expr
from repro_torch.aformat.statistics import ColumnStats


@dataclasses.dataclass
class Fragment:
    """One row group, self-contained in one object.

    path         CephFS path whose object holds the row group (for split
                 layout this is the per-row-group file, for striped/flat the
                 parent file).
    obj_idx      index of the object within the file's striping sequence.
    rg_in_object index of the row group within the footer that ``scan_op``
                 will see for that object (0 for split/striped fragments).
    num_rows     row count (pre-filter).
    stats        per-column min/max/null stats for client-side pruning.
    footer       FileMeta to hand to ``scan_op`` (striped layout passes the
                 rebased parent footer; None = object carries its own).
    """

    path: str
    obj_idx: int
    rg_in_object: int
    num_rows: int
    stats: Mapping[str, ColumnStats] | None = None
    footer: parquet.FileMeta | None = None
    # client-scan path: where the row group lives inside `path`
    client_meta: parquet.FileMeta | None = None
    client_rg_index: int = 0
    # snapshot layer (repro_torch.dataset.snapshot): rows matching this
    # predicate are deleted in the fragment's snapshot; the optimizer
    # conjoins NOT(tombstone) into the fragment's residual predicate so
    # deleted rows never resurface at any placement.  num_rows/stats
    # stay the *physical* (pre-delete) values — correct for pruning,
    # excluded from metadata-only answers while a tombstone is live.
    tombstone: Expr | None = None

    def describe(self) -> dict[str, Any]:
        return {"path": self.path, "obj_idx": self.obj_idx,
                "rows": self.num_rows}
