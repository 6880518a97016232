"""Per-column-chunk statistics (Parquet footer analogue)."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass
class ColumnStats:
    min: Any = None
    max: Any = None
    null_count: int = 0
    count: int = 0
    #: Optional physical-design index block for the same chunk
    #: (``repro_torch.aformat.indexes.ColumnIndex``): attached by
    #: ``RowGroupMeta.column_stats`` so ``Expr.prune`` can upgrade a
    #: stats-SOME verdict to an index-proven NONE.  Never serialized
    #: here — the chunk footer entry owns the block.
    index: Any = dataclasses.field(default=None, compare=False, repr=False)

    def to_json(self):
        def py(v):
            return v.item() if isinstance(v, np.generic) else v

        return {"min": py(self.min), "max": py(self.max),
                "null_count": self.null_count, "count": self.count}

    @staticmethod
    def from_json(d):
        return ColumnStats(d["min"], d["max"], d["null_count"], d["count"])


def compute_stats(column) -> ColumnStats:
    vals = column.values
    validity = column.validity
    count = len(vals)
    if validity is not None:
        nulls = int(count - validity.sum())
        vals = vals[validity]
    else:
        nulls = 0
    if len(vals) == 0:
        return ColumnStats(None, None, nulls, count)
    if column.field.type == "string":
        svals = [str(v) for v in vals]
        return ColumnStats(min(svals), max(svals), nulls, count)
    if column.field.type in ("float32", "float64"):
        finite = vals[np.isfinite(vals)]
        if len(finite) == 0:
            return ColumnStats(None, None, nulls, count)
        return ColumnStats(finite.min(), finite.max(), nulls, count)
    return ColumnStats(vals.min(), vals.max(), nulls, count)
