"""Partial aggregation — the storage-side SUM/MIN/MAX/MEAN/COUNT engine.

The paper's pushdown ships *filtered columns*; an aggregate only needs a
few numbers, so shipping columns wastes exactly the wire and client CPU
the paper targets.  This module is the placement-agnostic kernel both
sides run (the same-code-at-both-placements principle of ``scan_op``):

``AggSpec``
    One aggregate: ``(op, column)`` with op in sum/min/max/mean/count
    (``column=None`` means COUNT(*)).

``partial_aggregate(table, specs, group_by=...)``
    Fold a decoded fragment into an :class:`AggState` — optionally hash
    group-by over one key column.  Storage nodes pass ``max_groups``: a
    fragment whose key cardinality exceeds the bound raises
    :class:`CardinalityError` and the caller falls back to a scan (the
    spill-to-scan path), so a hostile key can never balloon the node's
    memory or the wire payload.

``AggState.merge``
    Associative, commutative-up-to-float-rounding combination of partial
    states: count/sum add, min/max compare, mean carries (sum, count).
    Integer sums are carried as exact Python ints, so any merge order
    yields the same result for count/min/max/sum-of-int/mean-of-int;
    float sums can differ in the last ulp across merge orders (inherent
    to float addition, same as any parallel aggregation engine).

``partial_from_stats``
    The zero-I/O path: ungrouped, predicate-free count/min/max are
    provable from footer statistics alone, so those fragments never touch
    storage at all.  Float min/max is excluded — footer stats skip
    non-finite values, so they cannot speak for a column that may hold
    ±inf.

``AggState.finalize(schema)``
    Produce the result Table: one row (ungrouped) or one row per group,
    sorted by key for determinism.  Empty input follows NumPy: sum=0,
    count=0, mean/min/max are null.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.aformat.schema import Field, Schema
from repro_torch.aformat.statistics import ColumnStats
from repro_torch.aformat.table import Column, Table

AGG_OPS = ("sum", "min", "max", "mean", "count")

#: Default storage-side group-cardinality bound (spill-to-scan past it).
DEFAULT_MAX_GROUPS = 4096

_INT_TYPES = ("int32", "int64", "bool")


class CardinalityError(ValueError):
    """Group-by key cardinality exceeded the storage-side bound."""


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One aggregate: op in sum/min/max/mean/count; column=None => rows."""

    op: str
    column: str | None = None

    def __post_init__(self):
        if self.op not in AGG_OPS:
            raise ValueError(f"unsupported aggregate op {self.op!r}")
        if self.column is None and self.op != "count":
            raise ValueError(f"{self.op} requires a column")

    @property
    def name(self) -> str:
        return f"{self.op}_{self.column}" if self.column else "count"

    def to_json(self) -> dict:
        return {"op": self.op, "column": self.column}

    @staticmethod
    def from_json(d: dict) -> "AggSpec":
        return AggSpec(d["op"], d.get("column"))


def parse_aggs(aggs) -> list[AggSpec]:
    """Normalize user input: AggSpec | (op, column) | "op(column)"."""
    out: list[AggSpec] = []
    for a in aggs:
        if isinstance(a, AggSpec):
            out.append(a)
        elif isinstance(a, str):
            if "(" in a:
                op, col = a.rstrip(")").split("(", 1)
                col = col.strip()
                out.append(AggSpec(op.strip(),
                                   None if col in ("", "*") else col))
            else:
                out.append(AggSpec(a.strip()))
        else:
            op, col = a
            out.append(AggSpec(op, col))
    return out


def needed_columns(specs: Sequence[AggSpec], group_by: str | None,
                   schema: Schema, predicate=None) -> list[str]:
    """Columns a fragment scan must decode to answer these aggregates —
    in schema order.  A pure COUNT(*) needs one column only to carry the
    row count: a predicate column if filtering, else the narrowest-by-
    position first field."""
    names = {s.column for s in specs if s.column is not None}
    if group_by is not None:
        names.add(group_by)
    if not names:
        if predicate is not None:
            names.add(sorted(predicate.columns())[0])
        else:
            names.add(schema.names[0])
    return sorted(names, key=schema.index)


# ---------------------------------------------------------------------------
# Partial cells: JSON-native per-aggregate accumulators
#   count -> int;  sum -> int|float;  min/max -> scalar|None (no rows);
#   mean -> [sum, count]
# ---------------------------------------------------------------------------


def _identity(spec: AggSpec):
    if spec.op == "count":
        return 0
    if spec.op == "sum":
        return 0
    if spec.op == "mean":
        return [0, 0]
    return None                       # min/max over zero rows


def _merge_cell(spec: AggSpec, a, b):
    if spec.op in ("count", "sum"):
        return a + b
    if spec.op == "mean":
        return [a[0] + b[0], a[1] + b[1]]
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b) if spec.op == "min" else max(a, b)


def _py(v):
    """numpy scalar -> exact JSON-able Python scalar."""
    if isinstance(v, np.generic):
        return v.item()
    return v


def _sum_scalar(vals: np.ndarray, field_type: str):
    """Exact sums: integer columns accumulate into Python int (no float
    rounding, so merge order can never change the result)."""
    if len(vals) == 0:
        return 0
    if field_type in _INT_TYPES:
        return int(np.sum(vals, dtype=np.int64))
    return float(np.sum(vals))


def _cell_from_values(spec: AggSpec, vals: np.ndarray, field_type: str):
    """One partial cell from the *valid* values of one column."""
    if spec.op == "count":
        return int(len(vals))
    if field_type == "string" and spec.op not in ("min", "max"):
        raise TypeError(f"{spec.op} over string column {spec.column!r}")
    if spec.op == "sum":
        return _sum_scalar(vals, field_type)
    if spec.op == "mean":
        return [_sum_scalar(vals, field_type), int(len(vals))]
    if len(vals) == 0:
        return None
    if field_type == "string":
        svals = [str(v) for v in vals]
        return min(svals) if spec.op == "min" else max(svals)
    return _py(vals.min() if spec.op == "min" else vals.max())


class AggState:
    """Mergeable partial-aggregate state (the agg_op wire payload).

    Ungrouped: ``cells`` is one accumulator per spec.  Grouped:
    ``groups`` maps key -> accumulator list.  ``rows`` counts the input
    rows folded in (post-predicate) — the accounting figure TaskRecords
    report."""

    def __init__(self, specs: Sequence[AggSpec], group_by: str | None, *,
                 cells: list | None = None,
                 groups: dict | None = None, rows: int = 0):
        self.specs = list(specs)
        self.group_by = group_by
        if group_by is None:
            self.cells = cells if cells is not None else \
                [_identity(s) for s in self.specs]
            self.groups = None
        else:
            self.cells = None
            self.groups = groups if groups is not None else {}
        self.rows = rows

    @staticmethod
    def empty(specs: Sequence[AggSpec],
              group_by: str | None) -> "AggState":
        return AggState(specs, group_by)

    def merge(self, other: "AggState") -> "AggState":
        """Associative in-place combine; returns self."""
        if (len(other.specs) != len(self.specs)
                or other.group_by != self.group_by):
            raise ValueError("merging incompatible aggregate states")
        if self.group_by is None:
            self.cells = [_merge_cell(s, a, b) for s, a, b in
                          zip(self.specs, self.cells, other.cells)]
        else:
            for key, cells in other.groups.items():
                mine = self.groups.get(key)
                if mine is None:
                    self.groups[key] = list(cells)
                else:
                    self.groups[key] = [
                        _merge_cell(s, a, b)
                        for s, a, b in zip(self.specs, mine, cells)]
        self.rows += other.rows
        return self

    @property
    def num_groups(self) -> int:
        return len(self.groups) if self.groups is not None else 0

    # -- wire format ---------------------------------------------------------
    def serialize(self) -> bytes:
        body: dict = {"aggs": [s.to_json() for s in self.specs],
                      "group_by": self.group_by, "rows": self.rows}
        if self.group_by is None:
            body["cells"] = self.cells
        else:
            body["groups"] = [[k, c] for k, c in self.groups.items()]
        return json.dumps(body, separators=(",", ":")).encode()

    @staticmethod
    def deserialize(raw: bytes) -> "AggState":
        d = json.loads(raw)
        specs = [AggSpec.from_json(s) for s in d["aggs"]]
        if d["group_by"] is None:
            return AggState(specs, None, cells=d["cells"], rows=d["rows"])
        groups = {_group_key(k): c for k, c in d["groups"]}
        return AggState(specs, d["group_by"], groups=groups,
                        rows=d["rows"])

    # -- result --------------------------------------------------------------
    def finalize(self, schema: Schema) -> Table:
        """Materialize the merged state as a result Table."""
        fields = result_fields(self.specs, self.group_by, schema)
        if self.group_by is None:
            rows = [self.cells]
            keys = None
        else:
            keys = sorted(self.groups)      # deterministic output order
            rows = [self.groups[k] for k in keys]
        cols: list[Column] = []
        fi = 0
        if self.group_by is not None:
            cols.append(_key_column(fields[0], keys))
            fi = 1
        for j, spec in enumerate(self.specs):
            cols.append(_agg_column(fields[fi + j],
                                    [r[j] for r in rows], spec))
        return Table(Schema(tuple(fields)), cols)


def _group_key(k):
    """JSON round-trips group keys as-is except tuples; keys are scalars
    (int/float/str/bool) so identity is enough."""
    return k


def result_fields(specs: Sequence[AggSpec], group_by: str | None,
                  schema: Schema) -> list[Field]:
    fields: list[Field] = []
    if group_by is not None:
        src = schema.field(group_by)
        fields.append(Field(src.name, src.type))
    for s in specs:
        if s.op == "count":
            t = "int64"
        elif s.op == "mean":
            t = "float64"
        elif s.op == "sum":
            t = "int64" if schema.field(s.column).type in _INT_TYPES \
                else "float64"
        else:
            t = schema.field(s.column).type
        fields.append(Field(s.name, t, nullable=True))
    return fields


def _key_column(field: Field, keys: list) -> Column:
    if field.type == "string":
        return Column(field, np.asarray(keys, object))
    return Column(field, np.asarray(keys, field.numpy_dtype))


def _agg_column(field: Field, cells: list, spec: AggSpec) -> Column:
    n = len(cells)
    if spec.op == "mean":
        vals = np.empty(n, np.float64)
        valid = np.ones(n, "?")
        for i, (s, c) in enumerate(cells):
            if c:
                vals[i] = s / c
            else:
                vals[i], valid[i] = 0.0, False
        return Column(field, vals, valid)
    if spec.op in ("min", "max"):
        valid = np.asarray([c is not None for c in cells], "?")
        if field.type == "string":
            vals = np.asarray(["" if c is None else c for c in cells],
                              object)
        else:
            vals = np.asarray([0 if c is None else c for c in cells],
                              field.numpy_dtype)
        return Column(field, vals, valid)
    # count / sum: always defined (0 over zero rows, matching np.sum)
    return Column(field, np.asarray(cells, field.numpy_dtype))


# ---------------------------------------------------------------------------
# Folding a decoded table into partial state
# ---------------------------------------------------------------------------


def partial_aggregate(table: Table, specs: Sequence[AggSpec],
                      group_by: str | None = None,
                      max_groups: int | None = None) -> AggState:
    """Fold one (already filtered) table into an AggState.

    ``max_groups`` bounds grouped-key cardinality (storage-side callers);
    exceeding it raises :class:`CardinalityError` — the spill-to-scan
    signal.  Rows whose group key is null are dropped, mirroring SQL
    GROUP BY."""
    if group_by is None:
        cells = []
        for s in specs:
            if s.column is None:
                cells.append(int(len(table)))
                continue
            col = table.column(s.column)
            vals = col.values
            if col.validity is not None:
                vals = vals[col.validity]
            cells.append(_cell_from_values(s, vals, col.field.type))
        return AggState(specs, None, cells=cells, rows=len(table))

    key_col = table.column(group_by)
    if key_col.validity is not None:
        table = table.filter(key_col.validity)
        key_col = table.column(group_by)
    kvals = key_col.values
    if key_col.field.type == "string":
        kvals = np.asarray([str(v) for v in kvals], object)
    uniq, inv = np.unique(kvals, return_inverse=True)
    if max_groups is not None and len(uniq) > max_groups:
        raise CardinalityError(
            f"group-by {group_by!r}: {len(uniq)} groups exceed the "
            f"storage-side bound of {max_groups}")
    n_groups = len(uniq)
    per_spec = [_grouped_cells(table, s, inv, n_groups) for s in specs]
    groups = {_py(uniq[g]): [per_spec[j][g] for j in range(len(specs))]
              for g in range(n_groups)}
    return AggState(specs, group_by, groups=groups, rows=len(table))


def _grouped_cells(table: Table, spec: AggSpec, inv: np.ndarray,
                   n_groups: int) -> list:
    """Per-group partial cells for one aggregate over one fragment."""
    if spec.column is None:             # COUNT(*)
        return np.bincount(inv, minlength=n_groups).tolist()
    col = table.column(spec.column)
    vals, ginv = col.values, inv
    if col.validity is not None:
        vals, ginv = vals[col.validity], inv[col.validity]
    ftype = col.field.type
    if spec.op == "count":
        return np.bincount(ginv, minlength=n_groups).tolist()
    if ftype == "string" and spec.op not in ("min", "max"):
        raise TypeError(f"{spec.op} over string column {spec.column!r}")
    if spec.op in ("sum", "mean"):
        if ftype in _INT_TYPES:
            acc = np.zeros(n_groups, np.int64)
            np.add.at(acc, ginv, vals.astype(np.int64, copy=False))
            sums = [int(v) for v in acc]
        else:
            sums = np.bincount(ginv, weights=vals.astype(np.float64),
                               minlength=n_groups).tolist()
        if spec.op == "sum":
            return sums
        counts = np.bincount(ginv, minlength=n_groups)
        return [[s, int(c)] for s, c in zip(sums, counts)]
    # min/max: sort rows by group, slice per group (cardinality-bounded)
    order = np.argsort(ginv, kind="stable")
    sg, sv = ginv[order], vals[order]
    starts = np.searchsorted(sg, np.arange(n_groups), side="left")
    ends = np.searchsorted(sg, np.arange(n_groups), side="right")
    out = []
    for g in range(n_groups):
        if starts[g] == ends[g]:
            out.append(None)
        else:
            part = sv[starts[g]:ends[g]]
            if ftype == "string":
                svals = [str(v) for v in part]
                out.append(min(svals) if spec.op == "min" else max(svals))
            else:
                out.append(_py(part.min() if spec.op == "min"
                               else part.max()))
    return out


# ---------------------------------------------------------------------------
# Metadata-only answers from footer statistics
# ---------------------------------------------------------------------------


def stats_answerable(spec: AggSpec, schema: Schema) -> bool:
    """Can footer stats answer this aggregate exactly?  count always;
    min/max except over floats (footer stats skip non-finite values, so
    they cannot speak for a column that may hold ±inf); sum/mean never
    (stats carry no sums)."""
    if spec.op == "count":
        return True
    if spec.op in ("min", "max"):
        return schema.field(spec.column).type not in ("float32", "float64")
    return False


def partial_from_stats(specs: Sequence[AggSpec],
                       stats: Mapping[str, ColumnStats], num_rows: int,
                       schema: Schema) -> "AggState | None":
    """Build a fragment's partial state from footer stats alone (the
    zero-I/O path for ungrouped, predicate-free aggregates).  Returns
    None when any spec needs real data."""
    cells: list[Any] = []
    for s in specs:
        if not stats_answerable(s, schema):
            return None
        if s.column is None:
            cells.append(int(num_rows))
            continue
        st = stats.get(s.column)
        if st is None or st.count != num_rows:
            return None                 # stats absent or partial
        if s.op == "count":
            cells.append(int(st.count - st.null_count))
        else:
            # all-null chunk: min/max stats are None, and so is the cell
            cells.append(_py(st.min if s.op == "min" else st.max))
    return AggState(specs, None, cells=cells, rows=num_rows)
