"""The port's decode plane against the reference's, on the CPU.

``TorchBackend(device="cpu")`` runs the kernels' plain PyTorch versions
through exactly the routing the card takes, so these tests pin, row group
by row group and through the Dataset API, that the port's scan is
byte-identical to the reference's ``NumPyBackend``: same dtypes, same
bits, same validity.  The grid is ``tests/test_decode.py``'s (encoding x
dtype x validity x predicate, projections, the fallback mix,
``scan_file``), plus NaN, ±inf and -0.0 — which the reference's
``PallasBackend`` loses (ROADMAP fault F1), so it is compared on finite
data only.
"""

import numpy as np
import pytest
import torch

from repro.aformat import parquet as ref_parquet
from repro.aformat.decode import NumPyBackend as RefNumPy
from repro.aformat.decode import PallasBackend as RefPallas
from repro.aformat.expressions import field as ref_field
from repro.aformat.schema import schema as ref_schema
from repro.aformat.table import Column as RefColumn
from repro.aformat.table import Table as RefTable
from repro.core import dataset as ref_dataset
from repro.core import make_cluster as ref_make_cluster
from repro.core import write_flat as ref_write_flat
from repro_torch.aformat import parquet
from repro_torch.aformat.decode import (NumPyBackend, TorchBackend,
                                        resolve_backend)
from repro_torch.aformat.expressions import Expr
from repro_torch.aformat.schema import Field, Schema
from repro_torch.aformat.table import Column, Table
from repro_torch.core import dataset, make_cluster, write_flat
from repro_torch.dataset.format import ParquetFormat, resolve_format
from repro_torch.dataset.scheduler import ScanScheduler

from test_decode import (PREDICATES, PROJECTIONS, assert_bytes_identical,
                         mixed_table)

# One intra-op thread: the suite runs in several worker processes at once,
# and the tensors here are small.
torch.set_num_threads(1)

TORCH = TorchBackend(device="cpu")
REF_NUMPY = RefNumPy()
REF_PALLAS = RefPallas()


# ---------------------------------------------------------------------------
# differential harness: reference bytes, reference scan vs port scan
# ---------------------------------------------------------------------------


def port_expr(pred):
    """The same predicate, as the port's expression tree."""
    return None if pred is None else Expr.from_json(pred.to_json())


def port_table(tbl: RefTable) -> Table:
    """The same columns, as the port's Table."""
    fields = [Field(f.name, f.type, f.nullable) for f in tbl.schema]
    return Table(Schema(tuple(fields)),
                 [Column(f, c.values, c.validity)
                  for f, c in zip(fields, tbl.columns)])


def scan_both(tbl, columns=None, predicate=None, row_group_rows=256,
              backend=TORCH, reference=REF_NUMPY):
    """Write ``tbl`` with the reference writer; scan every row group with
    the reference backend and with the port's; assert byte-identity and
    return (reference result, port result, last port routing report)."""
    data = ref_parquet.write_table(tbl, row_group_rows=row_group_rows)
    ref_src = ref_parquet.BytesSource(data)
    ref_meta = ref_parquet.read_footer(ref_src)
    src = parquet.BytesSource(data)
    meta = parquet.read_footer(src)
    pred = port_expr(predicate)
    outs_ref, outs, report = [], [], {}
    for ref_rg, rg in zip(ref_meta.row_groups, meta.row_groups):
        out_ref = reference.scan_row_group(ref_src, ref_meta, ref_rg,
                                           columns, predicate)
        report = {}
        out = backend.scan_row_group(src, meta, rg, columns, pred,
                                     report=report)
        assert_bytes_identical(out_ref, out)
        outs_ref.append(out_ref)
        outs.append(out)
    return RefTable.concat(outs_ref), Table.concat(outs), report


def special_table(n=600, seed=0, with_nulls=False):
    """``mixed_table`` with NaN, ±inf and -0.0 in its float columns, plus
    DICT float columns whose dictionaries hold them."""
    tbl = mixed_table(n, seed, with_nulls)
    rng = np.random.default_rng(seed + 1)
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0])
    cols = {c.field.name: c for c in tbl.columns}
    f32 = cols["f32"].values.copy()
    f64 = cols["f64"].values.copy()
    hit = rng.random(n) < 0.2
    f32[hit] = rng.choice(specials, hit.sum()).astype(np.float32)
    f64[hit] = rng.choice(specials, hit.sum())
    fcat = rng.choice(np.array([np.nan, 1.5, -0.0, 2.5], np.float32), n)
    dcat = rng.choice(np.array([np.inf, -np.inf, -0.0, 3.25, 2.0 ** 60]), n)
    out = []
    for c in tbl.columns:
        v = {"f32": f32, "f64": f64}.get(c.field.name, c.values)
        out.append(RefColumn(c.field, v, c.validity))
    extra = RefTable.from_pydict({"fcat": fcat, "dcat": dcat})
    names = [(f.name, f.type) for f in tbl.schema] + \
        [("fcat", "float32"), ("dcat", "float64")]
    nullable = ("cat", "f32") if with_nulls else ()
    return RefTable(ref_schema(*names, nullable=nullable),
                    out + [RefColumn(c.field, c.values, None)
                           for c in extra.columns])


SPECIAL_PREDICATES = {
    **PREDICATES,
    "nan-ne": ref_field("fcat") != 1.5,
    "neg-zero-eq": ref_field("f64") == 0.0,
    "inf-ge": (ref_field("dcat") >= -np.inf) & (ref_field("f32") > -1.0),
    "wide-float": ref_field("dcat") < 2.0 ** 60,
}


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pred_name", sorted(PREDICATES))
@pytest.mark.parametrize("nulls", [False, True], ids=["dense", "nulls"])
def test_torch_backend_byte_identical(pred_name, nulls):
    tbl = mixed_table(with_nulls=nulls)
    out_ref, out, _ = scan_both(tbl, predicate=PREDICATES[pred_name])
    assert len(out_ref) == len(out)


@pytest.mark.parametrize("proj_name", sorted(PROJECTIONS))
def test_torch_backend_byte_identical_projected(proj_name):
    scan_both(mixed_table(), columns=PROJECTIONS[proj_name],
              predicate=PREDICATES["flat-and"])


@pytest.mark.parametrize("pred_name", sorted(SPECIAL_PREDICATES))
@pytest.mark.parametrize("nulls", [False, True], ids=["dense", "nulls"])
def test_torch_backend_special_floats(pred_name, nulls):
    """NaN, ±inf and -0.0 through every hook: bits survive the gather and
    the compaction, and compares follow IEEE exactly as NumPy does."""
    tbl = special_table(with_nulls=nulls)
    out_ref, out, report = scan_both(tbl,
                                     predicate=SPECIAL_PREDICATES[pred_name])
    assert report["columns"]["fcat"] == "kernel"
    assert report["columns"]["dcat"] == "kernel"


@pytest.mark.parametrize("pred_name", ["none", "flat-and", "flat-or",
                                       "three-way-and", "empty-result"])
def test_torch_matches_reference_pallas_on_finite_data(pred_name):
    """Against the reference's accelerator path too, where it is exact:
    finite values without -0.0."""
    scan_both(mixed_table(), predicate=PREDICATES[pred_name],
              reference=REF_PALLAS)


def test_fallback_mix_within_one_row_group():
    """One row group where kernel and host columns coexist.  Routing
    follows types and encodings alone: the DICT int64 column beyond
    2**24 goes to the kernel in the port, in its own dtype."""
    _, _, report = scan_both(mixed_table(), predicate=PREDICATES["flat-and"],
                             row_group_rows=600)
    assert report["columns"]["cat"] == "kernel"
    assert report["columns"]["big"] == "kernel"
    assert report["columns"]["seq"] == "host"      # DELTA byte stream
    assert report["columns"]["pay"] == "host"      # strings
    assert report["columns"]["f32"] == "host"      # PLAIN
    assert report["predicate"] == "kernel"
    assert report["compact"]["cat"] == "kernel"
    assert report["compact"]["flag"] == "kernel"
    assert report["compact"]["pay"] == "host"


@pytest.mark.parametrize("pred_name,route", [
    ("string-cmp", "host:pay:string"),
    ("bool-eq", "host:flag:bool"),
    ("isin", "host:unsupported-node"),
    ("mixed-logic", "host:unsupported-node"),
    ("f64-cmp", "kernel"),          # float64 compare, native
    ("big-int", "kernel"),          # int64 beyond 2**24, native
    ("inexact-const", "kernel"),    # float32 compare, NumPy's rounding
])
def test_predicate_routes(pred_name, route):
    _, _, report = scan_both(mixed_table(), predicate=PREDICATES[pred_name],
                             row_group_rows=600)
    assert report["predicate"] == route


def test_predicate_constant_out_of_range_stays_on_host():
    _, _, report = scan_both(mixed_table(),
                             predicate=ref_field("cat") < 2 ** 40,
                             row_group_rows=600)
    assert report["predicate"] == "host:cat:value"


def test_validity_or_falls_back_and_stays_fused_under_and():
    tbl = mixed_table(with_nulls=True)
    _, _, rep_and = scan_both(tbl, predicate=PREDICATES["flat-and"],
                              row_group_rows=600)
    assert rep_and["predicate"] == "kernel"
    for name in ("flat-or", "not"):
        _, _, rep = scan_both(tbl, predicate=PREDICATES[name],
                              row_group_rows=600)
        assert rep["predicate"] == "host:cat:validity"


def test_scan_file_backend_equivalence(taxi_table):
    data = ref_parquet.write_table(taxi_table, row_group_rows=2048)
    pred = (ref_field("fare_amount") > 20.0) & \
        (ref_field("passenger_count") <= 2)
    a = ref_parquet.scan_file(ref_parquet.BytesSource(data), predicate=pred)
    b = parquet.scan_file(parquet.BytesSource(data),
                          predicate=port_expr(pred), backend=TORCH)
    assert_bytes_identical(a, b)


# ---------------------------------------------------------------------------
# resolution: the client formats default to the card
# ---------------------------------------------------------------------------


def test_resolve_backend():
    assert resolve_backend(None) is resolve_backend("numpy")
    assert isinstance(resolve_backend(None), NumPyBackend)
    assert resolve_backend(TORCH) is TORCH
    assert ParquetFormat(decode_backend="numpy").decode_backend is \
        resolve_backend("numpy")
    assert ParquetFormat(decode_backend=TORCH).decode_backend is TORCH
    for bad in ("cuda", "pallas"):
        with pytest.raises(ValueError, match="unknown decode backend"):
            resolve_backend(bad)


def test_card_backend_raises_without_a_card():
    """No silent host run: the default client backend names the device
    and raises when there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_backend("torch")
    with pytest.raises(RuntimeError, match="cuda"):
        ParquetFormat()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_format("parquet")
    with pytest.raises(ValueError, match="unsupported device"):
        TorchBackend("meta")


# ---------------------------------------------------------------------------
# plumbing: decode_backend= through the Dataset API, on both packages
# ---------------------------------------------------------------------------


@pytest.fixture
def both_clusters(taxi_table):
    """The same 2 x 5000 rows on a reference cluster and a port cluster."""
    ref_fs, fs = ref_make_cluster(8), make_cluster(8)
    for i in range(2):
        part = taxi_table.slice(i * 5000, 5000)
        ref_write_flat(ref_fs, f"/d/part{i}.arw", part, row_group_rows=1024)
        write_flat(fs, f"/d/part{i}.arw", port_table(part),
                   row_group_rows=1024)
    return ref_dataset(ref_fs, "/d"), dataset(fs, "/d")


def sorted_by_trip(tbl):
    return tbl.take(np.argsort(tbl.column("trip_id").values, kind="stable"))


@pytest.mark.parametrize("fmt", ["parquet", "adaptive", "pushdown"])
def test_query_matches_reference(both_clusters, fmt):
    """Client, adaptive and storage-side placements; the storage side
    (``scan_op``) decodes on the host path and needs no card."""
    ref_ds, ds = both_clusters
    pred = (ref_field("fare_amount") > 25.0) & \
        (ref_field("passenger_count") >= 4)
    cols = ["trip_id", "passenger_count", "fare_amount", "payment_type"]
    want = ref_ds.query(format=fmt).filter(pred).select(*cols).to_table()
    backend = None if fmt == "pushdown" else TORCH
    got = ds.query(format=fmt, decode_backend=backend) \
        .filter(port_expr(pred)).select(*cols).to_table()
    assert len(got) > 0
    assert_bytes_identical(sorted_by_trip(want), sorted_by_trip(got))


def test_scanner_decode_backend(both_clusters, taxi_table):
    ref_ds, ds = both_clusters
    pred = ref_field("passenger_count") >= 4
    want = ref_ds.scanner(format="parquet", predicate=pred).to_table()
    got = ds.scanner(format="parquet", predicate=port_expr(pred),
                     decode_backend=TORCH).to_table()
    assert_bytes_identical(sorted_by_trip(want), sorted_by_trip(got))
    exp = int((taxi_table.column("passenger_count").values[:10000]
               >= 4).sum())
    assert len(got) == exp


def test_explain_names_torch_routing(both_clusters):
    _, ds = both_clusters
    pred = port_expr(ref_field("passenger_count") >= 4)
    plan = ds.query(format="parquet", decode_backend=TORCH) \
        .filter(pred).select("trip_id").explain()
    assert "backend=torch[" in plan
    assert "kernel=passenger_count" in plan
    assert "pred=fused" in plan
    host_plan = ds.query(format="parquet", decode_backend="numpy") \
        .filter(pred).explain()
    assert "backend=numpy" in host_plan
    adaptive = ds.query(format="adaptive", decode_backend=TORCH) \
        .filter(port_expr(ref_field("fare_amount") > 30.0)).explain()
    assert "backend[client]=torch[" in adaptive
    assert "backend[osd]=numpy" in adaptive


def test_describe_matches_live_routing(both_clusters):
    """The footer-only routing explain() prints agrees with what the live
    scan does."""
    _, ds = both_clusters
    frag = ds.fragments()[0]
    meta = frag.client_meta
    rg = meta.row_groups[frag.client_rg_index]
    cols = ["trip_id", "passenger_count", "payment_type", "fare_amount"]
    desc = TORCH.describe(meta, rg, cols, None)
    report = {}
    src = parquet.BytesSource(ds.fs.read_file(frag.path))
    TORCH.scan_row_group(src, meta, rg, cols, None, report=report)
    for name, route in report["columns"].items():
        assert (f"{name}(" not in desc) == (route == "kernel"), name
    assert "payment_type(dict)" in desc       # strings stay on the host


def test_client_prior_and_observations():
    """The port's backend keeps the base prior until a card measurement
    replaces it, and — being another engine than the OSD's — keeps its
    observations on the client side."""
    sched = ScanScheduler(make_cluster(8), decode_backend=TORCH)
    assert sched._client_rate_prior == TorchBackend.decode_rate_prior \
        == NumPyBackend.decode_rate_prior == 150e6
    sched._observe("osd", 10_000_000, 0.1, 1000)
    assert sched._decode_rate_client._v is None
    sched._observe("client", 10_000_000, 0.01, 1000)
    assert sched._decode_rate_client.value(0) == pytest.approx(1e9)
    assert sched._decode_rate_osd.value(0) == pytest.approx(1e8)
