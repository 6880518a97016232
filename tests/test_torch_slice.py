"""The port's first slice as a whole: the client-side Dataset scan.

Pinned here, on the CPU: the port writes the reference's bytes; a
cluster carried across by ``interop.cluster_from_files`` scans, in the
port, to the reference's result; the slice's query through
``TorchBackend(device="cpu")`` matches the reference's host scan; and
the port is self-contained — it imports neither JAX nor the ``repro``
package, by a subprocess and by an AST walk.
"""

import ast
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.aformat.expressions import Expr as RefExpr
from repro.aformat.table import Table as RefTable
from repro.core import dataset as ref_dataset
from repro.core import make_cluster as ref_make_cluster
from repro.core import write_flat as ref_write_flat
from repro.storage.layouts import write_split as ref_write_split
from repro.storage.layouts import write_striped as ref_write_striped
from repro_torch import interop, workload
from repro_torch.aformat.decode import TorchBackend
from repro_torch.core import (dataset, make_cluster, write_flat, write_split,
                              write_striped)

from test_decode import assert_bytes_identical

# One intra-op thread: the suite runs in several worker processes at once,
# and the tensors here are small.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TORCH = TorchBackend(device="cpu")


def ref_table(tbl) -> RefTable:
    """The port's table as the reference's, from the same arrays."""
    return RefTable.from_pydict({c.field.name: c.values
                                 for c in tbl.columns})


def ref_expr(pred) -> RefExpr:
    return RefExpr.from_json(pred.to_json())


def files_of(fs) -> dict:
    """Every file of a cluster, as plain values, through its public API."""
    out = {}
    for path in fs.listdir(""):
        ino = fs.stat(path)
        out[path] = (fs.read_file(path), dict(ino.xattrs), ino.stripe_unit)
    return out


def test_workload_table_is_the_benchmarks_table():
    spec = importlib.util.spec_from_file_location(
        "bench_common", ROOT / "benchmarks" / "common.py")
    common = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = common
    spec.loader.exec_module(common)
    want = common.taxi_like_table(3000, seed=5)
    got = workload.taxi_like_table(3000, seed=5)
    assert_bytes_identical(want, got)
    assert len(got.schema) == 17


@pytest.mark.parametrize("rows,rgr,codec,indexes", [
    (5000, 1024, "zlib", True),
    (3000, 3000, "none", False),
    (2049, 512, "zlib", False),
])
def test_writer_bytes_identical(rows, rgr, codec, indexes):
    """The same seeded table, written by both packages: identical object
    bytes and xattrs."""
    tbl = workload.taxi_like_table(rows, seed=rows)
    ref_fs, fs = ref_make_cluster(4), make_cluster(4)
    ref_write_flat(ref_fs, "/t/a.arw", ref_table(tbl), row_group_rows=rgr,
                   codec=codec, build_indexes=indexes)
    write_flat(fs, "/t/a.arw", tbl, row_group_rows=rgr, codec=codec,
               build_indexes=indexes)
    ref_files, files = files_of(ref_fs), files_of(fs)
    assert ref_files.keys() == files.keys()
    for path in files:
        assert ref_files[path] == files[path], path
    assert [ref_fs.store.get(n) for n in ref_fs.object_names("/t/a.arw")] \
        == [fs.store.get(n) for n in fs.object_names("/t/a.arw")]


@pytest.mark.parametrize("layout", ["striped", "split"])
def test_other_layouts_write_identical_files(layout):
    tbl = workload.taxi_like_table(4000, seed=9)
    ref_fs, fs = ref_make_cluster(4), make_cluster(4)
    if layout == "striped":
        ref_write_striped(ref_fs, "/t/s.arw", ref_table(tbl),
                          row_group_rows=1000)
        write_striped(fs, "/t/s.arw", tbl, row_group_rows=1000)
    else:
        ref_write_split(ref_fs, "/t/s.arw", ref_table(tbl),
                        row_group_rows=1000)
        write_split(fs, "/t/s.arw", tbl, row_group_rows=1000)
    assert files_of(ref_fs) == files_of(fs)


def test_advisor_divergence_with_advise():
    """Known divergence (ROADMAP F2): with ``advise=True`` the port's
    advisor prices the kernel route at the port's prior (the base 150e6
    B/s, no H100 rate measured yet), the reference's at its 1.5e9 TPU
    prior, so small integer columns pick BITPACK in the port where the
    reference picks DICTP.  Both files hold the same table."""
    from repro.aformat import parquet as ref_parquet
    from repro_torch.aformat import parquet

    tbl = workload.taxi_like_table(20_000, seed=1)
    a = ref_parquet.write_table(ref_table(tbl), row_group_rows=20_000,
                                advise=True)
    b = parquet.write_table(tbl, row_group_rows=20_000, advise=True)

    def chosen(mod, data):
        meta = mod.read_footer(mod.BytesSource(data))
        return {f.name: c.encoding
                for f, c in zip(meta.schema, meta.row_groups[0].chunks)}

    assert (chosen(ref_parquet, a)["vendor_id"],
            chosen(parquet, b)["vendor_id"]) == ("dictp", "bitpack")
    assert_bytes_identical(
        ref_parquet.scan_file(ref_parquet.BytesSource(a)),
        parquet.scan_file(parquet.BytesSource(b), backend=TORCH))
    # the default writer does not consult the advisor: identical bytes
    assert ref_parquet.write_table(ref_table(tbl), row_group_rows=20_000) \
        == parquet.write_table(tbl, row_group_rows=20_000)


@pytest.fixture
def reference_cluster():
    fs = ref_make_cluster(8)
    for i in range(3):
        part = workload.taxi_like_table(4096, seed=i, start=i * 4096)
        ref_write_flat(fs, f"/taxi/part{i:05d}.arw", ref_table(part),
                       row_group_rows=2048)
    return fs


def slice_query(ds, **kw):
    return ds.query(format="parquet", **kw).filter(workload.SCAN_PREDICATE) \
        .select(*workload.SCAN_COLUMNS)


def test_interop_cluster_scans_to_reference_result(reference_cluster):
    ref_ds = ref_dataset(reference_cluster, "/taxi")
    want = ref_ds.query(format="parquet").filter(
        ref_expr(workload.SCAN_PREDICATE)).select(
        *workload.SCAN_COLUMNS).to_table()
    fs = interop.cluster_from_files(files_of(reference_cluster))
    assert files_of(fs) == files_of(reference_cluster)
    got = slice_query(dataset(fs, "/taxi"), decode_backend=TORCH).to_table()
    assert len(got) > 0
    order = np.argsort(got.column("trip_id").values)
    want_order = np.argsort(want.column("trip_id").values)
    assert_bytes_identical(want.take(want_order), got.take(order))


def test_slice_query_routes_every_hook_to_a_kernel(reference_cluster):
    """The slice's query on the slice's table takes all three kernel
    routes: DICT gathers, the fused predicate, the compaction."""
    fs = interop.cluster_from_files(files_of(reference_cluster))
    ds = dataset(fs, "/taxi")
    plan = slice_query(ds, decode_backend=TORCH).explain()
    assert "pred=fused" in plan
    assert "kernel=vendor_id,passenger_count,pu_location" in plan
    frag = ds.fragments()[0]
    meta = frag.client_meta
    from repro_torch.aformat import parquet

    report = {}
    TORCH.scan_row_group(parquet.BytesSource(fs.read_file(frag.path)), meta,
                         meta.row_groups[frag.client_rg_index],
                         workload.SCAN_COLUMNS, workload.SCAN_PREDICATE,
                         report=report)
    assert report["predicate"] == "kernel"
    assert report["columns"]["passenger_count"] == "kernel"
    assert set(report["compact"].values()) == {"kernel"}


def test_default_client_backend_is_the_card(reference_cluster):
    """``format="parquet"`` with no backend asks for the card: here, with
    no card, it raises instead of scanning on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ds = dataset(interop.cluster_from_files(files_of(reference_cluster)),
                 "/taxi")
    with pytest.raises(RuntimeError, match="cuda"):
        slice_query(ds).to_table()


# ---------------------------------------------------------------------------
# self-containment
# ---------------------------------------------------------------------------


def test_import_leaves_no_jax_or_reference_module():
    code = ("import json, sys\n"
            "import repro_torch.core, repro_torch.aformat.decode\n"
            "import repro_torch.interop, repro_torch.workload\n"
            "import repro_torch.kernels.build\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'repro'"
            " or m.startswith(('repro.', 'jax', 'jaxlib')))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, check=True,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix()
     for p in (ROOT / "src" / "repro_torch").rglob("*.py")]
    + ["chip_smoke.py"]))
def test_port_source_imports_nothing_of_jax_or_repro(path):
    bad = {n for n in _imports(ROOT / path)
           if n.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path} imports {sorted(bad)}"
