#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit:

    python3 chip_smoke.py [--seed 0] [--row-groups 4] [--reps 20]

Phases, each of which must pass:

1. device: the card's name, the device count and ``nvidia-smi``'s name and
   power limit;
2. build: every ``src/repro_torch/kernels/csrc/*.cu`` compiled for sm_90a
   (seconds, and ptxas's register and shared-memory lines);
3. kernels: each kernel at the main path's shapes (one row group of
   1,048,576 rows of the taxi-like table), held bit for bit against its
   plain PyTorch version on the card, with NaN, ±inf, -0.0 and int64
   beyond 2**53 among the inputs; then its time (CUDA events, median over
   ``--reps`` calls enqueued behind a sleep kernel, L2 flushed before
   each), the host's wall time per call, its bound (bytes over 3.35 TB/s),
   the plain version's time and one PyTorch call's time;
4. scan: the port's main path — ``make_cluster`` → ``write_flat`` →
   ``dataset`` → ``query(format="parquet").filter(pred).select(cols)
   .to_table()`` — over ``--row-groups`` row groups of 1,048,576 rows,
   on the card (the default backend) and on the host
   (``decode_backend="numpy"``); the two results must be byte-identical,
   and every kernel must have launched during the card's run.

It prints a ``{"kernels": [...]}`` line, ``nvidia-smi``'s line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or when any
phase fails, it exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
L2_FLUSH_BYTES = 128 << 20       # > the 50 MB L2
SLEEP_CYCLES = 100_000_000       # about 50 ms: longer than enqueuing the reps


def log(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# timing and comparison helpers
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int, flush) -> float:
    """Median device time of ``fn`` in ms, by CUDA events around each
    call, after one warm-up call, with the L2 cache flushed before each.
    A sleep kernel holds the stream while the calls are enqueued, so the
    events time the device's work and not the host's launch latency (a
    call that synchronises inside still pays its own wait)."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def host_ms(fn, reps: int) -> float:
    """Host wall time of one call in ms, launches and synchronisation
    included: what a caller waits for, where ``time_ms`` is the device's
    share."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def bits_equal(a, b) -> bool:
    """Same dtype, shape and bytes (NaN payloads and -0.0 included)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def max_abs_err(a, b) -> float:
    """Largest |a - b| over the elements finite in both."""
    import torch

    x, y = a.double(), b.double()
    ok = torch.isfinite(x) & torch.isfinite(y)
    if not bool(ok.any()):
        return 0.0
    return float((x[ok] - y[ok]).abs().max())


class Parity:
    """Every kernel-vs-plain comparison of one kernel."""

    def __init__(self, name: str):
        self.name, self.cases, self.err = name, 0, 0.0

    def check(self, case: str, got, want) -> None:
        self.cases += 1
        if not bits_equal(got, want):
            raise AssertionError(
                f"{self.name}[{case}]: kernel differs from its plain "
                f"version (max abs err {max_abs_err(got, want)})")
        self.err = max(self.err, max_abs_err(got, want))


# ---------------------------------------------------------------------------
# phase 3: the kernels at the main path's shapes
# ---------------------------------------------------------------------------


def row_group_inputs(seed: int):
    """One row group of the slice's table, as the card sees it: the DICT
    codes and dictionaries of the query's DICT columns, the predicate's
    columns, and the columns the compaction copies."""
    import numpy as np
    import torch

    from repro_torch import workload
    from repro_torch.aformat import encodings

    tbl = workload.taxi_like_table(workload.ROW_GROUP_ROWS, seed=seed)
    gathers = {}
    for name in workload.SCAN_COLUMNS:
        col = tbl.column(name)
        if encodings.choose_encoding(col.field.type, col.values) != \
                encodings.DICT:
            continue
        codes, dic = encodings.encode(col.field.type, encodings.DICT,
                                      col.values)
        gathers[name] = (
            torch.from_numpy(np.frombuffer(codes, np.int32).copy()).cuda(),
            torch.from_numpy(np.frombuffer(
                dic, col.field.numpy_dtype).copy()).cuda())
    columns = {n: torch.from_numpy(tbl.column(n).values.copy()).cuda()
               for n in workload.SCAN_COLUMNS}
    return gathers, columns


def special_values(n: int, seed: int):
    """Columns of the main path's length full of the values the TPU
    kernels lost: NaN (with a payload), ±inf, -0.0, int64 beyond 2**53."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    payload_nan = np.array([0x7FF0000000000123], np.uint64).view(np.float64)
    f64_pool = np.concatenate([[np.nan, np.inf, -np.inf, -0.0, 0.0, 1.5,
                                -2.25, 1e300], payload_nan])
    i64_pool = np.array([0, -1, 2 ** 53 + 1, 2 ** 53 + 2, -(2 ** 62) - 7,
                         2 ** 63 - 1, 2 ** 24 + 1], np.int64)
    f64 = rng.choice(f64_pool, n)
    return {
        "float64": torch.from_numpy(f64).cuda(),
        "float32": torch.from_numpy(
            rng.choice(f64_pool[:7], n).astype(np.float32)).cuda(),
        "int64": torch.from_numpy(rng.choice(i64_pool, n)).cuda(),
        "int32": torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, n,
                                               dtype=np.int32)).cuda(),
        "bool": torch.from_numpy(rng.random(n) < 0.5).cuda(),
    }


def check_dict_decode(gathers, specials, seed, reps, flush):
    import numpy as np
    import torch

    from repro_torch.kernels.dict_decode import dict_decode as dd
    from repro_torch.kernels.dict_decode.ref import dict_decode_ref

    parity = Parity("dict_decode")
    n = next(iter(gathers.values()))[0].numel()
    for name, (codes, dic) in gathers.items():
        parity.check(f"{name} D={dic.numel()}", dd.dict_decode(codes, dic),
                     dict_decode_ref(codes, dic))
    rng = np.random.default_rng(seed)
    for dtype, values in specials.items():
        if dtype == "bool":
            continue
        for d in (97, 200_000):        # staged in shared memory / via L2
            dic = values[:d].contiguous()
            codes = torch.from_numpy(rng.integers(0, d, n).astype(
                np.int32)).cuda()
            parity.check(f"{dtype} D={d}", dd.dict_decode(codes, dic),
                         dict_decode_ref(codes, dic))
    bad = torch.zeros(n, dtype=torch.int32, device="cuda")
    bad[n // 2] = 7
    try:
        dd.dict_decode(bad, specials["int64"][:7].contiguous())
    except ValueError:
        pass
    else:
        raise AssertionError("dict_decode: a code outside the dictionary "
                             "did not raise")

    outs = {k: torch.empty_like(codes, dtype=dic.dtype)
            for k, (codes, dic) in gathers.items()}
    err = torch.zeros(1, dtype=torch.int32, device="cuda")

    def kernel():
        for k, (codes, dic) in gathers.items():
            dd.launch(codes, dic, outs[k], err)

    def plain():
        for codes, dic in gathers.values():
            dict_decode_ref(codes, dic)

    def library():
        for codes, dic in gathers.values():
            torch.index_select(dic, 0, codes)

    nbytes = sum(4 * c.numel() + d.numel() * d.element_size()
                 + c.numel() * d.element_size()
                 for c, d in gathers.values())
    return parity, nbytes, {
        "ms": time_ms(kernel, reps, flush),
        "host_ms": host_ms(kernel, reps),
        "plain_ms": time_ms(plain, reps, flush),
        "library_ms": time_ms(library, reps, flush)}


def check_predicate(columns, specials, reps, flush):
    import numpy as np
    import torch

    from repro_torch import workload
    from repro_torch.aformat.decode import _KERNEL_OPS, _flatten
    from repro_torch.kernels.predicate_fused import predicate_fused as pf
    from repro_torch.kernels.predicate_fused.ref import predicate_mask_ref

    parity = Parity("predicate_fused")
    leaves, combine, negate = _flatten(workload.SCAN_PREDICATE)
    names = sorted({leaf.column for leaf in leaves})
    cols = [columns[n] for n in names]
    prog = pf.build_program(
        [(names.index(leaf.column), _KERNEL_OPS[leaf.op], leaf.value)
         for leaf in leaves],
        [torch.empty(0, dtype=c.dtype).numpy().dtype for c in cols],
        combine, negate)
    mask = pf.predicate_mask(cols, prog)
    parity.check("slice query", mask, predicate_mask_ref(cols, prog))

    spec = [specials[k] for k in ("float64", "float32", "int64", "int32")]
    dtypes = [np.float64, np.float32, np.int64, np.int32]
    programs = {
        f"{op} nan/inf/-0": ([(0, op, 1.5), (1, op, -0.0)], "and", False)
        for op in pf.OPS}
    programs.update({
        "vs nan": ([(0, "ne", float("nan")), (1, "eq", float("nan"))],
                   "or", False),
        "f32 vs 0.1, i64 beyond 2**53": ([(1, "lt", 0.1),
                                          (2, "ge", 2 ** 53 + 1)],
                                         "or", True),
        "i32 vs 2.5 (f64 compare)": ([(3, "gt", 2.5), (2, "ne", -1),
                                      (0, "le", float("inf"))],
                                     "and", False),
    })
    for case, (terms, comb, neg) in programs.items():
        p = pf.build_program(terms, dtypes, comb, neg)
        parity.check(case, pf.predicate_mask(spec, p),
                     predicate_mask_ref(spec, p))

    out = torch.empty_like(mask)
    nbytes = sum(c.numel() * c.element_size() for c in cols) + mask.numel()
    return parity, mask, nbytes, {
        "ms": time_ms(lambda: pf.launch(cols, prog, out), reps, flush),
        "host_ms": host_ms(lambda: pf.launch(cols, prog, out), reps),
        "plain_ms": time_ms(lambda: predicate_mask_ref(cols, prog), reps,
                            flush),
        "library_ms": None}


def check_token_pack(columns, mask, specials, reps, flush):
    import torch

    from repro_torch.kernels.token_pack import token_pack as tp
    from repro_torch.kernels.token_pack.ref import (block_counts_ref,
                                                    compact_ref,
                                                    pack_tokens_ref)

    parity = Parity("token_pack")
    offsets, count = tp.block_offsets(mask)
    counts = block_counts_ref(mask)
    parity.check("block offsets", offsets,
                 torch.cumsum(counts, 0, dtype=torch.int64) - counts)
    for name, values in {**columns, **specials}.items():
        parity.check(name, tp.compact(values, mask, offsets, count),
                     compact_ref(values, mask))
    for name in ("float64", "int64"):
        cap = max(1, count // 3)
        got, kept = tp.pack_tokens(specials[name], mask, cap)
        want, want_kept = pack_tokens_ref(specials[name], mask, cap)
        if kept != want_kept:
            raise AssertionError(f"token_pack: pack_tokens count {kept} != "
                                 f"{want_kept}")
        parity.check(f"pack_tokens {name} capacity {cap}", got, want)

    cols = list(columns.values())
    n = mask.numel()
    block_counts = torch.empty(-(-n // tp.BLOCK), dtype=torch.int32,
                               device="cuda")
    outs = [torch.empty(count, dtype=c.dtype, device="cuda") for c in cols]

    def kernel():
        tp.count_launch(mask, block_counts)
        inclusive = torch.cumsum(block_counts, 0, dtype=torch.int64)
        offs = inclusive - block_counts
        for c, o in zip(cols, outs):
            tp.scatter_launch(c, mask, offs, o)

    def plain():
        m = mask.ne(0)
        for c in cols:
            compact_ref(c, m)

    def library():
        m = mask.bool()
        for c in cols:
            torch.masked_select(c, m)

    nbytes = n + sum(c.element_size() * (n + count) for c in cols)
    return parity, count, nbytes, {
        "ms": time_ms(kernel, reps, flush),
        "host_ms": host_ms(kernel, reps),
        "plain_ms": time_ms(plain, reps, flush),
        "library_ms": time_ms(library, reps, flush)}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def sorted_by_trip(tbl):
    import numpy as np

    return tbl.take(np.argsort(tbl.column("trip_id").values, kind="stable"))


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def require_bytes_identical(a, b) -> None:
    """Same column names, row count, dtypes, bytes and validity."""
    import numpy as np

    require(a.schema.names == b.schema.names,
            f"columns {a.schema.names} != {b.schema.names}")
    require(len(a) == len(b), f"rows {len(a)} != {len(b)}")
    for ca, cb in zip(a.columns, b.columns):
        name = ca.field.name
        require(ca.values.dtype == cb.values.dtype, f"{name}: dtype")
        require(ca.values.tobytes() == cb.values.tobytes(), f"{name}: bytes")
        va = np.ones(len(ca), "?") if ca.validity is None else ca.validity
        vb = np.ones(len(cb), "?") if cb.validity is None else cb.validity
        require(np.array_equal(va, vb), f"{name}: validity")


def run_scan(seed: int, row_groups: int):
    import numpy as np

    from repro_torch import workload
    from repro_torch.aformat import decode, parquet
    from repro_torch.core import dataset, make_cluster, write_flat
    from repro_torch.kernels.dict_decode import dict_decode as dd
    from repro_torch.kernels.predicate_fused import predicate_fused as pf
    from repro_torch.kernels.token_pack import token_pack as tp

    rows = workload.ROW_GROUP_ROWS
    t0 = time.perf_counter()
    fs = make_cluster(8)
    for i in range(row_groups):
        write_flat(fs, f"/taxi/part{i:05d}.arw",
                   workload.taxi_like_table(rows, seed=seed + i,
                                            start=i * rows),
                   row_group_rows=rows)
    ds = dataset(fs, "/taxi")
    stored = sum(fs.file_size(p) for p in fs.listdir("/taxi"))
    log(f"scan: wrote {row_groups} row groups x {rows} rows "
        f"({stored} stored bytes) in {time.perf_counter() - t0:.3f} s")

    def query(**kw):
        return ds.query(format="parquet", **kw) \
            .filter(workload.SCAN_PREDICATE).select(*workload.SCAN_COLUMNS)

    frag = ds.fragments()[0]
    meta = frag.client_meta
    report = {}
    decode.resolve_backend("torch").scan_row_group(
        parquet.BytesSource(fs.read_file(frag.path)), meta,
        meta.row_groups[frag.client_rg_index], workload.SCAN_COLUMNS,
        workload.SCAN_PREDICATE, report=report)
    log("scan: routing of one row group " + json.dumps(report))
    log("scan: explain " + query().explain().splitlines()[-1].strip())
    query().to_table()                   # warm-up: allocator, threads

    dd.LAUNCHES = pf.LAUNCHES = tp.LAUNCHES = 0
    decode.TRANSFER_BYTES.update(h2d=0, d2h=0)
    t0 = time.perf_counter()
    out_card = query().to_table()        # the default backend: the card
    card_s = time.perf_counter() - t0
    launches = {"dict_decode": dd.LAUNCHES, "predicate_fused": pf.LAUNCHES,
                "token_pack": tp.LAUNCHES}
    transfers = dict(decode.TRANSFER_BYTES)

    t0 = time.perf_counter()
    out_host = query(decode_backend="numpy").to_table()
    host_s = time.perf_counter() - t0
    require_bytes_identical(sorted_by_trip(out_host),
                            sorted_by_trip(out_card))
    require(len(out_card) > 0, "the query selected no rows")
    for name in workload.SCAN_COLUMNS:
        values = out_card.column(name).values
        if values.dtype.kind == "f":
            require(bool(np.isfinite(values).all()), f"{name}: not finite")
    total = row_groups * rows
    log(f"scan: {total} rows -> {len(out_card)} rows, byte-identical to "
        f"the numpy backend")
    log(f"scan: card {card_s:.4f} s = {total / card_s:.1f} rows/s; "
        f"numpy {host_s:.4f} s = {total / host_s:.1f} rows/s")
    log(f"scan: copies per row group: host->card "
        f"{transfers['h2d'] / row_groups:.0f} bytes, card->host "
        f"{transfers['d2h'] / row_groups:.0f} bytes")
    log("scan: launches on the main path " + json.dumps(launches))
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    return launches


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--row-groups", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if args.row_groups < 4:
        ap.error("--row-groups: the smoke run scans at least 4")

    from repro_torch.kernels import build

    # 1. device
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.BUILD_INFO.get('seconds', 0.0):.2f} s)")
    for line in build.BUILD_INFO.get("ptxas", []):
        log("build: " + line.strip())

    # 3. kernels
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gathers, columns = row_group_inputs(args.seed)
    n = next(iter(columns.values())).numel()
    specials = special_values(n, args.seed)
    dd_par, dd_bytes, dd_t = check_dict_decode(gathers, specials, args.seed,
                                               args.reps, flush)
    pf_par, mask, pf_bytes, pf_t = check_predicate(columns, specials,
                                                   args.reps, flush)
    tp_par, selected, tp_bytes, tp_t = check_token_pack(
        columns, mask, specials, args.reps, flush)
    log(f"kernels: N={n}, {len(gathers)} DICT gathers "
        f"(D={[d.numel() for _, d in gathers.values()]}), "
        f"{selected} rows selected")
    del flush

    # 4. scan
    launches = run_scan(args.seed, args.row_groups)

    # 5. the kernels line
    src = "src/repro_torch/kernels/csrc/"
    rows = []
    for par, nbytes, times, source, replaces in (
            (dd_par, dd_bytes, dd_t, "dict_decode.cu",
             "src/repro/kernels/dict_decode/dict_decode.py:52"),
            (pf_par, pf_bytes, pf_t, "predicate_fused.cu",
             "src/repro/kernels/predicate_fused/predicate_fused.py:84"),
            (tp_par, tp_bytes, tp_t, "token_pack.cu",
             "src/repro/kernels/token_pack/token_pack.py:53")):
        rows.append({
            "name": par.name, "route": "cuda", "source": src + source,
            "replaces": replaces, "launches": launches[par.name],
            "max_abs_err": par.err, "ms": times["ms"],
            "plain_ms": times["plain_ms"],
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": times["library_ms"], "bytes": nbytes,
            "host_ms": times["host_ms"],
            "parity_cases": par.cases, "parity": "bit-equal"})
        log(f"kernel {par.name}: {par.cases} cases bit-equal; "
            f"{times['ms']:.5f} ms (host {times['host_ms']:.5f} ms) vs "
            f"bound {rows[-1]['bound_ms']:.5f} ms, "
            f"plain {times['plain_ms']:.5f} ms, library "
            f"{times['library_ms']} ms")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
