"""Where the port's client scan spends its time, on one NVIDIA GPU.

Builds the slice's cluster (``--row-groups`` row groups of 1,048,576 rows
of the taxi-like table, one per file), then runs the slice's query with
the default (card) backend:

* once with one scan thread under ``cProfile``: the host functions that
  take the time, by self time;
* once with one scan thread under ``torch.profiler``: the device time by
  kernel and copy, and the device's busy share of the wall time;
* a few times with the default 16 scan threads, against the NumPy
  backend in turns, for rows/s.

Run from the root of a checkout on a machine with a CUDA device:

    PYTHONPATH=src python benchmarks/torch_scan_profile.py [--seed 0]

It imports nothing of JAX or the ``repro`` package.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import sys
import time

import torch

from repro_torch import workload
from repro_torch.core import dataset, make_cluster, write_flat


def build(seed: int, row_groups: int):
    rows = workload.ROW_GROUP_ROWS
    fs = make_cluster(8)
    for i in range(row_groups):
        write_flat(fs, f"/taxi/part{i:05d}.arw",
                   workload.taxi_like_table(rows, seed=seed + i,
                                            start=i * rows),
                   row_group_rows=rows)
    return dataset(fs, "/taxi"), row_groups * rows


def query(ds, **kw):
    return ds.query(format="parquet", **kw).filter(workload.SCAN_PREDICATE) \
        .select(*workload.SCAN_COLUMNS)


def timed(ds, **kw) -> float:
    t0 = time.perf_counter()
    query(ds, **kw).to_table()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--row-groups", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_scan_profile: no CUDA device", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    ds, rows = build(args.seed, args.row_groups)
    query(ds).to_table()                      # build, warm-up

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(lambda: query(ds, num_threads=1).to_table())
    serial_s = time.perf_counter() - t0
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(18)
    print(f"host profile, 1 scan thread, card backend: {serial_s:.4f} s "
          f"wall under cProfile")
    print("\n".join(ln for ln in out.getvalue().splitlines()
                    if ln.strip())[:6000])

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as tp:
        t0 = time.perf_counter()
        query(ds, num_threads=1).to_table()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = {}                # device-side events only: kernels, copies
    for evt in tp.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", 0.0)
        if us > 0:
            device[evt.key] = (us, evt.count)
    busy_us = sum(us for us, _ in device.values())
    print(f"device profile, 1 scan thread: wall {wall:.4f} s, device busy "
          f"{busy_us / 1e6:.6f} s = {100 * busy_us / 1e6 / wall:.3f}% "
          f"(idle {100 - 100 * busy_us / 1e6 / wall:.3f}%)")
    for key, (us, count) in sorted(device.items(), key=lambda kv: -kv[1][0]):
        print(f"  {us / 1e3:10.3f} ms  {count:6d}x  {key[:90]}")

    card, host = [], []
    for i in range(args.pairs):
        if i % 2:
            card.append(timed(ds))
            host.append(timed(ds, decode_backend="numpy"))
        else:
            host.append(timed(ds, decode_backend="numpy"))
            card.append(timed(ds))
    res = {"rows": rows, "card_s": card, "numpy_s": host,
           "card_rows_per_s_median": rows / sorted(card)[len(card) // 2],
           "numpy_rows_per_s_median": rows / sorted(host)[len(host) // 2],
           "serial_card_wall_s": wall, "device_busy_s": busy_us / 1e6}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
