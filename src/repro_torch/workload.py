"""The scan the port's smoke run and tests drive.

``taxi_like_table`` is the repository's NYC-TLC-yellow-trip-like table
(17 columns, the schema of ``benchmarks/common.py``), made from a seed.
``SCAN_PREDICATE`` and ``SCAN_COLUMNS`` are the slice's query: a PLAIN
float64 compare and a DICT int32 compare, and a projection that mixes
DELTA, DICT and PLAIN columns.  ``ROW_GROUP_ROWS`` is Apache Arrow's
default Parquet row-group length (1024 x 1024).
"""

from __future__ import annotations

import numpy as np

from repro_torch.aformat.expressions import field
from repro_torch.aformat.table import Table

ROW_GROUP_ROWS = 1024 * 1024
SCAN_PREDICATE = (field("fare_amount") > 40.0) & \
    (field("passenger_count") >= 2)
SCAN_COLUMNS = ["trip_id", "vendor_id", "passenger_count", "pu_location",
                "fare_amount", "tip_amount", "extra"]


def taxi_like_table(n_rows: int, seed: int = 0, start: int = 0) -> Table:
    """``n_rows`` trips; ``trip_id`` counts from ``start``."""
    rng = np.random.default_rng(seed)
    return Table.from_pydict({
        "trip_id": np.arange(start, start + n_rows, dtype=np.int64),
        "vendor_id": rng.integers(1, 3, n_rows).astype(np.int32),
        "passenger_count": rng.integers(1, 7, n_rows).astype(np.int32),
        "trip_distance": rng.gamma(1.5, 2.0, n_rows).astype(np.float32),
        "rate_code": rng.integers(1, 7, n_rows).astype(np.int32),
        "pu_location": rng.integers(1, 266, n_rows).astype(np.int32),
        "do_location": rng.integers(1, 266, n_rows).astype(np.int32),
        "fare_amount": rng.gamma(2.0, 7.5, n_rows).astype(np.float64),
        "tip_amount": rng.gamma(1.2, 2.5, n_rows).astype(np.float32),
        "tolls_amount": (rng.random(n_rows) < 0.05).astype(np.float32)
        * rng.gamma(2.0, 3.0, n_rows).astype(np.float32),
        "total_amount": rng.gamma(2.2, 8.0, n_rows).astype(np.float64),
        "payment_type": rng.integers(1, 5, n_rows).astype(np.int32),
        "extra": rng.choice([0.0, 0.5, 1.0], n_rows).astype(np.float32),
        "mta_tax": np.full(n_rows, 0.5, np.float32),
        "congestion": (rng.random(n_rows) < 0.3).astype(np.float32) * 2.5,
        "airport_fee": (rng.random(n_rows) < 0.1).astype(np.float32) * 1.75,
        "duration_s": rng.gamma(2.0, 600.0, n_rows).astype(np.float32),
    })
