"""Measured encoding advisor: pick a chunk's encoding by encoding it.

``encodings.choose_encoding`` is a one-shot heuristic over a 4096-row
sample — cheap enough for the append hot path, but it guesses.  This
module is the measured alternative the compaction path uses
(``snapshot.MutableDataset.compact(advisor=True)`` →
``objclass.compact_op`` → ``parquet.encode_row_group(advise=True)``):
for each column chunk it *actually encodes* every applicable candidate,
compresses the buffers with the chunk's codec, and picks the cheapest by

    cost_s = stored_bytes / WIRE_RATE + stored_bytes / decode_rate

where ``decode_rate`` is the decode plane's per-backend rate prior for
the route that encoding would take (DICT/DICTP numeric chunks gather on
the CUDA kernel path; everything else decodes on the host) — so a
slightly larger encoding can still win when it unlocks the accelerated
decode route, exactly the stored-bytes-times-decode-rate trade the paper
prices.

Stored bytes stay primary: only candidates within ``BYTES_SLACK`` of
the smallest measured size compete on the rate-weighted cost.  Without
that gate a faster kernel prior would excuse multi-x byte inflation
(e.g. DICT over a unique-key column), defeating the point of measuring.

Candidate sets per type (all of ``encodings``' forms, including the
width-parameterized integer BITPACK and the bit-packed DICTP indices):

    string   PLAIN, DICT, DICTP
    bool     BITPACK, RLE, PLAIN
    int      PLAIN, DICT, DICTP, RLE, DELTA, BITPACK
    float    PLAIN, DICT, DICTP

A candidate that raises ``ValueError`` (DELTA overflow, BITPACK range
overflow) is simply dropped — PLAIN always applies, so the advisor
always returns a valid pick whose buffers the caller writes as-is.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.aformat import compression, encodings

#: Bytes/s the stored form moves at (network/flash read) — one shared
#: scale so the decode-rate term is commensurable; the *relative*
#: ranking is what matters, not the absolute seconds.
WIRE_RATE = 1e9

#: Candidates whose stored bytes exceed the minimum by more than this
#: factor are out, regardless of decode rate.
BYTES_SLACK = 1.10


def _rate_priors() -> tuple[float, float]:
    """(host, kernel) decode-rate priors from the decode plane."""
    from repro_torch.aformat.decode import NumPyBackend, TorchBackend

    return NumPyBackend.decode_rate_prior, TorchBackend.decode_rate_prior


def candidate_encodings(field_type: str) -> list[str]:
    if field_type == "string":
        return [encodings.PLAIN, encodings.DICT, encodings.DICTP]
    if field_type == "bool":
        return [encodings.BITPACK, encodings.RLE, encodings.PLAIN]
    if field_type in ("int32", "int64"):
        return [encodings.PLAIN, encodings.DICT, encodings.DICTP,
                encodings.RLE, encodings.DELTA, encodings.BITPACK]
    return [encodings.PLAIN, encodings.DICT, encodings.DICTP]


def _decode_rate(field_type: str, encoding: str,
                 host_rate: float, kernel_rate: float) -> float:
    if (encoding in (encodings.DICT, encodings.DICTP)
            and field_type in ("int32", "int64", "float32")):
        return kernel_rate
    return host_rate


@dataclasses.dataclass
class Candidate:
    encoding: str
    stored_bytes: int   # compressed size, summed over data buffers
    cost_s: float       # wire + decode seconds under the rate priors


@dataclasses.dataclass
class Advice:
    """The advisor's pick for one column chunk.  ``buffers`` are the
    winner's *raw* (uncompressed) buffers — the caller compresses and
    writes them, so the measurement encode is not repeated."""

    encoding: str
    buffers: list[bytes]
    stored_bytes: int
    candidates: list[Candidate]


def advise_column(field_type: str, values: np.ndarray,
                  codec: str) -> Advice:
    host_rate, kernel_rate = _rate_priors()
    ranked: list[Candidate] = []
    raw: dict[str, list[bytes]] = {}
    for enc in candidate_encodings(field_type):
        try:
            bufs = encodings.encode(field_type, enc, values)
        except ValueError:
            continue
        stored = sum(len(compression.compress(codec, b)) for b in bufs)
        rate = _decode_rate(field_type, enc, host_rate, kernel_rate)
        ranked.append(
            Candidate(enc, stored, stored / WIRE_RATE + stored / rate))
        raw[enc] = bufs
    assert ranked  # PLAIN never raises
    min_stored = min(c.stored_bytes for c in ranked)
    eligible = [c for c in ranked
                if c.stored_bytes <= BYTES_SLACK * min_stored]
    winner = min(eligible, key=lambda c: c.cost_s)
    ranked.sort(key=lambda c: (c not in eligible, c.cost_s))
    return Advice(winner.encoding, raw[winner.encoding],
                  winner.stored_bytes, ranked)
