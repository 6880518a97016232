"""Column-chunk encodings: PLAIN / DICT / DICTP / RLE / DELTA / BITPACK.

Each encoder maps a values array -> list of raw buffers; the footer records
which encoding was used.  The *decode* cost of these encodings (plus the
codec) is exactly the client-CPU work the paper offloads to storage.

``choose_encoding`` is the cheap one-shot heuristic the append/write hot
path uses; ``repro_torch.aformat.advisor`` is the measured alternative — it
encodes every applicable candidate and picks by stored bytes weighted
with the decode plane's per-backend rate priors (compaction's default).

Hardware-adaptation note: dictionary decode *is* wired to the GPU —
``repro_torch.aformat.decode.TorchBackend`` routes DICT chunks (and
DICTP chunks, after a host-side index unpack) through the
``repro_torch.kernels`` CUDA gather kernel whenever a client-side scan
runs with the default (or ``"torch"``) backend.  RLE run expansion,
DELTA's int8 delta stream, the string offset/payload buffers, and the
width-bit unpack steps run on the host path: they are byte-stream
transforms whose output (not input) is what the kernels consume, so the
host decodes them and the accelerator takes over from the decoded
arrays.

Encodings:

PLAIN    raw little-endian values (strings: int64 offsets + payload).
DICT     int32 indices + unique values.
DICTP    width-bit packed indices + unique values (width = bits needed
         for the dictionary size; buffer 0 = 1-byte width + packed bits).
RLE      run values + int32 run lengths.
DELTA    int64 base + int8 deltas (monotone-ish integer columns).
BITPACK  bool: 1 bit per value (``np.packbits``).  int32/int64: values
         rebased to their minimum and packed at the smallest width that
         holds the range (buffer 0 = <int64 base, uint8 width> header,
         buffer 1 = packed bits) — the width-parameterized integer form.
"""

from __future__ import annotations

import struct

import numpy as np

from repro_torch.aformat.table import strings_from_buffers

PLAIN, DICT, RLE, DELTA, BITPACK = "plain", "dict", "rle", "delta", "bitpack"
DICTP = "dictp"


def _string_buffers(values) -> list[bytes]:
    raw = [("" if v is None else str(v)).encode() for v in values]
    offsets = np.zeros(len(raw) + 1, np.int64)
    np.cumsum([len(r) for r in raw], out=offsets[1:])
    return [offsets.tobytes(), b"".join(raw)]


def _string_from_buffers(bufs, n):
    return strings_from_buffers(np.frombuffer(bufs[0], np.int64),
                                bufs[1], n)


def choose_encoding(field_type: str, values: np.ndarray) -> str:
    if field_type == "bool":
        return BITPACK
    if field_type == "string":
        # compare the sample's uniq count against the SAMPLE size: the
        # old `len(values) // 4` denominator made any column over ~16k
        # rows dictionary-encode regardless of its true cardinality
        sample = values[:4096]
        uniq = len(set(map(str, sample)))
        return DICT if uniq <= max(1, len(sample) // 4) else PLAIN
    if field_type in ("int32", "int64"):
        sample = values[: min(len(values), 4096)]
        if len(sample) > 1:
            d = np.diff(sample)
            if len(d) and d.min() >= 0 and d.max() <= 127:
                return DELTA
            runs = int(np.count_nonzero(d)) + 1
            if runs <= len(sample) // 8:
                return RLE
        uniq = len(np.unique(sample))
        if uniq <= max(1, min(len(values) // 4, 60_000)):
            return DICT
        return PLAIN
    # floats: dictionary only when very low cardinality
    uniq = len(np.unique(values[: min(len(values), 4096)]))
    if uniq <= max(1, len(values) // 16):
        return DICT
    return PLAIN


def pack_width(rel: np.ndarray, width: int) -> bytes:
    """Pack nonnegative values into ``width``-bit little-endian cells."""
    if len(rel) == 0:
        return b""
    rel = rel.astype(np.uint64)
    bitmat = ((rel[:, None] >> np.arange(width, dtype=np.uint64))
              & np.uint64(1)).astype(np.uint8)
    return np.packbits(bitmat.reshape(-1), bitorder="little").tobytes()


def unpack_width(buf: bytes, n: int, width: int) -> np.ndarray:
    """Inverse of :func:`pack_width` -> uint64 array of length ``n``."""
    if n == 0:
        return np.zeros(0, np.uint64)
    bits = np.unpackbits(np.frombuffer(buf, np.uint8),
                         bitorder="little")[:n * width]
    bitmat = bits.reshape(n, width).astype(np.uint64)
    return (bitmat << np.arange(width, dtype=np.uint64)).sum(
        axis=1, dtype=np.uint64)


def _dict_parts(field_type: str, values: np.ndarray):
    if field_type == "string":
        svals = np.asarray([str(v) for v in values], object)
        uniq, inv = np.unique(svals.astype(str), return_inverse=True)
        return inv, _string_buffers(uniq.astype(object)), len(uniq)
    uniq, inv = np.unique(values, return_inverse=True)
    return inv, [np.ascontiguousarray(uniq).tobytes()], len(uniq)


def encode(field_type: str, encoding: str, values: np.ndarray) -> list[bytes]:
    if encoding == PLAIN:
        if field_type == "string":
            return _string_buffers(values)
        return [np.ascontiguousarray(values).tobytes()]
    if encoding == BITPACK:
        if field_type == "bool":
            return [np.packbits(values.astype("?")).tobytes()]
        if field_type not in ("int32", "int64"):
            raise ValueError("bitpack: bool or integer columns only")
        v = values.astype(np.int64)
        if len(v) == 0:
            return [struct.pack("<qB", 0, 1), b""]
        base = int(v.min())
        span = int(v.max()) - base
        if span >= 2 ** 63:
            raise ValueError("bitpack range overflow; caller falls back")
        width = max(1, span.bit_length())
        rel = (v - np.int64(base)).astype(np.uint64)
        return [struct.pack("<qB", base, width), pack_width(rel, width)]
    if encoding == DICT:
        inv, uniq_bufs, _ = _dict_parts(field_type, values)
        return [inv.astype(np.int32).tobytes(), *uniq_bufs]
    if encoding == DICTP:
        inv, uniq_bufs, n_uniq = _dict_parts(field_type, values)
        width = max(1, max(n_uniq - 1, 0).bit_length())
        return [struct.pack("<B", width) + pack_width(inv, width),
                *uniq_bufs]
    if encoding == DELTA:
        base = values[:1].astype(np.int64)
        deltas = np.diff(values.astype(np.int64))
        if len(deltas) and (deltas.min() < -128 or deltas.max() > 127):
            raise ValueError("delta overflow; caller should fall back")
        return [base.tobytes(), deltas.astype(np.int8).tobytes()]
    if encoding == RLE:
        values = np.asarray(values)
        if len(values) == 0:
            return [b"", b""]
        change = np.nonzero(values[1:] != values[:-1])[0] + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [len(values)]])
        return [np.ascontiguousarray(values[starts]).tobytes(),
                (ends - starts).astype(np.int32).tobytes()]
    raise ValueError(encoding)


def decode(field_type: str, encoding: str, bufs: list[bytes], n: int,
           numpy_dtype) -> np.ndarray:
    if encoding == PLAIN:
        if field_type == "string":
            return _string_from_buffers(bufs, n)
        return np.frombuffer(bufs[0], numpy_dtype)[:n].copy()
    if encoding == BITPACK:
        if field_type == "bool":
            return np.unpackbits(
                np.frombuffer(bufs[0], np.uint8))[:n].astype("?")
        base, width = struct.unpack("<qB", bufs[0][:9])
        rel = unpack_width(bufs[1], n, width)
        return (rel.astype(np.int64) + np.int64(base)).astype(numpy_dtype)
    if encoding in (DICT, DICTP):
        if encoding == DICT:
            idx = np.frombuffer(bufs[0], np.int32)[:n]
        else:
            width = bufs[0][0]
            idx = unpack_width(bufs[0][1:], n, width).astype(np.int64)
        if field_type == "string":
            dict_n = (len(np.frombuffer(bufs[1], np.int64)) - 1)
            uniq = _string_from_buffers(bufs[1:], dict_n)
        else:
            uniq = np.frombuffer(bufs[1], numpy_dtype)
        return uniq[idx]
    if encoding == DELTA:
        base = np.frombuffer(bufs[0], np.int64)
        out = np.empty(n, np.int64)
        if n:
            out[0] = base[0]
        if n > 1:
            deltas = np.frombuffer(bufs[1], np.int8).astype(np.int64)
            np.cumsum(deltas[:n - 1], out=out[1:])
            out[1:] += base[0]
        return out.astype(numpy_dtype)
    if encoding == RLE:
        vals = np.frombuffer(bufs[0], numpy_dtype)
        runs = np.frombuffer(bufs[1], np.int32)
        return np.repeat(vals, runs)[:n]
    raise ValueError(encoding)
