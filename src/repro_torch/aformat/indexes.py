"""Per-row-group physical-design indexes (beyond min/max zone maps).

A :class:`ColumnIndex` is a per-column, per-row-group auxiliary index: a
bloom filter over the chunk's non-null values (the double-hash core is
shared with ``expressions.BloomIn`` so both sides of the wire hash
identically) plus an exact distinct-value count.  The writer builds one
per column chunk (``parquet.encode_row_group``); it serializes as a
versioned block inside the chunk's footer entry, and readers that meet
an unknown version simply ignore the block — min/max statistics alone
keep every pruning verdict sound, the index only ever upgrades a MAYBE
(SOME) verdict to a provable NONE.

Probing canonicalizes values into the build-side key domain first
(integers widen to int64, floats take their float64 bit pattern, strings
hash an 8-byte blake2b digest — exactly ``expressions._key_words``), so
an ``Eq``/``IsIn``/``BloomIn`` probe can never false-negative on a value
the chunk actually holds.  A probe value that cannot be represented in
the build domain returns ``None`` ("no verdict"), never ``False``.
"""

from __future__ import annotations

import base64
import dataclasses

import numpy as np

from repro_torch.aformat.expressions import _key_words, _mix64

#: Version tag written into every serialized index block.  Readers skip
#: blocks whose version they do not understand (forward compatibility);
#: footers written before index blocks existed simply lack the field
#: (backward compatibility) — both degrade to stats-only pruning.
INDEX_VERSION = 1

#: Bloom sizing: bits per *distinct* value (not per row — run-heavy and
#: dictionary-friendly chunks get proportionally tiny filters).
BITS_PER_DISTINCT = 8

#: Hard cap on one filter's size (bits): 2**20 bits = 128 KiB.  Past the
#: cap the filter saturates gracefully (higher FPR, still sound).
MAX_BITS = 1 << 20

_SEED_1 = 0x9E3779B97F4A7C15
_SEED_2 = 0xD1B54A32D192ED03


def value_kind(field_type: str) -> str:
    """The canonical key domain of a schema type: "i" (integer-like),
    "f" (float bit pattern), or "s" (string digest)."""
    if field_type in ("bool", "int32", "int64"):
        return "i"
    if field_type in ("float32", "float64"):
        return "f"
    return "s"


def canonical_words(kind: str, values) -> np.ndarray | None:
    """Canonicalize probe values into the ``kind`` key domain and hash
    them to uint64 words.  Returns None when any value cannot be
    represented exactly — the caller must treat that as "no verdict"
    (a lossy coercion could manufacture a false NONE)."""
    try:
        if kind == "i":
            out = []
            for v in values:
                if isinstance(v, (float, np.floating)):
                    if not float(v).is_integer():
                        return None
                iv = int(v)
                if not -(2**63) <= iv < 2**63:
                    return None
                out.append(iv)
            arr = np.asarray(out, np.int64)
        elif kind == "f":
            arr = np.asarray([float(v) for v in values], np.float64)
        else:
            arr = np.asarray([str(v) for v in values], object)
    except (TypeError, ValueError, OverflowError):
        return None
    return _key_words(arr)


@dataclasses.dataclass
class ColumnIndex:
    """Bloom filter + distinct count for one column chunk."""

    kind: str  # "i" | "f" | "s" — the build-side key domain
    bits: bytes
    num_bits: int
    num_hashes: int
    distinct: int  # exact distinct non-null values in the chunk
    count: int  # non-null values inserted
    version: int = INDEX_VERSION

    # -- construction ------------------------------------------------------
    @staticmethod
    def build(
        column, *, bits_per_distinct: int = BITS_PER_DISTINCT
    ) -> "ColumnIndex":
        """Build the index for one column chunk (``column`` is any object
        with ``.values``, ``.validity`` and ``.field.type``)."""
        vals = np.asarray(column.values)
        if column.validity is not None:
            vals = vals[column.validity]
        kind = value_kind(column.field.type)
        # vectorized canonicalization: schema-typed arrays coerce exactly
        if kind == "i":
            words = _key_words(vals.astype(np.int64))
        elif kind == "f":
            words = _key_words(vals.astype(np.float64))
        else:
            words = _key_words(np.asarray([str(v) for v in vals], object))
        uniq = np.unique(words)
        distinct = int(len(uniq))
        n = max(1, distinct)
        num_bits = max(64, 1 << int(np.ceil(np.log2(n * bits_per_distinct))))
        num_bits = min(num_bits, MAX_BITS)
        num_hashes = min(8, max(1, int(round(0.7 * num_bits / n))))
        bitarr = np.zeros(num_bits // 8, np.uint8)
        if distinct:
            h1 = _mix64(uniq, _SEED_1)
            h2 = _mix64(uniq, _SEED_2) | np.uint64(1)
            for i in range(num_hashes):
                with np.errstate(over="ignore"):
                    pos = (h1 + np.uint64(i) * h2) % np.uint64(num_bits)
                np.bitwise_or.at(
                    bitarr,
                    (pos >> np.uint64(3)).astype(np.int64),
                    np.uint8(1) << (pos & np.uint64(7)).astype(np.uint8),
                )
        return ColumnIndex(
            kind, bitarr.tobytes(), num_bits, num_hashes, distinct, len(vals)
        )

    # -- probes ------------------------------------------------------------
    def _probe_words(self, words: np.ndarray) -> np.ndarray:
        bitarr = np.frombuffer(self.bits, np.uint8)
        h1 = _mix64(words, _SEED_1)
        h2 = _mix64(words, _SEED_2) | np.uint64(1)
        mask = np.ones(len(words), "?")
        for i in range(self.num_hashes):
            with np.errstate(over="ignore"):
                pos = (h1 + np.uint64(i) * h2) % np.uint64(self.num_bits)
            bit = bitarr[(pos >> np.uint64(3)).astype(np.int64)] & (
                np.uint8(1) << (pos & np.uint64(7)).astype(np.uint8)
            )
            mask &= bit != 0
        return mask

    def contains_any(self, values) -> bool | None:
        """Tri-state membership: False = provably none of ``values`` is
        in the chunk (safe to prune), True = at least one may be, None =
        no verdict (a value could not be canonicalized)."""
        words = canonical_words(self.kind, values)
        if words is None or len(words) == 0:
            return None
        return bool(self._probe_words(words).any())

    def contains_any_words(self, words: np.ndarray) -> bool:
        """Membership over pre-hashed key words (the semi-join probe path:
        the build side hashed its keys once with ``_key_words``)."""
        words = np.asarray(words, np.uint64)
        if len(words) == 0:
            return True
        return bool(self._probe_words(words).any())

    # -- serialization -----------------------------------------------------
    def to_json(self) -> dict:
        return {
            "v": self.version,
            "kind": self.kind,
            "bloom": base64.b64encode(self.bits).decode("ascii"),
            "num_bits": self.num_bits,
            "num_hashes": self.num_hashes,
            "distinct": self.distinct,
            "count": self.count,
        }

    @staticmethod
    def from_json(d: dict | None) -> "ColumnIndex | None":
        """None (absent field: pre-index footer) and unknown versions both
        load as "no index" — old files scan unchanged, future blocks are
        skipped rather than misread."""
        if not d or d.get("v") != INDEX_VERSION:
            return None
        return ColumnIndex(
            d["kind"],
            base64.b64decode(d["bloom"]),
            d["num_bits"],
            d["num_hashes"],
            d["distinct"],
            d["count"],
            d["v"],
        )
