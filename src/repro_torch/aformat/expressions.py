"""Predicate expression AST with vectorized evaluation and stats pruning.

``Expr.evaluate(table)`` -> bool mask (client- or storage-side scan).
``Expr.prune(stats)``    -> {ALL, NONE, SOME}: whether a row group can be
skipped (NONE) or fully taken (ALL) from its footer min/max statistics —
Parquet predicate pushdown (paper §2.3).
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
from typing import Any, Mapping

import numpy as np

ALL, SOME, NONE = "all", "some", "none"


class Expr:
    def evaluate(self, table) -> np.ndarray:
        raise NotImplementedError

    def prune(self, stats: Mapping[str, "ColumnStats"]) -> str:
        return SOME

    def columns(self) -> set[str]:
        return set()

    # sugar
    def __and__(self, o):
        return And(self, o)

    def __or__(self, o):
        return Or(self, o)

    def __invert__(self):
        return Not(self)

    def to_json(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_json(d: dict | None) -> "Expr | None":
        if d is None:
            return None
        kind = d["kind"]
        if kind == "cmp":
            return Cmp(d["op"], d["column"], d["value"])
        if kind == "and":
            return And(Expr.from_json(d["lhs"]), Expr.from_json(d["rhs"]))
        if kind == "or":
            return Or(Expr.from_json(d["lhs"]), Expr.from_json(d["rhs"]))
        if kind == "not":
            return Not(Expr.from_json(d["expr"]))
        if kind == "isin":
            return IsIn(d["column"], d["values"])
        if kind == "bloom":
            return BloomIn(
                d["column"],
                base64.b64decode(d["bits"]),
                d["num_bits"], d["num_hashes"], d["count"],
                d.get("lo"), d.get("hi"))
        raise ValueError(kind)


_OPS = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


@dataclasses.dataclass
class Cmp(Expr):
    op: str
    column: str
    value: Any

    def evaluate(self, table):
        col = table.column(self.column)
        vals = col.values
        if col.field.type == "string":
            vals = np.asarray([str(v) for v in vals])
        mask = _OPS[self.op](vals, self.value)
        if col.validity is not None:
            mask = mask & col.validity
        return np.asarray(mask, "?")

    def prune(self, stats):
        st = stats.get(self.column)
        if st is None:
            return SOME
        if st.min is not None:
            lo, hi, v = st.min, st.max, self.value
            full = st.null_count == 0
            if self.op == "==":
                if v < lo or v > hi:
                    return NONE
                if lo == hi == v and full:
                    return ALL
            elif self.op == "!=":
                if lo == hi == v:
                    return NONE
                if (v < lo or v > hi) and full:
                    return ALL
            elif self.op == "<":
                if lo >= v:
                    return NONE
                if hi < v and full:
                    return ALL
            elif self.op == "<=":
                if lo > v:
                    return NONE
                if hi <= v and full:
                    return ALL
            elif self.op == ">":
                if hi <= v:
                    return NONE
                if lo > v and full:
                    return ALL
            elif self.op == ">=":
                if hi < v:
                    return NONE
                if lo >= v and full:
                    return ALL
        if self.op == "==":
            # bloom-index probe: upgrade the stats MAYBE to a provable
            # NONE (False = definitely absent; True/None stay SOME)
            idx = getattr(st, "index", None)
            if idx is not None and idx.contains_any([self.value]) is False:
                return NONE
        return SOME

    def columns(self):
        return {self.column}

    def to_json(self):
        v = self.value
        if isinstance(v, np.generic):
            v = v.item()
        return {"kind": "cmp", "op": self.op, "column": self.column,
                "value": v}


@dataclasses.dataclass
class IsIn(Expr):
    column: str
    values: list

    def evaluate(self, table):
        col = table.column(self.column)
        vals = col.values
        if col.field.type == "string":
            vals = np.asarray([str(v) for v in vals])
        mask = np.isin(vals, np.asarray(self.values))
        if col.validity is not None:
            mask = mask & col.validity
        return np.asarray(mask, "?")

    def prune(self, stats):
        st = stats.get(self.column)
        if st is None:
            return SOME
        if st.min is not None and all(
                v < st.min or v > st.max for v in self.values):
            return NONE
        idx = getattr(st, "index", None)
        if (idx is not None and self.values
                and idx.contains_any(self.values) is False):
            return NONE
        return SOME

    def columns(self):
        return {self.column}

    def to_json(self):
        return {"kind": "isin", "column": self.column,
                "values": [v.item() if isinstance(v, np.generic) else v
                           for v in self.values]}


def _mix64(x: np.ndarray, seed: int) -> np.ndarray:
    """SplitMix64-style avalanche over a uint64 array (wrapping mults)."""
    x = x.astype(np.uint64, copy=True) ^ np.uint64(seed)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xFF51AFD7ED558CCD)
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xC4CEB9FE1A85EC53)
        x ^= x >> np.uint64(33)
    return x


def _key_words(values: np.ndarray) -> np.ndarray:
    """Canonical uint64 word per key value, identical no matter which side
    of the wire hashes it: integers widen, floats take their bit pattern
    (-0.0 normalized to 0.0), strings take an 8-byte blake2b digest."""
    arr = np.asarray(values)
    if arr.dtype.kind in ("i", "u", "b"):
        return arr.astype(np.int64).view(np.uint64).copy()
    if arr.dtype.kind == "f":
        f = arr.astype(np.float64).copy()
        f[f == 0.0] = 0.0
        return f.view(np.uint64).copy()
    return np.fromiter(
        (int.from_bytes(
            hashlib.blake2b(str(v).encode("utf-8"),
                            digest_size=8).digest(), "little")
         for v in arr),
        np.uint64, len(arr))


@dataclasses.dataclass
class BloomIn(Expr):
    """Bloom-filter membership: ``column``'s value hashes into a bit array
    built from a join's build-side keys.  May pass values that were never
    inserted (false positives — callers that need exactness re-verify
    against the true key set), never rejects an inserted value.  Carries
    the inserted keys' min/max so footer-stats pruning stays exact:
    a fragment whose range is disjoint from [lo, hi] is provably empty of
    matches (NONE); ALL is never claimed."""

    column: str
    bits: bytes
    num_bits: int
    num_hashes: int
    count: int                    # keys inserted (explain/selectivity)
    lo: Any = None                # min/max of the inserted keys (numeric
    hi: Any = None                # keys only; None disables range pruning)
    #: In-memory only (never serialized — the wire form is unchanged):
    #: the build keys' canonical hash words and their key domain, kept by
    #: ``build`` for small key sets so ``prune`` can probe a row group's
    #: ColumnIndex bloom before the fragment ships.
    key_kind: "str | None" = dataclasses.field(default=None, compare=False)
    words: Any = dataclasses.field(default=None, compare=False, repr=False)

    #: Probe-side key retention cap: past this, per-row-group bloom
    #: probes cost more than they prune and ``prune`` stays stats-only.
    MAX_PROBE_KEYS = 4096

    @staticmethod
    def build(column: str, values, *, bits_per_key: int = 10) -> "BloomIn":
        arr = np.asarray(values)
        n = max(1, len(arr))
        num_bits = max(64, 1 << int(np.ceil(np.log2(n * bits_per_key))))
        num_hashes = max(1, int(round(0.7 * num_bits / n)))
        num_hashes = min(num_hashes, 8)
        bitarr = np.zeros(num_bits // 8, np.uint8)
        words = _key_words(arr)
        h1 = _mix64(words, 0x9E3779B97F4A7C15)
        h2 = _mix64(words, 0xD1B54A32D192ED03) | np.uint64(1)
        for i in range(num_hashes):
            with np.errstate(over="ignore"):
                pos = (h1 + np.uint64(i) * h2) % np.uint64(num_bits)
            np.bitwise_or.at(bitarr, (pos >> np.uint64(3)).astype(np.int64),
                             np.uint8(1) << (pos & np.uint64(7)).astype(
                                 np.uint8))
        lo = hi = None
        if arr.dtype.kind in ("i", "u", "f") and len(arr):
            lo, hi = arr.min().item(), arr.max().item()
        bl = BloomIn(column, bitarr.tobytes(), num_bits, num_hashes,
                     len(arr), lo, hi)
        bl.key_kind = ("i" if arr.dtype.kind in ("i", "u", "b")
                       else "f" if arr.dtype.kind == "f" else "s")
        if len(arr) <= BloomIn.MAX_PROBE_KEYS:
            bl.words = np.unique(words)
        return bl

    def _test(self, values: np.ndarray) -> np.ndarray:
        bitarr = np.frombuffer(self.bits, np.uint8)
        words = _key_words(values)
        h1 = _mix64(words, 0x9E3779B97F4A7C15)
        h2 = _mix64(words, 0xD1B54A32D192ED03) | np.uint64(1)
        mask = np.ones(len(words), "?")
        for i in range(self.num_hashes):
            with np.errstate(over="ignore"):
                pos = (h1 + np.uint64(i) * h2) % np.uint64(self.num_bits)
            bit = bitarr[(pos >> np.uint64(3)).astype(np.int64)] \
                & (np.uint8(1) << (pos & np.uint64(7)).astype(np.uint8))
            mask &= bit != 0
        return mask

    def evaluate(self, table):
        col = table.column(self.column)
        mask = self._test(col.values)
        if col.validity is not None:
            mask = mask & col.validity
        return np.asarray(mask, "?")

    def prune(self, stats):
        st = stats.get(self.column)
        if st is None:
            return SOME
        if (st.min is not None and self.lo is not None
                and self.hi is not None
                and (st.max < self.lo or st.min > self.hi)):
            return NONE
        # probe the row group's own bloom with the build keys' words:
        # both sides hash through _key_words, so domains must match
        idx = getattr(st, "index", None)
        if (idx is not None and self.words is not None
                and len(self.words) and self.key_kind == idx.kind
                and not idx.contains_any_words(self.words)):
            return NONE
        return SOME               # never ALL: the filter is approximate

    def columns(self):
        return {self.column}

    def digest(self) -> str:
        """Short content digest — result-cache keys and explain() use it
        instead of the (possibly kilobytes-long) bit array."""
        h = hashlib.blake2s(digest_size=8)
        h.update(self.bits)
        h.update(f"{self.num_bits}/{self.num_hashes}/{self.count}".encode())
        return h.hexdigest()

    def to_json(self):
        d = {"kind": "bloom", "column": self.column,
             "bits": base64.b64encode(self.bits).decode("ascii"),
             "num_bits": self.num_bits, "num_hashes": self.num_hashes,
             "count": self.count}
        if self.lo is not None:
            v = self.lo
            d["lo"] = v.item() if isinstance(v, np.generic) else v
            v = self.hi
            d["hi"] = v.item() if isinstance(v, np.generic) else v
        return d


@dataclasses.dataclass
class And(Expr):
    lhs: Expr
    rhs: Expr

    def evaluate(self, table):
        return self.lhs.evaluate(table) & self.rhs.evaluate(table)

    def prune(self, stats):
        a, b = self.lhs.prune(stats), self.rhs.prune(stats)
        if NONE in (a, b):
            return NONE
        if a == ALL and b == ALL:
            return ALL
        return SOME

    def columns(self):
        return self.lhs.columns() | self.rhs.columns()

    def to_json(self):
        return {"kind": "and", "lhs": self.lhs.to_json(),
                "rhs": self.rhs.to_json()}


@dataclasses.dataclass
class Or(Expr):
    lhs: Expr
    rhs: Expr

    def evaluate(self, table):
        return self.lhs.evaluate(table) | self.rhs.evaluate(table)

    def prune(self, stats):
        a, b = self.lhs.prune(stats), self.rhs.prune(stats)
        if ALL in (a, b):
            return ALL
        if a == NONE and b == NONE:
            return NONE
        return SOME

    def columns(self):
        return self.lhs.columns() | self.rhs.columns()

    def to_json(self):
        return {"kind": "or", "lhs": self.lhs.to_json(),
                "rhs": self.rhs.to_json()}


@dataclasses.dataclass
class Not(Expr):
    expr: Expr

    def evaluate(self, table):
        return ~self.expr.evaluate(table)

    def prune(self, stats):
        inner = self.expr.prune(stats)
        if inner == ALL:
            return NONE
        if inner == NONE:
            return ALL
        return SOME

    def columns(self):
        return self.expr.columns()

    def to_json(self):
        return {"kind": "not", "expr": self.expr.to_json()}


def field(name: str):
    """field("x") > 3  -> Cmp(">", "x", 3)."""
    return _FieldRef(name)


@dataclasses.dataclass
class _FieldRef:
    name: str

    def __eq__(self, v):  # type: ignore[override]
        return Cmp("==", self.name, v)

    def __ne__(self, v):  # type: ignore[override]
        return Cmp("!=", self.name, v)

    def __lt__(self, v):
        return Cmp("<", self.name, v)

    def __le__(self, v):
        return Cmp("<=", self.name, v)

    def __gt__(self, v):
        return Cmp(">", self.name, v)

    def __ge__(self, v):
        return Cmp(">=", self.name, v)

    def isin(self, values):
        return IsIn(self.name, list(values))
