"""Decode engine: pluggable backends behind every client-side scan.

One row group is the unit of work: decompressed column-chunk buffers plus
their encodings (and an optional predicate) go in, a filtered ``Table``
comes out.  Two backends implement that contract:

``NumPyBackend``
    The host path — ``encodings.decode`` per column, ``Expr.evaluate``
    for the mask, ``Table.filter`` for the selection.  Storage-side
    ``scan_op`` runs it (OSDs have no accelerator), and so does any
    client that asks for ``decode_backend="numpy"``.

``TorchBackend``
    The GPU path (``repro_torch.kernels``), and the client formats'
    default.  DICT (and, after a host width-bit unpack of the index
    buffer, DICTP) numeric columns gather through the ``dict_decode``
    CUDA kernel in their own dtype; a flat AND/OR of comparisons lowers
    to one ``predicate_fused`` launch that compares in NumPy's own
    compare types; and the selection compacts through ``token_pack``.
    RLE/DELTA/BITPACK byte streams, PLAIN columns, strings and
    IsIn/Bloom/mixed-logic predicates stay on the host path, each with a
    named reason in the routing report.  Routing depends on types and
    encodings alone, never on whether a kernel failed: a kernel error
    raises.  The result is byte-identical to ``NumPyBackend``;
    ``tests/test_torch_decode.py`` pins that equivalence.

The scheduler prices the two regimes separately: each backend carries a
``decode_rate_prior`` (stored bytes per second of decode+filter) that
seeds the client-side EWMA in ``repro_torch.dataset.scheduler``.
"""

from __future__ import annotations

import dataclasses
import threading
import warnings
from typing import Sequence

import numpy as np
import torch

from repro_torch.aformat import compression, encodings
from repro_torch.aformat.expressions import And, Cmp, Expr, Not, Or
from repro_torch.aformat.schema import Field
from repro_torch.aformat.table import Column, Table
from repro_torch.kernels import (block_offsets, build_program, compare_type,
                                 dict_decode, predicate_mask)
from repro_torch.kernels import compact as compact_rows
from repro_torch.kernels.predicate_fused.predicate_fused import (MAX_COLS,
                                                                 MAX_TERMS)

#: Expression ops -> predicate_fused kernel ops.
_KERNEL_OPS = {"<": "lt", "<=": "le", ">": "gt", ">=": "ge",
               "==": "eq", "!=": "ne"}

#: Column types the gather kernel decodes (DICT/DICTP chunks) and the
#: predicate kernel compares.
_GATHER_TYPES = ("int32", "int64", "float32", "float64")

#: Column types the compaction kernel copies.
_COMPACT_TYPES = ("int32", "int64", "float32", "float64", "bool")


def n_data_buffers(field_type: str, encoding: str) -> int:
    """How many of a chunk's buffers hold data (the rest is validity)."""
    if encoding == encodings.PLAIN:
        return 2 if field_type == "string" else 1
    if encoding in (encodings.DICT, encodings.DICTP):
        return 3 if field_type == "string" else 2
    if encoding in (encodings.DELTA, encodings.RLE):
        return 2
    # bitpack: bool is a single bit buffer; integers carry a
    # <base, width> header buffer plus the packed bits
    return 1 if field_type == "bool" else 2


@dataclasses.dataclass
class ChunkData:
    """One column chunk of one row group: decompressed, not yet decoded."""

    field: Field
    encoding: str
    bufs: list[bytes]           # data buffers, then optional validity
    num_rows: int

    @property
    def data_bufs(self) -> list[bytes]:
        return self.bufs[:n_data_buffers(self.field.type, self.encoding)]

    def validity(self) -> np.ndarray | None:
        nd = n_data_buffers(self.field.type, self.encoding)
        if len(self.bufs) <= nd:
            return None
        return np.unpackbits(np.frombuffer(self.bufs[nd], np.uint8)
                             )[:self.num_rows].astype("?")


def read_chunk(src, meta, rg, name: str) -> ChunkData:
    """Read + decompress one column chunk (``meta``/``rg`` are the
    ``parquet.FileMeta``/``RowGroupMeta`` footer objects, duck-typed so
    this module never imports the file format)."""
    field = meta.schema.field(name)
    chunk = rg.chunks[meta.schema.index(name)]
    bufs = []
    off = chunk.offset
    for ln in chunk.buffer_lengths:
        bufs.append(compression.decompress(chunk.codec, src.read(off, ln)))
        off += ln
    return ChunkData(field, chunk.encoding, bufs, rg.num_rows)


# ---------------------------------------------------------------------------
# Backend interface
# ---------------------------------------------------------------------------


class DecodeBackend:
    """Decode + filter + select one row group.  Subclasses override the
    three hooks (column decode, mask evaluation, selection compaction);
    the row-group template is shared so the backends can never disagree
    about column ordering, validity handling, or projection."""

    name = "abstract"
    #: stored-bytes/s prior seeding the scheduler's client-side EWMA
    decode_rate_prior = 150e6

    def decode_column(self, chunk: ChunkData) -> Column:
        raise NotImplementedError

    def evaluate_predicate(self, tbl: Table, predicate: Expr,
                           report: dict | None = None) -> np.ndarray:
        raise NotImplementedError

    def compact(self, tbl: Table, mask: np.ndarray,
                report: dict | None = None) -> Table:
        raise NotImplementedError

    def scan_row_group(self, src, meta, rg,
                       columns: Sequence[str] | None = None,
                       predicate: Expr | None = None,
                       report: dict | None = None) -> Table:
        """Decode + filter + project one row group (the scan_op payload).
        ``report``, when given, is filled with the per-column / predicate
        routing this call actually took (kernel vs host fallback)."""
        names = list(columns) if columns is not None else meta.schema.names
        needed = set(names)
        if predicate is not None:
            needed |= predicate.columns()
        order = sorted(needed, key=meta.schema.index)
        cols = {n: self.decode_column(read_chunk(src, meta, rg, n))
                for n in order}
        if report is not None:
            report["columns"] = {n: getattr(cols[n], "_decode_route",
                                            "host") for n in order}
            for n in order:
                if hasattr(cols[n], "_decode_route"):
                    del cols[n]._decode_route
        tbl = Table(meta.schema.select(order), [cols[n] for n in order])
        if predicate is not None:
            mask = np.asarray(self.evaluate_predicate(tbl, predicate,
                                                      report), "?")
            tbl = self.compact(tbl, mask, report)
        return tbl.select(names)

    def describe(self, meta, rg, columns: Sequence[str] | None,
                 predicate: Expr | None) -> str:
        """Static routing summary from footer metadata alone — what
        ``explain()`` prints before any byte is read."""
        return self.name


class NumPyBackend(DecodeBackend):
    """The host decode path (exactly the code ``parquet.scan_row_group``
    used to inline)."""

    name = "numpy"
    decode_rate_prior = 150e6    # matches the paper-testbed Xeon prior

    def decode_column(self, chunk: ChunkData) -> Column:
        values = encodings.decode(chunk.field.type, chunk.encoding,
                                  chunk.data_bufs, chunk.num_rows,
                                  chunk.field.numpy_dtype)
        return Column(chunk.field, values, chunk.validity())

    def evaluate_predicate(self, tbl, predicate, report=None):
        if report is not None:
            report["predicate"] = "host"
        return predicate.evaluate(tbl)

    def compact(self, tbl, mask, report=None):
        if report is not None:
            report["compact"] = "host"
        return tbl.filter(mask)


# ---------------------------------------------------------------------------
# Torch backend
# ---------------------------------------------------------------------------


def _flatten(pred: Expr):
    """Flatten an expression into (leaves, combine, negate) when it is a
    flat AND- or OR-tree of Cmp leaves (optionally under one Not); None
    when any other node type (IsIn / Bloom / mixed logic) appears."""
    negate = False
    if isinstance(pred, Not):
        pred, negate = pred.expr, True
    stack, leaves, kinds = [pred], [], set()
    while stack:
        node = stack.pop()
        if isinstance(node, Cmp):
            leaves.append(node)
        elif isinstance(node, (And, Or)):
            kinds.add("and" if isinstance(node, And) else "or")
            stack += [node.lhs, node.rhs]
        else:
            return None
    if len(kinds) > 1:
        return None
    return leaves, (kinds.pop() if kinds else "and"), negate


# Chunk buffers are immutable ``bytes``, so the arrays over them are
# read-only, and torch warns once per process when it wraps one.  The
# tensors made from them are only ever read, by the kernels and their
# plain versions, so that one warning is spent here, silenced.
with warnings.catch_warnings():
    warnings.simplefilter("ignore", UserWarning)
    torch.from_numpy(np.frombuffer(b"\0", np.uint8))

#: Bytes the torch backends copied host -> card and card -> host in this
#: process (``Table`` holds NumPy, so every kernel input crosses to the
#: card and every output comes back).
TRANSFER_BYTES = {"h2d": 0, "d2h": 0}
_transfer_lock = threading.Lock()


class TorchBackend(DecodeBackend):
    """The GPU decode path (``repro_torch.kernels``), with named host
    routes for everything the kernels do not take.  ``device="cuda"``
    (the default) runs the CUDA kernels and raises when there is no
    card; ``device="cpu"`` runs the kernels' plain PyTorch versions.
    Safe to share across scan threads: it holds no per-call state."""

    name = "torch"

    def __init__(self, device: str | torch.device = "cuda"):
        dev = torch.device(device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"TorchBackend: unsupported device {dev}")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"TorchBackend(device={str(dev)!r}): no CUDA device is "
                "available; pass decode_backend='numpy' or "
                "TorchBackend(device='cpu') to decode on the host")
        self.device = dev

    # -- host <-> card ----------------------------------------------------
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cpu":
            return t
        with _transfer_lock:
            TRANSFER_BYTES["h2d"] += t.nbytes
        return t.to(self.device)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        if t.device.type != "cpu":
            with _transfer_lock:
                TRANSFER_BYTES["d2h"] += t.nbytes
            t = t.cpu()
        return t.numpy()

    # -- column decode ------------------------------------------------------
    def decode_column(self, chunk: ChunkData) -> Column:
        if (chunk.encoding not in (encodings.DICT, encodings.DICTP)
                or chunk.field.type not in _GATHER_TYPES):
            return Column(chunk.field,
                          encodings.decode(chunk.field.type, chunk.encoding,
                                           chunk.data_bufs, chunk.num_rows,
                                           chunk.field.numpy_dtype),
                          chunk.validity())
        if chunk.encoding == encodings.DICT:
            codes = np.frombuffer(chunk.data_bufs[0],
                                  np.int32)[:chunk.num_rows]
        else:
            # DICTP: the width-bit unpack is a byte-stream transform
            # (host); the gather itself runs on the kernel
            buf = chunk.data_bufs[0]
            codes = encodings.unpack_width(
                buf[1:], chunk.num_rows, buf[0]).astype(np.int32)
        dic = np.frombuffer(chunk.data_bufs[1], chunk.field.numpy_dtype)
        values = self._to_host(dict_decode(self._to_device(codes),
                                           self._to_device(dic)))
        col = Column(chunk.field, values, chunk.validity())
        col._decode_route = "kernel"     # scraped into the scan report
        return col

    # -- predicate ---------------------------------------------------------
    def _lower(self, tbl: Table, predicate: Expr):
        """(kernel Program, referenced Columns) or (None, reason)."""
        flat = _flatten(predicate)
        if flat is None:
            return None, "unsupported-node"
        leaves, combine, negate = flat
        cols: list[Column] = []
        col_idx: dict[str, int] = {}
        terms = []
        for leaf in leaves:
            col = tbl.column(leaf.column)
            if col.field.type not in _GATHER_TYPES:
                return None, f"{leaf.column}:{col.field.type}"
            if compare_type(col.values.dtype, leaf.value) is None:
                return None, f"{leaf.column}:value"
            if col.validity is not None and (combine != "and" or negate):
                # nulls distribute over AND (mask & every validity) but
                # not over OR / NOT — those mixes stay on the host
                return None, f"{leaf.column}:validity"
            if leaf.column not in col_idx:
                col_idx[leaf.column] = len(cols)
                cols.append(col)
            terms.append((col_idx[leaf.column], _KERNEL_OPS[leaf.op],
                          leaf.value))
        if len(cols) > MAX_COLS:
            return None, "too-many-columns"
        if len(terms) > MAX_TERMS:
            return None, "too-many-terms"
        prog = build_program(terms, [c.values.dtype for c in cols],
                             combine, negate)
        return (prog, cols), None

    def evaluate_predicate(self, tbl, predicate, report=None):
        lowered, reason = self._lower(tbl, predicate)
        if lowered is None:
            if report is not None:
                report["predicate"] = f"host:{reason}"
            return predicate.evaluate(tbl)
        prog, cols = lowered
        mask = self._to_host(predicate_mask(
            [self._to_device(c.values) for c in cols], prog)).view("?")
        for c in cols:
            if c.validity is not None:     # AND-combine only (see _lower)
                mask = mask & c.validity
        if report is not None:
            report["predicate"] = "kernel"
        return mask

    # -- selection ---------------------------------------------------------
    def compact(self, tbl, mask, report=None):
        mask = np.asarray(mask, "?")
        mask_t = self._to_device(mask)
        offsets, count = block_offsets(mask_t)

        def kernel(values: np.ndarray) -> np.ndarray:
            return self._to_host(compact_rows(
                self._to_device(values), mask_t, offsets, count))

        idx = None
        routes = {}
        out_cols = []
        for c in tbl.columns:
            if c.field.type in _COMPACT_TYPES:
                validity = None if c.validity is None else \
                    kernel(c.validity)
                out_cols.append(Column(c.field, kernel(c.values), validity))
                routes[c.field.name] = "kernel"
            else:
                if idx is None:
                    idx = np.flatnonzero(mask)
                out_cols.append(c.take(idx))
                routes[c.field.name] = "host"
        if report is not None:
            report["compact"] = routes
        return Table(tbl.schema, out_cols)

    # -- explain -----------------------------------------------------------
    def describe(self, meta, rg, columns, predicate):
        """Per-column routing from footer metadata (encoding and dtype):
        the live scan routes by exactly these two."""
        names = list(columns) if columns is not None else meta.schema.names
        needed = set(names)
        if predicate is not None:
            needed |= predicate.columns()
        kernel, host = [], []
        for n in sorted(needed, key=meta.schema.index):
            field = meta.schema.field(n)
            chunk = rg.chunks[meta.schema.index(n)]
            if (chunk.encoding in (encodings.DICT, encodings.DICTP)
                    and field.type in _GATHER_TYPES):
                kernel.append(n)
            else:
                host.append(f"{n}({chunk.encoding})")
        pred = ""
        if predicate is not None:
            pred = " pred=fused" if _flatten(predicate) is not None \
                else " pred=host"
        detail = "; ".join(p for p in (
            f"kernel={','.join(kernel)}" if kernel else "",
            f"host={','.join(host)}" if host else "") if p)
        return f"torch[{detail}]{pred}"


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------

_BACKENDS: dict[str, DecodeBackend] = {}
_backends_lock = threading.Lock()


def resolve_backend(backend: "DecodeBackend | str | None") -> DecodeBackend:
    """Resolve a ``decode_backend=`` argument: None -> the NumPy host
    path (what storage-side ``scan_op`` runs), a known name ("numpy" /
    "torch") -> a shared instance, an instance passes through.  "torch"
    is ``TorchBackend("cuda")`` and raises when there is no card."""
    if isinstance(backend, DecodeBackend):
        return backend
    if backend is None:
        backend = "numpy"
    if backend in ("numpy", "torch"):
        with _backends_lock:
            inst = _BACKENDS.get(backend)
            if inst is None:
                inst = NumPyBackend() if backend == "numpy" \
                    else TorchBackend("cuda")
                _BACKENDS[backend] = inst
        return inst
    raise ValueError(
        f"unknown decode backend {backend!r}: pass 'numpy', 'torch', or "
        "a DecodeBackend instance")
