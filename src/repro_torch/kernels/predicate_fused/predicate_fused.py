"""Fused predicate: a flat AND/OR of ``column OP constant`` terms,
optionally negated, evaluated in one pass into a uint8 mask on the card.

The CUDA kernel is ``kernels/csrc/predicate_fused.cu``.  It reads up to
``MAX_COLS`` columns in place, each in its own dtype, and runs up to
``MAX_TERMS`` terms per row.  Each term compares in the type NumPy 2 uses
for ``column OP constant`` (NEP 50): :func:`compare_type` computes it on
the host, so the mask equals ``Expr.evaluate`` bit for bit.  A CPU tensor
goes to the plain version in ``ref.py``; a CUDA tensor goes to the kernel,
or the call raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.predicate_fused.ref import predicate_mask_ref

MAX_COLS = 8
MAX_TERMS = 16
OPS = ("lt", "le", "gt", "ge", "eq", "ne")
#: column dtypes and compare types the kernel takes -> its type codes
TYPE_CODES = {np.dtype(np.int32): 0, np.dtype(np.int64): 1,
              np.dtype(np.float32): 2, np.dtype(np.float64): 3}
_TORCH_TYPES = {np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}
_CODE_OF_TORCH = {t: TYPE_CODES[d] for d, t in _TORCH_TYPES.items()}

#: kernel launches in this process
LAUNCHES = 0
_count_lock = threading.Lock()


def compare_type(dtype, value) -> np.dtype | None:
    """The type NumPy compares ``array(dtype) OP value`` in, with the
    constant converted exactly as NumPy converts it — or None when the
    kernel cannot take the pair (a non-numeric constant, a type other than
    int32/int64/float32/float64, an integer constant outside the compare
    type's range)."""
    if isinstance(value, (str, bytes)) or not np.isscalar(value):
        return None
    try:
        ctype = np.result_type(np.dtype(dtype), value)
    except (TypeError, ValueError, OverflowError):
        return None
    if ctype not in TYPE_CODES:
        return None
    if ctype.kind == "i":
        if not isinstance(value, (bool, int, np.bool_, np.integer)):
            return None
        info = np.iinfo(ctype)
        if not info.min <= int(value) <= info.max:
            return None
    elif not np.isfinite(ctype.type(float(value))) and \
            np.isfinite(float(value)):
        return None                  # overflows the compare type
    return ctype


@dataclasses.dataclass(frozen=True)
class Term:
    col: int            # index into the column list
    op: str             # one of OPS
    ctype: np.dtype     # compare type, from compare_type()
    value: float | int  # the constant, converted to ctype

    @property
    def torch_ctype(self) -> torch.dtype:
        return _TORCH_TYPES[self.ctype]


@dataclasses.dataclass(frozen=True)
class Program:
    terms: tuple[Term, ...]
    combine: str = "and"          # "and" | "or"
    negate: bool = False

    def __post_init__(self):
        if self.combine not in ("and", "or"):
            raise ValueError(self.combine)
        if not 1 <= len(self.terms) <= MAX_TERMS:
            raise ValueError(f"{len(self.terms)} terms; the kernel takes "
                             f"1 to {MAX_TERMS}")
        for t in self.terms:
            if t.op not in OPS:
                raise ValueError(t.op)
            if t.ctype not in TYPE_CODES:
                raise ValueError(f"compare type {t.ctype}")


def build_program(terms: list[tuple[int, str, object]], dtypes: list,
                  combine: str = "and", negate: bool = False) -> Program:
    """(column index, op, constant) terms over columns of ``dtypes`` ->
    a Program whose terms carry NumPy's compare type; raises
    ``ValueError`` for a term the kernel cannot take."""
    out = []
    for col, op, value in terms:
        ctype = compare_type(dtypes[col], value)
        if ctype is None:
            raise ValueError(f"no kernel compare for {np.dtype(dtypes[col])}"
                             f" {op} {value!r}")
        out.append(Term(col, op, ctype, ctype.type(value).item()))
    return Program(tuple(out), combine, negate)


def _check(cols: list[torch.Tensor], prog: Program) -> None:
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"predicate_fused: {len(cols)} columns; the "
                         f"kernel takes 1 to {MAX_COLS}")
    n = cols[0].numel()
    for c in cols:
        if c.dtype not in _CODE_OF_TORCH:
            raise TypeError(f"predicate_fused: no kernel for {c.dtype}")
        if c.dim() != 1 or c.numel() != n:
            raise ValueError("predicate_fused: columns must be 1-D of one "
                             "length")
        if c.device != cols[0].device:
            raise ValueError("predicate_fused: columns on several devices")
    for t in prog.terms:
        if not 0 <= t.col < len(cols):
            raise ValueError(f"predicate_fused: term column {t.col}")


def launch(cols: list[torch.Tensor], prog: Program, out: torch.Tensor
           ) -> None:
    """Enqueue the kernel on the current stream; no synchronisation."""
    global LAUNCHES
    device = build.cuda_device(*cols, out)
    nc, terms = len(cols), prog.terms
    nt = len(terms)
    args = (
        (ctypes.c_void_p * nc)(*[c.data_ptr() for c in cols]),
        (ctypes.c_int * nc)(*[_CODE_OF_TORCH[c.dtype] for c in cols]), nc,
        (ctypes.c_int * nt)(*[t.col for t in terms]),
        (ctypes.c_int * nt)(*[OPS.index(t.op) for t in terms]),
        (ctypes.c_int * nt)(*[TYPE_CODES[t.ctype] for t in terms]),
        (ctypes.c_double * nt)(*[float(t.value) if t.ctype.kind == "f"
                                 else 0.0 for t in terms]),
        (ctypes.c_longlong * nt)(*[int(t.value) if t.ctype.kind == "i"
                                   else 0 for t in terms]),
        nt, int(prog.combine == "or"), int(prog.negate), out.data_ptr(),
        out.numel())
    with torch.cuda.device(device):
        code = build.library().predicate_fused_launch(
            *args, torch.cuda.current_stream(device).cuda_stream)
    build.check(code, "predicate_fused")
    with _count_lock:
        LAUNCHES += 1


def predicate_mask(cols: list[torch.Tensor], prog: Program) -> torch.Tensor:
    """cols: (N,) int32/int64/float32/float64 tensors -> (N,) uint8 mask
    of ``prog`` over them."""
    _check(cols, prog)
    device = cols[0].device
    if device.type == "cpu":
        return predicate_mask_ref(cols, prog)
    if device.type != "cuda":
        raise ValueError(f"predicate_fused: unsupported device {device}")
    out = torch.empty(cols[0].numel(), dtype=torch.uint8, device=device)
    if out.numel():
        launch(cols, prog, out)
    return out
