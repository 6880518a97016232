"""Order-preserving compaction of masked rows on the card.

The CUDA kernels are in ``kernels/csrc/token_pack.cu``: one counts the
selected rows of each 1024-row block, one writes a column's selected
values to their block's offset plus their rank in the block.  The block
offsets (:func:`block_offsets`) are computed once per mask and reused for
every column (:func:`compact`).  Values are copied as raw bits (1-, 4- or
8-byte elements).  A CPU tensor goes to the plain versions in ``ref.py``;
a CUDA tensor goes to the kernels, or the call raises.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.token_pack.ref import (BLOCK, block_counts_ref,
                                                compact_ref)

#: element types the scatter kernel copies
DTYPES = (torch.bool, torch.uint8, torch.int32, torch.int64, torch.float32,
          torch.float64)

#: launches of either kernel in this process
LAUNCHES = 0
_count_lock = threading.Lock()


def _counted() -> None:
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1


def _mask_bytes(mask: torch.Tensor) -> torch.Tensor:
    if mask.dtype not in (torch.bool, torch.uint8) or mask.dim() != 1:
        raise TypeError("token_pack: mask must be a 1-D bool or uint8 "
                        f"tensor, not {mask.dtype} {tuple(mask.shape)}")
    return mask.view(torch.uint8) if mask.dtype == torch.bool else mask


def count_launch(mask: torch.Tensor, counts: torch.Tensor) -> None:
    """Enqueue the block-count kernel; no synchronisation."""
    mask = _mask_bytes(mask)
    device = build.cuda_device(mask, counts)
    with torch.cuda.device(device):
        code = build.library().token_pack_count_launch(
            mask.data_ptr(), counts.data_ptr(), mask.numel(),
            torch.cuda.current_stream(device).cuda_stream)
    build.check(code, "token_pack.count")
    _counted()


def scatter_launch(values: torch.Tensor, mask: torch.Tensor,
                   offsets: torch.Tensor, out: torch.Tensor) -> None:
    """Enqueue the scatter kernel; rows past ``out``'s length are
    dropped.  No synchronisation."""
    mask = _mask_bytes(mask)
    device = build.cuda_device(values, mask, offsets, out)
    if values.element_size() not in (1, 4, 8):
        raise TypeError(f"token_pack: no kernel for {values.dtype}")
    with torch.cuda.device(device):
        code = build.library().token_pack_scatter_launch(
            values.data_ptr(), mask.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), values.numel(), out.numel(),
            values.element_size(),
            torch.cuda.current_stream(device).cuda_stream)
    build.check(code, "token_pack.scatter")
    _counted()


def block_offsets(mask: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(N,) mask -> (int64 exclusive offset of each 1024-row block, the
    number of selected rows).  Reads the count back to the host."""
    m = _mask_bytes(mask)
    if m.device.type == "cpu":
        counts = block_counts_ref(m)
    elif m.device.type == "cuda":
        counts = torch.empty(-(-m.numel() // BLOCK), dtype=torch.int32,
                             device=m.device)
        if m.numel():
            count_launch(m, counts)
    else:
        raise ValueError(f"token_pack: unsupported device {m.device}")
    inclusive = torch.cumsum(counts, 0, dtype=torch.int64)
    total = int(inclusive[-1]) if inclusive.numel() else 0
    return inclusive - counts, total


def compact(values: torch.Tensor, mask: torch.Tensor, offsets: torch.Tensor,
            count: int) -> torch.Tensor:
    """values (N,), the mask and its :func:`block_offsets` -> the
    ``count`` selected values, in order."""
    m = _mask_bytes(mask)
    if values.dtype not in DTYPES:
        raise TypeError(f"token_pack: no kernel for {values.dtype}")
    if values.dim() != 1 or values.numel() != m.numel():
        raise ValueError("token_pack: values and mask differ in shape")
    if values.device != m.device:
        raise ValueError(f"token_pack: values on {values.device}, mask on "
                         f"{m.device}")
    if values.device.type == "cpu":
        return compact_ref(values, m)
    if values.device.type != "cuda":
        raise ValueError(f"token_pack: unsupported device {values.device}")
    out = torch.empty(count, dtype=values.dtype, device=values.device)
    if values.numel():
        scatter_launch(values, m, offsets, out)
    return out


def pack_tokens(values: torch.Tensor, mask: torch.Tensor, capacity: int
                ) -> tuple[torch.Tensor, int]:
    """The reference's contract: (values, mask, capacity) -> (the selected
    values in order, cut or zero-padded to ``capacity``; how many of them
    there are, at most ``capacity``)."""
    offsets, total = block_offsets(mask)
    kept = min(total, capacity)
    selected = compact(values, mask, offsets, kept)
    out = torch.zeros(capacity, dtype=values.dtype, device=values.device)
    out[:kept] = selected[:kept]
    return out, kept
