"""Plain PyTorch versions of the compaction kernels."""

from __future__ import annotations

import torch

BLOCK = 1024


def block_counts_ref(mask: torch.Tensor) -> torch.Tensor:
    """(N,) mask -> (ceil(N / BLOCK),) int32 selected rows per block."""
    n = mask.numel()
    m = torch.zeros(-(-n // BLOCK) * BLOCK, dtype=torch.int32,
                    device=mask.device)
    m[:n] = mask.ne(0)
    return m.view(-1, BLOCK).sum(1, dtype=torch.int32)


def compact_ref(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """values (N,), mask (N,) -> the selected values, in order."""
    return values[mask.ne(0)]


def pack_tokens_ref(values: torch.Tensor, mask: torch.Tensor,
                    capacity: int) -> tuple[torch.Tensor, int]:
    """The selected values in order, cut or zero-padded to ``capacity``,
    and how many of them there are (at most ``capacity``)."""
    kept = compact_ref(values, mask)[:capacity]
    out = torch.zeros(capacity, dtype=values.dtype, device=values.device)
    out[:kept.numel()] = kept
    return out, kept.numel()
