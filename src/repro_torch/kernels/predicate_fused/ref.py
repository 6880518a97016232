"""Plain PyTorch version of the fused predicate kernel."""

from __future__ import annotations

import operator

import torch

_OPS = {"lt": operator.lt, "le": operator.le, "gt": operator.gt,
        "ge": operator.ge, "eq": operator.eq, "ne": operator.ne}


def predicate_mask_ref(cols: list[torch.Tensor], prog) -> torch.Tensor:
    """cols: (N,) tensors; prog: a ``predicate_fused.Program`` -> (N,)
    uint8 mask.  Each term compares in its compare type, as the kernel
    does."""
    acc = None
    for t in prog.terms:
        x = cols[t.col].to(t.torch_ctype)
        v = torch.tensor(t.value, dtype=t.torch_ctype, device=x.device)
        m = _OPS[t.op](x, v)
        if acc is None:
            acc = m
        else:
            acc = acc & m if prog.combine == "and" else acc | m
    if prog.negate:
        acc = ~acc
    return acc.to(torch.uint8)
