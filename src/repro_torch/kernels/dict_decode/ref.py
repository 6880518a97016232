"""Plain PyTorch version of the dictionary decode kernel."""

from __future__ import annotations

import torch


def dict_decode_ref(codes: torch.Tensor, dictionary: torch.Tensor
                    ) -> torch.Tensor:
    """codes (N,) int32, dictionary (D,) -> (N,) ``dictionary[codes]``;
    a code outside ``[0, D)`` raises ``ValueError``."""
    if codes.numel() and (int(codes.min()) < 0
                          or int(codes.max()) >= dictionary.numel()):
        raise ValueError("dict_decode: code outside the dictionary")
    return dictionary[codes.long()]
