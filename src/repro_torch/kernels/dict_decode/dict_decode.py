"""Dictionary decode: ``out[i] = dictionary[codes[i]]`` on the card.

The CUDA kernel is ``kernels/csrc/dict_decode.cu``; it copies each
element's bits, so every dtype and every value (NaN, -0.0, int64 above
2**53) comes back exactly.  A CPU tensor goes to the plain version in
``ref.py``; a CUDA tensor goes to the kernel, or the call raises.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dict_decode.ref import dict_decode_ref

#: element types the kernel gathers (as 4- or 8-byte words)
DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64)

#: kernel launches in this process
LAUNCHES = 0
_count_lock = threading.Lock()


def _check(codes: torch.Tensor, dictionary: torch.Tensor) -> None:
    if codes.dtype != torch.int32:
        raise TypeError(f"dict_decode: codes must be int32, not {codes.dtype}")
    if dictionary.dtype not in DTYPES:
        raise TypeError(f"dict_decode: no kernel for {dictionary.dtype}")
    if codes.dim() != 1 or dictionary.dim() != 1:
        raise ValueError("dict_decode: codes and dictionary must be 1-D")
    if codes.device != dictionary.device:
        raise ValueError("dict_decode: codes and dictionary on "
                         f"{codes.device} and {dictionary.device}")
    if dictionary.numel() >= 2 ** 31:
        raise ValueError("dict_decode: dictionary too large")


def launch(codes: torch.Tensor, dictionary: torch.Tensor, out: torch.Tensor,
           err: torch.Tensor) -> None:
    """Enqueue the kernel on the current stream; no synchronisation.
    ``err`` is a zeroed int32 flag that a bad code sets to 1."""
    global LAUNCHES
    device = build.cuda_device(codes, dictionary, out, err)
    with torch.cuda.device(device):
        code = build.library().dict_decode_launch(
            codes.data_ptr(), dictionary.data_ptr(), out.data_ptr(),
            err.data_ptr(), codes.numel(), dictionary.numel(),
            dictionary.element_size(),
            torch.cuda.current_stream(device).cuda_stream)
    build.check(code, "dict_decode")
    with _count_lock:
        LAUNCHES += 1


def dict_decode(codes: torch.Tensor, dictionary: torch.Tensor
                ) -> torch.Tensor:
    """codes (N,) int32, dictionary (D,) int32/int64/float32/float64 ->
    (N,) decoded values of the dictionary's dtype.  Raises ``ValueError``
    when a code lies outside ``[0, D)``."""
    _check(codes, dictionary)
    if codes.device.type == "cpu":
        return dict_decode_ref(codes, dictionary)
    if codes.device.type != "cuda":
        raise ValueError(f"dict_decode: unsupported device {codes.device}")
    out = torch.empty(codes.numel(), dtype=dictionary.dtype,
                      device=codes.device)
    if codes.numel() == 0:
        return out
    err = torch.zeros(1, dtype=torch.int32, device=codes.device)
    launch(codes, dictionary, out, err)
    if int(err.item()):
        raise ValueError("dict_decode: code outside the dictionary")
    return out
