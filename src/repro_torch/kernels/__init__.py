"""Hand-written CUDA kernels for the client-side scan, for Hopper (sm_90a).

The client-side decode engine (``repro_torch.aformat.decode.TorchBackend``)
runs one kernel per hook of the row-group template:

  dict_decode       DICT/DICTP column gather, in the column's own dtype
  predicate_fused   flat AND/OR of column-vs-constant compares -> byte mask
  token_pack        order-preserving compaction of the selected rows

Each package holds ``<name>.py`` (the wrapper: checks, output allocation,
the launch on the current stream, a ``LAUNCHES`` count) and ``ref.py``
(the plain PyTorch version).  The CUDA sources are in ``csrc/``;
``build.py`` compiles them with ``nvcc`` at first use and binds them with
ctypes.  A CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel, or the call raises.
"""

from repro_torch.kernels.dict_decode.dict_decode import dict_decode
from repro_torch.kernels.predicate_fused.predicate_fused import (
    build_program, compare_type, predicate_mask)
from repro_torch.kernels.token_pack.token_pack import (block_offsets, compact,
                                                       pack_tokens)

__all__ = ["dict_decode", "build_program", "compare_type", "predicate_mask",
           "block_offsets", "compact", "pack_tokens"]
