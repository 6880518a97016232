"""PyTorch/CUDA port of the Arrow-native storage system's client scan.

A self-contained package beside ``repro``: the host layers (``aformat``,
``storage``, ``dataset``, ``core``) are its own copies, and the client
decode plane (``aformat.decode.TorchBackend``) runs the scan's dictionary
decode, predicate and compaction as hand-written CUDA kernels
(``kernels``) on an NVIDIA H100.  ``interop.cluster_from_files`` rebuilds
a cluster from another cluster's files.
"""
