"""Build the CUDA kernels and bind them through ctypes.

Every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``) by its own
``nvcc -c`` process, all started together, and the objects are linked by
one more ``nvcc`` call into a single shared library with a plain C
interface.  Nothing includes PyTorch's headers, so a build takes seconds.
The library lands in ``build/kernels/`` at the root of the checkout,
named by a hash of the sources, at first use; a later call in the same
process, or a later process over the same sources, reuses it.

Each entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a nonzero code into a ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: entry point -> ctypes argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "dict_decode_launch": [_P, _P, _P, _P, _LL, _LL, _I, _P],
    "predicate_fused_launch": [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                               _P, _LL, _P],
    "token_pack_count_launch": [_P, _P, _LL, _P],
    "token_pack_scatter_launch": [_P, _P, _P, _P, _LL, _LL, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: what the last build in this process reported: seconds and ptxas lines
BUILD_INFO: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(sources: list[Path], target: Path) -> None:
    nvcc = _nvcc()
    out_dir = target.parent / f"obj-{target.stem}-{os.getpid()}"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in sources:
        obj = out_dir / f"{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log += out.splitlines()
        if proc.returncode:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *[str(obj) for _, obj, _ in procs]],
                          capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, target)
    shutil.rmtree(out_dir, ignore_errors=True)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, built=True,
                      ptxas=[ln for ln in log
                             if "ptxas" in ln or "spill" in ln])


def library() -> ctypes.CDLL:
    """The kernels' shared library: built at first use, then cached."""
    global _lib
    with _lock:
        if _lib is None:
            sources = _sources()
            target = BUILD_DIR / f"libreprotorch-{_digest(sources)}.so"
            if target.exists():
                BUILD_INFO.update(seconds=0.0, built=False, ptxas=[])
            else:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                _build(sources, target)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def cuda_device(*tensors):
    """The one CUDA device all of a launch's tensors lie on; raises when a
    tensor is on the CPU, on another card, or not contiguous."""
    device = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != device or not t.is_contiguous():
            raise ValueError("kernel launch needs contiguous CUDA tensors "
                             f"on one device, got {t.device} "
                             f"{tuple(t.shape)}")
    return device


def check(code: int, kernel: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if code:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error "
                           f"{code}")
