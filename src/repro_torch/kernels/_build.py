"""Build and load the port's CUDA kernels.

At first use, one ``nvcc`` per source under ``csrc/``, all started
together, compiles the sources into objects that one more ``nvcc`` links
into a shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so the build takes seconds, not minutes; the longest
source sets the pace).
The library lands under ``build/repro_torch/<hash>/`` at the root of the
checkout, keyed by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.

Flags: ``sm_90a`` (Hopper), ``-O3``, and no ``--use_fast_math``: the
quantize kernel needs IEEE division and ``rintf``, and the pier-update
and dequantize kernels unfused products and sums, to match their plain
versions bit for bit.

Every C entry returns a ``cudaError_t``: the launch entries bind the
calling thread to the tensors' card (``cudaSetDevice``, the card's index
passed just before the stream) and return ``cudaGetLastError()`` after
their launch, the symmetric-buffer entries
(``csrc/ipc.cu``) the result of their runtime call. :func:`check` raises
when it is not 0, because a refused launch (too many threads, too much
shared memory) never runs and a later synchronize does not report it.
Processes that share a build (the ranks of a training world) load the
library their parent built; ``build`` writes it atomically.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_ulonglong
_PP = ctypes.POINTER(ctypes.c_void_p)

# C signature of every entry point: (name, argtypes). Each returns an int
# cudaError_t. Pointers and the stream are c_void_p, so a 64-bit address is
# never cut to a 32-bit int.
SIGNATURES = {
    "quantize_blockwise_launch": [
        _P, _I, _L, _P, _P, _L, _I, _F, _F, _I, _P],
    "dequantize_blockwise_launch": [_P, _P, _P, _L, _I, _I, _P],
    "flash_attention_fwd_launch": [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
    "flash_attention_bwd_launch": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
        _I, _F, _F, _I, _P],
    "flash_attention_fwd_tc_launch": [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
    "flash_attention_bwd_tc_launch": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
    "pier_update_launch": [
        _P, _I, _P, _I, _P, _I, _P, _P, _L, _F, _F, _I, _I, _P],
    "paged_decode_attention_launch": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _I, _F, _F, _I, _P],
    "rmsnorm_fwd_launch": [_P, _P, _P, _P, _I, _L, _I, _F, _I, _I, _P],
    "rmsnorm_fwd_rowblock_launch": [_P, _P, _P, _P, _I, _L, _I, _F, _I, _P],
    "rmsnorm_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _P],
    "ring_allgather_launch": [_P, _L, _P, _PP, _L, _I, _I, _U, _U, _P, _I, _I, _P],
    "shard_scatter_launch": [_P, _L, _P, _PP, _L, _I, _I, _U, _U, _P, _I, _I, _P],
    "symm_alloc": [_I, _L, _PP],
    "symm_free": [_I, _P],
    "ipc_get_handle": [_P, _P],
    "ipc_open_handle": [_I, _P, _PP],
    "ipc_close_handle": [_I, _P],
    "host_flag_alloc": [_PP, _PP],
    "host_flag_free": [_P],
    "ipc_handle_bytes": [],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build (or load) in this process


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built at first use on a "
        "machine with the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "librepro_torch_kernels.so"


def _run(cmd) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")


def build() -> Path:
    """Compile the sources into the library (if not built yet); its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [out.with_name(f".{s.stem}.{tag}.o") for s in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(srcs, objs)]
    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        # every compile runs to its end before the first failure is raised
        for fut in [pool.submit(_run, c) for c in cmds]:
            fut.result()
    tmp = out.with_name(f".{out.name}.{tag}")
    _run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)])
    for o in objs:
        o.unlink()
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def lib():
    """The loaded kernel library, built at first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.repro_cuda_error_string.argtypes = [ctypes.c_int]
            handle.repro_cuda_error_string.restype = ctypes.c_char_p
            build_seconds = time.perf_counter() - t0
            _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``: every kernel launches there."""
    return torch.cuda.current_stream(device).cuda_stream


# dtype codes of the C interface (csrc/common.cuh: enum DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
