"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use with ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds).  Libraries land in ``build/kernels/`` at the root of
the checkout, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a changed source or header is rebuilt and
an unchanged one is reused.  :func:`build` compiles
several sources in parallel, one ``nvcc`` each.

Every C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``;
:func:`check` raises if that is not 0.  ``LAUNCHES`` counts, per wrapper,
the calls that launched its kernel (a call of ``sort_pairs`` or
``knn_topk`` runs a short sequence of launches and counts once) — a wrapper
adds one exactly where it launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("sorted_lookup", "edge_expand", "dedup_compact", "sort_pairs",
           "knn_topk", "rmsnorm", "flash_fwd", "flash_bwd", "segment_spmm",
           "embedding_bag")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"searchsorted_left_ranged": 0, "searchsorted_left": 0,
            "expand": 0,
            "dedup_compact_rows": 0, "sort_rows": 0, "sort_pairs": 0,
            "knn_topk": 0, "rmsnorm_fwd": 0, "flash_fwd": 0,
            "flash_bwd_dkv": 0, "flash_bwd_dq": 0, "segment_spmm": 0,
            "embedding_bag": 0}

_LIBS: dict = {}
_FUNCS: dict = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile the named sources that have no up-to-date library, all in
    parallel.  Returns {name: ptxas report} for the sources compiled now."""
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, path)
    reports, failed = {}, []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def function(source: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<source>.cu``, built on first
    use; ``argtypes`` is a list of ctypes types (c_void_p for pointers and
    the stream)."""
    fn = _FUNCS.get((source, symbol))
    if fn is not None:
        return fn
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            build((source,))
            lib = _LIBS[source] = ctypes.CDLL(str(_lib_path(source)))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    _FUNCS[(source, symbol)] = fn
    return fn


def stream_of(t) -> int:
    """The raw handle of PyTorch's current CUDA stream on ``t``'s device,
    the stream every kernel launches on (inside ``torch.cuda.graph`` the
    capture stream).  PyTorch's own raw-stream query, the one its generated
    kernels make at each launch: ``torch.cuda.current_stream(device)``
    builds a ``Stream`` object first, which took a fifth of a short
    wrapper's host time (chip_smoke.py's kernel report times both in
    ``host_parts_ms``)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def dtype_code(t) -> int:
    """The C entry points' dtype code of a float kernel's input: 0 float32,
    1 bfloat16."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise ValueError(f"float kernels take float32 or bfloat16, got "
                         f"{t.dtype}")
    return codes[t.dtype]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} (a cudaError_t code)")


def require_cuda(*tensors) -> None:
    """Every tensor must be on the same CUDA device (a kernel never runs on
    anything else, and never falls back).  Reads ``is_cuda`` and the device
    index, not ``Tensor.device``, which builds an object a tensor."""
    dev = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"kernel inputs must share one CUDA device, got "
                             f"{[str(x.device) for x in tensors]}")
