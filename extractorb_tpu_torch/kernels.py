"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

All kernels are compiled by one ``nvcc`` call into one shared library
with a plain C interface, loaded with ``ctypes``.  The library is built
at first use into ``build/kernels/`` beside the package (listed in
``.gitignore``) and rebuilt when a source file or the flags change: its
file name carries a hash of both.  Nothing here runs at import time, so
the package imports on machines without ``nvcc`` or a card.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on anything but 0.  ``LAUNCHES``
counts kernel launches per wrapper: each wrapper adds one where it
launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
# No --use_fast_math, and no contraction of a*b+c into FMAs: K2 must round
# like its plain PyTorch version (K1 and K3 are integer code; K4 is bound
# by latency, not by float throughput).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of each C entry point; every one ends with the stream
_SIGNATURES = {
    # pyr, score, keep, tab(host ptr), n_blocks, smem_bytes, stream
    "fast_detect_launch": (_P, _P, _P, _P, _I, _I, _P),
    # pyr, xy, level, valid, K, pattern, umax, tab(host ptr), angle, desc, stream
    "orb_describe_launch": (_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P),
    # q_desc, q_u, q_v, q_r, q_lo, q_hi, q_ok, M,
    # c_desc, c_x, c_y, c_oct, c_ok, N, best, second, best_idx, second_idx, stream
    "hamming_best2_launch": (_P, _P, _P, _P, _P, _P, _P, _I,
                             _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P),
    # R0, t0, pts, obs, isig, valid, B, N, fx, fy, cx, cy,
    # n_rounds, n_iters, R, t, inliers, n_inliers, stream
    "pose_lm_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F,
                       _I, _I, _P, _P, _P, _P, _P),
}

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libextractorb_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is up to date."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), *cu],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name}: argument {i} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
