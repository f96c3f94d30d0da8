"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source for ``sm_90a`` (one process per source,
all started together) and links them into one shared library with a
plain C interface, loaded with ``ctypes``. The library lands in
``src/repro_torch/_build/`` (git-ignored) under a name carrying a hash
of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing is built at import: the first kernel
launch (or :func:`library`) builds, so ``python3 chip_smoke.py`` alone
builds everything from the checkout.

``LAUNCHES`` counts kernel launches by kernel name; each wrapper adds
one exactly where it launches, so a run can show that its main path went
through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("common.cu", "spectral_matmul.cu", "spectral_matmul_q8.cu", "paged_decode.cu",
           "flash_attention.cu", "mlstm_chunk.cu", "mamba_scan.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_LOG: Dict[str, object] = {}   # seconds, per-source ptxas report


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else the toolkit PyTorch found, else PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidates.append(Path(CUDA_HOME) / "bin" / "nvcc")
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit's bin/ on PATH to build the port's kernels")
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for name in sorted(p.name for p in CSRC_DIR.iterdir()):
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernel library if it is not built yet; return
    its path."""
    lib_path = BUILD_DIR / f"libsct_kernels_{_digest()}.so"
    if lib_path.is_file():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs: List[tuple] = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        reports = {}
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            reports[src] = out
            if proc.returncode != 0:
                failed.append(f"{src}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_lib, lib_path)
    BUILD_LOG.update(seconds=time.time() - t0, ptxas=reports)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.sct_error_string.argtypes = [i]
            lib.sct_error_string.restype = ctypes.c_char_p
            lib.sct_spectral_matmul.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
            lib.sct_spectral_matmul.restype = i
            lib.sct_spectral_matmul_q8.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
            lib.sct_spectral_matmul_q8.restype = i
            lib.sct_paged_gqa_decode.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                                 i, f, p]
            lib.sct_paged_gqa_decode.restype = i
            lib.sct_paged_gqa_decode_cold.argtypes = [p] * 11 + [i] * 7 + [f, p]
            lib.sct_paged_gqa_decode_cold.restype = i
            lib.sct_flash_attention_fwd.argtypes = [p] * 6 + [i] * 8 + [f, p]
            lib.sct_flash_attention_fwd.restype = i
            lib.sct_flash_attention_bwd.argtypes = [p] * 11 + [i] * 8 + [f, p]
            lib.sct_flash_attention_bwd.restype = i
            lib.sct_mlstm_chunk.argtypes = [p] * 13 + [i] * 3 + [p]
            lib.sct_mlstm_chunk.restype = i
            lib.sct_mamba_scan.argtypes = [p] * 8 + [i] * 5 + [p]
            lib.sct_mamba_scan.restype = i
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = library().sct_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor, name: str) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"{name}: unsupported dtype {t.dtype}; "
                        f"kernels take {list(DTYPE_CODES)}") from None


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device and contiguous, else raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device "
                             f"(got {t.device} and {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
