"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every source under ``oece_tpu_torch/csrc``
into one shared library with a plain C interface, named by a hash of the
sources and flags, in ``build/oece_tpu_torch/`` of the checkout (listed in
.gitignore).  The library is loaded with ctypes; pointers and the stream are
passed as ``c_void_p``.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "oece_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None
BUILD_SECONDS = 0.0  # wall time of the nvcc run of this process (0 if cached)
BUILD_LOG = ""  # nvcc's output (register and shared-memory use per kernel)


def _nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in cands:
        path = os.path.join(root, "bin", "nvcc") if root else ""
        if path and os.path.isfile(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
            "from oece_tpu_torch/csrc at first use"
        )
    return found


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liboece_tpu_torch_{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
        cmd += [str(s) for s in _sources() if s.suffix == ".cu"]
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_SECONDS = time.time() - t0
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.oece_blind_rotate_rot.restype = ctypes.c_int
    lib.oece_blind_rotate_rot.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p
    ]
    lib.oece_error_string.restype = ctypes.c_char_p
    lib.oece_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib
