"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``*.cu`` source under
``oece_tpu_torch/csrc`` (one process per source, all started together) and
links the objects into one shared library with a plain C interface, named
by a hash of the sources (headers included) and flags, in
``build/oece_tpu_torch/`` of the checkout (listed in .gitignore).  The
library is loaded with ctypes; pointers and the stream are passed as
``c_void_p``.  Nothing is built at import time.
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
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
BUILD_SECONDS = 0.0  # wall time of the nvcc runs of this process (0 if cached)
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


def _build(so: Path) -> str:
    """Compile the .cu sources in parallel, link them into ``so``; returns
    nvcc's output.  Temporaries carry the pid, so concurrent builds of one
    hash do not collide."""
    nvcc, tag = _nvcc(), str(os.getpid())
    objs, procs = [], []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    try:
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        tmp = so.with_suffix(f".{tag}.tmp")
        link = subprocess.run(
            [nvcc, *GENCODE, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return log


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.time()
        BUILD_LOG = _build(so)
        BUILD_SECONDS = time.time() - t0
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.oece_blind_rotate_rot.restype = i32
    lib.oece_blind_rotate_rot.argtypes = [ptr] * 6 + [i32] * 9 + [ptr]
    lib.oece_blind_rotate_ap.restype = i32
    lib.oece_blind_rotate_ap.argtypes = [ptr] * 8 + [i32] * 8 + [ptr]
    lib.oece_ap_live_table.restype = i32
    lib.oece_ap_live_table.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    lib.oece_blind_rotate_std.restype = i32
    lib.oece_blind_rotate_std.argtypes = [ptr] * 6 + [i32] * 9 + [ptr]
    lib.oece_std_build.restype = i32
    lib.oece_std_build.argtypes = [ptr] * 2 + [i32] * 2 + [ptr]
    lib.oece_blind_rotate_rev.restype = i32
    lib.oece_blind_rotate_rev.argtypes = [ptr] * 5 + [i32] * 9 + [ptr]
    lib.oece_rev_window_matmul.restype = i32
    lib.oece_rev_window_matmul.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
    lib.oece_rev_matmul_dec.restype = i32
    lib.oece_rev_matmul_dec.argtypes = [ptr] * 4 + [i32] * 9 + [ptr]
    lib.oece_cmux_epilogue_true.restype = i32
    lib.oece_cmux_epilogue_true.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
    lib.oece_diag_matmul.restype = i32
    lib.oece_diag_matmul.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    lib.oece_negacyclic_matmul.restype = i32
    lib.oece_negacyclic_matmul.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    lib.oece_window_matmul.restype = i32
    lib.oece_window_matmul.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    lib.oece_build_rev.restype = i32
    lib.oece_build_rev.argtypes = [ptr] * 2 + [i32] * 4 + [ptr]
    lib.oece_rot_step.restype = i32
    lib.oece_rot_step.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
    lib.oece_error_string.restype = ctypes.c_char_p
    lib.oece_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib
