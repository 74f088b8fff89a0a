"""ctypes bindings of the port's native (C++) Bristol parser and levelizer
(counterpart of oece_tpu.circuits.native).

The source is the port's own copy, ``oece_tpu_torch/csrc/host/
oece_native.cpp``.  At first use it is built with ``g++`` into
``build/oece_tpu_torch/`` of the checkout (gitignored), named by a hash of
the source and flags; the JAX package's ``native/`` and its prebuilt
library are never built or loaded.  The Python implementations in
bristol.py and netlist.py define the behaviour; the native versions are
bit-identical accelerations, used automatically when the library builds
(``OECE_NO_NATIVE=1`` keeps the Python parser).  If the build fails the
bindings return None and the Python versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "csrc" / "host" / "oece_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "oece_tpu_torch"
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lib = None
_failed = False
BUILD_SECONDS = 0.0  # wall time of this process's g++ run (0 if cached)
BUILD_ERROR = ""  # g++'s output when the build failed


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode() + SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"liboece_native_{h}.so"


def _build(so: Path) -> None:
    """g++ the source into ``so`` (through a temporary named by the pid)."""
    global BUILD_SECONDS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.time()
    subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", str(tmp), str(SRC)],
                   check=True, capture_output=True, text=True, timeout=300)
    os.replace(tmp, so)
    BUILD_SECONDS = time.time() - t0


def _load():
    global _lib, _failed, BUILD_ERROR
    if _lib is not None or _failed:
        return _lib
    so = library_path()
    try:
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError) as e:
        _failed = True
        BUILD_ERROR = getattr(e, "stderr", None) or str(e)
        return None
    lib.oece_parse_bristol.restype = ctypes.c_void_p
    lib.oece_parse_bristol.argtypes = [ctypes.c_char_p]
    lib.oece_parse_error.restype = ctypes.c_char_p
    lib.oece_parse_error.argtypes = [ctypes.c_void_p]
    for fn in ("oece_parse_n_gates", "oece_parse_n_wires"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("oece_parse_n_inputs", "oece_parse_n_outputs"):
        getattr(lib, fn).restype = ctypes.c_int32
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.oece_parse_io_bits.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.oece_parse_gates.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
    lib.oece_parse_free.argtypes = [ctypes.c_void_p]
    lib.oece_levelize.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def parse_bristol_native(path: str, name: Optional[str] = None):
    """Native Bristol parse -> Netlist, or None if the library is missing."""
    from .netlist import Netlist

    lib = _load()
    if lib is None:
        return None
    h = lib.oece_parse_bristol(path.encode())
    try:
        err = lib.oece_parse_error(h)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        G = lib.oece_parse_n_gates(h)
        n_wires = lib.oece_parse_n_wires(h)
        in_bits = np.zeros(lib.oece_parse_n_inputs(h), dtype=np.int32)
        out_bits = np.zeros(lib.oece_parse_n_outputs(h), dtype=np.int32)
        lib.oece_parse_io_bits(h, _ptr(in_bits), _ptr(out_bits))
        op, in0, in1, out = (np.empty(G, dtype=np.int32) for _ in range(4))
        lib.oece_parse_gates(h, *(_ptr(a) for a in (op, in0, in1, out)))
    finally:
        lib.oece_parse_free(h)

    inputs: List[np.ndarray] = []
    off = 0
    for b in in_bits:
        inputs.append(np.arange(off, off + int(b), dtype=np.int32))
        off += int(b)
    outputs: List[np.ndarray] = []
    off = int(n_wires) - int(out_bits.sum())
    for b in out_bits:
        outputs.append(np.arange(off, off + int(b), dtype=np.int32))
        off += int(b)
    return Netlist(
        name=name or os.path.splitext(os.path.basename(path))[0], n_wires=int(n_wires),
        inputs=inputs, outputs=outputs, op=op, in0=in0, in1=in1, out=out,
    )


def levelize_native(nl) -> Optional[tuple]:
    """Native ASAP levelization -> (glevel, grank) int64 arrays, or None."""
    lib = _load()
    if lib is None:
        return None
    G = nl.n_gates
    glevel = np.empty(G, dtype=np.int64)
    grank = np.empty(G, dtype=np.int64)
    arrs = [np.ascontiguousarray(a, dtype=np.int32) for a in (nl.op, nl.in0, nl.in1, nl.out)]
    lib.oece_levelize(*(_ptr(a) for a in arrs), G, nl.n_wires, _ptr(glevel), _ptr(grank))
    return glevel, grank
