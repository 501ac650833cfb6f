"""ctypes loader for the repository's native C++ library (`native/`): the
port's counterpart of `genomics_tpu/runtime/native.py`, for what the port
runs on the host: linear-time suffix arrays (SA-IS) and BWTs.

The library is built from `native/sais.cpp` alone, the one source that
holds what the port binds, with `native/Makefile`'s flags but
`-fopenmp` and `-march=native`, into
`build/native/libgenomics_native.so` at the root of the checkout, at
first use and again whenever the source is newer than it.  `native/` is
only read.  SA-IS and the BWT are serial code, so OpenMP buys them
nothing (and the CUDA machine's g++ has no libgomp); built for the
compiler's default target, not the building CPU's, a library made on one
machine of an architecture loads on any other.
Each build compiles to a temporary file in the build directory and moves
it into place (`os.replace`), so processes that build at once never load
half a library.  A failed build raises: there is no fallback to another
suffix sorter (the JAX loader returns None and its callers fall back to
prefix doubling).  The CIGAR decoder is not bound: the port's walk writes
CIGARs on the card (`ops/tb_walk.py`).
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
NATIVE_DIR = ROOT / "native"
BUILD_DIR = ROOT / "build" / "native"
SOURCES = ("sais.cpp",)
# native/Makefile's CXXFLAGS but -fopenmp and -march=native (see above),
# and its link step
CXX_FLAGS = ("-O3", "-fPIC", "-Wall", "-shared")
LIB_NAME = "libgenomics_native.so"
# texts longer than this take the int64 SA-IS (the int32 path needs
# n + 1 < 2^31; the margin keeps the recursion's names safe too)
SAIS32_MAX = (1 << 31) - 16

_u8, _i32, _i64 = (ctypes.POINTER(t) for t in
                   (ctypes.c_uint8, ctypes.c_int32, ctypes.c_int64))
_BINDINGS = {
    "gt_sais_u8": (_u8, ctypes.c_int32, _i32),
    "gt_sais_u8_64": (_u8, ctypes.c_int64, _i64),
    "gt_bwt_from_sa": (_u8, ctypes.c_int32, _i32, _u8),
    "gt_bwt_from_sa_64": (_u8, ctypes.c_int64, _i64, _u8),
}


def build() -> Path:
    """Compile the library unless it is newer than its sources; returns
    its path.  Raises RuntimeError when the compiler fails."""
    out = BUILD_DIR / LIB_NAME
    srcs = [NATIVE_DIR / f for f in SOURCES]
    newest = max(s.stat().st_mtime for s in srcs)
    if out.exists() and out.stat().st_mtime >= newest:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".native-", suffix=".so")
    os.close(fd)
    try:
        cxx = os.environ.get("CXX", "g++")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *map(str, srcs)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise RuntimeError(f"building {LIB_NAME} failed:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: no process loads half a library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded library, built first if needed, its entry points bound."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _BINDINGS.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def sais_u8(text: np.ndarray, force64: bool = False) -> np.ndarray:
    """Suffix array of a uint8 text with an appended sentinel smaller than
    every symbol (native/sais.cpp): n + 1 entries, the sentinel's first;
    int32 below ~2.1 G symbols, int64 above or with `force64`."""
    lib = library()
    text = np.ascontiguousarray(text, np.uint8)
    n = len(text)
    if force64 or n >= SAIS32_MAX:
        sa = np.empty(n + 1, np.int64)
        rc = lib.gt_sais_u8_64(_ptr(text, ctypes.c_uint8), n,
                               _ptr(sa, ctypes.c_int64))
    else:
        sa = np.empty(n + 1, np.int32)
        rc = lib.gt_sais_u8(_ptr(text, ctypes.c_uint8), n,
                            _ptr(sa, ctypes.c_int32))
    if rc:
        raise RuntimeError(f"SA-IS failed on a text of {n} symbols ({rc})")
    return sa


def bwt_from_sa(text: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """BWT bytes of text from its (n + 1)-entry SA, int32 or int64: 0xFF
    where the suffix starts the text, else the symbol before it."""
    lib = library()
    text = np.ascontiguousarray(text, np.uint8)
    n = len(text)
    out = np.empty(n + 1, np.uint8)
    if sa.dtype == np.int64:
        sa = np.ascontiguousarray(sa)
        lib.gt_bwt_from_sa_64(_ptr(text, ctypes.c_uint8), n,
                              _ptr(sa, ctypes.c_int64),
                              _ptr(out, ctypes.c_uint8))
    else:
        sa = np.ascontiguousarray(sa, np.int32)
        lib.gt_bwt_from_sa(_ptr(text, ctypes.c_uint8), n,
                           _ptr(sa, ctypes.c_int32),
                           _ptr(out, ctypes.c_uint8))
    return out
