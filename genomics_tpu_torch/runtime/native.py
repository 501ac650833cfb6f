"""ctypes loader for the repository's native C++ library (`native/`): the
port's counterpart of `genomics_tpu/runtime/native.py`, for what the port
runs on the host: linear-time suffix arrays (SA-IS), BWTs and Lighter's
pass-3 correction walk.

The library is built from `native/sais.cpp` and `native/lighter.cpp`, the
sources that hold what the port binds, with `native/Makefile`'s flags but
`-fopenmp` and `-march=native`, into
`build/native/libgenomics_native.so` at the root of the checkout, at
first use and again whenever a source, or this loader (which names the
sources and the flags), is newer than it.  `native/` is
only read.  SA-IS and the BWT are serial code, and the CUDA machine's g++
has no libgomp, so lighter.cpp's `#pragma omp` loop is ignored and its
walk runs on one core; built for the compiler's default target, not the
building CPU's, a library made on one machine of an architecture loads on
any other.
Each build compiles to a temporary file in the build directory and moves
it into place (`os.replace`), so processes that build at once never load
half a library.  A failed build or load raises: there is no fallback to another
suffix sorter or to the Python correction walk (the JAX loader returns
None and its callers fall back to prefix doubling and to the Python
walk).  The CIGAR decoder is not bound: the port's walk writes
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
SOURCES = ("sais.cpp", "lighter.cpp")
# native/Makefile's CXXFLAGS but -fopenmp and -march=native (see above),
# and its link step
CXX_FLAGS = ("-O3", "-fPIC", "-Wall", "-shared")
LIB_NAME = "libgenomics_native.so"
# texts longer than this take the int64 SA-IS (the int32 path needs
# n + 1 < 2^31; the margin keeps the recursion's names safe too)
SAIS32_MAX = (1 << 31) - 16

# the longest read lighter.cpp's per-read stack buffers hold
LIGHTER_MAX_LEN = 4096

_u8, _i32, _i64, _u32 = (ctypes.POINTER(t) for t in
                         (ctypes.c_uint8, ctypes.c_int32, ctypes.c_int64,
                          ctypes.c_uint32))
_ci = ctypes.c_int
_BINDINGS = {
    "gt_sais_u8": (_u8, ctypes.c_int32, _i32),
    "gt_sais_u8_64": (_u8, ctypes.c_int64, _i64),
    "gt_bwt_from_sa": (_u8, ctypes.c_int32, _i32, _u8),
    "gt_bwt_from_sa_64": (_u8, ctypes.c_int64, _i64, _u8),
    # codes [N, L], lens, N, L, quals or NULL, bloom words, n_bits,
    # bloom_k, K, max_correction, bad_quality, out codes, out corrections
    "gt_lighter_pass3": (_u8, _i32, _ci, _ci, ctypes.c_void_p, _u32,
                         ctypes.c_uint64, _ci, _ci, ctypes.c_double, _ci,
                         _u8, _i32),
}


def build() -> Path:
    """Compile the library unless it is newer than its sources; returns
    its path.  Raises RuntimeError when the compiler fails."""
    out = BUILD_DIR / LIB_NAME
    srcs = [NATIVE_DIR / f for f in SOURCES]
    newest = max(p.stat().st_mtime for p in [*srcs, Path(__file__)])
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


def lighter_pass3(codes: np.ndarray, lens: np.ndarray,
                  bloom_words: np.ndarray, n_bits: int, bloom_k: int,
                  K: int, max_correction: float, bad_quality: int,
                  quals: np.ndarray | None = None):
    """Lighter's pass-3 walk over a batch (native/lighter.cpp, one read
    after another here).  codes [N, L] 2-bit with 4 = N, L at most
    LIGHTER_MAX_LEN; quals [N, L] uint8 or None (all 40).  Returns
    (out_codes [N, L] uint8, n_corrections [N] int32, -1 for an
    unreliable read left as it was)."""
    lib = library()
    codes = np.ascontiguousarray(codes, np.uint8)
    n, L = codes.shape
    if L > LIGHTER_MAX_LEN:
        raise ValueError(f"lighter_pass3 holds reads of up to "
                         f"{LIGHTER_MAX_LEN} bases; got {L}")
    lens = np.ascontiguousarray(lens, np.int32)
    bloom_words = np.ascontiguousarray(bloom_words, np.uint32)
    out = np.empty_like(codes)
    ncorr = np.empty(n, np.int32)
    qp = None
    if quals is not None:
        quals = np.ascontiguousarray(quals, np.uint8)
        qp = quals.ctypes.data_as(ctypes.c_void_p)
    rc = lib.gt_lighter_pass3(
        _ptr(codes, ctypes.c_uint8), _ptr(lens, ctypes.c_int32), n, L, qp,
        _ptr(bloom_words, ctypes.c_uint32), n_bits, bloom_k, K,
        max_correction, bad_quality, _ptr(out, ctypes.c_uint8),
        _ptr(ncorr, ctypes.c_int32))
    if rc:
        raise RuntimeError(f"lighter_pass3 failed on {n} reads ({rc})")
    return out, ncorr
