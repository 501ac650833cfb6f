"""Build the CUDA kernels of `csrc/` with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` exports a plain C entry point and becomes
`build/kernels/lib<name>.so` at the root of the checkout, compiled for
Hopper (`sm_90a`) at first use and again whenever the source is newer
than the library.  Nothing here includes PyTorch's headers, so a build
takes seconds.  The wrappers pass every pointer and the stream as
`c_void_p`; each entry point returns `cudaGetLastError()`.

A machine with a card but without nvcc is an error: there is no
prebuilt kernel and no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
KERNELS = ("local_sw", "tb_walk", "global_sw", "semiglobal_sw", "local_start",
           "semiglobal_start", "ksw_extend", "banded_sw")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from csrc/ at first use "
        "and need the CUDA toolkit (put nvcc on PATH or set CUDA_HOME)")


def _start(name: str):
    """Start nvcc on csrc/<name>.cu unless the library is newer than the
    source; returns (process, temporary output) or None."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}-", suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
    except BaseException:
        os.unlink(tmp)
        raise
    return proc, tmp


def _finish(name: str, job) -> Path:
    """Wait for a build from _start and move its library into place.
    The ptxas report (registers, spills) goes to build/kernels/<name>.log."""
    out = BUILD_DIR / f"lib{name}.so"
    if job is None:
        return out
    proc, tmp = job
    try:
        _, stderr = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{stderr}")
        (BUILD_DIR / f"{name}.log").write_text(stderr)
        os.replace(tmp, out)  # atomic: no process loads half a library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(names=KERNELS) -> list[Path]:
    """Compile every stale kernel of `names`: one nvcc per source, all
    started together.  Waits for every nvcc it started, failed or not."""
    jobs = []
    try:
        for name in names:
            jobs.append((name, _start(name)))
    except BaseException:
        for _, job in jobs:
            if job is not None:
                job[0].kill()
                job[0].wait()
                os.unlink(job[1])
        raise
    results, error = [], None
    for name, job in jobs:
        try:
            results.append(_finish(name, job))
        except RuntimeError as exc:
            error = error or exc
    if error is not None:
        raise error
    return results


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library is newer than it."""
    return build_all((name,))[0]


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    return ctypes.CDLL(str(build(name)))
