#!/usr/bin/env python3
"""What nvcc made of the DP kernels: ptxas's resource lines and the SASS
of every loop, counted per cell.

    python3 tools/sass_report.py [--out DIR] [--src CSRC] [KERNEL ...]

Builds `csrc/<KERNEL>.cu` (default: global_sw, semiglobal_sw, local_sw,
ksw_extend, semiglobal_start, local_start, banded_sw) with the port's
own nvcc flags, one nvcc per source, all started together, into DIR (default
chiprun_out/sass), disassembles each library with cuobjdump and, for
every kernel function, prints its ptxas line (registers, stack frame,
spills, shared memory) and every loop (a backward branch to a label):
its instructions, its global and shared loads and stores, and the
mnemonics it issues most.  The full SASS goes to DIR/<KERNEL>.sass.
With --src, the sources are taken from another checkout's csrc/ (a
parent commit unpacked beside this one), so two versions compare in
one run.  Needs nvcc and cuobjdump (the CUDA toolkit); runs no kernel.
"""
from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from genomics_tpu_torch import _build  # noqa: E402

INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
TARGET = re.compile(r"BRA\s+(0x[0-9a-f]+)")


def mnemonic(text: str) -> str:
    """The opcode of a SASS instruction, without predicate or modifiers."""
    tok = text.split()
    if tok and tok[0].startswith("@"):
        tok = tok[1:]
    return tok[0].split(".")[0] if tok else ""


def functions(sass: str):
    """{function name: [(offset, text)]} of a cuobjdump listing, in
    order."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None and (m := INSN.search(line)):
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def loops(body):
    """Each backward branch as (target offset, the instructions from the
    target to the branch, inclusive); a branch to itself (the trap at a
    function's end) is no loop."""
    out = []
    for at, text in body:
        m = TARGET.search(text) if mnemonic(text) == "BRA" else None
        if m and int(m.group(1), 16) < at:
            lo = int(m.group(1), 16)
            out.append((hex(lo), [t for o, t in body if lo <= o <= at]))
    return out


def describe(insns) -> str:
    ops = collections.Counter(mnemonic(t) for t in insns)
    mem = {k: sum(v for o, v in ops.items() if o.startswith(k))
           for k in ("LDG", "STG", "LDS", "STS", "LDL", "STL")}
    top = ", ".join(f"{o} {n}" for o, n in ops.most_common(12))
    return (f"{len(insns)} instructions; " + " ".join(
        f"{k} {v}" for k, v in mem.items() if v) + f"; {top}")


def kernel_of(mangled: str) -> str:
    """`name<template arguments>` of a mangled kernel symbol."""
    for m in re.finditer(r"\d+", mangled):
        rest = mangled[m.end():]
        for k in range(m.start(), m.end()):
            n = int(mangled[k:m.end()])
            if rest[:n].endswith("_kernel") and rest[n:n + 1] == "I":
                targs = rest[n + 1:].split("EEv")[0] + "E"
                args = re.findall(r"L[ib](-?\d+)E", targs)
                return f"{rest[:n]}<{','.join(args)}>"
    return mangled


def ptxas_lines(log: str) -> dict:
    """{mangled function: its stack frame, spills and registers} from
    ptxas -v output (build/kernels/<name>.log)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = ""
        elif cur and ("stack frame" in line or "Used " in line):
            out[cur] += line.split("ptxas info    :")[-1].strip() + "; "
    return {fn: text.rstrip("; ") for fn, text in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernels", nargs="*",
                    default=["global_sw", "semiglobal_sw", "local_sw",
                             "ksw_extend", "semiglobal_start", "local_start",
                             "banded_sw"])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "sass"))
    ap.add_argument("--src", default=str(_build.CSRC))
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    builds = {name: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
         str(Path(args.src) / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name in args.kernels}
    for name, proc in builds.items():
        lib = out / f"lib{name}.so"
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        res = ptxas_lines(err)
        sass = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        (out / f"{name}.sass").write_text(sass)
        for fn, body in functions(sass).items():
            print(f"{name} {kernel_of(fn)}: {res.get(fn, '')}; "
                  f"{len(body)} instructions")
            for start, insns in loops(body):
                print(f"  loop from {start}: {describe(insns)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
