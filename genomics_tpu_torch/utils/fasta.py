"""FASTA / FASTQ IO and the GASAL2 test_prog header-op convention.

The port's copy of `genomics_tpu/utils/fasta.py` (which imports no JAX;
the port keeps its own copy all the same).  test_prog encodes a
per-sequence op in the header's first character
(CDP/GASAL2/test_prog/test_prog.cpp:79-111):
  '>' forward natural (0), '<' reverse natural (1),
  '/' forward complement (2), '+' reverse complement (3).
"""
from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np


class FastaRecord(NamedTuple):
    name: str
    seq: str
    op: str = ">"   # one of > < / +


def read_fasta(path: str, with_ops: bool = False) -> list[FastaRecord]:
    """Records of a FASTA file; a header may start with any of the four op
    characters, and with `with_ops` the record keeps it as its op."""
    records: list[FastaRecord] = []
    name, op, chunks = None, ">", []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line[0] in "></+":
                if name is not None:
                    records.append(FastaRecord(name, "".join(chunks), op))
                op = line[0] if with_ops else ">"
                name = line[1:].strip()
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        records.append(FastaRecord(name, "".join(chunks), op))
    return records


def write_fasta(path: str, records: Iterable, width: int = 0) -> None:
    """Write (name, seq) records with '>' headers, wrapped at `width`
    columns when it is not 0."""
    with open(path, "w") as fh:
        for r in records:
            name = getattr(r, "name", None) or r[0]
            seq = getattr(r, "seq", None) or r[1]
            fh.write(f">{name}\n")
            if width:
                for i in range(0, len(seq), width):
                    fh.write(seq[i : i + width] + "\n")
            else:
                fh.write(seq + "\n")


class FastqRecord(NamedTuple):
    name: str
    seq: str
    quals: str


def read_fastq(path: str) -> list[FastqRecord]:
    """Records of a FASTQ file (four lines each)."""
    out: list[FastqRecord] = []
    with open(path) as fh:
        while True:
            h = fh.readline()
            if not h:
                break
            h = h.strip()
            if not h:
                continue
            if not h.startswith("@"):
                raise ValueError(f"bad FASTQ header: {h[:20]}")
            seq = fh.readline().strip()
            fh.readline()
            quals = fh.readline().strip()
            out.append(FastqRecord(h[1:], seq, quals))
    return out


def quals_to_phred(quals: str, offset: int = 33) -> np.ndarray:
    return np.frombuffer(quals.encode(), dtype=np.uint8).astype(np.int32) - offset
