"""SAM output (reference: nvbio/io output writes SAM/BAM for nvBowtie).
Single-end records with position/mapq/CIGAR, and paired-end records
with the full flag set (paired, proper pair, strands, first/second in
pair), RNEXT/PNEXT/TLEN.

The port's copy of `genomics_tpu/utils/samio.py`: the same bytes, the
@PG line's `genomics_tpu` included (the name of the file format's
writer, so that files of both packages are equal).
"""
from __future__ import annotations

from typing import Iterable

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST = 0x40
FLAG_SECOND = 0x80

_RC = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")


def _sam_seq(seq: str, m) -> str:
    """SEQ column stores the read as aligned (reverse-complemented for
    reverse-strand mappings)."""
    if m.pos >= 0 and getattr(m, "reverse", False):
        return seq.translate(_RC)[::-1]
    return seq


def _sam_cigar(m, seq_len: int) -> str:
    if m.pos < 0:
        return "*"
    cig = m.cigar_string or f"{seq_len}M"
    # SAM M covers both = and X; our byte-CIGAR X maps to M, then
    # adjacent same-op runs merge (2M1X1M → 4M)
    out, num, last_op, last_n = [], 0, "", 0
    for ch in cig:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            op = "M" if ch in "X=" else ch
            if op == last_op:
                last_n += num
            else:
                if last_op:
                    out.append(f"{last_n}{last_op}")
                last_op, last_n = op, num
            num = 0
    if last_op:
        out.append(f"{last_n}{last_op}")
    return "".join(out)


def sam_record(
    name: str, seq: str, m, ref_name: str, flag_extra: int = 0,
    rnext: str = "*", pnext: int = 0, tlen: int = 0,
) -> str:
    if m.pos < 0:
        flag = FLAG_UNMAPPED | flag_extra
        return f"{name}\t{flag}\t*\t0\t0\t*\t{rnext}\t{pnext}\t{tlen}\t{seq}\t*"
    flag = flag_extra | (FLAG_REVERSE if m.reverse else 0)
    # multi-contig mappers stamp the owning contig on the Mapping
    rname = getattr(m, "contig", None) or ref_name
    return (
        f"{name}\t{flag}\t{rname}\t{m.pos}\t{m.mapq}\t{_sam_cigar(m, len(seq))}"
        f"\t{rnext}\t{pnext}\t{tlen}\t{_sam_seq(seq, m)}\t*"
    )


def sam_header(ref_name, ref_len: int = 0) -> str:
    """ref_name: a single name (with ref_len), or a list of
    (name, length) pairs for multi-contig references."""
    if isinstance(ref_name, str):
        contigs = [(ref_name, ref_len)]
    else:
        contigs = list(ref_name)
    sq = "".join(f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in contigs)
    return (
        "@HD\tVN:1.6\tSO:unsorted\n"
        + sq
        + "@PG\tID:genomics_tpu\tPN:genomics_tpu\n"
    )


def write_sam(
    path: str,
    ref_name: str,
    ref_len: int,
    records: Iterable,      # (read_name, seq, Mapping)
) -> None:
    with open(path, "w") as fh:
        fh.write(sam_header(ref_name, ref_len))
        for name, seq, m in records:
            fh.write(sam_record(name, seq, m, ref_name) + "\n")


def _pair_fields(m, mate, ref_name: str):
    """(flag_bits, rnext, pnext, tlen) for one mate given the other."""
    flag = FLAG_PAIRED
    if m.pos >= 0 and mate.pos >= 0 and m.proper_pair and mate.proper_pair:
        flag |= FLAG_PROPER
    if mate.pos < 0:
        flag |= FLAG_MATE_UNMAPPED
        return flag, "*", 0, 0
    if mate.reverse:
        flag |= FLAG_MATE_REVERSE
    rnext = "=" if m.pos >= 0 else ref_name
    tlen = 0
    if m.pos >= 0:
        left = min(m.pos, mate.pos)
        right = max(m.pos + m.ref_span, mate.pos + mate.ref_span)
        tlen = right - left
        if m.pos > mate.pos or (m.pos == mate.pos and m.reverse):
            tlen = -tlen
    return flag, rnext, mate.pos if mate.pos >= 0 else 0, tlen


def write_sam_pairs(
    path: str,
    ref_name: str,
    ref_len: int,
    records: Iterable,      # (read_name, seq1, m1, seq2, m2)
) -> None:
    with open(path, "w") as fh:
        fh.write(sam_header(ref_name, ref_len))
        for name, seq1, m1, seq2, m2 in records:
            f1, rn1, pn1, tl1 = _pair_fields(m1, m2, ref_name)
            f2, rn2, pn2, tl2 = _pair_fields(m2, m1, ref_name)
            fh.write(sam_record(name, seq1, m1, ref_name,
                                f1 | FLAG_FIRST, rn1, pn1, tl1) + "\n")
            fh.write(sam_record(name, seq2, m2, ref_name,
                                f2 | FLAG_SECOND, rn2, pn2, tl2) + "\n")
