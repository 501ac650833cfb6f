"""BAM output/input — BGZF-compressed binary alignments (reference:
nvbio/io/output writes SAM *and* BAM for nvBowtie; nvbio/io/sequence
reads BAM inputs).  Self-contained: BGZF framing via zlib raw deflate,
BAM v1 record encoding per the SAM/BAM spec.

Writer covers the mapper's single- and paired-end records; the reader
parses everything the writer emits (and standard BAM from other tools,
minus optional-tag decoding) — used both by tests and by aln-diff.

The port's copy of `genomics_tpu/utils/bamio.py`: the same bytes for
the same records.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Iterable

from genomics_tpu_torch.utils import samio

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
# 4-bit SEQ code per the spec: "=ACMGRSVTWYHKDBN"
_SEQ_CODE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_SEQ_CHAR = "=ACMGRSVTWYHKDBN"
_CIGAR_OPS = "MIDNSHP=X"
_CIGAR_CODE = {c: i for i, c in enumerate(_CIGAR_OPS)}


def _bgzf_block(data: bytes) -> bytes:
    """One BGZF block: gzip member with the BC extra subfield (BSIZE)."""
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    payload = comp.compress(data) + comp.flush()
    bsize = len(payload) + 25  # BSIZE = header(18) + payload + crc(4) + isize(4) - 1
    header = struct.pack(
        "<4BI2BH2B2H",
        0x1F, 0x8B, 8, 4,    # magic, CM=deflate, FLG.FEXTRA
        0, 0, 0xFF,          # MTIME, XFL, OS
        6,                   # XLEN
        0x42, 0x43,          # 'B', 'C'
        2, bsize,            # SLEN=2, BSIZE
    )
    return header + payload + struct.pack(
        "<II", zlib.crc32(data) & 0xFFFFFFFF, len(data) & 0xFFFFFFFF
    )


def bgzf_compress(data: bytes, block: int = 0xFF00) -> bytes:
    out = bytearray()
    for i in range(0, len(data), block):
        out += _bgzf_block(data[i : i + block])
    out += _BGZF_EOF
    return bytes(out)


def bgzf_decompress(data: bytes) -> bytes:
    out, off = bytearray(), 0
    while off < len(data):
        if data[off : off + 2] != b"\x1f\x8b":
            raise ValueError(f"bad BGZF magic at {off}")
        xlen = struct.unpack_from("<H", data, off + 10)[0]
        extra = data[off + 12 : off + 12 + xlen]
        bsize = None
        e = 0
        while e + 4 <= len(extra):
            si1, si2, slen = extra[e], extra[e + 1], struct.unpack_from("<H", extra, e + 2)[0]
            if si1 == 0x42 and si2 == 0x43:
                bsize = struct.unpack_from("<H", extra, e + 4)[0] + 1
            e += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block missing BC subfield")
        payload = data[off + 12 + xlen : off + bsize - 8]
        out += zlib.decompress(payload, -15)
        off += bsize
    return bytes(out)


def _reg2bin(beg: int, end: int) -> int:
    """BAM bin number (SAM spec 4.2.1)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _parse_cigar(cig: str) -> list[tuple[int, int]]:
    ops, num = [], 0
    for ch in cig:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            ops.append((num, _CIGAR_CODE[ch]))
            num = 0
    return ops


def _encode_record(
    name: str, seq: str, m, flag: int,
    next_pos: int = -1, tlen: int = 0, qual: bytes | None = None,
    ref_id: int = 0,
) -> bytes:
    """One BAM alignment record (-1 refID if unmapped)."""
    mapped = m.pos >= 0
    ref_id = ref_id if mapped else -1
    pos = m.pos - 1 if mapped else -1
    seq_out = samio._sam_seq(seq, m)
    cig = samio._sam_cigar(m, len(seq)) if mapped else "*"
    cigar_ops = _parse_cigar(cig) if cig != "*" else []
    ref_span = sum(n for n, op in cigar_ops if op in (0, 2, 3, 7, 8))
    bam_bin = _reg2bin(pos, pos + max(ref_span, 1)) if mapped else 4680
    name_b = name.encode() + b"\0"
    packed = bytearray((len(seq_out) + 1) // 2)
    for i, c in enumerate(seq_out.upper()):
        code = _SEQ_CODE.get(c, 15)
        packed[i // 2] |= code << (4 if i % 2 == 0 else 0)
    q = qual if qual is not None else b"\xff" * len(seq_out)
    body = struct.pack(
        "<iiBBHHHiiii",
        ref_id, pos,
        len(name_b), getattr(m, "mapq", 0) if mapped else 0, bam_bin,
        len(cigar_ops), flag, len(seq_out),
        (ref_id if next_pos >= 0 else -1), (next_pos if next_pos >= 0 else -1),
        tlen,
    )
    body += name_b
    for n, op in cigar_ops:
        body += struct.pack("<I", (n << 4) | op)
    body += bytes(packed) + q
    return struct.pack("<i", len(body)) + body


def _ref_table(ref_name, ref_len):
    """(contigs list, name→id dict) — ref_name may be a single name or a
    list of (name, length) pairs (multi-contig references)."""
    if isinstance(ref_name, str):
        contigs = [(ref_name, ref_len)]
    else:
        contigs = list(ref_name)
    return contigs, {n: i for i, (n, _) in enumerate(contigs)}


def _header_blob(contigs) -> bytes:
    text = samio.sam_header(contigs).encode()
    data = bytearray()
    data += b"BAM\x01" + struct.pack("<i", len(text)) + text
    data += struct.pack("<i", len(contigs))
    for n, l in contigs:
        nm = n.encode() + b"\0"
        data += struct.pack("<i", len(nm)) + nm + struct.pack("<i", l)
    return bytes(data)


def _rid(m, ids) -> int:
    c = getattr(m, "contig", None)
    return ids.get(c, 0) if c else 0


def write_bam(
    path: str, ref_name, ref_len: int = 0,
    records: Iterable = (),  # (name, seq, Mapping)  single-end
) -> None:
    contigs, ids = _ref_table(ref_name, ref_len)
    data = bytearray(_header_blob(contigs))
    for name, seq, m in records:
        flag = (samio.FLAG_REVERSE if (m.pos >= 0 and m.reverse) else 0) | (
            samio.FLAG_UNMAPPED if m.pos < 0 else 0
        )
        data += _encode_record(name, seq, m, flag, ref_id=_rid(m, ids))
    with open(path, "wb") as fh:
        fh.write(bgzf_compress(bytes(data)))


def write_bam_pairs(
    path: str, ref_name, ref_len: int = 0,
    records: Iterable = (),  # (name, seq1, m1, seq2, m2)
) -> None:
    contigs, ids = _ref_table(ref_name, ref_len)
    data = bytearray(_header_blob(contigs))
    for name, seq1, m1, seq2, m2 in records:
        f1, _, pn1, tl1 = samio._pair_fields(m1, m2, ref_name)
        f2, _, pn2, tl2 = samio._pair_fields(m2, m1, ref_name)
        f1 |= samio.FLAG_FIRST | (
            samio.FLAG_UNMAPPED if m1.pos < 0 else
            (samio.FLAG_REVERSE if m1.reverse else 0))
        f2 |= samio.FLAG_SECOND | (
            samio.FLAG_UNMAPPED if m2.pos < 0 else
            (samio.FLAG_REVERSE if m2.reverse else 0))
        data += _encode_record(name, seq1, m1, f1, pn1 - 1, tl1,
                               ref_id=_rid(m1, ids))
        data += _encode_record(name, seq2, m2, f2, pn2 - 1, tl2,
                               ref_id=_rid(m2, ids))
    with open(path, "wb") as fh:
        fh.write(bgzf_compress(bytes(data)))


@dataclasses.dataclass
class BamRecord:
    name: str
    flag: int
    ref_id: int
    pos: int          # 0-based (-1 unmapped)
    mapq: int
    cigar: str
    next_pos: int
    tlen: int
    seq: str


def read_bam(path: str) -> tuple[str, list[tuple[str, int]], list[BamRecord]]:
    """→ (header_text, [(ref_name, ref_len)], records)."""
    with open(path, "rb") as fh:
        data = bgzf_decompress(fh.read())
    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM file")
    off = 4
    l_text = struct.unpack_from("<i", data, off)[0]; off += 4
    text = data[off : off + l_text].decode(); off += l_text
    n_ref = struct.unpack_from("<i", data, off)[0]; off += 4
    refs = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]; off += 4
        nm = data[off : off + l_name - 1].decode(); off += l_name
        l_ref = struct.unpack_from("<i", data, off)[0]; off += 4
        refs.append((nm, l_ref))
    recs = []
    while off < len(data):
        block = struct.unpack_from("<i", data, off)[0]; off += 4
        (ref_id, pos, l_name, mapq, _bin, n_cig, flag, l_seq,
         _nref, npos, tlen) = struct.unpack_from("<iiBBHHHiiii", data, off)
        p = off + 32
        name = data[p : p + l_name - 1].decode(); p += l_name
        cig = []
        for _ in range(n_cig):
            v = struct.unpack_from("<I", data, p)[0]; p += 4
            cig.append(f"{v >> 4}{_CIGAR_OPS[v & 0xF]}")
        seq_chars = []
        for i in range(l_seq):
            b = data[p + i // 2]
            seq_chars.append(_SEQ_CHAR[(b >> 4) if i % 2 == 0 else (b & 0xF)])
        recs.append(BamRecord(
            name, flag, ref_id, pos, mapq, "".join(cig) or "*",
            npos, tlen, "".join(seq_chars),
        ))
        off += block
    return text, refs, recs
