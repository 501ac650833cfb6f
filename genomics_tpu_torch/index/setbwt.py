"""String-set BWT + FM-index over a read SET (reference:
CDP/NvB/nvSetBWT — BWT construction over a collection of strings — and
nvFM-server's persistent query serving).

The set is encoded as the concatenation read_0 # read_1 # ... # with a
per-read terminator symbol; the suffix array comes from the native
linear-time SA-IS (native/sais.cpp), and the BWT's rank structure is
the WaveletTree (index/wavelet.py — nvbio's own sigma>4 rank structure,
strings/wavelet_tree.h), which handles the 6-symbol alphabet
{sentinel, terminator, A, C, G, T} that the 2-bit-plane FM-index
cannot.

Terminator convention: all terminators share one symbol, so suffixes
beginning at a terminator sort by the FOLLOWING read's text (the
concatenation convention BWA uses), not by read index; patterns made of
ACGT can never match across a read boundary because the terminator
symbol is not in the pattern alphabet, so count/locate semantics over
the set are exact.

The port's copy of `genomics_tpu/index/setbwt.py` (host numpy).  Its
suffix array comes from `runtime/native.py`, which raises if it cannot
build the library (the JAX class falls back to a Python sort).
"""
from __future__ import annotations

import numpy as np

from genomics_tpu_torch.index.qgram import encode2
from genomics_tpu_torch.index.wavelet import WaveletTree
from genomics_tpu_torch.runtime import native

# symbol codes: 0 = SA-IS sentinel (implicit), 1 = read terminator '#'
TERM = 1
_CODE = np.full(256, 0, np.uint8)
for _i, _c in enumerate("ACGT"):
    _CODE[ord(_c)] = 2 + _i
    _CODE[ord(_c.lower())] = 2 + _i
SIGMA = 6


class SetFMIndex:
    """FM-index over a read set's concatenated text (multi-string BWT).

    count/locate return per-read hits: locate gives (read_id, offset)
    pairs.  Rank is wavelet-tree backed (O(log sigma) per symbol)."""

    def __init__(self, reads: list[str] | None = None, *, _state=None):
        if _state is not None:
            (self.text, self.offsets, self.bwt, self.sa, self.C) = _state
            self.n = len(self.bwt)
            self.wt = WaveletTree(self.bwt, bits=3)
            return
        assert reads is not None
        codes = []
        offs = [0]
        for r in reads:
            c = _CODE[np.frombuffer(r.encode() if isinstance(r, str) else r,
                                    np.uint8)]
            if (c == 0).any():
                raise ValueError("reads must be ACGT-only for the set BWT")
            codes.append(c)
            codes.append(np.array([TERM], np.uint8))
            offs.append(offs[-1] + len(c) + 1)
        text = (np.concatenate(codes) if codes
                else np.zeros(0, np.uint8))
        self.text = text
        self.offsets = np.array(offs, np.int64)

        self.sa = native.sais_u8(text).astype(np.int64)
        n1 = len(self.sa)
        bwt = np.where(self.sa == 0, 0,
                       text[np.maximum(self.sa - 1, 0)]).astype(np.uint8)
        self.bwt = bwt
        self.n = n1
        counts = np.bincount(bwt, minlength=SIGMA)
        self.C = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.wt = WaveletTree(bwt, bits=3)

    @property
    def n_reads(self) -> int:
        return len(self.offsets) - 1

    def _occ(self, sym: int, i: int) -> int:
        return self.wt.rank(sym, i)

    def backward_search(self, pattern: str | bytes):
        """SA range of `pattern` over the set → (lo, hi)."""
        if isinstance(pattern, str):
            pattern = pattern.encode()
        pat = _CODE[np.frombuffer(pattern, np.uint8)]
        if (pat == 0).any():
            return (0, 0)
        lo, hi = 0, self.n
        for sym in pat[::-1]:
            s = int(sym)
            lo = int(self.C[s]) + self._occ(s, lo)
            hi = int(self.C[s]) + self._occ(s, hi)
            if hi <= lo:
                return (0, 0)
        return (lo, hi)

    def count(self, pattern) -> int:
        lo, hi = self.backward_search(pattern)
        return hi - lo

    def locate(self, pattern, limit: int = 64):
        """[(read_id, offset_in_read)] for up to `limit` matches."""
        lo, hi = self.backward_search(pattern)
        out = []
        for r in range(lo, min(hi, lo + limit)):
            p = int(self.sa[r])
            ri = int(np.searchsorted(self.offsets, p, "right")) - 1
            out.append((ri, p - int(self.offsets[ri])))
        return sorted(out)

    # -- persistence (the nvSetBWT output artifact) -----------------------

    def save(self, path: str) -> None:
        np.savez_compressed(
            path if path.endswith(".npz") else path + ".npz",
            kind="setbwt", text=self.text, offsets=self.offsets,
            bwt=self.bwt, sa=self.sa, C=self.C)

    @classmethod
    def load(cls, path: str) -> "SetFMIndex":
        z = np.load(path if path.endswith(".npz") else path + ".npz",
                    allow_pickle=False)
        return cls(_state=(z["text"], z["offsets"], z["bwt"], z["sa"],
                           z["C"]))


def load_any_index(path: str):
    """Load a saved index of either kind with ONE npz read: a SetFMIndex
    ('kind' == 'setbwt') or a plain FMIndex (nvBWT/nvSSA artifact)."""
    p = path if path.endswith(".npz") else path + ".npz"
    z = np.load(p, allow_pickle=False)
    if "kind" in z and str(z["kind"]) == "setbwt":
        return SetFMIndex(
            _state=(z["text"], z["offsets"], z["bwt"], z["sa"], z["C"]))
    from genomics_tpu_torch.index.fmindex import load_index

    return load_index(path)


def serve(index, lines_in, out, locate_limit: int = 20):
    """nvFM-server-style persistent query loop: one pattern per input
    line → 'pattern<TAB>count[<TAB>hits]'.  `index` may be a SetFMIndex
    or a plain FMIndex; 'QUIT' ends the loop.

    The reference server (CDP/NvB/nvFM-server, 61 LoC) maps the index
    once and serves clients; here the index stays resident in the
    process and the loop serves a stream (stdin or a socket file)."""
    is_set = isinstance(index, SetFMIndex)
    for raw in lines_in:
        pat = raw.strip()
        if not pat:
            continue
        if pat.upper() == "QUIT":
            break
        if is_set:
            cnt = index.count(pat)
            hits = index.locate(pat, limit=locate_limit) if cnt else []
            hit_s = ",".join(f"{r}:{o}" for r, o in hits)
        else:
            e = encode2(pat)
            if (e > 3).any():
                # non-ACGT chars (e.g. 'N') can never match the 2-bit
                # index — report 0 instead of crashing the server
                out.write(f"{pat}\t0\n")
                out.flush()
                continue
            e = e[None, :]
            lo, hi = index.backward_search(
                e, np.array([e.shape[1]], np.int64))
            cnt = max(int(hi[0] - lo[0]), 0)
            hits = index.locate(int(lo[0]), int(hi[0]))[:locate_limit] \
                if cnt else []
            hit_s = ",".join(str(int(x)) for x in hits)
        out.write(f"{pat}\t{cnt}" + (f"\t{hit_s}" if hit_s else "") + "\n")
        out.flush()
