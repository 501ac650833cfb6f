"""FM-index: the port's copy of `genomics_tpu/index/fmindex.py`, host
numpy as there (reference: CDP/NvB/nvbio/fmindex, rank dictionaries and
backtracking search; nvbio/sufsort builds the BWT; nvBWT app).

Build: linear-time native SA-IS (native/sais.cpp through
`runtime/native.py`, which raises if it cannot build it), BWT, occ
checkpoints every `occ_rate` positions (rank = checkpoint + in-block
count, the nvbio rank_dict design), and a text-position-sampled SA
(`sa_rate`; full below 8 Mbp).  Search: batched backward search, all
queries stepping together, two rank lookups per query per step; its
device counterpart is `ops/fm_search.py` (`to_device`).  Locate:
sampled-SA LF walk.  `suffix_array` (prefix doubling) is kept as the
plain sorter the tests hold SA-IS to.

One divergence from the JAX package: codes below 0 are refused as codes
above 3 are (the JAX build checks only the maximum, so -1 wraps to 255
at the uint8 cast and builds an index over a symbol that is not there).
"""
from __future__ import annotations

import numpy as np

from genomics_tpu_torch.index.qgram import encode2
from genomics_tpu_torch.runtime import native

SENTINEL = 4  # lexicographically smallest


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling (O(n log^2 n), numpy)."""
    n = len(codes)
    rank = codes.astype(np.int64)
    sa = np.argsort(rank, kind="stable").astype(np.int64)
    k = 1
    while k < n:
        key2 = np.full(n, -1, np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        new = np.zeros(n, np.int64)
        r_o = rank[order]
        k_o = key2[order]
        changed = np.ones(n, bool)
        changed[1:] = (r_o[1:] != r_o[:-1]) | (k_o[1:] != k_o[:-1])
        new[order] = np.cumsum(changed) - 1
        rank = new
        sa = order
        if rank.max() == n - 1:
            break
        k <<= 1
    return sa.astype(np.int64)


class FMIndex:
    def __init__(self, text: "str | bytes | np.ndarray", occ_rate: int = 128,
                 sa_rate: int | None = None):
        # genome-scale callers pass 2-bit code arrays directly (a 3.2 Gbp
        # text as a Python string would double peak memory for nothing)
        codes = text if isinstance(text, np.ndarray) else encode2(text)
        if codes.size and (int(codes.max()) > 3 or int(codes.min()) < 0):
            # covers 255 (encode2's non-ACGT marker) AND out-of-range
            # ndarray inputs (e.g. 4-bit GASAL codes passed by mistake,
            # or 2-bit arrays with N encoded as 4) — a silent build over
            # bad symbols would corrupt every occ table
            raise ValueError(
                "FM-index text must be ACGT only / 2-bit codes 0..3 "
                "(found other symbols); split contigs or mask N runs "
                "before indexing"
            )
        self.n = len(codes) + 1   # text + appended sentinel
        # native linear-time SA-IS + BWT (native/sais.cpp: int32 below
        # ~2.1 G symbols, int64 above)
        codes_u8 = codes.astype(np.uint8)
        sa = native.sais_u8(codes_u8)
        buf = native.bwt_from_sa(codes_u8, sa)
        # uint8 wraparound maps the 0xFF sentinel marker to 0 and codes
        # 0..3 to symbols 1..4 in one add
        bwt = (buf + np.uint8(1)).astype(np.int8)
        self.bwt = bwt
        # C array: counts of symbols < s
        counts = np.bincount(bwt, minlength=5)
        self.C = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        # rank dictionary: occ checkpoints every occ_rate positions with
        # an in-block popcount at query time (nvbio/fmindex rank_dict
        # design — a FULL occ table would be 5*(n+1)*8 bytes, 2 GB for a
        # 50 Mbp reference)
        R = int(occ_rate)
        self.occ_rate = R
        nb = (self.n + R - 1) // R
        ckpt = np.zeros((5, nb + 1), np.int64)
        starts = np.arange(0, self.n, R)
        for sym in range(5):
            cnt = np.add.reduceat(bwt == sym, starts)
            ckpt[sym, 1:] = np.cumsum(cnt)
        self.ckpt = ckpt
        # SA sampling (nvbio SSA): text-position-sampled — keep rows
        # whose suffix position is a multiple of sa_rate, locate via the
        # LF walk.  Full SA for small texts (tests, exactness).
        if sa_rate is None:
            sa_rate = 32 if self.n > 8_000_000 else 1
        self.sa_rate = int(sa_rate)
        if self.sa_rate <= 1:
            self.sa = sa
            self._ssa_rows = None
        else:
            mask = (sa % self.sa_rate) == 0
            self.sa = None
            self._ssa_rows = np.nonzero(mask)[0].astype(np.int64)
            self._ssa_vals = sa[self._ssa_rows].astype(np.int64)

    def rank(self, s: np.ndarray, i: np.ndarray) -> np.ndarray:
        """occ(s, i) = # of symbol s in bwt[:i], vectorized (checkpoint
        + in-block count)."""
        s = np.asarray(s, np.int64)
        i = np.asarray(i, np.int64)
        R = self.occ_rate
        k = i // R
        base = self.ckpt[s, k]
        start = k * R
        offs = np.arange(R, dtype=np.int64)
        idxm = start[..., None] + offs
        valid = idxm < i[..., None]
        blk = self.bwt[np.minimum(idxm, self.n - 1)]
        return base + ((blk == s[..., None]) & valid).sum(-1)

    def backward_search(self, queries: np.ndarray, qlen: np.ndarray):
        """Batched exact-match backward search.

        queries: [B, L] 2-bit codes (255 pad, aligned RIGHT-justified not
        required — we consume from each query's own end); qlen: [B].
        Returns (lo [B], hi [B]): SA ranges (hi<=lo → no match)."""
        B, L = queries.shape
        lo = np.zeros(B, np.int64)
        hi = np.full(B, self.n, np.int64)
        alive = np.ones(B, bool)
        for step in range(int(qlen.max())):
            k = qlen - 1 - step
            act = alive & (k >= 0)
            sym = np.where(act, queries[np.arange(B), np.clip(k, 0, L - 1)], 0)
            s = sym.astype(np.int64) + 1  # bwt symbol space
            nlo = self.C[s] + self.rank(s, lo)
            nhi = self.C[s] + self.rank(s, hi)
            lo = np.where(act, nlo, lo)
            hi = np.where(act, nhi, hi)
            alive = alive & (hi > lo)
        return lo, hi

    def sa_values(self, rows: np.ndarray) -> np.ndarray:
        """Suffix positions for SA rows; LF-walks to the nearest sampled
        row when the SA is sampled (<= sa_rate steps, vectorized)."""
        rows = np.asarray(rows, np.int64)
        if self.sa is not None:
            return self.sa[rows].astype(np.int64)
        out = np.full(rows.shape, -1, np.int64)
        cur = rows.copy()
        steps = np.zeros(rows.shape, np.int64)
        for _ in range(self.sa_rate + 1):
            unresolved = out < 0
            if not unresolved.any():
                break
            r = cur[unresolved]
            idx = np.searchsorted(self._ssa_rows, r)
            idx = np.minimum(idx, len(self._ssa_rows) - 1)
            hit = self._ssa_rows[idx] == r
            vals = np.where(hit, self._ssa_vals[idx] + steps[unresolved], -1)
            o = out[unresolved]
            o[hit] = vals[hit]
            out[unresolved] = o
            # LF step for the rest
            sym = self.bwt[r].astype(np.int64)
            nxt = self.C[sym] + self.rank(sym, r)
            c = cur[unresolved]
            c[~hit] = nxt[~hit]
            cur[unresolved] = c
            st = steps[unresolved]
            st[~hit] += 1
            steps[unresolved] = st
        return out

    def locate(self, lo: int, hi: int) -> np.ndarray:
        """SA range → sorted text positions."""
        if hi <= lo:
            return np.zeros(0, np.int64)
        return np.sort(self.sa_values(np.arange(lo, hi)))

    def count(self, pattern: str) -> int:
        codes = encode2(pattern)[None, :]
        lo, hi = self.backward_search(codes, np.array([codes.shape[1]]))
        return int(max(hi[0] - lo[0], 0))

    def to_device(self, device="cuda"):
        """Pack into a DeviceFMIndex on `device` for the batched search of
        ops/fm_search (the nvbio fmindex_device.h analog)."""
        from genomics_tpu_torch.ops.fm_search import build_device_index

        return build_device_index(self, device=device)

    # -- inexact search (nvbio backtrack.h analog) -------------------------

    def _occ1(self, s: int, i: int) -> int:
        return int(self.rank(np.int64(s), np.int64(i)))

    def inexact_search(self, pattern, max_mm: int = 1, max_results: int = 64):
        """Backtracking approximate search: all SA ranges matching
        `pattern` with up to max_mm substitutions (reference:
        Non-CDP/NvB/nvbio/fmindex/backtrack.h — hamming_backtrack's
        DFS over alternate symbols, stack of (range, position,
        budget)).  Returns [(lo, hi, n_mismatch)], best (fewest
        mismatches) first; ranges for distinct substitution patterns
        are disjoint."""
        codes = encode2(pattern) if isinstance(pattern, (str, bytes)) \
            else np.asarray(pattern)
        m = len(codes)
        out = []
        # DFS stack: (position to consume next(from the right), lo, hi, mm)
        stack = [(m - 1, 0, self.n, 0)]
        while stack and len(out) < max_results:
            i, lo, hi, mm = stack.pop()
            if i < 0:
                out.append((lo, hi, mm))
                continue
            want = int(codes[i]) if codes[i] != 255 else -1
            # try symbols: the true one free, others cost 1.  Push the
            # exact symbol LAST so it pops FIRST from the LIFO stack —
            # otherwise, when max_results truncates the DFS, 0-mismatch
            # ranges could be dropped while 1-2 mismatch ranges survive,
            # breaking the "fewest mismatches first" contract.
            order = [s for s in range(4) if s != want] + \
                ([want] if 0 <= want < 4 else [])
            for sym in order:
                cost = 0 if sym == want else 1
                if mm + cost > max_mm:
                    continue
                s = sym + 1
                nlo = int(self.C[s]) + self._occ1(s, lo)
                nhi = int(self.C[s]) + self._occ1(s, hi)
                if nhi > nlo:
                    stack.append((i - 1, nlo, nhi, mm + cost))
        out.sort(key=lambda r: r[2])
        return out

    def hybrid_search(self, pattern, max_mm: int = 1, split: int | None = None,
                      max_results: int = 64):
        """nvBowtie's approx-hybrid seed mapping (mapping_impl.h:67-68):
        0 mismatches in the subseed, up to max_mm in the rest.  The
        subseed is the RIGHT half (consumed first by backward search) —
        exact backward search narrows the range cheaply, then the
        backtracking DFS spends the mismatch budget on the left part
        only.  Returns [(lo, hi, n_mismatch)]."""
        codes = encode2(pattern) if isinstance(pattern, (str, bytes)) \
            else np.asarray(pattern)
        m = len(codes)
        if split is None:
            split = m // 2
        lo, hi = 0, self.n
        for i in range(m - 1, split - 1, -1):
            if codes[i] > 3:
                return []
            s = int(codes[i]) + 1
            lo2 = int(self.C[s]) + self._occ1(s, lo)
            hi2 = int(self.C[s]) + self._occ1(s, hi)
            if hi2 <= lo2:
                return []
            lo, hi = lo2, hi2
        out = []
        stack = [(split - 1, lo, hi, 0)]
        while stack and len(out) < max_results:
            i, lo, hi, mm = stack.pop()
            if i < 0:
                out.append((lo, hi, mm))
                continue
            want = int(codes[i]) if codes[i] <= 3 else -1
            for sym in range(4):
                cost = 0 if sym == want else 1
                if mm + cost > max_mm:
                    continue
                s = sym + 1
                nlo = int(self.C[s]) + self._occ1(s, lo)
                nhi = int(self.C[s]) + self._occ1(s, hi)
                if nhi > nlo:
                    stack.append((i - 1, nlo, nhi, mm + cost))
        out.sort(key=lambda r: r[2])
        return out


class BidirFMIndex:
    """Bidirectional FM-index (reference: Non-CDP/NvB/nvbio/fmindex/
    bidir.h — extend_forward/extend_backward over a paired
    forward/reverse index).

    State is a bi-interval (k, kr, s): [k, k+s) is the SA range of W in
    the FORWARD index, [kr, kr+s) the range of reverse(W) in the
    REVERSE index.  extend_back prepends a char (backward search on the
    forward index, reverse range maintained from the per-symbol
    occurrence counts); extend_forward appends (same with roles
    swapped).  Powers supermaximal-exact-match seeding (smems) —
    bwa-mem's mem collection, which greedy find_mems cannot produce."""

    def __init__(self, text: "str | bytes | np.ndarray"):
        if isinstance(text, bytes):
            text = text.decode()
        self.fwd = FMIndex(text)
        self.rev = FMIndex(
            text[::-1] if not isinstance(text, np.ndarray)
            else np.ascontiguousarray(text[::-1]))
        self.n = self.fwd.n

    def start(self):
        return (0, 0, self.n)

    def _cnts(self, fm: FMIndex, k: int, s: int):
        """Occurrence counts of each BWT symbol (0=$ .. 4=T) inside
        SA rows [k, k+s)."""
        syms = np.arange(5, dtype=np.int64)
        top = fm.rank(syms, np.full(5, k + s, np.int64))
        bot = fm.rank(syms, np.full(5, k, np.int64))
        return (top - bot).astype(np.int64)

    def extend_back(self, state, c: int):
        """W → cW.  c in 0..3.  Returns the new bi-interval (s may be
        0 = no occurrence)."""
        k, kr, s = state
        cnt = self._cnts(self.fwd, k, s)
        s2 = int(cnt[c + 1])
        k2 = int(self.fwd.C[c + 1]) + int(
            self.fwd.rank(np.int64(c + 1), np.int64(k)))
        # reverse ranges of {aW} partition [kr, kr+s) ordered by the
        # char FOLLOWING reverse(W) in reverse text = the prepended a:
        # $ first, then A<C<G<T
        kr2 = kr + int(cnt[0]) + int(cnt[1:c + 1].sum())
        return (k2, kr2, s2)

    def extend_forward(self, state, c: int):
        """W → Wc (append), symmetric on the reverse index."""
        k, kr, s = state
        cnt = self._cnts(self.rev, kr, s)
        s2 = int(cnt[c + 1])
        kr2 = int(self.rev.C[c + 1]) + int(
            self.rev.rank(np.int64(c + 1), np.int64(kr)))
        k2 = k + int(cnt[0]) + int(cnt[1:c + 1].sum())
        return (k2, kr2, s2)

    def _mem1(self, codes, x: int, min_len: int):
        """SMEMs covering position x (bwa-mem bwt_smem1 structure).
        Returns (mems, next_x)."""
        m = len(codes)
        st = self.extend_forward(self.start(), int(codes[x]))
        if st[2] == 0:
            return [], x + 1
        # forward: push the PREVIOUS interval whenever the range
        # shrinks (it held the largest end for its size), plus the
        # final one at end-of-query (bwa bwt_smem1a's forward loop)
        fwd = []
        end = x + 1
        while end < m:
            if codes[end] > 3:
                fwd.append((end, st))
                break
            nst = self.extend_forward(st, int(codes[end]))
            if nst[2] != st[2]:
                fwd.append((end, st))
                if nst[2] == 0:
                    break
            st = nst
            end += 1
        else:
            fwd.append((end, st))
        next_x = end
        # backward: longest-end intervals first; when the longest
        # still-alive interval dies at i, [i+1, its end) is
        # supermaximal (skip starts already covered by a prior mem)
        mems = []
        prev = fwd[::-1]
        i = x - 1
        while prev:
            c = int(codes[i]) if i >= 0 and codes[i] <= 3 else -1
            curr = []
            for e, s_ in prev:
                ns = self.extend_back(s_, c) if c >= 0 else (0, 0, 0)
                if ns[2] == 0:
                    if not curr and (
                        not mems or i + 1 < mems[-1][0]
                    ) and (e - (i + 1)) >= min_len:
                        mems.append((i + 1, e, s_[0], s_[0] + s_[2]))
                elif not curr or ns[2] != curr[-1][1][2]:
                    curr.append((e, ns))
            if not curr:
                break
            prev = curr
            i -= 1
        return mems, next_x

    def smems(self, query, min_len: int = 19):
        """Supermaximal exact matches (bwa-mem's mem collection over
        the bidirectional index — the seeding nvbio's bidir.h index
        exists to power; greedy find_mems cannot produce these).
        Returns [(q_start, q_end, sa_lo, sa_hi)] (forward-index
        range), q_end exclusive, length >= min_len, sorted."""
        codes = encode2(query) if isinstance(query, (str, bytes)) \
            else np.asarray(query)
        m = len(codes)
        out = []
        x = 0
        while x < m:
            if codes[x] > 3:
                x += 1
                continue
            mems, x = self._mem1(codes, x, min_len)
            out.extend(mems)
        seen = set()
        uniq = []
        for t in sorted(out):
            if (t[0], t[1]) not in seen:
                seen.add((t[0], t[1]))
                uniq.append(t)
        return uniq


def find_mems(fm: "FMIndex", query, min_len: int = 19):
    """Greedy maximal exact matches (nvmem-class seeding — reference:
    CDP/NvB/nvMem uses FM-index MEM seeds for chaining).

    Right-to-left backward-search extension: extend until the SA range
    empties, record the maximal match, restart just before the failure
    point.  Returns [(q_start, q_end, sa_lo, sa_hi), ...] with
    q_end exclusive, only matches >= min_len."""
    codes = encode2(query) if isinstance(query, (str, bytes)) else np.asarray(query)
    n = len(codes)
    mems = []
    e = n  # exclusive end of the current extension
    while e > 0:
        lo, hi = 0, fm.n
        i = e
        last = None
        while i > 0 and codes[i - 1] != 255:
            s = int(codes[i - 1]) + 1
            nlo = int(fm.C[s] + fm.rank(np.int64(s), np.int64(lo)))
            nhi = int(fm.C[s] + fm.rank(np.int64(s), np.int64(hi)))
            if nhi <= nlo:
                break
            lo, hi = int(nlo), int(nhi)
            i -= 1
            last = (i, e, lo, hi)
        if last is not None and (last[1] - last[0]) >= min_len:
            mems.append(last)
        # restart: skip past the character that broke the extension (or
        # the start of this match)
        e = i - 1 if i == e else (e - 1 if last is None else i)
        if last is not None and i == 0:
            break
        if last is None:
            e = min(e, i) if i < e else e - 1
    return mems


def seed_positions(fm: "FMIndex", query, min_len: int = 19, max_hits: int = 32):
    """MEMs expanded to (q_start, ref_pos) seed pairs (capped per MEM)."""
    out = []
    for qs, qe, lo, hi in find_mems(fm, query, min_len):
        for p in fm.sa_values(np.arange(lo, min(hi, lo + max_hits))):
            out.append((qs, int(p)))
    return out


def save_index(fm: "FMIndex", path: str) -> None:
    """Persist an FM-index (the nvBWT/nvSSA output-file analog — BWT +
    C + occ checkpoints + sampled SA in one npz; nvFM-server's role of
    sharing a built index across processes becomes load_index)."""
    np.savez_compressed(
        path,
        n=fm.n,
        bwt=fm.bwt,
        C=fm.C,
        ckpt=fm.ckpt,
        occ_rate=fm.occ_rate,
        sa_rate=fm.sa_rate,
        sa=fm.sa if fm.sa is not None else np.zeros(0, np.int64),
        ssa_rows=fm._ssa_rows if fm._ssa_rows is not None else np.zeros(0, np.int64),
        ssa_vals=fm._ssa_vals if fm._ssa_rows is not None else np.zeros(0, np.int64),
    )


def load_index(path: str) -> "FMIndex":
    z = np.load(path if path.endswith(".npz") else path + ".npz")
    fm = FMIndex.__new__(FMIndex)
    fm.n = int(z["n"])
    fm.bwt = z["bwt"]
    fm.C = z["C"]
    fm.ckpt = z["ckpt"]
    fm.occ_rate = int(z["occ_rate"])
    fm.sa_rate = int(z["sa_rate"])
    if fm.sa_rate <= 1:
        fm.sa = z["sa"]
        fm._ssa_rows = None
    else:
        fm.sa = None
        fm._ssa_rows = z["ssa_rows"]
        fm._ssa_vals = z["ssa_vals"]
    return fm
