"""k-mer spectrum error corrector: the port's copy of
`genomics_tpu/models/corrector.py`, host code in both packages (reference:
CDP/NvB/nvLighter — the
Bloom-filter-based Lighter algorithm: sample k-mers, build a trusted
k-mer Bloom filter, correct reads by restoring untrusted positions to
the alternative that maximizes trusted-k-mer coverage).

Simplified single-pass variant: count k-mers across reads (exact
counts, numpy), k-mers with count >= threshold are trusted (stored in a
Bloom filter — the nvLighter structure); for each read position covered
by too few trusted k-mers, try the 3 alternative bases and keep the one
that maximizes the number of trusted k-mers covering the read.

`LighterCorrector.correct_batch` takes the native walk
(`runtime.native.lighter_pass3`); a library that does not build or load
raises, where the JAX package falls back to the Python walk.  The Python
walk stays as its plain version (`use_native=False`), and as the walk of
reads past `native.LIGHTER_MAX_LEN` bases, the JAX package's own rule.
"""
from __future__ import annotations

import numpy as np

from genomics_tpu_torch.index.bloom import BloomFilter
from genomics_tpu_torch.index.qgram import encode2, qgrams_of
from genomics_tpu_torch.runtime import native


class KmerCorrector:
    def __init__(self, k: int = 15, trust_threshold: int = 3,
                 bloom_bits: int = 1 << 22):
        self.k = k
        self.threshold = trust_threshold
        self.bloom_bits = bloom_bits
        self.bloom: BloomFilter | None = None

    def build(self, reads: list[str]) -> None:
        from collections import Counter

        counts: Counter = Counter()
        for r in reads:
            keys = qgrams_of(encode2(r), self.k)
            keys = keys[keys < (1 << (2 * self.k))]
            counts.update(keys.tolist())
        trusted = np.array(
            [key for key, c in counts.items() if c >= self.threshold], np.uint64
        )
        self.bloom = BloomFilter(self.bloom_bits, k=4)
        if len(trusted):
            self.bloom.insert(trusted)

    def _coverage(self, codes: np.ndarray) -> int:
        keys = qgrams_of(codes, self.k)
        valid = keys < (1 << (2 * self.k))
        if not valid.any():
            return 0
        return int(self.bloom.query(keys[valid].astype(np.uint64)).sum())

    def correct(self, read: str, max_fixes: int = 4) -> str:
        assert self.bloom is not None, "call build() first"
        codes = encode2(read).copy()
        n, k = len(codes), self.k
        if n < k:
            return read
        fixes = 0
        keys = qgrams_of(codes, k)
        valid = keys < (1 << (2 * k))
        trusted = np.zeros(len(keys), bool)
        trusted[valid] = self.bloom.query(keys[valid].astype(np.uint64))
        # positions covered by no trusted k-mer are suspects
        cover = np.zeros(n, np.int32)
        for i in np.nonzero(trusted)[0]:
            cover[i : i + k] += 1
        best_cov = self._coverage(codes)
        for pos in np.nonzero(cover == 0)[0]:
            if fixes >= max_fixes:
                break
            orig = codes[pos]
            best_b, best_c = orig, best_cov
            for b in range(4):
                if b == orig:
                    continue
                codes[pos] = b
                c = self._coverage(codes)
                if c > best_c:
                    best_b, best_c = b, c
            codes[pos] = best_b
            if best_b != orig:
                fixes += 1
                best_cov = best_c
        return "".join("ACGT"[c] if c < 4 else "N" for c in codes)

    def correct_batch(self, reads: list[str]) -> list[str]:
        return [self.correct(r) for r in reads]


# ---------------------------------------------------------------------------
# Faithful nvLighter (reference: Non-CDP/NvB/nvLighter)
# ---------------------------------------------------------------------------


class _KmerCode:
    """utils.h:75-138 KmerCode: rolling big-endian 2-bit code with an
    `invalid` countdown tracking the most recent N."""

    __slots__ = ("mask", "code", "len", "invalid")

    def __init__(self, k: int):
        self.mask = (1 << (2 * k)) - 1
        self.code = 0
        self.len = k
        self.invalid = -1

    def copy(self) -> "_KmerCode":
        o = _KmerCode.__new__(_KmerCode)
        o.mask, o.code, o.len, o.invalid = (
            self.mask, self.code, self.len, self.invalid)
        return o

    def restart(self):
        self.code = 0
        self.invalid = -1

    def push_back(self, c: int):
        if self.invalid != -1:
            self.invalid += 1
        self.code = ((self.code << 2) & self.mask) | (c & 3)
        if c >= 4:
            self.invalid = 0
        if self.invalid >= self.len:
            self.invalid = -1

    def push_front(self, c: int):
        self.shift_right(1)
        if c >= 4:
            self.invalid = self.len - 1
        self.code = (self.code | ((c & 3) << (2 * (self.len - 1)))) & self.mask

    def shift_right(self, k: int):
        if self.invalid != -1:
            self.invalid -= k
        self.code = (self.code >> (2 * k)) & (self.mask >> (2 * k))
        if self.invalid < 0:
            self.invalid = -1

    def is_valid(self) -> bool:
        return self.invalid == -1


def _binom_cdf(n: int, p: float) -> np.ndarray:
    """P(X <= j) for X ~ Binomial(n, p), j = 0..n (log-space pmf)."""
    import math

    j = np.arange(n + 1, dtype=np.float64)
    logc = (
        np.array([math.lgamma(n + 1) for _ in range(n + 1)])
        - np.array([math.lgamma(v + 1) for v in j])
        - np.array([math.lgamma(n - v + 1) for v in j])
    )
    p = min(max(p, 1e-12), 1 - 1e-12)
    logpmf = logc + j * math.log(p) + (n - j) * math.log(1 - p)
    return np.cumsum(np.exp(logpmf))


class LighterCorrector:
    """The actual Lighter algorithm (reference: Non-CDP/NvB/nvLighter):

    pass 1 (sample_kmers.cu:55-142)    sample k-mers with probability
        alpha into Bloom filter A;
    threshold (nvLighter.cu:496-558)   per-coverage trust thresholds
        from the binomial tail of the sampling process, with the
        filter's measured FP rate folded in;
    pass 2 (sample_kmers.cu:305-460)   mark positions covered by more
        sampled k-mers than the threshold; k-mers made of k trusted
        positions in a row go into the trusted Bloom filter B;
    pass 3 (error_correct.cu:85-716)   per read: solid-kmer array,
        longest solid anchor, bidirectional greedy extension choosing
        the base that extends the trusted run furthest (ambiguity and
        max-correction caps as in the reference), then apply fixes.

    alpha defaults to nvLighter's inference: 7 / coverage
    (nvLighter.cu:169) with coverage = total_bases / genome_size.
    """

    def __init__(self, k: int = 17, genome_size: int | None = None,
                 alpha: float | None = None, bloom_bits: int = 1 << 24,
                 max_correction: float = 4.0, seed: int = 0,
                 bad_quality: int = -1, new_quality: int | None = None):
        self.k = k
        self.genome_size = genome_size
        self.alpha = alpha
        self.bloom_bits = bloom_bits
        self.max_correction = float(max_correction)
        self.seed = seed
        self.bad_quality = bad_quality
        self.new_quality = new_quality
        self.sampled: BloomFilter | None = None
        self.trusted: BloomFilter | None = None
        self.threshold: np.ndarray | None = None
        self._probe_cache: dict = {}

    # -- passes 1 + 2 -----------------------------------------------------

    def _read_kmers(self, codes: np.ndarray):
        """(keys, valid) for every k-mer start of one read (2-bit codes,
        255 where N)."""
        n, k = len(codes), self.k
        if n < k:
            return np.zeros(0, np.uint64), np.zeros(0, bool)
        keys = qgrams_of(np.where(codes == 255, 0, codes), k)
        win_n = np.lib.stride_tricks.sliding_window_view(codes == 255, k)
        valid = ~win_n.any(axis=1)
        return keys.astype(np.uint64), valid

    def build(self, reads: list[str]) -> None:
        rng = np.random.default_rng(self.seed)
        k = self.k
        alpha = self.alpha
        if alpha is None:
            total = sum(len(r) for r in reads)
            gsize = self.genome_size or max(total // 10, 1)
            coverage = max(total / gsize, 7.0)
            alpha = 7.0 / coverage            # nvLighter.cu:169
        self._alpha = alpha

        enc = [encode2(r) for r in reads]
        kmers = [self._read_kmers(c) for c in enc]

        # ---- pass 1: sampled filter A ----
        A = BloomFilter(self.bloom_bits, k=4)
        for keys, valid in kmers:
            if not len(keys):
                continue
            pick = valid & (rng.random(len(keys)) < alpha)
            if pick.any():
                A.insert(keys[pick])
        self.sampled = A

        # ---- threshold table (nvLighter.cu:531-558) ----
        occupancy = (
            np.unpackbits(A.words.view(np.uint8)).sum() / float(A.n_bits)
        )
        FP = float(occupancy) ** A.k
        thr = np.zeros(k + 1, np.int64)
        d = int(0.1 / alpha * 2)
        if d < 2:
            d = 2
        p = 1.0 - (1.0 - alpha) ** d
        pf = p + FP - p * FP
        for i in range(1, k + 1):
            cdf = _binom_cdf(i, pf)
            sel = np.nonzero(cdf >= 1 - 0.5e-2)[0]
            thr[i] = sel[0] if len(sel) else i
        self.threshold = thr
        self.fp_rate = FP

        # ---- pass 2: trusted filter B ----
        B = BloomFilter(self.bloom_bits, k=4)
        for codes, (keys, valid) in zip(enc, kmers):
            n = len(codes)
            if n < k:
                continue
            occur = np.zeros(len(keys), bool)
            if valid.any():
                occur[valid] = A.query(keys[valid])
            # one_cnt[j] = sampled k-mers covering position j
            cs = np.concatenate([[0], np.cumsum(occur)])
            j = np.arange(n)
            losub = np.clip(j - k + 1, 0, None)
            hisub = np.minimum(j, len(keys) - 1)
            one = cs[hisub + 1] - cs[losub]
            cnt = hisub - losub + 1
            trusted_pos = one > thr[cnt]
            # k-in-a-row trusted AND char at the window end not N → the
            # kmer (Ns inside shifted in as 'A', exactly as the
            # reference's `kmer <<= 2` with no insert)
            run = np.lib.stride_tricks.sliding_window_view(trusted_pos, k)
            allt = run.all(axis=1) & (codes[k - 1:] != 255)
            if allt.any():
                B.insert(keys[allt])
        self.trusted = B
        self._probe_cache = {}

    # -- pass 3: correction (error_correct.cu transcription) --------------

    def _is_trusted(self, kmer: _KmerCode) -> bool:
        if not kmer.is_valid():
            return False
        code = kmer.code
        cache = self._probe_cache
        hit = cache.get(code)
        if hit is None:
            hit = cache[code] = self.trusted.query_one(code)
        return hit

    def _mark_solid(self, read):
        """Vectorized mark_solid_kmers (error_correct.cu:95-107): a
        k-mer is solid iff N-free and in the trusted filter."""
        K = self.k
        codes = np.asarray(read)
        keys, valid = self._read_kmers(
            np.where(codes >= 4, 255, codes).astype(np.uint8)
        )
        solid = np.zeros(len(keys), bool)
        if valid.any():
            solid[valid] = self.trusted.query(keys[valid])
        return solid

    @staticmethod
    def _longest_solid(kmer_count, solid):
        """Longest run of solid k-mers; first run wins ties (the
        reference's strict `longest < stored`).  Vectorized run-length."""
        s = np.zeros(kmer_count + 2, np.int8)
        s[1:-1] = np.asarray(solid[:kmer_count], np.int8)
        d = np.diff(s)
        starts = np.nonzero(d == 1)[0]
        if not len(starts):
            return (0, 0)
        lengths = np.nonzero(d == -1)[0] - starts
        j = int(np.argmax(lengths))
        longest, begin = int(lengths[j]), int(starts[j])
        if longest >= kmer_count:
            return (begin, kmer_count)
        return (begin, begin + longest)

    def _best_right_change(self, read_len, read, frm, to, fixed_kmer):
        K = self.k
        best_kmer = None
        best_to, best_change, best_count = -1, -1, 0
        for j in range(4):
            kmer = fixed_kmer.copy()
            kmer.push_back(j)
            if not self._is_trusted(kmer):
                continue
            if best_to == -1:
                best_to = frm - 1
            k = frm
            while k <= to:
                kmer.push_back(int(read[k]))
                if not self._is_trusted(kmer):
                    break
                k += 1
            if k > to and to == read_len - 1:
                for _m in range(K - 1 - (to - frm + 1)):
                    for l in range(4):
                        tmp = kmer.copy()
                        tmp.push_back(l)
                        if self._is_trusted(tmp):
                            kmer.push_back(l)
                            k += 1
                            break
            if k > best_to:
                best_count, best_to, best_change = 1, k, j
                best_kmer = kmer
            elif k == best_to:
                best_count += 1
                if k == frm and j == 0:
                    best_count, best_change, best_kmer = 1, j, kmer
                elif k == frm and best_change == 0:
                    best_count = 1       # reference quirk (:237-238)
        return best_kmer, best_to, best_change, best_count

    def _check_right(self, tmp_kmer, read, pos, ln):
        for t in range(ln):
            tmp_kmer.push_back(int(read[pos + t]))
            if not self._is_trusted(tmp_kmer):
                return False
        return True

    def _adjust_right(self, read_len, read, kmer, pos):
        K = self.k
        if pos + K // 2 + 1 >= read_len:
            return False
        for c in range(4):
            if c == int(read[pos - 1]):
                continue
            tmp = kmer.copy()
            tmp.shift_right(1)
            tmp.push_back(c)
            if self._is_trusted(tmp) and self._check_right(
                tmp.copy(), read, pos, K // 2 + 1
            ):
                return True
        return False

    def _fix_right(self, read_len, read, longest, fix, solid):
        K = self.k
        trim_start = read_len
        bad_suffix = 0
        ambiguous = False
        longest_count = longest[1] - longest[0]
        kmer_count = read_len - K + 1
        i = longest[1]
        kmer = _KmerCode(K)
        if longest[1] >= kmer_count:
            i = read_len + 1
        elif longest_count < K:
            for i in range(longest[1], longest[1] - 1 + K):
                kmer.push_back(int(read[i]))
            i = longest[1] - 1 + K
        else:
            for j in range(K // 2 - 1, -1, -1):
                kmer.restart()
                for i in range(longest[1] - j - 1, longest[1] - j + K - 1):
                    kmer.push_back(int(read[i]))
                i = longest[1] - j + K - 1
                if self._adjust_right(read_len, read, kmer, i):
                    i -= 1
                    kmer.shift_right(1)
                    break
        while i < read_len:
            frm = i + 1
            to = i + K - 1 if i + K - 1 < read_len else read_len - 1
            tmp_kmer, best_to, best_change, best_count = (
                self._best_right_change(read_len, read, frm, to, kmer)
            )
            if best_to == -1 or (
                best_count > 1 and (best_to <= to or to - i + 1 < K)
            ):
                trim_start = i
                break
            if best_count <= 1:
                fix[i] = best_change
            else:
                fix[i] = -2
                ambiguous = True
            if best_to >= read_len:
                break
            if best_to <= to:
                kmer = tmp_kmer.copy()
                kmer.shift_right(1)
                i = best_to
            else:
                knext = to - K + 2
                while knext < kmer_count and solid[knext]:
                    knext += 1
                if knext >= kmer_count:
                    break
                kmer.restart()
                for i in range(knext, knext + K - 1):
                    kmer.push_back(int(read[i]) if fix[i] < 0 else fix[i])
                i = knext + K - 1
        return trim_start, bad_suffix, ambiguous

    def _best_left_change(self, read_len, read, frm, to, fixed_kmer):
        K = self.k
        best_kmer = None
        best_to, best_change, best_count = read_len + 1, -1, 0
        for j in range(4):
            kmer = fixed_kmer.copy()
            kmer.push_front(j)
            if not self._is_trusted(kmer):
                continue
            if best_to == read_len + 1:
                best_to = frm + 1
            k = frm
            while k >= to:
                kmer.push_front(int(read[k]))
                if not self._is_trusted(kmer):
                    break
                k -= 1
            if k < to and to == 0:
                for _m in range(K - 1 - (frm - to + 1)):
                    for l in range(4):
                        tmp = kmer.copy()
                        tmp.push_front(l)
                        if self._is_trusted(tmp):
                            kmer.push_front(l)
                            k -= 1
                            break
            if k < best_to:
                best_count, best_to, best_change = 1, k, j
                best_kmer = kmer
            elif k == best_to:
                best_count += 1
                if k == frm and j == int(read[frm + 1]):
                    best_count, best_change, best_kmer = 1, j, kmer
                elif k == frm and best_change == int(read[frm + 1]):
                    best_count = 1
        return best_kmer, best_to, best_change, best_count

    def _check_left(self, tmp_kmer, read, pos, ln):
        for t in range(ln):
            tmp_kmer.push_front(int(read[pos - t]))
            if not self._is_trusted(tmp_kmer):
                return False
        return True

    def _adjust_left(self, read_len, read, kmer, pos):
        K = self.k
        if pos - 1 - K // 2 < 0:
            return False
        for c in range(4):
            if c == int(read[pos]):
                continue
            tmp = kmer.copy()
            tmp.push_back(0)
            tmp.push_front(c)
            if self._is_trusted(tmp) and self._check_left(
                tmp.copy(), read, pos - 1, K // 2 + 1
            ):
                return True
        return False

    def _fix_left(self, read_len, read, longest, fix, solid):
        K = self.k
        bad_prefix = 0
        ambiguous = False
        longest_count = longest[1] - longest[0]
        kmer = _KmerCode(K)
        # NOTE deliberate deviation from the nvbio port: the reference's
        # fix_left (error_correct.cu:525-529) force-skips whenever the
        # anchor does not start at 0 and clobbers its starting index
        # with for-loop exit values (:533-541 sets "the starting point
        # i = longest_range.x - 1" and immediately overwrites it) —
        # making the left half of mid-anchored reads uncorrectable.
        # We run the INTENDED Lighter semantics: fix leftward from
        # longest.x - 1 with the anchor-start kmer
        # (read[x .. x+K-1) + 'A' placeholder, the same state the
        # reference's own next-error branch (:605-617) constructs).
        i = longest[0] - 1
        if longest_count < K:
            if longest[0] > 0:
                kmer.restart()
                for p in range(longest[0], longest[0] + K - 1):
                    kmer.push_back(int(read[p]))
                kmer.push_back(0)
        else:
            fired = False
            for j in range(K // 2 - 1, -1, -1):
                pos = longest[0] + j
                kmer.restart()
                for p in range(pos, pos + K):
                    kmer.push_back(int(read[p]))
                if self._adjust_left(read_len, read, kmer, pos):
                    i = pos
                    kmer.push_back(0)
                    fired = True
                    break
            if not fired:
                if longest[0] > 0:
                    kmer.restart()
                    for p in range(longest[0], longest[0] + K - 1):
                        kmer.push_back(int(read[p]))
                    kmer.push_back(0)
                else:
                    i = -1
        while i >= 0:
            frm = i - 1
            to = max(i - K + 1, 0)
            tmp_kmer, best_to, best_change, best_count = (
                self._best_left_change(read_len, read, frm, to, kmer)
            )
            if best_to == read_len + 1 or (
                best_count > 1 and (best_to >= to or i - to + 1 < K)
            ):
                bad_prefix = i + 1
                break
            if best_count <= 1:
                fix[i] = best_change
            else:
                fix[i] = -2
                ambiguous = True
            if best_to < 0:
                break
            if best_to >= to:
                kmer = tmp_kmer.copy()
                kmer.push_front(0)
                i = best_to
            else:
                knext = to - 1
                while knext >= 0 and solid[knext]:
                    knext -= 1
                if knext < 0:
                    break
                kmer.restart()
                for i in range(knext + 1, knext + K):
                    kmer.push_back(int(read[i]) if fix[i] < 0 else fix[i])
                i = knext
                kmer.push_back(0)
        return bad_prefix, ambiguous

    def correct(self, read: str, qual: np.ndarray | None = None):
        """Correct one read (error_correct.cu:624-716).

        Returns (corrected_read, n_corrections) with n_corrections = -1
        for unreliable reads (left unchanged)."""
        assert self.trusted is not None, "call build() first"
        codes = encode2(read).copy()
        codes = np.where(codes == 255, 4, codes).astype(np.int64)
        if len(codes) < self.k:
            return read, 0
        return self._correct_prepared(read, codes, self._mark_solid(codes),
                                      qual)

    def _correct_prepared(self, read, codes, solid, qual=None):
        K = self.k
        read_len = len(codes)
        if qual is None:
            qual = np.full(read_len, 40, np.int64)
        kmer_count = read_len - K + 1
        fix = np.full(read_len, -1, np.int64)
        longest = self._longest_solid(kmer_count, solid)
        if longest[1] - longest[0] == 0:
            return read, -1
        if longest[1] - longest[0] >= kmer_count:
            return read, 0
        trim_start, bad_suffix, amb_r = self._fix_right(
            read_len, codes, longest, fix, solid
        )
        bad_prefix, amb_l = self._fix_left(read_len, codes, longest, fix, solid)
        ambiguous = amb_r or amb_l

        # max-correction density cap (:672-687), vectorized: cc at i is
        # the weight sum over the K-wide window ending at i
        w = np.where(
            (fix >= 0) & (codes < 4),
            np.where(qual <= self.bad_quality, 0.5, 1.0),
            0.0,
        )
        cs = np.concatenate([[0.0], np.cumsum(w)])
        cc = cs[1:] - cs[np.maximum(np.arange(read_len) - K + 1, 0)]
        if (cc > self.max_correction).any():
            return read, -1

        out = codes.copy()
        window = slice(bad_prefix, trim_start)
        apply_ = (fix[window] >= 0) & (out[window] != fix[window])
        corrections = int(apply_.sum())
        out[window] = np.where(apply_, fix[window], out[window])
        bad_suffix = read_len - trim_start
        if corrections == 0 and bad_prefix == 0 and bad_suffix == 0 and ambiguous:
            return read, -1
        fixed = "".join("ACGTN"[int(c)] for c in out)
        return fixed, corrections

    def _correct_batch_native(self, reads: list[str], quals=None):
        K = self.k
        n = len(reads)
        L = max(len(r) for r in reads)
        mat = np.full((n, L), 4, np.uint8)
        lens = np.zeros(n, np.int32)
        for i, r in enumerate(reads):
            c = encode2(r)
            mat[i, : len(c)] = np.where(c == 255, 4, c)
            lens[i] = len(c)
        qmat = None
        if quals is not None:
            qmat = np.full((n, L), 40, np.uint8)
            for i, q in enumerate(quals):
                qmat[i, : len(q)] = np.asarray(q, np.uint8)
        res = native.lighter_pass3(
            mat, lens, self.trusted.words, self.trusted.n_bits,
            self.trusted.k, K, self.max_correction, self.bad_quality,
            quals=qmat,
        )
        out_codes, ncorr = res
        lut = np.frombuffer(b"ACGTN", np.uint8)
        out = []
        for i, r in enumerate(reads):
            nc = int(ncorr[i])
            if nc <= 0:
                out.append((r, nc))
            else:
                s = bytes(lut[out_codes[i, : lens[i]]]).decode()
                out.append((s, nc))
        return out

    def correct_batch(self, reads: list[str], quals=None,
                      use_native: bool = True):
        """Batched pass 3.  The whole walk runs in the native library
        (native/lighter.cpp, a 1:1 transcription of this file's Python
        walk, itself the error_correct.cu transcription), one read after
        another: the library is built without OpenMP.  The walk is a
        branch-divergent scalar state machine; the reference runs it a
        thread a read on the GPU (error_correct.cu:85-716).  The Python
        walk below is the plain version (use_native=False), and the walk
        of reads past native.LIGHTER_MAX_LEN bases, as in the JAX
        package."""
        assert self.trusted is not None, "call build() first"
        if use_native and len(reads) and max(
                len(r) for r in reads) <= native.LIGHTER_MAX_LEN:
            return self._correct_batch_native(reads, quals)
        self._probe_cache = {}
        K = self.k
        enc = []
        for r in reads:
            c = encode2(r).copy()
            enc.append(np.where(c == 255, 4, c).astype(np.int64))
        keys_all, valid_all, spans = [], [], []
        off = 0
        for c in enc:
            keys, valid = self._read_kmers(
                np.where(c >= 4, 255, c).astype(np.uint8))
            keys_all.append(keys)
            valid_all.append(valid)
            spans.append((off, off + len(keys)))
            off += len(keys)
        if off:
            kcat = np.concatenate(keys_all)
            vcat = np.concatenate(valid_all)
            scat = np.zeros(off, bool)
            if vcat.any():
                scat[vcat] = self.trusted.query(kcat[vcat])
        out = []
        for i, (r, c) in enumerate(zip(reads, enc)):
            if len(c) < K:
                out.append((r, 0))
                continue
            lo, hi = spans[i]
            qual = None if quals is None else quals[i]
            out.append(self._correct_prepared(r, c, scat[lo:hi], qual))
        return out
