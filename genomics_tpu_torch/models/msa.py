"""Center-star MSA (reference: CDP/STAR — CMSA2).  The counterpart of
`genomics_tpu/models/msa.py`.

Pipeline: k-mer occurrence center selection (center-star.cc:12-100) →
pairwise NW of every sequence against the center (affine, 3-matrix,
no x↔y switching, MATCH=0 / MISMATCH=-1 / GAP_START=0 / GAP_EXTEND=-1,
MIN_SCORE boundaries — nw.cc:25-94) → run-length backtrack producing
per-position gap counts `space` (gaps into the center) and
`spaceForOther` (gaps into the sequence) (nw.cc:96-150) → space merge
and aligned FASTA output (main.cu:90-140).

The pairwise DPs run in one batched call (`nw_matrices_batch`), and a
batched backtrack (`backtrack_batch`) returns only the gap counts, so the
O(B·m·n) matrices never leave the device.  Where one call's matrices do
not fit in the card's free memory, the pairs run in chunks, leaving 20%
free, as the reference's cuda_msa does (CDP/STAR/cuda-nw.cu:295-348).
Both functions take their plain versions (row scans; a loop of steps
vectorised over the batch) for tensors on the CPU and launch
`csrc/msa_nw.cu` (the fill replacing the jnp `nw_matrices_batch`,
msa.py:103; the backtrack replacing the jnp `backtrack_batch`, msa.py:160)
for tensors on a CUDA device; any other device raises.

The matrices are laid out pair-innermost, [m+1][n+1][P] in memory (P:
the pairs padded to whole sectors), and handed out as the [B, m+1, n+1]
view of the JAX function: the fill's threads, 8 pairs x 4 row strips a
warp, then store whole 32-byte sectors at each (i, j).  The backtrack
reads that storage in place, a warp a pair walking in rounds of
parallel loads (BACKTRACK_DIAG diagonal steps and the k = 1 gap step
after them, or BACKTRACK_RUN gap lengths, a round), and walks the B
pairs only.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from genomics_tpu_torch import _build
from genomics_tpu_torch.core.submat import load_scoring_matrix
from genomics_tpu_torch.device import checked_device, on_cpu
from genomics_tpu_torch.parallel import multihost
from genomics_tpu_torch.utils.fasta import read_fasta

MATCH, MISMATCH = 0, -1
GAP_START, GAP_EXTEND = 0, -1
MIN_SCORE = -32700
FREE_SHARE = 0.8   # a chunk's matrices take at most this share of free memory
# csrc/msa_nw.cu's fill: pairs a block (one 32-byte sector of int32 at each
# cell), rows a strip (a thread), rows a round (kRows x kMaxStrips)
FILL_PAIRS, FILL_ROWS, FILL_ROUND_ROWS = 8, 8, 768
# csrc/msa_nw.cu's backtrack: diagonal words (kDiag) and gap lengths k
# (kRun) a round of a pair's lanes
BACKTRACK_DIAG, BACKTRACK_RUN = 32, 32

# Kernel launches; each wrapper adds one where it launches its kernel.
LAUNCHES = {"msa_nw.fill": 0, "msa_nw.backtrack": 0}

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# center, seqs [n_pad, P], slens, table, A, M, m, n_pad, P (the pairs
# padded to whole sectors), stream
_FILL_ARGS = (_vp, _vp, _vp, _vp, _ci, _vp, _ci, _ci, _ci, _vp)
# M [m+1, n_pad+1, P], center, seqs [n_pad, B], slens, table, A, space,
# so, m, n_pad, P (M's pair pitch), B, stream
_BACKTRACK_ARGS = (_vp, _vp, _vp, _vp, _vp, _ci, _vp, _vp, _ci, _ci, _ci,
                   _ci, _vp)


# ---------------------------------------------------------------------------
# center selection (center-star.cc)
# ---------------------------------------------------------------------------


_C2I_LUT = np.full(256, -1, np.int64)   # per-char 2-bit contribution
_C2I_LUT[ord("A")] = 0
_C2I_LUT[ord("C")] = 2                  # bit (i*2+1)
_C2I_LUT[ord("T")] = 1                  # bit (i*2)
_C2I_LUT[ord("U")] = 1
_C2I_LUT[ord("G")] = 3


def _chunk_indices(s: str) -> np.ndarray:
    """All 8-char chunk indices of one sequence, vectorized (-1 where
    any char is unrecognized) — charsToIndex (center-star.cc:12-33)."""
    n8 = len(s) // 8
    if n8 == 0:
        return np.zeros(0, np.int64)
    b = np.frombuffer(s.encode()[: n8 * 8], np.uint8).reshape(n8, 8)
    v = _C2I_LUT[b]
    bad = (v < 0).any(axis=1)
    idx = (v << (2 * np.arange(8, dtype=np.int64))[None, :]).sum(axis=1)
    return np.where(bad, -1, idx)


def find_center_sequence(seqs: list[str]) -> int:
    """findCenterSequence (center-star.cc:38-100), vectorized: the
    occurrence vector counts each chunk once per sequence; the center
    maximizes the sum of occurrence counts over its chunks."""
    chunk_lists = [_chunk_indices(s) for s in seqs]
    vec = np.zeros(65536, np.int64)
    for ch in chunk_lists:
        u = np.unique(ch[ch >= 0])
        vec[u] += 1
    max_idx, max_count = 0, 0
    for i, ch in enumerate(chunk_lists):
        valid = ch[ch >= 0]
        count = int(vec[valid].sum())
        if count > max_count:
            max_idx, max_count = i, count
    return max_idx


# ---------------------------------------------------------------------------
# batched pairwise NW (nw.cc semantics) → M matrices
# ---------------------------------------------------------------------------


def _check_pairs(center, seqs, sub_table):
    if center.dim() != 1 or seqs.dim() != 2:
        raise ValueError(f"center [m] and seqs [B, n_pad] expected; got "
                         f"{tuple(center.shape)}, {tuple(seqs.shape)}")
    if center.dtype != torch.uint8 or seqs.dtype != torch.uint8:
        raise TypeError(f"center and seqs must be uint8; got {center.dtype},"
                        f" {seqs.dtype}")
    if sub_table is not None and (sub_table.shape != (256, 256)
                                  or sub_table.dtype != torch.int32):
        raise ValueError(f"sub_table must be [256, 256] int32; got "
                         f"{sub_table.dtype} {tuple(sub_table.shape)}")
    for t in (seqs, sub_table):
        if t is not None and t.device != center.device:
            raise ValueError(f"inputs on {center.device} and {t.device}")


def nw_matrices_batch_plain(center, seqs, sub_table=None):
    """The plain version of `nw_matrices_batch`, on the inputs' device:
    one row of every pair at a time, the x-chain as a running max
    (msa.py:103-156), over the padded width."""
    m = center.shape[0]
    B, n = seqs.shape
    dev = seqs.device
    GSE = GAP_START + GAP_EXTEND
    jidx = torch.arange(n + 1, dtype=torch.int32, device=dev)
    Ms = torch.empty((m + 1, n + 1, B), dtype=torch.int32, device=dev)
    Mprev = torch.where(jidx == 0, 0, MIN_SCORE).int().expand(B, n + 1)
    Ms[0] = Mprev.T
    Yprev = torch.full((B, n), MIN_SCORE, dtype=torch.int32, device=dev)
    seqs_i = seqs.long()
    # x-chain over v[j] = x[j] - j*GE: v[j] = max(v[j-1], g[j-1] - j*GE),
    # v[0] = MIN_SCORE, with g = GSE + max(dia, y) (GSE <= GE lets the
    # x-term of M absorb); slot a holds cell j = a+1
    decay = (jidx[1:] + 1) * GAP_EXTEND
    neg = torch.full((B, 1), MIN_SCORE, dtype=torch.int32, device=dev)
    for i in range(m):
        ci = center[i]
        if sub_table is None:
            sub = torch.where(seqs == ci, MATCH, MISMATCH)
        else:
            sub = sub_table[ci.long()][seqs_i]
        dia = Mprev[:, :-1] + sub
        y = torch.maximum(GSE + Mprev[:, 1:], GAP_EXTEND + Yprev)
        g = GSE + torch.maximum(dia, y)
        cm = torch.cummax(g - decay, 1).values
        v = torch.cat([neg, cm[:, :-1]], 1).clamp_min_(MIN_SCORE)
        x = v + jidx[1:] * GAP_EXTEND
        Mrow = torch.maximum(torch.maximum(dia, x), y)
        Mprev = torch.cat([neg, Mrow], 1)
        Ms[i + 1] = Mprev.T
        Yprev = y
    return Ms.permute(2, 0, 1)


def compact_table(center, seqs, sub_table):
    """(center codes [m] uint8, seqs codes [B, n_pad] uint8, [A, A] int32
    table) over the A bytes that occur in the call: every byte of center
    and seqs, padding and bytes the matrix does not name included (those
    score 0, as in the [256, 256] table)."""
    alpha = torch.unique(torch.cat([center, seqs.reshape(-1)]))
    lut = torch.zeros(256, dtype=torch.uint8, device=center.device)
    lut[alpha.long()] = torch.arange(alpha.numel(), device=center.device,
                                     dtype=torch.uint8)
    a = alpha.long()
    return (lut[center.long()], lut[seqs.long()],
            sub_table[a][:, a].contiguous())


def nw_matrices_batch(center: torch.Tensor, seqs: torch.Tensor,
                      sub_table: torch.Tensor | None = None) -> torch.Tensor:
    """center: [m] uint8 bytes; seqs: [B, n_pad] uint8 (0 = pad).
    sub_table: optional [256, 256] int32 char-indexed scores (protein
    matrices via core.submat; default MATCH/MISMATCH DNA scoring).
    Returns M: [B, m+1, n_pad+1] int32 (nw.cc matrix), on the inputs'
    device, stored pair-innermost (on the card a view of [m+1, n_pad+1,
    P] storage, P = B rounded up to a multiple of FILL_PAIRS).  The plain
    version computes the padded width; the kernel fills each pair only to
    its own length (the last column not 0) — callers read each pair's own
    n+1 columns."""
    _check_pairs(center, seqs, sub_table)
    if on_cpu(center):
        return nw_matrices_batch_plain(center, seqs, sub_table)
    return launch_fill(fill_args(center, seqs, sub_table))


def fill_args(center, seqs, sub_table) -> tuple:
    """The fill kernel's arguments for checked inputs on the card, in the
    order of `msa_nw_launch` but the stream, then the call's pair count
    B: the center's and the sequences' bytes (compact codes under a
    table), the sequences transposed to [n_pad, P], each row's length (to
    its last nonzero byte), the table and its side A (None, 0 for DNA),
    the [m+1, n_pad+1, P] matrices, m, n_pad, P, B.  P is B rounded up to
    whole sectors (FILL_PAIRS): the pads are pairs of length 0, so that
    each (i, j)'s 8-pair groups start on a 32-byte boundary."""
    m = center.shape[0]
    B, n = seqs.shape
    dev = center.device
    P = -(-B // FILL_PAIRS) * FILL_PAIRS
    seqs = torch.cat([seqs, seqs.new_zeros((P - B, n))])
    cols = torch.arange(n + 1, dtype=torch.int32, device=dev)
    slens = torch.where(torch.cat([seqs.new_ones((P, 1)), seqs], 1) != 0,
                        cols, 0).amax(1)
    table, A = None, 0
    if sub_table is not None:
        center, seqs, table = compact_table(center, seqs, sub_table)
        A = table.shape[0]
    M = torch.empty((m + 1, n + 1, P), dtype=torch.int32, device=dev)
    return (center.contiguous(), seqs.T.contiguous(),
            slens.to(torch.int32).contiguous(), table, A, M, m, n, P, B)


def launch_fill(args: tuple) -> torch.Tensor:
    """Launch csrc/msa_nw.cu's fill on `fill_args` (B > 0 launches) and
    count it; returns M as the [B, m+1, n_pad+1] view of its [m+1,
    n_pad+1, P] storage."""
    M, B = args[5], args[9]
    if B:
        _build.launch("msa_nw", "msa_nw_launch", _FILL_ARGS, M.device,
                      *args[:9])
        LAUNCHES["msa_nw.fill"] += 1
    return M.permute(2, 0, 1)[:B]


# ---------------------------------------------------------------------------
# backtrack (nw.cc:96-150)
# ---------------------------------------------------------------------------


def backtrack_batch_plain(Ms, cenc, seqs, slens, sub_table=None, stats=None):
    """The plain version of `backtrack_batch`, on the inputs' device: one
    step of every unfinished pair at a time (msa.py:160-222).  A pair
    that finds no run at any k stops (no matrix of `nw_matrices_batch`
    leads there).  `stats`, a dict, receives the steps taken, the matrix
    words a one-thread-a-pair walk reads (`reads`: the start's, then at
    each step the diagonal's where i, j > 0 and, without a diagonal step,
    each k's vertical word (i >= k) and horizontal word (j >= k) up to the
    hit, the horizontal one at the hit only where the vertical one
    missed), and what csrc/msa_nw.cu's rounds take: `rounds` summed over
    the pairs and `max_rounds` of one pair (a run of r diagonal steps
    takes r // BACKTRACK_DIAG + 1 rounds where a gap follows, the last
    of them also taking a gap of k = 1, and ceil(r / BACKTRACK_DIAG)
    where the walk ends; a gap of k >= 2 then takes ceil((k - 1) /
    BACKTRACK_RUN) rounds more, a search that finds none ceil((max(i, j)
    - 1) / BACKTRACK_RUN)) and the words those rounds load (`loaded`:
    the start's; a diagonal round's lane t, for t <= min(i, j), its
    diagonal word where t < min(i, j) and its k = 1 vertical and
    horizontal words inside the matrix; each gap round's vertical and
    horizontal words inside it)."""
    B, m1, n1 = Ms.shape
    dev = Ms.device
    n_diag, n_run = BACKTRACK_DIAG, BACKTRACK_RUN
    space = torch.zeros((B, m1), dtype=torch.int32, device=dev)
    so = torch.zeros((B, n1), dtype=torch.int32, device=dev)
    i = torch.full((B,), m1 - 1, dtype=torch.int64, device=dev)
    j = slens.long().clone()
    cur = Ms[torch.arange(B, device=dev), i, j]
    cenc, seqs = cenc.long(), seqs.long()
    steps, reads = 0, B
    # each pair's rounds and words loaded; its diagonal steps since its
    # last gap and min(i, j) where they began
    rounds = torch.zeros(B, dtype=torch.int64, device=dev)
    loaded = torch.ones(B, dtype=torch.int64, device=dev)
    streak = torch.zeros(B, dtype=torch.int64, device=dev)
    smin = torch.zeros(B, dtype=torch.int64, device=dev)
    while True:
        live = ((i != 0) | (j != 0)).nonzero().flatten()
        if live.numel() == 0:
            break
        bi, bj, Mij = i[live], j[live], cur[live]
        steps += live.numel()
        fresh = live[streak[live] == 0]
        smin[fresh] = torch.minimum(i[fresh], j[fresh])
        ci = cenc[(bi - 1).clamp_min(0)]
        sj = seqs[live, (bj - 1).clamp_min(0)]
        s = (torch.where(ci == sj, MATCH, MISMATCH) if sub_table is None
             else sub_table[ci, sj])
        inner = (bi > 0) & (bj > 0)
        d = Ms[live, (bi - 1).clamp_min(0), (bj - 1).clamp_min(0)]
        diag = inner & (s + d == Mij)
        reads += int(inner.sum())
        ni, nj, ncur = bi - 1, bj - 1, d
        streak[live[diag]] += 1
        g = (~diag).nonzero().flatten()
        if g.numel():
            # the least k of a vertical or a horizontal run; vertical
            # first at equal k (the JAX kv <= kh)
            gb, gi, gj, gM = live[g], bi[g], bj[g], Mij[g]
            K = int(torch.maximum(gi, gj).max())
            ks = torch.arange(1, K + 1, device=dev)
            run = GAP_START + GAP_EXTEND * ks
            col = Ms[gb[:, None], (gi[:, None] - ks).clamp_min(0), gj[:, None]]
            row = Ms[gb[:, None], gi[:, None], (gj[:, None] - ks).clamp_min(0)]
            vert = (ks <= gi[:, None]) & (col + run == gM[:, None])
            horiz = (ks <= gj[:, None]) & (row + run == gM[:, None])
            kv = torch.where(vert, ks, K + 1).amin(1)
            kh = torch.where(horiz, ks, K + 1).amin(1)
            use_v = kv <= kh
            k = torch.minimum(kv, kh)
            found = k <= K
            v, h = found & use_v, found & ~use_v
            so[gb[v], gj[v]] += k[v].int()
            space[gb[h], gi[h]] += k[h].int()
            gi2 = torch.where(v, gi - k, torch.where(h, gi, 0))
            gj2 = torch.where(h, gj - k, torch.where(v, gj, 0))
            ni[g], nj[g] = gi2, gj2
            ncur[g] = Ms[gb, gi2, gj2]
            reads += int((torch.minimum(gi, k) + torch.minimum(gj, k - 1)
                          + h.long())[found].sum())
            # the rounds: the diagonal run's, its failing one included
            # (which tests k = 1 too: a lane's diagonal word, and its
            # vertical and horizontal words at k = 1, to the cell t steps
            # down the diagonal), then gap rounds from k = 2 up to the hit
            # or past max(i, j)
            q = streak[gb] // n_diag + 1
            a, off = smin[gb], (gi != gj).long()
            ends = torch.where(found, k, torch.maximum(gi, gj))
            span = -(-(ends - 1) // n_run) * n_run
            rounds[gb] += q + span // n_run
            loaded[gb] += (2 * torch.minimum(a, q * n_diag)
                           + torch.minimum(a + off, q * n_diag)
                           + torch.minimum(gi, span + 1) - gi.clamp(max=1)
                           + torch.minimum(gj, span + 1) - gj.clamp(max=1))
            streak[gb] = 0
        i[live], j[live], cur[live] = ni, nj, ncur
    # each walk's last diagonal run, ending at (0, 0): three words a step
    rounds += -(-streak // n_diag)
    loaded += 3 * streak
    if stats is not None:
        stats["steps"], stats["reads"] = steps, reads
        stats["rounds"], stats["loaded"] = int(rounds.sum()), int(loaded.sum())
        stats["max_rounds"] = int(rounds.max()) if B else 0
    return space, so


def backtrack_batch(Ms: torch.Tensor, cenc: torch.Tensor, seqs: torch.Tensor,
                    slens: torch.Tensor, sub_table: torch.Tensor | None = None):
    """Batched backtrack of nw.cc:96-150 (the reference runs it on the
    device too: cuda_backtrack_3d, CDP/STAR/cuda-nw.cu:219-249): each
    pair's walk from (m, slen) prefers the diagonal, then the least k of
    a vertical or a horizontal gap run (vertical first at equal k), and
    adds k to so[j] (vertical) or space[i] (horizontal).

    Ms: [B, m+1, n_pad+1] int32 from `nw_matrices_batch`; cenc: [m] uint8;
    seqs: [B, n_pad] uint8; slens: [B] int32; sub_table as there.
    Returns ONLY the gap counts (space [B, m+1], so [B, n_pad+1] int32),
    on the inputs' device.  The kernel reads the matrices in place where
    they are stored pair-innermost (as `nw_matrices_batch` stores them)."""
    _check_pairs(cenc, seqs, sub_table)
    B, m1, n1 = Ms.shape
    if m1 != cenc.shape[0] + 1 or n1 != seqs.shape[1] + 1 or \
            seqs.shape[0] != B or slens.shape != (B,):
        raise ValueError(f"Ms [B, m+1, n_pad+1], cenc [m], seqs [B, n_pad] "
                         f"and slens [B] expected; got {tuple(Ms.shape)}, "
                         f"{tuple(cenc.shape)}, {tuple(seqs.shape)}, "
                         f"{tuple(slens.shape)}")
    if Ms.dtype != torch.int32 or slens.dtype != torch.int32:
        raise TypeError(f"Ms and slens must be int32; got {Ms.dtype}, "
                        f"{slens.dtype}")
    for t in (Ms, slens):
        if t.device != cenc.device:
            raise ValueError(f"inputs on {cenc.device} and {t.device}")
    if on_cpu(cenc):
        return backtrack_batch_plain(Ms, cenc, seqs, slens, sub_table)
    return launch_backtrack(backtrack_args(Ms, cenc, seqs, slens, sub_table))


def backtrack_args(Ms, cenc, seqs, slens, sub_table) -> tuple:
    """The backtrack kernel's arguments for checked inputs on the card, in
    the order of `msa_nw_backtrack_launch` but the stream: the matrices'
    [m+1, n_pad+1, P] storage, the center's and the sequences' bytes
    (compact codes under a table, the sequences as [n_pad, B]), the
    lengths, the table and its side (None, 0 for DNA), the zeroed space
    [B, m+1] and so [B, n_pad+1], m, n_pad, M's pair pitch P and the
    pair count B.  Where Ms is the view `nw_matrices_batch` hands out, P
    is its storage's pitch (B padded to whole sectors) and the storage is
    read in place; the kernel walks the B pairs only.  Else P = B, the
    matrices copied where they are not stored [m+1][n_pad+1][B]."""
    B, m1, n1 = Ms.shape
    dev = Ms.device
    P = Ms.stride(2)
    if 0 < B < P and Ms.stride() == (1, n1 * P, P):
        store = torch.as_strided(Ms, (m1, n1, P), (n1 * P, P, 1))
    else:
        P = B
        store = Ms.permute(1, 2, 0).contiguous()
    table, A = None, 0
    if sub_table is not None:
        cenc, seqs, table = compact_table(cenc, seqs, sub_table)
        A = table.shape[0]
    return (store, cenc.contiguous(), seqs.T.contiguous(),
            slens.contiguous(), table, A,
            torch.zeros((B, m1), dtype=torch.int32, device=dev),
            torch.zeros((B, n1), dtype=torch.int32, device=dev),
            m1 - 1, n1 - 1, P, B)


def launch_backtrack(args: tuple):
    """Launch csrc/msa_nw.cu's backtrack on `backtrack_args` (B > 0
    launches) and count it; returns (space [B, m+1], so [B, n_pad+1])."""
    if args[11]:
        _build.launch("msa_nw", "msa_nw_backtrack_launch", _BACKTRACK_ARGS,
                      args[0].device, *args)
        LAUNCHES["msa_nw.backtrack"] += 1
    return args[6], args[7]


def backtrack(M: np.ndarray, center: str, seq: str, sub_table=None):
    """nw.cc:96-150: diag-preferred walk with k-run gap matching.
    Returns (space [m+1], space_for_other [n+1]) gap counts."""
    m, n = len(center), len(seq)
    space = np.zeros(m + 1, np.int64)
    so = np.zeros(n + 1, np.int64)
    i, j = m, n
    while i != 0 or j != 0:
        if sub_table is not None and i > 0 and j > 0:
            s = int(sub_table[ord(center[i - 1]), ord(seq[j - 1])])
        else:
            s = MATCH if (i > 0 and j > 0 and center[i - 1] == seq[j - 1]) else MISMATCH
        if i > 0 and j > 0 and s + M[i - 1][j - 1] == M[i][j]:
            i -= 1
            j -= 1
        else:
            k = 1
            while True:
                if i >= k and M[i][j] == M[i - k][j] + GAP_START + GAP_EXTEND * k:
                    so[j] += k
                    i -= k
                    break
                elif j >= k and M[i][j] == M[i][j - k] + GAP_START + GAP_EXTEND * k:
                    space[i] += k
                    j -= k
                    break
                else:
                    k += 1
    return space, so


# ---------------------------------------------------------------------------
# driver + output merge (main.cu)
# ---------------------------------------------------------------------------


def pairs_per_call(dev: torch.device, m: int, n_pad: int) -> int:
    """Pairs whose matrices and gap counts fit in FREE_SHARE of the
    card's free memory (what the caching allocator holds unused
    counts as free); every pair on the CPU."""
    if dev.type == "cpu":
        return 1 << 62
    free = (torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev)
            - torch.cuda.memory_allocated(dev))
    per_pair = 4 * ((m + 1) * (n_pad + 1) + m + n_pad + 2) + 3 * n_pad
    fits = int(FREE_SHARE * free) // per_pair
    # whole sector groups: the fill pads a call to a multiple of FILL_PAIRS
    return max(1, fits - fits % FILL_PAIRS if fits >= FILL_PAIRS else fits)


def gap_counts(cenc: np.ndarray, arr: np.ndarray, slens: np.ndarray,
               sub_table, dev: torch.device):
    """(space [B, m+1], so [B, n_pad+1]) int64 of every pair on `dev`: the
    matrices and the backtrack in calls of `pairs_per_call` pairs."""
    B, n_pad = arr.shape
    space = np.zeros((B, len(cenc) + 1), np.int64)
    so = np.zeros((B, n_pad + 1), np.int64)
    c = torch.from_numpy(cenc).to(dev)
    step = pairs_per_call(dev, len(cenc), n_pad)
    for lo in range(0, B, step):
        a = torch.from_numpy(arr[lo:lo + step]).to(dev)
        sl = torch.from_numpy(slens[lo:lo + step]).to(dev)
        Ms = nw_matrices_batch(c, a, sub_table)
        sp, so_c = backtrack_batch(Ms, c, a, sl, sub_table)
        del Ms
        space[lo:lo + step] = sp.cpu().numpy()
        so[lo:lo + step] = so_c.cpu().numpy()
    return space, so


def pack_pairs(seqs: list[str], center_idx: int):
    """The pairs of `msa`: the center's bytes [m] uint8, the other
    sequences' [B, n_pad] uint8 (0 pads; n_pad at least 1) and their
    lengths [B] int32, in input order."""
    others = [s for k, s in enumerate(seqs) if k != center_idx]
    n_pad = max((len(s) for s in others), default=1)
    arr = np.zeros((len(others), n_pad), np.uint8)
    for k, s in enumerate(others):
        arr[k, : len(s)] = np.frombuffer(s.encode(), np.uint8)
    cenc = np.frombuffer(seqs[center_idx].encode(), np.uint8).copy()
    return cenc, arr, np.array([len(s) for s in others], np.int32)


def msa(seqs: list[str], center_idx: int | None = None,
        matrix_path: str | None = None, device="cuda", mesh=None):
    """Center-star MSA on `device` (the card unless told).  Returns
    (aligned list[str] in input order, center_idx).  matrix_path: optional
    NCBI scoring matrix (the STAR `-p scoring/BLOSUM62.txt` protein
    mode).

    mesh: optional `parallel.mesh.DataMesh`: the non-center sequences are
    split in blocks over its ranks, each rank fills and backtracks its own
    on the mesh's device, and the gap counts are all-gathered (the
    multi_gpu_msa analog, CDP/STAR/cuda-nw.cu:358-431); every rank returns
    the same rows as without a mesh."""
    dev = mesh.device if mesh is not None else checked_device(device)
    sub_table = None
    if matrix_path:
        sub_table = torch.from_numpy(load_scoring_matrix(matrix_path)).to(dev)
    if center_idx is None:
        center_idx = find_center_sequence(seqs)
    center = seqs[center_idx]
    others = [s for k, s in enumerate(seqs) if k != center_idx]
    m = len(center)
    max_len = max(len(s) for s in seqs)
    cenc, arr, slens = pack_pairs(seqs, center_idx)
    # only the [B, m+1] / [B, n+1] gap counts come back to the host,
    # never the O(B·m·n) matrices
    if mesh is None:
        space, so_pad = gap_counts(cenc, arr, slens, sub_table, dev)
    else:
        lo, hi = mesh.block(len(arr))
        space, so_pad = (multihost.fetch(torch.from_numpy(x).to(dev))
                         for x in gap_counts(cenc, arr[lo:hi], slens[lo:hi],
                                             sub_table, dev))
    so = np.zeros((len(others), max_len + 1), np.int64)
    so[:, : so_pad.shape[1]] = so_pad[:, : max_len + 1]

    # output merge (main.cu:90-140)
    space_center = space.max(axis=0) if len(others) else np.zeros(m + 1, np.int64)
    aligned_center = center
    for pos in range(m, -1, -1):
        if space_center[pos] > 0:
            aligned_center = (
                aligned_center[:pos] + "-" * int(space_center[pos]) + aligned_center[pos:]
            )
    any_center_gaps = bool(space_center.any())
    out = []
    for k, s in enumerate(others):
        a = s
        # fast paths: substitution-only alignments (the common case)
        # have no gap insertions at all — skip the per-position scans
        if so[k].any():
            for pos in range(len(s), -1, -1):
                if so[k, pos] > 0:
                    a = a[:pos] + "-" * int(so[k, pos]) + a[pos:]
        if any_center_gaps:
            shift = 0
            for pos in range(m + 1):
                num = int(space_center[pos] - space[k, pos])
                if num > 0:
                    a = a[: pos + shift] + "-" * num + a[pos + shift :]
                shift += int(space_center[pos])
        out.append(a)
    out.insert(center_idx, aligned_center)
    return out, center_idx


def run_file(input_path: str, output_path: str | None = None,
             device="cuda"):
    """The STAR app over a FASTA file: `msa` on `device` with DNA scoring,
    as the JAX package's run_file, the aligned rows written as FASTA, 60
    columns a line."""
    recs = read_fasta(input_path)
    aligned, center_idx = msa([r.seq for r in recs], device=device)
    if output_path:
        with open(output_path, "w") as fh:
            for r, a in zip(recs, aligned):
                fh.write(f">{r.name}\n")
                for i in range(0, len(a), 60):
                    fh.write(a[i : i + 60] + "\n")
    return aligned, center_idx
