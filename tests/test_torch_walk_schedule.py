"""The schedule of csrc/tb_walk.cu, emulated in numpy on the CPU: the
window of the cube's words a walk holds (columns j0 .. j0 - K + 1 in word
rows r0 and r0 - 1, or only each column's diagonal word), where it is
refilled, the pairs a thread takes from the counter after its first, the
run-length encode inside the walk and GLOBAL's and SEMI_GLOBAL's pads.
The emulation stands in for the kernel behind `_build.launch`, so the
wrapper's launch helpers (`walk_launch_args`, `launch_walk`) run as on the
card; it is held byte for byte to the plain version (`tb_walk_plain` and
`cigars_from_walk`) and to the native decoder native/cigar.cpp, which the
JAX package's engine runs, for all three algorithms, every SEMI_GLOBAL
head, DP cubes and cubes made to reach each edge: runs of 63, 64 and 126
ops, pads of 63 and 64, a LOCAL stop on the first step, walks with no
step, walks that start outside the cube, D runs across a word row inside
the window, I runs longer than the window, walks that leave the cube in
the middle of a window.  JAX is imported only for the reference.  The
kernel itself runs only on the card (tests/test_torch_cuda.py holds it to
the plain version)."""
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from genomics_tpu.core.scoring import AlgoType as JAlgo
from genomics_tpu.core.scoring import AlignmentParams as JParams
from genomics_tpu.runtime import native
from genomics_tpu.runtime.dispatch import _pack_nibbles_np
from genomics_tpu_torch import _build
from genomics_tpu_torch.core.scoring import (
    AlgoType,
    SemiGlobalSkip,
    params_from_jax,
)
from genomics_tpu_torch.ops import tb_walk
from genomics_tpu_torch.ops.scan_align import (
    global_align_batch,
    local_align_batch,
    semiglobal_align_batch,
)
from genomics_tpu_torch.runtime.dispatch import walk_start

ACGT = np.array([1, 3, 7, 4], np.uint8)
N4 = 14
D, I, D_EXT, I_EXT = 2, 3, 4, 8   # a nibble's direction and extension bits


def _source_constants():
    src = (_build.CSRC / "tb_walk.cu").read_text()
    c = dict(re.findall(r"constexpr (?:int|bool) (k\w+) = (\w+);", src))
    return (int(c["kWindow"]), c["kDiagonal"] == "true",
            c["kAdaptive"] == "true")


WINDOW, DIAGONAL, ADAPTIVE = _source_constants()
# (K, diagonal words only, windows sized by use, threads taking pairs from
# a counter): the source's schedule, then the variants
# tools/kernel_variants.py times (tools/tb_walk_registers.cu and
# tb_walk_lanes.cu take pairs from a counter)
SCHEDULES = [(WINDOW, DIAGONAL, ADAPTIVE, None),
             (WINDOW, DIAGONAL, ADAPTIVE, 7), (4, False, False, None),
             (16, False, True, 5), (8, True, False, None),
             (32, True, True, 3), (8, False, not ADAPTIVE, None)]
SCHEDULE_IDS = [f"K{k}-{'diag' if d else 'rows2'}-"
                f"{'adapt' if a else 'fixed'}-"
                f"{'counter' if t else 'static'}"
                for k, d, a, t in SCHEDULES]


class Stats:
    """What the emulated walks went through, to show each edge was met."""

    def __init__(self):
        self.refills = 0
        self.loads = 0
        self.d_across_rows = 0     # a D step into the window's lower row
        self.longest_i_run = 0
        self.left_mid_window = 0   # a walk that ended before the window's end
        self.shrunk = 0            # windows sized below K
        self.order = []


def _walk_pair(cube, b, i, j, total, local, p, K, diag, adaptive, stats):
    """One thread's walk of pair b, as tb_walk.cu's walk_pair runs it:
    (bytes, final i, final j)."""
    Lt8, Lq, _ = cube.shape
    T = Lq + Lt8 * 8

    def word(r, c):
        return int(cube[r, c, b]) & 0xFFFFFFFF if (
            0 <= r < Lt8 and 0 <= c < Lq) else 0

    op_shift, op_select, curr, prev, run, steps, i_run = 0, 3, 0, 0, 0, 0, 0
    out = []
    active = i >= 0 and j >= 0
    n = K
    while active:
        i0, r0, j0 = i, i >> 3, j
        stats.refills += 1
        w0 = [word((i0 - k) >> 3 if diag else r0, j0 - k) if k < n else 0
              for k in range(K)]
        w1 = [0 if diag or k >= n else word(r0 - 1, j0 - k)
              for k in range(K)]
        stats.loads += n if diag else 2 * n
        used = 0
        for k in range(K):
            if k == n:
                break
            while active:
                if diag:
                    if (i >> 3) != ((i0 - k) >> 3):
                        break
                    w = w0[k]
                else:
                    rr = r0 - (i >> 3)
                    if rr > 1:
                        break
                    w = w1[k] if rr else w0[k]
                    stats.d_across_rows += rr == 1 and prev == D
                cell = (w >> (4 * (i & 7))) & 0xF
                op = (cell >> op_shift) & op_select
                fill = op if (op == 0 or op_select == 3) else op_shift
                reset = op == 0 or (op == 1 and op_select == 3)
                to_gap = op >= 2 and op_select == 3
                op_shift = 0 if reset else (op if to_gap else op_shift)
                op_select = 3 if reset else 1
                if fill == prev and run < 63:
                    run += 1
                else:
                    if run:
                        out.append(prev | run << 2)
                    run = 1
                i_run = i_run + 1 if fill == I else 0
                stats.longest_i_run = max(stats.longest_i_run, i_run)
                steps += 1
                if local:
                    if fill >= 2:
                        curr -= p.gap_oe if prev != fill else p.gap_extend
                    else:
                        curr += -p.mismatch if fill == 1 else p.match
                    if curr == total:
                        prev = fill
                        active = False
                        break
                prev = fill
                i -= fill != 3
                j -= fill != 2
                active = i >= 0 and j >= 0 and steps < T
                if fill != 2:
                    break
            if not active or j != j0 - k - 1:
                stats.left_mid_window += not active and k < n - 1
                break
            used = k + 1
        if adaptive:
            n = min(K, max(1, 2 * used))
            stats.shrunk += n < K
    if run:
        out.append(prev | run << 2)
    return out, i, j


def _emulate(args, K, diag, adaptive, threads, stats):
    """tb_walk_launch on CPU tensors: every pair's walk, the pairs taken
    as the kernel's threads take them, the outputs written as the kernel
    writes them (whole 4-byte words up to n_ops, zeros past it in the
    last)."""
    (algo, pad_d, pad_i, tb, score, qend, tend, B, Lq, Lt8, width, match,
     mismatch, goe, ge, cigars, n_ops, qstart, tstart) = args
    assert width % 4 == 0
    assert tb.shape == (Lt8, Lq, B) and tb.is_contiguous()
    local = algo == 0
    pad_d, pad_i = algo == 1 or pad_d, algo == 1 or pad_i

    p = SimpleNamespace(match=match, mismatch=mismatch, gap_oe=goe,
                        gap_extend=ge)
    cube = tb.numpy()
    if threads is None:
        order = list(range(B))
    else:
        # thread t takes pair t, then whichever thread is done first takes
        # the next pair from the counter
        clock = [0] * min(threads, B)
        order, todo = [], list(range(len(clock)))
        queue = list(range(len(clock)))
        nxt_pair = len(clock)
        while queue:
            t = min(queue, key=lambda x: (clock[x], x))
            b = todo[t]
            order.append(b)
            if b < 0:
                queue.remove(t)
                continue
            clock[t] += 1 + abs(int(qend[b])) + abs(int(tend[b])) % 7
            todo[t] = nxt_pair if nxt_pair < B else -1
            nxt_pair += 1
        order = [b for b in order if b >= 0]
    assert sorted(order) == list(range(B))
    stats.order = order
    for b in order:
        out, i, j = _walk_pair(cube, b, int(tend[b]), int(qend[b]),
                               int(score[b]) if local else 0, local, p, K,
                               diag, adaptive, stats)
        if not local:
            for op, n in ((D, i + 1 if pad_d else 0),
                          (I, j + 1 if pad_i else 0)):
                while n > 0:
                    out.append(op | min(n, 63) << 2)
                    n -= 63
        assert len(out) <= width
        row = np.zeros((len(out) + 3) // 4 * 4, np.uint8)
        row[:len(out)] = out
        cigars[b, :len(row)] = torch.from_numpy(row)
        n_ops[b] = len(out)
        qstart[b] = j if local else (0 if pad_i else max(j + 1, 0))
        tstart[b] = i if local else (0 if pad_d else max(i + 1, 0))


def _stand_in(K, diag, adaptive, threads, stats):
    def launch(name, symbol, argtypes, device, *args):
        assert (name, symbol) == ("tb_walk", "tb_walk_launch")
        assert argtypes == tb_walk._ARGS and len(args) + 1 == len(argtypes)
        _emulate(args, K, diag, adaptive, threads, stats)
    return launch


def _walk(monkeypatch, schedule, tb, score, qend, tend, p, algo, head_q=False,
          head_t=False):
    """(cigars, n_ops, qstart, tstart, stats) of the wrapper's launch with
    the emulation behind it; cigars start as garbage, as torch.empty's
    may."""
    stats = Stats()
    monkeypatch.setattr(_build, "launch", _stand_in(*schedule, stats))
    args = tb_walk.walk_launch_args(tb, score, qend, tend, p, algo, head_q,
                                    head_t)
    args[-4].fill_(0xAB)
    key = "tb_walk" if algo == "local" else f"tb_walk.{algo}"
    before = tb_walk.LAUNCHES[key]
    got = tb_walk.launch_walk(args)
    assert tb_walk.LAUNCHES[key] == before + 1
    return (*got, stats)


def _check(got, tb, score, qend, tend, p, jp, algo, head_q=False,
           head_t=False, qlen=None, tlen=None):
    """got against walk_cigars_plain (every row) and the native decoder
    (rows whose walk takes a step: native emits a zero-length run for a
    walk without one)."""
    cig, n, qs, ts = got[:4]
    want = tb_walk.walk_cigars_plain(tb, score, qend, tend, p, algo, head_q,
                                     head_t)
    assert cig.shape == want[0].shape
    assert torch.equal(tb_walk.valid_bytes(cig, n), want[0])
    for g, w in zip((n, qs, ts), want[1:]):
        assert torch.equal(g, w)
    B = tb.shape[2]
    qlen = qend.numpy() if qlen is None else qlen
    tlen = tend.numpy() if tlen is None else tlen
    ncig, nn, nqs, nts = native.decode_tb_batch(
        tb.numpy(), qlen, tlen, algo, jp, score=score.numpy(),
        qend=qend.numpy(), tend=tend.numpy(), head_q=head_q, head_t=head_t,
        layout="sqb", max_ops=cig.shape[1])
    steps = (qend >= 0) & (tend >= 0)
    for b in range(B):
        if not steps[b]:
            continue
        assert int(n[b]) == nn[b], b
        np.testing.assert_array_equal(cig[b, :nn[b]].numpy(), ncig[b, :nn[b]],
                                      err_msg=str(b))
        assert (int(qs[b]), int(ts[b])) == (nqs[b], nts[b]), b
    return int(steps.sum())


def _sqb(nibs):
    """[B, Lt, Lq] nibbles → the [Lt/8, Lq, B] int32 cube."""
    packed = _pack_nibbles_np(nibs.astype(np.uint8))
    return torch.from_numpy(np.ascontiguousarray(packed.transpose(1, 2, 0)))


def _i32(x):
    return torch.tensor(x, dtype=torch.int32)


def _edge_cubes():
    """GLOBAL pairs on an all-M 136 x 136 cube made to hit each edge:
    (nibbles [B, 136, 136], i0, j0, what each pair shows)."""
    L = 136
    cases = [("runs 63, 63, 11 from outside the cube", None, L, L),
             ("an M run of exactly 63", 136 - 63, L, L),
             ("an M run of exactly 64", 136 - 64, L, L),
             ("an M run of exactly 126", 136 - 126, L, L),
             ("a D pad of exactly 63", None, 99, 36),
             ("a D pad of exactly 64", None, 100, 36),
             ("an I pad of exactly 63", None, 36, 99),
             ("an I pad of exactly 64", None, 36, 100),
             ("pads of 127 and 0 (63, 63, 1)", None, 127, 0)]
    nibs = np.zeros((len(cases), L, L), np.uint8)
    for b, (_, x_at, _, _) in enumerate(cases):
        if x_at is not None:
            nibs[b, x_at, x_at] = 1      # an X ends the M run there
    return nibs, [c[2] for c in cases], [c[3] for c in cases], cases


@pytest.mark.parametrize("schedule", SCHEDULES, ids=SCHEDULE_IDS)
def test_schedule_at_the_run_and_pad_edges(monkeypatch, schedule):
    nibs, i0, j0, cases = _edge_cubes()
    jp = JParams(algo=JAlgo.GLOBAL)
    p = params_from_jax(jp)
    tb = _sqb(nibs)
    B = len(cases)
    z = torch.zeros(B, dtype=torch.int32)
    got = _walk(monkeypatch, schedule, tb, z, _i32(j0), _i32(i0), p,
                "global")
    _check(got, tb, z, _i32(j0), _i32(i0), p, jp, "global",
           qlen=np.array(j0, np.int32), tlen=np.array(i0, np.int32))
    cig, n = got[0], got[1]
    runs = [[(int(x) & 3, int(x) >> 2) for x in cig[b, :n[b]]]
            for b in range(B)]
    assert runs[0] == [(0, 63), (0, 63), (0, 11)]
    assert runs[1][:2] == [(0, 63), (1, 1)]
    assert runs[2][:3] == [(0, 63), (0, 1), (1, 1)]
    assert runs[3][:4] == [(0, 63), (0, 63), (1, 1), (0, 10)]
    assert runs[4] == [(0, 37), (2, 63)]
    assert runs[5] == [(0, 37), (2, 63), (2, 1)]
    assert runs[6] == [(0, 37), (3, 63)]
    assert runs[7] == [(0, 37), (3, 63), (3, 1)]
    assert runs[8] == [(0, 1), (2, 63), (2, 63), (2, 1)]


def _biased_cube(rng, B, Lt, Lq, kind):
    """Random nibbles: "uniform", or mostly D or I chains (direction and
    extension bit set), so that D runs cross word rows inside a window and
    I runs outlast it."""
    nibs = rng.integers(0, 16, (B, Lt, Lq)).astype(np.uint8)
    if kind != "uniform":
        chain = (D | D_EXT) if kind == "d_runs" else (I | I_EXT)
        nibs[rng.random(nibs.shape) < 0.8] = chain
    return nibs


@pytest.mark.parametrize("schedule", SCHEDULES, ids=SCHEDULE_IDS)
@pytest.mark.parametrize("kind", ["uniform", "d_runs", "i_runs"])
@pytest.mark.parametrize("algo", ["local", "global", "semiglobal"])
def test_schedule_on_random_cubes_matches_plain_and_native(monkeypatch,
                                                           schedule, kind,
                                                           algo):
    """Random and chain-biased cubes, starts inside and outside the cube
    (GLOBAL's (tlen, qlen) when a pair fills its bucket, SEMI_GLOBAL's
    TAIL_T row qlen past Lt), no step (an end of -1), LOCAL stops on the
    first step, each SEMI_GLOBAL head."""
    rng = np.random.default_rng(len(kind) * 10 + len(algo))
    B, Lt, Lq = 48, 24, 40
    nibs = _biased_cube(rng, B, Lt, Lq, kind)
    tb = _sqb(nibs)
    jp = JParams(algo={"local": JAlgo.LOCAL, "global": JAlgo.GLOBAL,
                       "semiglobal": JAlgo.SEMI_GLOBAL}[algo])
    p = params_from_jax(jp)
    i0 = rng.integers(0, Lt, B).astype(np.int32)
    j0 = rng.integers(0, Lq, B).astype(np.int32)
    i0[:3], j0[:3] = Lt, Lq                  # from outside: exact fit
    i0[3], j0[3] = Lt + 13, 20               # a TAIL_T-style row past Lt
    i0[4], j0[4] = -1, 5                     # no step
    j0[5] = -1
    score = rng.integers(-20, 40, B).astype(np.int32)
    nibs[6, i0[6], j0[6]] = 0                # LOCAL: M, then stop
    score[6] = jp.match
    tb = _sqb(nibs)
    heads = ([(False, False)] if algo != "semiglobal" else
             [(False, False), (True, False), (False, True), (True, True)])
    for head_q, head_t in heads:
        args = (tb, _i32(score), _i32(j0), _i32(i0), p, algo)
        got = _walk(monkeypatch, schedule, *args, head_q, head_t)
        kw = dict(qlen=j0, tlen=i0) if algo == "global" else {}
        assert _check(got, *args[:5], jp, algo, head_q, head_t, **kw) == B - 2
        n, qs, ts = (x.numpy() for x in got[1:4])
        # pair 4 takes no step: no runs, and only the I pad of j0 + 1 = 6
        assert n[4] == (0 if algo == "local" or head_q else 1)
        if algo == "local":
            assert (n[6], qs[6], ts[6]) == (1, j0[6], i0[6])
            assert (qs[4], ts[4]) == (j0[4], i0[4])
    stats = got[4]
    K, diag, adaptive, threads = schedule
    if threads:
        assert stats.order != sorted(stats.order)
    if kind == "d_runs" and not diag:
        assert stats.d_across_rows > 0
    if kind == "i_runs":
        assert stats.longest_i_run > K or K >= 32
    assert stats.left_mid_window > 0
    if adaptive and kind != "uniform":
        assert stats.shrunk > 0


def _dp_cube(algo, head, tail, seed):
    """A DP batch with traceback, its walk start and its lengths."""
    rng = np.random.default_rng(seed)
    B, Lq, Lt = 40, 32, 48
    q = ACGT[rng.integers(0, 4, (B, Lq))]
    t = ACGT[rng.integers(0, 4, (B, Lt))]
    q[::2, :Lq] = t[::2, 4:4 + Lq]
    q[1::4, 10:13] = q[1::4, 13:16]          # indels in some related reads
    ql = rng.integers(1, Lq + 1, B).astype(np.int32)
    tl = rng.integers(1, Lt + 1, B).astype(np.int32)
    ql[0], tl[0] = Lq, Lt
    q[np.arange(Lq)[None, :] >= ql[:, None]] = N4
    t[np.arange(Lt)[None, :] >= tl[:, None]] = N4
    qt, tt, qlt, tlt = (torch.from_numpy(a) for a in (q, t, ql, tl))
    if algo == "local":
        jp = JParams()
        p = params_from_jax(jp)
        res = local_align_batch(qt, tt, p, with_tb=True)
        return res, res.target_end, res.query_end, jp, p, ql, tl
    if algo == "global":
        jp = JParams(algo=JAlgo.GLOBAL)
        p = params_from_jax(jp)
        res = global_align_batch(qt, tt, qlt, tlt, p, with_tb=True)
        return res, tlt, qlt, jp, p, ql, tl
    jp = JParams(algo=JAlgo.SEMI_GLOBAL)
    p = params_from_jax(jp)
    res = semiglobal_align_batch(qt, tt, qlt, tlt, p, head=head, tail=tail,
                                 with_tb=True)
    i0, j0 = walk_start(AlgoType.SEMI_GLOBAL, tail, res, qlt, tlt)
    return res, i0, j0, jp, p, ql, tl


@pytest.mark.parametrize("schedule", SCHEDULES[:2], ids=SCHEDULE_IDS[:2])
@pytest.mark.parametrize("algo,head,tail", [
    ("local", None, None), ("global", None, None),
    ("semiglobal", SemiGlobalSkip.NONE, SemiGlobalSkip.NONE),
    ("semiglobal", SemiGlobalSkip.QUERY, SemiGlobalSkip.QUERY),
    ("semiglobal", SemiGlobalSkip.TARGET, SemiGlobalSkip.TARGET),
    ("semiglobal", SemiGlobalSkip.BOTH, SemiGlobalSkip.BOTH),
], ids=["local", "global", "semi_none", "semi_query", "semi_target",
        "semi_both"])
def test_schedule_on_dp_cubes_matches_plain_and_native(monkeypatch, schedule,
                                                       algo, head, tail):
    res, i0, j0, jp, p, ql, tl = _dp_cube(algo, head, tail, 5)
    head_q = bool(head is not None and head & SemiGlobalSkip.QUERY)
    head_t = bool(head is not None and head & SemiGlobalSkip.TARGET)
    got = _walk(monkeypatch, schedule, res.tb, res.score, j0, i0, p, algo,
                head_q, head_t)
    kw = dict(qlen=ql, tlen=tl) if algo == "global" else {}
    _check(got, res.tb, res.score, j0, i0, p, jp, algo, head_q, head_t, **kw)
    assert (got[1] > 0).all()


def test_source_constants_and_width():
    """The schedule the tests emulate first is the source's; a row holds
    the longest walk's runs and both pads."""
    assert SCHEDULES[0][:3] == (WINDOW, DIAGONAL, ADAPTIVE)
    assert WINDOW >= 2
    src = (_build.CSRC / "tb_walk.cu").read_text()
    assert "tb_walk_kernel<kWindow, kDiagonal, kAdaptive>" in src
    for Lq, Lt in ((8, 16), (152, 152), (216, 328), (1, 8)):
        w = tb_walk.cigar_width(Lq, Lt)
        assert w % 4 == 0
        assert w >= Lq + Lt + 8 + 2 * ((max(Lq, Lt) + 1 + 62) // 63)
