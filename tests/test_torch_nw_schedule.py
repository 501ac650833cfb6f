"""The schedule of csrc/nw_app.cu, emulated in numpy on the CPU: the rows
cut into stripes of 32 kRows rows, one warp a stripe taken from an atomic
ticket, lane t computing column s - t of its kRows rows at step s, the
cells staged in a ring of kRing columns and written out a chunk of kChunk
columns at a time, each chunk published in the stripe's progress flag,
and lane 0 waiting on the flag of the stripe above before the warp loads
the next 32 columns of that stripe's last row, kLead steps before their
use.

The warps run as generators that a seeded random scheduler interleaves
step by step, with fewer resident warps than stripes where a case says
so (the ticket then hands the later stripes to warps that finished).  The
emulation stamps every output cell with the (stripe, chunk) that wrote
it, and shows that a stripe reads only cells of the row above that the
stripe above has written and published, that every value a lane takes
from the lane before it (or lane 0 from the row above) is of the column
it computes, and that a chunk's write-out reads the ring's cells of that
chunk; its matrix equals the gold and the plain version at N = 1, at the
stripe height +- 1 and at a chunk width that does not divide N.  The
kernel itself runs only on the card (tests/test_torch_cuda.py holds it to
the plain version)."""
import re

import numpy as np
import pytest
import torch

from genomics_tpu_torch import _build
from genomics_tpu_torch.core import golds
from genomics_tpu_torch.models import nw

MATCH, MISMATCH, INS, DEL = 1, -1, -1, -1


def _constants() -> dict:
    src = (_build.CSRC / "nw_app.cu").read_text()
    return {k: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
            for k, name in (("rows", "kRows"), ("chunk", "kChunk"),
                            ("ring", "kRing"), ("lead", "kLead"))}


def _emulate(ref, qry, rows, chunk, ring, lead, resident, seed):
    """nw_app_launch's kernel over N = len(ref) with `resident` warps:
    returns (out, each cell's stripe, each cell's chunk, the stripes each
    warp took)."""
    N = len(ref)
    stripe = 32 * rows
    stripes = -(-N // stripe)
    out = np.zeros((N, N), np.int64)
    by_stripe = np.full((N, N), -1)
    by_chunk = np.full((N, N), -1)
    flags = [0] * (stripes + 1)   # the ticket, then each stripe's progress
    t = np.arange(32)

    def warp(taken):
        while True:
            k = flags[0]           # atomicAdd: no yield in between
            flags[0] += 1
            if k >= stripes:
                return
            taken.append(k)
            q0 = k * stripe
            qt = q0 + t * rows
            qc = np.array([[qry[q] if q < N else 0 for q in qt + h]
                           for h in range(rows)]).T   # [32, rows]
            left = np.zeros((32, rows), np.int64)
            staged = np.zeros((stripe, ring), np.int64)
            staged_col = np.full((stripe, ring), -1)

            def wait_for(cols):
                while k > 0 and flags[k] < cols:
                    yield

            def above(c):
                """(M[q0 - 1][c], ref[c], c) for c < N."""
                if c >= N:
                    return (0, 0, -1)
                if q0 == 0:
                    return ((c + 1) * DEL, int(ref[c]), c)
                assert by_stripe[q0 - 1, c] == k - 1 and c < flags[k], (k, c)
                return (int(out[q0 - 1, c]), int(ref[c]), c)

            yield from wait_for(min(32, N))
            cur = [above(c) for c in range(32)]
            nxt = None
            carry = [(0, 0, -1)] * 32       # (M, ref byte, column) a lane
            diag = np.zeros(32, np.int64)
            for s in range(N + 31):
                if s % 32 == 0 and s:
                    cur = nxt
                if s % 32 == 32 - lead and s + lead < N:
                    yield from wait_for(min(s + lead + 32, N))
                    nxt = [above(s + lead + c) for c in range(32)]
                got = [cur[s % 32]] + carry[:31]   # lane 0: the row above
                for lane in range(32):
                    j = s - lane
                    if not 0 <= j < N:
                        continue
                    up0, rc, col = got[lane]
                    assert col == j, (k, s, lane, col)
                    if j == 0:
                        diag[lane] = qt[lane] * INS
                        left[lane] = (qt[lane] + np.arange(rows) + 1) * INS
                    d, up = diag[lane], up0
                    for h in range(rows):
                        sub = MATCH if rc == qc[lane, h] else MISMATCH
                        v = max(d + sub, left[lane, h] + DEL, up + INS)
                        d, left[lane, h], up = left[lane, h], v, v
                        staged[lane * rows + h, j % ring] = v
                        staged_col[lane * rows + h, j % ring] = j
                    diag[lane] = up0
                    carry[lane] = (up, rc, j)
                done = s - 31
                if 0 <= done < N and ((done + 1) % chunk == 0
                                      or done == N - 1):
                    c0 = done - done % chunk
                    for r in range(min(stripe, N - q0)):
                        for c in range(c0, done + 1):
                            assert staged_col[r, c % ring] == c
                            assert by_stripe[q0 + r, c] == -1
                            out[q0 + r, c] = staged[r, c % ring]
                            by_stripe[q0 + r, c] = k
                            by_chunk[q0 + r, c] = c // chunk
                    flags[k + 1] = done + 1
                yield

    rng = np.random.default_rng(seed)
    taken = [[] for _ in range(resident)]
    live = [warp(taken[w]) for w in range(resident)]
    while live:
        w = int(rng.integers(len(live)))
        try:
            next(live[w])
        except StopIteration:
            live.pop(w)
    return out, by_stripe, by_chunk, taken


# (N, rows, chunk, lead, resident warps): N = 1; the stripe's height +- 1
# at the kernel's own constants; stripes of 32 rows with chunks of 16 and
# 8 that do not divide N, the row above loaded 32 and 1 steps ahead, fewer
# resident warps than stripes
CASES = [(1, None, None, None, 1), (-1, None, None, None, 2),
         (+1, None, None, None, 1), (70, 1, 16, None, 2),
         (100, 1, 8, 32, 2), (33, 1, 32, 1, 3), (97, 1, 16, 1, 3)]


@pytest.mark.parametrize("N,rows,chunk,lead,resident", CASES)
def test_stripes_read_only_published_rows(N, rows, chunk, lead, resident):
    const = _constants()
    if N in (-1, +1):   # the kernel's stripe height -+ 1
        N += 32 * const["rows"]
    rows = rows or const["rows"]
    chunk = chunk or const["chunk"]
    lead = lead or const["lead"]
    rng = np.random.default_rng(N)
    ref = rng.integers(0, 4, N).astype(np.uint8)
    qry = nw.generate_query(ref, rng) % 4
    got, by_stripe, by_chunk, taken = _emulate(ref, qry, rows, chunk,
                                               const["ring"], lead, resident,
                                               N)
    stripe = 32 * rows
    q = np.arange(N)
    np.testing.assert_array_equal(by_stripe, np.repeat(q[:, None] // stripe,
                                                       N, 1))
    np.testing.assert_array_equal(by_chunk, np.repeat(q[None, :] // chunk,
                                                      N, 0))
    stripes = -(-N // stripe)
    assert sorted(sum(taken, [])) == list(range(stripes))
    if stripes > resident:   # the ticket gave a warp a second stripe
        assert max(len(x) for x in taken) > 1
    np.testing.assert_array_equal(got, golds.nw_cpu(ref, qry))
    np.testing.assert_array_equal(
        got, nw.nw_matrix(torch.from_numpy(ref), torch.from_numpy(qry)).numpy())


def test_stripe_height_is_the_wrappers():
    const = _constants()
    assert 32 * const["rows"] == nw.STRIPE
    assert const["ring"] >= const["chunk"] + 31 and const["chunk"] % 4 == 0
    assert 1 <= const["lead"] <= 32
    assert nw.flag_words(1) == 2 and nw.flag_words(nw.STRIPE + 1) == 3
    assert [nw.launches_per_call(N) for N in (0, 1, 32768)] == [0, 2, 2]
