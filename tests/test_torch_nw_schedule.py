"""The schedule of csrc/nw_app.cu, emulated in numpy on the CPU: one
launch per diagonal of kTile x kTile tiles, one warp a tile, thread t of
a tile owning its row t and computing column s - t at step s.  The
emulation stamps every cell of the output with the launch that wrote it
and every cell of a tile with the step that computed it, and shows that a
tile reads from global memory only cells that tiles of earlier diagonals
wrote (its edges), and that a step reads from the shared tile only cells
of earlier steps; its matrix equals the gold and the plain version at
sizes around the tile's edges.  The kernel itself runs only on the card
(tests/test_torch_cuda.py holds it to the plain version)."""
import re

import numpy as np
import pytest
import torch

from genomics_tpu_torch import _build
from genomics_tpu_torch.core import golds
from genomics_tpu_torch.models import nw

MATCH, MISMATCH, INS, DEL = 1, -1, -1, -1


def _tile_side() -> int:
    src = (_build.CSRC / "nw_app.cu").read_text()
    return int(re.search(r"constexpr int kTile = (\d+);", src).group(1))


def _emulate(ref, qry, T):
    """nw_app_launch's launches over N = len(ref): returns (out, the
    number of launches)."""
    N = len(ref)
    nt = -(-N // T)
    out = np.zeros((N, N), np.int64)
    written = np.full((N, N), -1)   # the launch that wrote each cell

    def read(q, r, d):
        assert 0 <= written[q, r] < d, (q, r, d, written[q, r])
        return out[q, r]

    launches = 0
    for d in range(2 * nt - 1):
        launches += 1
        for a in range(max(0, d - nt + 1), min(d, nt - 1) + 1):
            b = d - a
            q0, r0 = a * T, b * T
            t = np.arange(T)
            q, r = q0 + t, r0 + t
            # the edges, from global memory or the boundary
            top = np.zeros(T + 1, np.int64)
            for c in range(T):
                if q0 == 0:
                    top[1 + c] = (r[c] + 1) * DEL
                elif r[c] < N:
                    top[1 + c] = read(q0 - 1, r[c], d)
            if r0 == 0:
                top[0] = q0 * INS
            elif q0 == 0:
                top[0] = r0 * DEL
            else:
                top[0] = read(q0 - 1, r0 - 1, d)
            left_edge = np.zeros(T, np.int64)
            for k in range(T):
                if r0 == 0:
                    left_edge[k] = (q[k] + 1) * INS
                elif q[k] < N:
                    left_edge[k] = read(q[k], r0 - 1, d)
            rseg = np.where(r < N, ref[np.minimum(r, N - 1)], 0)
            qc = np.where(q < N, qry[np.minimum(q, N - 1)], 0)
            tile = np.zeros((T, T), np.int64)
            step_of = np.full((T, T), -1)
            left = left_edge.copy()
            for s in range(2 * T - 1):
                for th in range(T):
                    c = s - th
                    if not 0 <= c < T:
                        continue
                    if th == 0:
                        up, dg = top[c + 1], top[c]
                    else:
                        assert 0 <= step_of[th - 1, c] < s
                        up = tile[th - 1, c]
                        if c == 0:
                            dg = left_edge[th - 1]
                        else:
                            assert 0 <= step_of[th - 1, c - 1] < s
                            dg = tile[th - 1, c - 1]
                    sub = MATCH if rseg[c] == qc[th] else MISMATCH
                    v = max(up + INS, dg + sub, left[th] + DEL)
                    tile[th, c], step_of[th, c] = v, s
                    left[th] = v
            rows = min(T, N - q0)
            cols = min(T, N - r0)
            out[q0:q0 + rows, r0:r0 + cols] = tile[:rows, :cols]
            written[q0:q0 + rows, r0:r0 + cols] = d
    assert (written >= 0).all()
    return out, launches


@pytest.mark.parametrize("N,T", [(1, None), (9, None), (33, None),
                                 (70, None), (23, 8)])
def test_tile_schedule_reads_only_earlier_diagonals(N, T):
    T = T or _tile_side()
    rng = np.random.default_rng(N)
    ref = rng.integers(0, 4, N).astype(np.uint8)
    qry = nw.generate_query(ref, rng) % 4
    got, launches = _emulate(ref, qry, T)
    assert launches == 2 * -(-N // T) - 1
    if T == nw.TILE:
        assert launches == nw.tile_launches(N)
    np.testing.assert_array_equal(got, golds.nw_cpu(ref, qry))
    np.testing.assert_array_equal(
        got, nw.nw_matrix(torch.from_numpy(ref), torch.from_numpy(qry)).numpy())


def test_tile_side_is_the_wrappers():
    assert _tile_side() == nw.TILE
