"""The schedule of csrc/sw_app.cu, emulated in numpy on the CPU: each
window's rows cut into stripes of kRows rows, one block a stripe taken
from an atomic ticket in stripe-major order, the columns swept in tiles
of kTile (kTile / kThreads columns a thread), each row of a tile a
block-wide max-scan seeded by the row's cell left of the tile, the cell
left of a thread's first column taken from its own exclusive prefix, the
tile's rows written out in 16-byte groups at aligned addresses with
scalar heads and tails, the stripe's last row first and then published
in the stripe's progress flag before the other rows, and the stripe
below waiting on that flag before it reads its row above from H.

The blocks run as generators that a seeded random scheduler interleaves
tile by tile, with fewer resident blocks than stripes where a case says
so (the ticket then hands the later stripes to blocks that finished).
The emulation stamps every cell of H with the (stripe, tile) that wrote
it and asserts that a cell is written once, that a stripe reads only
cells of the row above that the stripe above wrote and published, that
each row's seed is that row's cell at the column left of the tile, and
that a window's best is zeroed before any block folds into it.  H and
best equal the plain version and the JAX `sw_matrix_batch` at n = 0 and
1, n at a stripe's height +- 1, L at a tile's width +- 1 and below it,
one window, windows shorter than L and a planted copy across a tile's
edge.  The kernel itself runs only on the card (tests/test_torch_cuda.py
holds it to the plain version)."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import sw_stripe_edges
from genomics_tpu.models import sw as jsw
from genomics_tpu_torch import _build
from genomics_tpu_torch.models import sw

UNSET = np.iinfo(np.int64).min


def _constants() -> dict:
    src = (_build.CSRC / "sw_app.cu").read_text()
    return {k: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
            for k, name in (("threads", "kThreads"), ("tile", "kTile"),
                            ("rows", "kRows"))}


def _emulate(x, wins, rows, tile, threads, resident, seed, mis=0):
    """sw_app_launch's kernel over x [n] and wins [W, L] with `resident`
    blocks, H's first word `mis` words past a 16-byte boundary: returns
    (H, best, each cell's stripe, the stripes each block took)."""
    n = len(x)
    W, L = wins.shape
    cols = tile // threads
    S = max(1, -(-n // rows))
    total = W * S
    tiles = -(-L // tile)
    H = np.full((W, n + 1, L + 1), UNSET, np.int64)
    by_stripe = np.full(H.shape, -1)
    by_tile = np.full(H.shape, -1)
    flags = [0] * (total + 1)   # the ticket, then each stripe's progress
    best = [None] * W
    t = np.arange(threads)
    warp = t // 32

    def store(w, i, j, v, k, c):
        assert by_stripe[w, i, j] == -1, (w, i, j)
        H[w, i, j], by_stripe[w, i, j], by_tile[w, i, j] = v, k, c

    def block(taken):
        while True:
            k = flags[0]           # atomicAdd: no yield in between
            flags[0] += 1
            if k >= total:
                return
            taken.append(k)
            w, s = k % W, k // W
            i0 = s * rows + 1
            rws = max(0, min(rows, n + 1 - i0))
            if s == 0:
                for j in range(L + 1):
                    store(w, 0, j, 0, k, 0)
                best[w] = 0
            for h in range(rws):
                store(w, i0 + h, 0, 0, k, 0)   # before tile 0's release
            carry = [(0, i0 + h, 0) for h in range(rows)]  # value, row, col
            mx = 0
            for c in range(tiles if rws else 0):
                c0 = c * tile + 1
                j0 = c0 + t * cols
                while s > 0 and flags[1 + k - W] <= c:
                    yield
                jj = j0[:, None] + np.arange(cols)          # [threads, cols]
                valid = jj <= L

                def above(j):
                    """The row above at columns j (valid ones only)."""
                    j = np.asarray(j)
                    assert (by_stripe[w, i0 - 1, j] == k - W).all(), (k, c)
                    assert (by_tile[w, i0 - 1, j] < flags[1 + k - W]).all()
                    return H[w, i0 - 1, j]

                up = np.zeros((threads, cols), np.int64)
                wb = np.zeros((threads, cols), np.int64)
                wb[valid] = wins[w, jj[valid] - 1]
                dg = np.zeros(threads, np.int64)
                if s > 0:
                    up[valid] = above(jj[valid])
                    inner = (j0 > 1) & (j0 <= L + 1)
                    dg[inner] = above(j0[inner] - 1)
                stage = np.zeros((rows, tile), np.int64)
                for h in range(rws):
                    i = i0 + h
                    val, crow, ccol = carry[h]
                    assert (crow, ccol) == (i, c0 - 1), (k, c, h)
                    seed = val + c0 - 1
                    d = np.concatenate([dg[:, None], up[:, :-1]], 1)
                    b = np.maximum(np.maximum(up - 1, d + (wb == x[i - 1])), 0)
                    inc = np.maximum.accumulate(b + jj, axis=1)
                    run = inc[:, -1]
                    excl = np.zeros(threads, np.int64)
                    totals = []
                    for q in range(warp[-1] + 1):
                        incl = np.maximum.accumulate(run[warp == q])
                        excl[warp == q] = np.concatenate([[0], incl[:-1]])
                        totals.append(incl[-1])
                    before = np.array([max(totals[:q], default=0)
                                       for q in warp])
                    prefix = np.maximum(np.maximum(seed, excl), before)
                    up = np.maximum(inc, prefix[:, None]) - jj
                    stage[h] = up.reshape(-1)
                    mx = max(mx, int(up[valid].max(initial=0)))
                    dg = prefix - (j0 - 1)
                    carry[h] = (int(up[-1, -1]), i, c0 + tile - 1)
                ce = min(c0 + tile - 1, L)
                # the last row first, published, then the others
                for h in [rws - 1] + list(range(rws - 1)):
                    i = i0 + h
                    word = ((w * (n + 1) + i) * (L + 1) + mis) % 4
                    a = c0 + (4 - (word + c0) % 4) % 4
                    groups = (ce - a + 1) // 4 if ce >= a else 0
                    for u in range(groups):
                        col = a + 4 * u
                        assert (word + col) % 4 == 0
                        for e in range(col, col + 4):
                            store(w, i, e, stage[h, e - c0], k, c)
                    ends = [e for e in range(c0, c0 + 4) if e < a]
                    ends += range(a + 4 * groups, a + 4 * groups + 4)
                    for e in ends:
                        if e <= ce:
                            store(w, i, e, stage[h, e - c0], k, c)
                    if h == rws - 1:
                        flags[1 + k] = c + 1
                        yield
                yield
            assert best[w] is not None, w   # zeroed before the fold
            best[w] = max(best[w], mx)

    rng = np.random.default_rng(seed)
    taken = [[] for _ in range(resident)]
    live = [block(taken[b]) for b in range(resident)]
    while live:
        b = int(rng.integers(len(live)))
        try:
            next(live[b])
        except StopIteration:
            live.pop(b)
    return H, np.array(best, np.int64), by_stripe, taken


def _windows(rng, W, L, short=False):
    a = np.frombuffer(b"ACGT", np.uint8)
    wins = a[rng.integers(0, 4, (W, L))]
    if short:   # 0 pads: windows shorter than L, one of them empty
        for k, m in enumerate(rng.integers(0, L, W)):
            wins[k, (0 if k == 1 else m):] = 0
    return wins


def _check(x, wins, got, best, by_stripe, taken, resident, rows):
    W, L = wins.shape
    assert (got != UNSET).all() and (by_stripe >= 0).all()
    want_H, want_best = sw.sw_matrix_batch_plain(torch.from_numpy(x),
                                                 torch.from_numpy(wins))
    np.testing.assert_array_equal(got, want_H.numpy())
    np.testing.assert_array_equal(best, want_best.numpy())
    jax_H = np.asarray(jsw.sw_matrix_batch(jnp.asarray(x), jnp.asarray(wins)))
    np.testing.assert_array_equal(got, jax_H)
    total = W * max(1, -(-len(x) // rows))
    assert sorted(sum(taken, [])) == list(range(total))
    if total > resident:   # the ticket gave a block a second stripe
        assert max(len(b) for b in taken) > 1


@pytest.mark.parametrize("case", range(len(sw_stripe_edges(
    np.random.default_rng(0)))))
def test_stripes_read_only_published_rows(case):
    """chip_smoke.sw_stripe_edges' cases (n = 0 and 1, a stripe's height
    +- 1, a tile's width +- 1 and below it, one window, windows shorter
    than L, a copy across a tile's edge) at the kernel's own constants,
    on the grids of fewer blocks than stripes that the card runs them on."""
    const = _constants()
    R, T = const["rows"], const["tile"]
    label, x, wins, grid = sw_stripe_edges(np.random.default_rng(7))[case]
    assert grid < wins.shape[0] * max(1, -(-len(x) // R))
    got, best, by_stripe, taken = _emulate(x, wins, R, T, const["threads"],
                                           grid, case)
    _check(x, wins, got, best, by_stripe, taken, grid, R)
    if label == "a copy across a tile's edge":   # the copy's full score
        assert best[1] == len(x) and got[1].max() == len(x)


# (n, L, W, rows, tile, threads, resident blocks, H's first word past a
# 16-byte boundary): narrow tiles, so that a row crosses many tile edges
# and every alignment of a row's first column occurs
SMALL = [(7, 150, 3, 2, 32, 8, 4, 0), (9, 97, 2, 3, 24, 8, 3, 3),
         (5, 64, 4, 5, 16, 4, 2, 1), (12, 33, 1, 4, 80, 40, 2, 2)]


@pytest.mark.parametrize("n,L,W,rows,tile,threads,resident,mis", SMALL)
def test_narrow_tiles_and_every_alignment(n, L, W, rows, tile, threads,
                                          resident, mis):
    rng = np.random.default_rng(n * L)
    a = np.frombuffer(b"ACGT", np.uint8)
    x = a[rng.integers(0, 4, n)]
    wins = _windows(rng, W, L, short=W > 2)
    wins[0, 10:10 + n] = x   # a hit, so that best is not 0
    got, best, by_stripe, taken = _emulate(x, wins, rows, tile, threads,
                                           resident, L, mis)
    _check(x, wins, got, best, by_stripe, taken, resident, rows)


def test_stripe_shape_is_the_wrappers():
    const = _constants()
    assert (sw.ROWS, sw.TILE) == (const["rows"], const["tile"])
    assert const["tile"] % const["threads"] == 0
    assert [sw.stripes(n) for n in (0, 1, sw.ROWS, sw.ROWS + 1)] == [
        1, 1, 1, 2]
    assert sw.flag_words(0, 3) == 4 and sw.flag_words(sw.ROWS + 1, 5) == 11
    assert [sw.launches_per_call(W) for W in (0, 1, 100)] == [0, 2, 2]


@pytest.mark.parametrize("kernel,variants", [
    ("sw_app", "SW_VARIANTS"), ("sw_app", "SW_DIAG"),
    ("msa_nw", "BACKTRACK_VARIANTS"),
    ("msa_nw", "FILL_VARIANTS"), ("nw_app", "NW_VARIANTS")])
def test_variant_edits_apply_to_this_tree(kernel, variants):
    """tools/app_variants.py's one-change variants edit this tree's
    sources once at each spot, and the SW ones span kRows x kTile."""
    import tools.app_variants as av

    src = (_build.CSRC / f"{kernel}.cu").read_text()
    table = getattr(av, variants)
    for name, pairs in table.items():
        out = av.edits(src, pairs)
        assert out != src, name
    if variants == "SW_VARIANTS":
        assert len(table) == 23 and "w256-t1024-r8" in table
