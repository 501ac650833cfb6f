"""The roofline's work counts against brute-force counts at tiny sizes,
and the least time against the peaks."""
import numpy as np
import pytest

from portbench import peaks
from portbench.reference import align
from portbench.work import gotoh, pairhmm

SCORING = (1, 4, 6, 1)


def brute_cells(m, n):
    """Cells a plain DP visits: one per (target row, query column)."""
    return sum(1 for _ in range(n) for _ in range(m))


@pytest.mark.parametrize("m,n", [(1, 1), (3, 5), (7, 2), (16, 24)])
def test_dp_cells_and_bytes(m, n):
    for local, tb in ((True, True), (True, False), (False, True)):
        cig = b"" if tb else None
        ops, nbytes = gotoh.pair_work(m, n, local, cig, 3)
        assert ops == brute_cells(m, n) * gotoh.cell_ops(local, tb)
        assert nbytes == m + n + 8 + 12


def test_cell_ops_are_the_derivation():
    assert gotoh.cell_ops(True, False) == 3.0       # (5 + 1) / 2
    assert gotoh.cell_ops(True, True) == 4.0        # (5 + 1 + 2) / 2
    assert gotoh.cell_ops(False, True) == 3.5       # (5 + 2) / 2


def test_walk_steps_count_the_walk():
    rng = np.random.default_rng(5)
    qs, ts = [], []
    for _ in range(12):
        t = bytes(rng.choice(list(b"ACGT"), int(rng.integers(20, 60))))
        q = bytearray(t[5:40])
        q[3] = ord("A") if q[3] != ord("A") else ord("C")
        del q[10:12]
        qs.append(bytes(q))
        ts.append(t)
    for out in align.align_local(qs, ts, SCORING):
        ops = [b & 3 for b in out["cigar"] for _ in range(b >> 2)]
        assert gotoh.walk_steps(out["cigar"]) == len(ops)
        m = sum(op != 2 for op in ops)      # query bases the walk covers
        assert m == out["query_end"] - out["query_start"] + 1


def test_pairhmm_region_work_is_the_sum_over_pairs():
    reads, haps = [150, 149, 3], [300, 297]
    brute = sum(r * h * pairhmm.CELL_OPS + h * pairhmm.LAST_ROW_OPS
                for r in reads for h in haps)
    ops, nbytes = pairhmm.region_work(reads, haps)
    assert ops == brute
    assert nbytes == 4 * sum(reads) + sum(haps) + 4 * len(reads) * len(haps)


def test_least_time_takes_the_binding_peak():
    p = peaks.card_peaks(132, 1980)
    assert p["int32_ops"] == 132 * 64 * 1980e6
    assert p["fp32_ops"] == 2 * p["int32_ops"]
    w = {"int32_ops": 1e9, "fp32_ops": 1e9, "bytes": 1e6}
    assert peaks.least_seconds(w, p) == 1e9 / p["int32_ops"]
    assert peaks.least_seconds({"bytes": 3.35e12}, p) == 1.0


def test_walk_of_the_reference_covers_both_sequences_in_global():
    out = align.align_global([b"ACGTACGTAA"], [b"ACGTTACGTA"], (2, 4, 6, 1))
    ops = [b & 3 for b in out[0]["cigar"] for _ in range(b >> 2)]
    assert sum(op != 2 for op in ops) >= 10 and sum(op != 3 for op in ops) >= 10
