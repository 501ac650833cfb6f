"""Bowtie2 mapping-quality models, ported from nvBowtie (reference:
Non-CDP/NvB/nvBowtie/bowtie2/cuda/mapq.h — BowtieMapq2 at :146-330,
BowtieMapq3 at :41-141).

The decision trees below ARE the mapq definition (like bowtie2's own
MapqV2/V3); constants are transcribed so mapq values match nvBowtie's
bin-for-bin.  Scoring-scheme inputs:

- `perfect_score(L)` — local scheme: L * match bonus (scoring.h:281);
  global (monotone, end-to-end) scheme: 0 (scoring.h:176).
- `min_score(L)` — the alignment-validity threshold; bowtie2 defaults:
  local  `--score-min G,20,8`  →  20 + 8 * ln(L),
  end-to-end `--score-min L,-0.6,-0.6` → -0.6 - 0.6 * L.
- `monotone` — True for end-to-end scoring (match bonus 0).

The port's copy of `genomics_tpu/models/mapq.py` (host Python in both
packages), kept so that the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MapqScheme:
    match: int = 2
    monotone: bool = False         # local scoring by default (nvBowtie --local)

    def perfect_score(self, read_len: int) -> int:
        return 0 if self.monotone else read_len * self.match

    def min_score(self, read_len: int) -> float:
        if self.monotone:
            return -0.6 - 0.6 * read_len
        return 20.0 + 8.0 * math.log(max(read_len, 1))


def bowtie_mapq2(
    best: int,
    second: int | None,
    read_len: int,
    scheme: MapqScheme = MapqScheme(),
    paired: bool = False,
    o_read_len: int = 0,
) -> int:
    """BowtieMapq2 (mapq.h:146-330), the nvBowtie default."""
    max_score = float(scheme.perfect_score(read_len)) + (
        float(scheme.perfect_score(o_read_len)) if paired else 0.0
    )
    min_score = float(scheme.min_score(read_len)) + (
        float(scheme.min_score(o_read_len)) if paired else 0.0
    )
    diff = max_score - min_score
    if best < min_score:
        return 0
    best_over = best - min_score
    has_second = second is not None

    if scheme.monotone:
        # end-to-end branch (:187-264)
        if not has_second:
            if best_over >= diff * 0.8:
                return 42
            if best_over >= diff * 0.7:
                return 40
            if best_over >= diff * 0.6:
                return 24
            if best_over >= diff * 0.5:
                return 23
            if best_over >= diff * 0.4:
                return 8
            if best_over >= diff * 0.3:
                return 3
            return 0
        best_diff = abs(abs(float(best)) - abs(float(second)))
        if best_diff >= diff * 0.9:
            return 39 if best_over == diff else 33
        if best_diff >= diff * 0.8:
            return 38 if best_over == diff else 27
        if best_diff >= diff * 0.7:
            return 37 if best_over == diff else 26
        if best_diff >= diff * 0.6:
            return 36 if best_over == diff else 22
        if best_diff >= diff * 0.5:
            if best_over == diff:
                return 35
            if best_over >= diff * 0.84:
                return 25
            if best_over >= diff * 0.68:
                return 16
            return 5
        if best_diff >= diff * 0.4:
            if best_over == diff:
                return 34
            if best_over >= diff * 0.84:
                return 21
            if best_over >= diff * 0.68:
                return 14
            return 4
        if best_diff >= diff * 0.3:
            if best_over == diff:
                return 32
            if best_over >= diff * 0.88:
                return 18
            if best_over >= diff * 0.67:
                return 15
            return 3
        if best_diff >= diff * 0.2:
            if best_over == diff:
                return 31
            if best_over >= diff * 0.88:
                return 17
            if best_over >= diff * 0.67:
                return 11
            return 0
        if best_diff >= diff * 0.1:
            if best_over == diff:
                return 30
            if best_over >= diff * 0.88:
                return 12
            if best_over >= diff * 0.67:
                return 7
            return 0
        if best_diff > 0:
            return 6 if best_over >= diff * 0.67 else 2
        return 1 if best_over >= diff * 0.67 else 0

    # local branch (:267-327)
    if not has_second:
        if best_over >= diff * 0.8:
            return 44
        if best_over >= diff * 0.7:
            return 42
        if best_over >= diff * 0.6:
            return 41
        if best_over >= diff * 0.5:
            return 36
        if best_over >= diff * 0.4:
            return 28
        if best_over >= diff * 0.3:
            return 24
        return 22
    best_diff = abs(abs(float(best)) - abs(float(second)))
    if best_diff >= diff * 0.9:
        return 40
    if best_diff >= diff * 0.8:
        return 39
    if best_diff >= diff * 0.7:
        return 38
    if best_diff >= diff * 0.6:
        return 37
    if best_diff >= diff * 0.5:
        if best_over == diff:
            return 35
        return 25 if best_over >= diff * 0.5 else 20
    if best_diff >= diff * 0.4:
        if best_over == diff:
            return 34
        return 21 if best_over >= diff * 0.5 else 19
    if best_diff >= diff * 0.3:
        if best_over == diff:
            return 33
        return 18 if best_over >= diff * 0.5 else 16
    if best_diff >= diff * 0.2:
        if best_over == diff:
            return 32
        return 17 if best_over >= diff * 0.5 else 12
    if best_diff >= diff * 0.1:
        if best_over == diff:
            return 31
        return 14 if best_over >= diff * 0.5 else 9
    if best_diff > 0:
        return 11 if best_over >= diff * 0.5 else 2
    return 1 if best_over >= diff * 0.5 else 0


_MAPQ3_ONE = (43, 42, 41, 36, 32, 27, 20, 11, 4, 1, 0)
_MAPQ3_TWO_PERFECT = (2, 16, 23, 30, 31, 32, 34, 36, 38, 40, 42)
_MAPQ3_TWO = (
    (2, 2, 2, 1, 1, 0, 0, 0, 0, 0, 0),
    (20, 14, 7, 3, 2, 1, 0, 0, 0, 0, 0),
    (20, 16, 10, 6, 3, 1, 0, 0, 0, 0, 0),
    (20, 17, 13, 9, 3, 1, 1, 0, 0, 0, 0),
    (21, 19, 15, 9, 5, 2, 2, 0, 0, 0, 0),
    (22, 21, 16, 11, 10, 5, 0, 0, 0, 0, 0),
    (23, 22, 19, 16, 11, 0, 0, 0, 0, 0, 0),
    (24, 25, 21, 30, 0, 0, 0, 0, 0, 0, 0),
    (30, 26, 29, 0, 0, 0, 0, 0, 0, 0, 0),
    (30, 27, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (30, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
)


def bowtie_mapq3(
    best: int,
    second: int | None,
    read_len: int,
    scheme: MapqScheme = MapqScheme(),
    paired: bool = False,
) -> int:
    """BowtieMapq3 (mapq.h:41-141).

    Quirks kept verbatim: `best == max_score` compares the NEGATED best
    score against max_score (:123, i.e. fires when best_score == 0);
    bins are clamped at 10 here where the reference would index out of
    bounds (UB we cannot reproduce)."""
    if paired:
        return 44
    max_score = float(scheme.perfect_score(read_len))
    min_score = float(scheme.min_score(read_len))
    norm = 10.0 / (max_score - min_score)
    if best < min_score:
        return 0
    best_neg = max(int(max_score) - best, 0)
    best_bin = int(float(best_neg) * norm + 0.5)
    best_bin = min(best_bin, 10)
    if second is not None:
        d = best - second
        diff_bin = min(int(float(d) * norm + 0.5), 10)
        if best_neg == int(max_score):
            return _MAPQ3_TWO_PERFECT[best_bin]
        return _MAPQ3_TWO[diff_bin][best_bin]
    if best_neg == int(max_score):
        return 44
    return _MAPQ3_ONE[best_bin]
