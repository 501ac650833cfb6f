"""The port's NW and SW apps (`genomics_tpu_torch.models.nw`, `.sw`) on
the CPU against the JAX package: the same seeded numpy inputs through
`nw_matrix`, `sw_matrix_batch` and `sw.align` of both, integer-equal, the
port's copies of the golds, and the `nw` and `sw` subcommands byte for
byte.  The CUDA kernels are held to these plain versions on the card
(tests/test_torch_cuda.py)."""
import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import APP_ROWS, cube_err, mutate, sw_edges
from genomics_tpu import __main__ as jax_main
from genomics_tpu.core import golds as jgolds
from genomics_tpu.models import nw as jnw
from genomics_tpu.models import sw as jsw
from genomics_tpu_torch import __main__ as torch_main
from genomics_tpu_torch.core import golds
from genomics_tpu_torch.models import nw, sw


def _nw_inputs(N, seed):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, N).astype(np.uint8)
    return ref, nw.generate_query(ref, rng)


@pytest.mark.parametrize("N", [1, 31, 33, 64])
def test_nw_matrix_matches_jax_and_gold(N):
    ref, qry = _nw_inputs(N, N)
    want = np.asarray(jnw.nw_matrix(jnp.asarray(ref), jnp.asarray(qry)))
    got = nw.nw_matrix(torch.from_numpy(ref), torch.from_numpy(qry))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(golds.nw_cpu(ref, qry),
                                  jgolds.nw_cpu(ref, qry))


def test_generate_query_and_run_match_jax():
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    ref = rng_a.integers(0, 256, 80).astype(np.uint8)
    rng_b.integers(0, 256, 80)
    np.testing.assert_array_equal(nw.generate_query(ref, rng_a),
                                  jnw.generate_query(ref, rng_b))
    assert nw.run(N=48, seed=3, device="cpu") == jnw.run(N=48, seed=3)


def test_nw_tile_launches():
    """A call's CUDA launches no longer grow with N: the flags' memset and
    one kernel (the tile-diagonal schedule made 2 ceil(N / 32) - 1)."""
    assert [nw.launches_per_call(N) for N in (0, 1, 32, 33, 257, 32768)] == [
        0, 2, 2, 2, 2, 2]
    S = nw.STRIPE
    assert [nw.flag_words(N) for N in (1, S, S + 1, 32768)] == [
        2, 2, 3, 32768 // S + 1]


def _sw_cases():
    return sw_edges(np.random.default_rng(3))


@pytest.mark.parametrize("case", range(5))
def test_sw_matrix_batch_matches_jax(case):
    label, x, wins = _sw_cases()[case]
    want = np.asarray(jsw.sw_matrix_batch(jnp.asarray(x), jnp.asarray(wins)))
    H, best = sw.sw_matrix_batch(torch.from_numpy(x), torch.from_numpy(wins))
    np.testing.assert_array_equal(H.numpy(), want, err_msg=label)
    np.testing.assert_array_equal(best.numpy(), want.max(axis=(1, 2)))


def _sw_pair(seed, lx=24, pre=40, post=60):
    rng = np.random.default_rng(seed)
    x = "".join(rng.choice(list("ACGT"), lx))
    mid = list(x)
    mid[lx // 2] = "A" if mid[lx // 2] != "A" else "C"
    y = ("".join(rng.choice(list("ACGT"), pre)) + "".join(mid)
         + "".join(rng.choice(list("ACGT"), post)))
    return x, y


@pytest.mark.parametrize("seed,window,overlap", [
    (1, None, None), (2, 30, 10), (4, 50, None), (6, None, 5)])
def test_sw_align_matches_jax_and_gold(seed, window, overlap):
    x, y = _sw_pair(seed)
    got = sw.align(x, y, window_size=window, overlap=overlap, device="cpu")
    assert got == jsw.align(x, y, window_size=window, overlap=overlap)
    score, loc, idx, cig = golds.sw_best_alignment(x, y, window, overlap)
    assert (got["score"], got["location"], got["window"], got["cigar"]) == (
        score, loc, idx, cig)


def test_sw_align_without_a_hit_matches_jax():
    # nothing matches: every window's max is 0
    assert sw.align("AAAA", "CCCCCCCCCCCCCCCC", device="cpu") == jsw.align(
        "AAAA", "CCCCCCCCCCCCCCCC")


def test_wrappers_refuse_what_they_lack():
    u8 = torch.zeros(4, dtype=torch.uint8)
    with pytest.raises(TypeError):
        nw.nw_matrix(u8.int(), u8)
    with pytest.raises(ValueError):
        nw.nw_matrix(u8, u8[:3])
    with pytest.raises(ValueError):
        sw.sw_matrix_batch(u8, u8)
    with pytest.raises(TypeError):
        sw.sw_matrix_batch(u8.int(), u8[None])


def _stdout(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_nw_and_sw_subcommands_print_the_jax_lines(tmp_path):
    argv = ["nw", "-N", "40", "--seed", "2"]
    want = _stdout(jax_main.main, argv)
    assert _stdout(torch_main.main, argv + ["--device", "cpu"]) == want
    x, y = _sw_pair(9, lx=30, pre=70, post=90)
    small, large = tmp_path / "small.txt", tmp_path / "large.txt"
    small.write_text(x + "\n")
    large.write_text(y + "\n")
    for extra in ([], ["-w", "64", "-o", "20"]):
        argv = ["sw", "-s", str(small), "-l", str(large), *extra]
        want = _stdout(jax_main.main, argv)
        assert _stdout(torch_main.main, argv + ["--device", "cpu"]) == want


def test_compress_cigar():
    assert sw.compress_cigar("MMMIIDM") == "3M2I1D1M"
    assert sw.compress_cigar("") == ""


def test_app_rows_name_the_functions_they_replace():
    """chip_smoke.py's kernels line: each app kernel's `replaces` is the
    line of the JAX function it ports, its source a file of csrc/."""
    from pathlib import Path

    from genomics_tpu_torch import _build

    root = Path(__file__).resolve().parent.parent
    fns = {"nw_app": "nw_matrix", "sw_app": "sw_matrix_batch",
           "msa_nw.fill": "nw_matrices_batch",
           "msa_nw.backtrack": "backtrack_batch"}
    for name, src, rep in APP_ROWS:
        path, line = rep.split(":")
        text = (root / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith(f"def {fns[name]}("), (name, text)
        assert (_build.CSRC / src).exists() and src[:-3] in _build.KERNELS


def test_cube_err_reads_each_pair_to_its_length():
    a = torch.zeros((2, 3, 5), dtype=torch.int32)
    b = a.clone()
    b[0, 1, 4] = 7       # past pair 0's length 3
    b[1, 2, 2] = -2
    assert cube_err(a, b) == 7
    assert cube_err(a, b, torch.tensor([3, 4])) == 2
    assert cube_err(a, a.clone()) == 0


def test_mutate_keeps_rates_and_letters():
    rng = np.random.default_rng(0)
    s = "ACGT" * 2500
    assert mutate(rng, s, 0.0, 0.0) == s
    m = mutate(rng, s, 0.0, 0.2)
    assert set(m) <= set("ACGT") and 9000 < len(m) < 11000 and m != s


@pytest.mark.parametrize("lenY,lenX,window,overlap", [
    (300_000, 1000, None, None), (10_001, 200, 45_000, None),
    (5_000, 120, 700, 50), (999, 333, None, None)])
def test_split_windows_cover_the_sequence(lenY, lenX, window, overlap):
    """The app's windows: each holds its stretch of y, 0-padded, starts
    `window - overlap` apart, and the last reaches y's end or the count
    is ceil(lenY / window)."""
    y = np.random.default_rng(lenY).integers(65, 69, lenY).astype(
        np.uint8).tobytes()
    starts, ends, wins = sw.split_windows(y, lenX, window, overlap)
    w, o = window or 3 * lenX, overlap or lenX
    assert len(starts) == len(ends) == wins.shape[0] == -(-lenY // w)
    assert starts == [k * (w - o) for k in range(len(starts))]
    assert wins.shape[1] == max(e - s for s, e in zip(starts, ends))
    for k, (s, e) in enumerate(zip(starts, ends)):
        assert e == min(s + w, lenY)
        assert wins[k, :e - s].tobytes() == y[s:e]
        assert not wins[k, e - s:].any()
