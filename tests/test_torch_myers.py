"""Myers edit distance and Hamming distance in the PyTorch port against
the JAX package: (best, end, final) integer-equal to the JAX scan
(`myers_batch`) and to the Pallas kernel `_myers_kernel` in interpret mode
(`myers_batch_tpu`), with interior 255s, N codes and empty patterns."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_tpu.ops import myers as jmyers
from genomics_tpu_torch.ops import myers


def _batch(seed, B, Lp, Lt):
    """Patterns and texts of 2-bit codes padded with 255; half the texts
    hold a copy of their pattern, texts carry Ns (4) and interior 255s,
    and three patterns are empty."""
    rng = np.random.default_rng(seed)
    pats = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    texts = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    plen = rng.integers(1, Lp + 1, B).astype(np.int32)
    tlen = rng.integers(1, Lt + 1, B).astype(np.int32)
    plen[:3] = 0
    for i in range(0, B, 2):
        at = int(rng.integers(0, max(Lt - plen[i], 0) + 1))
        k = min(plen[i], Lt - at)
        texts[i, at:at + k] = pats[i, :k]
    texts[rng.random((B, Lt)) < 0.03] = 4
    texts[rng.random((B, Lt)) < 0.01] = 255
    for i in range(B):
        pats[i, plen[i]:] = 255
        texts[i, tlen[i]:] = 255
    return pats, plen, texts, tlen


def _torch(eq, plen, texts, tlen):
    return [torch.from_numpy(a) for a in (eq, plen, texts, tlen)]


@pytest.mark.parametrize("W,Lp,Lt", [(1, 32, 80), (3, 96, 152),
                                     (5, 160, 200)])
def test_myers_matches_jax_scan_and_pallas_kernel(W, Lp, Lt):
    pats, plen, texts, tlen = _batch(W, 1024, Lp, Lt)
    eq = myers.build_eq_masks(pats, plen, W)
    np.testing.assert_array_equal(eq, jmyers.build_eq_masks(pats, plen, W))
    scan = jmyers.myers_batch(jnp.asarray(eq), jnp.asarray(plen),
                              jnp.asarray(texts), jnp.asarray(tlen))
    pallas = jmyers.myers_batch_tpu(eq, plen, texts, tlen)
    got = myers.myers_batch(*_torch(eq, plen, texts, tlen))
    got64 = myers.myers_batch(*_torch(eq.astype(np.int64), plen, texts,
                                      tlen))
    # ROADMAP C10: for an empty pattern the Pallas kernel starts best_end
    # at min(lastw, 0) - 1 = -2; the port keeps the scan's -1
    some = plen > 0
    for name, g, s, p, g64 in zip(("best", "end", "final"), got, scan, pallas,
                                  got64):
        assert g.dtype == torch.int32 and g.shape == (1024,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(s), err_msg=name)
        np.testing.assert_array_equal(g64.numpy(), np.asarray(s),
                                      err_msg=name)
        np.testing.assert_array_equal(g.numpy()[some], p[some], err_msg=name)
    assert (got[1].numpy() >= 0).any() and (got[0].numpy()[3:] == 0).any()


def test_myers_wide_patterns_match_jax_scan():
    """W = 9, the kernel's scratch-word path, against the JAX scan."""
    pats, plen, texts, tlen = _batch(9, 64, 288, 320)
    eq = myers.build_eq_masks(pats, plen, 9)
    want = jmyers.myers_batch(jnp.asarray(eq), jnp.asarray(plen),
                              jnp.asarray(texts), jnp.asarray(tlen))
    got = myers.myers_batch(*_torch(eq, plen, texts, tlen))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_edit_distance_semiglobal_matches_jax():
    """tests/test_nvb_components.py's strings, lowercase, U and N
    included."""
    rng = np.random.default_rng(1)
    ps = ["".join(rng.choice(list("ACGT"), int(rng.integers(4, 90))))
          for _ in range(20)]
    ts = ["".join(rng.choice(list("ACGTacgUN"), int(rng.integers(4, 120))))
          for _ in range(20)]
    ts[:10] = [t[:5] + p + t[5:] for p, t in zip(ps[:10], ts[:10])]
    want = jmyers.edit_distance_semiglobal(ps, ts)
    got = myers.edit_distance_semiglobal(ps, ts, device="cpu")
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert (got[0][:10] == 0).all()


def test_hamming_batch_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 4, (50, 40)).astype(np.uint8)
    b = a.copy()
    b[rng.random(b.shape) < 0.1] = 3
    length = rng.integers(0, 41, 50).astype(np.int32)
    want = np.asarray(jmyers.hamming_batch(a, b, length))
    got = myers.hamming_batch(torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(length))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        myers.hamming_batch(a[:2, :6], b[:2, :6], [4, 6]).numpy(),
        np.asarray(jmyers.hamming_batch(a[:2, :6], b[:2, :6],
                                        np.array([4, 6]))))


def test_edit_distance_needs_the_card_unless_told():
    if torch.cuda.is_available():
        assert myers.edit_distance_semiglobal(["ACGT"], ["AACGTT"])[0][0] == 0
        return
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        myers.edit_distance_semiglobal(["ACGT"], ["AACGTT"])


def test_myers_batch_checks_its_inputs():
    pats, plen, texts, tlen = _batch(2, 8, 20, 30)
    args = _torch(myers.build_eq_masks(pats, plen, 1), plen, texts, tlen)
    with pytest.raises(TypeError):
        myers.myers_batch(args[0], args[1], args[2].int(), args[3])
    with pytest.raises(ValueError):
        myers.myers_batch(args[0], args[1].long(), *args[2:])
    with pytest.raises(ValueError):
        myers.myers_batch(args[0][:, :3], *args[1:])
    with pytest.raises(ValueError, match="unsupported device"):
        myers.myers_batch(*(x.to("meta") for x in args))


def _myers_constants():
    import re

    from genomics_tpu_torch import _build

    src = (_build.CSRC / "myers.cu").read_text()
    c = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    return int(c["kThreads"]), int(c["kChunk"])


def _staged_texts(texts, ts, tlen, B, Lt, threads, chunk):
    """The byte each thread of myers.cu reads at each text step, as its
    block stages them: per block of `threads` pairs, chunks of `chunk`
    bytes up to the block's longest min(tlen, Lt), each pair's aligned
    16-byte words from the one holding the chunk's first byte, only those
    holding a byte below the block's end; a word not copied reads 0xEE.
    Read from the texts' storage at their real addresses."""
    words = chunk // 16 + 1
    store = texts.untyped_storage()
    mem = np.frombuffer(bytes(store), np.uint8)
    start = texts.data_ptr() - store.data_ptr()
    base_addr = store.data_ptr()
    seen = np.full((B, Lt), 255, np.uint8)
    tl = np.minimum(tlen.numpy(), Lt)
    for b0 in range(0, B, threads):
        n = min(threads, B - b0)
        cols = int(tl[b0:b0 + n].max(initial=0))
        for c0 in range(0, cols, chunk):
            end = min(c0 + chunk, cols)
            for p in range(n):
                first = start + (b0 + p) * ts + c0     # offset in storage
                aligned = (base_addr + first) & ~15
                staged = np.full(16 * words, 0xEE, np.uint8)
                for w in range(words):
                    word = aligned + 16 * w
                    if word < base_addr + first + (end - c0):
                        lo = word - base_addr
                        got = mem[max(lo, 0):lo + 16]
                        staged[16 * w + max(-lo, 0):16 * w + max(-lo, 0)
                               + len(got)] = got
                skew = (base_addr + start + (b0 + p) * ts) & 15
                k = min(chunk, Lt - c0)
                seen[b0 + p, c0:c0 + k] = staged[skew:skew + k]
    return seen


def _myers_stand_in(threads, chunk, record):
    """`_build.launch` with myers.cu's schedule behind it: the masks read
    in place (every es-th 32-bit word), the texts through the staging, the
    recurrence of the plain version on the bytes read."""
    def launch(name, symbol, argtypes, device, *args):
        assert (name, symbol) == ("myers", "myers_launch")
        assert argtypes == myers._ARGS and len(args) + 1 == len(argtypes)
        (eq_w, es, texts, ts, plen, tlen, B, W, Lt, state, best, end,
         fin) = args
        assert eq_w.dtype == torch.int32 and eq_w.is_contiguous()
        assert texts.stride(1) == 1 and (state is None) == (W <= 8)
        eq = eq_w.reshape(-1)[::es][:B * 4 * W].reshape(B, 4, W)
        seen = _staged_texts(texts, ts, tlen, B, Lt, threads, chunk)
        tl = np.minimum(tlen.numpy(), Lt)
        for b in range(B):
            np.testing.assert_array_equal(seen[b, :tl[b]],
                                          texts[b, :tl[b]].numpy())
        record.append(seen)
        for out, got in zip((best, end, fin), myers.myers_batch_plain(
                eq.view(torch.uint32), plen, torch.from_numpy(seen), tlen)):
            out.copy_(got)
    return launch


@pytest.mark.parametrize("mask_dtype", ["uint32", "int32", "int64"])
def test_myers_layout_reads_inputs_in_place(mask_dtype):
    """No permute, transpose or dtype copy: the layout's masks share the
    storage of contiguous uint32, int32 and int64 masks (int64 read at
    every second word), and texts that are a slice of a larger tensor,
    rows or columns, are passed with their row stride."""
    pats, plen, texts, tlen = _batch(3, 40, 70, 90)
    eq = myers.build_eq_masks(pats, plen, 3)
    eq_t = {"uint32": torch.from_numpy(eq),
            "int32": torch.from_numpy(eq.view(np.int32)),
            "int64": torch.from_numpy(eq.astype(np.int64))}[mask_dtype]
    wide = torch.from_numpy(np.pad(texts, ((3, 2), (5, 11))))
    for tx, stride in ((torch.from_numpy(texts), 90),
                       (wide[3:43, 5:95], 106),
                       (torch.from_numpy(texts.reshape(-1)[7:7 + 39 * 90]
                                         ).view(39, 90), 90)):
        n = tx.shape[0]
        lay = myers.myers_layout(eq_t[:n], _t(plen[:n]), tx, _t(tlen[:n]))
        assert lay[0].data_ptr() == eq_t.data_ptr()
        assert lay[1] == (2 if mask_dtype == "int64" else 1)
        assert lay[2].data_ptr() == tx.data_ptr() and lay[3] == stride
        assert lay[6:10] == (n, 3, 90, None)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("mask_dtype", ["uint32", "int64"])
@pytest.mark.parametrize("W,Lp,Lt,offset", [
    (1, 20, 13, 0), (3, 90, 152, 3), (5, 160, 200, 0), (2, 40, 67, 9),
    (9, 280, 300, 1)])
def test_staged_text_order_matches_plain(monkeypatch, mask_dtype, W, Lp, Lt,
                                         offset):
    """The kernel's staging of the texts (chunks, aligned words, the skew
    of each row, the block's longest text) reads every pair the bytes the
    plain version reads, at Lt below, at and past a chunk, rows at any
    alignment (a slice `offset` bytes into a larger tensor), tlen past Lt,
    interior 255s, empty patterns, a last block part full; (best, end,
    final) equal myers_batch_plain's."""
    from genomics_tpu_torch import _build

    threads, chunk = _myers_constants()
    B = threads + 45
    pats, plen, texts, tlen = _batch(W * 7 + Lt, B, Lp, Lt)
    tlen[5] = Lt + 20
    tlen[threads:] = np.minimum(tlen[threads:], Lt // 2)
    eq = myers.build_eq_masks(pats, plen, W)
    eq = eq.astype(np.int64) if mask_dtype == "int64" else eq
    flat = np.full(offset + B * Lt + 5, 0x77, np.uint8)
    flat[offset:offset + B * Lt] = texts.reshape(-1)
    tx = torch.from_numpy(flat)[offset:offset + B * Lt].view(B, Lt)
    record = []
    monkeypatch.setattr(_build, "launch",
                        _myers_stand_in(threads, chunk, record))
    args = (torch.from_numpy(eq), _t(plen), tx, _t(tlen))
    before = myers.LAUNCHES["myers"]
    got = myers.launch_myers(myers.myers_layout(*args))
    assert myers.LAUNCHES["myers"] == before + 1 and record
    want = myers.myers_batch_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (want[1] >= 0).any() and (want[1][:3] == -1).all()
