"""The port's distributed layer (`genomics_tpu_torch.parallel`, the mesh
paths of `models.ngia` and `models.msa`) against `genomics_tpu.parallel` on
the CPU.

Each world size runs as that many child processes over gloo, each child
this file run as a script (`python tests/test_torch_parallel.py --worker
...`), so no child loads the conftest's JAX: a `file://` rendezvous under
the test's temporary directory, `timeout` on every child and on the
process group.  The JAX side runs here, on `data_mesh(n)` of the
conftest's 8-device CPU mesh, at test_parallel.py's inputs:

- `sharded_align_scores` and `sharded_pipeline_step` at 1, 2, 4 and 8
  ranks: scores integer-equal field for field; the likelihoods bit-equal
  to the gold and to JAX's host-prepared wavefront kernel, and within
  test_parallel's rtol of JAX's pipeline fields, whose on-device prep
  rounds Qm / 3 as a multiply (ROADMAP C23); `tb_checksum` the real
  pairs' nibble sum, which JAX's padding lanes add to (C23);
- nGIA's mesh rounds at 2 and 4 ranks against JAX's
  `cluster_distributed(mesh=data_mesh(n))` and the port on one device
  (reads of 40 bases or more, serial rounds: off C1 and C21), and over
  blocks of unequal size;
- `msa(mesh=)` byte-equal to `msa()`.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 240          # a child's
WORLDS = (1, 2, 4, 8)
MESH_WORLDS = (2, 4)     # nGIA and msa over the mesh
PIPELINE_KEYS = ("q", "t", "qlen", "tlen", "reads", "haps", "rlen", "clen",
                 "bq", "iq", "dq")
INT_FIELDS = ("sw_score", "sw_score_fast", "nw_score", "ksw_score",
              "banded_score", "myers_best", "global_best_sw",
              "global_best_owner")
LIK_FIELDS = ("likelihood", "likelihood_intertask")
SIM = 0.9


def pipeline_inputs(seed: int = 1) -> dict:
    """test_parallel.py's pipeline inputs: B = 16, 16 x 16 codes of 0-15,
    PairHMM reads of 8 and haplotypes of 12 bytes."""
    rng = np.random.default_rng(seed)
    B, Lq, Lt, R, C = 16, 16, 16, 8, 12
    return {
        "q": rng.integers(0, 16, (B, Lq)).astype(np.uint8),
        "t": rng.integers(0, 16, (B, Lt)).astype(np.uint8),
        "qlen": np.full(B, Lq, np.int32), "tlen": np.full(B, Lt, np.int32),
        "reads": rng.integers(65, 85, (B, R)).astype(np.uint8),
        "haps": rng.integers(65, 85, (B, C)).astype(np.uint8),
        "rlen": np.full(B, R, np.int32), "clen": np.full(B, C, np.int32),
        "bq": rng.integers(5, 60, (B, R)).astype(np.int32),
        "iq": rng.integers(5, 60, (B, R)).astype(np.int32),
        "dq": rng.integers(5, 60, (B, R)).astype(np.int32),
        # test_parallel.py's scores inputs: B = 32, 24 x 24 codes of 0-15
        "sq": np.random.default_rng(0).integers(0, 16, (32, 24)).astype(
            np.uint8),
        "st": np.random.default_rng(2).integers(0, 16, (32, 24)).astype(
            np.uint8),
    }


def ngia_reads(seed: int, n_fam: int, per: int) -> list[str]:
    """Families of 60-140 random bases, each read a copy with up to 5
    substitutions and a cut of up to 9 leading bases (40 bases or more:
    every read passes its own word filter, C21)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_fam):
        base = rng.choice(list("ACGT"), int(rng.integers(60, 140)))
        for _ in range(per):
            s = base.copy()
            for pos in rng.integers(0, len(s), int(rng.integers(0, 6))):
                s[pos] = rng.choice(list("ACGT"))
            out.append("".join(s[int(rng.integers(0, 10)):]))
    return out


def msa_seqs(seed: int, n: int = 11) -> list[str]:
    rng = np.random.default_rng(seed)
    base = rng.choice(list("ACGT"), 50)
    out = []
    for _ in range(n):
        s = list(base)
        for _ in range(int(rng.integers(0, 4))):
            pos = int(rng.integers(0, len(s)))
            op = rng.integers(0, 3)
            if op == 0:
                s[pos] = str(rng.choice(list("ACGT")))
            elif op == 1:
                del s[pos]
            else:
                s.insert(pos, str(rng.choice(list("ACGT"))))
        out.append("".join(s))
    return out


def text_inputs() -> dict:
    return {"ngia": ngia_reads(5, 6, 8),            # 48: even blocks
            "ngia_uneven": ngia_reads(6, 5, 9),     # 45: blocks of 12 and 9
            "msa": msa_seqs(7)}


# ---------------------------------------------------------------------------
# the child: one rank
# ---------------------------------------------------------------------------


def worker(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--init", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--dir", required=True)
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from genomics_tpu_torch.core.scoring import AlignmentParams
    from genomics_tpu_torch.models import msa, ngia
    from genomics_tpu_torch.parallel import (data_mesh, sharded_align_scores,
                                             sharded_pipeline_step)
    from genomics_tpu_torch.parallel import multihost

    multihost.initialize(args.init, args.world, args.rank, backend="gloo",
                         device="cpu")
    mesh = data_mesh(args.world, device="cpu")
    P = AlignmentParams()
    d = Path(args.dir)
    arrays = dict(np.load(d / "inputs.npz"))
    texts = json.loads((d / "texts.json").read_text())
    out = {}
    scores, best = sharded_align_scores(mesh, arrays["sq"], arrays["st"], P)
    out["scores"], out["best"] = multihost.fetch(scores), int(best)
    ins = [arrays[k] for k in PIPELINE_KEYS]
    for tag, fast in (("pipe", True), ("plain", False)):
        res = sharded_pipeline_step(mesh, *ins, params=P, use_pallas=fast)
        for k, v in res.items():
            out[f"{tag}_{k}"] = multihost.fetch(v)
    if args.world in MESH_WORLDS:
        for name in ("ngia", "ngia_uneven"):
            res = ngia.cluster_distributed(texts[name], SIM, mesh=mesh)
            out[f"{name}_cluster"] = res.cluster
            out[f"{name}_order"] = res.order
        rows, center = msa.msa(texts["msa"], mesh=mesh)
        out["msa_center"] = center
        out["msa_rows"] = np.array(rows)
    # every rank holds the gathered result; each writes its own copy
    np.savez(d / f"out{args.rank}.npz", **out)
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def _start(world: int, d: Path) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    init = f"file://{d / 'rendezvous'}"
    return [subprocess.Popen(
        [sys.executable, __file__, "--worker", "--init", init, "--world",
         str(world), "--rank", str(r), "--dir", str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def _wait(procs) -> list[str]:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


@pytest.fixture(scope="module")
def inputs():
    return pipeline_inputs(), text_inputs()


@pytest.fixture(scope="module")
def launched(inputs, tmp_path_factory):
    """Every world's ranks started at once: {world: (dir, processes)}."""
    arrays, texts = inputs
    runs = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"world{world}")
        np.savez(d / "inputs.npz", **arrays)
        (d / "texts.json").write_text(json.dumps(texts))
        runs[world] = (d, _start(world, d))
    yield runs
    for _, procs in runs.values():
        _wait(procs)


@pytest.fixture(scope="module")
def port(launched, jax_runs):
    """{world size: rank 0's gathered outputs}, each rank's copy checked
    equal to rank 0's (JAX's runs are made while the ranks work)."""
    out = {}
    for world, (d, procs) in launched.items():
        logs = _wait(procs)
        for p, log in zip(procs, logs):
            assert p.returncode == 0, f"world {world}:\n{log[-4000:]}"
        res = [dict(np.load(d / f"out{r}.npz")) for r in range(world)]
        for other in res[1:]:
            for k, v in res[0].items():
                np.testing.assert_array_equal(other[k], v, err_msg=k)
        out[world] = res[0]
    return out


@pytest.fixture(scope="module")
def jax_runs(inputs, launched):
    """JAX's sharded scores and pipeline step on data_mesh(n), per n."""
    import jax

    from genomics_tpu.core.scoring import AlignmentParams
    from genomics_tpu.parallel import data_mesh, shard_batch
    from genomics_tpu.parallel import sharded_align_scores
    from genomics_tpu.parallel.mesh import sharded_pipeline_step

    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 CPU devices")
    arrays, _ = inputs
    P = AlignmentParams()
    out = {}
    for n in WORLDS:
        mesh = data_mesh(n)
        s, b = sharded_align_scores(mesh, *shard_batch(
            mesh, arrays["sq"], arrays["st"]), P)
        res = sharded_pipeline_step(mesh, *shard_batch(
            mesh, *(arrays[k] for k in PIPELINE_KEYS)), params=P)
        out[n] = {"scores": np.asarray(s), "best": int(b),
                  **{k: np.asarray(v) for k, v in res.items()}}
    return out


@pytest.fixture(scope="module")
def gold_likelihoods(inputs):
    """The pipeline's pairs through the gold and through JAX's exact
    wavefront kernel with host prep (`pairhmm_forward_tpu_dataset`,
    interpret mode)."""
    from genomics_tpu.core import golds
    from genomics_tpu.ops import pallas_pairhmm

    a, _ = inputs
    recs = [{"read": a["reads"][i].tobytes(), "hap": a["haps"][i].tobytes(),
             "base_quals": a["bq"][i], "ins_quals": a["iq"][i],
             "del_quals": a["dq"][i]} for i in range(len(a["reads"]))]
    gold = np.array([golds.pairhmm_forward(r["read"], r["hap"],
                                           r["base_quals"], r["ins_quals"],
                                           r["del_quals"]) for r in recs],
                    np.float32)
    return gold, np.asarray(pallas_pairhmm.pairhmm_forward_tpu_dataset(
        recs, exact=True))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_scores_match_jax(world, port, jax_runs):
    got, want = port[world], jax_runs[world]
    np.testing.assert_array_equal(got["scores"], want["scores"])
    assert got["best"] == want["best"] == want["scores"].max()


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_scores_match_jax(world, port, jax_runs):
    got, want = port[world], jax_runs[world]
    for k in INT_FIELDS:
        np.testing.assert_array_equal(got[f"pipe_{k}"], want[k], err_msg=k)
    assert got["pipe_global_best_sw"] == got["pipe_sw_score"].max()


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_likelihoods_are_the_gold_bits(world, port, jax_runs,
                                                gold_likelihoods):
    """Both PairHMM fields are the gold's bits and JAX's host-prepared
    wavefront kernel's; JAX's pipeline fields prepare Qm on the device
    (a multiply by 1/3) and its inter-task field is the two-rounded form,
    so they are held to test_parallel's rtol (ROADMAP C23)."""
    gold, jax_exact = gold_likelihoods
    got, want = port[world], jax_runs[world]
    for k in LIK_FIELDS:
        np.testing.assert_array_equal(got[f"pipe_{k}"], gold, err_msg=k)
        np.testing.assert_array_equal(got[f"pipe_{k}"], jax_exact,
                                      err_msg=k)
        np.testing.assert_allclose(got[f"pipe_{k}"], want[k], rtol=1e-5)
    np.testing.assert_allclose(float(got["pipe_total_likelihood"]),
                               gold.astype(np.float64).sum(), rtol=1e-5)
    np.testing.assert_allclose(float(got["pipe_total_likelihood"]),
                               float(want["total_likelihood"]), rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_tb_checksum_is_the_real_pairs_nibble_sum(world, port, jax_runs,
                                                  inputs):
    """The port's tb_checksum sums the first nibble of each traceback word
    over the real pairs: the plain version's and JAX's TB kernel's on
    the same pairs, at every world size; JAX's field adds its padding
    lanes' nibbles, so it grows with the mesh (ROADMAP C23)."""
    import jax.numpy as jnp
    import torch

    from genomics_tpu.ops import pallas_align
    from genomics_tpu.parallel.mesh import _pad_pair_shard
    from genomics_tpu_torch.core.scoring import AlignmentParams
    from genomics_tpu_torch.ops import scan_align

    a, _ = inputs
    B = len(a["q"])
    plain = scan_align.local_align_batch(
        torch.from_numpy(a["q"]), torch.from_numpy(a["t"]),
        AlignmentParams(), with_tb=True).tb
    want = int((plain & 0xF).sum())
    qp, tp = _pad_pair_shard(jnp.asarray(a["q"]), jnp.asarray(a["t"]))
    from genomics_tpu.core.scoring import AlignmentParams as JP

    tb = np.asarray(pallas_align.local_align_tpu(qp, tp, JP(),
                                                 with_tb=True).tb)
    assert int((tb[:B] & 0xF).sum()) == want
    assert int(port[world]["pipe_tb_checksum"]) == want
    pad_lanes = int(jax_runs[world]["tb_checksum"]) - want
    assert pad_lanes > 0 and pad_lanes % (world * 128 - B) == 0


@pytest.mark.parametrize("world", (1, 4))
def test_pipeline_plain_versions(world, port, inputs):
    """use_pallas=False: the plain versions give the fast path's scores,
    Myers' best and the checksum 0 and the inter-task field the plain
    likelihood, as in the JAX package's plain branch (mesh.py:256-270)."""
    got = port[world]
    for k in ("sw_score", "nw_score", "ksw_score", "banded_score",
              "likelihood", "global_best_sw", "global_best_owner",
              "total_likelihood"):
        np.testing.assert_array_equal(got[f"plain_{k}"], got[f"pipe_{k}"],
                                      err_msg=k)
    np.testing.assert_array_equal(got["plain_sw_score_fast"],
                                  got["plain_sw_score"])
    np.testing.assert_array_equal(got["plain_likelihood_intertask"],
                                  got["plain_likelihood"])
    assert not got["plain_myers_best"].any()
    assert int(got["plain_tb_checksum"]) == 0


@pytest.mark.parametrize("world", MESH_WORLDS)
def test_ngia_mesh_matches_jax_and_one_device(world, port, inputs):
    from genomics_tpu.models import ngia as JN
    from genomics_tpu.parallel import data_mesh
    from genomics_tpu_torch.models import ngia as TN

    reads = inputs[1]["ngia"]
    want = JN.cluster_distributed(reads, SIM, mesh=data_mesh(world))
    one = TN.cluster_distributed(reads, SIM, device="cpu")
    got = port[world]
    np.testing.assert_array_equal(got["ngia_cluster"], want.cluster)
    np.testing.assert_array_equal(got["ngia_cluster"], one.cluster)
    np.testing.assert_array_equal(got["ngia_order"], want.order)
    assert 1 < want.n_clusters < len(reads)


@pytest.mark.parametrize("world", MESH_WORLDS)
def test_ngia_mesh_over_unequal_blocks(world, port, inputs):
    """45 reads over 4 ranks: blocks of 12, 12, 12 and 9."""
    from genomics_tpu.models import ngia as JN
    from genomics_tpu_torch.models import ngia as TN

    reads = inputs[1]["ngia_uneven"]
    one = TN.cluster_distributed(reads, SIM, device="cpu")
    np.testing.assert_array_equal(port[world]["ngia_uneven_cluster"],
                                  one.cluster)
    np.testing.assert_array_equal(one.cluster,
                                  JN.cluster_distributed(reads, SIM).cluster)


@pytest.mark.parametrize("world", MESH_WORLDS)
def test_msa_mesh_equals_msa(world, port, inputs):
    from genomics_tpu_torch.models import msa

    rows, center = msa.msa(inputs[1]["msa"], device="cpu")
    got = port[world]
    assert int(got["msa_center"]) == center
    assert list(got["msa_rows"]) == rows


def test_one_rank_without_a_process_group(inputs, port):
    """Without a process group the mesh is one rank and every collective
    is the identity: the pipeline gives the one-rank gloo run's fields."""
    import torch.distributed as dist

    from genomics_tpu_torch.core.scoring import AlignmentParams
    from genomics_tpu_torch.parallel import data_mesh, sharded_pipeline_step
    from genomics_tpu_torch.parallel import multihost

    assert not dist.is_initialized()
    arrays, _ = inputs
    res = sharded_pipeline_step(data_mesh(device="cpu"),
                                *(arrays[k] for k in PIPELINE_KEYS),
                                params=AlignmentParams())
    for k, v in res.items():
        np.testing.assert_array_equal(multihost.fetch(v), port[1][f"pipe_{k}"],
                                      err_msg=k)


def test_shards_are_contiguous_blocks():
    """put_global's blocks: ceil(n / size) rows a rank, the last ones
    shorter or empty, together the whole batch in order."""
    from genomics_tpu_torch.parallel import multihost
    from genomics_tpu_torch.parallel.mesh import DataMesh

    import torch

    x = np.arange(45 * 2).reshape(45, 2)
    for size in (1, 2, 4, 8, 64):
        parts = [multihost.put_global(DataMesh(size, r, torch.device("cpu")),
                                      x) for r in range(size)]
        assert [len(p) for p in parts] == [
            multihost.block(45, size, r)[1] - multihost.block(45, size, r)[0]
            for r in range(size)]
        np.testing.assert_array_equal(torch.cat(parts).numpy(), x)
    assert multihost.block(45, 4, 3) == (36, 45)
    assert multihost.block(2, 4, 3) == (2, 2)


def test_backends_do_not_switch(tmp_path):
    """A mesh needs the process group's size, and a backend that cannot
    start raises instead of giving way to another."""
    import torch
    import torch.distributed as dist

    from genomics_tpu_torch.parallel import data_mesh, multihost

    with pytest.raises(ValueError, match="process group"):
        data_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            multihost.initialize(f"file://{tmp_path}/a", 1, 0,
                                 device="cuda")
    if not dist.is_nccl_available():
        with pytest.raises(RuntimeError):
            multihost.initialize(f"file://{tmp_path}/b", 1, 0,
                                 backend="nccl", device="cpu")
    assert not dist.is_initialized()


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1:]))
