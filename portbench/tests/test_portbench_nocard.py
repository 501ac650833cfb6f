"""A run without a card fails and prints no result; so does a run in a
directory that holds only BENCHMARK.json and the benchmark."""
import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness


def run_cli(cwd, cell="gasal2-testprog.tb"):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def no_result(out: str) -> bool:
    for line in out.splitlines():
        try:
            if "metrics" in json.loads(line):
                return False
        except (json.JSONDecodeError, TypeError):
            pass
    return True


def test_no_card_exits_nonzero_with_no_result():
    p = run_cli(harness.ROOT)
    assert p.returncode != 0 and no_result(p.stdout), p.stderr
    assert "CUDA" in p.stderr


def test_without_the_program_exits_nonzero(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run_cli(tmp_path)
    assert p.returncode != 0 and no_result(p.stdout)


@pytest.mark.cuda
def test_short_run_on_the_card(card, tmp_path):
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "gasal2-testprog.score", "--seed", str(2**33 + 3), "--seconds",
         "2", "--trace", "0"], cwd=harness.ROOT, capture_output=True,
        text=True, timeout=900)
    assert p.returncode == 0, p.stderr
    line = json.loads(p.stdout.splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"pairs_per_s", "setup_s"}
