"""`run.py` refuses to measure without a card, and prints no result."""

import os
import shutil
import subprocess
import sys

import pytest

from perfbench.harness import registry

ROOT = registry.REPO_ROOT


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


@pytest.mark.parametrize("cell", ["stark_paper.k16_host",
                                  "stark_paper.k16_device"])
def test_refuses_without_a_card(cell):
    out = _run(ROOT, "--workload", cell, "--seed", str(2**31 + 9),
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_refuses_in_a_bare_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench")
    out = _run(str(tmp_path), "--workload", "stark_paper.k16_host",
               "--seed", "3", "--seconds", "1", "--trace", "1")
    assert out.returncode != 0 and out.stdout.strip() == ""
