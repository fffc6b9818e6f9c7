"""Without a card the run fails and prints no result: it never falls back
to the CPU. The same in a directory that holds only the benchmark's files."""

import os
import shutil
import subprocess
import sys

import pytest

from slam_bench import harness

ARGS = ["--workload", "euroc_stereo.offline", "--seed", "2147483999", "--seconds", "1", "--trace", "0"]


def run_from(root):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "slam_bench/run.py", *ARGS], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)


def test_command_fails_without_a_card():
    p = run_from(harness.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_command_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "slam_bench", ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    p = run_from(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_cell_asks_for_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.BenchError, match="no CUDA device"):
        harness.run_cell("euroc_stereo.offline", 1, 1.0, False, device="cuda")
