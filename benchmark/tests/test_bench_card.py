"""On the card: one short run of the headline cell through the command
line, correct, and the run refused without a card (here on the CPU)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def _run(*extra, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "pyramid20-w512-ep60", "--seed", "2147483999", *extra],
                          capture_output=True, text=True, cwd=ROOT, timeout=900, env=env)


@pytest.mark.gpu
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run("--seconds", "3", "--trace", "0")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)


def test_the_run_refuses_a_machine_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run("--seconds", "1", "--trace", "0", env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
