"""The port's examples run as a user runs them: ``tune_and_run_kernel``
on the CPU (the kernels' plain versions under the tuned schedules), and
its default, the card, refused where there is none."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLE = os.path.join(ROOT, "examples_torch", "tune_and_run_kernel.py")


def _run(*args):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(ROOT, "src")))
    return subprocess.run([sys.executable, EXAMPLE, *args], capture_output=True, text=True,
                          env=env, timeout=300)


def test_tune_and_run_kernel_on_the_cpu():
    proc = _run("--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[gemm] tuned (256, 256, 256)" in proc.stdout
    assert "[flash] tuned (256, 256, 64)" in proc.stdout
    assert "dispatch 1 from the record, 0 kernel launches" in proc.stdout
    assert "0 kernel launches)\nOK" in proc.stdout
    assert proc.stdout.rstrip().endswith("OK: both tuned kernels match their plain versions on cpu")


def test_tune_and_run_kernel_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs the kernels there")
    proc = _run()
    assert proc.returncode != 0
    assert "RuntimeError: the kernels run on the card and none is present" in proc.stderr
