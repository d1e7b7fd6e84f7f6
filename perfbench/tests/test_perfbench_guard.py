"""The import guard, and what a run loads."""

import os
import subprocess
import sys

from conftest import ROOT
from perfbench.guard import forbidden_modules


def test_names_compared_whole():
    found = forbidden_modules(["repro_torch", "repro_torch.kernels", "reproduce", "jaxtyping",
                               "repro", "repro.core", "jax", "jax.numpy", "jaxlib", "flax.linen",
                               "perfbench"])
    assert found == ["flax.linen", "jax", "jax.numpy", "jaxlib", "repro", "repro.core"]


def test_a_run_loads_no_forbidden_module():
    """Everything a run imports, the port's engine and kernels, the
    reference and every metric reader, in a fresh interpreter."""
    code = (
        "import sys; from perfbench import run, specs, control\n"
        "import repro_torch.launch.serve, repro_torch.kernels.ops, repro_torch.core\n"
        "b = specs.load_benchmark()\n"
        "for w in b['workloads']:\n"
        "    c = specs.load_cell(w['name'], bench=b)\n"
        "    specs.load_reference(c.config['reference'])\n"
        "    [specs.metric_reader(m['name']) for m in c.end_to_end + c.per_layer]\n"
        "from perfbench.guard import forbidden_modules\n"
        "print(forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_exits_and_prints_nothing():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          "qwen2-72b.long-prompt", "--seed", str(2 ** 31 + 9), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
