"""The port's search space, legality rule and package isolation, held
against the JAX package: paper space sizes, neighbours, features and
transplants match exactly; the kernel wrapper refuses exactly what the
port's analyzer calls ILLEGAL."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest

from repro.core.config_space import GemmConfigSpace as RefSpace
from repro_torch.core.analysis import (
    HopperSpec,
    ScheduleAnalyzer,
    gemm_launch_error,
    should_prune,
)
from repro_torch.core.config_space import GemmConfigSpace, TilingState
from repro_torch.kernels.gemm import kernel_config_from_state

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.mark.parametrize(
    "dim,size", [(512, 484_000), (1024, 899_756), (2048, 1_589_952)]
)
def test_paper_space_sizes(dim, size):
    assert GemmConfigSpace(dim, dim, dim).size() == size == RefSpace(dim, dim, dim).size()


@pytest.mark.parametrize("dims", [(64, 64, 64), (256, 128, 512), (8192, 4096, 6144)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_neighbours_features_transplant_match_reference(dims, seed):
    port, ref = GemmConfigSpace(*dims), RefSpace(*dims)
    other_port, other_ref = GemmConfigSpace(1024, 512, 2048), RefSpace(1024, 512, 2048)
    rng_p, rng_r = random.Random(seed), random.Random(seed)
    for _ in range(20):
        s, r = port.random_state(rng_p), ref.random_state(rng_r)
        assert s.key() == r.key()
        assert [x.key() for x in port.neighbors(s)] == [x.key() for x in ref.neighbors(r)]
        np.testing.assert_array_equal(port.features(s), ref.features(r))
        tp, tr = other_port.transplant(s), other_ref.transplant(r)
        assert (tp is None) == (tr is None)
        if tp is not None:
            assert tp.key() == tr.key()
    assert port.initial_state().key() == ref.initial_state().key()
    assert port.n_features == ref.n_features


def test_enumeration_matches_reference():
    port, ref = GemmConfigSpace(16, 16, 16), RefSpace(16, 16, 16)
    assert [s.key() for s in port.enumerate()] == [s.key() for s in ref.enumerate()]


@pytest.mark.parametrize("dims", [(64, 64, 64), (512, 256, 1024), (8192, 4096, 6144),
                                  (8, 4096, 11008)])
@pytest.mark.parametrize("in_bytes", [2, 4])
@pytest.mark.parametrize("seed", range(4))
def test_wrapper_refusals_agree_with_analyzer(dims, in_bytes, seed):
    """The kernel's config check and the analyzer's ILLEGAL verdict are
    one rule: on sampled states (legitimate products) they agree."""
    space = GemmConfigSpace(*dims)
    analyzer = ScheduleAnalyzer(space, in_bytes=in_bytes)
    rng = random.Random(seed)
    n_illegal = 0
    for _ in range(200):
        s = space.random_state(rng)
        illegal = analyzer.analyze(s).illegal
        try:
            kernel_config_from_state(s).validate(*dims, in_bytes=in_bytes)
            refused = False
        except ValueError:
            refused = True
        assert illegal == refused, (s, analyzer.analyze(s))
        n_illegal += illegal
    assert n_illegal > 0


def test_analyzer_reasons():
    """The float32 SIMT kernel's reasons (the bf16 kernels' are in
    tests/test_torch_gemm_rules.py)."""
    space = GemmConfigSpace(1024, 1024, 1024)
    an = ScheduleAnalyzer(space, in_bytes=4)
    assert an.analyze(space.initial_state()).reason == "block_below_minimum"
    assert not an.analyze(TilingState((8, 4, 4, 8), (32, 32), (8, 2, 8, 8))).illegal
    assert an.analyze(TilingState((8, 4, 4, 8), (32, 32), (8, 2, 8, 4))).reason == "product_mismatch"
    assert an.analyze(TilingState((8, 1, 8, 16), (32, 32), (8, 2, 8, 8))).reason == "register_tile"
    assert an.analyze(TilingState((4, 8, 4, 8), (32, 32), (4, 8, 4, 8))).reason == "threads_over_limit"
    assert an.analyze(TilingState((8, 1, 16, 8), (1, 1024), (8, 2, 8, 8))).reason == "smem_overflow"
    degenerate = an.analyze(TilingState((32, 1, 32, 1), (32, 32), (32, 1, 32, 1)))
    assert degenerate.reason == "degenerate" and should_prune(degenerate)
    small = ScheduleAnalyzer(GemmConfigSpace(128, 128, 128), in_bytes=4)
    fill = small.analyze(TilingState((1, 4, 4, 8), (4, 32), (1, 2, 8, 8)))
    assert fill.reason == "under_fill" and not should_prune(fill)


def test_launch_rule_edges():
    """The float32 SIMT kernel's rule (the bf16 kernels' edges are in
    tests/test_torch_gemm_rules.py)."""
    spec = HopperSpec()
    assert gemm_launch_error(128, 32, 128, 32, 64, 8, 8, 4) is None
    assert gemm_launch_error(8, 8, 8, 8, 8, 2, 2, 4)[0] == "partial_warp"
    assert gemm_launch_error(128, 8, 128, 128, 128, 1, 1, 4)[0] == "threads_over_limit"
    assert gemm_launch_error(128, 8, 128, 48, 64, 8, 8, 4)[0] == "tile_nesting"
    assert gemm_launch_error(32, 8, 32, 32, 32, 1, 1, 4) is None  # 1024 threads
    assert gemm_launch_error(
        128, 8, 128, 32, 64, 8, 8, 4, grid_m=spec.max_grid_y + 1
    )[0] == "grid_too_large"


def test_repro_torch_imports_no_jax_and_no_repro():
    """The port stands alone: importing every module of it, and running a
    round of each learned tuner (whose JAX twins import JAX lazily, when
    their networks are built), loads neither JAX nor anything of the JAX
    package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "from repro_torch.core import AnalyticalHopperCost, Budget, GemmConfigSpace\n"
        "from repro_torch.core.tuners import NA2CTuner, RNNControllerTuner\n"
        "space = GemmConfigSpace(64, 64, 64)\n"
        "cost = AnalyticalHopperCost(space, dtype='float32')\n"
        "for cls, n in ((NA2CTuner, 1 + 16), (RNNControllerTuner, 1 + 8)):\n"
        "    res = cls(space, cost, device='cpu').tune(Budget(max_trials=n + 1))\n"
        "    assert res.n_trials == n + 1, res.n_trials  # one round trained, one more began\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'flax'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 30 else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
