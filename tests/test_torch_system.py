"""End-to-end behaviour of the port on the CPU — the twin of
``tests/test_system.py``: tune -> record -> reload -> dispatch -> execute,
as a user drives it, plus the tune CLI.  The measured backend needs a
card, so the CPU runs use the analytical H100 model; the result is held
against the JAX package's Pallas GEMM on the same numpy inputs."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.gemm import default_config as ref_default_config
from repro.kernels.gemm import gemm_pallas
from repro_torch.core import (
    AnalyticalHopperCost,
    Budget,
    TuningRecords,
    TuningSession,
    Workload,
    global_records,
    set_global_records,
    workload_key_for,
)
from repro_torch.kernels import ops
from repro_torch.launch import tune as tune_cli


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.05)])
def test_end_to_end_tune_record_dispatch(tmp_path, dtype, tol):
    """TuningSession finds a config, persists it, a reloaded store serves
    it through gemm(), and the product matches the Pallas kernel's."""
    old = global_records()
    try:
        records = TuningRecords(str(tmp_path / "r.json"))
        session = TuningSession(records, cost_factory=AnalyticalHopperCost, verbose=False)
        wl = Workload("gemm", (128, 128, 128), dtype=dtype)
        res = session.tune_workload(wl, "g-bfs", Budget(max_fraction=0.05), warm_start=True)
        assert res.best_state is not None and np.isfinite(res.best_cost)
        key = workload_key_for("gemm", (128, 128, 128), dtype, "analytical_h100")
        assert records.lookup_state(key) is not None

        records2 = TuningRecords(str(tmp_path / "r.json"))  # a fresh process
        assert records2.lookup_state(key).key() == records.lookup_state(key).key()
        set_global_records(records2)
        ops.set_kernel_policy(ops.KernelPolicy(cost_backend="analytical_h100"))
        ops.reset_dispatch_stats()
        rng = np.random.default_rng(0)
        a, b = rng.standard_normal((128, 128)), rng.standard_normal((128, 128))
        out = ops.gemm(torch.tensor(a).to(getattr(torch, dtype)),
                       torch.tensor(b).to(getattr(torch, dtype)), device="cpu")
        ref = gemm_pallas(jnp.asarray(a, dtype), jnp.asarray(b, dtype),
                          ref_default_config(128, 128, 128), interpret=True)
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                                   rtol=tol, atol=tol * 8)
        assert ops.dispatch_stats()["gemm"]["records"] == 1
    finally:
        set_global_records(old)
        ops.set_kernel_policy(ops.KernelPolicy())
        ops.reset_dispatch_stats()


def test_tune_cli_on_the_model(tmp_path, capsys):
    """The CLI tunes yi-6b's five GEMMs, writes records, and a
    warm-started rerun is served from the journal."""
    rec = str(tmp_path / "yi.json")
    argv = ["--arch", "yi-6b", "--device", "cpu", "--cost", "analytical",
            "--noise", "0", "--max-trials", "25", "--records", rec, "--warm-start"]
    tune_cli.main(argv)
    with open(rec) as f:
        data = json.load(f)
    assert len(data) == 5
    assert all(k.endswith("/bfloat16/analytical_h100") for k in data)
    tune_cli.main(argv + ["--analyze", "prune"])
    out = capsys.readouterr().out
    qkv = [l for l in out.splitlines() if l.startswith("[tune] yi-6b/qkv")]
    assert "cache_hit=1.00" in qkv[1]  # the rerun starts from the journaled best
    assert "kernel_launches={}" in out  # the model launches nothing


def test_tune_cli_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for argv in (["--arch", "yi-6b"], ["--arch", "yi-6b", "--device", "cpu"]):
        with pytest.raises(SystemExit) as exc:
            tune_cli.main(argv + ["--records", str(tmp_path / "r.json")])
        assert exc.value.code == 2
