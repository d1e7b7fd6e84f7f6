"""The port's serving engine and CLIs held against the JAX package's:
greedy tokens of ragged, bucket-padded requests on the reduced yi-6b
(f32, reference params carried across), a tuned flash record driving
dispatch on both sides, ``tune --op flash`` writing flash-scoped records
on the CPU, and the entry points refusing to run without a card unless
asked for the CPU."""

import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.core.records import TuningRecords as RefRecords
from repro.core.records import set_global_records as ref_set_records
from repro.core.records import workload_key_for as ref_key
from repro.kernels import ops as ref_ops
from repro.launch.serve import ServeEngine as RefEngine
from repro.models.api import Model as RefModel
from repro_torch.configs.registry import get_arch
from repro_torch.core.flash_space import FlashScheduleState
from repro_torch.core.records import TuningRecords, global_records, set_global_records, workload_key_for
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import default_blocks
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import tune as tune_cli
from repro_torch.launch.serve import ServeEngine
from repro_torch.models.transformer import params_from_reference


@pytest.fixture
def clean_dispatch():
    saved_ref, saved_port = ref_ops.kernel_policy(), global_records()
    yield
    ref_ops.set_kernel_policy(saved_ref)
    ref_set_records(RefRecords())
    set_global_records(saved_port)
    ops.set_kernel_policy(ops.KernelPolicy())
    ops.reset_dispatch_stats()


def test_engine_tokens_match_reference_on_ragged_prompts(clean_dispatch):
    cfg, ref_cfg = get_arch("yi-6b").reduced(), ref_get_arch("yi-6b").reduced()
    ref_params = RefModel(ref_cfg).init_params(jax.random.PRNGKey(0))
    params = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
    seq, hd, gen = 128, cfg.resolved_head_dim, 5
    state = FlashScheduleState((4, 32), (2, 64))  # blocks (32, 64)
    rec = RefRecords()
    rec.update(ref_key("flash", (seq, seq, hd), "float32", "analytical_tpu_v5e"),
               state, cost=1.0, tuner="test", n_trials=1)
    ref_set_records(rec)
    ref_ops.set_kernel_policy(ref_ops.KernelPolicy(use_pallas=True, interpret=True,
                                                   pallas_ops=("flash",)))
    port_rec = TuningRecords()
    port_rec.update(workload_key_for("flash", (seq, seq, hd), "float32", "hopper_timed"),
                    state, cost=1.0, tuner="test", n_trials=1)
    set_global_records(port_rec)

    rng = np.random.default_rng(3)
    lens = np.array([100, 71, 90], np.int32)
    prompts = np.zeros((3, 100), np.int32)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(0, cfg.vocab_size, n)
    ref_engine = RefEngine(ref_cfg, ref_params, max_batch=4, max_len=seq + gen,
                           prompt_buckets=[64, seq], gen_buckets=[gen])
    ref_out = ref_engine.generate(prompts, gen, prompt_lens=lens)

    ops.reset_dispatch_stats()
    engine = ServeEngine(cfg, params, max_batch=4, max_len=seq + gen,
                         prompt_buckets=[64, seq], device="cpu")
    out = engine.generate(prompts, gen, prompt_lens=lens)
    np.testing.assert_array_equal(out, ref_out)
    assert ops.dispatch_stats()["flash"]["records"] == cfg.n_layers
    assert engine.stats["prefill_buckets"] == {seq: 1} and engine.stats["bucket_misses"] == 0
    assert engine.last_timing["prompt_bucket"] == seq

    # an unbucketed prompt is served at its own length and counted
    short = engine.generate(prompts[:1, :20], 3)
    assert short.shape == (1, 3) and engine.stats["prefill_buckets"][64] == 1
    with pytest.raises(ValueError):
        engine.generate(np.zeros((1, 200), np.int32), 3)  # beyond the cache


def test_flash_dispatch_checks_the_served_grid(clean_dispatch):
    """A record and the heuristic blocks are held to the served grid of
    batch x query heads: one taller than gridDim.y takes neither."""
    rec = TuningRecords()
    rec.update(workload_key_for("flash", (128, 128, 16), "float32", "hopper_timed"),
               FlashScheduleState((4, 32), (2, 64)), cost=1.0, tuner="test", n_trials=1)
    set_global_records(rec)
    ops.reset_dispatch_stats()
    assert ops.flash_schedule(128, 128, 16, "float32", grid_y=8 * 32) == (32, 64)
    assert ops.flash_schedule(128, 128, 16, "float32", grid_y=70_000) is None
    assert ops.dispatch_stats()["flash"]["static_reject"] == 1
    assert default_blocks(128, 128, 16, 4, grid_y=8 * 32) == (64, 64)
    assert default_blocks(128, 128, 16, 4, grid_y=70_000) is None


def test_tune_cli_op_flash_writes_flash_records(tmp_path, capsys):
    rec = str(tmp_path / "f.json")
    argv = ["--op", "flash", "--arch", "yi-6b", "--device", "cpu", "--cost", "analytical",
            "--noise", "0", "--max-trials", "12", "--fraction", "1.0", "--records", rec, "--warm-start"]
    tune_cli.main(argv)
    with open(rec) as f:
        data = json.load(f)
    assert list(data) == ["flash/4096x4096x128/bfloat16/analytical_h100"]
    assert data["flash/4096x4096x128/bfloat16/analytical_h100"]["op"] == "flash"
    tune_cli.main(argv)
    out = capsys.readouterr().out
    assert "cache_hit=1.00" in [l for l in out.splitlines() if "flash_s4096 g-bfs" in l][1]
    assert 'flash_launches={}' in out  # the model launches nothing
    with pytest.raises(SystemExit):
        tune_cli.main(["--op", "gemm", "--device", "cpu", "--cost", "analytical",
                       "--records", rec])  # gemm needs --arch


def test_serve_cli_on_the_cpu_serves_a_tuned_flash_record(tmp_path, capsys, clean_dispatch):
    """The loop as a user drives it on the CPU: tune the reduced model's
    flash workload into records, then serve a bucket that dispatches it."""
    rec = TuningRecords(str(tmp_path / "r.json"))
    rec.update(workload_key_for("flash", (128, 128, 16), "float32", "analytical_h100"),
               FlashScheduleState((2, 64), (4, 32)), cost=1.0, tuner="test", n_trials=1)
    serve_cli.main(["--arch", "yi-6b", "--reduced", "--device", "cpu", "--requests", "2",
                    "--prompt-len", "100", "--gen", "3", "--buckets", "128",
                    "--records", str(tmp_path / "r.json")])
    out = capsys.readouterr().out
    assert "[serve] yi-6b: 2 requests x 3 tokens (bucket 128) on cpu" in out
    stats = ops.dispatch_stats()["flash"]
    assert stats["records"] == 2 and stats["heuristic"] == 0


def test_entry_points_refuse_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as exc:
        serve_cli.main(["--arch", "yi-6b", "--reduced"])
    assert exc.value.code == 2
    with pytest.raises(SystemExit) as exc:
        tune_cli.main(["--op", "flash", "--records", str(tmp_path / "r.json")])
    assert exc.value.code == 2
    cfg = get_arch("yi-6b").reduced()
    with pytest.raises(RuntimeError):
        ServeEngine(cfg, {}, max_batch=1, max_len=8)
