"""The port's serving engine and CLIs held against the JAX package's:
greedy tokens of ragged, bucket-padded requests on the reduced yi-6b
(f32, reference params carried across), a tuned flash record driving
dispatch on both sides, the same for every other family (prompts padded
to a bucket, the ssm and hybrid state stopped at each row's length), the decode
programs' keys (prompt jitter reuses one, a records change rebuilds it),
``tune --op flash`` writing flash-scoped records on the CPU, and the
entry points refusing to run without a card unless asked for the CPU.
On the CPU the engine runs its decode loop eagerly; the card's CUDA
graphs are held against that loop in ``test_torch_card.py``."""

import json

import jax
import jax.numpy as jnp
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
from repro_torch.core.config_space import TilingState
from repro_torch.core.flash_space import FlashScheduleState
from repro_torch.core.records import TuningRecords, global_records, set_global_records, workload_key_for
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import default_blocks
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import tune as tune_cli
from repro_torch.launch.serve import ServeEngine
from repro_torch.models.api import Model
from repro_torch.models.transformer import params_from_reference
from test_torch_hybrid import tiny_model


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
    assert default_blocks(128, 128, 16, 4, grid_y=8 * 32) == (128, 64)
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
    assert 'flash_dtype_launches={}' in out
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


# -- every family through the engine -----------------------------------------------


def _family_models(name, **over):
    cfg, ref_cfg = get_arch(name).reduced(**over), ref_get_arch(name).reduced(**over)
    ref_params = RefModel(ref_cfg).init_params(jax.random.PRNGKey(0))
    params = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
    return cfg, ref_cfg, params, ref_params


def _ragged(cfg, lens, width, seed=3):
    rng = np.random.default_rng(seed)
    prompts = np.zeros((len(lens), width), np.int32)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return prompts


#: the paddable families beside dense; the MoE at a capacity that drops no
#: choice (the reference's drop path has a gap, ROADMAP.md)
PADDED = [("qwen3-moe-235b-a22b", {"moe_capacity_factor": 2.0}), ("whisper-tiny", {}),
          ("llava-next-34b", {})]


@pytest.mark.parametrize("name,over", PADDED)
def test_engine_tokens_match_reference_per_family(name, over, clean_dispatch):
    """Ragged prompts padded to a bucket above the reduced threshold, a
    gen bucket above the request: the reference engine's greedy tokens."""
    cfg, ref_cfg, params, ref_params = _family_models(name, **over)
    lens = np.array([90, 71, 77], np.int32)
    prompts = _ragged(cfg, lens, 90)
    ref_engine = RefEngine(ref_cfg, ref_params, max_batch=4, max_len=112,
                           prompt_buckets=[32, 96], gen_buckets=[8])
    ref_out = ref_engine.generate(prompts, 6, prompt_lens=lens)
    engine = ServeEngine(cfg, params, max_batch=4, max_len=112, prompt_buckets=[32, 96],
                         gen_buckets=[8], device="cpu")
    out = engine.generate(prompts, 6, prompt_lens=lens)
    np.testing.assert_array_equal(out, ref_out)
    assert engine.last_timing["gen_bucket"] == 8
    assert engine.cache_report()["captures"] == 1 and engine.cache_report()["replays"] == 1


@pytest.mark.parametrize("name", ["mamba2-130m", "zamba2-1.2b"])
def test_engine_serves_ssm_and_hybrid_at_exact_lengths(name, clean_dispatch):
    """SSM/hybrid prompts right-padded into a bucket (whose pads their
    state takes in none of) give the tokens of the reference engine, which
    runs them at their own length; a ragged batch is served too."""
    cfg, ref_cfg, params, ref_params = _family_models(name)
    # 48 tokens: a multiple of the reduced ssm_chunk (16), as the reference's SSD scan needs
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 48)).astype(np.int32)
    ref_out = RefEngine(ref_cfg, ref_params, max_batch=4, max_len=72,
                        gen_buckets=[8]).generate(prompts, 7)
    engine = ServeEngine(cfg, params, max_batch=4, max_len=72, prompt_buckets=[64],
                         gen_buckets=[8], device="cpu")
    np.testing.assert_array_equal(engine.generate(prompts, 7), ref_out)
    assert engine.last_timing["prompt_bucket"] == 64
    out = engine.generate(prompts, 7, prompt_lens=np.array([48, 33, 48]))
    assert out.shape == (3, 7)
    np.testing.assert_array_equal(out[[0, 2]], ref_out[[0, 2]])


def _ssm_model(name: str):
    """A reduced SSM or hybrid registry arch, or the tiny Nemotron-H pattern
    stack of ``test_torch_hybrid``, with its weights."""
    if name == "nemotron-h-tiny":
        cfg, _, params = tiny_model(seed=2)
        return cfg, params
    cfg = get_arch(name).reduced()
    return cfg, Model(cfg, device="cpu").init_params(seed=2)


@pytest.mark.parametrize("name", ["mamba2-130m", "zamba2-1.2b", "nemotron-h-tiny"])
def test_ragged_ssm_batch_gives_each_row_served_alone(name, clean_dispatch):
    """Rows of 45, 23 and 38 tokens right-padded to a bucket of 48: each
    row's tokens are those it is served alone at its exact length (its
    recurrent state took in no pad, its attention saw no pad K/V), and the
    engine's loop over its static buffers gives ``eager_reference``'s."""
    cfg, params = _ssm_model(name)
    lens = np.array([45, 23, 38])
    prompts = _ragged(cfg, lens, 45, seed=8)
    engine = ServeEngine(cfg, params, max_batch=3, max_len=64, prompt_buckets=[48],
                         gen_buckets=[8], device="cpu")
    out = engine.generate(prompts, 7, prompt_lens=lens)
    assert engine.last_timing["prompt_bucket"] == 48
    np.testing.assert_array_equal(out, engine.eager_reference(prompts, 7, prompt_lens=lens))
    alone = ServeEngine(cfg, params, max_batch=1, max_len=64, gen_buckets=[8], device="cpu")
    for row, n in enumerate(lens):
        np.testing.assert_array_equal(out[row], alone.generate(prompts[row:row + 1, :n], 7)[0])
        assert alone.last_timing["prompt_bucket"] == n


def test_engine_prepends_frontend_embeddings(clean_dispatch):
    """A VLM request with patch embeddings: the engine's tokens equal the
    reference model's greedy loop over the same padded prefill (the
    reference engine serves text only)."""
    cfg, ref_cfg, params, ref_params = _family_models("llava-next-34b")
    ref = RefModel(ref_cfg)
    lens = np.array([40, 27], np.int32)
    prompts = _ragged(cfg, lens, 40)
    fe = np.random.default_rng(6).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    engine = ServeEngine(cfg, params, max_batch=2, max_len=64, prompt_buckets=[48],
                         gen_buckets=[6], device="cpu")
    out = engine.generate(prompts, 5, prompt_lens=lens, frontend_embeds=torch.from_numpy(fe))

    toks = np.zeros((2, 48), np.int32)
    toks[:, :40] = prompts
    valid = lens + 8
    logits, cache = ref.prefill(ref_params, {"tokens": jnp.asarray(toks),
                                             "frontend_embeds": jnp.asarray(fe)},
                                64, last_idx=jnp.asarray(valid - 1))
    cache = dict(cache, valid_len=jnp.asarray(valid), prefill_len=jnp.asarray(56))
    want = []
    for _ in range(5):
        tok = jnp.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None].astype(jnp.int32)
        want.append(np.asarray(tok)[:, 0])
        logits, cache = ref.decode_step(ref_params, cache, tok)
    np.testing.assert_array_equal(out, np.stack(want, 1))
    with pytest.raises(ValueError):  # 8 + 48 + 16 > 64
        engine.generate(prompts, 16, prompt_lens=lens, frontend_embeds=torch.from_numpy(fe))


def test_prompt_jitter_reuses_the_decode_program_and_records_rebuild_it(clean_dispatch):
    """Jitter inside a prompt bucket builds no second decode program (one
    per gen bucket, built at prewarm); a gen bucket miss builds its own; a
    records change builds the bucket's program again, never reusing one
    that dispatched under stale schedules."""
    cfg = get_arch("yi-6b").reduced()
    params = params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, RefModel(ref_get_arch("yi-6b").reduced())
                                    .init_params(jax.random.PRNGKey(0))), "cpu")
    set_global_records(TuningRecords())
    engine = ServeEngine(cfg, params, max_batch=2, max_len=48, prompt_buckets=[16, 32],
                         gen_buckets=[4, 8], device="cpu")
    assert engine.cache_report()["captures"] == 2 and engine.prewarm_s > 0
    rng = np.random.default_rng(0)
    outs = []
    for p in (20, 27, 31):  # one prompt bucket (32), one gen bucket (8)
        outs.append(engine.generate(rng.integers(0, cfg.vocab_size, (2, p)), 7))
    rep = engine.cache_report()
    assert (rep["captures"], rep["replays"], rep["bucket_misses"]) == (2, 3, 0)
    assert all(o.shape == (2, 7) for o in outs)
    engine.generate(rng.integers(0, cfg.vocab_size, (2, 12)), 9)  # gen 9: no bucket
    assert engine.cache_report()["captures"] == 3
    rec = TuningRecords()
    rec.update(workload_key_for("gemm", (64, 64, 128), "float32", "hopper_timed"),
               TilingState((1, 2, 4, 8), (2, 32), (1, 2, 8, 8)), cost=1.0, tuner="test",
               n_trials=1)
    set_global_records(rec)
    engine.generate(rng.integers(0, cfg.vocab_size, (2, 30)), 8)
    assert engine.cache_report()["captures"] == 4
    engine.generate(rng.integers(0, cfg.vocab_size, (2, 18)), 8)
    assert engine.cache_report()["captures"] == 4


@pytest.mark.parametrize("name", ["yi-6b", "whisper-tiny", "mamba2-130m", "llava-next-34b"])
def test_eager_reference_gives_the_engine_tokens(name, clean_dispatch):
    """``eager_reference`` (the greedy loop through the Model API on a
    fresh cache, from the same prefill inputs) gives ``generate``'s tokens
    and builds, replays and counts nothing; on the CPU no launch is
    counted."""
    cfg = get_arch(name).reduced()
    params = Model(cfg, device="cpu").init_params(seed=1)
    paddable = cfg.family != "ssm"
    engine = ServeEngine(cfg, params, max_batch=3, max_len=96,
                         prompt_buckets=[80] if paddable else None, gen_buckets=[8],
                         device="cpu")
    lens = np.array([64, 41, 57]) if paddable else np.full(3, 64)
    prompts = _ragged(cfg, lens, 64, seed=5)
    fe = (torch.from_numpy(np.random.default_rng(7).standard_normal((3, 8, cfg.d_model))
                           .astype(np.float32)) if cfg.family == "vlm" else None)
    out = engine.generate(prompts, 7, prompt_lens=lens, frontend_embeds=fe)
    before = engine.cache_report()
    want = engine.eager_reference(prompts, 7, prompt_lens=lens, frontend_embeds=fe)
    np.testing.assert_array_equal(out, want)
    assert engine.cache_report() == before
    assert all(not c for c in engine.launch_report().values())


def test_engine_checks_that_buckets_fit_the_cache():
    cfg = get_arch("mamba2-130m").reduced()
    params = Model(cfg, device="cpu").init_params(seed=0)
    with pytest.raises(ValueError, match="exceeds max_len"):
        ServeEngine(cfg, params, max_batch=1, max_len=40, prompt_buckets=[32],
                    gen_buckets=[16], device="cpu")


def test_serve_cli_serves_an_ssm_arch_on_the_cpu(capsys, clean_dispatch):
    serve_cli.main(["--arch", "mamba2-130m", "--reduced", "--device", "cpu", "--requests", "2",
                    "--prompt-len", "16", "--gen", "4", "--buckets", "16"])
    out = capsys.readouterr().out
    assert "[serve] mamba2-130m: 2 requests x 4 tokens (bucket 16) on cpu" in out
    assert "captures=1 replays=1" in out
