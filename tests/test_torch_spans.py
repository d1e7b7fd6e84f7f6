"""The port's spans (``repro_torch/utils/spans.py``) on the CPU: off, a
span is one shared no-op and times nothing unless asked; under the
profiler, a tiny engine's ``generate`` shows the serving, model, block
and MoE spans nested as the layers call each other, with the call's and
the block's index; the tokens do not move with the profiler; the timed
spans are what the engine reports (``stats``, ``prewarm_s``)."""

import contextlib
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import get_arch
from repro_torch.launch.serve import ServeEngine
from repro_torch.models.api import Model
from repro_torch.utils import spans
from repro_torch.utils.spans import reset_span_totals, span, span_totals

MOE_PARTS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
GEN = 4


@pytest.fixture
def clean_totals():
    reset_span_totals()
    yield
    reset_span_totals()


def _engine(name: str):
    cfg = get_arch(name).reduced()
    params = Model(cfg, device="cpu").init_params(seed=0)
    return cfg, ServeEngine(cfg, params, max_batch=2, max_len=40, prompt_buckets=[32],
                            gen_buckets=[GEN], device="cpu")


def _prompts(cfg):
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 32))
    lens = np.array([32, 20])
    prompts[1, 20:] = 0
    return prompts, lens


def _ranges(prof) -> list:
    """The profiler's ``record_function`` ranges: ``(name, start, end)``,
    outer before inner."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _inside(ranges, outer, name: str) -> list:
    return [r for r in ranges if r[0] == name and outer[1] <= r[1] and r[2] <= outer[2]]


def test_a_span_with_the_profiler_off_is_one_shared_no_op(clean_totals):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert span("block.attn", 3) is span("moe.route")
    assert isinstance(span("x"), contextlib.nullcontext)
    with span("x"), span("y", 1):
        pass
    assert span_totals() == {}


def test_a_span_under_the_profiler_is_a_range(clean_totals):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer", 7):
            with span("inner"):
                torch.ones(4).sum()
    ranges = _ranges(prof)
    assert [r[0] for r in ranges] == ["outer", "inner"]
    assert ranges[0][1] <= ranges[1][1] and ranges[1][2] <= ranges[0][2]
    assert span_totals() == {}  # untimed spans time nothing, traced or not


def test_timed_spans_add_their_seconds_and_reset_clears(clean_totals):
    with span("t", timed=True) as first:
        time.sleep(0.01)
    with span("t", timed=True) as second:
        pass
    assert first.seconds >= 0.01
    assert span_totals() == {"t": pytest.approx(first.seconds + second.seconds)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("t", timed=True):
            pass
    assert [r[0] for r in _ranges(prof)] == ["t"]  # a timed span is a range too
    reset_span_totals()
    assert span_totals() == {}


def test_timed_span_records_even_when_its_body_raises(clean_totals):
    with pytest.raises(ValueError):
        with span("failing", timed=True):
            raise ValueError("boom")
    assert "failing" in span_totals()


def test_engine_build_and_capture_are_timed(clean_totals):
    cfg, engine = _engine("qwen3-moe-235b-a22b")
    totals = span_totals()
    assert set(totals) == {"engine.build", "engine.capture"}
    assert totals["engine.build"] > 0
    assert engine.prewarm_s == totals["engine.capture"] > 0
    prompts, lens = _prompts(cfg)
    engine.generate(prompts, GEN, prompt_lens=lens)
    totals = span_totals()
    assert engine.stats["prefill_s"] == [totals["serve.prefill"]]
    assert engine.stats["decode_s"] == [totals["serve.decode"]]
    parts = ("serve.request", "serve.program", "serve.prefill", "serve.decode")
    assert sum(totals[p] for p in parts) <= totals["serve.generate"]
    reset_span_totals()
    assert span_totals() == {}


@pytest.mark.parametrize("name,mlp", [("qwen3-moe-235b-a22b", "block.moe"),
                                      ("yi-6b", "block.mlp")])
def test_generate_nests_the_spans_of_every_layer(name, mlp, clean_totals):
    cfg, engine = _engine(name)
    prompts, lens = _prompts(cfg)
    engine.generate(prompts, GEN, prompt_lens=lens)  # first call's set-up not traced
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.generate(prompts, GEN, prompt_lens=lens)
    ranges = _ranges(prof)
    (gen,) = [r for r in ranges if r[0] == "serve.generate"]
    for part in ("serve.request", "serve.program", "serve.prefill", "serve.decode"):
        assert len(_inside(ranges, gen, part)) == 1, part
    (prefill,) = _inside(ranges, gen, "serve.prefill")
    for once in ("model.embed", "model.head"):
        assert len(_inside(ranges, prefill, once)) == 1, once
    blocks = _inside(ranges, prefill, mlp)
    assert len(blocks) == cfg.n_layers
    assert len(_inside(ranges, prefill, "block.attn")) == cfg.n_layers
    assert len(_inside(ranges, prefill, "block.norm")) == 2 * cfg.n_layers
    for block in blocks:  # one set of the MoE's passes a block, in order
        parts = [r[0] for r in ranges if r[0].startswith("moe.")
                 and block[1] <= r[1] and r[2] <= block[2]]
        assert parts == (list(MOE_PARTS) if mlp == "block.moe" else [])
    other = "block.mlp" if mlp == "block.moe" else "block.moe"
    assert not [r for r in ranges if r[0] == other]


def test_spans_carry_the_call_and_block_index(monkeypatch, clean_totals):
    """The call's index goes to every span of a ``generate``; the block's
    to its block spans."""
    cfg, engine = _engine("qwen3-moe-235b-a22b")
    prompts, lens = _prompts(cfg)
    engine.generate(prompts, GEN, prompt_lens=lens)
    opened = []

    @contextlib.contextmanager
    def record(name, args=None):
        opened.append((name, args))
        yield

    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    monkeypatch.setattr(torch.profiler, "record_function", record)
    engine.generate(prompts, GEN, prompt_lens=lens)
    monkeypatch.undo()
    serve = [(n, a) for n, a in opened if n.startswith("serve.")]
    assert serve == [(n, "1") for n in ("serve.generate", "serve.request", "serve.program",
                                        "serve.prefill", "serve.decode")]
    prefill_blocks = [a for n, a in opened if n == "block.moe"][:cfg.n_layers]
    assert prefill_blocks == [str(i) for i in range(cfg.n_layers)]
    assert all(a is None for n, a in opened if n.startswith(("moe.", "model.")))


@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "yi-6b"])
def test_tokens_do_not_move_with_the_profiler(name, clean_totals):
    cfg, engine = _engine(name)
    prompts, lens = _prompts(cfg)
    off = engine.generate(prompts, GEN, prompt_lens=lens)
    with profile(activities=[ProfilerActivity.CPU]):
        on = engine.generate(prompts, GEN, prompt_lens=lens)
    np.testing.assert_array_equal(on, off)


def test_training_keeps_its_span_names(clean_totals):
    """``train.*`` and ``remat.*`` moved onto the helper with their names."""
    from repro_torch.optim import make_optimizer
    from repro_torch.train.step import make_train_step

    cfg = get_arch("yi-6b").reduced(remat="full")
    model = Model(cfg, device="cpu")
    params = model.init_params(seed=0)
    opt = make_optimizer("adamw", 1e-3)
    step = make_train_step(model, opt)
    toks = torch.randint(0, cfg.vocab_size, (2, 16))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, opt.init(params), {"tokens": toks, "labels": toks})
    names = {r[0] for r in _ranges(prof)}
    assert {"train.grads", "train.clip", "train.update", "remat.forward",
            "remat.recompute", "block.attn", "block.mlp"} <= names


def test_generate_opens_no_range_with_the_profiler_off(monkeypatch, clean_totals):
    cfg, engine = _engine("qwen3-moe-235b-a22b")
    prompts, lens = _prompts(cfg)

    def refuse(*args, **kwargs):
        raise AssertionError("a range was opened with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    engine.generate(prompts, GEN, prompt_lens=lens)
    assert spans._NULL is span("block.attn", 0)
