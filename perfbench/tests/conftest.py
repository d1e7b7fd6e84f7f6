"""The benchmark's CPU tests: run from the repository's root with
``python -m pytest perfbench/tests``."""

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

BENCH = os.path.join(ROOT, "perfbench")

#: each configuration at a tiny size: the published file with its widths cut
TINY = {
    "qwen2-72b": dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                      intermediate_size=128, vocab_size=256, num_hidden_layers=2),
    "qwen3-moe-235b-a22b": dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                                head_dim=16, moe_intermediate_size=32, num_experts=8,
                                num_experts_per_tok=2, vocab_size=256, num_hidden_layers=2),
}
TINY_TRAFFIC = dict(name="tiny", batch=4, prompt_len={"low": 24, "high": 64}, bucket=64,
                    gen_tokens=6, token_ids="uniform", warmup_batches=1, trace_batches=1)


def tiny_config(name: str, **extra) -> dict:
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY[name])
    cfg.update(extra)
    return cfg


def tiny_cell(name: str, limits: dict = None, **extra):
    """A cell of configuration ``name`` at a tiny size, comparing what its
    full-size cells compare (``limits``: by default the widest gap)."""
    from perfbench import specs

    bench = specs.load_benchmark(ROOT)
    like = f"{name}.long-prompt"
    config = tiny_config(name, **extra)
    return specs.Cell(name=f"tiny-{name}", chips=1, config=config,
                      architecture=specs.architecture_of(config),
                      traffic=copy.deepcopy(TINY_TRAFFIC),
                      check={"tune_trials": 2, "check_requests": 4,
                             "limits": limits or {"widest_gap": 0.25}},
                      end_to_end=specs.metrics_for(bench["end_to_end"], like),
                      per_layer=specs.metrics_for(bench["per_layer"], like))


@pytest.fixture
def state_dir(tmp_path):
    return str(tmp_path / "state")
