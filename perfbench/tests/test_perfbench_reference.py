"""The plain reference against the port at a tiny size of each
configuration, and its independence from the program."""

import ast
import os

import numpy as np
import pytest
import torch

from conftest import BENCH, tiny_config
from perfbench import specs, system, weights
from perfbench.traffic import Mix

NAMES = ["qwen2-72b", "qwen3-moe-235b-a22b"]


def served(name, dtype, seed=0, rows=4, bucket=64, gen=6):
    cfg = tiny_config(name, torch_dtype=dtype)
    decoder = specs.architecture_of(cfg)
    arch = system.arch_config(cfg, decoder)
    params, _ = weights.make_params(decoder.layout(cfg, arch.padded_vocab), seed, "cpu")
    engine = system.make_engine(arch, params, rows, bucket, gen, "cpu")
    mix = Mix(name="t", batch=rows, low=bucket // 3, high=bucket, bucket=bucket, gen=gen,
              warmup_batches=0, trace_batches=0)
    b = mix.draw(seed, 0, cfg["vocab_size"])
    tokens = np.array(engine.generate(b.prompts, gen, prompt_lens=b.lens))
    return cfg, params, b, tokens


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_follows_the_port_in_float32(name, seed):
    """In float32 the engine's greedy tokens are the reference's best at
    every served position, prefill and decode through the cache alike
    (the MoE's capacity drops included)."""
    cfg, params, b, tokens = served(name, "float32", seed)
    ref = specs.load_reference(cfg["reference"])
    for coupled in {ref.couples_batch(cfg), True}:
        gaps = ref.served_gaps(cfg, params, b.prompts, b.lens, tokens, coupled=coupled,
                               device="cpu")["gap"]
        assert gaps.shape == tokens.shape
        assert float(gaps.max()) < 1e-4


def test_dense_reference_takes_rows_apart_or_whole():
    """A dense model couples no rows: the reference over the real tokens of
    each row equals the one over the whole padded batch."""
    cfg, params, b, tokens = served("qwen2-72b", "bfloat16")
    ref = specs.load_reference(cfg["reference"])
    assert not ref.couples_batch(cfg)
    apart = ref.served_gaps(cfg, params, b.prompts, b.lens, tokens, coupled=False, device="cpu")
    whole = ref.served_gaps(cfg, params, b.prompts, b.lens, tokens, coupled=True, device="cpu")
    assert torch.allclose(apart["gap"], whole["gap"], atol=1e-4)
    assert float(apart["gap"].max()) < 0.25  # bf16 rounding, not a wrong token


def test_moe_capacity_couples_rows():
    cfg = tiny_config("qwen3-moe-235b-a22b")
    ref = specs.load_reference(cfg["reference"])
    assert ref.couples_batch(cfg)
    assert not ref.couples_batch({**cfg, "serving": {}})


@pytest.mark.parametrize("name,dtype,number", [("qwen2-72b", "bfloat16", "widest_gap"),
                                                ("qwen3-moe-235b-a22b", "float32", "gap_mean")])
def test_control_fails_where_the_program_passes(name, dtype, number):
    """The fp8 control (the reference in the program's place, its weight
    products on float8 e4m3 operands) reads the number its cells compare
    far above the program's at this size: the check's two readings, on
    the CPU (the MoE in float32, where the port is exact)."""
    from perfbench.judge import NUMBERS

    program, control = [], []
    for seed in range(3):
        cfg, params, b, tokens = served(name, dtype, seed)
        ref = specs.load_reference(cfg["reference"])
        out = ref.served_gaps(cfg, params, b.prompts, b.lens, tokens,
                              coupled=ref.couples_batch(cfg), control=True, device="cpu")
        program.append(NUMBERS[number](out["gap"].reshape(-1).numpy()))
        control.append(NUMBERS[number](out["control_gap"].reshape(-1).numpy()))
    assert min(control) > 3 * max(program), (program, control)


def test_reference_imports_nothing_of_the_program():
    for fname in os.listdir(os.path.join(BENCH, "references")):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(BENCH, "references", fname)) as f:
            tree = ast.parse(f.read())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        tops = {n.partition(".")[0] for n in names}
        assert tops <= {"__future__", "contextlib", "math", "torch"}, (fname, tops)
