"""A whole run on the CPU at a tiny size, past the look for a card: sound,
it comes out correct; with the served path broken underneath, once for
each fault a served cell can have (:mod:`perfbench.faults`), it comes out
not correct.  (The
exchange between cards is a fault no cell here can have: every cell runs
on one card.)  Each configuration compares what its cells compare: the
dense one the widest gap (bf16, at rounding when sound), the MoE one the
mean gap (float32, where the port is exact; in bf16 rounding flips
routing choices at this size)."""

import pytest

from conftest import tiny_cell
from perfbench import faults, run, specs

DECODER = specs.load_architecture("decoder")


CELLS = {
    # program 0-0.012, the fp8 control 0.14-0.46 at this size (six seeds each)
    "qwen2-72b": dict(limits={"widest_gap": 0.05}),
    "qwen3-moe-235b-a22b": dict(limits={"gap_mean": 1e-3}, torch_dtype="float32"),
}


def run_tiny(state_dir, name="qwen2-72b", traced=False):
    return run.run_cell(tiny_cell(name, **CELLS[name]), 2 ** 31 + 17, 0.3, traced,
                        device="cpu", state_dir=state_dir)


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(state_dir, name, traced):
    result, ctx = run_tiny(state_dir, name, traced=traced)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 4
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    names = set(result["metrics"])
    assert result["first_run"] is False  # the CPU tunes nothing
    if traced:
        assert "engine.prefill_ms.prompt" in names and "mfu.prompt" in names
        assert "busy_s" in result["device"] and "breakdown" in result
    else:
        assert names == {"prompt_tok_s", "setup_s"}
        assert all(m["value"] > 0 for m in result["metrics"].values())


@pytest.mark.parametrize("name", sorted(CELLS))
def test_decode_step_that_leaves_its_state_unchanged(state_dir, name):
    """A decode step whose cache write and length advance are lost."""
    with faults.planted("stale_state", DECODER):
        result, _ = run_tiny(state_dir, name)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_half_the_batch_left_out(state_dir, name):
    """The second half of each batch is not served: its rows get the
    first half's answers."""
    with faults.planted("half_batch", DECODER):
        result, _ = run_tiny(state_dir, name)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("where", ["prefill", "decode"])
def test_a_token_altered_where_it_is_produced(state_dir, where, name):
    """One token of each request, the first (from prefill's logits) or a
    later one (a decode step's), replaced by the next id."""
    with faults.planted(f"altered_token.{where}", DECODER):
        result, _ = run_tiny(state_dir, name)
    assert not result["correct"], result["checks"]


def test_every_fault_is_restored(state_dir):
    """Once its block ends, a planted fault leaves the port as it was."""
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import transformer as tf

    before = (tf.decode_step, ServeEngine.generate, ServeEngine._decode_loop)
    assert list(faults.of(DECODER)) == ["stale_state", *faults.FAULTS]
    for name in faults.of(DECODER):
        with faults.planted(name, DECODER):
            assert (tf.decode_step, ServeEngine.generate, ServeEngine._decode_loop) != before
        assert (tf.decode_step, ServeEngine.generate, ServeEngine._decode_loop) == before


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_and_faults_are_judged_as_a_run_is(state_dir, name):
    """``perfbench.control`` at a tiny size: the program's seeds come out
    correct, the fp8 control and each planted fault not, all through the
    check a run makes (``judge.checks`` and ``judge.passes`` against the
    cell's limits)."""
    from perfbench import control

    seeds = [2 ** 31 + 101, 2 ** 31 + 102]
    rows = list(control.readings(tiny_cell(name, **CELLS[name]), seeds, set(seeds), 1,
                                 ("stale_state", "half_batch"), device="cpu",
                                 state_dir=state_dir))
    program = [r for r in rows if r["run"] == "program"]
    planted = [r for r in rows if r["run"].startswith("fault:")]
    assert [r["seed"] for r in program] == seeds and len(planted) == 2
    assert all(r["correct"] and not r["control_correct"] for r in program), program
    assert not any(r["correct"] for r in planted), planted
