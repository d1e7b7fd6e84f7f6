"""Reading the program's spans (``perfbench/spans.py``) on synthetic
events: device work goes to the spans open at its launch, not at its
run; a graph's replayed kernels to the replay's span; sums are inclusive
of nesting; idle gaps by the innermost span at their middle.  Then a
tiny cell on the CPU: its traced run reads the new metrics, and the
spans command's function splits set-up and reads every span."""

import pytest

from conftest import tiny_cell
from perfbench import run, spans
from perfbench.spans import OUTSIDE, Op, attribute
from perfbench.trace import TRACED_RANGE


def span(name, start, end):
    return Op(name, "span", start, end - start)


def launch(corr, at, name="cudaLaunchKernel"):
    return Op(name, "launch", at, 5, corr=corr)


def kernel(corr, start, dur, name="k"):
    return Op(name, "device", start, dur, corr=corr)


#: one batch: generate [100, 1000) over prefill [110, 500) (block.moe
#: [120, 400): moe.route [120, 200), moe.dispatch [200, 260), moe.experts
#: [260, 400)) and decode [500, 990)
BATCH = [
    span(TRACED_RANGE, 0, 2000),
    span("serve.generate", 100, 1000),
    span("serve.prefill", 110, 500),
    span("block.moe", 120, 400),
    span("moe.route", 120, 200),
    span("moe.dispatch", 200, 260),
    span("moe.experts", 260, 400),
    span("serve.decode", 500, 990),
]


def test_a_kernel_counts_where_it_was_launched_not_where_it_ran():
    ops = BATCH + [
        launch(1, 150), kernel(1, 160, 40),   # routing, run inside moe.route
        launch(2, 210), kernel(2, 300, 50),   # launched in dispatch, run in experts
        launch(3, 270), kernel(3, 350, 100),  # experts, past block.moe's end
    ]
    s = attribute(ops)
    assert s.by_span["moe.route"] == pytest.approx(40e-9)
    assert s.by_span["moe.dispatch"] == pytest.approx(50e-9)
    assert s.by_span["moe.experts"] == pytest.approx(100e-9)
    assert s.kernels_by_span == {n: {"k": pytest.approx(v)} for n, v in
                                 (("moe.route", 40e-9), ("moe.dispatch", 50e-9),
                                  ("moe.experts", 100e-9))}


def test_sums_are_inclusive_of_nesting():
    ops = BATCH + [launch(1, 150), kernel(1, 160, 40), launch(2, 210), kernel(2, 300, 50),
                   launch(3, 270), kernel(3, 350, 100), launch(4, 450), kernel(4, 460, 30)]
    s = attribute(ops)
    assert s.by_span["block.moe"] == pytest.approx(190e-9)
    assert s.by_span["serve.prefill"] == pytest.approx(220e-9)  # 30 outside the block
    assert s.by_span["serve.generate"] == pytest.approx(220e-9)
    assert OUTSIDE not in s.by_span
    assert sum(s.by_span[f"moe.{n}"] for n in ("route", "dispatch", "experts")) == \
        pytest.approx(s.by_span["block.moe"])


def test_graph_replayed_kernels_count_to_the_replay_span():
    """Every kernel of a graph carries the id of its one launch."""
    ops = BATCH + [launch(9, 510, "cudaGraphLaunch")] + [
        kernel(9, 520 + 60 * i, 50, name=f"graph kernel {i}") for i in range(8)]
    s = attribute(ops)
    assert s.by_span == {"serve.decode": pytest.approx(400e-9),
                         "serve.generate": pytest.approx(400e-9)}


def test_a_kernel_launched_under_no_span_counts_outside_the_engine():
    ops = BATCH + [launch(5, 1200), kernel(5, 1210, 10), kernel(6, 1500, 10)]
    s = attribute(ops)
    assert s.by_span == {OUTSIDE: pytest.approx(20e-9)}  # the second: no launch seen


def test_work_outside_the_window_is_not_counted():
    ops = BATCH + [launch(1, 150), kernel(1, 2500, 40)]
    assert attribute(ops).by_span == {}


def test_idle_gaps_by_the_innermost_span_at_their_middle():
    ops = BATCH + [
        launch(1, 120), kernel(1, 120, 60),     # busy [120, 180)
        launch(2, 200), kernel(2, 230, 170),    # busy [230, 400): gap [180, 230) mid 205
        launch(3, 500), kernel(3, 600, 1300),   # busy [600, 1900): gap [400, 600) mid 500
    ]
    s = attribute(ops)
    assert s.busy_s == pytest.approx((60 + 170 + 1300) * 1e-9)
    assert s.window_s == pytest.approx(2000e-9)
    # [0, 120) mid 60 and [1900, 2000) mid 1950: no span; [180, 230): dispatch;
    # [400, 600) mid 500: decode
    assert s.idle_by_span == {OUTSIDE: pytest.approx(220e-9),
                              "moe.dispatch": pytest.approx(50e-9),
                              "serve.decode": pytest.approx(200e-9)}
    assert sum(s.idle_by_span.values()) + s.busy_s == pytest.approx(s.window_s)


def test_the_window_is_one_traced_range():
    with pytest.raises(ValueError, match="one"):
        attribute(BATCH[1:])


def test_setup_parts_add_up_to_setup_s():
    totals = {"kernels.load": 1.5, "engine.build": 0.5, "engine.capture": 2.0,
              "serve.generate": 4.0, "serve.prefill": 3.9}
    parts = spans.setup_parts(totals, 20.0, 3.0)
    assert list(parts) == ["imports", "kernels.load", "engine.build", "engine.capture",
                           "warm-up", "rest"]
    assert parts["warm-up"] == 4.0 and parts["rest"] == pytest.approx(9.0)
    assert sum(parts.values()) == pytest.approx(20.0)


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.setattr(spans, "program_span_totals", lambda: {})
    assert spans.setup_engine_s(None) is None


@pytest.fixture
def fresh_totals():
    from repro_torch.utils.spans import reset_span_totals

    reset_span_totals()
    yield
    reset_span_totals()


def test_a_tiny_traced_run_reads_the_span_metrics(state_dir, fresh_totals):
    result, ctx = run.run_cell(tiny_cell("qwen3-moe-235b-a22b", limits={"gap_mean": 1e-3},
                                         torch_dtype="float32"),
                               2 ** 31 + 29, 0.3, True, device="cpu", state_dir=state_dir)
    m = result["metrics"]
    assert m["engine.decode_ms.prompt"]["value"] == pytest.approx(
        1e3 * sum(b.decode_s for b in ctx.batches) / len(ctx.batches))
    assert m["engine.decode_ms.prompt"]["unit"] == "ms"
    assert m["setup.engine_s"]["value"] > 0 and m["setup.engine_s"]["unit"] == "s"
    assert result["correct"]


def test_cell_spans_splits_set_up_and_reads_every_span(state_dir, fresh_totals):
    out = spans.cell_spans(tiny_cell("qwen2-72b"), 2 ** 31 + 31, device="cpu",
                           state_dir=state_dir, imports_s=0.0, untraced=1)
    parts = out["setup_parts"]
    assert sum(parts.values()) == pytest.approx(out["setup_s"])
    assert parts["engine.build"] > 0 and parts["warm-up"] > 0 and parts["kernels.load"] == 0
    assert len(out["untraced_prefill_ms"]) == 1 and len(out["traced_prefill_ms"]) == 1
    assert out["by_span"] == {} and out["busy_s"] == 0  # no device work on the CPU
    assert sum(out["idle_by_span"].values()) == pytest.approx(out["window_s"])
