"""The program's spans in a run: device time and idle time by span, and
set-up's parts.

The port opens a span (``repro_torch/utils/spans.py``) at each layer
boundary; under the profiler each is a host range on the profiler's
clock.  A kernel runs after its launch, often inside later spans, so a
device operation is not placed by time: it goes to the spans that were
open on the host when it was **launched**, found through the profiler's
link from the operation to the runtime call that launched it (both carry
one correlation id).  A kernel replayed from a CUDA graph carries the id
of the graph's launch, so it goes to the span of the replay
(``serve.decode``).  Device seconds by span name are inclusive: a kernel
counts to every span open at its launch.  Each idle gap of the traced
window goes to the innermost program span open on the host at its
middle.  Where no program span is open, the label is
:data:`OUTSIDE`.

The program's table of timed spans (``span_totals()``) is read through
:func:`program_span_totals`, which gives nothing for a program without
spans.  :func:`setup_parts` splits a run's ``setup_s`` by it.

A ``--trace 1`` run of ``perfbench.run`` keeps :func:`attribute`'s
summary of its traced batches as ``ctx.spans`` for the metric readers
(:func:`device_ms`).  Besides, one command serves a cell's set-up and its
traced batches and prints all of this as one JSON line:

    python3 -m perfbench.spans --workload qwen3-moe-235b-a22b.long-prompt \\
        --seed 2147483659
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # before the heavy imports, as perfbench.run's

import collections  # noqa: E402
import dataclasses  # noqa: E402

from .trace import TRACED_RANGE, _short  # noqa: E402

__all__ = ["Op", "SpanSummary", "OUTSIDE", "SETUP_SPANS", "MODEL_SPANS", "kineto_ops",
           "attribute", "program_span_totals", "setup_parts", "decode_ms", "device_ms",
           "setup_engine_s", "cell_spans", "main"]

#: the label of device and idle time under no program span
OUTSIDE = "outside the engine"
#: the program's set-up spans, in the order they run
SETUP_SPANS = ("kernels.load", "engine.build", "engine.capture")
#: the spans of the model step: ``serve.prefill``'s time under none of them
#: is the engine's own
MODEL_SPANS = ("model.embed", "block.norm", "block.attn", "block.mlp", "block.moe",
               "model.head")


@dataclasses.dataclass(frozen=True)
class Op:
    """One event of the trace: a host ``span`` (a ``record_function``
    range), a ``launch`` (a CUDA runtime or driver call), ``device`` work,
    or another ``host`` event.  A launch and the device work it launched
    share ``corr``."""

    name: str
    kind: str
    start_ns: int
    dur_ns: int
    corr: int = 0

    @property
    def end_ns(self) -> int:
        return self.start_ns + self.dur_ns


@dataclasses.dataclass
class SpanSummary:
    window_s: float
    busy_s: float
    by_span: dict  # device seconds by span name, inclusive; OUTSIDE for none
    idle_by_span: dict  # idle seconds by the innermost span at each gap's middle
    kernels_by_span: dict  # innermost span at launch -> {kernel: device seconds}


def kineto_ops(prof) -> list[Op]:
    """The events of a ``torch.profiler.profile`` as :class:`Op` s.  On
    the host, a ``record_function`` range is a span and a CUDA runtime or
    driver call (``cuda*``, ``cu*``) a launch: the only link a kernel
    launched through ``ctypes`` or replayed from a graph has, since no
    framework op is open at its launch.  On the device, everything but the
    mirror of a host range is device work."""
    events = prof.profiler.kineto_results.events()
    ranges = {e.name() for e in events
              if e.is_user_annotation() and "CUDA" not in str(e.device_type())}
    out = []
    for e in events:
        if "CUDA" not in str(e.device_type()):
            kind = ("span" if e.is_user_annotation() else
                    "launch" if e.name().startswith("cu") else "host")
        elif e.is_user_annotation() or e.name() in ranges:
            continue
        else:
            kind = "device"
        out.append(Op(e.name(), kind, int(e.start_ns()), int(e.duration_ns()),
                      int(e.correlation_id())))
    return out


class _OpenSpans:
    """The program spans open at a given host time, for times asked in
    increasing order."""

    def __init__(self, spans: list[Op]):
        self._spans = sorted(spans, key=lambda s: s.start_ns)
        self._next, self._open = 0, []

    def at(self, t: int) -> list[Op]:
        while self._next < len(self._spans) and self._spans[self._next].start_ns <= t:
            self._open.append(self._spans[self._next])
            self._next += 1
        self._open = [s for s in self._open if s.end_ns > t]
        return self._open


def _busy_intervals(dev: list[Op], w1: int) -> list[tuple[int, int]]:
    out = []
    for o in sorted(dev, key=lambda o: o.start_ns):
        end = min(o.end_ns, w1)
        if out and o.start_ns <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([o.start_ns, end])
    return [tuple(iv) for iv in out]


def attribute(ops: list[Op]) -> SpanSummary:
    """Device seconds by the spans open at each operation's launch, and
    idle seconds by the innermost span at each gap's middle, over the
    traced window (the harness's range :data:`~perfbench.trace.TRACED_RANGE`;
    an operation counts where it starts inside it, as in
    :func:`perfbench.trace.summarize`)."""
    rng = [o for o in ops if o.kind == "span" and o.name == TRACED_RANGE]
    if len(rng) != 1:
        raise ValueError(f"expected one {TRACED_RANGE!r} range in the trace, found {len(rng)}")
    w0, w1 = rng[0].start_ns, rng[0].end_ns
    spans = [o for o in ops if o.kind == "span" and o.name != TRACED_RANGE]
    dev = [o for o in ops if o.kind == "device" and w0 <= o.start_ns < w1]
    launched = {o.corr: o.start_ns for o in ops if o.kind == "launch"}

    by_span: dict = collections.defaultdict(float)
    kernels: dict = collections.defaultdict(lambda: collections.defaultdict(float))
    timed = sorted(((launched.get(o.corr), o) for o in dev),
                   key=lambda p: -1 if p[0] is None else p[0])
    open_at = _OpenSpans(spans)
    for t, o in timed:
        around = open_at.at(t) if t is not None else []
        for name in {s.name for s in around} or (OUTSIDE,):
            by_span[name] += o.dur_ns / 1e9
        inner = min(around, key=lambda s: s.dur_ns).name if around else OUTSIDE
        kernels[inner][_short(o.name)] += o.dur_ns / 1e9

    busy = _busy_intervals(dev, w1)
    idle: dict = collections.defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    open_at = _OpenSpans(spans)
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 > g0:
            around = open_at.at((g0 + g1) // 2)
            idle[min(around, key=lambda s: s.dur_ns).name if around else OUTSIDE] += \
                (g1 - g0) / 1e9
    busy_s = sum(b - a for a, b in busy) / 1e9
    return SpanSummary((w1 - w0) / 1e9, busy_s, dict(by_span), dict(idle),
                       {k: dict(v) for k, v in kernels.items()})


# -- the program's table of timed spans ------------------------------------------------


def program_span_totals() -> dict:
    """The program's timed spans (seconds by name) so far in this
    process, or ``{}`` where the program has no spans."""
    try:
        from repro_torch.utils.spans import span_totals
    except ImportError:  # a program without spans
        return {}
    return span_totals()


def setup_parts(totals: dict, setup_s: float, imports_s: float) -> dict:
    """``setup_s`` by part: ``imports`` (process start to the imports'
    end), the set-up spans, ``warm-up`` (the warm-up's ``serve.generate``
    calls) and ``rest`` (under no program span: the CUDA context, the
    weights, the records).  ``totals`` are the program's timed spans at
    set-up's end."""
    parts = {"imports": imports_s}
    parts.update({name: totals.get(name, 0.0) for name in SETUP_SPANS})
    parts["warm-up"] = totals.get("serve.generate", 0.0)
    parts["rest"] = setup_s - sum(parts.values())
    return parts


# -- metric readers ------------------------------------------------------------------


def decode_ms(ctx):
    """The engine's decode time a batch over the window (``serve.decode``'s
    seconds, ``stats['decode_s']``: the graph's replay and the tokens'
    copy to the host)."""
    return 1e3 * sum(b.decode_s for b in ctx.batches) / len(ctx.batches)


def device_ms(ctx, *names):
    """Device milliseconds a traced batch launched under the spans
    ``names``, summed (disjoint spans: siblings, not one inside another),
    from the run's ``ctx.spans``; None for an untraced run or where the
    trace holds none of them."""
    found = [ctx.spans.by_span[n] for n in names if n in ctx.spans.by_span] if ctx.spans else []
    if not found:
        return None
    return 1e3 * sum(found) / len(ctx.traced_batches())


def setup_engine_s(ctx):
    """``engine.build`` + ``engine.capture`` over set-up: the program's
    table, read after the window, which builds no engine, in a process
    that ran one cell (a run's).  None for a program without spans."""
    totals = program_span_totals()
    if "engine.build" not in totals:
        return None
    return totals["engine.build"] + totals.get("engine.capture", 0.0)


# -- one cell's spans ----------------------------------------------------------------


def cell_spans(cell, seed: int, device="cuda", state_dir=None, imports_s: float = 0.0,
               t_start: float = T_START, untraced: int = 2, top: int = 6) -> dict:
    """A cell's set-up (``perfbench.run.set_up``, from ``t_start``), its
    parts, then ``untraced`` window batches and the mix's traced batches
    under the profiler: their engine times, device and idle seconds by
    span, and the ``top`` kernels of each innermost span."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import run, system

    on_card = torch.device(device).type == "cuda"
    sv = run.set_up(cell, seed, device, state_dir or run.STATE_DIR)
    setup_s = time.perf_counter() - t_start
    parts = setup_parts(program_span_totals(), setup_s, imports_s)

    engine, mix, vocab = sv.engine, sv.mix, sv.config["vocab_size"]
    n0 = len(engine.stats["prefill_s"])
    for i in range(untraced):
        run._serve(engine, mix.draw(seed, mix.trace_batches + i, vocab))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        with record_function(TRACED_RANGE):
            for i in range(mix.trace_batches):
                run._serve(engine, mix.draw(seed, i, vocab))
    summary = attribute(kineto_ops(prof))
    del prof
    bs = summary.by_span
    model = sum(bs.get(n, 0.0) for n in MODEL_SPANS)
    moe = sum(bs.get(f"moe.{n}", 0.0) for n in ("route", "dispatch", "experts", "combine"))
    stats = engine.stats
    system.release_engine(engine)
    return {
        "first_run": sv.first_run, "setup_s": setup_s, "setup_parts": parts,
        "untraced_prefill_ms": [1e3 * x for x in stats["prefill_s"][n0:n0 + untraced]],
        "untraced_decode_ms": [1e3 * x for x in stats["decode_s"][n0:n0 + untraced]],
        "traced_prefill_ms": [1e3 * x for x in stats["prefill_s"][n0 + untraced:]],
        "traced_decode_ms": [1e3 * x for x in stats["decode_s"][n0 + untraced:]],
        "window_s": summary.window_s, "busy_s": summary.busy_s,
        "by_span": bs, "idle_by_span": summary.idle_by_span,
        "top_kernels_by_span": {
            name: sorted(([k, v] for k, v in ks.items()), key=lambda kv: -kv[1])[:top]
            for name, ks in summary.kernels_by_span.items()},
        "model_share_of_prefill": model / bs["serve.prefill"] if bs.get("serve.prefill")
        else None,
        "moe_share_of_block_moe": moe / bs["block.moe"] if bs.get("block.moe") else None,
    }


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description="one cell's spans: set-up's parts, device and "
                                             "idle time by span over the traced batches")
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    import torch

    from . import run, specs

    imports_s = time.perf_counter() - T_START
    cell = specs.load_cell(args.workload)
    if not torch.cuda.is_available():
        run.log(f"{args.workload} needs a CUDA card")
        return 2
    result = {"workload": args.workload, "seed": args.seed,
              "device": torch.cuda.get_device_name(), "power_limit": run.power_limit()}
    result.update(cell_spans(cell, args.seed, imports_s=imports_s))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
