"""Named spans over the port's layers, on the profiler's clock.

``span(name)`` is a ``torch.profiler.record_function`` range while the
profiler records, so a trace shows each layer's host interval beside the
device work launched inside it; otherwise it is one shared no-op context,
and a span costs one attribute read.  ``args`` (a batch's call index, a
block's index) goes into the trace with the range.

``span(name, timed=True)`` also adds the span's seconds on the host clock
(``time.perf_counter``) to an in-memory table, :func:`span_totals` /
:func:`reset_span_totals` (as ``kernels.ops.dispatch_stats`` /
``reset_dispatch_stats`` keep dispatch counts), and hands them back as
the context's ``seconds``.  Timed spans are for host work and for work
that ends in a device sync inside the span (set-up's parts, the serving
engine's per-call phases); an untimed span over asynchronous device work
times only the launches, so it is left to the trace.  Nothing is written
to disk.

The port's spans (see ``PERF.md`` §3 for the metric each feeds):

* set-up, timed: ``kernels.load`` (``kernels/build.build_library``),
  ``engine.build`` and ``engine.capture`` (``launch/serve.ServeEngine``);
* each ``ServeEngine.generate``, timed, with the engine's call index:
  ``serve.generate`` over ``serve.request``, ``serve.program``,
  ``serve.prefill`` and ``serve.decode`` (one CUDA graph replay: no span
  inside it shows);
* the model step (``models/transformer.py``): ``model.embed`` and
  ``model.head`` in prefill, ``block.norm``, ``block.attn`` and
  ``block.mlp`` or ``block.moe`` with the block's index, and under
  ``block.moe`` ``moe.route``, ``moe.dispatch``, ``moe.experts`` and
  ``moe.combine``;
* training: ``train.step``, ``train.grads``, ``train.clip``,
  ``train.update``, ``remat.forward``, ``remat.recompute`` and
  ``attn.chunked``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "span_totals", "reset_span_totals", "TimedSpan"]

_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()
_TOTALS: dict[str, float] = {}


class TimedSpan:
    """A span that adds its host seconds to :func:`span_totals` and keeps
    them in ``seconds``; a profiler range too while the profiler records."""

    __slots__ = ("name", "args", "seconds", "_t0", "_range")

    def __init__(self, name: str, args: Optional[str]):
        self.name, self.args = name, args
        self.seconds = 0.0
        self._range = None

    def __enter__(self) -> "TimedSpan":
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name, self.args)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        with _LOCK:
            _TOTALS[self.name] = _TOTALS.get(self.name, 0.0) + self.seconds
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None


def span(name: str, args=None, timed: bool = False):
    """The span ``name`` as a context manager (see the module docstring);
    ``args`` is given to the trace as a string."""
    if timed:
        return TimedSpan(name, None if args is None else str(args))
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name, None if args is None else str(args))
    return _NULL


def span_totals() -> dict[str, float]:
    """Seconds of every timed span, summed by name, since the last reset."""
    with _LOCK:
        return dict(_TOTALS)


def reset_span_totals() -> None:
    with _LOCK:
        _TOTALS.clear()
