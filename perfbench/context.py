"""What a run hands its metric readers."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .spans import SpanSummary
from .trace import TraceSummary
from .traffic import Mix

__all__ = ["BatchRecord", "RunContext"]


@dataclasses.dataclass
class BatchRecord:
    prompts: np.ndarray  # (rows, bucket)
    lens: np.ndarray  # (rows,)
    gen: int
    tokens: np.ndarray  # (rows, gen) served
    prefill_s: float
    decode_s: float
    traced: bool


@dataclasses.dataclass
class RunContext:
    config: dict  # the configuration's file
    architecture: object  # its module, architectures/<name>.py
    mix: Mix
    setup_s: float
    window_s: float
    batches: list  # BatchRecord of every batch of the window
    dispatch: dict  # the program's dispatch counts over the window
    trace: Optional[TraceSummary] = None  # a traced run's, else None
    spans: Optional[SpanSummary] = None  # device seconds by program span, likewise

    def traced_batches(self) -> list:
        return [b for b in self.batches if b.traced]
