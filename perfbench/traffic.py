"""The one traffic generator: every mix is a file of parameters under
``traffic/``, read here.

A mix serves static batches in a closed loop (the serving engine takes a
batch, serves it whole, and takes the next), so its file gives:

* ``batch``: requests a batch;
* ``prompt_len``: the lengths' distribution over the whole numbers of
  ``[low, high]``: ``{"dist": "uniform", "low": a, "high": b}``, or
  ``{"dist": "lognormal", "median": m, "sigma": s, "low": a, "high": b}``,
  a lognormal cut to ``[a, b]`` (the share of a heavy-tailed trace that a
  length router sends to one bucket).  Lengths are drawn stratified: the
  distribution's quantiles are cut into ``batch`` equal strata and each
  batch takes one length from each, at an offset within the strata that
  moves with the batch's index (a golden-ratio sequence) and not with the
  seed.  So every seed serves the same lengths, batch by batch, the seed
  choosing which row gets which and the tokens; a rate over the real
  tokens does not move with the seed, and over many batches the lengths
  follow the distribution;
* ``bucket``: the prompt width served (prompts are right-padded to it);
* ``gen_tokens``: tokens generated for each request;
* ``token_ids``: ``"uniform"``, ids uniform over the vocabulary;
* ``warmup_batches`` and ``trace_batches``: batches served before the
  window and traced at its start by a ``--trace 1`` run.

Batch ``i`` of a seed is drawn from its own stream, so the same seed
gives the same batches however many the window holds, and warm-up
batches come from a stream of their own.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np

__all__ = ["Mix", "Batch", "WINDOW", "WARMUP"]

WINDOW, WARMUP = 0, 1
_GOLDEN = (5 ** 0.5 - 1) / 2


@dataclasses.dataclass(frozen=True)
class Batch:
    prompts: np.ndarray  # (batch, bucket) int64, right-padded with 0
    lens: np.ndarray  # (batch,) real prompt lengths
    gen: int


@dataclasses.dataclass(frozen=True)
class Mix:
    name: str
    batch: int
    low: int
    high: int
    bucket: int
    gen: int
    warmup_batches: int
    trace_batches: int
    median: float = 0.0  # lognormal only; 0 is uniform
    sigma: float = 0.0

    @classmethod
    def from_file(cls, spec: dict) -> "Mix":
        if spec.get("token_ids", "uniform") != "uniform":
            raise ValueError(f"token_ids {spec['token_ids']!r}: only 'uniform' is drawn")
        pl = spec["prompt_len"]
        low, high = int(pl["low"]), int(pl["high"])
        if not 1 <= low <= high <= int(spec["bucket"]):
            raise ValueError(f"prompt lengths [{low}, {high}] do not fit bucket {spec['bucket']}")
        dist = pl.get("dist", "uniform")
        if dist not in ("uniform", "lognormal"):
            raise ValueError(f"prompt_len dist {dist!r}: 'uniform' or 'lognormal'")
        shape = ({"median": float(pl["median"]), "sigma": float(pl["sigma"])}
                 if dist == "lognormal" else {})
        return cls(name=spec["name"], batch=int(spec["batch"]), low=low, high=high,
                   bucket=int(spec["bucket"]), gen=int(spec["gen_tokens"]),
                   warmup_batches=int(spec.get("warmup_batches", 1)),
                   trace_batches=int(spec.get("trace_batches", 1)), **shape)

    def lengths(self, index: int) -> np.ndarray:
        """Batch ``index``'s prompt lengths, one from each stratum of the
        distribution's quantiles, sorted."""
        q = (np.arange(self.batch) + (index * _GOLDEN) % 1.0) / self.batch
        if not self.median:
            return self.low + (q * (self.high - self.low + 1)).astype(np.int64)
        # the lognormal cut to [low, high + 1), by its inverse CDF
        unit, mu = NormalDist(), math.log(self.median)
        lo, hi = (unit.cdf((math.log(x) - mu) / self.sigma) for x in (self.low, self.high + 1))
        x = [math.exp(mu + self.sigma * unit.inv_cdf(lo + u * (hi - lo))) for u in q]
        return np.clip(np.floor(x), self.low, self.high).astype(np.int64)

    def draw(self, seed: int, index: int, vocab: int, stream: int = WINDOW) -> Batch:
        """Batch ``index`` of ``seed``'s ``stream``."""
        rng = np.random.default_rng([seed & (2 ** 64 - 1), stream, index])
        lens = rng.permutation(self.lengths(index))
        prompts = np.zeros((self.batch, self.bucket), np.int64)
        for i, n in enumerate(lens):
            prompts[i, :n] = rng.integers(0, vocab, n)
        return Batch(prompts=prompts, lens=lens, gen=self.gen)
