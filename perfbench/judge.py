"""Deciding ``correct``: the served tokens of a sample of the window's
requests, held against the plain reference.

The sample is drawn from the seed and always holds the longest request
(prompt and generation together; the first of equals).  Where the rows of
a batch share expert capacity, a request's tokens depend on its whole
batch, so whole batches are sampled; otherwise single requests, taken in
turn from each row of a batch (each slot of the engine), so that a sample
of at least a batch's size holds every slot.  For each
served token the reference reads ``best - logit(served)`` at its position;
a greedy engine that serves what the configuration states leaves that
gap at rounding.  The numbers a cell compares, each against its limit in
``cells/<cell>.json``, are read of the sample's gaps (:data:`NUMBERS`):
the widest gap, or where rounding can flip a routing choice (see
``PERF.md``) their mean.  :func:`checks` and :func:`passes` decide
``correct``, for a run and for the readings of the program and of its
control alike.
"""

from __future__ import annotations

import itertools
import math
import time

import numpy as np

__all__ = ["sample", "reference_gaps", "checks", "passes", "NUMBERS", "SAMPLE_STREAM"]

SAMPLE_STREAM = 2

#: what may be read of a sample's gaps (a flat array), by name
NUMBERS = {
    "widest_gap": lambda g: float(g.max()),
    "gap_mean": lambda g: float(g.mean()),
}


def checks(gaps: np.ndarray, limits: dict) -> dict:
    """Each number a cell compares, read of ``gaps``, beside its limit."""
    return {name: {"value": NUMBERS[name](gaps), "limit": float(limit)}
            for name, limit in limits.items()}


def passes(compared: dict, failed: int = 0) -> bool:
    """``correct``: every request served, every number within its limit."""
    return failed == 0 and all(c["value"] <= c["limit"] for c in compared.values())


def sample(batches: list, n_requests: int, coupled: bool, seed: int) -> list:
    """``[(batch index, rows)]`` to check: ``n_requests`` requests or the
    whole batches that hold them, the longest request among them."""
    reqs = [(bi, r) for bi, b in enumerate(batches) for r in range(len(b.lens))]
    size = [int(batches[bi].lens[r]) + batches[bi].gen for bi, r in reqs]
    longest = reqs[int(np.argmax(size))]
    rng = np.random.default_rng([seed & (2 ** 64 - 1), SAMPLE_STREAM])
    if coupled:
        per = len(batches[0].lens)
        want = max(1, math.ceil(n_requests / per))
        others = [bi for bi in rng.permutation(len(batches)) if bi != longest[0]]
        chosen = sorted([longest[0]] + list(others[:want - 1]))
        return [(bi, list(range(len(batches[bi].lens)))) for bi in chosen]
    by_slot: dict = {}
    for i in rng.permutation(len(reqs)):
        if reqs[i] != longest:
            by_slot.setdefault(reqs[i][1], []).append(reqs[i])
    turns = itertools.zip_longest(*(by_slot[r] for r in rng.permutation(sorted(by_slot))))
    others = [q for turn in turns for q in turn if q is not None]
    chosen = sorted([longest] + others[:n_requests - 1])
    by_batch: dict = {}
    for bi, r in chosen:
        by_batch.setdefault(bi, []).append(r)
    return sorted(by_batch.items())


def reference_gaps(reference, config: dict, params: dict, batches: list, picked: list,
                   coupled: bool, device, control: bool = False) -> dict:
    """The reference's gaps over the picked requests: ``gap`` (and
    ``control_gap``), one flat array each, ``tokens`` and ``seconds``."""
    t0 = time.perf_counter()
    gaps: dict = {}
    if coupled:
        for bi, _ in picked:
            b = batches[bi]
            out = reference.served_gaps(config, params, b.prompts, b.lens, b.tokens,
                                        coupled=True, control=control, device=device)
            for k, v in out.items():
                gaps.setdefault(k, []).append(v.reshape(-1).numpy())
    else:
        rows = [(batches[bi], r) for bi, rs in picked for r in rs]
        out = reference.served_gaps(
            config, params, np.stack([b.prompts[r] for b, r in rows]),
            np.array([b.lens[r] for b, r in rows]), np.stack([b.tokens[r] for b, r in rows]),
            coupled=False, control=control, device=device)
        for k, v in out.items():
            gaps.setdefault(k, []).append(v.reshape(-1).numpy())
    res = {k: np.concatenate(v) for k, v in gaps.items()}
    res["tokens"] = int(res["gap"].size)
    res["seconds"] = time.perf_counter() - t0
    return res
