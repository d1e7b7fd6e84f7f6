"""Deterministic candidate sharding — the multi-host partitioner over
one shared trial journal.

The substrate for distributed search already exists: the
:class:`~repro_torch.core.records.TrialJournal` is an O_APPEND shared log any
number of processes can write without tearing, and ``reload_every``
merges sibling rows mid-search.
What was missing is the *partitioner*: a rule that makes two hosts
running the same search never measure the same candidate, plus a final
election that reconciles their per-shard bests into one records entry.

Both live here:

* :func:`shard_of` — the ownership rule.  A candidate belongs to
  ``blake2b(workload_key | state_key) mod n_shards``.  Hashing the
  workload key *into* the digest seeds the partition per workload, so
  the same tiling state lands on different shards for different
  workloads — no shard is systematically starved of good candidates
  across an arch.  The hash is stable across processes, hosts, and
  Python versions (unlike ``hash()``), so every participant computes
  the same owner without coordination.
* :class:`ShardSpec` — ``index/count`` with ``owns()``; ``0/1`` (the
  default everywhere) disables sharding entirely.
* **done markers** — tiny JSON files in a ``<journal>.shards/``
  directory, one per ``(workload, shard)``, written atomically when a
  shard finishes its search.  They carry the shard's journaled best, so
  the elect-and-merge step (:func:`elect_best`) needs no coordinator:
  every shard waits for its siblings' markers (:func:`await_markers`),
  then deterministically picks the winner — lowest journaled cost,
  ties broken by shard index — and keep-best-merges it into the
  records table (idempotent, so every shard may do it).

The :class:`~repro_torch.core.measure.MeasureEngine` applies ownership *after*
the cache/static/learned funnel: a non-owned cache miss is first given
one journal reload (the sibling may have measured it already — a free
hit), and otherwise becomes a **deferred** outcome (``inf`` cost, zero
lane time) instead of occupying a lane.  ``repro_torch.launch.analyze``
audits the result: a journal row claiming shard ``i`` whose recomputed
owner differs, or one candidate measured by two shards, is an error.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import re
import tempfile
import time
from typing import Optional

__all__ = [
    "ShardSpec",
    "parse_shard",
    "shard_of",
    "shard_dir_for",
    "write_done_marker",
    "read_done_markers",
    "await_markers",
    "elect_best",
]


def shard_of(workload_key: str, state_key: str, n_shards: int) -> int:
    """Owner shard of one candidate: a stable hash of the workload key
    and the state key, mod the shard count.  The workload key acts as a
    per-workload seed — the same state key maps to different owners for
    different workloads."""
    if n_shards <= 1:
        return 0
    h = hashlib.blake2b(
        f"{workload_key}|{state_key}".encode("utf-8"), digest_size=8
    )
    return int.from_bytes(h.digest(), "big") % n_shards


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """This engine's slice of a sharded search: shard ``index`` of
    ``count``.  ``count == 1`` means sharding is off (``enabled`` is
    False and ``owns`` accepts everything) — the engine stays
    bit-identical to an unsharded one."""

    index: int
    count: int

    def __post_init__(self):
        if self.count < 1:
            raise ValueError(f"shard count must be >= 1, got {self.count}")
        if not (0 <= self.index < self.count):
            raise ValueError(
                f"shard index must be in [0, {self.count}), got {self.index}"
            )

    @property
    def enabled(self) -> bool:
        return self.count > 1

    def owns(self, workload_key: str, state_key: str) -> bool:
        if not self.enabled:
            return True
        return shard_of(workload_key, state_key, self.count) == self.index

    def __str__(self) -> str:
        return f"{self.index}/{self.count}"


_SHARD_RE = re.compile(r"^(\d+)/(\d+)$")


def parse_shard(spec: str) -> ShardSpec:
    """Parse the CLI spelling ``I/N`` (e.g. ``0/2``) into a
    :class:`ShardSpec`; range errors surface from the dataclass."""
    m = _SHARD_RE.match(spec.strip())
    if m is None:
        raise ValueError(
            f"shard spec must look like I/N (e.g. 0/2), got {spec!r}"
        )
    return ShardSpec(int(m.group(1)), int(m.group(2)))


# -- done markers / election ---------------------------------------------------

def shard_dir_for(journal_path: str) -> str:
    """Default location of the shard done-markers: a directory next to
    the :class:`~repro_torch.core.records.TrialJournal`, like the
    learned-model cache — everything a sharded search shares
    travels with the journal file."""
    return journal_path + ".shards"


def _workload_dir(root: str, workload_key: str) -> str:
    slug = re.sub(r"[^A-Za-z0-9._=-]+", "_", workload_key)[:80]
    h = hashlib.blake2b(workload_key.encode("utf-8"), digest_size=6).hexdigest()
    return os.path.join(root, f"{slug}-{h}")


def _marker_name(index: int, count: int) -> str:
    return f"shard_{index}_of_{count}.done.json"


_MARKER_RE = re.compile(r"^shard_(\d+)_of_(\d+)\.done\.json$")


def write_done_marker(
    root: str,
    workload_key: str,
    shard: ShardSpec,
    best_state_lists: Optional[list],
    best_cost: float,
    n_measured: int,
) -> str:
    """Atomically publish one shard's completion marker (staging file →
    ``os.replace``).  ``best_cost`` is the shard's lowest *journaled*
    cost (``inf`` → ``null``: the shard finished but found nothing
    finite, which the election skips)."""
    d = _workload_dir(root, workload_key)
    os.makedirs(d, exist_ok=True)
    payload = {
        "workload": workload_key,
        "shard": shard.index,
        "n_shards": shard.count,
        "best": best_state_lists,
        "best_cost": best_cost if math.isfinite(best_cost) else None,
        "n_measured": int(n_measured),
    }
    path = os.path.join(d, _marker_name(shard.index, shard.count))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, separators=(",", ":"))
        os.replace(tmp, path)  # atomic publish
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def read_done_markers(
    root: str, workload_key: str, n_shards: int
) -> dict[int, dict]:
    """All committed markers for one workload at the given shard count
    (``{shard_index: payload}``); unreadable or foreign files are
    skipped — a marker either parsed or does not exist yet."""
    d = _workload_dir(root, workload_key)
    out: dict[int, dict] = {}
    for i in range(n_shards):
        path = os.path.join(d, _marker_name(i, n_shards))
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(payload, dict):
            out[i] = payload
    return out


def await_markers(
    root: str,
    workload_key: str,
    shard: ShardSpec,
    timeout_s: float = 60.0,
    poll_s: float = 0.2,
) -> dict[int, dict]:
    """Poll for all ``shard.count`` done markers of one workload, up to
    ``timeout_s`` seconds.  Returns whatever is present at the end —
    the caller elects over the partial set when a sibling never reports
    (a dead host must not wedge the survivors forever)."""
    deadline = time.monotonic() + max(0.0, timeout_s)
    while True:
        markers = read_done_markers(root, workload_key, shard.count)
        if len(markers) >= shard.count or time.monotonic() >= deadline:
            return markers
        time.sleep(poll_s)


def elect_best(markers: dict[int, dict]) -> Optional[tuple[int, list, float]]:
    """The merged winner over a set of done markers: lowest journaled
    ``best_cost``, ties broken by the lower shard index (scanning in
    index order and using strict ``<`` makes the tie-break implicit).
    Returns ``(shard_index, best_state_lists, best_cost)``, or None
    when no shard reported a finite best."""
    winner: Optional[tuple[int, list, float]] = None
    for i in sorted(markers):
        m = markers[i]
        c = m.get("best_cost")
        lists = m.get("best")
        if c is None or lists is None:
            continue
        c = float(c)
        if winner is None or c < winner[2]:
            winner = (i, lists, c)
    return winner
