"""Operator-agnostic search-space protocol — the tuner stack's view of
*any* tunable kernel schedule.

The paper closes with "the proposed approaches have potential to be
applied to other operator-level optimizations"; the TVM line of work
(Learning to Optimize Tensor Programs) shows the win comes from a
*generic* schedule-space abstraction.  This module is that abstraction
for this repo: every tuner, cost backend, journal and session programs
against :class:`SearchSpace` and the opaque :class:`State` protocol, so
opening a new workload (flash attention, a reduction, a conv) means
writing one space + one cost model and registering them in
``repro_torch.core.ops`` — never touching the tuners.

Two layers live here:

* :class:`SearchSpace` — the protocol every tuner consumes:
  ``initial_state / actions / step / neighbors / is_legitimate / size /
  enumerate / random_state / transplant / features / n_features`` plus
  state (de)serialization hooks (``state_from_lists``) used by the
  records/journal layer and the process-executor boundary.
* :class:`FactoredSearchSpace` — the shared implementation for spaces
  whose state is a list of ordered factor rows with exact products (the
  paper's Eqn. 5/6 MDP, generalized from the GEMM's three ``m/k/n``
  rows to any number of dimension rows).  ``GemmConfigSpace`` is the
  canonical instance.

This module is framework-neutral (numpy + stdlib) and is kept
statement-for-statement equal to the JAX package's ``core/space.py``, so
both packages walk identical trial sequences.

States are op-specific frozen dataclasses; the module-level *state-type
registry* maps an op name to its state class so persisted rows (records
files, trial journals) can be deserialized without knowing every op up
front.
"""

from __future__ import annotations

import abc
import dataclasses
import itertools
import math
import random as _random
from typing import Callable, Iterator, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

__all__ = [
    "State",
    "Action",
    "SearchSpace",
    "FactoredSearchSpace",
    "compositions_pow2",
    "count_compositions_pow2",
    "register_state_type",
    "state_type_for",
    "state_from_lists",
]


@runtime_checkable
class State(Protocol):
    """What the tuner stack needs from a schedule point: a stable cache
    key, the dimension products it schedules, and a JSON-serializable
    row form (``as_lists``, inverted by the owning space's
    ``state_from_lists``)."""

    def key(self) -> str: ...

    def dims(self) -> tuple[int, ...]: ...

    def as_lists(self) -> list[list[int]]: ...


@dataclasses.dataclass(frozen=True)
class Action:
    """Double ``row[dim][i]``, halve ``row[dim][j]`` (paper Eqn. 6) —
    the product-preserving move shared by every factored space."""

    dim: int  # dimension-row index
    i: int
    j: int

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"(d{self.dim}: x2@{self.i}, /2@{self.j})"


# -- state-type registry ------------------------------------------------------
# op name -> state dataclass, so persisted rows (TuningRecords, the
# TrialJournal) deserialize without hard-coding every op.  Spaces
# register their state class at import time; repro_torch.core imports
# every bundled space, so importing it makes the bundled ops resolvable.
_STATE_TYPES: dict[str, type] = {}


def register_state_type(op: str, cls: type) -> None:
    _STATE_TYPES[op] = cls


def state_type_for(op: str) -> type:
    try:
        return _STATE_TYPES[op]
    except KeyError:
        raise KeyError(
            f"no state type registered for op {op!r} "
            f"(registered: {sorted(_STATE_TYPES)})"
        ) from None


def state_from_lists(op: str, lists: Sequence[Sequence[int]]) -> State:
    """Deserialize a persisted state row for ``op`` (see ``as_lists``)."""
    return state_type_for(op).from_lists(lists)


class SearchSpace(abc.ABC):
    """The operator-agnostic search-space protocol.

    A space owns one workload instance of one op (a GEMM shape, an
    attention shape, ...) and exposes the MDP the tuners walk plus the
    featurization the learned tuners train on.  Everything the tuner
    stack touches goes through this surface; nothing downstream may
    assume GEMM."""

    #: op name this space schedules (must have a registered state type)
    op: str = "base"
    #: optional extra legitimacy predicate (hardware constraint closure)
    extra_constraint: Optional[Callable] = None

    # -- identity ------------------------------------------------------------
    @property
    @abc.abstractmethod
    def dims(self) -> tuple[int, ...]:
        """Dimension sizes this space schedules (workload identity)."""

    @property
    @abc.abstractmethod
    def depths(self) -> tuple[int, ...]:
        """Nesting depth of each dimension row."""

    def dim_specs(self) -> list[tuple[int, int]]:
        """``(value, depth)`` per *factored* dimension row — what
        sequence-decision tuners (the RNN controller) need to emit a
        configuration.  ``dims`` may carry additional non-factored
        workload dims (e.g. flash's head_dim); those never appear
        here."""
        return list(zip(self.dims, self.depths))

    @property
    def n_fixed_dims(self) -> int:
        """How many trailing entries of ``dims`` are workload identity
        only (never factored).  Warm-start donors must match them
        exactly — e.g. a flash schedule tuned for head_dim 64 must never
        seed a head_dim 128 search."""
        return len(self.dims) - len(self.depths)

    def spec_kwargs(self) -> Optional[dict]:
        """Extra constructor kwargs (beyond dims/depths) needed to
        rebuild an equivalent space via the op registry's
        ``make_space``, or ``None`` when the space cannot be rebuilt
        from a picklable description (e.g. it carries a constraint
        closure) — process-shippable backends refuse to ship then."""
        return None if self.extra_constraint is not None else {}

    # -- states --------------------------------------------------------------
    @abc.abstractmethod
    def state_from_rows(self, rows: Sequence[Sequence[int]]) -> State:
        """Build this op's state from dimension factor rows."""

    def state_from_lists(self, lists: Sequence[Sequence[int]]) -> State:
        """Inverse of ``State.as_lists`` (the journal/executor format)."""
        return self.state_from_rows(lists)

    @abc.abstractmethod
    def initial_state(self) -> State: ...

    # -- MDP -----------------------------------------------------------------
    @property
    @abc.abstractmethod
    def actions(self) -> list[Action]: ...

    @property
    def n_actions(self) -> int:
        return len(self.actions)

    @abc.abstractmethod
    def step(self, s: State, a: Action) -> Optional[State]: ...

    @abc.abstractmethod
    def neighbors(self, s: State) -> list[State]: ...

    @abc.abstractmethod
    def is_legitimate(self, s: State) -> bool: ...

    def structural_error(self, s: State) -> Optional[tuple[str, str]]:
        """``(reason, detail)`` when the state is structurally invalid
        for this space — the machine-readable form of
        ``is_legitimate`` consumed by the static analyzer
        (``repro_torch.core.analysis``).  ``None`` means structurally sound.
        Subclasses with richer structure override this with specific
        reasons; the default wraps ``is_legitimate``."""
        try:
            if self.is_legitimate(s):
                return None
        except Exception as e:
            return ("malformed", f"{type(e).__name__}: {e}")
        return ("illegitimate", "state fails the space's legitimacy check")

    # -- enumeration / sampling ----------------------------------------------
    @abc.abstractmethod
    def size(self) -> int: ...

    @abc.abstractmethod
    def enumerate(self) -> Iterator[State]: ...

    @abc.abstractmethod
    def random_state(self, rng: _random.Random) -> State: ...

    @abc.abstractmethod
    def transplant(self, s: State) -> Optional[State]:
        """Map a state tuned for *another* workload of the same op into
        this space (warm-start translation); None when impossible."""

    # -- featurization -------------------------------------------------------
    @abc.abstractmethod
    def features(self, s: State) -> np.ndarray: ...

    @property
    @abc.abstractmethod
    def n_features(self) -> int: ...

    # -- hardware footprint --------------------------------------------------
    @abc.abstractmethod
    def working_set_bytes(self, s: State, in_bytes: int = 2) -> int:
        """On-chip (shared-memory) working set of the schedule — the
        shared legitimacy cliff every cost backend guards with."""


def count_compositions_pow2(value: int, parts: int) -> int:
    """Number of ordered factorizations of ``value`` into ``parts`` factors
    reachable under the doubling/halving moves (= power-of-two compositions
    times the fixed placement of the odd part, which rides along factor
    moves two-at-a-time).  For ``value = odd * 2^e`` this is the number of
    ways to distribute ``e`` twos into ``parts`` ordered slots, times the
    number of slots the odd part can occupy — except the odd part is only
    movable in factors of 2, i.e. it cannot move at all; it stays where the
    initial state put it.  Hence ``C(e + parts - 1, parts - 1)``.
    """
    e = (value & -value).bit_length() - 1  # exponent of 2 in value
    return math.comb(e + parts - 1, parts - 1)


def compositions_pow2(value: int, parts: int) -> Iterator[tuple[int, ...]]:
    """Enumerate ordered factor tuples ``(f_0..f_{parts-1})`` with
    ``prod == value`` where all variation is in powers of two and the odd
    part of ``value`` stays on factor 0 (the reachable set from the
    paper's initial state ``[value, 1, .., 1]``)."""
    odd = value
    e = 0
    while odd % 2 == 0:
        odd //= 2
        e += 1
    # distribute e twos into `parts` slots
    for cut in itertools.combinations(range(e + parts - 1), parts - 1):
        prev = -1
        exps = []
        for c in cut:
            exps.append(c - prev - 1)
            prev = c
        exps.append(e + parts - 2 - prev)
        factors = [2**x for x in exps]
        factors[0] *= odd
        yield tuple(factors)


class FactoredSearchSpace(SearchSpace):
    """Shared machinery for spaces whose state is ``N`` ordered factor
    rows with exact products — the paper's MDP generalized to any row
    count.  Subclasses fix the op name, the state dataclass
    (``state_from_rows``), the featurization, and the working-set model;
    everything else (actions, stepping, enumeration, sampling,
    transplanting) is row-generic and statement-for-statement the
    historical GEMM implementation, so ``GemmConfigSpace`` stays
    bit-identical."""

    def __init__(
        self,
        values: Sequence[int],
        depths: Sequence[int],
        extra_constraint: Optional[Callable[[State], bool]] = None,
    ):
        values = tuple(int(v) for v in values)
        depths = tuple(int(d) for d in depths)
        if len(values) != len(depths):
            raise ValueError(f"values/depths mismatch: {values} vs {depths}")
        if not values or min(values) < 1 or min(depths) < 1:
            raise ValueError(f"bad {self.op} dims {values} depths {depths}")
        self._values = values
        self._depths = depths
        self.extra_constraint = extra_constraint
        self._actions = self._build_actions()

    # -- identity ------------------------------------------------------------
    @property
    def dims(self) -> tuple[int, ...]:
        return self._values

    @property
    def depths(self) -> tuple[int, ...]:
        return self._depths

    def dim_specs(self) -> list[tuple[int, int]]:
        # from the factored rows directly: ``dims`` may be overridden to
        # append non-factored workload dims (flash's head_dim), which
        # must never leak into the decision sequence
        return list(zip(self._values, self._depths))

    # -- basic protocol ------------------------------------------------------
    def initial_state(self) -> State:
        """Paper Sec. 5: ``s0 = [[v, 1, ..], ...]`` (no tiling)."""
        return self.state_from_rows(
            [(v,) + (1,) * (d - 1) for v, d in zip(self._values, self._depths)]
        )

    def _build_actions(self) -> list[Action]:
        acts = []
        for dim, d in enumerate(self._depths):
            for i in range(d):
                for j in range(d):
                    if i != j:
                        acts.append(Action(dim, i, j))
        return acts

    @property
    def actions(self) -> list[Action]:
        return self._actions

    @property
    def n_actions(self) -> int:
        return len(self._actions)

    def step(self, s: State, a: Action) -> Optional[State]:
        """Apply Eqn. 6/7; returns None when the move is illegitimate
        (halving an odd factor)."""
        lists = s.as_lists()
        row = lists[a.dim]
        if row[a.j] % 2 != 0:
            return None
        row[a.i] *= 2
        row[a.j] //= 2
        s2 = self.state_from_rows(lists)
        if not self.is_legitimate(s2):
            return None
        return s2

    def neighbors(self, s: State) -> list[State]:
        """g(s) of Eqn. 9 — all legitimate one-action successors."""
        out = []
        for a in self._actions:
            s2 = self.step(s, a)
            if s2 is not None:
                out.append(s2)
        return out

    def is_legitimate(self, s: State) -> bool:
        """J of Eqn. 5: exact products, positive integers, row depths,
        plus the optional hardware-constraint closure and the
        subclass's :meth:`extra_legitimate` hook.  Defined as "no
        structural error", so the boolean check and the analyzer's
        reasons can never drift apart."""
        return self.structural_error(s) is None

    def structural_error(self, s: State) -> Optional[tuple[str, str]]:
        """Fine-grained structural verdict for factored-row states (see
        ``SearchSpace.structural_error``).  Detail strings are only
        built on the failure path — the passing path stays as cheap as
        the historical boolean check (this runs per neighbor step)."""
        try:
            rows = s.as_lists()
        except Exception as e:
            return ("malformed", f"{type(e).__name__}: {e}")
        if len(rows) != len(self._values):
            return (
                "row_count",
                f"{len(rows)} factor rows, space has {len(self._values)} dims",
            )
        for i, (row, v, d) in enumerate(zip(rows, self._values, self._depths)):
            if len(row) != d:
                return (
                    "row_depth",
                    f"dim {i}: {len(row)} factors, nesting depth is {d}",
                )
            if any(f < 1 for f in row):
                return (
                    "factor_nonpositive",
                    f"dim {i}: factors {list(row)} include a zero/negative "
                    f"grid or block extent",
                )
            if math.prod(row) != v:
                return (
                    "product_mismatch",
                    f"dim {i}: prod({list(row)}) != {v} (block larger than "
                    f"the dim, or a stale record for another shape)",
                )
        if self.extra_constraint is not None and not self.extra_constraint(s):
            return (
                "extra_constraint",
                "the space's hardware-constraint closure rejected the state",
            )
        if not self.extra_legitimate(s):
            return (
                "op_constraint",
                f"{self.op} op-specific legitimacy rejected the state",
            )
        return None

    def extra_legitimate(self, s: State) -> bool:
        """Op-specific legitimacy beyond exact products (default: none)."""
        return True

    # -- enumeration / sampling ----------------------------------------------
    def size(self) -> int:
        return math.prod(
            count_compositions_pow2(v, d)
            for v, d in zip(self._values, self._depths)
        )

    def enumerate(self) -> Iterator[State]:
        rows_iter = itertools.product(
            *(
                compositions_pow2(v, d)
                for v, d in zip(self._values, self._depths)
            )
        )
        for rows in rows_iter:
            s = self.state_from_rows(rows)
            if self.extra_constraint is not None and not self.extra_constraint(s):
                continue
            if self.extra_legitimate(s):  # keep enumerate == is_legitimate
                yield s

    def random_state(self, rng: _random.Random) -> State:
        def rand_comp(value: int, parts: int) -> tuple[int, ...]:
            odd = value
            e = 0
            while odd % 2 == 0:
                odd //= 2
                e += 1
            exps = [0] * parts
            for _ in range(e):
                exps[rng.randrange(parts)] += 1
            factors = [2**x for x in exps]
            factors[0] *= odd
            return tuple(factors)

        for _ in range(64):
            s = self.state_from_rows(
                [rand_comp(v, d) for v, d in zip(self._values, self._depths)]
            )
            if self.is_legitimate(s):
                return s
        return self.initial_state()

    def transplant(self, s: State) -> Optional[State]:
        """Map a state tuned for *another* workload of this op into this
        space — the warm-start translation.

        Tiling quality is carried by the inner factors (CTA tile, warp
        tile, register tile), which transfer across shapes;
        the grid factor merely covers whatever dimension is left.  So:
        keep the donor's inner factors (resized to this space's nesting
        depth, register factor kept innermost), shrink them until their
        product divides the new dimension, and absorb the remainder —
        including the dimension's odd part, which keeps the state inside
        the reachable set — into the grid factor.  Returns None when no
        legitimate translation exists.
        """
        src_rows = s.as_lists()
        if len(src_rows) != len(self._values):
            return None
        rows = []
        for row, dim, d in zip(src_rows, self._values, self._depths):
            inner = list(row[1:])
            if len(inner) > d - 1:  # merge overflow into the outermost inner slot
                keep = len(inner) - (d - 1)
                inner = [math.prod(inner[: keep + 1])] + inner[keep + 1:]
            while len(inner) < d - 1:  # pad outermost, keep register innermost
                inner.insert(0, 1)
            for _ in range(64):
                p = math.prod(inner) if inner else 1
                if p >= 1 and dim % p == 0:
                    break
                big = max(range(len(inner)), key=lambda i: inner[i])
                inner[big] = inner[big] // 2 if inner[big] % 2 == 0 else 1
            p = math.prod(inner) if inner else 1
            if dim % p != 0:
                inner, p = [1] * (d - 1), 1
            rows.append([dim // p] + inner)
        s2 = self.state_from_rows(rows)
        return s2 if self.is_legitimate(s2) else None
