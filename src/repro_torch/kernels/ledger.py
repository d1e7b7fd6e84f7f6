"""The launch ledger: one count of the hand-written kernels' launches.

Each wrapper calls :func:`note_launch` where it launches its kernel on the
card, and nowhere else.  A launch is counted under its kind and dims
(``"gemm"``: ``(M, K, N)``; ``"flash"``: ``(seq_q, seq_kv, head_dim)``;
``"ssd"``: ``(n, q)``, one a chunked-scan call of three kernels;
``"conv"``: ``(width, channels)``, one a causal conv's call), the
:func:`launch_role` in force on the launching thread and its operands'
dtype; :func:`launches` sums by any of those fields.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Optional

__all__ = ["note_launch", "launches", "launch_role", "current_role", "reset_launches"]

_FIELDS = ("kind", "dims", "role", "dtype")
#: launches keyed by ``_FIELDS``; a CUDA backward launches from autograd's
#: thread, so every access holds the lock
_COUNTS: collections.Counter = collections.Counter()
_LOCK = threading.Lock()
_ROLE = threading.local()


@contextlib.contextmanager
def launch_role(role: str):
    """Attribute this thread's launches inside the block to ``role``
    (``recompute``, ``dA``, ``dB``; ``forward`` outside any block)."""
    prev = current_role()
    _ROLE.name = role
    try:
        yield
    finally:
        _ROLE.name = prev


def current_role() -> str:
    return getattr(_ROLE, "name", "forward")


def note_launch(kind: str, dims: tuple, dtype) -> None:
    """Count one launch of ``kind``'s kernel at ``dims`` on ``dtype`` operands."""
    key = (kind, dims, current_role(), str(dtype).removeprefix("torch."))
    with _LOCK:
        _COUNTS[key] += 1


def launches(kind: Optional[str] = None, *by: str) -> collections.Counter:
    """The launches of ``kind`` (of every kind where None) summed by the
    fields ``by`` (``dims`` where none is given), keyed by the one field's
    value or by the tuple of several, in the order each was first counted."""
    idx = [_FIELDS.index(f) for f in by or ("dims",)]
    with _LOCK:
        counts = list(_COUNTS.items())
    out: collections.Counter = collections.Counter()
    for key, n in counts:
        if kind is None or key[0] == kind:
            out[key[idx[0]] if len(idx) == 1 else tuple(key[i] for i in idx)] += n
    return out


def reset_launches(*kinds: str) -> None:
    """Forget the launches of ``kinds`` (of every kind where none is given)."""
    with _LOCK:
        for key in [k for k in _COUNTS if not kinds or k[0] in kinds]:
            del _COUNTS[key]
