"""The import guard: no module of the JAX package, JAX or Flax may be
loaded in a benchmark run.  Names are compared whole, by the part before
the first dot, so the port (``repro_torch``) never matches the JAX
package (``repro``)."""

from __future__ import annotations

import sys

__all__ = ["FORBIDDEN", "forbidden_modules"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.partition(".")[0] in FORBIDDEN)
