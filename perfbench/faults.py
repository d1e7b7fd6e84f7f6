"""The faults a served cell can have, planted in the program for a run
that must come out not correct: the CPU tests plant them at a tiny size,
``python3 -m perfbench.control --faults ...`` at a cell's own size on the
card.  Each is a context manager that patches the port
(:func:`perfbench.system.patched`) and restores it.  The faults here hold
for any served model; those that depend on the model's cache, such as a
decode step that leaves its state unchanged (``stale_state``), are its
architecture's (``architectures/<name>.py``, ``faults()``).  An engine
built under a fault captures it into its decode graph, so one is planted
before its engine is built.  (A cell on one card has no exchange between
cards to leave out.)"""

from __future__ import annotations

import contextlib

import numpy as np

from . import system

__all__ = ["FAULTS", "of", "planted"]


def _half(generate):
    """The second half of each batch is not served: its rows get the
    first half's answers."""

    def half(self, prompts, gen_tokens, prompt_lens=None, frontend_embeds=None):
        out = np.array(generate(self, prompts, gen_tokens, prompt_lens, frontend_embeds))
        h = len(out) // 2
        out[h:2 * h] = out[:h]
        return out

    return half


def _altered_token(col: int):
    """One token of each request, column ``col`` (0: from the prefill's
    logits; later: a decode step's), replaced by the next id."""

    def make(decode_loop):
        def altered(self, g, tokens):
            decode_loop(self, g, tokens)
            tokens[:, col] = (tokens[:, col] + 1) % self.cfg.vocab_size

        return altered

    return system.patched("launch.serve", "ServeEngine._decode_loop", make)


FAULTS = {
    "half_batch": lambda: system.patched("launch.serve", "ServeEngine.generate", _half),
    "altered_token.prefill": lambda: _altered_token(0),
    "altered_token.decode": lambda: _altered_token(3),
}


def of(architecture) -> dict:
    """Every fault a cell of ``architecture`` can have, by name: its
    architecture's, then the general ones."""
    return {**architecture.faults(), **FAULTS}


@contextlib.contextmanager
def planted(name: str, architecture):
    """The port with fault ``name`` of a cell of ``architecture`` planted,
    for the ``with`` block."""
    with of(architecture)[name]():
        yield
