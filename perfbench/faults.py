"""The faults a served cell can have, planted in the program for a run
that must come out not correct: the CPU tests plant them at a tiny size,
``python3 -m perfbench.control --faults ...`` at a cell's own size on the
card.  Each is a context manager that patches the port and restores it.
An engine built under a fault captures it into its decode graph, so one
is planted before its engine is built.  (A cell on one card has no
exchange between cards to leave out.)"""

from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np

__all__ = ["FAULTS", "planted"]


def _stale_state():
    """A decode step whose cache write and length advance are lost."""
    from repro_torch.models import transformer as tf

    real = tf.decode_step

    def stale(cfg, params, cache, tokens):
        kept = {k: cache[k].clone() for k in ("k", "v", "len")}
        logits, cache = real(cfg, params, cache, tokens)
        for k, v in kept.items():
            cache[k].copy_(v)
        return logits, cache

    return mock.patch.object(tf, "decode_step", stale)


def _half_batch():
    """The second half of each batch is not served: its rows get the
    first half's answers."""
    from repro_torch.launch.serve import ServeEngine

    real = ServeEngine.generate

    def half(self, prompts, gen_tokens, prompt_lens=None, frontend_embeds=None):
        out = np.array(real(self, prompts, gen_tokens, prompt_lens, frontend_embeds))
        h = len(out) // 2
        out[h:2 * h] = out[:h]
        return out

    return mock.patch.object(ServeEngine, "generate", half)


def _altered_token(col: int):
    """One token of each request, column ``col`` (0: from the prefill's
    logits; later: a decode step's), replaced by the next id."""
    from repro_torch.launch.serve import ServeEngine

    real = ServeEngine._decode_loop

    def altered(self, g, tokens):
        real(self, g, tokens)
        tokens[:, col] = (tokens[:, col] + 1) % self.cfg.vocab_size

    return mock.patch.object(ServeEngine, "_decode_loop", altered)


FAULTS = {
    "stale_state": _stale_state,
    "half_batch": _half_batch,
    "altered_token.prefill": lambda: _altered_token(0),
    "altered_token.decode": lambda: _altered_token(3),
}


@contextlib.contextmanager
def planted(name: str):
    """The port with fault ``name`` planted, for the ``with`` block."""
    with FAULTS[name]():
        yield
