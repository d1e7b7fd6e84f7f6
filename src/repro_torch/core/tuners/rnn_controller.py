"""RNN-controller tuner — the paper's second baseline ("the general
configuration optimization method using a RNN controller by Google
researchers", i.e. the NAS-style controller of Zoph & Le / Bello et al.),
with its networks in PyTorch.

A GRU emits the configuration as a sequence of categorical decisions:
for each dimension row of the space (``space.dim_specs()`` — m/k/n for
GEMM, q/kv for flash attention) it distributes the power-of-two
exponent budget e_x over d_x ordered slots, one slot at a time, each
choice conditioned on the running remainder via masking.  Sampled
configurations are measured; the controller is trained with REINFORCE
(reward = c_ref / cost, EMA baseline, entropy bonus).

The logic is the JAX package's (``repro/core/tuners/rnn_controller.py``):
the sampling arithmetic stays in numpy float64 on the logits the GRU
gives, and every draw comes from ``self.rng``.  ``c_ref`` is the cost of
the untiled initial state, 1.0 when that cost is ``inf`` (as it is on
the Hopper kernels, whose launch rule refuses the untiled state).  The
train step's log-probabilities are batched over the round's samples
where the reference ``vmap``s.  The networks run on ``device`` —
``cuda`` unless ``cpu`` is asked for; ``cuda`` without a card raises.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..snapshot import tree_from_jsonable, tree_to_jsonable
from ..space import State
from .base import Tuner, TuningContext
from .nn import (
    GRUCell,
    adam_state,
    he_linear,
    load_adam_state,
    make_adam,
    network_device,
    params_from_reference,
)

__all__ = ["RNNControllerTuner"]

#: logit of a choice beyond the remaining exponent budget
_MASKED = -1e9


def _exponent_budget(value: int) -> int:
    e = 0
    while value % 2 == 0:
        value //= 2
        e += 1
    return e


class _Controller(nn.Module):
    """GRU cell (with its learned ``h0``), the linear head over exponent
    choices, and the start-token embedding ``emb0``."""

    def __init__(self, gru: GRUCell, head: nn.Linear, emb0: torch.Tensor):
        super().__init__()
        self.gru, self.head = gru, head
        self.emb0 = nn.Parameter(emb0)


class RNNControllerTuner(Tuner):
    name = "rnn-controller"

    def __init__(
        self,
        space,
        cost,
        seed: int = 0,
        hidden: int = 64,
        lr: float = 4e-3,
        batch_size: int = 8,
        entropy_beta: float = 5e-3,
        baseline_decay: float = 0.9,
        device="cuda",
    ):
        super().__init__(space, cost, seed)
        self.hidden = hidden
        self.lr = lr
        self.batch_size = batch_size
        self.entropy_beta = entropy_beta
        self.baseline_decay = baseline_decay
        self.device = network_device(device)
        self._ready = False
        self._baseline = None
        self._c_ref = None

    # -- crash-safe resume ---------------------------------------------------
    def state_dict(self) -> dict:
        d = super().state_dict()
        d["baseline"] = self._baseline
        d["c_ref"] = self._c_ref
        if self._ready:
            d["params"] = tree_to_jsonable(dict(self.net.state_dict()))
            d["opt_state"] = tree_to_jsonable(adam_state(self.opt))
        return d

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self._baseline = state["baseline"]
        self._c_ref = state["c_ref"]
        if "params" in state:
            if not self._ready:
                self._setup()  # builds the modules and optimizer, then overwrite
            self.net.load_state_dict(tree_from_jsonable(state["params"], torch.from_numpy))
            load_adam_state(self.opt, tree_from_jsonable(state["opt_state"]))
            self._memo.clear()

    # -- networks --------------------------------------------------------------
    def _setup(self, reference_params: Optional[dict] = None) -> None:
        """Derive the decision sequence from the space and build the
        controller from a generator seeded with the tuner's seed, or from
        the JAX package's parameter tree (``{"gru", "head", "emb0"}``,
        numpy leaves) when one is given, and Adam over it."""
        sp = self.space
        # one (exponent budget, depth) pair per dimension row — the
        # op-agnostic decision sequence
        self.budgets = [
            (_exponent_budget(value), depth) for value, depth in sp.dim_specs()
        ]
        self.max_e = max(b for b, _ in self.budgets)
        # decision sequence: for each dim, d_x - 1 free slots (last is forced)
        self.seq_spec: list[tuple[int, int]] = []  # (dim_idx, slot_idx)
        for di, (_, d) in enumerate(self.budgets):
            for slot in range(d - 1):
                self.seq_spec.append((di, slot))
        n_in = self.max_e + 2  # one-hot prev choice + start token
        if reference_params is None:
            gen = torch.Generator().manual_seed(self.seed)
            gru = GRUCell(n_in, self.hidden, gen)
            head = he_linear(self.hidden, self.max_e + 1, gen)
            emb0 = torch.randn(n_in, generator=gen) * 0.1
        else:
            gru = params_from_reference(reference_params["gru"])
            head = params_from_reference(reference_params["head"])
            emb0 = torch.tensor(np.asarray(reference_params["emb0"], np.float32))
        self.net = _Controller(gru, head, emb0).to(self.device)
        self.opt = make_adam(self.net, self.lr)
        self._onehots = torch.eye(n_in, device=self.device)
        self._memo: dict[tuple, tuple] = {}
        self._ready = True

    def _logp_entropy(self, choices: torch.Tensor, masks: torch.Tensor):
        """Log-probability and entropy of each sample's fixed choice
        sequence (``choices`` (B, L), ``masks`` (B, L, max_e + 1)): the
        reference's ``sample_logp``, batched over the samples."""
        net = self.net
        n = choices.shape[0]
        h = net.gru.h0.expand(n, -1)
        x = net.emb0.expand(n, -1)
        logp_total = torch.zeros(n, device=choices.device)
        ent_total = torch.zeros(n, device=choices.device)
        for t in range(choices.shape[1]):
            h = net.gru(h, x)
            logits = torch.where(masks[:, t], net.head(h), _MASKED)
            lp = F.log_softmax(logits, dim=-1)
            logp_total = logp_total + torch.gather(lp, 1, choices[:, t:t + 1])[:, 0]
            p = torch.exp(lp)
            ent_total = ent_total - torch.sum(torch.where(masks[:, t], p * lp, 0.0), dim=-1)
            x = self._onehots[choices[:, t] + 1]
        return logp_total, ent_total

    def _train_step(self, choices_b: np.ndarray, masks_b: np.ndarray, adv_b: np.ndarray) -> None:
        """One REINFORCE step: Adam on mean(−logp·adv − β·entropy)."""
        def dev(a):
            return torch.from_numpy(a).to(self.device)

        logp, ent = self._logp_entropy(dev(choices_b).long(), dev(masks_b))
        adv = dev(np.asarray(adv_b, np.float32))
        loss = torch.mean(-logp * adv - self.entropy_beta * ent)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self._memo.clear()  # the network changed

    # -- sampling ----------------------------------------------------------------
    @torch.no_grad()
    def _sample_config(self) -> tuple[State, np.ndarray, np.ndarray]:
        """One configuration drawn from the controller.  Between train
        steps the network is fixed, so a step's hidden state and choice
        distribution depend only on the choices before it: they are
        memoized by that prefix (``_memo``, cleared whenever the network
        changes), and a draw whose prefix was seen costs one ``searchsorted``
        instead of a GRU step and a device read.  The draws are the same:
        one ``self.rng`` number a step, on the same cumulative
        probabilities.  (A controller whose policy has collapsed draws
        thousands of already-measured configurations a round, which the
        memo makes cheap.)"""
        net = self.net
        remaining = [b for b, _ in self.budgets]
        exps: list[list[int]] = [[0] * d for _, d in self.budgets]
        choices, masks = [], []
        for (di, slot) in self.seq_spec:
            prefix = tuple(choices)
            hit = self._memo.get(prefix)
            if hit is None:
                if prefix:
                    h = net.gru(self._memo[prefix[:-1]][0], self._onehots[prefix[-1] + 1])
                else:
                    h = net.gru(net.gru.h0, net.emb0)
                logits = net.head(h).cpu().numpy().astype(np.float64)
                mask = np.zeros(self.max_e + 1, dtype=bool)
                mask[: remaining[di] + 1] = True
                logits[~mask] = _MASKED
                z = logits - logits.max()
                p = np.exp(z)
                p /= p.sum()
                hit = self._memo[prefix] = (h, np.cumsum(p), mask)
            _, cum, mask = hit
            c = int(np.searchsorted(cum, self.rng.random()))
            c = min(c, remaining[di])
            choices.append(c)
            masks.append(mask)
            exps[di][slot] = c
            remaining[di] -= c
        for di, (_, d) in enumerate(self.budgets):
            exps[di][d - 1] = remaining[di]
        rows = []
        for di, (value, _depth) in enumerate(self.space.dim_specs()):
            odd = value >> _exponent_budget(value)
            row = [2 ** e for e in exps[di]]
            row[0] *= odd
            rows.append(row)
        s = self.space.state_from_lists(rows)
        return s, np.asarray(choices, np.int32), np.stack(masks)

    # -- REINFORCE loop ------------------------------------------------------------
    def run(self, ctx: TuningContext) -> None:
        # Controller samples are drawn first, then the whole batch is
        # measured in ONE engine call — the controller's parameters only
        # update between batches, so deferring measurement changes
        # nothing about the sampling distribution while letting the
        # engine spread the batch across its measurement lanes.
        if not self._ready:
            self._setup()
        if self._c_ref is None:
            c_ref = ctx.measure(self.space.initial_state())
            self._c_ref = c_ref if math.isfinite(c_ref) else 1.0
        c_ref = self._c_ref
        while not ctx.done():
            ctx.checkpoint(self)
            sampled = []  # (state, choices, masks) pending measurement
            round_keys: set[str] = set()
            guard = 0
            while len(sampled) < self.batch_size and guard < 64:
                guard += 1
                s, choices, masks = self._sample_config()
                if not self.space.is_legitimate(s):
                    continue
                if ctx.seen(s) or s.key() in round_keys:
                    continue
                round_keys.add(s.key())
                sampled.append((s, choices, masks))
            if not sampled:
                continue
            costs = ctx.measure_many([s for s, _, _ in sampled])
            batch = [
                (choices, masks, 0.0 if not math.isfinite(c) else float(c_ref / c))
                for (_, choices, masks), c in zip(sampled, costs)
            ]
            rewards = np.asarray([b[2] for b in batch], np.float32)
            if self._baseline is None:
                self._baseline = float(rewards.mean())
            adv = rewards - self._baseline
            self._baseline = self.baseline_decay * self._baseline + (
                1 - self.baseline_decay
            ) * float(rewards.mean())
            self._train_step(
                np.stack([b[0] for b in batch]), np.stack([b[1] for b in batch]), adv
            )
