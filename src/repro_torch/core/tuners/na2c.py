"""N-A2C — Neighborhood Actor Advantage Critic tuner (paper Algorithm 2,
Fig. 6), with its networks in PyTorch.

Per episode the agent rolls out ``T`` steps from the neighborhood center
(the best state ever visited), collecting *unvisited* states into a
candidate batch; when the batch is full, all candidates are measured in
**one batched engine call** (``measure_many``), the replay memory is
updated with transitions and rewards ``r = c_ref / cost(s')`` (Eqn. 8),
and the actor/critic networks are trained from replay.  The center
re-anchors to the incumbent (line 22 of Algorithm 2).  Action masks are
memoized per episode (each is one ``space.step`` probe per action).

The search logic is the JAX package's (``repro/core/tuners/na2c.py``)
line for line:

  * every sampling decision draws from ``self.rng`` (a Python
    ``random.Random``), so one seed gives one rollout sequence;
  * the policy's logits are masked and sampled in numpy float32, as
    there; only the network forward and the train step run in torch;
  * ε-greedy follows π with probability ε, annealed upward from
    ``epsilon0`` to ``epsilon1`` over the budget (the paper's
    orientation), with the paper's optional T-decay;
  * rewards are normalized by the first measured state's cost (the
    warm-start state, or the untiled one), falling back to 1.0 when that
    cost is ``inf``.

The networks (actor and critic MLPs over the space's tiling features)
run on ``device`` — ``cuda`` unless ``cpu`` is asked for; ``cuda``
without a card raises.  They run on the default stream, which the
measured cost also times on, so a train step still running cannot fall
inside a timed launch.
"""

from __future__ import annotations

import collections
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..snapshot import tree_from_jsonable, tree_to_jsonable
from ..space import State
from .base import Tuner, TuningContext
from .nn import MLP, adam_state, load_adam_state, make_adam, network_device, params_from_reference

__all__ = ["NA2CTuner"]

#: logit of an illegitimate action (the reference's mask value)
_MASKED = np.float32(-1e9)


class NA2CTuner(Tuner):
    name = "n-a2c"

    def __init__(
        self,
        space,
        cost,
        seed: int = 0,
        steps_per_episode: int = 3,  # paper: T = 3 for the GPU experiments
        batch_size: int = 16,  # len(B_test)
        epsilon0: float = 0.35,
        epsilon1: float = 0.9,
        gamma: float = 0.9,
        hidden: int = 64,
        lr: float = 3e-3,
        entropy_beta: float = 1e-2,
        replay_cap: int = 4096,
        train_iters: int = 8,
        t_decay: bool = False,
        s0: Optional[State] = None,
        device="cuda",
    ):
        super().__init__(space, cost, seed)
        self.T = steps_per_episode
        self.batch_size = batch_size
        self.eps0, self.eps1 = epsilon0, epsilon1
        self.gamma = gamma
        self.hidden = hidden
        self.lr = lr
        self.entropy_beta = entropy_beta
        self.replay_cap = replay_cap
        self.train_iters = train_iters
        self.t_decay = t_decay
        self.s0 = s0
        self.device = network_device(device)
        self._ready = False
        # search memory (externalized so snapshots can capture it)
        self._center: Optional[State] = None
        self._c_ref: Optional[float] = None
        self._replay: Optional[collections.deque] = None
        self._episode = 0
        self._T = steps_per_episode

    # -- crash-safe resume ---------------------------------------------------
    def state_dict(self) -> dict:
        d = super().state_dict()
        d["center"] = None if self._center is None else self._center.as_lists()
        d["c_ref"] = self._c_ref
        d["episode"] = self._episode
        d["T"] = self._T
        d["replay"] = (
            None
            if self._replay is None
            else [tree_to_jsonable(e) for e in self._replay]
        )
        if self._ready:
            d["params"] = tree_to_jsonable(dict(self.net.state_dict()))
            d["opt_state"] = tree_to_jsonable(adam_state(self.opt))
        return d

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self._center = (
            None
            if state["center"] is None
            else self.space.state_from_lists(state["center"])
        )
        self._c_ref = state["c_ref"]
        self._episode = state["episode"]
        self._T = state["T"]
        self._replay = (
            None
            if state["replay"] is None
            else collections.deque(
                (tree_from_jsonable(e) for e in state["replay"]),
                maxlen=self.replay_cap,
            )
        )
        if "params" in state:
            if not self._ready:
                self._setup()  # builds the modules and optimizer, then overwrite
            params = tree_from_jsonable(state["params"], torch.from_numpy)
            self.net.load_state_dict(params)
            load_adam_state(self.opt, tree_from_jsonable(state["opt_state"]))

    # -- networks --------------------------------------------------------------
    def _setup(self, reference_params: Optional[dict] = None) -> None:
        """Build actor and critic (``F → hidden → hidden → A`` and ``→ 1``)
        from a generator seeded with the tuner's seed, or from the JAX
        package's parameter tree (``{"actor": [...], "critic": [...]}``,
        numpy leaves) when one is given, and Adam over both."""
        F_, A = self.space.n_features, self.space.n_actions
        if reference_params is None:
            gen = torch.Generator().manual_seed(self.seed)
            actor = MLP([F_, self.hidden, self.hidden, A], gen)
            critic = MLP([F_, self.hidden, self.hidden, 1], gen)
        else:
            actor = params_from_reference(reference_params["actor"])
            critic = params_from_reference(reference_params["critic"])
        self.net = nn.ModuleDict({"actor": actor, "critic": critic}).to(self.device)
        self.opt = make_adam(self.net, self.lr)
        self._ready = True

    def _loss(self, feats, acts, rewards, feats2, mask) -> torch.Tensor:
        """The reference's ``loss_fn``: masked policy gradient on the
        detached advantage, the critic's squared TD error against a
        detached bootstrap, and an entropy bonus over legal actions."""
        actor, critic = self.net["actor"], self.net["critic"]
        logits = torch.where(mask, actor(feats), _MASKED.item())
        logp = F.log_softmax(logits, dim=-1)
        v = critic(feats)[:, 0]
        v2 = critic(feats2)[:, 0]
        target = rewards + self.gamma * v2.detach()
        adv = target - v
        critic_loss = torch.mean(adv**2)
        sel_logp = torch.gather(logp, 1, acts[:, None])[:, 0]
        actor_loss = -torch.mean(sel_logp * adv.detach())
        p = torch.exp(logp)
        entropy = -torch.mean(torch.sum(torch.where(mask, p * logp, 0.0), dim=-1))
        return actor_loss + 0.5 * critic_loss - self.entropy_beta * entropy

    def _train_step(self, feats, acts, rewards, feats2, mask, mask2) -> None:
        """One Adam step on a replay batch (numpy arrays; ``mask2`` is
        carried in the replay tuple as in the reference, and unused)."""
        def dev(a):
            return torch.from_numpy(a).to(self.device)

        loss = self._loss(dev(feats), dev(acts).long(), dev(rewards), dev(feats2), dev(mask))
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()

    @torch.no_grad()
    def _policy_logits(self, feat: np.ndarray, mask: np.ndarray) -> np.ndarray:
        logits = self.net["actor"](torch.from_numpy(feat).to(self.device)[None])[0]
        return np.where(mask, logits.cpu().numpy(), _MASKED)

    # -- helpers ---------------------------------------------------------------
    def _action_mask(self, s: State) -> np.ndarray:
        return np.array(
            [self.space.step(s, a) is not None for a in self.space.actions],
            dtype=bool,
        )

    def _policy_action(self, s: State, mask: np.ndarray) -> int:
        logits = self._policy_logits(self.space.features(s), mask)
        # sample from the masked softmax
        z = logits - logits.max()
        p = np.exp(z)
        p = p / p.sum()
        return int(np.searchsorted(np.cumsum(p), self.rng.random()))

    # -- Algorithm 2 -------------------------------------------------------------
    def run(self, ctx: TuningContext) -> None:
        if not self._ready:
            self._setup()
        if self._replay is None:
            self._center = self.s0 or self.space.initial_state()
            c_ref = ctx.measure(self._center)
            self._c_ref = c_ref if math.isfinite(c_ref) else 1.0
            self._replay = collections.deque(maxlen=self.replay_cap)
        c_ref = self._c_ref
        replay = self._replay
        while not ctx.done():
            ctx.checkpoint(self)
            T = self._T
            center = self._center
            frac = len(ctx.trials) / max(1, ctx.max_trials)
            eps = self.eps0 + (self.eps1 - self.eps0) * frac
            collected: list[State] = []
            collected_keys: set[str] = set()
            transitions: list[tuple[State, int, State]] = []
            masks: dict[str, np.ndarray] = {}

            def mask_of(s: State) -> np.ndarray:
                m = masks.get(s.key())
                if m is None:
                    m = self._action_mask(s)
                    masks[s.key()] = m
                return m

            # -- collect candidates by T-step rollouts around the center ------
            guard = 0
            while len(collected) < self.batch_size and guard < 50:
                guard += 1
                s = center
                for _ in range(max(1, T)):
                    mask = mask_of(s)
                    if not mask.any():
                        break
                    if self.rng.random() < eps:
                        a_idx = self._policy_action(s, mask)
                        if not mask[a_idx]:
                            a_idx = self.rng.choice(np.flatnonzero(mask).tolist())
                    else:
                        a_idx = self.rng.choice(np.flatnonzero(mask).tolist())
                    s2 = self.space.step(s, self.space.actions[a_idx])
                    if s2 is None:  # masks admit only legal actions
                        raise RuntimeError(f"masked action {a_idx} is illegal at {s}")
                    transitions.append((s, a_idx, s2))
                    if not ctx.seen(s2) and s2.key() not in collected_keys:
                        collected.append(s2)
                        collected_keys.add(s2.key())
                    s = s2
            if not collected:
                # neighborhood exhausted: hop the center to a random state
                self._center = self.space.random_state(self.rng)
                if not ctx.seen(self._center):
                    ctx.measure(self._center)
                continue
            # -- measure the batch: one engine round ----------------------------
            ctx.measure_many(collected)  # may raise BudgetExhausted — fine (line 4)
            # -- replay update: rewards from the visited-cost table -------------
            for (s, a_idx, s2) in transitions:
                c2 = ctx.visited.get(s2.key())
                if c2 is None:
                    continue
                r = 0.0 if not math.isfinite(c2) else float(c_ref / c2)
                replay.append(
                    (
                        self.space.features(s),
                        a_idx,
                        r,
                        self.space.features(s2),
                        mask_of(s),
                        mask_of(s2),
                    )
                )
            # -- re-anchor the neighborhood center (Algorithm 2 line 22) --------
            if ctx.best_state is not None:
                self._center = ctx.best_state
            # -- train actor + critic from replay -------------------------------
            if len(replay) >= 8:
                for _ in range(self.train_iters):
                    idx = [self.rng.randrange(len(replay)) for _ in range(min(64, len(replay)))]
                    batch = [replay[i] for i in idx]
                    self._train_step(
                        np.stack([b[0] for b in batch]),
                        np.array([b[1] for b in batch], dtype=np.int32),
                        np.array([b[2] for b in batch], dtype=np.float32),
                        np.stack([b[3] for b in batch]),
                        np.stack([b[4] for b in batch]),
                        np.stack([b[5] for b in batch]),
                    )
            self._episode += 1
            if self.t_decay and self._episode % 16 == 0 and self._T > 1:
                self._T -= 1
