"""The port's tuners held against the JAX package's.

* The framework-neutral tuners (``random``, ``grid``, ``sim-anneal``,
  ``genetic``, ``xgboost-like``) reproduce the reference's trial
  sequence, costs, clock and best state bit for bit under
  ``tests/test_torch_tuning.py``'s shared table cost, with one and with
  four lanes; the gradient-boosted trees predict and serialize alike.
* All eight tuners behave on the port's spaces and its H100 cost model:
  budgets hold, no state is measured twice, one seed gives one trial
  sequence, the optimum of a brute-forced space is found, the curves are
  monotone, the registry's names are the reference's.
* The learned tuners' networks (``core/tuners/nn.py``), with parameters
  carried over from the reference by ``params_from_reference``, compute
  the reference's MLP and GRU step, and the gradients of one N-A2C and
  one RNN train step, in float32 within rtol 1e-5 / atol 1e-6; the new
  parameters agree as closely wherever Adam's first step is well
  conditioned (see ``WELL_CONDITIONED_GRAD``); and the tuners give the
  reference's trials through their first collection round.
"""

import math

import jax
import numpy as np
import pytest
import torch

from repro.core.config_space import GemmConfigSpace as RefSpace
from repro.core.learn.gbt import GradientBoostedTrees as RefGBT
from repro.core.learn.gbt import PairwiseRankGBT as RefRankGBT
from repro.core.tuners import TUNERS as REF_TUNERS
from repro.core.tuners import Budget as RefBudget
from repro.core.tuners import NA2CTuner as RefNA2C
from repro.core.tuners import RNNControllerTuner as RefRNN
from repro.core.tuners import nn as ref_nn
from repro_torch.core import AnalyticalHopperCost, Budget, GemmConfigSpace, get_op
from repro_torch.core.learn import GradientBoostedTrees, PairwiseRankGBT
from repro_torch.core.tuners import TUNERS, GBFSTuner, GridTuner, NA2CTuner, RNNControllerTuner
from repro_torch.core.tuners import nn as port_nn
from test_torch_tuning import PortTable, RefTable, _same

NEUTRAL = ["random", "grid", "sim-anneal", "genetic", "xgboost-like"]
LEARNED = ["n-a2c", "rnn-controller"]
#: the networks' float32 parity limit: the two frameworks sum a matmul
#: in different orders
RTOL, ATOL = 1e-5, 1e-6


def _kw(name: str) -> dict:
    return {"device": "cpu"} if name in LEARNED else {}


# -- (i) bit for bit against the reference --------------------------------------

@pytest.mark.parametrize("name", NEUTRAL)
@pytest.mark.parametrize("dims", [(64, 64, 64), (256, 512, 128)])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("n_workers", [1, 4])
def test_neutral_tuner_parity(name, dims, seed, n_workers):
    ref = REF_TUNERS[name](RefSpace(*dims), RefTable(RefSpace(*dims)), seed=seed).tune(
        RefBudget(max_trials=80), n_workers=n_workers
    )
    port = TUNERS[name](GemmConfigSpace(*dims), PortTable(GemmConfigSpace(*dims)),
                        seed=seed).tune(Budget(max_trials=80), n_workers=n_workers)
    assert ref.n_trials == 80
    _same(ref, port)
    assert port.clock_s == ref.clock_s


def test_gbt_predictions_and_json_match_reference():
    import json

    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 23))
    y = x[:, 0] * 2.0 - x[:, 3] ** 2 + 0.1 * rng.normal(size=200)
    groups = rng.integers(0, 4, size=200)
    x_new = rng.normal(size=(50, 23))
    ref, port = RefGBT(30, 4).fit(x, y), GradientBoostedTrees(30, 4).fit(x, y)
    np.testing.assert_array_equal(port.predict(x_new), ref.predict(x_new))
    ref_r = RefRankGBT(20, 3).fit(x, y, groups)
    port_r = PairwiseRankGBT(20, 3).fit(x, y, groups)
    np.testing.assert_array_equal(port_r.predict(x_new), ref_r.predict(x_new))
    assert json.dumps(port_r.to_jsonable()) == json.dumps(ref_r.to_jsonable())
    back = PairwiseRankGBT.from_jsonable(json.loads(json.dumps(port_r.to_jsonable())))
    np.testing.assert_array_equal(back.predict(x_new), ref_r.predict(x_new))


# -- (ii) behaviour on the port's spaces and H100 model ---------------------------

@pytest.fixture(scope="module")
def spaces():
    """256^3 float32 (about 12 % of random states launch on the SIMT
    kernel) and a 16^3 space brute-forced for its optimum."""
    space = GemmConfigSpace(256, 256, 256)
    cost = AnalyticalHopperCost(space, dtype="float32")
    small = GemmConfigSpace(16, 16, 16)
    small_cost = AnalyticalHopperCost(small, dtype="float32")
    best = min(small_cost.cost(s) for s in small.enumerate())
    return space, cost, small, small_cost, best


def _make(name, space, cost, seed, **kw):
    """A tuner as the session's warm start builds it: the ones that take
    ``s0`` start from the kernel's heuristic state (the untiled state
    cannot launch on the Hopper kernels)."""
    kw = {**_kw(name), **kw}
    if name in ("g-bfs", "n-a2c"):
        kw.setdefault("s0", get_op("gemm").default_state(space, "float32"))
    return TUNERS[name](space, cost, seed=seed, **kw)


@pytest.mark.parametrize("name", sorted(TUNERS))
def test_budget_respected(spaces, name):
    space, cost, *_ = spaces
    res = _make(name, space, cost, 0).tune(Budget(max_trials=100))
    assert res.n_trials == 100
    if name != "grid":  # the enumeration's first states cannot launch
        assert res.best_state is not None and math.isfinite(res.best_cost)


@pytest.mark.parametrize("name", sorted(TUNERS))
def test_no_duplicate_measurements(spaces, name):
    space, cost, *_ = spaces
    res = _make(name, space, cost, 1).tune(Budget(max_trials=150))
    keys = [t.state.key() for t in res.trials]
    assert len(keys) == len(set(keys)), "states must not be re-measured"


@pytest.mark.parametrize("name", sorted(TUNERS))
def test_seed_determinism(spaces, name):
    space, cost, *_ = spaces
    r1 = _make(name, space, cost, 3).tune(Budget(max_trials=80))
    r2 = _make(name, space, cost, 3).tune(Budget(max_trials=80))
    assert [(t.state.key(), t.cost) for t in r1.trials] == [
        (t.state.key(), t.cost) for t in r2.trials
    ]


@pytest.mark.parametrize("name", ["g-bfs", "random", "sim-anneal", "genetic", "xgboost-like"])
def test_finds_optimum_on_small_space(spaces, name):
    """300 trials (5 % of the 6125 states) find the brute-forced optimum."""
    *_, small, small_cost, best = spaces
    res = _make(name, small, small_cost, 0).tune(Budget(max_trials=300))
    assert res.best_cost <= best * 1.05


@pytest.mark.parametrize("name", LEARNED)
def test_learned_tuners_near_optimum(spaces, name):
    *_, small, small_cost, best = spaces
    res = _make(name, small, small_cost, 0).tune(Budget(max_trials=150))
    assert res.best_cost <= best * 2.0


def test_gbfs_explores_everything_with_full_rho(spaces):
    """rho = len(g(s)) + unlimited budget -> the full reachable space
    (paper Sec. 4.2)."""
    *_, small, small_cost, _ = spaces
    res = GBFSTuner(small, small_cost, seed=0, rho=10_000).tune(
        Budget(max_trials=small.size() + 10)
    )
    assert res.n_trials == small.size()


def test_grid_tuner_sequential(spaces):
    *_, small, small_cost, _ = spaces
    res = GridTuner(small, small_cost, seed=0).tune(Budget(max_trials=50))
    assert [t.state.key() for t in res.trials] == [s.key() for s in list(small.enumerate())[:50]]


def test_curves_monotone(spaces):
    space, cost, *_ = spaces
    res = _make("g-bfs", space, cost, 0).tune(Budget(max_trials=200))
    costs = [c for _, c in res.best_curve()]
    assert all(b <= a for a, b in zip(costs, costs[1:]))
    assert [n for n, _ in res.best_curve()] == list(range(1, 201))
    tcurve = res.best_time_curve()
    assert all(t2 >= t1 for (t1, _), (t2, _) in zip(tcurve, tcurve[1:]))


def test_tuner_registry_matches_reference():
    assert set(TUNERS) == set(REF_TUNERS) == {
        "g-bfs", "n-a2c", "xgboost-like", "rnn-controller",
        "random", "grid", "sim-anneal", "genetic",
    }


def test_learned_tuners_refuse_a_missing_card(spaces):
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid device here")
    space, cost, *_ = spaces
    for cls in (NA2CTuner, RNNControllerTuner):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cls(space, cost)  # the default device is cuda


# -- (iii) the networks against the reference's ------------------------------------

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _ref_leaf(tree, name: str) -> np.ndarray:
    """The reference's leaf for a port parameter name, in the port's
    layout (the reference's ``w`` is (n_in, n_out), the port's weight
    (n_out, n_in))."""
    path = name.split(".")
    if path[-1] in ("weight", "bias"):
        # the GRU's packed matrices are leaves there ("wi", "wh")
        tail = [] if path[-2] in ("wi", "wh") else ["w" if path[-1] == "weight" else "b"]
        path = path[:-1] + tail
    leaf = tree
    for p in path:
        if p == "layers":
            continue
        leaf = leaf[int(p)] if p.isdigit() else leaf[p]
    leaf = np.asarray(leaf)
    return leaf.T if name.endswith("weight") else leaf


#: Adam's first step moves a parameter by lr·g/(|g| + 1e-8): where the
#: gradient is within a few decades of eps (a unit whose tanh saturates
#: on every sample) float32 rounding of 1 − tanh² in either framework
#: moves the step by up to lr/2, so new parameters are compared at
#: |g| >= 1e-4 and the gradients themselves everywhere
WELL_CONDITIONED_GRAD = 1e-4


def _assert_one_adam_step(port, old, params, opt_state):
    """The port's state after one train step against the reference's:
    Adam's first moments (0.1 × the gradient after one step) within
    RTOL/ATOL everywhere; new parameters within RTOL/ATOL wherever the
    step is well conditioned, and nowhere moved by more than lr."""
    m_port = port_nn.adam_state(port.opt)["m"]
    names = [n for n, _ in port.net.named_parameters()]
    n_checked = 0
    for name, p, m in zip(names, port.net.parameters(), m_port):
        _close(m.numpy(), _ref_leaf(opt_state["m"], name))
        new, want, before = p.detach().numpy(), _ref_leaf(params, name), _ref_leaf(old, name)
        well = np.abs(m.numpy()) / 0.1 >= WELL_CONDITIONED_GRAD
        _close(new[well], want[well])
        assert np.all(np.abs(new - before) <= port.lr * (1 + RTOL))
        n_checked += int(well.sum())
    assert n_checked > 0.9 * sum(p.numel() for p in port.net.parameters())


def test_mlp_and_linear_forward_match_reference():
    params = _np(ref_nn.init_mlp(jax.random.PRNGKey(0), [23, 64, 64, 26]))
    x = np.random.default_rng(0).normal(size=(16, 23)).astype(np.float32)
    mlp = port_nn.params_from_reference(params)
    lin_p = _np(ref_nn.init_linear(jax.random.PRNGKey(1), 23, 7))
    lin = port_nn.params_from_reference(lin_p)
    with torch.no_grad():
        _close(mlp(torch.from_numpy(x)).numpy(), np.asarray(ref_nn.mlp_apply(params, x)))
        _close(lin(torch.from_numpy(x)).numpy(), np.asarray(ref_nn.linear_apply(lin_p, x)))


def test_gru_step_matches_reference():
    params = _np(ref_nn.init_gru(jax.random.PRNGKey(2), 10, 64))
    rng = np.random.default_rng(1)
    h = rng.normal(size=(5, 64)).astype(np.float32)
    x = rng.normal(size=(5, 10)).astype(np.float32)
    cell = port_nn.params_from_reference(params)
    assert not isinstance(cell, torch.nn.GRUCell)
    with torch.no_grad():
        got = cell(torch.from_numpy(h), torch.from_numpy(x)).numpy()
    _close(got, np.asarray(ref_nn.gru_step(params, h, x)))
    np.testing.assert_array_equal(cell.h0.detach().numpy(), params["h0"])


def _pair(ref_cls, port_cls, dims=(64, 64, 64), **kw):
    """A reference tuner with its networks built and a port tuner holding
    the same parameters, both on the shared table cost."""
    ref = ref_cls(RefSpace(*dims), RefTable(RefSpace(*dims)), seed=0, **kw)
    ref._setup()
    port = port_cls(GemmConfigSpace(*dims), PortTable(GemmConfigSpace(*dims)), seed=0,
                    device="cpu", **kw)
    port._setup(reference_params=_np(ref.params))
    return ref, port


def _replay_batch(space, n=32, seed=0):
    rng = np.random.default_rng(seed)
    import random

    prng = random.Random(seed)
    feats, acts, feats2, masks, masks2 = [], [], [], [], []
    for _ in range(n):
        s = space.random_state(prng)
        mask = np.array([space.step(s, a) is not None for a in space.actions])
        a = int(rng.choice(np.flatnonzero(mask)))
        s2 = space.step(s, space.actions[a])
        feats.append(space.features(s))
        feats2.append(space.features(s2))
        acts.append(a)
        masks.append(mask)
        masks2.append(np.array([space.step(s2, b) is not None for b in space.actions]))
    rewards = rng.uniform(0.0, 2.0, size=n).astype(np.float32)
    return (np.stack(feats), np.asarray(acts, np.int32), rewards, np.stack(feats2),
            np.stack(masks), np.stack(masks2))


def test_na2c_train_step_matches_reference():
    ref, port = _pair(RefNA2C, NA2CTuner)
    batch = _replay_batch(port.space)
    old = _np(ref.params)
    params, opt_state = ref._train_step(ref.params, ref.opt_state, *batch)
    port._train_step(*batch)
    _assert_one_adam_step(port, old, _np(params), _np(opt_state))
    assert port_nn.adam_state(port.opt)["t"] == int(opt_state["t"]) == 1


def test_rnn_train_step_matches_reference():
    ref, port = _pair(RefRNN, RNNControllerTuner)
    samples = [ref._sample_config() for _ in range(8)]
    choices = np.stack([c for _, c, _ in samples])
    masks = np.stack([m for _, _, m in samples])
    adv = np.random.default_rng(3).normal(size=8).astype(np.float32)
    old = _np(ref.params)
    params, opt_state = ref._train_step(ref.params, ref.opt_state, choices, masks, adv)
    port._train_step(choices, masks, adv)
    _assert_one_adam_step(port, old, _np(params), _np(opt_state))


def test_rnn_sampling_memo_changes_no_draw():
    """The controller memoizes each step's hidden state and choice
    distribution by the choices before it while its network is fixed: the
    same seed draws the same configurations, choices and masks with the
    memo emptied before every draw, before and after a train step."""
    space = GemmConfigSpace(256, 256, 256)
    memo, fresh = (RNNControllerTuner(space, None, seed=5, device="cpu") for _ in range(2))
    for t in (memo, fresh):
        t._setup()

    def draws(t, n, clear):
        out = []
        for _ in range(n):
            if clear:
                t._memo.clear()
            s, c, m = t._sample_config()
            out.append((s.key(), c.tolist(), m.tolist()))
        return out

    for _ in range(2):
        got = draws(memo, 200, clear=False)
        assert got == draws(fresh, 200, clear=True)
        assert len(memo._memo) < 200 * len(memo.seq_spec)  # later draws hit
        choices = np.stack([np.asarray(c, np.int32) for _, c, _ in got[:8]])
        masks = np.stack([np.asarray(m) for _, _, m in got[:8]])
        adv = np.random.default_rng(3).normal(size=8).astype(np.float32)
        for t in (memo, fresh):
            t._train_step(choices, masks, adv)
        assert memo._memo == {}


def test_rnn_draws_are_counted_by_seed():
    """Every draw adds one to ``rnn_controller.DRAWS`` under the tuner's
    seed, whether or not its configuration is measured; a search counts at
    least one draw per measured trial after the first (the untiled state)."""
    from repro_torch.core.tuners.rnn_controller import DRAWS

    DRAWS.clear()
    t = RNNControllerTuner(GemmConfigSpace(256, 256, 256), None, seed=7, device="cpu")
    t._setup()
    for _ in range(25):
        t._sample_config()
    assert DRAWS == {7: 25}
    DRAWS.clear()
    space = GemmConfigSpace(128, 128, 128)
    tuner = RNNControllerTuner(space, AnalyticalHopperCost(space, dtype="float32"),
                               seed=3, device="cpu")
    res = tuner.tune(Budget(max_trials=40))
    assert set(DRAWS) == {3} and DRAWS[3] >= res.n_trials - 1


@pytest.mark.parametrize("ref_cls,port_cls,first_round", [
    (RefNA2C, NA2CTuner, 1 + 16),  # c_ref's state, then one batch of 16
    (RefRNN, RNNControllerTuner, 1 + 8),  # the untiled state, then 8 samples
])
def test_first_collection_round_matches_reference(ref_cls, port_cls, first_round):
    """With carried-over parameters the sampled trials equal the
    reference's until the first train step; after it (float32 rounding
    apart) the run is held on behaviour."""
    ref, port = _pair(ref_cls, port_cls)
    r = ref.tune(RefBudget(max_trials=60))
    p = port.tune(Budget(max_trials=60))
    trace = [(t.state.key(), t.cost, t.clock_s) for t in p.trials]
    assert trace[:first_round] == [(t.state.key(), t.cost, t.clock_s) for t in r.trials][:first_round]
    assert p.n_trials == 60 and len({k for k, _, _ in trace}) == 60
