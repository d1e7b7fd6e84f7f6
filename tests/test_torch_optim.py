"""The port's optimizers and schedules (``repro_torch/optim``) against the
JAX package's on the same numpy inputs.  Limits, each named where it is
used:

- ``SCHED_RTOL`` 1e-6: the schedules' f32 arithmetic, with ``cos`` and
  ``pow`` possibly an ulp apart between the two libraries;
- ``CLIP_RTOL`` 1e-6: the global norm sums each leaf in another order;
- ``UPDATE_RTOL`` 1e-6: one AdamW or Adafactor update from the same
  gradients and state (products may fuse into one rounding on one side).
  A bf16 param is checked as its own f32 master rounded, and the master
  against the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro_torch import optim
from repro_torch.optim import opt_state_from_reference
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths

SCHED_RTOL = 1e-6
CLIP_RTOL = 1e-6
UPDATE_RTOL = 1e-6


def _tree(seed: int, dtype=np.float32) -> dict:
    """A params-like tree: stacked matrices, a stacked (L, d) norm scale,
    an unstacked (d,) scale, a bias and an f32 router beside them."""
    rng = np.random.default_rng(seed)

    def r(*shape, dt=dtype):
        return rng.standard_normal(shape).astype(np.float32).astype(dt)

    return {
        "embed": {"table": r(24, 8)},
        "layers": {"ln1": {"scale": r(2, 8)}, "attn": {"wq": {"w": r(2, 8, 16), "b": r(2, 16)}},
                   "mlp": {"router": {"w": r(2, 8, 4, dt=np.float32)}}},
        "ln_f": {"scale": r(8)},
    }


def _pair(seed: int, dtype: str):
    """The same tree for both packages: numpy f32, rounded to bf16 in
    JAX for ``dtype`` bfloat16 (the router stays f32)."""
    tree = _tree(seed)
    ref = jax.tree_util.tree_map(jnp.asarray, tree)
    if dtype == "bfloat16":
        ref = jax.tree_util.tree_map_with_path(
            lambda path, a: a if "router" in jax.tree_util.keystr(path) else a.astype(jnp.bfloat16),
            ref)
    port = opt_state_from_reference(jax.tree_util.tree_map(np.asarray, ref), "cpu")
    return ref, port


def _close(got: torch.Tensor, want, rtol, atol=0.0):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _close_trees(got: dict, want: dict, rtol):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    paths = list(tree_paths(got))
    assert [p for p, _ in paths] == ["/".join(str(k.key) for k in kp) for kp, _ in flat]
    for (_, g), (_, w) in zip(paths, flat):
        assert g.dtype == getattr(torch, str(w.dtype))
        _close(g, w, rtol)


# -- schedules -------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [("constant", (3e-4,)),
                                       ("warmup_cosine", (3e-4, 20, 100)),
                                       ("warmup_cosine", (1e-3, 0, 7)),
                                       ("warmup_linear", (3e-4, 20, 100))])
def test_schedules_match_reference(name, args):
    steps = np.arange(0, 130, dtype=np.int32)
    ref = getattr(ref_optim, name)(*args)
    port = getattr(optim, name)(*args)
    for s in steps:
        _close(port(torch.tensor(s, dtype=torch.int32)), ref(jnp.asarray(s)), SCHED_RTOL)


# -- global norm and clip --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(dtype, max_norm):
    ref, port = _pair(1, dtype)
    got, norm = optim.clip_by_global_norm(port, max_norm)
    want, ref_norm = ref_optim.clip_by_global_norm(ref, max_norm)
    _close(norm, ref_norm, CLIP_RTOL)
    _close(optim.global_norm(port), ref_optim.global_norm(ref), CLIP_RTOL)
    _close_trees(got, want, CLIP_RTOL)


# -- updates ----------------------------------------------------------------------------


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lr", [1e-3, "warmup_cosine"])
def test_update_matches_reference(opt_name, dtype, lr):
    if lr == "warmup_cosine":
        lr_ref, lr_port = ref_optim.warmup_cosine(1e-2, 1, 10), optim.warmup_cosine(1e-2, 1, 10)
    else:
        lr_ref = lr_port = lr
    # both from the reference's state after one update (every moment
    # non-zero), then one more update each from the same gradients
    ref_p, _ = _pair(2, dtype)
    ref_opt = ref_optim.make_optimizer(opt_name, lr_ref)
    port_opt = optim.make_optimizer(opt_name, lr_port)
    ref_g0, _ = _pair(3, dtype)
    ref_g, port_g = _pair(4, dtype)
    ref_p1, ref_s1 = ref_opt.update(ref_g0, ref_opt.init(ref_p), ref_p)
    to_port = lambda t: opt_state_from_reference(jax.tree_util.tree_map(np.asarray, t), "cpu")
    port_p, port_s = to_port(ref_p1), to_port(ref_s1)
    ref_p2, ref_s2 = ref_opt.update(ref_g, ref_s1, ref_p1)
    got_p, got_s = port_opt.update(port_g, port_s, port_p)
    assert got_p is port_p and got_s is port_s  # written in place
    assert int(got_s["step"]) == int(ref_s2["step"]) == 2
    _close_trees({k: v for k, v in got_s.items() if k != "step"},
                 {k: v for k, v in ref_s2.items() if k != "step"}, UPDATE_RTOL)
    if "master" in got_s:
        # each bf16 param is its own master rounded, as the reference's is
        for (_, p), (_, m) in zip(tree_paths(got_p), tree_paths(got_s["master"])):
            assert torch.equal(p, m.to(p.dtype))
    else:
        _close_trees(got_p, ref_p2, UPDATE_RTOL)


def test_adamw_state_tree_and_decay_follow_the_reference():
    """``{step, m, v, master}`` for bf16 params, no master for f32; every
    leaf of two or more dims decays (the stacked (L, d) norm scale too),
    the (d,) ``ln_f`` does not."""
    _, port = _pair(5, "bfloat16")
    opt = optim.AdamW(lr=0.1, weight_decay=0.5)
    state = opt.init(port)
    assert sorted(state) == ["m", "master", "step", "v"]
    assert all(t.dtype == torch.float32 for t in tree_leaves(state["m"]) + tree_leaves(state["v"]))
    _, f32 = _pair(5, "float32")
    assert sorted(opt.init(f32)) == ["m", "step", "v"]
    before = tree_map(lambda t: t.clone(), f32)
    zeros = tree_map(torch.zeros_like, f32)
    opt.update(zeros, opt.init(f32), f32)
    assert torch.equal(f32["ln_f"]["scale"], before["ln_f"]["scale"])
    assert not torch.equal(f32["layers"]["ln1"]["scale"], before["layers"]["ln1"]["scale"])
    assert not torch.equal(f32["layers"]["attn"]["wq"]["b"], before["layers"]["attn"]["wq"]["b"])


def test_adafactor_factors_every_matrix():
    _, port = _pair(6, "float32")
    state = optim.Adafactor().init(port)
    ref_p, _ = _pair(6, "float32")
    ref_state = ref_optim.Adafactor().init(ref_p)
    assert sorted(state) == sorted(ref_state) == ["factored", "step"]
    _close_trees(state["factored"], ref_state["factored"], 0.0)


def test_make_optimizer_names():
    assert isinstance(optim.make_optimizer("adamw", 1e-3), optim.AdamW)
    assert isinstance(optim.make_optimizer("adafactor", 1e-3), optim.Adafactor)
    with pytest.raises(ValueError):
        optim.make_optimizer("sgd", 1e-3)


def test_opt_state_from_reference_keeps_each_leaf_type():
    ref_p, _ = _pair(7, "bfloat16")
    ref_state = ref_optim.AdamW().init(ref_p)
    state = opt_state_from_reference(jax.tree_util.tree_map(np.asarray, ref_state), "cpu")
    assert state["step"].dtype == torch.int32
    assert state["master"]["embed"]["table"].dtype == torch.float32
    _close_trees(state, ref_state, 0.0)
