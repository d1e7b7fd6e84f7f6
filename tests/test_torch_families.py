"""The port's model zoo, every family but dense (which
``test_torch_models.py`` holds), against the JAX package's on the same
numpy inputs: configs, the attention pieces, the MoE layer, the
attention families' logits and bucket-padded prefill + decode, and the
SSD scan with the SSM and hybrid models at exact lengths.  Parameters are
the reference's ``init_params`` trees carried across with
``params_from_reference``.  Tolerances, as in ``test_torch_models.py``:
float32 2e-4 (sums in another order), bfloat16 0.1 (rounded at other
places in the two frameworks).

The MoE models run at ``moe_capacity_factor = E / k``, a capacity that
drops no choice, wherever they are held against the reference's model:
the reference writes each dropped choice into its expert's slot 0 (a
reference gap, ROADMAP.md); ``test_moe_apply_with_drops`` holds the
port's drop path against the reference on every token that gap leaves
alone, and against a per-token numpy MoE on every token."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import common as ref_cm
from repro.models import mamba2 as ref_mb
from repro.models import transformer as ref_tf
from repro.models.api import Model as RefModel
from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models import mamba2 as mb
from repro_torch.models import transformer as tf
from repro_torch.models.api import Model
from repro_torch.models.transformer import params_from_reference

ATTN_ARCHS = ["qwen3-moe-235b-a22b", "grok-1-314b", "whisper-tiny", "llava-next-34b",
              "qwen2-72b"]
SSM_ARCHS = ["mamba2-130m", "zamba2-1.2b"]
TOL = {"float32": 2e-4, "bfloat16": 0.1}


def _no_drop(name: str) -> dict:
    """The capacity factor at which a reduced MoE drops no choice."""
    arch = registry.get_arch(name)
    return {"moe_capacity_factor": 2.0} if arch.family == "moe" else {}


def _models(name: str, dtype: str = "float32", seed: int = 0, **over):
    if dtype != "float32":
        over.update(param_dtype=dtype, compute_dtype=dtype)
    cfg = registry.get_arch(name).reduced(**over)
    ref_cfg = ref_registry.get_arch(name).reduced(**over)
    ref = RefModel(ref_cfg)
    ref_params = ref.init_params(jax.random.PRNGKey(seed))
    params = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
    return cfg, Model(cfg, device="cpu"), params, ref, ref_params


def _close(got: torch.Tensor, ref, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def _batches(cfg, tokens: np.ndarray, dtype: str, seed: int = 2):
    """The same inputs for both packages: tokens, and the stub frontends'
    embeddings (frames for encdec, patches for a VLM) from numpy."""
    rng = np.random.default_rng(seed)
    ref, port = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens).long()}
    extra = {}
    b = tokens.shape[0]
    if cfg.family == "encdec":
        extra["enc_frames"] = rng.standard_normal((b, cfg.encoder_len, cfg.d_model))
    if cfg.frontend == "vision_patches":
        extra["frontend_embeds"] = rng.standard_normal((b, cfg.n_frontend_tokens, cfg.d_model))
    for key, arr in extra.items():
        arr = arr.astype(np.float32)
        ref[key] = jnp.asarray(arr).astype(jnp.dtype(dtype))
        port[key] = torch.from_numpy(arr).to(getattr(torch, dtype))
    return ref, port


# -- configs ---------------------------------------------------------------------


def _fields(cfg) -> dict:
    """A registry config's fields but ``layer_pattern``, the port's own
    field (the reference's record has none), which it leaves empty."""
    fields = dataclasses.asdict(cfg)
    assert fields.pop("layer_pattern") == ""
    return fields


@pytest.mark.parametrize("name", sorted(ref_registry.ARCHS))
def test_config_matches_reference(name):
    cfg, ref = registry.get_arch(name), ref_registry.get_arch(name)
    assert _fields(cfg) == dataclasses.asdict(ref)
    assert _fields(cfg.reduced()) == dataclasses.asdict(ref.reduced())
    assert (cfg.n_params(), cfg.n_active_params()) == (ref.n_params(), ref.n_active_params())
    assert cfg.gemm_workloads(8, 4096) == ref.gemm_workloads(8, 4096)
    assert (cfg.d_inner, cfg.ssm_heads, cfg.padded_vocab) == (
        ref.d_inner, ref.ssm_heads, ref.padded_vocab)


def test_registry_matches_reference():
    assert list(registry.ARCHS) == list(ref_registry.ARCHS)
    assert [(a.name, s.name) for a, s in registry.all_cells()] == [
        (a.name, s.name) for a, s in ref_registry.all_cells()]
    assert dataclasses.asdict(registry.get_shape("decode_32k")) == dataclasses.asdict(
        ref_registry.get_shape("decode_32k"))
    with pytest.raises(KeyError):
        registry.get_arch("gpt-5")


# -- attention pieces ----------------------------------------------------------------


@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_chunked_causal_attention_matches_reference(softcap):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 64, 2, 16)).astype(np.float32) for _ in range(2))
    got = cm.chunked_causal_attention(*map(torch.from_numpy, (q, k, v)), chunk_q=16,
                                      chunk_k=32, softcap=softcap)
    ref = ref_cm.chunked_causal_attention(*map(jnp.asarray, (q, k, v)), chunk_q=16,
                                          chunk_k=32, softcap=softcap)
    _close(got, ref, 2e-5)
    _close(got, ref_cm.causal_attention(*map(jnp.asarray, (q, k, v)), softcap=softcap), 2e-5)


def test_cross_attention_and_positions_match_reference():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 11, 2, 16)).astype(np.float32) for _ in range(2))
    _close(cm.cross_attention(*map(torch.from_numpy, (q, k, v)), softcap=3.0),
           ref_cm.cross_attention(*map(jnp.asarray, (q, k, v)), softcap=3.0), 2e-5)
    _close(cm.causal_attention(*map(torch.from_numpy, (q, k, v)), causal=False),
           ref_cm.causal_attention(*map(jnp.asarray, (q, k, v)), causal=False), 2e-5)
    _close(cm.sinusoidal_positions(37, 24), ref_cm.sinusoidal_positions(37, 24), 1e-5)


def test_long_softcapped_attention_runs_chunked():
    """A long sequence flash cannot take (a softcap) goes to chunked
    attention, as the reference's dispatch sends it, and counts no flash
    dispatch; one no block divides is counted as ``plain`` and runs
    chunked too."""
    rng = np.random.default_rng(2)
    ops.reset_dispatch_stats()
    try:
        for s, softcap in ((128, 30.0), (100, 0.0)):
            q = rng.standard_normal((1, s, 4, 16)).astype(np.float32)
            k, v = (rng.standard_normal((1, s, 2, 16)).astype(np.float32) for _ in range(2))
            got = cm.attention_dispatch(*map(torch.from_numpy, (q, k, v)), softcap=softcap,
                                        chunk_threshold=64)
            ref = ref_cm.attention_dispatch(*map(jnp.asarray, (q, k, v)), softcap=softcap,
                                            chunk_threshold=64)
            _close(got, ref, 2e-5)
        st = ops.dispatch_stats()["flash"]
        assert (st["plain"], st["records"], st["heuristic"]) == (1, 0, 0)
    finally:
        ops.reset_dispatch_stats()


# -- MoE ---------------------------------------------------------------------------------


def _numpy_moe(cfg, p, x, cap):
    """Top-k capacity MoE per token in numpy: each expert keeps its first
    ``cap`` choices in (token, choice) order and drops the rest."""
    logits = x @ p["router"]["w"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top_e = np.argsort(-probs, axis=-1, kind="stable")[:, :cfg.experts_per_token]
    top_w = np.take_along_axis(probs, top_e, -1)
    top_w /= top_w.sum(-1, keepdims=True)
    out, load = np.zeros_like(x), np.zeros(cfg.n_experts, int)
    dropped = 0
    for t in range(x.shape[0]):
        for j, e in enumerate(top_e[t]):
            load[e] += 1
            if load[e] > cap:
                dropped += 1
                continue
            gate, up = x[t] @ p["wg"][e], x[t] @ p["wi"][e]
            hid = gate / (1 + np.exp(-gate)) * up  # swiglu
            out[t] += top_w[t, j] * (hid @ p["wo"][e])
    return out, top_e, dropped


def test_moe_apply_with_drops():
    """moe_apply at a capacity that drops choices: aux loss equal to the
    reference's; every token's output equal to a per-token numpy MoE;
    and equal to the reference's on every token its slot-0 write leaves
    alone (the first kept token of an overflowing expert, unless it is
    token 0, takes token 0's row there)."""
    cfg, _, params, _, ref_params = _models("qwen3-moe-235b-a22b", moe_capacity_factor=1.0)
    t = 16
    cap = max(1, int(cfg.experts_per_token * t * cfg.moe_capacity_factor / cfg.n_experts))
    x = np.random.default_rng(5).standard_normal((1, t, cfg.d_model)).astype(np.float32)
    p_np = jax.tree_util.tree_map(lambda a: np.asarray(a[0]), ref_params["layers"]["mlp"])
    p_t = tf.layer(params["layers"]["mlp"], 0)
    got, aux = tf.moe_apply(cfg, p_t, torch.from_numpy(x))
    ref, ref_aux = ref_tf.moe_apply(cfg, jax.tree_util.tree_map(jnp.asarray, p_np),
                                    jnp.asarray(x))
    want, top_e, dropped = _numpy_moe(cfg, p_np, x[0], cap)
    assert dropped > 0
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
    _close(got[0], want, 2e-4)
    flat = top_e.reshape(-1)
    collided = {int(np.flatnonzero(flat == e)[0]) // cfg.experts_per_token
                for e in range(cfg.n_experts) if (flat == e).sum() > cap} - {0}
    keep = [i for i in range(t) if i not in collided]
    _close(got[0, keep], np.asarray(ref)[0, keep], 2e-4)
    # the gap itself: on those tokens the reference departs from the MoE
    assert collided and all(np.abs(np.asarray(ref)[0, i] - want[i]).max() > 1e-2
                            for i in collided)


# -- attention families ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ATTN_ARCHS)
def test_forward_logits_match_reference(name, dtype):
    cfg, port, params, ref, ref_params = _models(name, dtype, **_no_drop(name))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    ref_batch, batch = _batches(cfg, tokens, dtype)
    ref_logits, ref_aux = ref.logits(ref_params, ref_batch)
    logits, aux = port.logits(params, batch)
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision_patches" else 0
    assert logits.shape == (2, 24 + n_front, cfg.padded_vocab)
    _close(logits, ref_logits, TOL[dtype])
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=TOL[dtype], atol=1e-6)


@pytest.mark.parametrize("name", ATTN_ARCHS)
def test_padded_prefill_and_decode_match_reference(name):
    """A right-padded 96-token bucket (above the reduced threshold of 64:
    flash where it can run, else chunked attention), seeded from each
    sequence's last real token, then three decode steps with the pad K/V
    masked out, float32."""
    cfg, port, params, ref, ref_params = _models(name, **_no_drop(name))
    seq, max_len = 96, 112
    lens = np.array([96, 71, 50], np.int32)
    rng = np.random.default_rng(1)
    toks = np.zeros((3, seq), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    ref_batch, batch = _batches(cfg, toks, "float32")
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision_patches" else 0
    last = lens - 1 + n_front
    ref_logits, ref_cache = ref.prefill(ref_params, ref_batch, max_len,
                                        last_idx=jnp.asarray(last))
    logits, cache = port.prefill(params, batch, max_len, last_idx=torch.from_numpy(last).long())
    _close(logits, ref_logits, 2e-4)
    _close(cache["k"], ref_cache["k"], 2e-4)
    if cfg.family == "encdec":
        _close(cache["cross_k"], ref_cache["cross_k"], 2e-4)
    assert int(cache["len"]) == int(ref_cache["len"]) == seq + n_front

    valid = lens + n_front
    ref_cache = dict(ref_cache, valid_len=jnp.asarray(valid),
                     prefill_len=jnp.asarray(seq + n_front))
    cache.update(valid_len=torch.from_numpy(valid).long(),
                 prefill_len=torch.tensor(seq + n_front))
    tok = np.asarray(jnp.argmax(ref_logits[:, -1, :cfg.vocab_size], -1))[:, None].astype(np.int32)
    for _ in range(3):
        ref_logits, ref_cache = ref.decode_step(ref_params, ref_cache, jnp.asarray(tok))
        logits, cache = port.decode_step(params, cache, torch.from_numpy(tok).long())
        _close(logits, ref_logits, 2e-4)
        tok = np.asarray(jnp.argmax(ref_logits[:, -1, :cfg.vocab_size], -1))[:, None].astype(
            np.int32)
    assert int(cache["len"]) == int(ref_cache["len"]) == seq + n_front + 3


def test_params_from_reference_keeps_each_leaf_type():
    """bf16 weights stay bf16, the router and the SSM scalars f32, as in
    the reference's tree; the port's own init builds the same tree."""
    for name in ("qwen3-moe-235b-a22b", "zamba2-1.2b", "whisper-tiny"):
        cfg, port, params, _, ref_params = _models(name, "bfloat16")
        for path, leaf in jax.tree_util.tree_flatten_with_path(ref_params)[0]:
            node = params
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape
            assert str(node.dtype).removeprefix("torch.") == str(leaf.dtype)
        own = port.init_params(seed=1)
        assert jax.tree_util.tree_structure(own) == jax.tree_util.tree_structure(params)


def test_model_dispatches_every_family():
    """Every family's cache starts empty; an SSM prefill right-padded past
    a row's length (``last_idx``) stops that row's state at its length:
    its logits and recurrent state are the exact-length prefill's."""
    for name in registry.ARCHS:
        cfg = registry.get_arch(name).reduced()
        model = Model(cfg, device="cpu")
        cache = model.init_cache(2, 16)
        assert int(cache["len"]) == 0
    model = Model(registry.get_arch("mamba2-130m").reduced(), device="cpu")
    params = model.init_params(seed=2)
    toks = torch.randint(0, 256, (1, 21), generator=torch.Generator().manual_seed(0))
    padded = torch.cat([toks, torch.randint(0, 256, (1, 11))], 1)  # 32: two chunks
    want, exact = model.prefill(params, {"tokens": toks}, 40)
    got, cache = model.prefill(params, {"tokens": padded}, 40,
                               last_idx=torch.tensor([toks.shape[1] - 1]))
    _close(got, want.numpy(), 2e-4)
    _close(cache["layers"]["ssm"], exact["layers"]["ssm"].numpy(), 2e-4)
    _close(cache["layers"]["conv"], exact["layers"]["conv"].numpy(), 2e-4)


# -- SSD, SSM and hybrid ---------------------------------------------------------------


def test_ssd_chunked_matches_reference_and_the_recurrence():
    rng = np.random.default_rng(3)
    b, l, h, p, n = 2, 32, 4, 8, 6
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, l, h))).astype(np.float32) * 0.1
    A = -np.linspace(0.5, 2.0, h).astype(np.float32)
    B, C = (rng.standard_normal((b, l, h, n)).astype(np.float32) for _ in range(2))
    jargs, targs = map(jnp.asarray, (x, dt, A, B, C)), map(torch.from_numpy, (x, dt, A, B, C))
    jargs, targs = list(jargs), list(targs)
    y, state = mb.ssd_chunked(*targs, chunk=8, return_state=True)
    ref_y, ref_state = ref_mb.ssd_chunked(*jargs, chunk=8, return_state=True)
    _close(y, ref_y, 2e-4)
    _close(state, ref_state, 2e-4)
    _close(mb.ssd_reference(*targs), ref_mb.ssd_reference(*jargs), 2e-4)
    _close(y, ref_mb.ssd_reference(*jargs), 2e-4)


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_ssm_and_hybrid_prefill_and_decode_match_reference(name):
    """Forward logits, an exact-length prefill (the recurrent state after
    the last token) and three decode steps, float32."""
    cfg, port, params, ref, ref_params = _models(name)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    ref_logits, _ = ref.logits(ref_params, {"tokens": jnp.asarray(toks)})
    logits, aux = port.logits(params, {"tokens": torch.from_numpy(toks).long()})
    _close(logits, ref_logits, 2e-4)
    assert float(aux) == 0.0

    ref_logits, ref_cache = ref.prefill(ref_params, {"tokens": jnp.asarray(toks)}, 40)
    logits, cache = port.prefill(params, {"tokens": torch.from_numpy(toks).long()}, 40)
    _close(logits, ref_logits, 2e-4)
    states = (("layers", "layers"),) if cfg.family == "ssm" else (("mamba", "mamba"),)
    for ours, theirs in states:
        _close(cache[ours]["ssm"], ref_cache[theirs]["ssm"], 2e-4)
        _close(cache[ours]["conv"], ref_cache[theirs]["conv"], 2e-4)
    tok = np.asarray(jnp.argmax(ref_logits[:, -1, :cfg.vocab_size], -1))[:, None].astype(np.int32)
    for _ in range(3):
        ref_logits, ref_cache = ref.decode_step(ref_params, ref_cache, jnp.asarray(tok))
        logits, cache = port.decode_step(params, cache, torch.from_numpy(tok).long())
        _close(logits, ref_logits, 2e-4)
        tok = np.asarray(jnp.argmax(ref_logits[:, -1, :cfg.vocab_size], -1))[:, None].astype(
            np.int32)
    assert int(cache["len"]) == int(ref_cache["len"]) == 35
