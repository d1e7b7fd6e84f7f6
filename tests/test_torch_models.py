"""The port's dense model (reduced yi-6b) held against the JAX package's:
the reference's ``init_params`` tree goes through
``params_from_reference``, and forward logits, bucket-padded ``prefill``
(with ``last_idx``) and ``decode_step`` are compared on the same numpy
token inputs.  Prompts above the reduced threshold (64) run flash
attention on both sides under one ``(block_q, block_kv)``: a flash
record is written into each package's namespace, the reference runs its
Pallas kernel in interpret mode, the port its kernel's plain version.
Tolerances: float32 2e-4 on logits (a two-layer model, GEMMs summed in
another order), bfloat16 0.1 (rounded at other places in the two
frameworks)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.core.records import TuningRecords as RefRecords
from repro.core.records import set_global_records as ref_set_records
from repro.core.records import workload_key_for as ref_key
from repro.kernels import ops as ref_ops
from repro.models import common as ref_cm
from repro.models.api import Model as RefModel
from repro_torch.configs.registry import get_arch
from repro_torch.core.flash_space import FlashScheduleState
from repro_torch.core.records import TuningRecords, global_records, set_global_records, workload_key_for
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models.api import Model
from repro_torch.models.transformer import params_from_reference

#: the flash schedule both packages serve at 128 tokens, per dtype: (block_q,
#: block_kv) = (32, 64) in f32, and (64, 32) in bf16, whose tensor-core
#: kernel takes whole 64-row warpgroups
BLOCKS = {"float32": FlashScheduleState((4, 32), (2, 64)),
          "bfloat16": FlashScheduleState((2, 64), (4, 32))}


@pytest.fixture
def flash_records():
    """Write the same flash schedule for a 128-token prompt into each
    package's records, so both run flash under identical blocks."""
    saved_ref, saved_port = ref_ops.kernel_policy(), global_records()
    ref_ops.set_kernel_policy(ref_ops.KernelPolicy(use_pallas=True, interpret=True,
                                                   pallas_ops=("flash",)))

    def write(seq, hd, dtype):
        rec = RefRecords()
        rec.update(ref_key("flash", (seq, seq, hd), dtype, "analytical_tpu_v5e"),
                   BLOCKS[dtype], cost=1.0, tuner="test", n_trials=1)
        ref_set_records(rec)
        port = TuningRecords()
        port.update(workload_key_for("flash", (seq, seq, hd), dtype, "hopper_timed"),
                    BLOCKS[dtype], cost=1.0, tuner="test", n_trials=1)
        set_global_records(port)

    ops.reset_dispatch_stats()
    yield write
    ref_ops.set_kernel_policy(saved_ref)
    ref_set_records(RefRecords())
    set_global_records(saved_port)
    ops.reset_dispatch_stats()
    ref_ops.reset_dispatch_stats()


def _configs(dtype="float32"):
    over = {} if dtype == "float32" else {"param_dtype": dtype, "compute_dtype": dtype}
    return get_arch("yi-6b").reduced(**over), ref_get_arch("yi-6b").reduced(**over)


def _models(dtype="float32", seed=0):
    cfg, ref_cfg = _configs(dtype)
    ref = RefModel(ref_cfg)
    ref_params = ref.init_params(jax.random.PRNGKey(seed))
    port = Model(cfg, device="cpu")
    params = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
    return cfg, port, params, ref, ref_params


def _close(got: torch.Tensor, ref, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_reduced_config_matches_reference():
    cfg, ref_cfg = _configs()
    port, ref = dataclasses.asdict(cfg), dataclasses.asdict(ref_cfg)
    assert port.pop("layer_pattern") == ""  # the port's own field, empty in the registry
    assert port == {k: ref[k] for k in port}
    assert get_arch("yi-6b").attn_chunk_threshold == 2048 and cfg.attn_chunk_threshold == 64


def test_params_from_reference_keeps_the_tree():
    cfg, port, params, _, ref_params = _models()
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    for path, leaf in flat_ref:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
    own = port.init_params(seed=1)
    assert jax.tree_util.tree_structure(own) == jax.tree_util.tree_structure(params)
    # the port's own init draws truncated normals scaled by 1/sqrt(d_in)
    w = own["layers"]["attn"]["wq"]["w"]
    assert w.shape == (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.resolved_head_dim)
    assert w.abs().max() <= 2.0 / cfg.d_model ** 0.5 + 1e-6
    assert 0.5 < float(w.std() * cfg.d_model ** 0.5) < 1.0


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 0.1)])
def test_forward_logits_match_reference(dtype, tol):
    cfg, port, params, ref, ref_params = _models(dtype)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    ref_logits, _ = ref.logits(ref_params, {"tokens": jnp.asarray(tokens)})
    logits, aux = port.logits(params, {"tokens": torch.from_numpy(tokens).long()})
    assert float(aux) == 0.0 and logits.shape == (2, 24, cfg.padded_vocab)
    _close(logits, ref_logits, tol)


def _padded_prompts(cfg, seq, lens, seed=1):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), seq), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return toks


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 0.1)])
def test_padded_prefill_and_decode_match_reference(dtype, tol, flash_records):
    """Prefill of a right-padded 128-token bucket (flash on both sides,
    the tuned blocks), seeded from each sequence's last real token, then
    three decode steps with the pad K/V masked out."""
    cfg, port, params, ref, ref_params = _models(dtype)
    seq, hd, max_len = 128, cfg.resolved_head_dim, 136
    flash_records(seq, hd, dtype)
    lens = np.array([128, 97, 70], np.int32)
    toks = _padded_prompts(cfg, seq, lens)

    ref_logits, ref_cache = ref.prefill(ref_params, {"tokens": jnp.asarray(toks)}, max_len,
                                        last_idx=jnp.asarray(lens - 1))
    logits, cache = port.prefill(params, {"tokens": torch.from_numpy(toks).long()}, max_len,
                                 last_idx=torch.from_numpy(lens - 1).long())
    assert ref_ops.dispatch_stats()["flash"]["records"] >= 1
    assert ops.dispatch_stats()["flash"]["records"] == cfg.n_layers
    _close(logits, ref_logits, tol)
    _close(cache["k"], ref_cache["k"], tol)
    _close(cache["v"], ref_cache["v"], tol)
    assert cache["len"] == int(ref_cache["len"]) == seq

    ref_cache = dict(ref_cache, valid_len=jnp.asarray(lens), prefill_len=jnp.asarray(seq))
    cache.update(valid_len=torch.from_numpy(lens).long(), prefill_len=seq)
    tok = np.asarray(jnp.argmax(ref_logits[:, -1, :cfg.vocab_size], -1))[:, None].astype(np.int32)
    for _ in range(3):
        ref_logits, ref_cache = ref.decode_step(ref_params, ref_cache, jnp.asarray(tok))
        logits, cache = port.decode_step(params, cache, torch.from_numpy(tok).long())
        _close(logits, ref_logits, tol)
        tok = np.asarray(jnp.argmax(ref_logits[:, -1, :cfg.vocab_size], -1))[:, None].astype(np.int32)
    assert cache["len"] == int(ref_cache["len"]) == seq + 3


def test_heuristic_and_plain_attention_dispatch():
    """Without a record the port's heuristic blocks serve a long prompt;
    where no block divides the sequence, plain attention does, counted as
    a shape rule.  Both agree with the reference's plain attention."""
    saved = global_records()
    set_global_records(TuningRecords())
    ops.reset_dispatch_stats()
    try:
        rng = np.random.default_rng(0)
        for s in (128, 100):
            q, k, v = (rng.standard_normal((1, s, 4, 16)).astype(np.float32),
                       rng.standard_normal((1, s, 2, 16)).astype(np.float32),
                       rng.standard_normal((1, s, 2, 16)).astype(np.float32))
            ref = ref_cm.causal_attention(*map(jnp.asarray, (q, k, v)))
            out = cm.attention_dispatch(*map(torch.from_numpy, (q, k, v)), chunk_threshold=64)
            _close(out, ref, 2e-5)
        st = ops.dispatch_stats()["flash"]
        assert (st["heuristic"], st["plain"], st["records"]) == (1, 1, 0)
    finally:
        set_global_records(saved)
        ops.reset_dispatch_stats()


@pytest.mark.parametrize("sq,sk", [(1, 9), (5, 9), (9, 9)])
def test_plain_attention_matches_reference(sq, sk):
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, 2, 16)).astype(np.float32) for _ in range(2))
    _close(cm.causal_attention(*map(torch.from_numpy, (q, k, v)), softcap=5.0),
           ref_cm.causal_attention(*map(jnp.asarray, (q, k, v)), softcap=5.0), 2e-5)
    length, valid, prefix = 7, np.array([3, 6]), 5
    got = cm.decode_attention(torch.from_numpy(q[:, :1]), torch.from_numpy(k), torch.from_numpy(v),
                              length, valid_len=torch.from_numpy(valid), prefix_len=prefix)
    ref = ref_cm.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k), jnp.asarray(v), length,
                                  valid_len=jnp.asarray(valid), prefix_len=prefix)
    _close(got, ref, 2e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "squared_relu", "gelu"])
def test_activations_and_norms_match_reference(kind):
    rng = np.random.default_rng(0)
    x, gate = rng.standard_normal((3, 8)).astype(np.float32), rng.standard_normal((3, 8)).astype(np.float32)
    _close(cm.mlp_act(kind, torch.from_numpy(x), torch.from_numpy(gate)),
           ref_cm.mlp_act(kind, jnp.asarray(x), jnp.asarray(gate)), 1e-5)
    p = {"scale": rng.standard_normal(8).astype(np.float32), "bias": rng.standard_normal(8).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    _close(cm.layernorm(tp, torch.from_numpy(x)), ref_cm.layernorm(jp, jnp.asarray(x)), 1e-5)
    _close(cm.rmsnorm(tp, torch.from_numpy(x)), ref_cm.rmsnorm(jp, jnp.asarray(x)), 1e-5)
    pos = np.arange(6)[None, :]
    xr = rng.standard_normal((1, 6, 2, 8)).astype(np.float32)
    _close(cm.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos), 1e4),
           ref_cm.apply_rope(jnp.asarray(xr), jnp.asarray(pos), 1e4), 1e-5)


def test_model_refuses_the_card_it_does_not_have():
    cfg = get_arch("yi-6b").reduced()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Model(cfg)
    # a family the zoo lacks, as the reference's Model refuses it
    with pytest.raises(ValueError):
        Model(dataclasses.replace(cfg, family="rwkv"), device="cpu")
