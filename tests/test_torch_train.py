"""The port's training stack against the JAX package's on the same numpy
inputs: ``Model.loss`` and its gradients for a reduced config of each of
the six families, the losses, remat, attention under autograd (flash has
no backward), the GEMM backward, the train step with and without
microbatches, five ``Trainer`` steps against a loop built by hand from
the reference's parts that import (its own ``Trainer`` needs
``repro.dist`` modules that do not exist, ROADMAP.md), resume, and the
CLI.  Parameters are the reference's ``init_params`` trees carried
across with ``params_from_reference``.  Limits:

- ``LOSS_RTOL`` 1e-5: losses and metrics (f32 sums in another order);
- ``GRAD_RTOL`` / ``GRAD_ATOL`` 1e-4 / 1e-6: f32 gradients;
- ``BF16_GRAD_REL`` 0.1: per-leaf relative L2 error of bf16 gradients
  (the two frameworks round to bf16 at other places; the models' bf16
  logits are held at 0.1 too);
- ``GEMM_TOL``: the reference's GEMM kernel limits, f32 1e-4, bf16 0.05;
- ``STEP_LOSS_RTOL`` 1e-4 and ``STEP_NORM_RTOL`` 1e-3: five optimizer
  steps, where each step's rounding differences feed the next.

MoE configs run at ``moe_capacity_factor`` = E / k, a capacity that drops
nothing (the reference's drop gap, ROADMAP.md)."""

import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.data.pipeline import DataPipeline as RefPipeline
from repro.data.pipeline import SyntheticLM as RefSynthetic
from repro.kernels import ops as ref_ops
from repro.models import common as ref_cm
from repro.models import transformer as ref_tf
from repro.models.api import Model as RefModel
from repro.optim import make_optimizer as ref_make_optimizer
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataPipeline, SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ledger import current_role
from repro_torch.launch import train as train_cli
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.models.api import Model
from repro_torch.models.transformer import params_from_reference
from repro_torch.train.step import (
    make_decode_step, make_prefill_step, make_train_step, value_and_grad,
)
from repro_torch.train.trainer import Trainer
from repro_torch.utils.tree import tree_leaves, tree_paths

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
BF16_GRAD_REL = 0.1
GEMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.05}
STEP_LOSS_RTOL, STEP_NORM_RTOL = 1e-4, 1e-3

FAMILIES = ["yi-6b", "qwen3-moe-235b-a22b", "whisper-tiny", "llava-next-34b",
            "mamba2-130m", "zamba2-1.2b"]


def _over(name: str, dtype: str = "float32") -> dict:
    over = {"moe_capacity_factor": 2.0} if registry.get_arch(name).family == "moe" else {}
    if dtype != "float32":
        over.update(param_dtype=dtype, compute_dtype=dtype)
    return over


def _models(name: str, dtype: str = "float32", seed: int = 0):
    over = _over(name, dtype)
    cfg = registry.get_arch(name).reduced(**over)
    ref = RefModel(ref_registry.get_arch(name).reduced(**over))
    ref_params = ref.init_params(jax.random.PRNGKey(seed))
    params = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
    return cfg, Model(cfg, device="cpu"), params, ref, ref_params


def _batches(cfg, seq: int, dtype: str, seed: int = 5):
    """The same batch for both packages: tokens, labels (some masked with
    -1), and the stub frontends' embeddings, from numpy.  A VLM's labels
    cover its text only."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)
    labs[0, :7] = -1
    ref = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
    port = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labs).long()}
    extra = {}
    if cfg.family == "encdec":
        extra["enc_frames"] = rng.standard_normal((2, cfg.encoder_len, cfg.d_model))
    if cfg.frontend == "vision_patches":
        extra["frontend_embeds"] = rng.standard_normal((2, cfg.n_frontend_tokens, cfg.d_model))
    for key, arr in extra.items():
        arr = arr.astype(np.float32)
        ref[key] = jnp.asarray(arr).astype(jnp.dtype(dtype))
        port[key] = torch.from_numpy(arr).to(getattr(torch, dtype))
    return ref, port


def _seq(cfg) -> int:
    # above the reduced attention threshold (64); a multiple of ssm_chunk
    return 64 if cfg.family in ("ssm", "hybrid") else 96


@functools.lru_cache(maxsize=None)
def _loss_and_grads(name: str, dtype: str = "float32"):
    """``Model.loss`` and its gradients through both packages, as numpy:
    ``(port metrics, port grads, ref metrics, ref grads)``, the grads as
    ``[(path, array)]`` in JAX's leaf order."""
    cfg, model, params, ref, ref_params = _models(name, dtype)
    ref_b, port_b = _batches(cfg, _seq(cfg), dtype)
    (_, ref_m), ref_g = jax.value_and_grad(ref.loss, has_aux=True)(ref_params, ref_b)
    grads, metrics = value_and_grad(model, params, port_b)
    ref_flat = [("/".join(str(k.key) for k in path), leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(ref_g)[0]]
    return metrics, list(tree_paths(grads)), ref_m, ref_flat


def _close(got, want, rtol, atol=0.0):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol)


# -- Model.loss for every family ---------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_metrics_match_reference(name):
    metrics, _, ref_m, _ = _loss_and_grads(name)
    assert sorted(metrics) == sorted(ref_m) == ["accuracy", "aux", "ce", "loss", "tokens"]
    for key in ref_m:
        _close(metrics[key], ref_m[key], LOSS_RTOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_gradients_match_reference(name):
    _, grads, _, ref_grads = _loss_and_grads(name)
    assert [p for p, _ in grads] == [p for p, _ in ref_grads]
    for (path, g), (_, want) in zip(grads, ref_grads):
        assert g.dtype == torch.float32, path
        _close(g, want, GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "mamba2-130m", "zamba2-1.2b"])
def test_bf16_gradients_keep_each_leaf_type(name):
    """bf16 weights beside f32 leaves (the MoE router, the SSM's A_log, D
    and dt_bias): every gradient has its leaf's type, as in the
    reference, and is within BF16_GRAD_REL of the reference's."""
    _, grads, _, ref_grads = _loss_and_grads(name, "bfloat16")
    types = {str(g.dtype).removeprefix("torch.") for _, g in grads}
    assert types == {"float32", "bfloat16"}
    for (path, g), (_, want) in zip(grads, ref_grads):
        assert str(g.dtype).removeprefix("torch.") == str(want.dtype), path
        want = np.asarray(want, np.float32)
        err = np.linalg.norm(g.float().numpy() - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= BF16_GRAD_REL, (path, err)


# -- the losses ------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["yi-6b", "llava-next-34b"])
def test_loss_fn_matches_reference(name):
    """The full-logits loss (labels padded for a VLM's frontend)."""
    cfg, _, params, ref, ref_params = _models(name)
    ref_b, port_b = _batches(cfg, 40, "float32")
    loss, metrics = tf.loss_fn(cfg, params, port_b)
    ref_loss, ref_m = ref_tf.loss_fn(ref.cfg, ref_params, ref_b)
    _close(loss, ref_loss, LOSS_RTOL)
    for key in ref_m:
        _close(metrics[key], ref_m[key], LOSS_RTOL)


@pytest.mark.parametrize("seq,chunk", [(96, 32), (100, 32), (96, 512)])
def test_streaming_loss_matches_reference_in_chunks(seq, chunk):
    """Several chunks, a length the chunk does not divide (one chunk),
    and one chunk; the loss and the gradient of the hidden states."""
    cfg, _, params, ref, ref_params = _models("yi-6b")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    labels = rng.integers(-1, cfg.vocab_size, (2, seq)).astype(np.int32)
    aux = np.float32(0.25)

    def ref_fn(x):
        return ref_tf.streaming_lm_loss(ref.cfg, ref_params, x, jnp.asarray(labels),
                                        jnp.asarray(aux), chunk=chunk)

    (ref_loss, ref_m), ref_gx = jax.value_and_grad(ref_fn, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    loss, metrics = tf.streaming_lm_loss(cfg, params, xt, torch.from_numpy(labels).long(),
                                         torch.tensor(aux), chunk=chunk)
    (gx,) = torch.autograd.grad(loss, [xt])
    for key in ref_m:
        _close(metrics[key], ref_m[key], LOSS_RTOL)
    _close(gx, ref_gx, GRAD_RTOL, GRAD_ATOL)


# -- remat ----------------------------------------------------------------------------------


def test_remat_full_equals_none_and_dots_is_refused():
    """``full``, ``none`` and ``dots`` give one loss and the same gradients
    on the same inputs.  (The name is from when ``dots`` was refused; it
    is ported now, and held against the reference in
    ``tests/test_torch_remat.py``.)"""
    cfg, model, params, _, _ = _models("yi-6b")
    _, batch = _batches(cfg, 96, "float32")
    g_full, m_full = value_and_grad(model, params, batch)
    for remat in ("none", "dots"):
        other = Model(cfg.reduced(remat=remat, **_over("yi-6b")), device="cpu")
        g_other, m_other = value_and_grad(other, params, batch)
        assert float(m_full["loss"]) == float(m_other["loss"]), remat
        for a, b in zip(tree_leaves(g_full), tree_leaves(g_other)):
            _close(a, b, GRAD_RTOL, GRAD_ATOL)


def test_the_recompute_runs_under_its_launch_role():
    """A checkpointed body runs twice under autograd: once in the forward
    (role ``forward``) and once in the backward (role ``recompute``); the
    GEMM kernel's launches count under the role in force."""
    seen = []

    def body(x):
        seen.append(current_role())
        return (x * x).sum()

    x = torch.ones(3, requires_grad=True)
    tf._checkpointed(body)(x).backward()
    assert seen == ["forward", "recompute"]
    with torch.no_grad():
        tf._checkpointed(body)(x)
    assert seen[2:] == ["forward"]


# -- attention under autograd: flash has no backward -------------------------------------


def test_flash_refuses_operands_that_require_a_gradient():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 128, 2, 16)).astype(np.float32))
               for _ in range(3))
    with pytest.raises(ValueError, match="no backward"):
        fa.flash_attention(q.requires_grad_(), k, v, 64, 64)
    with torch.no_grad():  # nothing recorded: the kernel's plain version runs
        fa.flash_attention(q, k, v, 64, 64)


def test_attention_dispatch_runs_chunked_under_autograd():
    """Above the reduced threshold (64) a recorded attention counts as
    ``plain`` and runs the chunked path, whose gradients are the
    reference's (its training runs with flash off); without autograd the
    same call dispatches flash."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 128, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 128, 2, 16)).astype(np.float32) for _ in range(2))
    w = rng.standard_normal((2, 128, 4, 16)).astype(np.float32)
    ops.reset_dispatch_stats()
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = cm.attention_dispatch(qt, kt, vt, chunk_threshold=64)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [qt, kt, vt])
    assert ops.dispatch_stats()["flash"]["plain"] == 1
    assert ops.dispatch_stats()["flash"]["heuristic"] == 0

    def ref_fn(q, k, v):
        return jnp.sum(ref_cm.attention_dispatch(q, k, v, chunk_threshold=64) * w)

    ref_grads = jax.grad(ref_fn, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, want in zip(grads, ref_grads):
        _close(g, want, GRAD_RTOL, GRAD_ATOL)
    with torch.no_grad():
        cm.attention_dispatch(qt, kt, vt, chunk_threshold=64)
    assert ops.dispatch_stats()["flash"]["heuristic"] == 1


# -- the GEMM backward --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_backward_matches_the_reference_vjp(dtype):
    """dA = g Bᵀ and dB = Aᵀ g through the kernel (its plain version on
    the CPU), each in its operand's type, against the reference's
    ``custom_vjp`` through its Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(2)
    a, b, g = (rng.standard_normal(s).astype(np.float32) for s in ((64, 128), (128, 96), (64, 96)))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ja, jb, jg = (jnp.asarray(x).astype(jdt) for x in (a, b, g))
    ref_ops.set_kernel_policy(ref_ops.KernelPolicy(use_pallas=True, interpret=True))
    try:
        _, vjp = jax.vjp(lambda x, y: ref_ops.gemm(x, y), ja, jb)
        ref_da, ref_db = vjp(jg)
    finally:
        ref_ops.set_kernel_policy(ref_ops.KernelPolicy())
    ta, tb = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype).requires_grad_()
              for x in (ja, jb))
    tg = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(dtype)
    da, db = torch.autograd.grad(ops.gemm(ta, tb, device="cpu"), [ta, tb], tg)
    assert (da.dtype, db.dtype) == (dtype, dtype)
    assert str(ref_da.dtype) == str(dtype).removeprefix("torch.")
    _close(da, ref_da, GEMM_TOL[dtype], GEMM_TOL[dtype])
    _close(db, ref_db, GEMM_TOL[dtype], GEMM_TOL[dtype])


# -- the train step -------------------------------------------------------------------------


class _Capture:
    """An optimizer that keeps the clipped gradients it is given."""

    def update(self, grads, state, params):
        self.grads = grads
        return params, state


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_reference(grad_accum):
    """The clipped gradients (microbatches summed in f32, against the
    reference's ``lax.scan``), the metrics and ``grad_norm``."""
    cfg, model, params, ref, ref_params = _models("yi-6b")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    port_opt, ref_opt = _Capture(), _Capture()
    _, _, metrics = make_train_step(model, port_opt, grad_accum=grad_accum, clip_norm=0.5)(
        params, {}, {"tokens": torch.from_numpy(toks).long(),
                     "labels": torch.from_numpy(labs).long()})
    _, _, ref_m = ref_make_train_step(ref, ref_opt, grad_accum=grad_accum, clip_norm=0.5)(
        ref_params, {}, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)})
    assert sorted(metrics) == sorted(ref_m)
    for key in ref_m:
        _close(metrics[key], ref_m[key], LOSS_RTOL if key != "grad_norm" else GRAD_RTOL)
    ref_flat = jax.tree_util.tree_leaves(ref_opt.grads)
    for (path, g), want in zip(tree_paths(port_opt.grads), ref_flat):
        assert str(g.dtype).removeprefix("torch.") == str(want.dtype), path
        _close(g, want, GRAD_RTOL, GRAD_ATOL)


def test_prefill_and_decode_steps_call_the_model():
    cfg = registry.get_arch("yi-6b").reduced()
    model = Model(cfg, device="cpu")
    params = model.init_params(seed=0)
    toks = torch.arange(12).reshape(2, 6) % cfg.vocab_size
    logits, cache = make_prefill_step(model, 16)(params, {"tokens": toks})
    want, _ = model.prefill(params, {"tokens": toks}, 16)
    assert torch.equal(logits, want)
    step_logits, cache = make_decode_step(model)(params, cache, logits[:, -1:].argmax(-1))
    assert step_logits.shape == (2, 1, cfg.padded_vocab) and int(cache["len"]) == 7


# -- the Trainer ---------------------------------------------------------------------------


def _reference_loop(cfg, ref_params, steps, batch, seq, lr, warmup, seed):
    """The reference's Trainer loop from its parts that import: Model,
    make_optimizer, warmup_cosine, make_train_step and DataPipeline."""
    model = RefModel(cfg)
    opt = ref_make_optimizer(cfg.optimizer, ref_warmup_cosine(lr, warmup, steps))
    step_fn = jax.jit(ref_make_train_step(model, opt))
    pipe = RefPipeline(RefSynthetic(cfg.vocab_size, seq, seed=seed), batch)
    params, state, out = ref_params, opt.init(ref_params), []
    it = iter(pipe)
    for _ in range(steps):
        params, state, m = step_fn(params, state, next(it))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    pipe.stop()
    return out


@pytest.mark.parametrize("name", ["yi-6b", "qwen3-moe-235b-a22b"])
def test_five_trainer_steps_match_the_reference_loop(name, tmp_path):
    """yi-6b trains with AdamW, qwen3-moe with Adafactor (its config's)."""
    steps, batch, seq, lr, warmup = 5, 2, 96, 1e-2, 2
    cfg, _, params, ref, ref_params = _models(name)
    want = _reference_loop(ref.cfg, ref_params, steps, batch, seq, lr, warmup, seed=1)
    pipe = DataPipeline(SyntheticLM(cfg.vocab_size, seq, seed=1), batch)
    trainer = Trainer(cfg, pipe, str(tmp_path), lr=lr, warmup_steps=warmup,
                      total_steps=steps, ckpt_every=100, device="cpu")
    trainer.params = params
    trainer.opt_state = trainer.optimizer.init(params)
    log = trainer.train(steps)
    assert [r["step"] for r in log] == list(range(1, steps + 1))
    for rec, (loss, norm) in zip(log, want):
        _close(np.float32(rec["loss"]), loss, STEP_LOSS_RTOL)
        _close(np.float32(rec["grad_norm"]), norm, STEP_NORM_RTOL)


def _trainer(directory, steps_total, log_path=None):
    cfg = registry.get_arch("yi-6b").reduced()
    pipe = DataPipeline(SyntheticLM(cfg.vocab_size, 32, seed=3), 4)
    return Trainer(cfg, pipe, directory, lr=3e-3, warmup_steps=2, total_steps=steps_total,
                   ckpt_every=5, log_path=log_path, seed=7, device="cpu")


def test_trainer_resume_is_bit_identical(tmp_path):
    """Ten steps straight equal five, a new Trainer resumed from the
    step-5 checkpoint, and five more: the losses and every param and
    state leaf, bit for bit.  Each step appends one JSONL record."""
    straight = _trainer(str(tmp_path / "a"), 10, log_path=str(tmp_path / "a.jsonl"))
    want = straight.train(10)
    first = _trainer(str(tmp_path / "b"), 10)
    first.train(5)
    resumed = _trainer(str(tmp_path / "b"), 10)
    resumed.initialize(resume=True)
    assert resumed.step == 5 and resumed.pipeline.step == 5
    for a, b in zip(tree_leaves({"p": first.params, "o": first.opt_state}),
                    tree_leaves({"p": resumed.params, "o": resumed.opt_state})):
        assert torch.equal(a, b)
    got = resumed.train(10)
    assert [r["loss"] for r in got] == [r["loss"] for r in want[5:]]
    for a, b in zip(tree_leaves({"p": straight.params, "o": straight.opt_state}),
                    tree_leaves({"p": resumed.params, "o": resumed.opt_state})):
        assert torch.equal(a, b)
    with open(tmp_path / "a.jsonl") as f:
        assert len(f.readlines()) == 10


def test_trainer_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        Trainer(registry.get_arch("yi-6b").reduced(), None, None)


def test_train_cli_drops_the_loss(tmp_path):
    out = io.StringIO()
    args = ["--arch", "yi-6b", "--reduced", "--device", "cpu", "--steps", "30",
            "--batch", "8", "--seq", "64", "--lr", "3e-3", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "10"]
    with contextlib.redirect_stdout(out):
        train_cli.main(args)
    line = out.getvalue().strip().splitlines()[-1]
    fields = dict(f.split("=") for f in line.split()[3:])
    assert line.startswith("[train] yi-6b done: step=30")
    assert float(fields["loss"]) < float(fields["first_loss"]) - 0.5
    assert sorted(p.name for p in tmp_path.iterdir())[-1] == "step_00000030"
