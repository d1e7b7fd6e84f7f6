"""Remat ``dots`` against the JAX package's, and the GEMM operator it rests on.

``dots`` runs each block under a checkpoint whose forward keeps the 2-D
products its backward reads (the ``repro_torch::gemm`` operator's outputs
and the MoE router's f32 product, but not the block's closing product,
which feeds only the residual add) and whose recompute takes them back
in place of running the products; everything else is recomputed, as
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` saves the
``dot_general`` outputs without batch dimensions that the backward
reads.  Held here, on the CPU:

- loss and gradients of the five families under ``dots`` against the
  reference's ``value_and_grad`` under ``dots`` (its Pallas GEMM off, its
  default), at the training limits of ``tests/test_torch_train.py``:
  loss rtol 1e-5, f32 gradients rtol 1e-4 / atol 1e-6;
- what is saved: the products each block of the six families keeps
  (dense, MoE, encoder-decoder, VLM, SSM, hybrid), as a multiset of
  shapes and types, against the residuals
  ``jax.ad_checkpoint.print_saved_residuals`` lists for the reference's
  block, and with the reference's Pallas GEMM on, which its policy does
  not see (it saves none of its products);
- the closing product's placeholder: NaN in the recompute, and the
  ``dots`` gradients equal ``full``'s all the same, so nothing reads it;
- what is recomputed (the GEMM kernel's work reports, which a kept
  product does not make): no GEMM in the recompute under ``dots``, each
  block product once under ``full``, attention's batched products under
  both;
- ``torch.library.opcheck`` on ``repro_torch::gemm`` (the tiled kernel's
  plain version, the padded bf16 decode product, ``torch.matmul``);
- the dry run of a ``dots`` step: its meta trace counts what the CPU run
  counts, each GEMM call once.

MoE configs run at ``moe_capacity_factor`` = E / k, a capacity that drops
nothing (the reference's drop gap, ROADMAP.md)."""

import collections
import contextlib
import io
import math
import re

import jax
import jax.ad_checkpoint
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.kernels import ops as ref_ops
from repro.models import transformer as ref_tf
from repro.models.api import Model as RefModel
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import ops
from repro_torch.kernels.ledger import current_role, launches, reset_launches
from repro_torch.launch import dryrun
from repro_torch.models import transformer as tf
from repro_torch.models.api import Model
from repro_torch.models.transformer import params_from_reference
from repro_torch.train.step import value_and_grad
from repro_torch.utils.op_costs import OpCounter
from repro_torch.utils.tree import tree_from_numpy, tree_paths

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
FAMILIES = ["yi-6b", "qwen3-moe-235b-a22b", "whisper-tiny", "mamba2-130m", "zamba2-1.2b"]
#: one arch of each family: dense, MoE, encoder-decoder, VLM, SSM, hybrid
EVERY_FAMILY = ["yi-6b", "qwen3-moe-235b-a22b", "whisper-tiny", "llava-next-34b",
                "mamba2-130m", "zamba2-1.2b"]
FRONTEND_LEN = 16  # the VLM's precomputed frontend embeddings a sequence
GEMM = torch.ops.repro_torch.gemm.default  # the operator opcheck takes
BATCHED = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads while these model steps run: the suite runs
    files side by side, and some of them time process lanes."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _over(name: str, remat: str = "dots") -> dict:
    arch = registry.get_arch(name)
    over = {"remat": remat}
    if arch.family == "moe":
        over["moe_capacity_factor"] = arch.n_experts / arch.experts_per_token
    return over


def _models(name: str, remat: str = "dots"):
    over = _over(name, remat)
    cfg = registry.get_arch(name).reduced(**over)
    ref = RefModel(ref_registry.get_arch(name).reduced(**over))
    ref_params = ref.init_params(jax.random.PRNGKey(0))
    params = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
    return cfg, Model(cfg, device="cpu"), params, ref, ref_params


def _batch(cfg, seed: int = 5, frontend: bool = False):
    """Tokens and labels (some masked), and whisper's encoder frames (and,
    with ``frontend``, a VLM's frontend embeddings), the same for both
    packages."""
    seq = 64 if cfg.family in ("ssm", "hybrid") else 96  # above the threshold (64)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)
    labs[0, :7] = -1
    ref = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
    port = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labs).long()}
    if cfg.family == "encdec":
        frames = rng.standard_normal((2, cfg.encoder_len, cfg.d_model)).astype(np.float32)
        ref["enc_frames"], port["enc_frames"] = jnp.asarray(frames), torch.from_numpy(frames)
    if frontend and cfg.family == "vlm":
        emb = rng.standard_normal((2, FRONTEND_LEN, cfg.d_model)).astype(np.float32)
        ref["frontend_embeds"], port["frontend_embeds"] = jnp.asarray(emb), torch.from_numpy(emb)
    return ref, port


def _close(got, want, rtol, atol=0.0):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


class _Products(OpCounter):
    """An op counter that also keeps, by the GEMM launch role in force
    (``forward``, ``recompute``, ``dA``, ``dB``), the GEMM kernel's work
    reports (its dims) and the batched products dispatched (their result
    shapes), in order."""

    def __init__(self):
        super().__init__()
        self.order = collections.defaultdict(list)

    def add_kernel(self, kind, dims, flops, nbytes, out):
        if kind == "gemm":
            self.order[current_role()].append(("gemm", dims))
        super().add_kernel(kind, dims, flops, nbytes, out)

    def _count(self, func, args, kwargs, ins, out):
        if func in BATCHED:
            self.order[current_role()].append(("batched", tuple(out.shape)))
        super()._count(func, args, kwargs, ins, out)

    def count(self, role, what, exclude_n=None) -> int:
        return sum(1 for w, dims in self.order[role] if w == what and dims[-1] != exclude_n)


# -- loss and gradients against the reference's dots --------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_dots_matches_the_reference_dots(name):
    cfg, model, params, ref, ref_params = _models(name)
    assert cfg.remat == ref.cfg.remat == "dots"
    ref_b, port_b = _batch(cfg)
    (_, ref_m), ref_g = jax.value_and_grad(ref.loss, has_aux=True)(ref_params, ref_b)
    grads, metrics = value_and_grad(model, params, port_b)
    for key in ref_m:
        _close(metrics[key], ref_m[key], LOSS_RTOL)
    ref_flat = [("/".join(str(k.key) for k in path), leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(ref_g)[0]]
    got = list(tree_paths(grads))
    assert [p for p, _ in got] == [p for p, _ in ref_flat]
    for (path, g), (_, want) in zip(got, ref_flat):
        assert g.dtype == torch.float32, path
        _close(g, want, GRAD_RTOL, GRAD_ATOL)


# -- what is saved, what is recomputed ------------------------------------------------


_JAX_TYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _reference_residuals(body, params, x, pallas: bool = False) -> list[tuple]:
    """``(shape, dtype)`` of what the reference's block ``body`` (under
    ``dots``) keeps for its backward, less its arguments and constants.  A
    residual stacked by a layer scan (a hybrid group's SSM layers) counts
    as one product a layer."""
    if pallas:
        ref_ops.set_kernel_policy(ref_ops.KernelPolicy(use_pallas=True, interpret=True))
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            jax.ad_checkpoint.print_saved_residuals(lambda p, x: body(p, x).sum(), params, x)
    finally:
        ref_ops.set_kernel_policy(ref_ops.KernelPolicy())
    kept = []
    for line in out.getvalue().splitlines():
        if "from the argument" in line or "from a constant" in line:
            continue
        dtype, dims = re.match(r"(\w+)\[([\d,]*)\]", line).groups()
        shape = tuple(int(d) for d in dims.split(",") if d)
        kept += [(shape[-2:], _JAX_TYPES[dtype])] * math.prod(shape[:-2])
    return kept


def _reference_blocks(name: str, cfg, ref_params, seq: int) -> list[list[tuple]]:
    """What each remat block of the reference's model keeps under ``dots``,
    in the order the port runs its blocks: whisper's encoder blocks, then
    its decoder blocks (cross attention over the encoder's output); a
    hybrid's groups (their SSM layers and the shared block); the layers
    of the others.  Each block of a kind is the same function of the same
    shapes, so the first layer's parameters stand for every layer's."""
    from repro.models import hybrid as ref_hy
    from repro.models import mamba2 as ref_mb

    def first(tree):
        return jax.tree_util.tree_map(lambda t: t[0], tree)

    dt = jnp.dtype(cfg.compute_dtype)
    x = jnp.zeros((2, seq, cfg.d_model), dt)
    pos = jnp.arange(seq)[None]
    if cfg.family == "ssm":
        body = ref_mb._remat_wrap(cfg, lambda p, x: ref_mb.mamba_block_apply(cfg, p, x))
        return [_reference_residuals(body, first(ref_params["layers"]), x)] * cfg.n_layers
    if cfg.family == "hybrid":
        i, n_groups, _ = ref_hy._split(cfg)

        def group(gp, x):
            x = ref_hy._run_group_stack(cfg, gp, x, i)
            return ref_tf.block_apply(cfg, ref_params["shared_attn"], x, pos, moe=False)[0]

        body = jax.checkpoint(
            group, policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
        return [_reference_residuals(body, first(ref_params["groups"]), x)] * n_groups
    blocks = []
    enc_out = None
    if cfg.family == "encdec":
        xe = jnp.zeros((2, cfg.encoder_len, cfg.d_model), dt)
        body = ref_tf._remat(cfg, lambda p, x: ref_tf.block_apply(
            cfg, p, x, jnp.arange(cfg.encoder_len)[None], moe=False, causal=False)[0])
        blocks += [_reference_residuals(body, first(ref_params["encoder"]["layers"]), xe)
                   ] * cfg.n_encoder_layers
        enc_out = xe
    body = ref_tf._remat(cfg, lambda p, x: ref_tf.block_apply(
        cfg, p, x, pos, moe=cfg.family == "moe", enc_out=enc_out)[0])
    return blocks + [_reference_residuals(body, first(ref_params["layers"]), x)] * cfg.n_layers


def _kept_and_grads(name: str, remat: str):
    """One port train step (``value_and_grad``) of the reduced ``name``
    under ``remat``: the blocks' :class:`ops.KeptBlock` records, the
    gradients, the placeholders the recompute took, and the models."""
    cfg, model, params, ref, ref_params = _models(name, remat)
    _, batch = _batch(cfg, frontend=True)
    handed = []
    replayed = ops._replayed

    def recording(store, m, n, device):  # the same call, its result noted
        out = replayed(store, m, n, device)
        if out.stride() == (0, 0):
            handed.append(out)
        return out

    with ops.watch_kept() as seen, pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "_replayed", recording)
        grads, _ = value_and_grad(model, params, batch)
    return cfg, ref, ref_params, batch, seen, dict(tree_paths(grads)), handed


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_saved_products_are_the_references_residuals(remat):
    """One reduced yi-6b block (2 x 96 tokens, chunked attention).  Under
    ``dots`` the block keeps the reference's six saved ``dot_general``
    outputs (2-D, as its ``gemm`` flattens the leading dims): wq, wk, wv,
    wo, gate and up.  Its seventh product, the MLP's down product, feeds
    only the residual add, so JAX's backward reads nothing of it: the
    port does not keep it, and its recompute computes none of the seven.
    Attention's batched products are recomputed.  Under ``full`` every
    product runs again and nothing is kept.  With its Pallas GEMM on, the
    reference's ``dots`` keeps none of its products (a ``pallas_call`` is
    not a ``dot_general``): the gap ROADMAP.md lists."""
    cfg, _, params, ref, ref_params = _models("yi-6b", remat)
    x = np.random.default_rng(1).standard_normal((2, 96, cfg.d_model)).astype(np.float32)
    layer = jax.tree_util.tree_map(lambda t: t[0], ref_params["layers"])
    port_layer = tree_from_numpy(jax.tree_util.tree_map(np.asarray, layer), "cpu")
    xt = torch.from_numpy(x).requires_grad_()
    pos = torch.arange(96)[None]
    body = tf._remat(cfg, lambda p, x: tf.block_apply(cfg, p, x, pos, moe=False)[0])
    with _Products() as first, ops.watch_kept() as seen:
        y = body(port_layer, xt).sum()
    with _Products() as backward:
        y.backward()
    forward = collections.Counter(first.order["forward"])
    again = collections.Counter(backward.order["recompute"])
    products = [dims for what, dims in first.order["forward"] if what == "gemm"]
    batched = {k: n for k, n in forward.items() if k[0] == "batched"}
    assert batched and all(again[k] == n for k, n in batched.items())
    if remat == "full":
        assert again == forward  # everything runs again
        assert seen == []
        return
    assert not any(what == "gemm" for what, _ in again)
    assert len(products) == 7 and products[-1] == (192, cfg.d_ff, cfg.d_model)
    (block,) = seen
    down = ((192, cfg.d_model), torch.float32)
    assert block.unread == down and block.placeholder_handed
    want = _reference_residuals(ref_tf._remat(ref.cfg, lambda p, x: ref_tf.block_apply(
        ref.cfg, p, x, jnp.arange(96)[None], moe=False)[0]), layer, jnp.asarray(x))
    assert sorted(block.kept) == sorted(want) == sorted(
        ((m, n), torch.float32) for m, _, n in products[:-1])
    assert all(len(s) == 2 for s, _ in want) and len(want) == 6
    assert _reference_residuals(ref_tf._remat(ref.cfg, lambda p, x: ref_tf.block_apply(
        ref.cfg, p, x, jnp.arange(96)[None], moe=False)[0]), layer, jnp.asarray(x),
        pallas=True) == []


@pytest.mark.parametrize("name", EVERY_FAMILY)
def test_every_familys_dots_blocks_keep_the_references_products(name):
    """A train step of each family's reduced model under ``dots``: every
    block keeps, as a multiset of shapes and types, what the reference's
    block keeps (``print_saved_residuals``, less arguments and
    constants).  The dense and VLM blocks keep six products; the MoE
    block attention's four and the router's f32 logits (its experts'
    products have a batch dim); whisper's encoder block five, its decoder
    block nine (with cross attention's four); an SSM block its input
    projection; a hybrid group its SSM layers' input and output
    projections and the shared block's six.  The closing product (the
    MLP's down product, an SSM block's output projection), which feeds
    only the residual add, is the one left out where the block has one,
    and its recompute took the placeholder in its place."""
    cfg, ref, ref_params, batch, seen, _, _ = _kept_and_grads(name, "dots")
    seq = batch["tokens"].shape[1] + (FRONTEND_LEN if cfg.family == "vlm" else 0)
    want = _reference_blocks(name, ref.cfg, ref_params, seq)
    assert len(seen) == len(want) > 0
    for block, kept in zip(seen, want):
        assert collections.Counter(block.kept) == collections.Counter(kept)
        assert block.placeholder_handed == (block.unread is not None)
        assert (block.unread is None) == (cfg.family == "moe")


@pytest.mark.parametrize("name", EVERY_FAMILY)
def test_dots_gradients_equal_fulls_with_a_nan_placeholder(name):
    """The closing product's placeholder in the recompute is NaN, and the
    ``dots`` gradients equal ``full``'s all the same (finite, at the
    training limits): nothing the backward reads comes from it.  The MoE
    router's kept product, whose backward is its own, too."""
    cfg, _, _, _, seen, dots, handed = _kept_and_grads(name, "dots")
    full = _kept_and_grads(name, "full")[5]
    assert len(handed) == sum(b.unread is not None for b in seen)
    assert handed or cfg.family == "moe"
    assert all(torch.isnan(t).all() for t in handed)
    assert list(dots) == list(full)
    for path, g in full.items():
        assert torch.isfinite(dots[path]).all(), path
        _close(dots[path], g.numpy(), GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("name", ["yi-6b", "mamba2-130m", "zamba2-1.2b"])
def test_the_recompute_runs_no_saved_product(name):
    """A train step's backward: under ``full`` the recompute runs the GEMM
    operator once per block product (every forward call but the loss
    head's, whose chunks are checkpointed under both), under ``dots`` not
    at all; the dA and dB products are the same under both, and the
    batched products (attention's, the SSD scan's) run again under both.
    On the CPU nothing launches."""
    counts = {}
    for remat in ("full", "dots"):
        cfg, model, params, _, _ = _models(name, remat)
        _, batch = _batch(cfg)
        reset_launches()
        with _Products() as seen:
            value_and_grad(model, params, batch)
        assert not launches("gemm") and not launches("gemm", "role", "dims")
        head = cfg.padded_vocab
        counts[remat] = {
            "forward": seen.count("forward", "gemm", exclude_n=head),
            "recompute": seen.count("recompute", "gemm", exclude_n=head),
            "backward": (seen.count("dA", "gemm"), seen.count("dB", "gemm")),
            "batched": seen.count("recompute", "batched"),
        }
    full, dots = counts["full"], counts["dots"]
    assert full["recompute"] == full["forward"] > 0
    assert dots["recompute"] == 0 and dots["forward"] == full["forward"]
    assert dots["backward"] == full["backward"]
    assert dots["batched"] == full["batched"] > 0


# -- the SSD's gradients at the published chunk ---------------------------------------


def test_ssd_gradients_are_finite_at_the_published_chunk():
    """At the chunk every published SSM config uses (256), the intra-chunk
    decay ``exp(seg)`` overflows above the diagonal.  The port masks
    before the exponential: its chunked scan has the reference's outputs
    and the sequential recurrence's gradients; the reference masks after
    it, and its gradients are NaN (the gap ROADMAP.md lists)."""
    from repro.models import mamba2 as ref_mb
    from repro_torch.models import mamba2 as mb

    rng = np.random.default_rng(4)
    b, seq, h, p, n = 1, 512, 2, 8, 4
    x = rng.standard_normal((b, seq, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, seq, h)))).astype(np.float32)
    a = -np.exp(rng.uniform(0.0, np.log(16.0), h)).astype(np.float32)
    bm, cm_ = (rng.standard_normal((b, seq, h, n)).astype(np.float32) for _ in range(2))
    w = rng.standard_normal((b, seq, h, p)).astype(np.float32)
    args = [torch.from_numpy(t).requires_grad_() for t in (x, dt, a, bm, cm_)]
    y = mb.ssd_chunked(*args, chunk=256)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(), args)
    args2 = [t.detach().clone().requires_grad_() for t in args]
    want = torch.autograd.grad((mb.ssd_reference(*args2) * torch.from_numpy(w)).sum(), args2)
    for g, gw in zip(grads, want):
        assert torch.isfinite(g).all()
        _close(g, gw.numpy(), 1e-3, 1e-4)
    jargs = [jnp.asarray(t) for t in (x, dt, a, bm, cm_)]
    _close(y, ref_mb.ssd_chunked(*jargs, chunk=256), 2e-4, 2e-4)
    ref_grads = jax.grad(lambda *t: jnp.sum(ref_mb.ssd_chunked(*t, chunk=256) * w),
                         argnums=(0, 1, 2, 3, 4))(*jargs)
    assert not all(bool(jnp.isfinite(g).all()) for g in ref_grads)


def test_ssm_model_gradients_at_the_published_chunk_are_the_small_chunks():
    """The reduced mamba2 at chunk 256 (256 tokens): finite gradients,
    equal to the same model's at the reduced chunk (16), where the
    reference's are finite and held in ``test_dots_matches_the_reference_dots``."""
    got = {}
    for chunk in (16, 256):
        cfg = registry.get_arch("mamba2-130m").reduced(ssm_chunk=chunk, remat="dots")
        model = Model(cfg, device="cpu")
        params = model.init_params(seed=1)
        rng = np.random.default_rng(2)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256))).long(),
                 "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256))).long()}
        grads, metrics = value_and_grad(model, params, batch)
        got[chunk] = (float(metrics["loss"]), list(tree_paths(grads)))
    (loss16, g16), (loss256, g256) = got[16], got[256]
    _close(np.float32(loss256), loss16, LOSS_RTOL)
    for (path, a), (_, b) in zip(g256, g16):
        assert torch.isfinite(a).all(), path
        _close(a, b.numpy(), GRAD_RTOL, GRAD_ATOL)


# -- the operator --------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n,dtype,config", [
    (64, 64, 32, torch.float32, None),           # the tiled kernel's plain version
    (64, 64, 32, torch.float32, [32, 16, 32, 0, 0, 4, 4]),  # an explicit config
    (128, 64, 64, torch.bfloat16, None),         # wgmma's tile
    (3, 64, 32, torch.bfloat16, None),           # 3 rows padded to the 8-row block
    (64, 24, 32, torch.bfloat16, None),          # K = 8 (mod 16): torch.matmul
    (5, 7, 3, torch.float32, None),              # no config divides: torch.matmul
])
def test_gemm_operator_passes_opcheck(m, k, n, dtype, config):
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(dtype)
    for grad in (False, True):
        args = (a.clone().requires_grad_(grad), b.clone().requires_grad_(grad), config)
        result = torch.library.opcheck(GEMM, args)
        assert set(result.values()) == {"SUCCESS"}, result


def test_dots_step_counts_on_meta_equal_the_cpu_run():
    """A 2-layer reduced yi-6b train step under ``dots`` traced on meta
    counts what it counts on the CPU; the GEMM's FLOPs are each call's
    2·M·K·N once, and are ``full``'s less one forward of every block
    product (the recompute ``dots`` does not run)."""
    shape = ShapeSpec("train", 128, 2, "train")
    got = {}
    for remat in ("full", "dots"):
        cfg = registry.get_arch("yi-6b").reduced(n_layers=2, remat=remat)
        for device in ("meta", "cpu"):
            c = dryrun.count_step(dryrun.make_cell(cfg, shape, device)["run"])
            got[remat, device] = (c.flops, c.bytes, c.by_kind, dict(c.kernel_launches),
                                  c.peak_bytes)
    assert got["dots", "meta"] == got["dots", "cpu"]
    assert got["full", "meta"] == got["full", "cpu"]
    flops, _, by_kind, launches, _ = got["dots", "cpu"]
    gemm_flops = by_kind["gemm_kernel"]["flops"]
    assert gemm_flops == sum(c * 2 * m * k * n for (_, (m, k, n)), c in launches.items())
    full_launches = collections.Counter(got["full", "cpu"][3])
    extra = full_launches - collections.Counter(launches)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q, kv, ff, tok = cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.d_ff, 2 * 128
    want = collections.Counter()
    for dims in ((tok, d, q), (tok, d, kv), (tok, d, kv), (tok, q, d), (tok, d, ff),
                 (tok, d, ff), (tok, ff, d)):
        want[("gemm", dims)] += cfg.n_layers
    assert extra == want
    assert got["full", "cpu"][2]["gemm_kernel"]["flops"] - gemm_flops == sum(
        c * 2 * m * k * n for (_, (m, k, n)), c in want.items())
