"""The port's Mamba-2 with groups and its Nemotron-H pattern stack on the
CPU: the grouped SSD against the sequential recurrence and the
head-expanded scan, the gated norm against a loop over groups, prefill's
shapes (no head-expanded ``(…, h, n)`` operand), and a tiny Nemotron-H
(``M-*M-M*-``: d 64, 4 Mamba heads of 16 in 2 groups, state 16, chunk
16, float32) against the plain reference ``torch_reference_nemotron_h``:
full-forward logits, and a ragged prefill then decode through the cache
against the reference's one causal pass over each row's real tokens.

Tolerances: float32 2e-4, as the other CPU tests of the port hold it
against the JAX package: the port's chunked SSD, its grouped einsums and
its padded lengths sum in another order than the reference's listing.
Each planted fault this file catches (a lost SSM state write in decode,
pad tokens taken into the state, the gated norm over the whole width)
moves the logits by 1e-2 or more."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import torch_reference_nemotron_h as ref
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ssd
from repro_torch.models import mamba2 as mb
from repro_torch.models.api import Model
from repro_torch.models.transformer import layer

TOL = 2e-4
PATTERN = "M-*M-M*-"
#: the reference's configuration: the published config.json keys at a tiny size
CONFIG = dict(
    hidden_size=64, mamba_num_heads=4, mamba_head_dim=16, n_groups=2, ssm_state_size=16,
    conv_kernel=4, chunk_size=16, expand=1, intermediate_size=128, num_attention_heads=4,
    num_key_value_heads=2, attention_head_dim=16, hybrid_override_pattern=PATTERN,
    num_hidden_layers=len(PATTERN), rms_norm_eps=1e-5, vocab_size=256)


def tiny_config(**over) -> ArchConfig:
    """The port's record of :data:`CONFIG`."""
    fields = dict(
        name="nemotron-h-tiny", family="hybrid", n_layers=len(PATTERN), d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16, norm_eps=1e-5,
        mlp_kind="squared_relu", pos_embed="none", ssm_state=16, ssm_head_dim=16,
        ssm_expand=1, ssm_conv_width=4, ssm_chunk=16, ssm_n_groups=2,
        layer_pattern=PATTERN, vocab_pad_multiple=64, param_dtype="float32",
        compute_dtype="float32", attn_chunk_threshold=64)
    fields.update(over)
    return ArchConfig(**fields)


def tiny_model(seed: int = 0):
    """The tiny model and its weights: the port's init, with every norm
    scale, ``D`` and conv bias moved off 1 and 0, so that one left out
    shows."""
    cfg = tiny_config()
    model = Model(cfg, device="cpu")
    params = model.init_params(seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    for kind in ("mamba", "mlp", "attn"):
        ln = params[kind]["ln"]["scale"]
        ln.add_(0.1 * torch.randn(ln.shape, generator=gen))
    for leaf in (params["ln_f"]["scale"], params["mamba"]["norm"]["scale"],
                 params["mamba"]["D"], params["mamba"]["conv_b"]):
        leaf.add_(0.1 * torch.randn(leaf.shape, generator=gen))
    return cfg, model, params


def _close(got: torch.Tensor, want: torch.Tensor):
    np.testing.assert_allclose(got.detach().float().numpy(), want.float().numpy(),
                               rtol=TOL, atol=TOL)


# -- the grouped SSD and the gated norm ----------------------------------------------


def _ssd_args(b, l, h, p, g, n, seed=3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, l, h, p)).astype(np.float32))
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((b, l, h)) - 2)).astype(
        np.float32))
    A = -torch.from_numpy(np.exp(rng.uniform(0.0, np.log(16.0), h)).astype(np.float32))
    B, C = (torch.from_numpy(rng.standard_normal((b, l, g, n)).astype(np.float32))
            for _ in range(2))
    return x, dt, A, B, C


@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_ssd_matches_the_recurrence(groups):
    """B and C by group: the chunked scan (its outputs and final state)
    equals the sequential recurrence and the head-expanded scan, head
    ``k`` reading group ``k // (h / g)``."""
    x, dt, A, B, C = _ssd_args(2, 48, 8, 6, groups, 5)
    wide = [t.repeat_interleave(8 // groups, dim=2) for t in (B, C)]
    y, state = mb.ssd_chunked(x, dt, A, B, C, chunk=16, return_state=True)
    _close(y, mb.ssd_reference(x, dt, A, *wide))
    y_wide, state_wide = mb.ssd_chunked(x, dt, A, *wide, chunk=16, return_state=True)
    _close(y, y_wide)
    _close(state, state_wide)
    # the state after the last position is the recurrence's
    want = torch.zeros(2, 8, 6, 5)
    for t in range(48):
        want = want * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bhn,bhp,bh->bhpn", wide[0][:, t], x[:, t], dt[:, t])
    _close(state, want)


def test_ssd_row_blocks_and_a_ragged_tail_change_nothing(monkeypatch):
    """A batch run in blocks of rows gives the one pass's outputs; a
    length the chunk does not divide (padded with dt = 0) gives the
    recurrence's outputs and final state."""
    x, dt, A, B, C = _ssd_args(3, 40, 4, 6, 2, 5)
    y, state = mb.ssd_chunked(x, dt, A, B, C, chunk=16, return_state=True)
    monkeypatch.setattr(ssd, "_SSD_BLOCK_BYTES", 1)
    y_rows, state_rows = mb.ssd_chunked(x, dt, A, B, C, chunk=16, return_state=True)
    _close(y_rows, y)
    _close(state_rows, state)
    wide = [t.repeat_interleave(2, dim=2) for t in (B, C)]
    _close(y, mb.ssd_reference(x, dt, A, *wide))
    y_short, state_short = mb.ssd_chunked(x[:, :37], dt[:, :37], A, B[:, :37], C[:, :37],
                                          chunk=16, return_state=True)
    _close(y_short, y[:, :37])
    _, state_37 = mb.ssd_chunked(x[:, :37], dt[:, :37], A, B[:, :37], C[:, :37],
                                 chunk=37, return_state=True)
    _close(state_short, state_37)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_gated_norm_is_per_group(groups):
    rng = np.random.default_rng(groups)
    y, z = (torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(np.float32))
            for _ in range(2))
    scale = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    got = mb.gated_rmsnorm({"scale": scale}, y, z, groups, 1e-5)
    gated = y * torch.nn.functional.silu(z)
    want = torch.empty_like(gated)
    w = 32 // groups
    for k in range(groups):
        part = gated[..., k * w:(k + 1) * w]
        want[..., k * w:(k + 1) * w] = part * torch.rsqrt(
            (part * part).mean(-1, keepdim=True) + 1e-5)
    _close(got, want * scale)


class _Shapes(TorchDispatchMode):
    """Every floating output's shape of the ops run under it."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                self.shapes.append(tuple(t.shape))
        return out


def test_prefill_forms_no_head_expanded_b_or_c():
    """A Mamba-2 prefill with 8 heads in 2 groups, state 12, head dim 6:
    no tensor of its ops ends in (heads, state), nor in (heads a group,
    state), as B or C taken to every head would; the chunk states end in
    (head dim, state)."""
    cfg = tiny_config(d_model=48, ssm_expand=1, ssm_head_dim=6, ssm_state=12,
                      ssm_n_groups=2, n_layers=1, layer_pattern="M")
    h, n, r = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_heads // cfg.ssm_n_groups
    assert (h, n, r, cfg.ssm_head_dim) == (8, 12, 4, 6)
    params = Model(cfg, device="cpu").init_params(seed=0)
    x = torch.randn(2, 32, cfg.d_model)
    with _Shapes() as seen:
        mb.mamba_block_prefill(cfg, layer(params["mamba"], 0), x, torch.tensor([32, 19]))
    assert seen.shapes
    assert not [s for s in seen.shapes if s[-2:] in ((h, n), (r, n))]
    assert any(s[-2:] == (cfg.ssm_head_dim, n) for s in seen.shapes)


# -- the pattern stack against the plain reference ------------------------------------


def test_pattern_config_counts_layers_by_kind():
    cfg = tiny_config()
    assert cfg.layer_counts() == {"M": 3, "-": 3, "*": 2}
    d, di, f = 64, 64, 128
    conv_ch = di + 2 * 2 * 16
    mamba = d + d * (2 * di + 2 * 2 * 16 + 4) + 5 * conv_ch + 3 * 4 + di + di * d
    mlp, attn = d + 2 * d * f, d + d * (4 + 2 * 2) * 16 + 4 * 16 * d
    params = Model(cfg, device="cpu").init_params(seed=0)
    n_leaf = sum(t.numel() for t in _leaves(params))
    assert cfg.n_params() == n_leaf == 2 * 256 * d + d + 3 * mamba + 3 * mlp + 2 * attn
    kinds = [w[3] for w in cfg.gemm_workloads(2, 16)]
    assert kinds == ["ssm_in", "ssm_out", "ffn_in", "ffn_out", "qkv", "attn_out", "lm_head"]
    assert cfg.gemm_workloads(2, 16)[0] == (32, 64, 2 * 64 + 2 * 2 * 16 + 4, "ssm_in")
    small = cfg.reduced()
    assert small.layer_pattern == PATTERN and small.n_layers == 8
    with pytest.raises(ValueError, match="layer_pattern"):
        tiny_config(layer_pattern="M-x")
    with pytest.raises(ValueError, match="layer_pattern"):
        tiny_config(n_layers=7)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def test_full_forward_logits_match_the_reference():
    cfg, model, params = tiny_model()
    toks = torch.randint(0, 256, (2, 40), generator=torch.Generator().manual_seed(5))
    logits, aux = model.logits(params, {"tokens": toks})
    assert float(aux) == 0.0
    for row in range(2):
        _close(logits[row, :, :256], ref.logits(CONFIG, params, toks[row]))


def test_ragged_prefill_and_decode_match_one_causal_pass():
    """Rows of 37, 20 and 29 tokens right-padded to 48, then 5 decode
    steps through the cache (the pad K/V masked, as the engine sets the
    cache's lengths): at each step, the logits of the reference's pass
    over the row's real tokens and the tokens fed."""
    cfg, model, params = tiny_model(seed=1)
    gen = torch.Generator().manual_seed(7)
    lens = torch.tensor([37, 20, 29])
    toks = torch.randint(1, 256, (3, 48), generator=gen)
    fed = torch.randint(0, 256, (3, 5), generator=gen)
    logits, cache = model.prefill(params, {"tokens": toks}, 64, last_idx=lens - 1)
    cache.update(valid_len=lens.clone(), prefill_len=torch.tensor(48))
    steps = [logits[:, 0]]
    for j in range(5):
        logits, cache = model.decode_step(params, cache, fed[:, j:j + 1])
        steps.append(logits[:, 0])
    got = torch.stack(steps, 1)[..., :256]  # (rows, 6, vocab)
    for row, n in enumerate(lens.tolist()):
        want = ref.logits(CONFIG, params, torch.cat([toks[row, :n], fed[row]]))
        _close(got[row], want[n - 1:])


def test_pattern_stack_spans_nest_under_their_layers():
    """Under the profiler a prefill shows each Mamba layer's ``block.mamba``
    (with its index) over ``mamba.conv``, ``mamba.ssd`` and ``mamba.gate``,
    and the MLP and attention layers' ``block.mlp`` and ``block.attn``."""
    cfg, model, params = tiny_model()
    toks = torch.randint(0, 256, (1, 32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.prefill(params, {"tokens": toks}, 40, last_idx=torch.tensor([20]))
    ranges = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events() if e.is_user_annotation()),
                    key=lambda r: (r[1], -r[2]))
    names = [r[0] for r in ranges]
    assert names.count("block.mamba") == 3 and names.count("mamba.ssd") == 3
    assert names.count("block.mlp") == 3 and names.count("block.attn") == 2
    assert names.count("block.norm") == 8
    assert {"model.embed", "model.head"} <= set(names)
    for outer in (r for r in ranges if r[0] == "block.mamba"):
        inner = [r[0] for r in ranges if outer[1] <= r[1] and r[2] <= outer[2]]
        assert {"mamba.conv", "mamba.ssd", "mamba.gate"} <= set(inner)
    assert not any("gemm_tiled" in n or "flash_fwd" in n for n in names)
