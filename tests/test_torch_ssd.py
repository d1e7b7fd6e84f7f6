"""The Mamba-2 SSD's chunked-scan kernel on the CPU: the precision its
TF32 split keeps, emulated in plain PyTorch, and the wrapper's routing
(the plain version for CPU tensors, refusals, the shapes it takes).  The
kernel itself runs only on the card (``tests/test_torch_card.py``).

The split: every operand the kernel forms in f32 (the dt-scaled scores,
x scaled by dt and its decay, the entering state) enters its ``wgmma`` as
two TF32 parts, ``hi`` the value with its low 13 mantissa bits cleared and
``lo`` the remainder so cleared.  At Nemotron-H-47B's widths that must
keep the plain f32 path's accuracy against the sequential recurrence
(within twice its largest error, and within ``TOL``, the port's f32 limit
against its references), where bf16 operands would lose it (ten times
the f32 path's error or more)."""

import functools

import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.kernels import ops, ssd
from repro_torch.kernels.ledger import launches, note_launch, reset_launches
from repro_torch.models import mamba2 as mb

TOL = 2e-4
#: Nemotron-H-47B's SSD widths (its published config's mamba_num_heads,
#: n_groups, mamba_head_dim, ssm_state_size and chunk_size)
NEMOTRON = dict(h=256, g=8, p=64, n=256, q=128)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its low 13 mantissa bits cleared: what the tensor cores
    read of an f32 value given as TF32."""
    return (t.contiguous().view(torch.int32) & -(1 << 13)).view(torch.float32)


def _split(t: torch.Tensor) -> torch.Tensor:
    """The value the two TF32 parts of ``t`` carry into one accumulator."""
    hi = _tf32(t)
    return hi + _tf32(t - hi)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _ssd_args(b, l, h, g, p, n, seed=0):
    """bf16 x, B, C (the served types), dt in the published init's range and
    A in [-16, -1] at about five standard deviations, as the cell draws them."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, l, h, p, generator=gen).bfloat16()
    B = torch.randn(b, l, g, n, generator=gen).bfloat16()
    C = torch.randn(b, l, g, n, generator=gen).bfloat16()
    dt = torch.nn.functional.softplus(torch.randn(b, l, h, generator=gen) * 0.465 - 4.579)
    A = -torch.exp(torch.log(torch.tensor(4.0)) + 0.277 * torch.randn(h, generator=gen))
    return x, dt, A, B, C


@functools.lru_cache(maxsize=1)
def _errors_at_nemotron_widths() -> dict:
    """Largest error against the recurrence at Nemotron-H's (g, h, p, n, q),
    one row of 256 positions: the f32 path, split, and bf16 operands."""
    w = NEMOTRON
    x, dt, A, B, C = _ssd_args(1, 256, w["h"], w["g"], w["p"], w["n"])
    wide = [t.repeat_interleave(w["h"] // w["g"], dim=2) for t in (B, C)]
    want = mb.ssd_reference(x, dt, A, *wide)
    return {name: (ssd._ssd_f32(x, dt, A, B, C, w["q"], formed)[0] - want).abs().max().item()
            for name, formed in (("f32", None), ("split", _split), ("bf16", _bf16))}


def test_tf32_split_keeps_the_f32_paths_accuracy():
    err = _errors_at_nemotron_widths()
    assert err["split"] <= 2 * err["f32"], err
    assert err["split"] <= TOL, err


def test_bf16_operands_lose_the_f32_paths_accuracy():
    err = _errors_at_nemotron_widths()
    assert err["bf16"] >= 10 * err["f32"], err


def _scan_args(b=2, l=300, h=4, g=2, n=64, seed=3):
    """The wrapper's inputs at a shape it takes (head dim 64): raw dt in
    bf16, dt_bias, A and D in f32."""
    x, _, A, B, C = _ssd_args(b, l, h, g, 64, n, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    dt_raw = torch.randn(b, l, h, generator=gen).bfloat16()
    dt_bias = torch.randn(h, generator=gen) * 0.465 - 4.579
    D = 1 + 0.1 * torch.randn(h, generator=gen)
    return x, dt_raw, dt_bias, A, B, C, D


@pytest.mark.parametrize("lens", [None, (300, 170)], ids=["full", "ragged"])
def test_wrapper_runs_the_plain_version_on_cpu(lens):
    """CPU tensors take the plain version, launch nothing, and give the
    einsum route's SSD: dt masked past each row's length, y in f32 plus
    D x rounded once, the state ssd_chunked ends in (300 positions: a
    length chunk 128 does not divide)."""
    x, dt_raw, dt_bias, A, B, C, D = _scan_args()
    valid_len = None if lens is None else torch.tensor(lens)
    before = launches("ssd")
    y, state = ssd.ssd_scan(x, dt_raw, dt_bias, A, B, C, D, 128, valid_len)
    assert launches("ssd") == before
    want_y, want_state = ssd.ssd_scan_plain(x, dt_raw, dt_bias, A, B, C, D, 128, valid_len)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(state, want_state, rtol=0, atol=0)
    dt = torch.nn.functional.softplus(dt_raw.float() + dt_bias)
    if valid_len is not None:
        dt = dt * (torch.arange(x.shape[1])[None, :] < valid_len[:, None])[..., None]
    y32, st = mb.ssd_chunked(x.float(), dt, A, B, C, 128, return_state=True)
    torch.testing.assert_close(state, st, rtol=TOL, atol=TOL)
    # one rounding of y: within half a bf16 step of the f32 sum
    exact = y32 + D[None, None, :, None] * x.float()
    torch.testing.assert_close(y.float(), exact, rtol=2 ** -8, atol=TOL)
    if valid_len is not None:  # the state stops at each row's length
        _, st_short = mb.ssd_chunked(x[1:, :170].float(), dt[1:, :170], A, B[1:, :170],
                                     C[1:, :170], 128, return_state=True)
        torch.testing.assert_close(state[1:], st_short, rtol=TOL, atol=TOL)


def test_wrapper_refuses_operands_that_need_a_gradient():
    x, dt_raw, dt_bias, A, B, C, D = _scan_args()
    with pytest.raises(ValueError, match="no backward"):
        ssd.ssd_scan(x, dt_raw, dt_bias.requires_grad_(), A, B, C, D, 128)
    with torch.no_grad():  # recorded by no one: taken
        ssd.ssd_scan(x, dt_raw, dt_bias, A, B, C, D, 128)


@pytest.mark.parametrize("case", ["head_dim", "state", "chunk", "dtype", "groups"])
def test_wrapper_refuses_what_it_has_no_instantiation_for(case):
    x, dt_raw, dt_bias, A, B, C, D = _scan_args()
    chunk = 128
    if case == "head_dim":
        x = x[..., :16]
    elif case == "state":
        B, C = B[..., :16], C[..., :16]
    elif case == "chunk":
        chunk = 16
    elif case == "dtype":
        x, dt_raw, B, C = x.float(), dt_raw.float(), B.float(), C.float()
    else:
        B, C = B.repeat(1, 1, 2, 1)[:, :, :3], C.repeat(1, 1, 2, 1)[:, :, :3]
    with pytest.raises(ValueError):
        ssd.ssd_scan(x, dt_raw, dt_bias, A, B, C, D, chunk)


@pytest.mark.parametrize("name", ["nemotron-h-47b", "mamba2-130m", "zamba2-1.2b"])
def test_takes_every_served_width_and_no_reduced_one(name):
    if name == "nemotron-h-47b":
        w = NEMOTRON
        assert ssd.takes(w["p"], w["n"], w["q"], torch.bfloat16)
        return
    cfg = get_arch(name)
    dtype = getattr(torch, cfg.compute_dtype)
    assert ssd.takes(cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk, dtype)
    small = cfg.reduced()
    assert not ssd.takes(small.ssm_head_dim, small.ssm_state, small.ssm_chunk, dtype)
    assert not ssd.takes(cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk, torch.float32)


def test_ssd_chunked_is_the_plain_version_reexported():
    """The model's ``ssd_chunked`` is the kernel module's plain version, and
    still the grouped chunked SSD the recurrence gives."""
    assert mb.ssd_chunked is ssd.ssd_chunked
    x, dt, A, B, C = _ssd_args(2, 48, 4, 2, 8, 6)
    y, state = mb.ssd_chunked(x.float(), dt, A, B, C, 16, return_state=True)
    wide = [t.repeat_interleave(2, dim=2) for t in (B, C)]
    torch.testing.assert_close(y, mb.ssd_reference(x, dt, A, *wide), rtol=TOL, atol=TOL)


def test_launch_counts_report_the_ssd_kernel():
    reset_launches("ssd")
    for _ in range(24):
        note_launch("ssd", (256, 128), torch.bfloat16)
    try:
        assert ops.launch_counts()[("ssd", (256, 128))] == 24
    finally:
        reset_launches("ssd")


def test_prefill_on_cpu_takes_the_einsum_route_and_counts_no_card_call():
    """A CPU prefill runs ssd_chunked (the plain version), whatever its
    widths: its route counts as ``plain`` in ``dispatch_stats()["ssd"]``,
    and no kernel call counts in the launch ledger."""
    cfg = get_arch("mamba2-130m").reduced(n_layers=1)
    params = mb.init_mamba_block(cfg, torch.Generator().manual_seed(0), "cpu", ())
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(1))
    before = launches("ssd")
    ops.reset_dispatch_stats()
    out, st = mb.mamba_block_prefill(cfg, params, x, torch.tensor([40, 23]))
    assert launches("ssd") == before
    stats = ops.dispatch_stats()["ssd"]
    assert (stats["plain"], stats["heuristic"]) == (1, 0)
    assert out.shape == x.shape and st["ssm"].shape == (2, cfg.ssm_heads, 16, 16)


def test_prefill_on_the_wrapper_equals_the_einsum_route(monkeypatch):
    """The kernel route of ``ssd.ssd_prefill``, taken here on CPU tensors
    (so through the wrapper's plain version), hands the wrapper the views,
    A, D and lengths the einsum route uses: a bf16 block at a width the
    kernel takes (head dim 64, state 64, chunk 128, 2 groups) gives the
    einsum route's state and, within a bf16 rounding step carried through
    the gated norm and the out projection, its output."""
    import dataclasses

    cfg = dataclasses.replace(get_arch("mamba2-130m").reduced(n_layers=1), ssm_head_dim=64,
                              ssm_state=64, ssm_chunk=128, ssm_n_groups=2,
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    params = mb.init_mamba_block(cfg, torch.Generator().manual_seed(0), "cpu", ())
    x = torch.randn(2, 200, cfg.d_model, generator=torch.Generator().manual_seed(1)).bfloat16()
    valid_len = torch.tensor([200, 131])
    want, want_st = mb.mamba_block_prefill(cfg, params, x, valid_len)
    calls = []
    scan = ssd.ssd_scan

    def counted(*args):
        calls.append(args)
        return scan(*args)

    monkeypatch.setattr(ssd, "ssd_scan", counted)
    monkeypatch.setattr(ssd, "_on_kernel", lambda operands, chunk: ssd.takes(
        operands[0].shape[-1], operands[4].shape[-1], chunk, operands[0].dtype))
    ops.reset_dispatch_stats()
    out, st = mb.mamba_block_prefill(cfg, params, x, valid_len)
    assert len(calls) == 1 and ops.dispatch_stats()["ssd"]["heuristic"] == 1
    torch.testing.assert_close(st["ssm"], want_st["ssm"], rtol=TOL, atol=TOL)
    torch.testing.assert_close(out.float(), want.float(), rtol=1.6e-2, atol=2e-2)
