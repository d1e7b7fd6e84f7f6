"""The Mamba-2 block's causal-conv kernel on the CPU: the wrapper's routing
(the plain version for CPU tensors, refusals, the widths it takes) and the
route the block takes.  The kernel itself runs only on the card
(``tests/test_torch_card.py``)."""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.registry import get_arch
from repro_torch.kernels import causal_conv as cc
from repro_torch.kernels import ops
from repro_torch.kernels.ledger import launches, note_launch, reset_launches
from repro_torch.models import mamba2 as mb

#: Nemotron-H-47B's conv channels: d_inner (256 heads x 64) + 2 x 8 groups x
#: state 256, inside an in_proj output of 2 d_inner + 2 g n + 256 heads
NEMOTRON_CH, NEMOTRON_AT, NEMOTRON_ROW = 20480, 16384, 37120


def conv_operands(b=2, l=70, ch=48, row=None, at=16, gen=None, device="cpu"):
    """bf16 xBC as the block slices it out of a wider in_proj output (row
    ``row`` elements, the slice at ``at``), a conv weight and bias, drawn
    from ``gen`` (seed 0 where None) on ``device``; the card tests draw
    theirs here too."""
    gen = gen or torch.Generator().manual_seed(0)
    row = row or ch + 2 * at
    proj = torch.randn((b, l, row), generator=gen, device=device).bfloat16()
    w = (0.25 * torch.randn((4, ch), generator=gen, device=device)).bfloat16()
    bias = (0.1 * torch.randn((ch,), generator=gen, device=device)).bfloat16()
    return proj[..., at:at + ch], w, bias


@pytest.mark.parametrize("view", ["strided", "packed"])
def test_wrapper_runs_the_plain_version_on_cpu(view):
    """CPU tensors take the plain version and launch nothing."""
    xBC, w, bias = conv_operands()
    if view == "packed":
        xBC = xBC.contiguous()
    before = launches("conv")
    y = cc.causal_conv(xBC, w, bias)
    assert launches("conv") == before
    torch.testing.assert_close(y, cc.causal_conv_plain(xBC, w, bias), rtol=0, atol=0)
    assert y.shape == xBC.shape and y.dtype == torch.bfloat16


def test_wrapper_refuses_operands_that_need_a_gradient():
    xBC, w, bias = conv_operands()
    with pytest.raises(ValueError, match="no backward"):
        cc.causal_conv(xBC, w.float().requires_grad_().bfloat16(), bias)
    with torch.no_grad():  # recorded by no one: taken
        cc.causal_conv(xBC, w.float().requires_grad_().bfloat16(), bias)


@pytest.mark.parametrize("case", ["width", "dtype", "weight_dtype", "channels", "row_stride",
                                  "start", "shape"])
def test_wrapper_refuses_what_it_does_not_take(case):
    xBC, w, bias = conv_operands()
    if case == "width":
        w = torch.cat([w, w[:1]])
    elif case == "dtype":
        xBC, w, bias = xBC.float(), w.float(), bias.float()
    elif case == "weight_dtype":
        w = w.float()
    elif case == "channels":
        xBC, w, bias = xBC[..., :44], w[:, :44], bias[:44]
    elif case == "row_stride":  # a row of 84 elements: 168 bytes, off a 16-byte boundary
        xBC, w, bias = conv_operands(row=84)
    elif case == "start":  # the slice starts 2 bytes past a boundary
        xBC, w, bias = conv_operands(at=1)
    else:
        bias = bias[:40]
    with pytest.raises(ValueError):
        cc.causal_conv(xBC, w, bias)


def test_takes_rejects_other_widths_channels_and_types():
    assert cc.takes(4, 48, torch.bfloat16)
    assert not cc.takes(3, 48, torch.bfloat16)
    assert not cc.takes(4, 44, torch.bfloat16)
    assert not cc.takes(4, 48, torch.float32)


@pytest.mark.parametrize("name", ["nemotron-h-47b", "mamba2-130m", "zamba2-1.2b"])
def test_takes_every_served_width_read_in_place(name):
    """The served widths: the kernel takes the channel count, and reads the
    xBC slice of a served in_proj output in place (its start and row stride
    on 16-byte boundaries)."""
    if name == "nemotron-h-47b":
        width, dtype = 4, torch.bfloat16
        ch, at, row = NEMOTRON_CH, NEMOTRON_AT, NEMOTRON_ROW
    else:
        cfg = get_arch(name)
        di, g, n, h, ch = mb._shapes(cfg)
        width, dtype = cfg.ssm_conv_width, getattr(torch, cfg.compute_dtype)
        at, row = di, 2 * di + 2 * g * n + h
    assert cc.takes(width, ch, dtype)
    proj = torch.zeros(2, 3, row, dtype=dtype)
    assert cc._aligned(proj[..., at:at + ch])


def test_prefill_on_cpu_takes_the_plain_route_and_counts_no_card_call():
    """A CPU prefill runs the plain version: its route counts as ``plain`` in
    ``dispatch_stats()["conv"]``, and no kernel call counts in the launch
    ledger."""
    cfg = get_arch("mamba2-130m").reduced(n_layers=1)
    params = mb.init_mamba_block(cfg, torch.Generator().manual_seed(0), "cpu", ())
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(1))
    before = launches("conv")
    ops.reset_dispatch_stats()
    mb.mamba_block_prefill(cfg, params, x, torch.tensor([40, 23]))
    assert launches("conv") == before
    stats = ops.dispatch_stats()["conv"]
    assert (stats["plain"], stats["heuristic"]) == (1, 0)


def test_prefill_under_autograd_takes_the_plain_route():
    """Training's forward (operands autograd records) takes the plain
    version, wherever the operands lie, and its gradient reaches the conv's
    weight and bias."""
    xBC, w, bias = conv_operands()
    w, bias = w.requires_grad_(), bias.requires_grad_()
    assert not cc._on_kernel(xBC, w, bias)
    ops.reset_dispatch_stats()
    cc.conv_prefill(xBC, w, bias).float().sum().backward()
    stats = ops.dispatch_stats()["conv"]
    assert (stats["plain"], stats["heuristic"]) == (1, 0)
    assert w.grad is not None and bias.grad is not None and w.grad.abs().sum() > 0


@pytest.mark.parametrize("lens", [None, (200, 131)], ids=["full", "ragged"])
def test_prefill_on_the_wrapper_equals_the_plain_route(monkeypatch, lens):
    """The kernel route of ``conv_prefill``, taken here on CPU tensors (so
    through the wrapper's plain version), hands the wrapper in_proj's xBC
    slice in place, the weight and the bias the plain route uses: a bf16
    block gives the plain route's output and states exactly."""
    cfg = dataclasses.replace(get_arch("mamba2-130m").reduced(n_layers=1),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    params = mb.init_mamba_block(cfg, torch.Generator().manual_seed(0), "cpu", ())
    params["conv_b"] = (0.1 * torch.randn(params["conv_b"].shape,
                                          generator=torch.Generator().manual_seed(2))).bfloat16()
    x = torch.randn(2, 200, cfg.d_model, generator=torch.Generator().manual_seed(1)).bfloat16()
    valid_len = None if lens is None else torch.tensor(lens)
    want, want_st = mb.mamba_block_prefill(cfg, params, x, valid_len)
    calls = []

    def launch(xBC, w, bias):  # the wrapper's checks, then its plain version on CPU tensors
        calls.append(xBC)
        return cc.causal_conv(xBC, w, bias)

    monkeypatch.setattr(cc, "_launch", launch)
    monkeypatch.setattr(cc, "_on_kernel", lambda xBC, w, bias: cc._typed(xBC, w, bias)
                        and cc._aligned(xBC))
    ops.reset_dispatch_stats()
    out, st = mb.mamba_block_prefill(cfg, params, x, valid_len)
    assert len(calls) == 1 and not calls[0].is_contiguous()  # the slice, read in place
    assert ops.dispatch_stats()["conv"] == {**ops.dispatch_stats()["conv"], "heuristic": 1,
                                            "plain": 0}
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    for k in ("conv", "ssm"):
        torch.testing.assert_close(st[k], want_st[k], rtol=0, atol=0)


def test_causal_conv_plain_is_reexported_and_is_the_depthwise_conv():
    """The model's ``causal_conv_plain`` is the kernel module's, and it is
    ``silu(conv1d(groups=ch) + bias)`` with the width - 1 zeros before each
    row (in f32, where no pass rounds)."""
    assert mb.causal_conv_plain is cc.causal_conv_plain
    xBC, w, bias = (t.float() for t in conv_operands())
    ch = xBC.shape[-1]
    want = F.silu(F.conv1d(F.pad(xBC.transpose(1, 2), (3, 0)), w.t()[:, None, :], bias,
                           groups=ch)).transpose(1, 2)
    torch.testing.assert_close(cc.causal_conv_plain(xBC, w, bias), want, rtol=1e-6, atol=1e-6)


def test_launch_counts_report_the_conv_kernel():
    reset_launches("conv")
    for _ in range(24):
        note_launch("conv", (4, NEMOTRON_CH), torch.bfloat16)
    try:
        assert ops.launch_counts()[("conv", (4, NEMOTRON_CH))] == 24
    finally:
        reset_launches("conv")


def test_bf16_steps_counts_the_representable_values_between():
    """The card's comparison: 0 for equal values (signed zeros too), 1 for
    neighbours, across zero by the steps on both sides."""
    a = torch.tensor([1.0, 1.0, 0.0, -0.0, -1.0], dtype=torch.bfloat16)
    up = torch.nextafter(a, torch.tensor(2.0, dtype=torch.bfloat16))
    assert cc.bf16_steps(a, a).tolist() == [0] * 5
    assert cc.bf16_steps(a, up).tolist() == [1] * 5
    assert cc.bf16_steps(a[2:3], a[3:4]).item() == 0
    tiny = torch.tensor([2 ** -133], dtype=torch.bfloat16)  # the smallest positive subnormal
    assert cc.bf16_steps(tiny, -tiny).item() == 2
