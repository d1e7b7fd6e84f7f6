"""The port's kernels on the card, held against their plain PyTorch
versions.  Every test here is marked ``gpu`` and skips where there is no
card.  The file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch built for CUDA:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_card.py
"""

import pytest
import torch

from repro_torch.core.analysis import (
    FLASH_HEAD_DIMS,
    GEMM_BW_BN,
    GEMM_WG_INSTANCES,
    flash_max_threads,
    gemm_bf16_max_threads,
    max_threads_for_reg_tile,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


#: configs per case: the SIMT kernel in f32; in bf16 the wgmma kernel (one
#: and two warpgroups, both slab depths) and, at M = 8, the bandwidth kernel
GEMM_CASES = {
    "float32": (torch.float32, (512, 256, 384),
                (gemm.KernelConfig(128, 32, 128, 32, 64, 8, 8),
                 gemm.KernelConfig(32, 64, 32, 0, 0, 1, 1))),
    "bfloat16": (torch.bfloat16, (512, 256, 512),
                 (gemm.KernelConfig(128, 128, 256, 64, 256),
                  gemm.KernelConfig(256, 64, 128, 128, 128),
                  gemm.KernelConfig(64, 64, 64, 64, 64))),
    "bfloat16-decode": (torch.bfloat16, (8, 4096, 1024),
                        (gemm.KernelConfig(8, 256, 16, 8, 16),
                         gemm.KernelConfig(8, 64, 64, 8, 64))),
}


@pytest.mark.gpu
# bf16: one output rounding step apart, at K <= 4096 (chip_smoke.py states
# the limit, whose atol grows with K above that)
@pytest.mark.parametrize("case,tol", [("float32", (1e-4, 8e-4)),
                                      ("bfloat16", (1.6e-2, 2e-3)),
                                      ("bfloat16-decode", (1.6e-2, 2e-3))])
def test_gemm_kernel_matches_plain_on_card(case, tol):
    gen = _card()
    dtype, (m, k, n), configs = GEMM_CASES[case]
    a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    b = torch.randn(k, n, generator=gen, device="cuda").to(dtype)
    for cfg in configs:
        before = gemm.LAUNCHES[(m, k, n)]
        out = gemm.gemm_tiled(a, b, cfg)
        torch.cuda.synchronize()
        assert gemm.LAUNCHES[(m, k, n)] == before + 1
        torch.testing.assert_close(out.float(), gemm.gemm_plain(a, b, cfg).float(),
                                   rtol=tol[0], atol=tol[1])


@pytest.mark.gpu
def test_gemm_launch_limits_match_the_analyzer():
    _card()
    for rm in (1, 2, 4, 8):
        for rn in (1, 2, 4, 8):
            assert gemm.kernel_max_threads(torch.float32, rm, rn) == max_threads_for_reg_tile(rm, rn)
    for bk, sm, sn in GEMM_WG_INSTANCES:
        cfg = gemm.KernelConfig(sm, bk, sn, sm, sn)
        assert gemm.kernel_max_threads_bf16(cfg) == gemm_bf16_max_threads(sm)
    for bn in GEMM_BW_BN:
        cfg = gemm.KernelConfig(8, 16, bn, 8, bn)
        assert gemm.kernel_max_threads_bf16(cfg) == gemm_bf16_max_threads(8)


@pytest.mark.gpu
def test_gemm_refuses_unaligned_bf16_operands_on_card():
    _card()
    buf = torch.zeros(64 * 64 + 8, device="cuda").bfloat16()
    a = buf[1:64 * 64 + 1].view(64, 64)
    before = sum(gemm.LAUNCHES.values())
    with pytest.raises(ValueError, match="16-byte"):
        gemm.gemm_tiled(a, a.clone(), gemm.KernelConfig(64, 64, 64, 64, 64))
    assert sum(gemm.LAUNCHES.values()) == before


#: (G, causal, (block_q, block_kv)) per dtype: the bf16 kernel takes whole
#: 64-row warpgroups and up to 128 keys a block, the f32 one blocks of 16
FLASH_CASES = {
    torch.bfloat16: ((1, True, (64, 16)), (4, True, (128, 32)), (8, False, (64, 128)),
                     (8, True, (128, 128))),
    torch.float32: ((1, True, (16, 16)), (4, True, (64, 32)), (8, False, (32, 64)),
                    (8, True, (64, 64))),
}


@pytest.mark.gpu
# bf16: two rounding steps, as chip_smoke.py states (kernel and plain
# version round P and the output at the same places)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (2e-5, 8e-5)),
                                       (torch.bfloat16, (1.6e-2, 2e-3))])
@pytest.mark.parametrize("hd", FLASH_HEAD_DIMS)
def test_flash_kernel_matches_plain_on_card(dtype, tol, hd):
    gen = _card()
    for g, causal, (bq, bkv) in FLASH_CASES[dtype]:
        q = torch.randn(2, 256, 2 * g, hd, generator=gen, device="cuda").to(dtype)
        k = torch.randn(2, 256, 2, hd, generator=gen, device="cuda").to(dtype)
        v = torch.randn(2, 256, 2, hd, generator=gen, device="cuda").to(dtype)
        before = fa.LAUNCHES[(256, 256, hd)]
        out = fa.flash_attention(q, k, v, bq, bkv, causal)
        torch.cuda.synchronize()
        assert fa.LAUNCHES[(256, 256, hd)] == before + 1
        torch.testing.assert_close(out.float(),
                                   fa.flash_attention_plain(q, k, v, bq, bkv, causal).float(),
                                   rtol=tol[0], atol=tol[1])


@pytest.mark.gpu
def test_flash_launch_limits_match_the_analyzer():
    _card()
    for dtype in (torch.float32, torch.bfloat16):
        for hd in FLASH_HEAD_DIMS:
            assert fa.kernel_max_threads(dtype, hd) == flash_max_threads(hd, dtype.itemsize)


@pytest.mark.gpu
def test_na2c_on_the_card_is_deterministic():
    """N-A2C with its networks on the card gives the same trials twice
    under one seed (the float32 H100 model at 256^3, warm-started)."""
    _card()
    from repro_torch.core import AnalyticalHopperCost, Budget, GemmConfigSpace, get_op
    from repro_torch.core.tuners import NA2CTuner

    space = GemmConfigSpace(256, 256, 256)
    cost = AnalyticalHopperCost(space, dtype="float32")
    s0 = get_op("gemm").default_state(space, "float32")
    runs = [NA2CTuner(space, cost, seed=0, s0=s0, device="cuda").tune(Budget(max_trials=120))
            for _ in range(2)]
    assert runs[0].n_trials == 120
    assert [(t.state.key(), t.cost) for t in runs[0].trials] == [
        (t.state.key(), t.cost) for t in runs[1].trials
    ]
