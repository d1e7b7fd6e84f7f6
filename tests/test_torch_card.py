"""The port's kernels on the card, held against their plain PyTorch
versions.  Every test here is marked ``gpu`` and skips where there is no
card.  The file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch built for CUDA:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_card.py
"""

import pytest
import torch

from repro_torch.core.analysis import FLASH_HEAD_DIMS, flash_max_threads
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_kernel_matches_plain_on_card(dtype):
    gen = _card()
    rtol = 1e-4 if dtype == torch.float32 else 0.05
    a = torch.randn(512, 256, generator=gen, device="cuda").to(dtype)
    b = torch.randn(256, 384, generator=gen, device="cuda").to(dtype)
    for cfg in (gemm.KernelConfig(128, 32, 128, 32, 64, 8, 8),
                gemm.KernelConfig(32, 64, 32, 0, 0, 1, 1)):
        before = gemm.LAUNCHES[(512, 256, 384)]
        out = gemm.gemm_tiled(a, b, cfg)
        torch.cuda.synchronize()
        assert gemm.LAUNCHES[(512, 256, 384)] == before + 1
        torch.testing.assert_close(out.float(), gemm.gemm_plain(a, b, cfg).float(),
                                   rtol=rtol, atol=rtol * 8)


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
