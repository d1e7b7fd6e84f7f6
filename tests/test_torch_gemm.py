"""The port's GEMM (plain version on the CPU, CUDA kernel on the card) and
its record-aware dispatch, held against the JAX package's Pallas GEMM in
interpret mode: the same numpy-seeded inputs go through both, with the
JAX package's tolerances (float32 rtol 1e-4, bfloat16 0.05)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as ref_ops
from repro.kernels.gemm import KernelConfig as RefConfig
from repro.kernels.gemm import default_config as ref_default_config
from repro.kernels.gemm import gemm_pallas
from repro_torch.core.analysis import gemm_launch_error
from repro_torch.core.config_space import TilingState
from repro_torch.core.records import TuningRecords, global_records, set_global_records, workload_key_for
from repro_torch.kernels import ops
from repro_torch.kernels.gemm import (
    KernelConfig,
    default_config,
    gemm_tiled,
    state_from_config,
)
from repro_torch.kernels.ledger import launches

SHAPES = [(64, 64, 64), (128, 256, 64), (256, 128, 512), (8, 1024, 8)]
# the JAX package's kernel test configs (tests/test_gemm_kernel.py)
REF_CONFIGS = [
    RefConfig(32, 64, 32),
    RefConfig(64, 128, 64, sub_m=32, sub_n=32),
    RefConfig(8, 128, 8),
]
DTYPES = [("float32", torch.float32, 1e-4), ("bfloat16", torch.bfloat16, 0.05)]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(x: np.ndarray, dtype: str):
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got: torch.Tensor, ref, tol):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol * 8
    )


def _port_config(ref: RefConfig, in_bytes: int) -> KernelConfig:
    """float32: the reference config's blocks and sub-tiles with the
    smallest square register tile the SIMT kernel launches them with.
    bfloat16: a tile of the tensor-core kernel with the reference's K
    slab (the plain version's arithmetic depends on the slab alone)."""
    c = ref.resolved()
    if in_bytes == 2:
        cfg = KernelConfig(64, c.block_k, 64, 64, 64)
        assert gemm_launch_error(64, c.block_k, 64, 64, 64, 1, 1, 2) is None
        return cfg
    for reg in (1, 2, 4, 8):
        rm, rn = min(reg, c.sub_m), min(reg, c.sub_n)
        if gemm_launch_error(c.block_m, c.block_k, c.block_n, c.sub_m, c.sub_n,
                             rm, rn, in_bytes) is None:
            return KernelConfig(c.block_m, c.block_k, c.block_n, c.sub_m, c.sub_n, rm, rn)
    raise AssertionError(f"no launchable register tile for {ref}")


@pytest.fixture
def clean_dispatch():
    old = global_records()
    ops.reset_dispatch_stats()
    yield
    set_global_records(old)
    ops.set_kernel_policy(ops.KernelPolicy())
    ops.reset_dispatch_stats()


@pytest.mark.parametrize("dtype,tdtype,tol", DTYPES)
@pytest.mark.parametrize("cfg", REF_CONFIGS, ids=str)
def test_plain_matches_pallas_on_reference_configs(cfg, dtype, tdtype, tol):
    m, k, n = 128, 256, 128
    ja, ta = _both(_rand((m, k), 0), dtype)
    jb, tb = _both(_rand((k, n), 1), dtype)
    ref = gemm_pallas(ja, jb, cfg, interpret=True)
    port_cfg = _port_config(cfg, ta.element_size())
    out = gemm_tiled(ta, tb, port_cfg)
    assert out.dtype == tdtype
    _close(out, ref, tol)


@pytest.mark.parametrize("dtype,tdtype,tol", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_dispatched_gemm_matches_pallas(shape, dtype, tdtype, tol, clean_dispatch):
    m, k, n = shape
    ja, ta = _both(_rand((m, k), 0), dtype)
    jb, tb = _both(_rand((k, n), 1), dtype)
    ref = gemm_pallas(ja, jb, ref_default_config(m, k, n), interpret=True)
    _close(ops.gemm(ta, tb, device="cpu"), ref, tol)
    assert ops.dispatch_stats()["gemm"]["heuristic"] == 1


@pytest.mark.parametrize("dtype,tdtype,tol", [DTYPES[0]])
def test_backward_matches_jax_grad(dtype, tdtype, tol, clean_dispatch):
    a, b, g = _rand((64, 128), 0), _rand((128, 64), 1), _rand((64, 64), 2)
    ref_ops.set_kernel_policy(ref_ops.KernelPolicy(use_pallas=True, interpret=True))
    try:
        da_ref, db_ref = jax.grad(
            lambda x, y: jnp.sum(ref_ops.gemm(x, y) * jnp.asarray(g)), argnums=(0, 1)
        )(jnp.asarray(a), jnp.asarray(b))
    finally:
        ref_ops.set_kernel_policy(ref_ops.KernelPolicy())
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    (ops.gemm(ta, tb, device="cpu") * torch.from_numpy(g)).sum().backward()
    _close(ta.grad, da_ref, tol)
    _close(tb.grad, db_ref, tol)
    # forward + dA + dB, each dispatched to the kernel under its own key
    assert ops.dispatch_stats()["gemm"]["heuristic"] == 3


@pytest.mark.parametrize("m", [1, 2, 5])
def test_bf16_products_under_eight_rows_run_padded_rows(m, clean_dispatch):
    """A bf16 product of fewer than 8 rows (a small decode batch) runs
    the kernel's 8-row block on rows padded with zeros: the reference
    product's values, dispatched under the ``(8, K, N)`` heuristic."""
    a, b = _rand((m, 256), 0), _rand((256, 512), 1)
    (ja, ta), (jb, tb) = _both(a, "bfloat16"), _both(b, "bfloat16")
    ref_ops.set_kernel_policy(ref_ops.KernelPolicy(use_pallas=True, interpret=True))
    try:
        ref = ref_ops.gemm(ja, jb)
    finally:
        ref_ops.set_kernel_policy(ref_ops.KernelPolicy())
    got = ops.gemm(ta, tb, device="cpu")
    assert got.shape == (m, 512) and got.dtype == torch.bfloat16
    _close(got, ref, 0.05)
    assert ops.kernel_config(m, 256, 512, torch.bfloat16) == (None, "matmul")
    assert ops.kernel_config(8, 256, 512, torch.bfloat16)[1] == "heuristic"
    assert ops.dispatch_stats()["gemm"]["heuristic"] == 1


def test_records_drive_dispatch(tmp_path, clean_dispatch):
    """A tuning record changes the config gemm() serves; an ILLEGAL
    record is refused by the static guard and the heuristic serves."""
    rec = TuningRecords(str(tmp_path / "r.json"))
    good = TilingState((2, 2, 2, 8), (2, 32), (2, 1, 8, 4))
    bad = TilingState((1, 1, 1, 64), (1, 64), (1, 1, 1, 64))  # 64x64 register tile
    rec.update(workload_key_for("gemm", (64, 64, 64), "float32", "hopper_timed"), good, 1e-6, "g-bfs", 1)
    rec.update(workload_key_for("gemm", (64, 64, 64), "bfloat16", "hopper_timed"), bad, 1e-6, "g-bfs", 1)
    set_global_records(rec)
    a, b = torch.from_numpy(_rand((64, 64), 0)), torch.from_numpy(_rand((64, 64), 1))
    np.testing.assert_allclose(ops.gemm(a, b, device="cpu").numpy(), a.numpy() @ b.numpy(),
                               rtol=1e-4, atol=1e-3)
    ops.gemm(a, b, device="cpu")  # memoized
    ops.gemm(a.bfloat16(), b.bfloat16(), device="cpu")
    st = ops.dispatch_stats()["gemm"]
    assert (st["records"], st["memo_hits"], st["static_reject"], st["heuristic"]) == (2, 1, 1, 1)
    rec.update(workload_key_for("gemm", (64, 64, 64), "float32", "hopper_timed"),
               TilingState((1, 4, 2, 8), (2, 32), (1, 2, 4, 8)), 1e-7, "g-bfs", 1)
    ops.gemm(a, b, device="cpu")  # the records change dropped the memo
    assert ops.dispatch_stats()["gemm"]["store_lookups"] == 3


def test_matmul_shape_rule_and_higher_rank(clean_dispatch):
    a, b = torch.from_numpy(_rand((63, 127), 0)), torch.from_numpy(_rand((127, 65), 1))
    np.testing.assert_allclose(ops.gemm(a, b, device="cpu").numpy(), a.numpy() @ b.numpy(),
                               rtol=1e-4, atol=1e-4)
    assert ops.dispatch_stats()["gemm"]["matmul"] == 1
    x, w = torch.from_numpy(_rand((4, 8, 32), 2)), torch.from_numpy(_rand((32, 16), 3))
    out = ops.gemm(x, w, device="cpu")
    assert out.shape == (4, 8, 16)
    np.testing.assert_allclose(out.numpy(), np.einsum("abk,kn->abn", x.numpy(), w.numpy()),
                               rtol=1e-4, atol=1e-4)


def test_entry_points_refuse_to_fall_back_to_cpu():
    a = torch.ones(64, 64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ops.gemm(a, a)
    with pytest.raises(ValueError):
        ops.gemm(a, a, device="meta")
    from repro_torch.core import GemmConfigSpace, HopperTimedCost

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            HopperTimedCost(GemmConfigSpace(64, 64, 64))
    with pytest.raises(RuntimeError):
        HopperTimedCost(GemmConfigSpace(64, 64, 64), device="cpu")


def test_wrapper_refusals():
    cfg = KernelConfig(32, 32, 32, 32, 32, 1, 1)
    a = torch.ones(64, 64)
    with pytest.raises(ValueError):
        gemm_tiled(a.half(), a.half(), cfg)
    with pytest.raises(ValueError):
        gemm_tiled(a.t()[:, :32], a[:32], cfg)  # not contiguous
    with pytest.raises(ValueError):
        gemm_tiled(a, torch.ones(32, 64), cfg)
    with pytest.raises(ValueError):
        gemm_tiled(a, a, KernelConfig(48, 32, 32, 48, 32, 1, 1))  # does not divide
    with pytest.raises(ValueError):
        gemm_tiled(a, a, KernelConfig(64, 64, 64, 64, 64, 1, 1))  # 4096 threads
    before = launches("gemm").total()
    gemm_tiled(a, a, cfg)
    assert launches("gemm").total() == before  # the plain version is no launch


def test_default_config_fits_hopper_where_the_tpu_default_does_not():
    """The JAX package's TPU default (blocks up to 256x512x256) needs far
    more than a CTA's shared memory (SIMT, float32) and has no tensor-core
    instantiation (bfloat16); the port keeps its own default per dtype."""
    for m, k, n in [(8192, 4096, 6144), (8192, 12288, 4096), (8192, 4096, 65536)]:
        ref = ref_default_config(m, k, n).resolved()
        for in_bytes in (4, 2):
            assert gemm_launch_error(ref.block_m, ref.block_k, ref.block_n, ref.sub_m,
                                     ref.sub_n, 1, 1, in_bytes) is not None
            cfg = default_config(m, k, n, in_bytes)
            cfg.validate(m, k, n, in_bytes)
            assert state_from_config(cfg, m, k, n).dims() == (m, k, n)
    assert default_config(63, 127, 65) is None
    assert default_config(63, 127, 65, 4) is None

