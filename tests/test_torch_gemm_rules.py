"""The bf16 GEMM kernels' legality rule, heuristic and analytical model
(``repro_torch.core.analysis``, ``kernels/gemm.py``,
``core/cost/analytical.py``), and the plain version held against the JAX
package's Pallas GEMM (interpret mode) under configs the bf16 rule
admits.  bf16 takes the tensor-core (``wgmma``) kernel at ``block_m >=
64`` and the bandwidth kernel below; float32 keeps the SIMT kernel."""

import hashlib
import math
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.gemm import KernelConfig as RefConfig
from repro.kernels.gemm import gemm_pallas
from repro_torch.core.analysis import (
    GEMM_BW_BN,
    GEMM_WG_INSTANCES,
    HopperSpec,
    ScheduleAnalyzer,
    gemm_bf16_max_threads,
    gemm_kernel_kind,
    gemm_launch_error,
    gemm_smem_bytes,
    gemm_stages,
    should_prune,
    simt_lda,
)
from repro_torch.core.config_space import GemmConfigSpace, TilingState
from repro_torch.core.cost.analytical import AnalyticalHopperCost
from repro_torch.kernels import ops
from repro_torch.kernels.gemm import (
    KernelConfig,
    default_config,
    gemm_tiled,
    kernel_config_from_state,
    state_from_config,
)

#: (block_m, block_k, block_n, sub_m, sub_n, reg_m, reg_n) -> the bf16
#: rule's verdict (None: launchable)
BF16_EDGES = [
    # the wgmma kernel
    ((128, 128, 256, 64, 256, 1, 1), None),  # the heuristic tile
    ((64, 64, 64, 64, 64, 1, 1), None),  # the smallest instantiation
    ((128, 64, 128, 128, 128, 1, 1), None),  # at the register cliff: 128 accumulators
    ((128, 64, 256, 128, 256, 1, 1), "accumulator_cliff"),  # 256 accumulators
    ((256, 64, 128, 256, 128, 1, 1), "accumulator_cliff"),
    ((64, 64, 64, 32, 64, 1, 1), "wgmma_shape"),  # sub_m under m64
    ((192, 64, 64, 192, 64, 1, 1), "wgmma_shape"),  # sub_m not 64 or 128
    ((64, 64, 64, 64, 16, 1, 1), "wgmma_shape"),  # n16: under one 64-column atom
    ((64, 64, 96, 64, 96, 1, 1), "wgmma_shape"),  # n96: not whole atoms
    ((64, 32, 64, 64, 64, 1, 1), "wgmma_shape"),  # a 32-deep slab: half an atom
    ((64, 16, 64, 64, 64, 1, 1), "wgmma_shape"),  # one k16 step
    ((64, 256, 64, 64, 64, 1, 1), "wgmma_shape"),
    ((64, 8, 64, 64, 64, 1, 1), "block_below_minimum"),  # under one k16 step
    ((128, 64, 128, 64, 128, 2, 1), "register_tile"),  # m3 != 1
    ((128, 64, 128, 64, 64, 1, 2), "register_tile"),  # n3 != 1
    ((128, 64, 128, 48, 128, 1, 1), "tile_nesting"),
    ((256, 64, 128, 64, 128, 1, 1), "threads_over_limit"),  # 4 warpgroups
    ((128, 64, 256, 64, 128, 1, 1), "threads_over_limit"),
    ((128, 128, 128, 64, 128, 1, 1), None),  # 64 KB slabs: 3 stages
    ((128, 128, 256, 64, 256, 1, 1), None),  # 96 KB slabs: 2 stages
    ((64, 128, 512, 64, 256, 1, 1), "ring_too_shallow"),  # a 144 KB slab
    # the bandwidth kernel
    ((8, 256, 16, 8, 16, 1, 1), None),  # decode's heuristic tile
    ((16, 64, 64, 16, 64, 1, 1), None),
    ((8, 16, 8, 8, 8, 1, 1), None),
    ((8, 48, 16, 8, 16, 1, 1), None),  # any multiple of 16 deep
    ((8, 24, 16, 8, 16, 1, 1), "stream_tile"),  # not whole k16 steps
    ((32, 64, 16, 32, 16, 1, 1), "stream_tile"),  # 8 or 16 rows only
    ((8, 256, 128, 8, 128, 1, 1), "stream_tile"),  # no 128-column instantiation
    ((8, 256, 32, 8, 16, 1, 1), "stream_tile"),  # no split of the CTA tile
    ((16, 256, 32, 8, 32, 1, 1), "stream_tile"),
    ((8, 256, 16, 8, 16, 1, 2), "register_tile"),
    ((8, 8, 16, 8, 16, 1, 1), "block_below_minimum"),
    ((4, 64, 16, 4, 16, 1, 1), "block_below_minimum"),
    ((8, 2048, 64, 8, 64, 1, 1), "ring_too_shallow"),  # one 300 KB stage
]


@pytest.mark.parametrize("tile,want", BF16_EDGES, ids=lambda x: str(x))
def test_bf16_rule_edges(tile, want):
    err = gemm_launch_error(*tile, 2)
    assert (err and err[0]) == want, err


def test_bf16_rule_grid_limit_and_float32_keeps_the_simt_rule():
    spec = HopperSpec()
    assert gemm_launch_error(128, 128, 256, 64, 256, 1, 1, 2,
                             grid_m=spec.max_grid_y + 1)[0] == "grid_too_large"
    assert gemm_launch_error(8, 256, 16, 8, 16, 1, 1, 2,
                             grid_m=spec.max_grid_y + 1)[0] == "grid_too_large"
    # the SIMT heuristic tile is no bf16 tile, and the wgmma tile no SIMT one
    assert gemm_launch_error(128, 32, 128, 32, 64, 8, 8, 4) is None
    assert gemm_launch_error(128, 32, 128, 32, 64, 8, 8, 2)[0] == "register_tile"
    assert gemm_launch_error(128, 64, 256, 64, 256, 1, 1, 4)[0] == "threads_over_limit"
    assert [gemm_kernel_kind(bm, b) for bm, b in ((128, 4), (128, 2), (64, 2), (8, 2))] == \
        ["simt", "wgmma", "wgmma", "stream"]


def test_derived_stages_follow_shared_memory():
    # wgmma: min(4, (opt-in shared memory - 1 KB of alignment) // slab bytes)
    assert gemm_stages(128, 64, 256) == 4  # 48 KB slabs
    assert gemm_stages(128, 128, 256) == 2  # 96 KB
    assert gemm_stages(64, 128, 512) == 1  # 144 KB
    assert gemm_stages(128, 64, 128) == 4  # 32 KB
    assert gemm_stages(64, 64, 64) == 4
    assert gemm_stages(128, 128, 128) == 3  # 64 KB
    small = HopperSpec(smem_per_block=100_000)
    assert gemm_stages(128, 64, 256, spec=small) == 2
    assert gemm_launch_error(128, 128, 256, 64, 256, 1, 1, 2, small)[0] == "ring_too_shallow"
    assert gemm_smem_bytes(128, 64, 256) == 4 * (128 + 256) * 64 * 2 + 1024
    assert gemm_smem_bytes(128, 64, 256, spec=small) == 2 * 384 * 64 * 2 + 1024
    # the bandwidth kernel: min(8, 96 KB // padded stage bytes), plus the
    # f32 partial sums of its 4 warps
    stage = 2 * (8 * (256 + 8) + 256 * (16 + 8))
    assert gemm_stages(8, 256, 16) == 98_304 // stage == 5
    assert gemm_smem_bytes(8, 256, 16) == 5 * stage + 4 * 4 * 8 * 16
    assert gemm_stages(8, 16, 8) == 8
    # float32: the SIMT kernel's ring of padded slabs (test_float32_ring_rule)
    assert gemm_stages(128, 32, 128, 4) == 4
    assert gemm_smem_bytes(128, 32, 128, 4) == 4 * (132 + 128) * 32 * 4
    # the space's working set follows the ring
    space = GemmConfigSpace(8192, 4096, 4096)
    st = state_from_config(KernelConfig(128, 64, 128, 64, 128), 8192, 4096, 4096)
    assert space.working_set_bytes(st, 2) == gemm_smem_bytes(128, 64, 128)
    assert space.working_set_bytes(st, 2) == 4 * 256 * 64 * 2 + 1024


#: (block_m, block_k, block_n) -> (stages, shared-memory bytes) of the
#: float32 ring: min(4, opt-in // slab), the A slab's rows padded to simt_lda
F32_RINGS = [
    ((128, 8, 128), (4, 4 * (132 + 128) * 8 * 4)),  # 8 KB slabs: the cap of 4
    ((128, 64, 128), (3, 3 * (132 + 128) * 64 * 4)),  # 65 KB: three fit
    ((128, 128, 128), (1, (132 + 128) * 128 * 4)),  # 130 KB: one stage, still launched
    ((64, 512, 32), (1, (68 + 32) * 512 * 4)),  # the analytical model's 512^3 optimum
    ((8, 1024, 8), (2, 2 * (12 + 8) * 1024 * 4)),  # bm = 8 pads to 12
    ((12, 8, 16), (4, 4 * (12 + 16) * 8 * 4)),  # bm = 4 (mod 8): no padding
    ((10, 8, 16), (4, 4 * (12 + 16) * 8 * 4)),
    ((512, 128, 512), (0, (516 + 512) * 128 * 4)),  # over the budget once
]


@pytest.mark.parametrize("tile,ring", F32_RINGS, ids=str)
def test_float32_ring_rule(tile, ring):
    assert (gemm_stages(*tile, 4), gemm_smem_bytes(*tile, 4)) == ring
    assert simt_lda(tile[0]) % 8 == 4 and 0 <= simt_lda(tile[0]) - tile[0] < 8


def test_float32_padding_is_in_the_rule():
    """The A slab's padding counts against the budget: a slab whose
    unpadded bytes fit and padded bytes do not is refused, and a smaller
    card's budget takes stages off the ring.  A slab that fits once
    launches with one stage."""
    assert gemm_launch_error(128, 128, 128, 32, 64, 8, 8, 4) is None
    assert (16 + 40) * 1024 * 4 <= HopperSpec().smem_per_block < (20 + 40) * 1024 * 4
    assert gemm_launch_error(16, 1024, 40, 16, 40, 1, 1, 4)[0] == "smem_overflow"
    small = HopperSpec(smem_per_block=100_000)
    assert gemm_stages(128, 32, 128, 4, small) == 3
    assert gemm_stages(128, 128, 128, 4, small) == 0


def test_float32_launchable_set_is_unchanged():
    """The ring keeps the space's float32 launchable set: at 512^3 the
    same 47 441 states as the single-slab rule it replaced (the digest of
    their sorted keys under that rule)."""
    space, spec = GemmConfigSpace(512, 512, 512), HopperSpec()
    analyzer = ScheduleAnalyzer(space, spec, in_bytes=4)
    keys = sorted(s.key() for s in space.enumerate() if not analyzer.analyze(s).illegal)
    assert len(keys) == 47_441
    assert hashlib.sha256("\n".join(keys).encode()).hexdigest() == \
        "bcaad5b1853607d3b89503b31f78a458d543a9626d8fa36ee3f906181ba88d1e"


def test_bf16_instantiations_and_their_limits():
    assert len(GEMM_WG_INSTANCES) == 10
    assert all(sm * sn // 128 <= 128 for _, sm, sn in GEMM_WG_INSTANCES)
    assert all(bk % 64 == 0 and sn % 64 == 0 for bk, _, sn in GEMM_WG_INSTANCES)
    assert (64, 64, 256) in GEMM_WG_INSTANCES and (64, 128, 256) not in GEMM_WG_INSTANCES
    assert GEMM_BW_BN == (8, 16, 32, 64)
    assert gemm_bf16_max_threads(64) == gemm_bf16_max_threads(128) == 256
    assert gemm_bf16_max_threads(8) == gemm_bf16_max_threads(16) == 128


def test_bf16_register_tiles_are_refused_not_pruned_as_degenerate():
    """In bf16 every launchable state has a 1x1 register tile: the SIMT
    kernel's ``degenerate`` verdict must not prune them; other register
    tiles are ILLEGAL (``register_tile``), so G-BFS spends no trial on
    aliases of one schedule."""
    space = GemmConfigSpace(8192, 4096, 4096)
    bf16, f32 = ScheduleAnalyzer(space, in_bytes=2), ScheduleAnalyzer(space, in_bytes=4)
    wg = TilingState((64, 2, 64, 1), (32, 128), (16, 1, 256, 1))
    assert bf16.analyze(wg).ok and not should_prune(bf16.analyze(wg))
    assert f32.analyze(wg).illegal
    alias = TilingState((64, 2, 32, 2), (32, 128), (16, 1, 256, 1))
    assert bf16.analyze(alias).reason == "register_tile"
    degenerate = TilingState((32, 1, 32, 8), (128, 32), (32, 1, 32, 4))
    assert f32.analyze(TilingState((256, 1, 32, 1), (128, 32), (128, 1, 32, 1))).reason \
        == "degenerate"
    assert bf16.analyze(degenerate).reason == "register_tile"
    decode = ScheduleAnalyzer(GemmConfigSpace(8, 4096, 11008), in_bytes=2)
    st = TilingState((1, 1, 8, 1), (16, 256), (688, 1, 16, 1))
    assert decode.analyze(st).ok
    assert decode.analyze(TilingState((1, 1, 8, 1), (16, 256), (172, 4, 16, 1))).reason \
        == "stream_tile"
    # 43 CTAs of 256 columns leave most SMs idle: advisory, never pruned
    fill = decode.analyze(TilingState((1, 1, 8, 1), (16, 256), (1376, 1, 8, 1)))
    assert fill.ok
    narrow = ScheduleAnalyzer(GemmConfigSpace(8, 4096, 512), in_bytes=2)
    under = narrow.analyze(TilingState((1, 1, 8, 1), (16, 256), (32, 1, 16, 1)))
    assert under.reason == "under_fill" and not should_prune(under)


SERVED_PREFILL = [(32768, 4096, 4096), (32768, 4096, 512), (32768, 4096, 11008),
                  (32768, 11008, 4096)]
DECODE = [(8, 4096, 4096), (8, 4096, 512), (8, 4096, 11008), (8, 11008, 4096),
          (8, 4096, 65536)]


@pytest.mark.parametrize("dims", SERVED_PREFILL + [(8192, 4096, 6144), (8192, 12288, 4096)])
def test_default_config_is_a_wgmma_tile_at_prefill_shapes(dims):
    cfg = default_config(*dims)
    assert gemm_kernel_kind(cfg.block_m) == "wgmma"
    assert (cfg.block_m, cfg.block_k, cfg.block_n, cfg.sub_m, cfg.sub_n) == (128, 128, 256, 64, 256)
    cfg.validate(*dims, 2)
    assert kernel_config_from_state(state_from_config(cfg, *dims)) == cfg


@pytest.mark.parametrize("dims,block_n", zip(DECODE, (32, 8, 64, 32, 64)))
def test_default_config_is_the_bandwidth_kernel_at_m8(dims, block_n):
    """The widest columns that still give about one CTA per SM (N = 512
    gives fewer at any width: the narrowest, the most CTAs)."""
    cfg = default_config(*dims)
    assert gemm_kernel_kind(cfg.block_m) == "stream"
    assert (cfg.block_m, cfg.block_n, cfg.block_k) == (8, block_n, 256)
    cfg.validate(*dims, 2)
    st = state_from_config(cfg, *dims)
    assert st.m == (1, 1, 8, 1) and st.n[1] == st.n[3] == 1
    assert kernel_config_from_state(st) == cfg
    # float32 keeps the SIMT heuristic
    assert gemm_kernel_kind(default_config(*dims, 4).block_m, 4) == "simt"


@pytest.mark.parametrize("dims,bf16_kernel", [
    ((128, 4104, 128), None),      # K = 8 (mod 16): no k16 step fits
    ((8, 4104, 4096), None),
    ((8, 4096, 4100), None),       # N = 4 (mod 8): no column tile fits (nor in f32)
    ((128, 4112, 128), "stream"),  # K = 16 (mod 64): no wgmma slab, 16-row streams
    ((120, 4096, 128), "stream"),  # M = 8 (mod 64)
    ((128, 4096, 128), "wgmma"),
])
def test_bf16_coverage_and_what_goes_to_the_library(dims, bf16_kernel):
    """The bf16 kernels step K by 16 (``mma.sync``/``wgmma`` k16), where
    the SIMT kernel they replace stepped it by 8: a bf16 product whose K
    is 8 modulo 16 gets no config and dispatch sends it to
    ``torch.matmul``, while float32 still takes the SIMT kernel."""
    cfg, src = ops.kernel_config(*dims, torch.bfloat16)
    if bf16_kernel is None:
        assert (cfg, src) == (None, "matmul")
    else:
        assert src == "heuristic" and gemm_kernel_kind(cfg.block_m) == bf16_kernel
    f32_cfg, f32_src = ops.kernel_config(*dims, torch.float32)
    assert (f32_src == "matmul") == (dims[2] % 8 != 0)


def _sample(space, n, seed):
    rng = random.Random(seed)
    return [space.random_state(rng) for _ in range(n)]


@pytest.mark.parametrize("dims", [(8192, 4096, 6144), (8, 4096, 11008), (256, 512, 128)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_analytical_model_structure(dims, dtype):
    space = GemmConfigSpace(*dims)
    cost = AnalyticalHopperCost(space, dtype=dtype)
    analyzer = ScheduleAnalyzer(space, in_bytes=cost.in_bytes)
    states = _sample(space, 300, 0)
    s0 = state_from_config(default_config(*dims, cost.in_bytes), *dims)
    states.append(s0)
    costs = [cost.cost(s) for s in states]
    assert costs == cost.batch_cost(states)
    assert costs == AnalyticalHopperCost(space, dtype=dtype).batch_cost(states)  # deterministic
    for s, c in zip(states, costs):
        assert math.isinf(c) == analyzer.analyze(s).illegal, s
    assert math.isfinite(cost.cost(s0))


def test_analytical_tensor_cores_beat_simt_at_the_same_cta_tile():
    dims = (8192, 4096, 4096)
    space = GemmConfigSpace(*dims)
    bf16 = AnalyticalHopperCost(space, dtype="bfloat16")
    f32 = AnalyticalHopperCost(space, dtype="float32")
    wg = TilingState((64, 2, 64, 1), (64, 64), (32, 1, 128, 1))  # 128x64x128, two m64n128
    simt = TilingState((64, 4, 4, 8), (64, 64), (32, 2, 8, 8))  # 128x64x128, 8x8 per thread
    assert (wg.block_m, wg.block_k, wg.block_n) == (simt.block_m, simt.block_k, simt.block_n)
    # the SIMT model reaches 94 % of the f32 rate with 128-bit operand loads
    # (8x8: 64 FMAs a k step per 4 loads); wgmma's copies hold it to a
    # quarter of the bf16 rate
    assert 4 * bf16.cost(wg) < f32.cost(simt) < math.inf
    # above the tensor-core bound, within a few times of it
    bound = 2 * 8192 * 4096 * 4096 / 989e12
    assert bound < bf16.cost(wg) < 4 * bound
    # decode: the bandwidth kernel streams B near the memory rate
    d = (8, 4096, 11008)
    dec = AnalyticalHopperCost(GemmConfigSpace(*d), dtype="bfloat16")
    read = 4096 * 11008 * 2 / 3.35e12
    assert read < dec.cost(state_from_config(default_config(*d), *d)) < 2 * read
    assert bf16.measure_fingerprint() != f32.measure_fingerprint().replace("float32", "bfloat16")
    # the f32 model of the ring kernel: costs of the single-slab model it
    # replaced are not served from a journal
    assert f32.measure_fingerprint().startswith("r1|float32|ring")


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["wgmma", "stream"])
@pytest.mark.parametrize("ref", [RefConfig(32, 64, 32), RefConfig(64, 128, 64, sub_m=32, sub_n=32),
                                 RefConfig(8, 128, 8)], ids=str)
def test_plain_matches_pallas_under_bf16_kernel_configs(ref, kind):
    """The plain version under a config each bf16 kernel takes, with the
    reference config's K slab, against the Pallas kernel (interpret mode)
    at the JAX package's bf16 tolerance."""
    m, k, n = 128, 256, 128
    a, b = _rand((m, k), 0), _rand((k, n), 1)
    bk = ref.block_k
    cfg = KernelConfig(128, bk, 128, 64, 128) if kind == "wgmma" else KernelConfig(16, bk, 32, 16, 32)
    cfg.validate(m, k, n, 2)
    assert gemm_kernel_kind(cfg.block_m) == kind
    out = gemm_tiled(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16(), cfg)
    want = gemm_pallas(jnp.asarray(a, "bfloat16"), jnp.asarray(b, "bfloat16"), ref,
                       interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               rtol=0.05, atol=0.4)


def test_unaligned_operands_are_refused_and_dispatch_copies_them():
    buf = torch.randn(64 * 64 + 1).bfloat16()
    a = buf[1:].view(64, 64)  # contiguous, 2 bytes past a 16-byte boundary
    assert a.is_contiguous() and a.data_ptr() % 16
    b = torch.randn(64, 64).bfloat16()
    cfg = KernelConfig(64, 64, 64, 64, 64)
    with pytest.raises(ValueError, match="16-byte"):
        gemm_tiled(a, b, cfg)
    with pytest.raises(ValueError, match="16-byte"):
        gemm_tiled(b, a, cfg)
    # float32 too: the SIMT kernel copies B's rows in 16-byte chunks
    f = torch.randn(64 * 64 + 1)[1:].view(64, 64)
    f_cfg = KernelConfig(64, 32, 64, 32, 64, 8, 8)
    with pytest.raises(ValueError, match="16-byte"):
        gemm_tiled(f, f, f_cfg)
    np.testing.assert_allclose(ops.gemm(f, f, config=f_cfg, device="cpu").numpy(),
                               gemm_tiled(f.clone(), f.clone(), f_cfg).numpy())
    np.testing.assert_allclose(ops.gemm(a, b, config=cfg, device="cpu").float().numpy(),
                               gemm_tiled(a.clone(), b, cfg).float().numpy())
