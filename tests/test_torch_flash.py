"""The port's flash attention (plain version on the CPU, CUDA kernel on the
card), its search space, launch rule, analytical model and tuning, held
against the JAX package: the same numpy-seeded inputs go through the
reference Pallas kernel in interpret mode and through the port, at the
reference's tolerances (float32 2e-5, bfloat16 0.05; atol 4x)."""

import hashlib
import math
import random
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import TrialJournal as RefJournal
from repro.core import TuningRecords as RefRecords
from repro.core import TuningSession as RefSession
from repro.core.cost.base import CostBackend as RefBackend
from repro.core.cost.flash_analytical import FlashAnalyticalCost as RefFlashCost
from repro.core.flash_space import FlashAttnConfigSpace as RefSpace
from repro.core.session import Workload as RefWorkload
from repro.core.tuners import Budget as RefBudget
from repro.core.tuners import GBFSTuner as RefGBFS
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.launch.tune import flash_workloads_for_arch as ref_flash_workloads
from repro_torch.core import Budget, TrialJournal, TuningRecords, TuningSession, Workload
from repro_torch.core.analysis import (
    FLASH_F32_BKV,
    FLASH_HEAD_DIMS,
    FLASH_STAGES,
    HopperSpec,
    ScheduleAnalyzer,
    flash_launch_error,
    flash_max_threads,
    flash_smem_bytes,
    flash_stages,
    flash_threads,
    should_prune,
)
from repro_torch.core.cost.base import CostBackend
from repro_torch.core.cost.flash_analytical import FlashAnalyticalHopperCost
from repro_torch.core.flash_space import FlashAttnConfigSpace, FlashScheduleState
from repro_torch.core.ops import get_op
from repro_torch.core.tuners import GBFSTuner
from repro_torch.kernels.flash_attention import (
    default_blocks,
    flash_attention,
    flash_attention_plain,
    state_from_blocks,
)
from repro_torch.kernels.ledger import launches
from repro_torch.launch.tune import flash_workloads_for_arch

DTYPES = [("float32", 2e-5), ("bfloat16", 0.05)]


def _qkv(b, s, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32))


def _both(arrays, dtype):
    return ([jnp.asarray(a, dtype) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _close(got: torch.Tensor, ref, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol * 4)


# -- the kernel's arithmetic ---------------------------------------------------


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize(
    "shape",
    # the reference kernel test's shapes (tests/test_flash_kernel.py)
    [(2, 128, 8, 2, 16), (1, 256, 4, 4, 32), (2, 64, 8, 8, 16), (1, 128, 16, 4, 8)],
    ids=str,
)
def test_plain_matches_reference_kernel(shape, dtype, tol):
    b, s, h, kv, hd = shape
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, s, h, kv, hd), dtype)
    ref = ref_flash(jq, jk, jv, block_q=64, block_k=64, interpret=True)
    out = flash_attention_plain(tq, tk, tv, min(64, s), min(64, s))
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _close(out, ref, tol)


@pytest.mark.parametrize("bq,bkv,g,seed", [
    (16, 16, 1, 0), (16, 64, 2, 1), (32, 16, 4, 2), (64, 32, 1, 3),
    (32, 32, 2, 4), (64, 64, 4, 5), (16, 32, 4, 6), (64, 16, 2, 7),
])
def test_block_sweep_matches_reference(bq, bkv, g, seed):
    """Any (block_q, block_kv) tiling computes the reference's attention —
    the tunability contract (the reference's hypothesis sweep, as cases)."""
    arrays = _qkv(1, 128, 2 * g, 2, 16, seed)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "float32")
    ref = ref_flash(jq, jk, jv, block_q=bq, block_k=bkv, interpret=True)
    np.testing.assert_allclose(flash_attention_plain(tq, tk, tv, bq, bkv).numpy(),
                               np.asarray(ref), rtol=2e-5, atol=1e-4)
    # the wrapper takes these blocks and, on CPU tensors, is the plain version
    np.testing.assert_array_equal(flash_attention(tq, tk, tv, bq, bkv).numpy(),
                                  flash_attention_plain(tq, tk, tv, bq, bkv).numpy())


@pytest.mark.parametrize("hd", FLASH_HEAD_DIMS)
def test_non_causal_matches_reference(hd):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 64, 4, 2, hd), "float32")
    ref = ref_flash(jq, jk, jv, block_q=32, block_k=32, causal=False, interpret=True)
    _close(flash_attention(tq, tk, tv, 32, 32, causal=False), ref, 2e-5)


def test_indivisible_blocks_raise():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 100, 4, 2, 16), "float32")
    with pytest.raises(ValueError):
        ref_flash(jq, jk, jv, block_q=64, block_k=64, interpret=True)
    with pytest.raises(ValueError):
        flash_attention_plain(tq, tk, tv, 64, 64)
    with pytest.raises(ValueError):
        flash_attention(tq, tk, tv, 64, 64)


def test_wrapper_refusals():
    _, (q, k, v) = _both(_qkv(1, 64, 4, 2, 16), "float32")
    with pytest.raises(ValueError):
        flash_attention(q.half(), k.half(), v.half(), 32, 32)  # dtype
    with pytest.raises(ValueError):
        flash_attention(q[:, :32], k, v, 32, 32)  # causal needs sq == sk
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, 32, 32)
    with pytest.raises(ValueError):
        flash_attention(q[..., :3, :], k, v, 32, 32)  # 3 heads on 2 kv heads
    with pytest.raises(ValueError):
        flash_attention(q, k, v, 8, 8)  # below the kernel's minimum block
    _, (q8, k8, v8) = _both(_qkv(1, 64, 4, 2, 8), "float32")
    with pytest.raises(ValueError):
        flash_attention(q8, k8, v8, 32, 32)  # no head_dim-8 instantiation
    before = launches("flash").total()
    flash_attention(q, k, v, 32, 32)
    flash_attention(q[:, :32], k, v, 32, 32, causal=False)  # cross shapes are fine
    assert launches("flash").total() == before  # the plain version is no launch


@pytest.mark.parametrize("hd", (8, 16, 32, 64, 128, 256))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_wrapper_refusals_agree_with_analyzer(hd, dtype):
    """The wrapper's check and the analyzer's ILLEGAL verdict are one rule:
    on every state of a 64-token space (at the timed operand's 32 heads on
    4 kv heads) they agree."""
    space = FlashAttnConfigSpace(64, 64, hd, heads=32, kv_heads=4)
    tdtype = getattr(torch, dtype)
    analyzer = ScheduleAnalyzer(space, in_bytes=torch.empty((), dtype=tdtype).element_size())
    q = torch.zeros((1, 64, 32, hd), dtype=tdtype)
    kv = torch.zeros((1, 64, 4, hd), dtype=tdtype)
    verdicts = []
    for s in space.enumerate():
        try:
            flash_attention(q, kv, kv, s.block_q, s.block_kv)
            refused = False
        except ValueError:
            refused = True
        assert analyzer.analyze(s).illegal == refused, (s, analyzer.analyze(s))
        verdicts.append(refused)
    assert any(verdicts)
    assert all(verdicts) == (hd not in FLASH_HEAD_DIMS)


#: per dtype, (blocks, head_dim, grid_y) -> the launch rule's reason
#: (None: launches); bf16 takes the tensor-core kernel, f32 the CUDA-core one
LAUNCH_EDGES = {
    "bfloat16": [
        ((128, 128, 128), None),  # two warpgroups, 160 KB of shared memory
        ((64, 16, 128), None),
        ((64, 64, 96), "head_dim"),
        ((8, 64, 128), "block_below_minimum"),
        ((64, 40, 128), "block_alignment"),  # block_kv not a multiple of 16
        ((32, 64, 128), "block_alignment"),  # block_q under one warpgroup (64 rows)
        ((96, 64, 128), "block_alignment"),
        ((192, 64, 16), "threads_over_limit"),  # 384 > 256 threads
        ((64, 144, 128), "kv_block_over_registers"),
        ((128, 128, 128, 70_000), "grid_too_large"),
    ],
    "float32": [
        ((64, 64, 128), None),
        ((48, 64, 128), None),  # block_q: any multiple of 16
        ((16, 16, 16), None),  # one warp: 4 row groups of 8 lanes
        ((64, 64, 96), "head_dim"),
        ((8, 64, 128), "block_below_minimum"),
        ((40, 64, 128), "block_alignment"),
        ((64, 48, 128), "block_alignment"),  # no block_kv 48 instantiation
        ((64, 128, 128), "kv_block_over_registers"),  # block_kv 64 is the largest
        ((128, 64, 128), None),  # 512 threads (16 a row group), one ring stage
        ((144, 16, 128), "threads_over_limit"),  # 576 > 512
        ((128, 32, 64), None),  # 512 threads at hd 64
        ((144, 32, 64), "threads_over_limit"),
        ((256, 64, 32), None),  # 512 threads (8 a row group) at hd 32
        ((272, 16, 32), "threads_over_limit"),  # 544 > 512
        ((64, 64, 128, 70_000), "grid_too_large"),
    ],
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_launch_rule_edges(dtype):
    in_bytes = 2 if dtype == "bfloat16" else 4
    assert flash_launch_error(64, 64, 128, in_bytes=1)[0] == "dtype"
    for (bq, bkv, hd, *grid), want in LAUNCH_EDGES[dtype]:
        err = flash_launch_error(bq, bkv, hd, in_bytes, grid_y=grid[0] if grid else 1)
        assert (err and err[0]) == want, ((bq, bkv, hd), err)
    if dtype == "bfloat16":
        # 128 threads per 64-row warpgroup, __launch_bounds__(256) for every hd;
        # the Q tile and a ring of FLASH_STAGES bf16 K/V tiles, no P tile
        assert flash_threads(128, 16) == flash_max_threads(16) == flash_max_threads(128) == 256
        assert flash_smem_bytes(128, 128, 128) == 2 * 128 * (128 + 2 * FLASH_STAGES * 128)
        assert flash_smem_bytes(128, 128, 128) <= 232_448
    else:
        # 16 lanes per 4 query rows at hd >= 64, 8 below; __launch_bounds__(512)
        assert flash_threads(64, 128, 4) == flash_threads(64, 64, 4) == 256
        assert flash_threads(64, 32, 4) == flash_threads(16, 16, 4) * 4 == 128
        assert all(flash_max_threads(hd, 4) == 512 for hd in FLASH_HEAD_DIMS)
        # d-major Q, key-major P and a ring of (d-major K, row-major V) stages,
        # d-major rows padded by 4 floats; as deep as fits beside Q and P, <= 2
        q, stage, p = 128 * 68, 128 * 68 + 64 * 128, 64 * 68
        assert flash_stages(64, 64, 128, 4) == 2
        assert flash_smem_bytes(64, 64, 128, 4) == 4 * (q + 2 * stage + p) <= 232_448
        q, p = 128 * 132, 64 * 132
        assert flash_stages(128, 64, 128, 4) == 1  # two stages would take 236 544 B
        assert flash_smem_bytes(128, 64, 128, 4) == 4 * (q + stage + p)
        assert 4 * (q + 2 * stage + p) > 232_448
        assert flash_stages(128, 32, 128, 4) == 2
        # a card with less shared memory: one stage, then none
        small = HopperSpec(smem_per_block=120_000)
        assert flash_stages(64, 64, 128, 4, small) == 1
        assert flash_launch_error(64, 64, 128, 4, small) is None
        assert flash_stages(128, 64, 128, 4, small) == 0
        assert flash_launch_error(128, 64, 128, 4, small)[0] == "smem_overflow"
        assert flash_smem_bytes(128, 64, 128, 4, small) == 4 * (q + stage + p)


def test_analyzer_flash_verdicts():
    an = ScheduleAnalyzer(FlashAttnConfigSpace(4096, 4096, 128, heads=32, kv_heads=4))
    assert an.analyze(FlashScheduleState((64, 64), (64, 64))).ok
    assert an.analyze(FlashScheduleState((4096, 1), (64, 64))).reason == "block_below_minimum"
    assert an.analyze(FlashScheduleState((64, 64), (32, 64))).reason == "product_mismatch"
    small = ScheduleAnalyzer(FlashAttnConfigSpace(128, 128, 16, heads=32, kv_heads=4))
    fill = small.analyze(FlashScheduleState((2, 64), (2, 64)))  # 2 x 32 CTAs
    assert fill.reason == "under_fill" and not should_prune(fill)
    # the grid the rules read is the space's head layout: on the JAX
    # package's one head the 64 CTAs of 64-row blocks leave SMs idle, and
    # a layout taller than gridDim.y cannot launch at all
    one = ScheduleAnalyzer(FlashAttnConfigSpace(4096, 4096, 128))
    assert one.analyze(FlashScheduleState((64, 64), (64, 64))).reason == "under_fill"
    tall = ScheduleAnalyzer(FlashAttnConfigSpace(4096, 4096, 128, heads=70_000, kv_heads=1))
    assert tall.analyze(FlashScheduleState((64, 64), (64, 64))).reason == "grid_too_large"


#: per dtype: (seq_q, seq_kv, head_dim) -> heuristic blocks
DEFAULT_BLOCKS = {
    "bfloat16": [((4096, 4096, 128), (128, 128)), ((128, 128, 16), (128, 128)),
                 ((192, 192, 64), (64, 64)), ((64, 64, 32), (64, 64)),
                 ((48, 48, 16), None),  # under one warpgroup of rows
                 ((100, 100, 16), None), ((4096, 4096, 8), None)],
    "float32": [((4096, 4096, 128), (64, 64)), ((128, 128, 16), (64, 64)),
                ((48, 48, 16), (16, 16)), ((100, 100, 16), None), ((4096, 4096, 8), None)],
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_default_blocks_fit_hopper_where_the_tpu_default_does_not(dtype):
    """The JAX package's TPU default (256 x 512) cannot launch at hd 128;
    the port keeps its own heuristic blocks per dtype, each of which the
    launch rule takes."""
    in_bytes = 2 if dtype == "bfloat16" else 4
    assert flash_launch_error(256, 512, 128, in_bytes) is not None
    for (sq, skv, hd), want in DEFAULT_BLOCKS[dtype]:
        got = default_blocks(sq, skv, hd, in_bytes=in_bytes)
        assert got == want, ((sq, skv, hd), got)
        if got is not None:
            assert flash_launch_error(*got, hd, in_bytes) is None
    if dtype == "float32":
        # 128-row CTAs where their grid fills the card's 132 SMs (yi-6b's 32
        # heads), 64-row ones where it would not (the toy row's 2 x 16 heads)
        assert default_blocks(4096, 4096, 128, 4, grid_y=32) == (128, 64)
        assert default_blocks(256, 256, 128, 4, grid_y=32) == (64, 64)
        assert default_blocks(4096, 4096, 128, 4, grid_y=4) == (64, 64)  # 128 CTAs
        assert default_blocks(4096, 4096, 128, 4, grid_y=5) == (128, 64)  # 160
    st = state_from_blocks(64, 32, 4096, 4096)
    assert (st.block_q, st.block_kv, st.dims()) == (64, 32, (4096, 4096))
    space = get_op("flash").make_space((4096, 4096, 128))
    assert get_op("flash").default_state(space, dtype) == state_from_blocks(
        *default_blocks(4096, 4096, 128, in_bytes), 4096, 4096)


#: (seq, head_dim, G, batch x query heads) at which the tests and the card
#: phases dispatch the f32 kernel through ``ops.flash_blocks``: the reduced
#: configs (head_dim 16, 4 query heads on 2 kv heads) past their 64-token
#: threshold, the toy and the real row of ``chip_smoke.py``, and the
#: served attention geometries of yi-6b, qwen3-moe and whisper in f32
F32_DISPATCHED = [
    (80, 16, 2, 4), (96, 16, 2, 8), (128, 16, 2, 16), (256, 16, 2, 8),
    (256, 128, 8, 32), (4096, 128, 8, 32), (4096, 128, 8, 256), (32768, 128, 8, 32),
    (4096, 128, 16, 64), (128, 64, 1, 48), (3520, 128, 7, 56),
]


def test_f32_dispatch_finds_a_launchable_pair_wherever_it_did():
    """The f32 rule changed, the sequences the kernel takes did not: a
    sequence that is a multiple of 16 gets launchable heuristic blocks at
    every head_dim (the parent's list ended in 16 x 16, and so does this
    one), any other runs plain attention; and at each dispatched shape
    the blocks ``ops.flash_blocks`` returns launch at its grid."""
    from repro_torch.kernels import ops

    for seq in range(16, 8192 + 1, 16):
        for hd in FLASH_HEAD_DIMS:
            got = default_blocks(seq, seq, hd, 4, grid_y=32)
            assert got is not None and flash_launch_error(*got, hd, 4, grid_y=32) is None
            assert got[1] in FLASH_F32_BKV and seq % got[0] == seq % got[1] == 0
    for seq in (48, 100, 4095, 4104):
        assert (default_blocks(seq, seq, 16, 4) is None) == (seq % 16 != 0)
    for seq, hd, g, grid_y in F32_DISPATCHED:
        blocks, src = ops.flash_blocks(seq, seq, hd, torch.float32, grid_y=grid_y)
        assert src == "heuristic" and flash_launch_error(*blocks, hd, 4, grid_y=grid_y) is None
        assert default_blocks(seq, seq, hd, 2 * 2, grid_y=grid_y) == blocks


# -- the search space ----------------------------------------------------------


@pytest.mark.parametrize("dims", [(128, 128, 16), (4096, 4096, 128), (256, 512, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_space_matches_reference(dims, causal):
    """States, keys, size, enumeration, neighbours, transplants and
    spec_kwargs match bit for bit; features match but for the working
    set, which follows the Hopper kernel's shared memory."""
    port, ref = FlashAttnConfigSpace(*dims, causal=causal), RefSpace(*dims, causal=causal)
    assert port.size() == ref.size() and port.dims == ref.dims
    assert port.spec_kwargs() == ref.spec_kwargs()
    assert port.initial_state().key() == ref.initial_state().key()
    assert port.n_features == ref.n_features
    assert [s.key() for s in port.enumerate()] == [s.key() for s in ref.enumerate()]
    other_port, other_ref = FlashAttnConfigSpace(1024, 2048, dims[2]), RefSpace(1024, 2048, dims[2])
    rng_p, rng_r = random.Random(3), random.Random(3)
    for _ in range(20):
        s, r = port.random_state(rng_p), ref.random_state(rng_r)
        assert s.key() == r.key() and (s.block_q, s.block_kv) == (r.block_q, r.block_kv)
        assert [x.key() for x in port.neighbors(s)] == [x.key() for x in ref.neighbors(r)]
        fp, fr = port.features(s), ref.features(r)
        np.testing.assert_array_equal(fp[:-1], fr[:-1])
        assert fp[-1] == np.float32(math.log2(flash_smem_bytes(s.block_q, s.block_kv, dims[2])))
        tp, tr = other_port.transplant(s), other_ref.transplant(r)
        assert (tp is None) == (tr is None)
        if tp is not None:
            assert tp.key() == tr.key()


def test_flash_workloads_match_reference():
    for arch in ("yi-6b", None):
        port, ref = flash_workloads_for_arch(arch, "train_4k"), ref_flash_workloads(arch, "train_4k")
        assert [(w.op, w.dims, w.dtype, w.depths, w.label) for w in port] == [
            (w.op, w.dims, w.dtype, w.depths, w.label) for w in ref]
        assert port[0].key("hopper_timed") == ref[0].key("hopper_timed")
    assert port[0].dims == (4096, 4096, 128) and port[0].dtype == "bfloat16"


def test_head_layout_travels_with_the_workload():
    """The arch's query and kv heads reach the space, and through it the
    launch and fill rules, the analytical model, the timed operand and
    the fingerprints; the workload key and the JAX package's one-head
    spec_kwargs stay as they are."""
    (yi,) = flash_workloads_for_arch("yi-6b", "train_4k")
    space = yi.space()
    assert (space.heads, space.kv_heads) == (32, 4)
    assert space.spec_kwargs() == {"causal": True, "heads": 32, "kv_heads": 4}
    assert FlashAttnConfigSpace(4096, 4096, 128).spec_kwargs() == \
        RefSpace(4096, 4096, 128).spec_kwargs()
    wide = Workload("flash", (256, 256, 32), label="w", space_kwargs={"heads": 64, "kv_heads": 8})
    assert wide.key("b") == Workload("flash", (256, 256, 32)).key("b")
    wspace = wide.space()
    q, k, v = get_op("flash").operands(wspace, "float32", 0, "cpu")
    assert q.shape == (1, 256, 64, 32) and k.shape == v.shape == (1, 256, 8, 32)
    st = state_from_blocks(64, 64, 256, 256)  # 4 q blocks
    assert ScheduleAnalyzer(wspace).analyze(st).ok  # 4 x 64 = 256 CTAs
    assert ScheduleAnalyzer(FlashAttnConfigSpace(256, 256, 32, heads=32, kv_heads=4)).analyze(
        st).reason == "under_fill"  # 4 x 32 = 128 CTAs for 132 SMs
    # one head of 64 CTAs fits one wave on 132 SMs; 32 heads take many
    one = FlashAnalyticalHopperCost(FlashAttnConfigSpace(4096, 4096, 128))
    many = FlashAnalyticalHopperCost(space)
    big = state_from_blocks(64, 64, 4096, 4096)
    assert many.cost(big) > 4 * one.cost(big)
    assert "heads=32" in many.measure_fingerprint() and "heads" not in one.measure_fingerprint()
    with pytest.raises(ValueError):
        FlashAttnConfigSpace(256, 256, 32, heads=6, kv_heads=4)
    # tune_arch tunes two layouts of one key as two workloads
    session = TuningSession(TuningRecords(), cost_factory=PortTable, verbose=False)
    report = session.tune_arch(workloads=[wide, Workload("flash", (256, 256, 32), label="n")],
                               budget=Budget(max_trials=8))
    assert report.n_unique_shapes == 2


# -- the analytical model ------------------------------------------------------


@pytest.mark.parametrize("dims", [(512, 512, 64), (4096, 4096, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_kv_visits_equal_reference(dims, causal):
    port = FlashAnalyticalHopperCost(FlashAttnConfigSpace(*dims, causal=causal))
    ref = RefFlashCost(RefSpace(*dims, causal=causal))
    for s, r in zip(port.space.enumerate(), ref.space.enumerate()):
        assert port.kv_visits(s) == ref.kv_visits(r)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_analytical_model_structure(dtype):
    space = FlashAttnConfigSpace(4096, 4096, 128)
    cost = FlashAnalyticalHopperCost(space, dtype=dtype)
    analyzer = ScheduleAnalyzer(space, in_bytes=cost.in_bytes)
    states = list(space.enumerate())
    costs = [cost.cost(s) for s in states]
    assert costs == FlashAnalyticalHopperCost(space, dtype=dtype).batch_cost(states)  # deterministic
    for s, c in zip(states, costs):
        assert math.isinf(c) == analyzer.analyze(s).illegal
    assert sum(map(math.isfinite, costs)) > 5
    # a coarser kv block wastes masked work above the causal diagonal
    assert cost.kv_visits(state_from_blocks(64, 16, 4096, 4096)) * 16 < \
        cost.kv_visits(state_from_blocks(64, 128, 4096, 4096)) * 128


def test_analytical_model_follows_the_kernel_of_each_dtype():
    """bf16 is costed at a share of the tensor-core rate, f32 on CUDA cores:
    at the served blocks of each, the tensor-core kernel is several times
    faster; the two models never share journal entries."""
    space = FlashAttnConfigSpace(4096, 4096, 128, heads=32, kv_heads=4)
    bf16 = FlashAnalyticalHopperCost(space, dtype="bfloat16")
    f32 = FlashAnalyticalHopperCost(space, dtype="float32")
    st = state_from_blocks(64, 64, 4096, 4096)
    assert 4 * bf16.cost(st) < f32.cost(st) < math.inf
    # the tensor-core bound: the causal products at 989 TFLOP/s, on 32 heads
    ops = 4 * 32 * 128 * 4096 * 4097 // 2
    assert ops / 989e12 < bf16.cost(st) < 10 * ops / 989e12
    assert bf16.measure_fingerprint() != f32.measure_fingerprint().replace("float32", "bfloat16")


# -- tuning parity -------------------------------------------------------------


def table_cost(key: str) -> float:
    """A deterministic cost table: a hash of the state key, with about one
    state in ten failing (``inf``)."""
    u = int.from_bytes(hashlib.blake2b(key.encode(), digest_size=8).digest(), "big") / 2.0**64
    return math.inf if u < 0.1 else 1e-3 * (1.0 + u)


class RefTable(RefBackend):
    name = "table"

    def cost_once(self, s, repeat_idx):
        return table_cost(s.key())


class PortTable(CostBackend):
    name = "table"

    def cost_once(self, s, repeat_idx):
        return table_cost(s.key())


def _trace(result):
    return [(t.state.key(), t.cost, t.clock_s) for t in result.trials]


@pytest.mark.parametrize("dims", [(512, 512, 64), (4096, 4096, 128)])
@pytest.mark.parametrize("seed,n_workers", [(0, 1), (7, 4)])
def test_gbfs_flash_parity(dims, seed, n_workers):
    ref = RefGBFS(RefSpace(*dims), RefTable(RefSpace(*dims)), seed=seed).tune(
        RefBudget(max_trials=40), n_workers=n_workers)
    port = GBFSTuner(FlashAttnConfigSpace(*dims), PortTable(FlashAttnConfigSpace(*dims)),
                     seed=seed).tune(Budget(max_trials=40), n_workers=n_workers)
    assert _trace(port) == _trace(ref) and port.n_trials == ref.n_trials
    assert port.best_state.key() == ref.best_state.key() and port.best_cost == ref.best_cost


def test_flash_tune_workload_parity(tmp_path, monkeypatch):
    """Trial sequence, best state, records JSON and journal bytes match,
    for a cold search and a warm start from the record it wrote."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    out = {}
    for pkg, Session, Records, Journal, Wl, Bud, Table in (
        ("ref", RefSession, RefRecords, RefJournal, RefWorkload, RefBudget, RefTable),
        ("port", TuningSession, TuningRecords, TrialJournal, Workload, Budget, PortTable),
    ):
        rec, jnl = str(tmp_path / f"{pkg}.json"), str(tmp_path / f"{pkg}.jsonl")
        with Journal(jnl) as journal:
            session = Session(Records(rec), cost_factory=Table, seed=3,
                              verbose=False, journal=journal)
            wl = Wl("flash", (1024, 1024, 128), dtype="bfloat16", label="f")
            first = session.tune_workload(wl, "g-bfs", Bud(max_trials=30))
            second = session.tune_workload(wl, "g-bfs", Bud(max_trials=30),
                                           seed=5, warm_start=True)
        with open(rec, "rb") as f, open(jnl, "rb") as g:
            out[pkg] = (first, second, f.read(), g.read())
    ref, port = out["ref"], out["port"]
    for i in (0, 1):
        assert _trace(port[i]) == _trace(ref[i])
        assert port[i].best_state.key() == ref[i].best_state.key()
    assert port[1].n_cache_hits == ref[1].n_cache_hits > 0
    assert port[2] == ref[2]
    assert port[3] == ref[3]



# -- the plain version rounds where the kernel rounds ---------------------------


def test_plain_rounds_p_to_bf16_where_the_kernel_does():
    """For bf16 inputs the plain version feeds P @ V with p rounded to bf16
    and sums l from the f32 p, as the tensor-core kernel does; f32 inputs
    keep f32 p.  One kv block, full attention: the softmax written out."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 2, 1, 32, seed=4))
    for dtype in (torch.bfloat16, torch.float32):
        qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
        logits = torch.einsum("bqhd,bkhd->bhqk", qd.float() / math.sqrt(32),
                              kd.float().expand(-1, -1, 2, -1))
        p = torch.exp(logits - logits.amax(-1, keepdim=True))
        pv = p.to(dtype).float() if dtype == torch.bfloat16 else p
        want = (torch.einsum("bhqk,bkhd->bqhd", pv, vd.float().expand(-1, -1, 2, -1))
                / p.sum(-1).permute(0, 2, 1)[..., None]).to(dtype)
        got = flash_attention_plain(qd, kd, vd, 64, 64, causal=False)
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-6, atol=1e-6)
    # rounding p moves the bf16 result off the f32-p result somewhere
    f32p = flash_attention_plain(q, k, v, 64, 64, causal=False)
    bf = flash_attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), 64, 64, causal=False)
    unrounded = flash_attention_plain(q.bfloat16().float(), k.bfloat16().float(),
                                      v.bfloat16().float(), 64, 64, causal=False).bfloat16()
    assert not torch.equal(bf, unrounded)
    assert (bf.float() - f32p).abs().max() < 0.05


# -- the measured cost names the kernel it times --------------------------------


def test_measured_fingerprint_names_the_kernel_source(tmp_path, monkeypatch):
    """HopperTimedCost's fingerprint carries the digest of the source its
    op launches, so a journal measured on another build of the kernel is
    re-measured, not served.  Checked on a copy of the sources, without a
    card or nvcc."""
    import shutil

    from repro_torch.core.cost import measured
    from repro_torch.kernels import build

    for name in ("flash_attention.cu", "gemm.cu"):
        shutil.copy(f"{build.CSRC_DIR}/{name}", tmp_path / name)
    backend = object.__new__(measured.HopperTimedCost)
    backend.space = FlashAttnConfigSpace(256, 256, 32, heads=8, kv_heads=2)
    backend.n_repeats, backend.dtype, backend.seed = 3, "bfloat16", 0
    backend.device = torch.device("cuda")
    backend._opspec = get_op("flash")
    backend._operands = get_op("flash").operands(backend.space, "float32", 0, "cpu")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "card")

    repo_fp = backend.measure_fingerprint()
    digest = build.source_digest("flash_attention.cu")
    assert f"|src=flash_attention.cu@{digest}|" in repo_fp
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    assert backend.measure_fingerprint() == repo_fp  # the same text, the same part
    with open(tmp_path / "flash_attention.cu", "a") as f:
        f.write("// another build\n")
    changed = backend.measure_fingerprint()
    assert changed != repo_fp and digest not in changed
    assert changed.replace(build.source_digest("flash_attention.cu", str(tmp_path)), digest) == repo_fp
    # the GEMM op names its own source
    assert measured.kernel_source_part(get_op("gemm")).startswith("src=gemm.cu@")
