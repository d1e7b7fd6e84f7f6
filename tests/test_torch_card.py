"""The port's kernels on the card, held against their plain PyTorch
versions.  Every test here is marked ``gpu`` and skips where there is no
card.  The file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch built for CUDA:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_card.py
"""

import collections

import pytest
import torch

from repro_torch.core.analysis import (
    FLASH_HEAD_DIMS,
    GEMM_BW_BN,
    GEMM_WG_INSTANCES,
    flash_max_threads,
    flash_smem_bytes,
    flash_stages,
    gemm_bf16_max_threads,
    gemm_smem_bytes,
    gemm_stages,
    gemm_wgmma_threads,
    max_threads_for_reg_tile,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


#: configs per case: the SIMT kernel in f32 (every register tile, one stage
#: and a ring); in bf16 the wgmma kernel (one and two warpgroups, both slab
#: depths) and, at M = 8, the bandwidth kernel
GEMM_CASES = {
    "float32": (torch.float32, (256, 2048, 256),
                (gemm.KernelConfig(128, 32, 128, 32, 64, 8, 8),
                 gemm.KernelConfig(32, 64, 32, 0, 0, 1, 1)) + tuple(gemm.simt_ring_configs())),
    # N = 2 (mod 4): B's rows by 4-byte copies; bk = 12: A in runs of 4 k
    "float32-odd": (torch.float32, (64, 96, 1010),
                    (gemm.KernelConfig(32, 8, 10, 32, 10, 1, 2),
                     gemm.KernelConfig(32, 12, 10, 16, 10, 2, 1))),
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
@pytest.mark.parametrize("case,tol", [("float32", (1e-4, 8e-4)), ("float32-odd", (1e-4, 8e-4)),
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
def test_f32_ring_matches_the_analyzer():
    """The ring the SIMT kernel launches (stages, shared-memory bytes)
    equals ``analysis.gemm_stages`` / ``gemm_smem_bytes``: one stage at a
    slab that fits once, four where many fit, none over the budget."""
    _card()
    tiles = [(c.block_m, c.block_k, c.block_n) for c in gemm.simt_ring_configs()]
    tiles += [(128, 64, 128), (8, 1024, 8), (10, 8, 16), (16, 1024, 40), (512, 128, 512)]
    for tile in tiles:
        stages = gemm_stages(*tile, 4)
        assert gemm.kernel_f32_ring(*tile) == (stages, gemm_smem_bytes(*tile, 4) if stages else 0)
    assert {gemm_stages(*t, 4) for t in tiles} == {0, 1, 2, 3, 4}


WGMMA_CONFIGS = gemm.wgmma_configs()
#: the benchmark's prefill products (8 x 4096 tokens): qwen2-72b's q and o,
#: k and v, the FFN's gate and up, its down; qwen3-moe's q and o
WGMMA_SERVED = [(32768, 8192, 8192), (32768, 8192, 1024), (32768, 8192, 29568),
                (32768, 29568, 8192), (32768, 4096, 8192), (32768, 8192, 4096)]


@pytest.mark.gpu
def test_wgmma_ring_matches_the_analyzer():
    """The ring and threads the wgmma kernel launches each tile with
    (``repro_gemm_wgmma_ring``) equal ``analysis.gemm_stages``,
    ``gemm_wgmma_threads`` and ``gemm_smem_bytes``: the consumers and the
    producer, up to 8 stages."""
    _card()
    for cfg in WGMMA_CONFIGS:
        bm, bk, bn, sm, sn = cfg.block_m, cfg.block_k, cfg.block_n, cfg.sub_m, cfg.sub_n
        assert gemm.kernel_wgmma_ring(cfg) == (
            gemm_stages(bm, bk, bn), gemm_wgmma_threads(bm, bn, sm, sn),
            gemm_smem_bytes(bm, bk, bn))
    assert {gemm.kernel_wgmma_ring(c)[1] for c in WGMMA_CONFIGS} == {256, 384}
    assert max(gemm.kernel_wgmma_ring(c)[0] for c in WGMMA_CONFIGS) == 8


@pytest.mark.gpu
@pytest.mark.parametrize("dims", WGMMA_SERVED + ["short"], ids=str)
def test_every_wgmma_instantiation_matches_plain_on_card(dims):
    """Every instantiation, with one and two consumer warpgroups, against
    the plain version: at the served shapes (each tile that divides
    them), and on short products of one slab and of fewer slabs than the
    ring's stages (the producer never waits on a stage, and the
    consumers' last release comes before the ring is full)."""
    gen = _card()

    def launchable(cfgs, mkn):
        out = []
        for cfg in cfgs:
            try:
                cfg.validate(*mkn, 2)
            except ValueError:  # e.g. a 64 x 128 x 512 tile: one stage fits
                continue
            out.append(cfg)
        return out

    cases = []
    if dims == "short":
        for cfg in WGMMA_CONFIGS:
            stages = gemm_stages(cfg.block_m, cfg.block_k, cfg.block_n)
            for n_k in sorted({1, 2, stages - 1}):
                mkn = (2 * cfg.block_m, n_k * cfg.block_k, 2 * cfg.block_n)
                if launchable([cfg], mkn):
                    cases.append((mkn, [cfg]))
        n_ks = {(k // c[0].block_k, gemm_stages(c[0].block_m, c[0].block_k, c[0].block_n))
                for (_, k, _), c in cases}
        assert len({c[0] for _, c in cases}) >= 25
        assert any(n == 1 for n, _ in n_ks) and any(1 < n < s for n, s in n_ks)
    else:
        cfgs = launchable(WGMMA_CONFIGS, dims)
        assert len(cfgs) >= 10
        cases.append((dims, cfgs))
    for (m, k, n), cfgs in cases:
        a = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        b = torch.randn(k, n, generator=gen, device="cuda").to(torch.bfloat16)
        rtol, atol = gemm.bf16_gemm_tol(k)
        for bk in sorted({c.block_k for c in cfgs}):
            ref = gemm.gemm_plain(a, b, gemm.KernelConfig(64, bk, 64)).float()
            for cfg in (c for c in cfgs if c.block_k == bk):
                before = gemm.LAUNCHES[(m, k, n)]
                out = gemm.gemm_tiled(a, b, cfg)
                torch.cuda.synchronize()
                assert gemm.LAUNCHES[(m, k, n)] == before + 1
                torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol,
                                           msg=lambda s, cfg=cfg: f"{cfg} {(m, k, n)}: {s}")
            del ref


@pytest.mark.gpu
def test_gemm_refuses_unaligned_bf16_operands_on_card():
    _card()
    buf = torch.zeros(64 * 64 + 8, device="cuda").bfloat16()
    a = buf[1:64 * 64 + 1].view(64, 64)
    before = sum(gemm.LAUNCHES.values())
    with pytest.raises(ValueError, match="16-byte"):
        gemm.gemm_tiled(a, a.clone(), gemm.KernelConfig(64, 64, 64, 64, 64))
    assert sum(gemm.LAUNCHES.values()) == before


#: (G, causal, (block_q, block_kv), seq) per dtype: the bf16 kernel takes
#: whole 64-row warpgroups and up to 128 keys a block, the f32 one block_q
#: in multiples of 16 and block_kv 16, 32 or 64 (two ring stages, or one at
#: 128 x 64 and hd 128); the f32 case at S = 4096 runs at hd 128 only
FLASH_CASES = {
    torch.bfloat16: ((1, True, (64, 16), 256), (4, True, (128, 32), 256),
                     (8, False, (64, 128), 256), (8, True, (128, 128), 256)),
    torch.float32: ((1, True, (16, 16), 256), (4, True, (64, 32), 256),
                    (8, False, (32, 64), 256), (8, True, (64, 64), 256),
                    (4, True, (128, 64), 256), (8, True, (64, 64), 4096)),
}


@pytest.mark.gpu
# bf16: two rounding steps, as chip_smoke.py states (kernel and plain
# version round P and the output at the same places)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (2e-5, 8e-5)),
                                       (torch.bfloat16, (1.6e-2, 2e-3))])
@pytest.mark.parametrize("hd", FLASH_HEAD_DIMS)
def test_flash_kernel_matches_plain_on_card(dtype, tol, hd):
    gen = _card()
    for g, causal, (bq, bkv), seq in FLASH_CASES[dtype]:
        if seq > 256 and hd != 128:
            continue
        q = torch.randn(2, seq, 2 * g, hd, generator=gen, device="cuda").to(dtype)
        k = torch.randn(2, seq, 2, hd, generator=gen, device="cuda").to(dtype)
        v = torch.randn(2, seq, 2, hd, generator=gen, device="cuda").to(dtype)
        before = fa.LAUNCHES[(seq, seq, hd)]
        before_dtype = fa.DTYPE_LAUNCHES[str(dtype).removeprefix("torch.")]
        out = fa.flash_attention(q, k, v, bq, bkv, causal)
        torch.cuda.synchronize()
        assert fa.LAUNCHES[(seq, seq, hd)] == before + 1
        assert fa.DTYPE_LAUNCHES[str(dtype).removeprefix("torch.")] == before_dtype + 1
        torch.testing.assert_close(out.float(),
                                   fa.flash_attention_plain(q, k, v, bq, bkv, causal).float(),
                                   rtol=tol[0], atol=tol[1])


@pytest.mark.gpu
def test_flash_launch_limits_match_the_analyzer():
    _card()
    for dtype in (torch.float32, torch.bfloat16):
        for hd in FLASH_HEAD_DIMS:
            assert fa.kernel_max_threads(dtype, hd) == flash_max_threads(hd, dtype.itemsize)
    # the f32 K/V ring: two stages, one (128 x 64 at hd 128), and none
    for bq, bkv, hd in ((64, 64, 128), (128, 32, 128), (128, 64, 128), (256, 64, 32),
                        (16, 16, 16), (512, 64, 128)):
        stages = flash_stages(bq, bkv, hd, 4)
        assert fa.kernel_f32_ring(bq, bkv, hd) == (
            stages, flash_smem_bytes(bq, bkv, hd, 4) if stages else 0)
    assert {flash_stages(128, 64, 128, 4), flash_stages(512, 64, 128, 4)} == {0, 1}


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


def _timed_gemm(dims=(512, 256, 512)):
    """A measured bf16 GEMM backend, its heuristic state and launchable
    neighbours of it, and a state no kernel takes (the untiled start)."""
    from repro_torch.core import GemmConfigSpace, HopperTimedCost
    from repro_torch.kernels.gemm import default_config, state_from_config

    space = GemmConfigSpace(*dims)
    cost = HopperTimedCost(space, dtype="bfloat16")
    good = state_from_config(default_config(*dims), *dims)
    near = [s for s in space.neighbors(good) if not cost.analyzer.analyze(s).illegal]
    return cost, [good] + near, space.initial_state()


@pytest.mark.gpu
def test_timed_cost_rebuilt_from_its_spec_in_a_worker_process():
    """``HopperTimedCost.worker_spec()`` rebuilds the backend in a worker
    process with its own CUDA context: a launchable state gets a finite
    time, a refused one ``inf`` without an error."""
    import math

    from repro_torch.core import MeasureEngine, ProcessExecutor

    _card()
    cost, launchable, refused = _timed_gemm()
    with ProcessExecutor(timeout_s=120.0) as ex:
        ex.warm_up(2, backend=cost)
        out = MeasureEngine(cost, n_workers=2, executor=ex).measure_wave(
            [launchable[0], refused])
        mem = ex.worker_call("repro_torch.core.cost.measured:worker_stats")
    assert out[0].error is None and 0 < out[0].cost < 1.0
    assert math.isinf(out[1].cost) and out[1].error is None
    assert len(mem) == 2 and all(m["peak_allocated"] > 0 for m in mem)


@pytest.mark.gpu
def test_process_lanes_never_hold_the_card_gate_at_once():
    """Two worker processes time kernels on one card: every timed region
    takes the card's one gate, and the gate never finds a second holder
    inside."""
    from repro_torch.core import MeasureEngine, ProcessExecutor

    _card()
    cost, launchable, _ = _timed_gemm((2048, 2048, 2048))
    states = launchable[:8]
    before = cost.gate.stats()
    with ProcessExecutor(timeout_s=120.0) as ex:
        ex.warm_up(2, backend=cost)
        eng = MeasureEngine(cost, n_workers=2, executor=ex)
        for i in range(0, len(states), 2):
            eng.measure_wave(states[i : i + 2])
    after = cost.gate.stats()
    assert len(states) >= 4 and eng.stats.n_failures == 0
    assert after["entries"] - before["entries"] == len(states)
    assert after["overlaps"] == before["overlaps"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["yi-6b", "qwen3-moe-235b-a22b", "whisper-tiny",
                                  "mamba2-130m", "zamba2-1.2b"])
def test_graphed_decode_equals_the_eager_loop_on_card(name):
    """The engine's decode, replayed from its CUDA graph, gives the tokens
    of the eager loop on the same card; a second request in the same
    buckets captures nothing and replays once more."""
    _card()
    import numpy as np

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models.api import Model

    cfg = get_arch(name).reduced()
    model = Model(cfg, device="cuda")
    params = model.init_params(seed=0)
    engine = ServeEngine(cfg, params, max_batch=8, max_len=144, prompt_buckets=[128],
                         gen_buckets=[8], device="cuda")
    assert engine.cache_report()["captures"] == 1
    rng = np.random.default_rng(0)
    for call, width in enumerate((112, 96)):
        lens = rng.integers(width // 2, width + 1, 8)  # ragged, in every family
        lens[0] = width
        prompts = np.zeros((8, width), np.int64)
        for i, n in enumerate(lens):
            prompts[i, :n] = rng.integers(0, cfg.vocab_size, n)
        out = engine.generate(prompts, 8, prompt_lens=lens)
        np.testing.assert_array_equal(out, engine.eager_reference(prompts, 8, prompt_lens=lens))
        rep = engine.cache_report()
        assert (rep["captures"], rep["replays"]) == (1, call + 1)
    # a replay launches what its capture recorded; the warm-up ran it once
    launched = engine.launch_report()
    assert any(kernel == "gemm" for kernel, _ in launched["captured"])
    assert launched["warmup"] == launched["captured"]
    assert launched["replayed"] == {key: 2 * n for key, n in launched["captured"].items()}


@pytest.mark.gpu
def test_spans_on_card_time_set_up_and_put_replayed_kernels_under_decode():
    """``kernels.load`` and ``engine.capture`` are timed on the card; a
    ``generate`` under the profiler gives the untraced call's tokens; the
    benchmark's span reader (``perfbench/spans.py``) puts every kernel of
    the traced call under the engine's spans, each kernel of the decode
    graph's replay under ``serve.decode``, and the MoE's passes under
    ``block.moe``."""
    _card()
    import numpy as np
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench.spans import OUTSIDE, attribute, kineto_ops
    from perfbench.trace import TRACED_RANGE
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.build import build_library
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models.api import Model
    from repro_torch.utils.spans import reset_span_totals, span_totals

    reset_span_totals()
    build_library("gemm.cu")
    cfg = get_arch("qwen3-moe-235b-a22b").reduced()
    params = Model(cfg, device="cuda").init_params(seed=0)
    engine = ServeEngine(cfg, params, max_batch=8, max_len=144, prompt_buckets=[128],
                         gen_buckets=[8], device="cuda")
    totals = span_totals()
    assert totals["kernels.load"] > 0 and engine.prewarm_s == totals["engine.capture"] > 0
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 128))
    plain = engine.generate(prompts, 8)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(TRACED_RANGE):
            traced = engine.generate(prompts, 8)
    np.testing.assert_array_equal(traced, plain)
    ops = kineto_ops(prof)
    by = attribute(ops).by_span
    assert OUTSIDE not in by, by
    graph = {o.corr for o in ops if o.kind == "launch" and "GraphLaunch" in o.name}
    replayed = sum(o.dur_ns for o in ops if o.kind == "device" and o.corr in graph) / 1e9
    assert graph and replayed > 0
    assert by["serve.decode"] >= replayed
    parts = ("serve.request", "serve.program", "serve.prefill", "serve.decode")
    assert by["serve.generate"] == pytest.approx(sum(by.get(p, 0.0) for p in parts))
    moe = sum(by[f"moe.{p}"] for p in ("route", "dispatch", "experts", "combine"))
    assert 0.9 * by["block.moe"] <= moe <= by["block.moe"] * (1 + 1e-9)


#: forward products of yi-6b's training step at 2 x 4096 tokens (the head's
#: per 512-position loss chunk): their backward runs dA at (M, N, K) and dB
#: at (K, M, N), with K = 8192 tokens in dB
TRAIN_PRODUCTS = ((8192, 4096, 11008), (8192, 11008, 4096), (8192, 4096, 512),
                  (1024, 4096, 65536))


@pytest.mark.gpu
@pytest.mark.parametrize("dims", TRAIN_PRODUCTS)
def test_gemm_backward_matches_plain_on_card(dims):
    """``gemm``'s backward launches the kernel on dA = g Bᵀ and dB = Aᵀ g,
    each counted under its launch role, in bf16, and each is within the
    bf16 limit of the plain version under the config dispatch chose
    (rtol 1.6e-2 / atol 2e-3 x max(1, K / 4096) x max(1, K / 11008)^0.5:
    one rounding step, and wgmma's accumulation error, which grows about
    as K^1.5; ``chip_smoke.gemm_tol``)."""
    from repro_torch.kernels import ops

    gen = _card()
    m, k, n = dims
    bf16 = torch.bfloat16
    a = torch.randn(m, k, generator=gen, device="cuda").to(bf16).requires_grad_()
    b = torch.randn(k, n, generator=gen, device="cuda").to(bf16).requires_grad_()
    g = torch.randn(m, n, generator=gen, device="cuda").to(bf16)
    gemm.reset_launches()
    da, db = torch.autograd.grad(ops.gemm(a, b), [a, b], g)
    torch.cuda.synchronize()
    assert (da.dtype, db.dtype) == (bf16, bf16)
    assert gemm.ROLE_LAUNCHES[("dA", (m, n, k))] == 1
    assert gemm.ROLE_LAUNCHES[("dB", (k, m, n))] == 1
    for got, lhs, rhs in ((da, g, b.detach().t().contiguous()),
                          (db, a.detach().t().contiguous(), g)):
        cfg, _ = ops.kernel_config(lhs.shape[0], lhs.shape[1], rhs.shape[1], bf16)
        want = gemm.gemm_plain(lhs, rhs, cfg)
        depth = lhs.shape[1]
        atol = 2e-3 * max(1.0, depth / 4096) * max(1.0, depth / 11008) ** 0.5
        torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2, atol=atol)


@pytest.mark.gpu
def test_reduced_train_step_on_card_matches_the_cpu():
    """One AdamW step of the reduced yi-6b (f32) on the card, through the
    GEMM kernel in the forward, the recompute and both backward products,
    against the same step on the CPU (the plain versions): the loss and
    the gradient norm within the reduced model's logits limit, 2e-4, and
    each new param within 2e-4 plus twice the learning rate (Adam's first
    step moves a param by about lr·sign(g), which flips where |g| is
    within rounding of 0)."""
    import numpy as np

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.api import Model
    from repro_torch.optim import AdamW
    from repro_torch.train.step import make_train_step
    from repro_torch.utils.tree import tree_leaves, tree_map

    _card()
    cfg = get_arch("yi-6b").reduced()
    cpu = Model(cfg, device="cpu")
    params = cpu.init_params(seed=0)
    params_card = tree_map(lambda t: t.to("cuda"), params)
    samples = [SyntheticLM(cfg.vocab_size, 128, seed=1).sample(i) for i in range(4)]
    batch = {"tokens": torch.from_numpy(np.stack([s[0] for s in samples])).long(),
             "labels": torch.from_numpy(np.stack([s[1] for s in samples])).long()}
    out = {}
    gemm.reset_launches()
    for label, model, p in (("cpu", cpu, params), ("card", Model(cfg, device="cuda"),
                                                    params_card)):
        opt = AdamW(lr=1e-3)
        b = {k: v.to(model.device) for k, v in batch.items()}
        p, _, metrics = make_train_step(model, opt)(p, opt.init(p), b)
        out[label] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                      [t.cpu() for t in tree_leaves(p)])
    roles = {role for role, _ in gemm.ROLE_LAUNCHES}
    assert roles == {"forward", "recompute", "dA", "dB"}
    (loss, norm, p_cpu), (loss_c, norm_c, p_card) = out["cpu"], out["card"]
    assert abs(loss - loss_c) <= 2e-4 * abs(loss) and abs(norm - norm_c) <= 2e-4 * norm
    for a, b in zip(p_cpu, p_card):
        assert (b - a).abs().max().item() <= 2e-4 + 2 * 1e-3


@pytest.mark.gpu
def test_reduced_dots_step_on_card_keeps_every_block_product():
    """The reduced yi-6b (f32) on the card under remat ``dots`` and
    ``full``: the same loss and gradients within the reduced model's
    limit, 2e-4; under ``dots`` the GEMM kernel launches in no block's
    recompute (the loss head's chunks are checkpointed under every remat,
    and recompute under both), and the forward, dA and dB launches are
    ``full``'s."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.api import Model
    from repro_torch.train.step import value_and_grad
    from repro_torch.utils.tree import tree_leaves, tree_map

    _card()
    cfg = get_arch("yi-6b").reduced()
    params = tree_map(lambda t: t.to("cuda"), Model(cfg, device="cpu").init_params(seed=0))
    samples = [SyntheticLM(cfg.vocab_size, 128, seed=1).sample(i) for i in range(4)]
    batch = {"tokens": torch.from_numpy(np.stack([s[0] for s in samples])).long().cuda(),
             "labels": torch.from_numpy(np.stack([s[1] for s in samples])).long().cuda()}
    out = {}
    for remat in ("full", "dots"):
        gemm.reset_launches()
        model = Model(dataclasses.replace(cfg, remat=remat), device="cuda")
        grads, metrics = value_and_grad(model, params, batch)
        out[remat] = (float(metrics["loss"]), tree_leaves(grads),
                      collections.Counter(gemm.ROLE_LAUNCHES))
    (loss_f, g_f, roles_f), (loss_d, g_d, roles_d) = out["full"], out["dots"]
    assert abs(loss_f - loss_d) <= 2e-4 * abs(loss_f)
    for a, b in zip(g_f, g_d):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-4)
    head = cfg.padded_vocab
    assert any(r == "recompute" and d[2] != head for r, d in roles_f)
    assert not any(r == "recompute" and d[2] != head for r, d in roles_d)
    assert {k: n for k, n in roles_d.items() if k[0] != "recompute"} == {
        k: n for k, n in roles_f.items() if k[0] != "recompute"}


#: the dry run's probes at yi-6b's published widths and one layer, cut to
#: a few seconds: a train step (chunked attention under autograd), a
#: prefill above the 2048-token threshold (flash) and a decode step
DRY_CASES = {"train": (4096, 1, "train"), "prefill": (4096, 1, "prefill"),
             "decode": (4096, 8, "decode")}


def _dry_counts(kind: str, counter_cls=None):
    """One counted step of the probe on the card and its trace on meta:
    ``(card counter, meta counter, GEMM launches, flash launches, flash
    FLOPs a launch)``."""
    import collections

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.utils.op_costs import OpCounter

    seq, batch, kind = DRY_CASES[kind]
    cfg = dryrun._depth_variant(get_arch("yi-6b"), 1)
    shape = ShapeSpec(kind, seq, batch, kind)
    meta = dryrun.count_step(dryrun.make_cell(cfg, shape, "meta")["run"])
    cell = dryrun.make_cell(cfg, shape, "cuda")
    cell["run"]()
    gemm.reset_launches()
    fa.LAUNCHES.clear()
    with (counter_cls or OpCounter)() as card:
        cell["run"]()
    torch.cuda.synchronize()
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    blocks, _ = ops.flash_blocks(seq, seq, hd, torch.bfloat16, grid_y=batch * h)
    per_launch = fa.flash_work(batch, seq, seq, h, cfg.n_kv_heads, hd, *blocks, True, 2)[0]
    return (card, meta, collections.Counter(gemm.LAUNCHES), collections.Counter(fa.LAUNCHES),
            per_launch)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", list(DRY_CASES))
def test_meta_trace_counts_what_the_card_runs(kind):
    """The step's counted FLOPs and bytes, by kind, are the same on the
    card and on meta; the GEMM kernel's equal 2·M·K·N over its launches,
    flash's its launches times its grid's work."""
    _card()
    card, meta, gemm_l, flash_l, per_launch = _dry_counts(kind)
    assert (card.flops, card.bytes, card.by_kind) == (meta.flops, meta.bytes, meta.by_kind)
    assert card.by_kind["gemm_kernel"]["flops"] == sum(
        c * 2 * m * k * n for (m, k, n), c in gemm_l.items()) > 0
    assert card.by_kind["flash_kernel"]["flops"] == per_launch * sum(flash_l.values())
    assert bool(flash_l) == (kind == "prefill")


@pytest.mark.gpu
def test_count_check_refuses_a_counter_that_drops_dB():
    from repro_torch.utils.op_costs import OpCounter

    class DropsDB(OpCounter):
        def add_kernel(self, kind, dims, flops, nbytes, out):
            if getattr(gemm._ROLE, "name", "forward") != "dB":
                super().add_kernel(kind, dims, flops, nbytes, out)

    _card()
    card, meta, gemm_l, _, _ = _dry_counts("train", DropsDB)
    assert card.by_kind["gemm_kernel"]["flops"] < sum(
        c * 2 * m * k * n for (m, k, n), c in gemm_l.items())
    assert card.flops < meta.flops


@pytest.mark.gpu
def test_tune_and_run_kernel_example_runs_both_kernels_on_card():
    """``examples_torch/tune_and_run_kernel.py`` at its default device:
    both kernels launch under the tuned schedules and match their plain
    versions within the example's f32 tolerances."""
    import os
    import subprocess
    import sys

    _card()
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(root, "src")))
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "examples_torch", "tune_and_run_kernel.py")],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dispatch 1 from the record, 1 kernel launches" in proc.stdout
    assert "1 kernel launches)\nOK" in proc.stdout
    assert proc.stdout.rstrip().endswith(
        "OK: both tuned kernels match their plain versions on cuda")
