"""What the metric files read, shared by the variants of one quantity (a
later ``gemm_roofline.<kind>`` reads as ``gemm_roofline.prompt`` does, in
its own cells).  Each function takes the run's :class:`~perfbench.context.RunContext`
and returns a number, or None where the run holds nothing to read: a
share of a roofline or of a peak is never made up as 0.  The work a
batch holds (its products, its attention's bound, its model operations)
is the architecture's (``ctx.architecture``, ``architectures/<name>.py``)."""

from __future__ import annotations

from . import work

__all__ = ["setup_s", "prompt_tok_s", "prefill_ms", "record_share", "gemm_roofline",
           "flash_roofline", "mfu", "idle_share"]


def setup_s(ctx):
    return ctx.setup_s


def prompt_tok_s(ctx):
    """Real prompt tokens of the window's requests over the window."""
    return sum(int(b.lens.sum()) for b in ctx.batches) / ctx.window_s


def prefill_ms(ctx):
    """The engine's prefill time (its host clock, closed by a sync), a batch."""
    return 1e3 * sum(b.prefill_s for b in ctx.batches) / len(ctx.batches)


def record_share(ctx):
    """Of the window's eager GEMM dispatches (prefill; a graph replay
    dispatches nothing), the share a tuned record drove, in %."""
    g = ctx.dispatch.get("gemm", {})
    total = sum(g.get(k, 0) for k in ("records", "heuristic", "explicit", "matmul"))
    return 100.0 * g.get("records", 0) / total if total else None


def gemm_roofline(ctx):
    """The least time of the traced batches' dense products over the
    device time of the GEMM kernel (``gemm_tiled*``), in %."""
    t = ctx.trace.device_s("gemm_tiled") if ctx.trace else 0.0
    if t <= 0:
        return None
    arch = ctx.architecture
    bound = sum(work.product_bound_s(*p)
                for b in ctx.traced_batches()
                for p in arch.served_products(ctx.config, len(b.lens), ctx.mix.bucket, b.gen))
    return 100.0 * bound / t


def flash_roofline(ctx):
    """The least time of the traced prefills' causal attention over the
    real lengths, over the device time of the flash kernel (``flash_fwd*``),
    in %."""
    t = ctx.trace.device_s("flash_fwd") if ctx.trace else 0.0
    if t <= 0:
        return None
    bound = sum(ctx.architecture.attention_bound_s(ctx.config, int(n))
                for b in ctx.traced_batches() for n in b.lens)
    return 100.0 * bound / t


def mfu(ctx):
    """Model operations of the window's requests over the window's
    seconds at the bf16 peak, in %."""
    flops = sum(ctx.architecture.request_model_flops(ctx.config, int(n), b.gen)
                for b in ctx.batches for n in b.lens)
    return 100.0 * flops / (ctx.window_s * work.PEAK_FLOPS_BF16)


def idle_share(ctx):
    """The share of the traced window in which no operation ran on the
    device, in %."""
    if not ctx.trace or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
