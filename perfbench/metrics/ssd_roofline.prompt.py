"""ssd_roofline.prompt: the traced prefills' SSD over the real lengths at its bound (the architecture's ``ssd_bound_s``) over the device time under the span ``mamba.ssd``, in %."""

from perfbench.spans import device_ms

__all__ = ["read"]


def read(ctx):
    ms = device_ms(ctx, "mamba.ssd")
    if not ms:
        return None
    traced = ctx.traced_batches()
    bound_s = sum(ctx.architecture.ssd_bound_s(ctx.config, int(n))
                  for b in traced for n in b.lens) / len(traced)
    return 100.0 * 1e3 * bound_s / ms
