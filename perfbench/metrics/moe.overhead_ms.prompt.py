"""moe.overhead_ms.prompt: the device ms a traced prefill of the MoE's passes around its experts (kernels launched under the spans ``moe.route``, ``moe.dispatch`` and ``moe.combine``)."""

from perfbench.spans import device_ms

__all__ = ["read"]


def read(ctx):
    return device_ms(ctx, "moe.route", "moe.dispatch", "moe.combine")
