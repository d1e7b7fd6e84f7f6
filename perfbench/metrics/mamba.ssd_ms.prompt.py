"""mamba.ssd_ms.prompt: the device ms a traced batch of the Mamba-2 layers' SSD (kernels launched under the span ``mamba.ssd``: dt, the chunked scan and the D skip, in prefill)."""

from perfbench.spans import device_ms

__all__ = ["read"]


def read(ctx):
    return device_ms(ctx, "mamba.ssd")
