"""mamba.conv_ms.prompt: the device ms a traced batch of the Mamba-2 layers' causal conv (kernels launched under the span ``mamba.conv``: the depthwise conv over the sequence, its bias and SiLU, in prefill)."""

from perfbench.spans import device_ms

__all__ = ["read"]


def read(ctx):
    return device_ms(ctx, "mamba.conv")
