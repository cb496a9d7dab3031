"""attn_roofline (layer: kernels): the least time a step's attention
kernels need, forward and backward over every layer, over their device
time in the traced window, in %.

The least time is the larger of the bytes over the card's HBM bandwidth
and the operations over its float32 rate (the reference module's
``aggregation_bytes`` and ``aggregation_flops``, counted as the port's
kernel bounds count B8, B3 and B9). The device time is
``attn_device_ms``'s: B8, B3, B9 and B9's second pass, one roofline for
the three kernels. A window in which none of them ran reads nothing."""
from pathlib import Path

from portbench import load_module

_device = load_module(Path(__file__).with_name("attn_device_ms.py"),
                      "portbench_metric_attn_device_ms_kernels")


def read(ctx):
    if ctx.trace is None:
        return None
    hbm = ctx.peak("hbm_bytes_per_s")
    f32 = ctx.peak("f32_flops_per_s")
    if hbm is None or f32 is None:
        return None
    device_ms = ctx.trace.device_ms_per_step(_device.is_attention)
    if device_ms <= 0:
        return None
    bound_ms = max(ctx.aggregation_bytes_per_step / hbm,
                   ctx.aggregation_flops_per_step / f32) * 1e3
    return 100.0 * bound_ms / device_ms
