"""agg_roofline (layer: kernels): the least time a step's aggregations
need, forward and backward over every layer, over the device time of the
port's hand-written aggregation kernels in the traced window, in %.

The least time is the larger of the bytes over the card's HBM bandwidth
and the operations over its float32 rate (the reference module's
``aggregation_bytes`` and ``aggregation_flops``: distinct rows read,
valid edges, row pointers and the float32 output written once). The
kernels are the row owners of ``csrc/pair_stream.cu`` (K1 and K2). A
window in which none of them ran reads nothing."""

KERNELS = ("row_owner_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    hbm = ctx.peak("hbm_bytes_per_s")
    f32 = ctx.peak("f32_flops_per_s")
    if hbm is None:
        return None
    device_ms = ctx.trace.device_ms_per_step(
        lambda name: any(k in name for k in KERNELS))
    if device_ms <= 0:
        return None
    bound_ms = max(ctx.aggregation_bytes_per_step / hbm,
                   ctx.aggregation_flops_per_step / f32) * 1e3
    return 100.0 * bound_ms / device_ms
