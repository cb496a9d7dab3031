"""attn_device_ms (layer: kernels): device ms a step in the port's
hand-written attention kernels of the traced window: B8
(``expd_rows_kernel``), B3 and B9's second pass (``row_owner_kernel``,
which no other kernel of an RGAT cell's step is) and B9
(``bwd_rows_kernel``, or ``bwd_rows_tiled_kernel`` for rows wider than
its registers hold). A window in which none of them ran reads
nothing."""

KERNELS = ("expd_rows_kernel", "row_owner_kernel", "bwd_rows_kernel",
           "bwd_rows_tiled_kernel")


def is_attention(name: str) -> bool:
    return any(k in name for k in KERNELS)


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.device_ms_per_step(is_attention)
    return ms if ms > 0 else None
