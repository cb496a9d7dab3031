"""gemm_device_ms (layer: model step): device ms a step in the matrix
product kernels of the traced window, by kernel name."""

PATTERNS = ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitkreduce",
            "dot_kernel")


def is_gemm(name: str) -> bool:
    lowered = name.lower()
    return any(p in lowered for p in PATTERNS)


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.device_ms_per_step(is_gemm)
    return ms if ms > 0 else None
