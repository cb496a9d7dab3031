"""train_mfu (layer: model step): model FLOPs of the measured window's
steps over the window's seconds times the card's dense bf16 peak, in %.

The FLOPs are the configuration's reference module's ``model_flops``
(2 M K N a dense product forward, three times that with the backward, 2
edges hidden an aggregation each way), whatever precision the program
runs in; the peak is ``peaks.json``'s for the card."""


def read(ctx):
    flops_per_s = ctx.peak("bf16_dense_flops_per_s")
    if flops_per_s is None or not ctx.window["steps"]:
        return None
    done = ctx.flops_per_step * ctx.window["steps"]
    return 100.0 * done / (ctx.window["window_s"] * flops_per_s)
