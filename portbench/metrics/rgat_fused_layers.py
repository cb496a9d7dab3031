"""rgat_fused_layers (layer: model step): RGAT layers a step that took the
pair-attention route (B8, B3, B9), from the program's counter
``rgat.route.pair_attention`` (``tf2_gnn_tpu_torch/utils/tracing.py``),
counted at every RGAT layer's forward whether tracing is on or off, over
every step the process ran: the set-up's, one a batch, the measured
window's and the traced window's; 0 where every layer took another
route. A program that counts no RGAT route reads nothing."""


def read(ctx):
    from tf2_gnn_tpu_torch.utils import tracing

    counters = tracing.counters("rgat.route")
    steps = len(ctx.prep_ms) + ctx.window["steps"] + (
        ctx.trace.steps if ctx.trace is not None else 0)
    if not counters or not steps:
        return None
    return counters.get("pair_attention", 0) / steps
