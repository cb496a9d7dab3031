"""batch_prep_ms (layer: data): the mean host ms, over the set-up's
batches, to pack, pad and plan one batch through the port's data layer
and move it to the device (synchronised)."""
import statistics


def read(ctx):
    return statistics.fmean(ctx.prep_ms) if ctx.prep_ms else None
