"""step_dispatch_ms (layer: harness): the mean host ms of one
``make_train_step`` call in the measured window, timed by the benchmark's
host clock around each call without a synchronise. It includes any wait
for a full launch queue."""


def read(ctx):
    return ctx.window["dispatch_ms"]
