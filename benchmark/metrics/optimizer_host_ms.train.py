"""optimizer_host_ms.train: ms a step that the host spends in the optimizer
phase (the port's ``vcd.train.optimizer`` spans: the missing-gradient
check, the gradient's norm and clip, AdamW's update), Σ over the traced
epoch / its steps."""

from benchmark.readers import span_ms


def read(ctx):
    return span_ms(ctx, "train", "vcd.train.optimizer")
