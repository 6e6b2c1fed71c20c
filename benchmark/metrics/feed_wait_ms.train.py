"""feed_wait_ms.train: ms a step that the training loop waits in
``device_feed`` for its next batch (the port's ``vcd.feed.wait`` spans), Σ
over the traced epoch / its steps."""

from benchmark.readers import span_ms


def read(ctx):
    return span_ms(ctx, "train", "vcd.feed.wait")
