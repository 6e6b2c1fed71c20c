"""feed_wait_ms.serve: ms a batch that the serving loop waits in
``device_feed`` for its next batch (the port's ``vcd.feed.wait`` spans: the
producer's queue on the card), Σ over the traced requests / their
batches."""

from benchmark.readers import span_ms


def read(ctx):
    return span_ms(ctx, "serve", "vcd.feed.wait")
