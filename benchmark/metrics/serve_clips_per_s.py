"""serve_clips_per_s: clips whose results came back within the window, over
the window's whole time (host clock)."""

from benchmark.readers import rate


def read(ctx):
    return rate(ctx, "serve")
