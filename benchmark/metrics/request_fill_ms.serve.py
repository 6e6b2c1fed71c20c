"""request_fill_ms.serve: the mean, over the traced requests, of the time
from a request's start (the benchmark's span) to the first device activity
after it: the loader's pool, the feed's pinned buffers and the first
batch's fetch and copy before the card has work."""


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("slice", {}).get("fills"):
        return None
    fills = ctx["slice"]["fills"]
    return 1e3 * sum(fills) / len(fills)
