"""feed_pinned_mib.serve: MiB of pinned host buffers a request's feed
allocates (a fresh ``device_feed`` builds its ring anew), from the feed's
counters over every request the run served: set-up's, the window's and
the traced ones."""

from benchmark.harness import feed_counters


def read(ctx):
    f = feed_counters()
    if ctx.get("kind") != "serve" or f is None or not f["feeds"]:
        return None
    return f["pinned_bytes"] / f["feeds"] / 2 ** 20
