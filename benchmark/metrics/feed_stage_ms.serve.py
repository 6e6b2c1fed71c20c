"""feed_stage_ms.serve: ms a batch that ``device_feed``'s producer thread
spends in ``stage`` (the slot's last-copy wait, the pinned allocations, the
copy into pinned memory, the copy's issue), from the feed's counters over
every batch the run served: set-up's requests, the window's and the traced
ones. The harness's slice counters do not hold the feed's."""

from benchmark.harness import feed_counters


def read(ctx):
    f = feed_counters()
    if ctx.get("kind") != "serve" or f is None or not f["batches"]:
        return None
    return f["stage_ns"] / f["batches"] * 1e-6
