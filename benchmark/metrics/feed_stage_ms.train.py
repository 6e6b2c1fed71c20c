"""feed_stage_ms.train: ms a batch that ``device_feed``'s producer thread
spends in ``stage``, from the feed's counters over every batch the run
trained on: set-up's epoch, the window's and the traced one."""

from benchmark.harness import feed_counters


def read(ctx):
    f = feed_counters()
    if ctx.get("kind") != "train" or f is None or not f["batches"]:
        return None
    return f["stage_ns"] / f["batches"] * 1e-6
