"""train_clips_per_s: clips trained on over the whole time of the window's
epochs, which end in a synchronise (host clock)."""

from benchmark.readers import rate


def read(ctx):
    return rate(ctx, "train")
