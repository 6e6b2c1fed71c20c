"""device_idle.train: 1 − (union of the device's busy intervals) / (wall
time) of the traced epoch, in %."""

from benchmark.readers import idle


def read(ctx):
    return idle(ctx, "train")
