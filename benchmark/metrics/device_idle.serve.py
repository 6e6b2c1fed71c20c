"""device_idle.serve: 1 − (union of the device's busy intervals) / (wall
time) of the traced requests, in %."""

from benchmark.readers import idle


def read(ctx):
    return idle(ctx, "serve")
