"""k4_divided_roofline.serve: K4's forward launches in the traced requests
of a TimeSformer (two a block a batch: the temporal attention, S = the
frames, and the spatial, S = the patches and the CLS token): Σ bound over
Σ device time, both shapes together."""

from benchmark.architectures.timesformer import k4_launches
from benchmark.readers import roofline


def read(ctx):
    c = ctx.get("c", {})
    if c.get("architecture") != "timesformer":
        return None
    return roofline(ctx, "serve", "k4_divided_roofline.serve", [
        (("flash_fwd",), (), k4_launches(c, c["batch_size"], False)["fwd"])])
