"""k4_roofline.train: K4's forward, di, dK/dV and dQ launches (one each a
spatial block a step) in the traced epoch: Σ bound over Σ device time."""

from benchmark.architectures.vivit import k4_launches
from benchmark.readers import roofline


def read(ctx):
    c = ctx.get("c", {})
    if c.get("architecture") != "vivit":
        return None
    L = c["spatial_layers"]
    launches = k4_launches(c, c["batch_size"], True)
    return roofline(ctx, "train", "k4_roofline.train", [
        (("flash_fwd",), (), launches[:L]),
        (("flash_bwd_di",), (), launches[L:2 * L]),
        (("flash_bwd_dkv",), (), launches[2 * L:3 * L]),
        (("flash_bwd_dq",), (), launches[3 * L:])])
