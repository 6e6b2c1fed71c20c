"""k2_roofline.train: K2's forward and dx launches (36 a step) and its
weight gradient (18 a step, with its kernel that adds the partial sums) in
the traced epoch: Σ bound over Σ device time."""

from benchmark.architectures.convnext_gru import k2_launches, k2_wgrad_launches
from benchmark.readers import roofline

FWD = ("dwconv7x7",)
WGRAD = ("dwconv_wgrad",)
WGRAD_HELPERS = ("wgrad_hopper_sum_parts", "wgrad_sum_parts")


def read(ctx):
    if ctx.get("c", {}).get("architecture") != "convnext_gru":
        return None
    c, B = ctx["c"], ctx["c"]["batch_size"]
    return roofline(ctx, "train", "k2_roofline.train", [
        (FWD, (), k2_launches(c, B, True)),
        (WGRAD, WGRAD_HELPERS, k2_wgrad_launches(c, B))])
