"""k2_roofline.serve: K2's forward (the depthwise 7×7 of every ConvNeXt
block) in the traced requests: Σ bound over Σ device time of its launches,
18 a batch at the flagship's stage shapes."""

from benchmark.architectures.convnext_gru import k2_launches
from benchmark.readers import roofline

PATTERNS = ("dwconv7x7",)


def read(ctx):
    if ctx.get("c", {}).get("architecture") != "convnext_gru":
        return None
    B = ctx["c"]["batch_size"]
    return roofline(ctx, "serve", "k2_roofline.serve",
                    [(PATTERNS, (), k2_launches(ctx["c"], B, False))])
