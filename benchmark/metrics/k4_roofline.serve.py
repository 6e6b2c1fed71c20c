"""k4_roofline.serve: K4's forward (flash self-attention of the ViViT's
spatial blocks) in the traced requests: Σ bound over Σ device time, one
launch a spatial block a batch."""

from benchmark.architectures.vivit import k4_launches
from benchmark.readers import roofline

PATTERNS = ("flash_fwd",)


def read(ctx):
    if ctx.get("c", {}).get("architecture") != "vivit":
        return None
    B = ctx["c"]["batch_size"]
    return roofline(ctx, "serve", "k4_roofline.serve",
                    [(PATTERNS, (), k4_launches(ctx["c"], B, False))])
