"""k3_roofline.train: K3's training forward (18 a step; its backward is
stock PyTorch, not counted here) in the traced epoch: Σ bound over Σ
device time."""

from benchmark.architectures.convnext_gru import k3_launches
from benchmark.readers import roofline

PATTERNS = ("convnext_mlp", "wide_gemm")
HELPERS = ("wide_ln_kernel", "ln_rows_kernel")


def read(ctx):
    if ctx.get("c", {}).get("architecture") != "convnext_gru":
        return None
    B = ctx["c"]["batch_size"]
    return roofline(ctx, "train", "k3_roofline.train",
                    [(PATTERNS, HELPERS, k3_launches(ctx["c"], B, True))])
