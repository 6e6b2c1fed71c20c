"""k3_roofline.serve: K3's eval (LayerNorm → MLP → layer scale → residual of
every ConvNeXt block) in the traced requests: Σ bound over Σ device time,
18 launches a batch."""

from benchmark.architectures.convnext_gru import k3_launches
from benchmark.readers import roofline

PATTERNS = ("convnext_mlp", "wide_gemm")
HELPERS = ("wide_ln_kernel", "ln_rows_kernel")


def read(ctx):
    if ctx.get("c", {}).get("architecture") != "convnext_gru":
        return None
    B = ctx["c"]["batch_size"]
    return roofline(ctx, "serve", "k3_roofline.serve",
                    [(PATTERNS, HELPERS, k3_launches(ctx["c"], B, False))])
