"""mfu.train: forward and backward FLOPs for the window's clips (no
recomputation counted), over the window's time, as a share of the H100's
989 TFLOP/s bf16 peak."""

from benchmark.readers import mfu


def read(ctx):
    return mfu(ctx, "train")
