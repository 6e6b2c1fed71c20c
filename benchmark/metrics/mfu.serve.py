"""mfu.serve: the forward's FLOPs for the window's clips (counted from the
shapes, ``counts.clip_flops``), over the window's time, as a share of the
H100's 989 TFLOP/s bf16 peak."""

from benchmark.readers import mfu


def read(ctx):
    return mfu(ctx, "serve")
