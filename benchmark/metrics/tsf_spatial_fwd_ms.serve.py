"""tsf_spatial_fwd_ms.serve: ms a batch of device time launched inside the
port's ``vcd.tsf.spatial`` spans (each block's spatial attention: the CLS
token's copies, LayerNorm, projections, K4, out projection, the CLS
mean), Σ over the traced requests / their batches."""

from benchmark.readers import span_device_ms


def read(ctx):
    return span_device_ms(ctx, "serve", "vcd.tsf.spatial")
