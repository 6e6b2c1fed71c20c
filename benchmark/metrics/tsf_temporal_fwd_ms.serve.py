"""tsf_temporal_fwd_ms.serve: ms a batch of device time launched inside
the port's ``vcd.tsf.temporal`` spans (each block's temporal attention:
LayerNorm, projections, K4, out projection, ``temporal_fc``), Σ over the
traced requests / their batches."""

from benchmark.readers import span_device_ms


def read(ctx):
    return span_device_ms(ctx, "serve", "vcd.tsf.temporal")
