"""preprocess_ms.train: ms a step of device time that the training
preprocess launches (kernels, copies and memsets whose launch lies inside
the port's ``vcd.train.preprocess`` spans, matched by the trace's
correlation ids), Σ over the traced epoch / its steps."""

from benchmark.readers import span_device_ms


def read(ctx):
    return span_device_ms(ctx, "train", "vcd.train.preprocess")
