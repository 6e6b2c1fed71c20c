"""forward_issue_ms.serve: ms a batch that the host spends issuing the
forward (the port's ``vcd.serve.forward`` spans: the forward's launches,
the result's pinned copy and its event), Σ over the traced requests /
their batches."""

from benchmark.readers import span_ms


def read(ctx):
    return span_ms(ctx, "serve", "vcd.serve.forward")
