"""emit_ms.serve: ms a batch that the host spends making the result dicts,
its wait for the card left out (the port's ``vcd.serve.emit`` spans less
the ``vcd.serve.result_wait`` spans inside them), Σ over the traced
requests / their batches."""

from benchmark.readers import span_ms


def read(ctx):
    emit = span_ms(ctx, "serve", "vcd.serve.emit")
    if emit is None:
        return None
    return emit - (span_ms(ctx, "serve", "vcd.serve.result_wait") or 0.0)
