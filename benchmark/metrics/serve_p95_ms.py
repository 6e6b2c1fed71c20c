"""serve_p95_ms: the 95th percentile of the latency of every request of the
window, from the call to the moment its result dicts exist on the host
(host clock; numpy's linear interpolation)."""

import numpy as np


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["latencies_s"]:
        return None
    return float(np.percentile(ctx["latencies_s"], 95)) * 1e3
