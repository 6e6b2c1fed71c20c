"""setup_s: seconds from the process's start to the first timed request or
step: imports, loading the kernel library, the weights and the clip pool
from the seed, and the warm-up of the cell's own shapes (host clock)."""


def read(ctx):
    return ctx["setup_s"]
