"""dense_pass_ms: device ms a search of every operation in the traced
window that is not one of the port's hand-written kernels (the
``__global__`` functions of ``csrc/``): PyTorch's generic passes of the
level loop, the 2D steps, the fold and the frontier, copies and fills."""
from bench.devtrace import matcher


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    port = matcher(run.port_kernels)
    ms = run.trace.seconds(lambda n: not port(n)) * 1e3
    return ms / run.trace.searches
