"""Device ms a step in the elementwise and reduction kernels (every kernel
that is not a transform, an exchange, a GEMM or a copy)."""

from portbench.metrics.arithmetic import OTHER


def read(r):
    s = r["families_s"].get(OTHER)
    return None if s is None else 1e3 * s / r["steps"]
