"""Device ms a step in the copy and transpose kernels."""

from portbench.metrics.arithmetic import COPIES


def read(r):
    s = r["families_s"].get(COPIES)
    return None if s is None else 1e3 * s / r["steps"]
