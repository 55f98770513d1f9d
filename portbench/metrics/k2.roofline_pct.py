"""The exchange kernel's (K2's) least time for what one step hands it on
this rank (every kind: transposes, gathers, reflections; the census's
tally), by ``k2_bound_ms``, as a share of the device time a step spends
in K2's kernels, in %."""

from portbench.metrics.arithmetic import K2, k2_bound_ms


def read(r):
    c = r.get("census")
    s = r["families_s"].get(K2)
    if not c or not c["k2_bytes"] or not s:
        return None
    bound_ms = k2_bound_ms(c["k2_bytes"], c["cards"], c["ranks"])[0]
    return 100.0 * bound_ms / (1e3 * s / r["steps"])
