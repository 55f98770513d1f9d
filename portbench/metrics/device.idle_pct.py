"""Share of the traced window in which no operation ran on the device
(the union of the device's intervals against the window), in %."""


def read(r):
    if r["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
