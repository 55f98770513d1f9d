"""The least time of the step's 2-D transforms at HBM bandwidth (each
field read once and written once, from the census of one step), as a
share of the device time a step spends in the FFT kernels, in %."""

from portbench.metrics.arithmetic import FFT, PEAK_BYTES, transform_bytes


def read(r):
    c = r.get("census")
    s = r["families_s"].get(FFT)
    if not c or not c["counts"] or not s:
        return None
    nbytes = transform_bytes(c["counts"], c["nx"], c["ranks"],
                             c["itemsize"], c["half_width"])
    return 100.0 * nbytes / PEAK_BYTES / (s / r["steps"])
