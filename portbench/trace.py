"""The traced window: ``torch.profiler`` over a stretch of the run, reduced
to one rank's summary: the device's busy time (the union of its
operations' intervals) against the window, each kernel family's device
seconds, the kernels that took most, and the device's idle stretches
labelled by what the host was doing then."""

from __future__ import annotations

import contextlib

from portbench.metrics.arithmetic import family, gaps, union_length

WINDOW = "portbench.traced_window"
TOP = 10


@contextlib.contextmanager
def traced():
    """Profile the body (host and device activity) inside a host span
    named ``WINDOW``; yields the profiler, whose events are read once the
    body is done."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield prof


def events(prof):
    """``(device, host)``: lists of ``(name, start_us, end_us)``."""
    from torch.autograd import DeviceType

    evs = prof.events()
    # a host span (record_function) is mirrored on the device's timeline
    # as an annotation: it is no device operation
    spans = {e.name for e in evs if getattr(e, "is_user_annotation", False)}
    spans.add(WINDOW)
    dev, host = [], []
    for e in evs:
        tr = e.time_range
        rec = (e.name, float(tr.start), float(tr.end))
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name in spans):
                dev.append(rec)
        elif e.device_type == DeviceType.CPU:
            host.append(rec)
    return dev, host


def summarize(dev, host, steps: int) -> dict:
    """One rank's summary of a traced window of ``steps`` steps, from its
    device and host events (``(name, start_us, end_us)``, one time base).
    The window is the host span ``WINDOW``."""
    win = [h for h in host if h[0] == WINDOW]
    if win:
        lo, hi = win[0][1], win[0][2]
    else:
        lo = min(d[1] for d in dev)
        hi = max(d[2] for d in dev)
    inside = [d for d in dev if d[2] > lo and d[1] < hi]
    busy_us = union_length([(s, e) for _, s, e in inside], lo, hi)
    fam, kern = {}, {}
    for name, s, e in inside:
        t = (min(e, hi) - max(s, lo)) * 1e-6
        f = family(name)
        fam[f] = fam.get(f, 0.0) + t
        key = f"{f}: {name[:96]}"
        kern[key] = kern.get(key, 0.0) + t
    # each idle stretch by the innermost host span over its midpoint (a
    # sweep: the stretches and the spans in order of time)
    spans = sorted((h for h in host if h[0] != WINDOW),
                   key=lambda h: h[1])
    idle, active, j = {}, [], 0
    for s, e in gaps([(a, b) for _, a, b in inside], lo, hi):
        mid = 0.5 * (s + e)
        while j < len(spans) and spans[j][1] <= mid:
            active.append(spans[j])
            j += 1
        active = [h for h in active if h[2] >= mid]
        label = (min(active, key=lambda h: h[2] - h[1])[0] if active
                 else "no host span")
        idle[label] = idle.get(label, 0.0) + (e - s) * 1e-6
    top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                           key=lambda kv: -kv[1])[:TOP]
    return {
        "steps": int(steps),
        "window_s": (hi - lo) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "families_s": fam,
        "device_ops": top(kern),
        "idle_gaps": top(idle),
    }
