"""The program's own spans (``niwqg_tpu_torch/utils/profiling.py``) as the
benchmark would read them: the set-up seconds of a group of spans on each
rank, the largest over ranks, and the host events that label the device's
idle stretches by the innermost program span.

A rank's spans are what ``profiling.spans()`` returns. No metric reads them
yet: the harness does not carry each rank's spans in its record (PERF.md
§7). ``tools/trace_cell.py`` uses these functions to print them for a run
of a cell.
"""

from __future__ import annotations

from portbench import trace

# the program's span names are ``layer.what`` under these layers
LAYERS = ("mesh", "model", "etdrk4", "runner", "shell", "cuda_build")
# trace.summarize's label of an idle stretch under no span: here, under no
# span of the program's
OUTSIDE = "no host span"
# set-up by part: (the spans, the descendants' prefix whose time is left
# out, or None)
GROUPS = {"mesh": (("mesh.init", "mesh.k2_group"), None),
          "model": (("model.init", "model.set_fields"), "mesh."),
          "capture": (("runner.first_step", "runner.capture"), "mesh.")}


def is_program(name: str) -> bool:
    return name.split(".", 1)[0] in LAYERS and "." in name


def _ancestors(recs):
    """For each span of a rank's list, its ancestors' names."""
    out = []
    for rec in recs:
        p, names = rec["parent"], []
        while p is not None:
            names.append(recs[p]["name"])
            p = recs[p]["parent"]
        out.append(names)
    return out


def setup_seconds(rank: dict, names, less: str = "mesh.") -> float:
    """Seconds of one rank's spans named in ``names`` (the outermost of
    them), less the time their descendants whose name starts with ``less``
    cover (the outermost of those); ``less=None`` subtracts nothing."""
    recs = rank["list"]
    total = 0.0
    for rec, up in zip(recs, _ancestors(recs)):
        if rec["end_ns"] is None:
            continue
        dt = 1e-9 * (rec["end_ns"] - rec["start_ns"])
        if rec["name"] in names and not set(up) & set(names):
            total += dt
        elif (less and rec["name"].startswith(less)
              and set(up) & set(names)
              and not any(u.startswith(less) for u in up)):
            total -= dt
    return total


def largest(ranks, names, less: str = "mesh."):
    """The largest over ``ranks`` (a list of ranks' spans) of
    :func:`setup_seconds`, or ``None`` where no rank recorded any of
    ``names``."""
    seen = [k for k in ranks or ()
            if any(rec["name"] in names for rec in k["list"])]
    if not seen:
        return None
    return max(setup_seconds(k, names, less) for k in seen)


def program_host(host) -> list:
    """The host events of the program's spans, and the traced window's:
    ``trace.summarize`` given these labels each idle stretch by the
    innermost program span over its midpoint (``idle_gaps``), or
    :data:`OUTSIDE` where none is open then."""
    return [h for h in host if h[0] == trace.WINDOW or is_program(h[0])]


def loop_idle_ms(r: dict):
    """Device idle a step under the run loop's spans (``shell.*`` and
    ``runner.*``), from a traced summary's ``idle_by_span``, in ms."""
    idle = r.get("idle_by_span")
    if idle is None or not r.get("steps"):
        return None
    s = sum(v for k, v in idle.items()
            if k.startswith(("shell.", "runner.")))
    return 1e3 * s / r["steps"]
