"""The comparison that decides ``correct``.

Two segments of a run are held to the plain reference
(``portbench/reference``), each over one stretch of ``yield_every``
steps that the run itself took:

- ``start``: the first stretch of the run, from the seed's initial fields,
  which set-up drives through the window's own entry
  (``run_with_snapshots``) on the same model; the reference follows it
  from the same initial fields;
- ``end``: the last stretch of the measured window; the reference follows
  it from the program's own state at its start (its fields and its
  budget integrals), since following the whole window would take longer
  than the window.

For each the numbers are: per prognostic field, the largest difference
between the program's field and the reference's at the stretch's end as a
share of the reference field's largest magnitude (``<field>_<segment>``);
and over the diagnostics the configuration names, each series' largest
difference over the stretch's samples as a share of the reference
series' largest magnitude, of which the largest (``diag_<segment>``).
A number that is not finite fails."""

from __future__ import annotations

import math

import numpy as np


def rel_max(prog, ref) -> float:
    prog = np.asarray(prog)
    ref = np.asarray(ref)
    if prog.shape != ref.shape:
        return math.inf
    scale = float(np.abs(ref).max())
    err = float(np.abs(prog - ref).max())
    if not (math.isfinite(err) and math.isfinite(scale)) or scale == 0:
        return math.inf
    return err / scale


def segment_numbers(segment: str, prog_fields: dict, ref_fields: dict,
                    prog_series: dict, ref_series: dict, diags) -> tuple:
    """``(numbers, detail)``: the segment's compared numbers, and every
    diagnostic's own reading."""
    nums = {f"{k}_{segment}": rel_max(prog_fields[k], ref_fields[k])
            for k in ref_fields}
    detail = {k: rel_max(prog_series[k], ref_series[k]) for k in diags}
    nums[f"diag_{segment}"] = max(detail.values(), default=math.inf)
    return nums, detail


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: ``checks`` pairs every number with its
    limit; ``correct`` holds when every number is finite and within it and
    every limit has its number."""
    checks = {k: {"value": numbers.get(k, math.inf), "limit": limits[k]}
              for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
