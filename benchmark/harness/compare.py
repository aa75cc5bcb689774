"""The comparison that decides ``correct``: the program's answers against the
plain reference's, answer by answer, summed up in numbers that each have a
limit in the configuration's ``correct`` entry (``PERF.md`` gives the
readings each limit was set from).

An answer is a lane's pose and its iteration count.  The driver stops a lane
at the first step below the tolerances, so a step within rounding of them
may stop it one iteration earlier or later in float32 than in float64; the
reference therefore keeps its poses one iteration before and after its own
stop, and each answer is held against the reference's pose after as many
iterations as the answer reports.  An answer more than one iteration away
from the reference's count has an infinite gap.

A few lanes in a thousand are chaotic in float32: a rounding at a tie of the
trim or the correspondence sends them down another path, and they end
centimetres away (``PERF.md`` shows such lanes with a second witness, the
reference itself computed in float32).  So no number is a widest gap; the
numbers are:

* ``translation_gap_q50_m``, ``translation_gap_q90_m``: the 50th and 90th
  percentiles over the compared answers of ``|t_program - t_reference|``,
  metres;
* ``rotation_gap_q90_rad``: the 90th percentile of the angle of
  ``R_program R_reference^T``;
* ``iteration_flip_pct``: the share of answers whose count differs from the
  reference's, percent;
* ``far_answer_pct``: the share of answers whose translation lies farther
  than the configuration's ``far_m`` from the reference's (an infinite gap
  included), percent.

The percentiles take the higher of two neighbouring order statistics.  A
configuration's ``correct`` entry is ``{"far_m": metres, "limits": {number:
limit}}``; the numbers it does not name are reported, never compared.
"""

from __future__ import annotations

import math

import torch

from .reference import rotation_angle

def gaps(prog_rot, prog_trans, prog_iters, ref: dict) -> dict:
    """Per answer, in float64 on the host.  ``ref`` holds the reference's
    ``rotation``, ``translation``, ``iterations``, ``previous`` and ``next``
    for the same answers."""
    host = {k: (tuple(x.double().cpu() for x in ref[k]) if isinstance(ref[k], tuple)
                else ref[k].cpu()) for k in ("rotation", "translation", "iterations",
                                             "previous", "next")}
    d = prog_iters.cpu().long() - host["iterations"].long()
    rot, trans = host["rotation"].double(), host["translation"].double()
    for shift, key in ((-1, "previous"), (1, "next")):
        rot = torch.where((d == shift)[:, None, None], host[key][0], rot)
        trans = torch.where((d == shift)[:, None], host[key][1], trans)
    far = d.abs() > 1
    p_rot, p_trans = prog_rot.double().cpu(), prog_trans.double().cpu()
    inf = torch.tensor(float("inf"), dtype=torch.float64)
    t_gap = torch.where(far, inf, torch.linalg.vector_norm(p_trans - trans, dim=-1))
    r_gap = torch.where(far, inf, rotation_angle(p_rot @ rot.transpose(-1, -2)).abs())
    t_gap = torch.where(torch.isnan(t_gap), inf, t_gap)
    r_gap = torch.where(torch.isnan(r_gap), inf, r_gap)
    return {"translation_gap_m": t_gap, "rotation_gap_rad": r_gap, "iteration_delta": d}


def numbers(per_answer: dict, far_m: float) -> dict:
    """Every number the comparison can hold to a limit, and the widest gaps
    (reported, never compared)."""
    t, r, d = (per_answer[k] for k in ("translation_gap_m", "rotation_gap_rad",
                                       "iteration_delta"))
    if not len(t):
        return {}

    def q(x, level):  # torch.quantile's "higher", without its limit on size
        return float(torch.sort(x).values[math.ceil(level * (len(x) - 1))])

    return {
        "translation_gap_q50_m": q(t, 0.5),
        "translation_gap_q90_m": q(t, 0.9),
        "rotation_gap_q90_rad": q(r, 0.9),
        "iteration_flip_pct": 100.0 * float((d != 0).double().mean()),
        "far_answer_pct": 100.0 * float((t > far_m).double().mean()),
        "translation_gap_widest_m": float(t.max()),
        "rotation_gap_widest_rad": float(r.max()),
    }


def judge(per_answer: dict, correct: dict) -> dict:
    """``{name: {"value": reading, "limit": limit}}`` for the configuration's
    compared numbers; a number that cannot be read reads ``inf``."""
    read = numbers(per_answer, correct["far_m"])
    return {name: {"value": read.get(name, float("inf")), "limit": limit}
            for name, limit in correct["limits"].items()}
