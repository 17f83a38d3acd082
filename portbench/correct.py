"""The comparison that decides ``correct`` for a training cell.

Set-up drives the program through its first steps and takes three
readings, which the plain reference (``reference/lm.py``) takes again from
the same seeded weights and token rows:

- ``loss_gap``: the largest relative gap of a checked step's loss;
- ``grad_gap``: the worst leaf's gap between the norms of its first
  gradient as the optimizer took it (clipped), the program's worked out
  from its AdamW first moment after one step (m / (1 - b1));
- ``change_gap``: the worst leaf's gap between the norms of its change
  after the checked steps, read before the next step moves it.

A leaf's gap is |program norm - reference norm| over the larger of the
reference's norm of that leaf and of the median leaf.  Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of ``change_gap``.  Each gap has its
limit (``limits/<cell>.json``), set between the largest reading of sound
runs and the smallest of the fp8 control's or a fault's; a gap that is
not finite fails.
"""
from __future__ import annotations

import math
import statistics
from typing import Any, Dict, Optional, Tuple

#: steps the reference follows
CHECKED_STEPS = 3
#: a leaf whose reference gradient is under this share of the median
#: leaf's takes no part in ``change_gap``
STILL_LEAF = 1e-3


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keys=None
             ) -> Tuple[float, str]:
    keys = list(ref) if keys is None else list(keys)
    med = statistics.median(ref[k] for k in keys)
    worst, at = 0.0, ""
    for k in keys:
        p = prog.get(k, float("nan"))
        gap = abs(p - ref[k]) / max(ref[k], med, 1e-30)
        if not math.isfinite(gap):
            return float("inf"), k
        if gap > worst:
            worst, at = gap, k
    return worst, at


def gaps(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, Any]:
    """The three numbers compared, with the leaf that set each."""
    losses = list(zip(prog["losses"], ref["losses"]))
    if len(losses) < len(ref["losses"]):
        loss_gap = float("inf")
    else:
        loss_gap = max((abs(p - r) / abs(r) if math.isfinite(p)
                        else float("inf")) for p, r in losses)
    g_ref = ref["grad_norms"]
    med = statistics.median(g_ref.values())
    moving = [k for k, v in g_ref.items() if v >= STILL_LEAF * med]
    grad_gap, grad_at = leaf_gap(prog["grad_norms"], g_ref)
    change_gap, change_at = leaf_gap(prog["change_norms"], ref["change_norms"],
                                     moving)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_leaf": grad_at,
            "change_leaf": change_at,
            "still_leaves": sorted(set(g_ref) - set(moving))}


def compare(prog, ref, limits: Optional[Dict[str, float]]
            ) -> Tuple[Dict[str, Any], bool]:
    """({name: {value, limit}} of the numbers the limits hold, every one
    within its limit).  A number with no limit in the file is not compared
    (it has no upper reading: ``limits/<cell>.json`` gives its readings);
    no limits at all is never correct."""
    g = gaps(prog, ref)
    checks = {name: {"value": g[name], "limit": limits[name]}
              for name in ("loss_gap", "grad_gap", "change_gap")
              if limits is not None and name in limits}
    ok = bool(checks) and all(c["value"] <= c["limit"]
                              for c in checks.values())
    return checks, ok
