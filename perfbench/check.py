"""What decides ``correct``: the numbers that a cell's loop
(``loops/<loop>.py``) compares with the configuration's plain reference
(``reference/<reference>.py``), and their limits
(``limits/<workload>.json``)."""

from __future__ import annotations

import statistics


def rel(a: float, b: float, floor: float) -> float:
    """``|a - b|`` over the larger of ``|b|`` and ``floor``."""
    return abs(a - b) / max(abs(b), floor)


def leaf_gaps(prog: dict, refn: dict, names) -> float:
    """The worst of ``names``' gaps between the program's and the
    reference's norms, against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    med = statistics.median(refn.values())
    return max(rel(prog[n], refn[n], med) for n in names)


def judge(limits: dict | None, values: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: every number at or under its limit. With no
    limits for the cell nothing can be correct."""
    checks = {k: {"value": v, "limit": (limits or {}).get(k, {})
                  .get("limit")} for k, v in values.items()}
    ok = limits is not None and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks
