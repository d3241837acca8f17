"""The numbers that decide ``correct``, each against its limit from the
configuration file.

Training: each leaf's norm on the program's side against the reference's,
the gap measured against the larger of the reference leaf's norm and the
median leaf's (some gradients are all but zero); the worst leaf counts.
Leaves whose plain gradient is under a thousandth of the median leaf's in
the reference move under Adam by round-off alone and are left out of the
weights' change.  Norms average a leaf's rounding away, so the first
gradient is also held against the reference's element by element
(``grad_err``): the norm of the difference, over the same floor."""
from __future__ import annotations

import statistics

NOUGHT = 1e-3


def norm_gap(prog: dict, ref: dict, keys=None):
    """(worst gap, its leaf) of two {leaf: norm} dicts."""
    keys = sorted(ref) if keys is None else sorted(keys)
    med = statistics.median(ref[k] for k in keys)
    worst = max(keys, key=lambda k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30))
    return abs(prog[worst] - ref[worst]) / max(ref[worst], med, 1e-30), worst


def moving_leaves(raw_grad_norm: dict):
    """The leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(raw_grad_norm.values())
    return [k for k, v in raw_grad_norm.items() if v >= NOUGHT * med]


def diff_err(prog: dict, ref: dict):
    """(worst, the three worst leaves, median) of ||prog - ref|| over the
    larger of ||ref|| and the median leaf's, leaf by leaf, for two {leaf:
    tensor} dicts."""
    norms = {k: float(v.norm()) for k, v in ref.items()}
    med = statistics.median(norms.values())
    errs = {k: float((prog[k].to(v.device) - v).norm()) / max(norms[k], med, 1e-30)
            for k, v in ref.items()}
    top = sorted(errs, key=errs.get, reverse=True)[:3]
    return (errs[top[0]], ", ".join(f"{k} {errs[k]:.4g}" for k in top),
            statistics.median(errs.values()))


def train_numbers(prog: dict, ref: dict) -> dict:
    """{name: (value, detail)} of the program's readings (``loss`` a list
    a step, ``grad_norm``, ``change_norm``, ``grad``: the first gradient
    by leaf) against the reference's."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss_gap = float("inf")
    grad_gap, grad_leaf = norm_gap(prog["grad_norm"], ref["grad_norm"])
    change_gap, change_leaf = norm_gap(prog["change_norm"], ref["change_norm"],
                                       moving_leaves(ref["raw_grad_norm"]))
    grad_err, err_leaf, err_median = diff_err(prog["grad"], ref["grad"])
    return {"grad_err": (grad_err, err_leaf),
            "grad_err_median": (err_median, "the median leaf"), "loss_gap": (loss_gap, "worst of the first steps"),
            "grad_gap": (grad_gap, grad_leaf), "change_gap": (change_gap, change_leaf)}


def verdict(numbers: dict, limits: dict):
    """(correct, checks): every number at or under its limit; checks is
    {name: {"value", "limit"}} in ``limits``' order."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = float(numbers[name][0]) if name in numbers else float("inf")
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit          # NaN fails
    return ok, checks
