"""The numbers that decide ``correct`` for a training cell, each a gap between
what the program produced in its checked steps and what the reference
(``reference.follow``) produced from the same inputs.

Compared, each with the cell's limit (``limits/<cell>.json``), which names
the numbers its cell compares:

* ``data_gap``: the program's preprocessed data set against the source
  mesh as the reference normalises it: the largest of the vertex gap of
  the program's normalised mesh and each cloud point's distance to the
  nearest triangle whose normal is parallel to the point's.
* ``batch_gap``: the largest difference of a batch's points or GT normals.
* ``sdf_mean_gap``: the mean difference of the GT distances (the oracle
  against brute force) over a batch's rows, the largest over the batches.
* ``loss_gap``: the largest gap of the first step's loss or one of its four
  terms, over the reference's value.
* ``surface_loss_gap`` (stage 1): the same of the first step's two
  surface terms alone (|f| on the surface, and the Hessian normal against
  the GT normal): they read no GT distance, so no oracle's error enters,
  and they hold the SIREN's value and Hessian to float32.  Stage 2's terms
  are all surface terms, so ``loss_gap`` is this number there.
* ``grad_gap``: the first step's gradient, as the optimizer holds it after
  that step, by the worst leaf: the gap between the two norms of a leaf
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger.
* ``step1_gap``: the parameters' change in the first step, by the worst
  leaf, the same way; leaves whose first reference gradient is under a
  thousandth of the median leaf's move by round-off alone under Adam and
  are left out.

Read and printed, not compared (``PERF.md`` gives the readings and why):
``sdf_gap``, the largest GT distance gap, which the oracles' design bounds
and no fault exceeds; ``loss3_gap`` and ``step3_gap``, the loss of every
checked step and the change over all of them, where Adam's first moves at
the warm-up rate carry float32 differences between two sound paths to
percents by the third step.
"""

from __future__ import annotations

import numpy as np

NAMES = ("data_gap", "batch_gap", "sdf_mean_gap", "loss_gap", "surface_loss_gap", "grad_gap",
         "step1_gap")
# columns of stage 1's ``terms``: |f| on the surface, the Hessian normal
SURFACE_TERMS = {"s1": (0, 2)}
RESTING_LEAF = 1e-3  # a leaf's gradient norm under this share of the median's


def _leaf_gap(prog, ref, keep=None):
    p = np.array([np.linalg.norm(x) for x in prog])
    r = np.array([np.linalg.norm(x) for x in ref])
    if keep is not None:
        p, r = p[keep], r[keep]
    scale = np.maximum(r, np.median(r))
    return float(np.max(np.abs(p - r) / np.maximum(scale, np.finfo(np.float64).tiny)))


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


def gaps(prog: dict, ref: dict, prog_batches=None, ref_batches=None, stage: str = "s1") -> dict:
    """``prog`` and ``ref`` hold ``terms`` (steps, terms + 1), ``grad1``,
    ``delta1`` and ``delta`` (lists of arrays, one a leaf); the batches,
    when given, are lists of (points, normals, sdf) of each side.
    -> {name: float}."""
    out = {}
    if prog_batches is not None:
        bg, sg, sm = 0.0, 0.0, 0.0
        for (pp, pn, ps), (rp, rn, rs) in zip(prog_batches, ref_batches):
            bg = max(bg, float(np.abs(pp - rp).max()), float(np.abs(pn - rn).max()))
            d = np.abs(ps.astype(np.float64) - rs.astype(np.float64))
            sg, sm = max(sg, float(d.max())), max(sm, float(d.mean()))
        out.update(batch_gap=bg, sdf_mean_gap=sm, sdf_gap=sg)
    t_p, t_r = np.asarray(prog["terms"], np.float64), np.asarray(ref["terms"], np.float64)
    out["loss_gap"] = float(np.max(_rel(t_p[0], t_r[0])))
    if stage in SURFACE_TERMS:
        out["surface_loss_gap"] = float(np.max(_rel(t_p[0], t_r[0])[list(SURFACE_TERMS[stage])]))
    out["grad_gap"] = _leaf_gap(prog["grad1"], ref["grad1"])
    g_ref = np.array([np.linalg.norm(x) for x in ref["grad1"]])
    keep = g_ref >= RESTING_LEAF * np.median(g_ref)
    out["step1_gap"] = _leaf_gap(prog["delta1"], ref["delta1"], keep)
    out["loss3_gap"] = float(np.max(_rel(t_p, t_r)))
    out["step3_gap"] = _leaf_gap(prog["delta"], ref["delta"], keep)
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """-> (every number that ``limits`` names within its limit, {name:
    {"value", "limit"}} in the order of ``NAMES``); a number that is
    missing or not finite fails."""
    unknown = set(limits) - set(NAMES)
    if not limits or unknown:
        raise ValueError("limits name no number, or numbers that checks.py does not read: "
                         f"{sorted(unknown)}")
    table, ok = {}, True
    for name in (n for n in NAMES if n in limits):
        v = numbers.get(name, float("nan"))
        lim = limits[name]
        table[name] = {"value": v, "limit": lim}
        ok = ok and bool(np.isfinite(v)) and v <= lim
    return ok, table
