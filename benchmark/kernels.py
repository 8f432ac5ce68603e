"""Which SIREN kernel each CUDA kernel of a device trace belongs to.

Each SIREN op launches more than one CUDA kernel on its stream:
``frag_kernel`` (W's fragments) before the main kernel, and after a VJP's
tile kernel ``wbar_kernel`` and ``reduce_kernel`` (the weights' gradient).
The main kernels carry the carry rows a point as their first template
argument: ``fwd_kernel<10, ...>`` is K1, ``fwd_kernel<4, ...>`` K3a,
``tile_kernel<10, ...>`` K2 and ``tile_kernel<4, ...>`` K3b (names as
the profiler prints them, demangled or mangled).  A ``frag_kernel`` goes
to the next main kernel on the stream, a ``wbar_kernel`` or
``reduce_kernel`` to the last one.  What cannot be attributed so (a helper
with no main kernel before or after it, another forward kernel such as the
render's value pass) is left unattributed and counted apart.  Only kernels
of the port's ``dudf`` namespace are considered: the names
``reduce_kernel`` and ``tile_kernel`` also occur in PyTorch.
"""

from __future__ import annotations

import re

_MAIN = [
    (re.compile(r"fwd_kernel(<10,|ILi10E)"), "K1"),
    (re.compile(r"fwd_kernel(<4,|ILi4E)"), "K3a"),
    (re.compile(r"tile_kernel(<10,|ILi10E)"), "K2"),
    (re.compile(r"tile_kernel(<4,|ILi4E)"), "K3b"),
]
_LEAD = re.compile(r"frag_kernel")
_TRAIL = re.compile(r"wbar_kernel|reduce_kernel")


def _ours(name: str) -> bool:
    return "dudf" in name


def main_kernel(name: str):
    """"K1", "K2", "K3a", "K3b" for a main kernel's name, else None."""
    if not _ours(name):
        return None
    return next((k for pat, k in _MAIN if pat.search(name)), None)


def attribute(names):
    """Labels for kernel names in stream order: the SIREN kernel each belongs
    to, or None.  -> (labels, number of ``dudf`` kernels left unattributed)."""
    labels = [None] * len(names)
    pending, last = [], None
    for i, name in enumerate(names):
        if not _ours(name):
            continue
        k = main_kernel(name)
        if k is not None:
            labels[i] = last = k
            for j in pending:
                labels[j] = k
            pending = []
        elif _LEAD.search(name):
            pending.append(i)
        elif _TRAIL.search(name) and last in ("K2", "K3b"):
            labels[i] = last
    unattributed = sum(1 for n, lab in zip(names, labels) if _ours(n) and lab is None)
    return labels, unattributed


def per_kernel(events):
    """``events``: device kernels in stream order, each a dict with ``name``
    and ``dur_s``.  -> ({K: {"launches", "seconds"}}, unattributed count);
    ``launches`` counts the main kernels, ``seconds`` all the kernels
    attributed to K."""
    labels, unattributed = attribute([e["name"] for e in events])
    out = {}
    for e, lab in zip(events, labels):
        if lab is None:
            continue
        rec = out.setdefault(lab, {"launches": 0, "seconds": 0.0})
        rec["seconds"] += e["dur_s"]
        rec["launches"] += int(main_kernel(e["name"]) is not None)
    return out, unattributed


def roofline_pct(ctx, name: str):
    """Share (%) of kernel ``name``'s roofline in the traced stretch ``ctx``:
    its frozen bound at the rows it runs on over its device time a launch;
    None where it did not run."""
    from benchmark import workcount

    rows = ctx.kernel_rows.get(name)
    rec = per_kernel(ctx.kernels)[0].get(name)
    if not rows or rec is None or rec["launches"] == 0 or rec["seconds"] <= 0:
        return None
    per_launch = rec["seconds"] / rec["launches"]
    return 100.0 * workcount.kernel_bound_s(name, rows, ctx.hidden) / per_launch
