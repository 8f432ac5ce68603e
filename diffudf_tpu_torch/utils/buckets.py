"""Shape-bucketing helper: a copy of ``diffudf_tpu/utils/buckets.py``.

Pads a data-dependent length to a coarse geometric ladder, so that the set
of distinct shapes a run sees stays small (``factor=2`` for ≤2× waste,
``factor=4`` for shapes that take many values per run).  The JAX package
needs it because every new shape compiles; the extraction slice here runs
eagerly and its kernel masks ragged tiles, so nothing here pads yet.
"""

from __future__ import annotations


def next_bucket(n: int, floor: int, factor: int = 2, cap: int | None = None):
    """Smallest ``floor * factor**k ≥ n``, clamped to ``cap`` if given."""
    b = floor
    while b < n and (cap is None or b < cap):
        b *= factor
    return b if cap is None else min(b, cap)
