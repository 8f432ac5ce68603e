"""Data parallelism over a ``torch.distributed`` process group
(:mod:`.mesh`).

The JAX package exports its 1-D device mesh here (``data_mesh``,
``shard_batch``, ``replicate``, ``batch_spec``).  They have no counterpart:
a PyTorch rank is one process with one device, so :class:`DataGroup` (the
group, its rank and its collectives) and :func:`run_group` (start the ranks)
take their place."""

from .mesh import DataGroup, run_group

__all__ = ["DataGroup", "run_group"]
