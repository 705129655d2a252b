"""Named axes over ranks: the pure data-parallel part of
``horovod_tpu/parallel/mesh.py``.

The JAX package names axes of parallelism on a ``jax.sharding.Mesh``
of devices (``AXIS_ORDER`` l.30, the axis names l.36-41). In the port
one process drives one card and is one rank, so a mesh is a mapping
from axis name to size over the ranks of a process set, with that
set's ``torch.distributed`` group. Only the data axis is ported:
``data_parallel_mesh`` (the counterpart of l.112) puts every rank of
the world, or of a registered set, on it. A mesh that gives another
axis more than one rank (fsdp, tensor, seq, expert, pipe) is refused by
``require_data_parallel``: those layers are ROADMAP A.9.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

AXIS_ORDER = ("pipe", "data", "fsdp", "expert", "seq", "tensor")

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"


class Mesh:
    """Axis sizes over the ranks of ``process_set`` (None: the axes
    name no ranks, a world of one). ``shape`` maps each axis name to
    its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, shape: Mapping[str, int], process_set=None):
        unknown = [a for a in shape if a not in AXIS_ORDER]
        if unknown:
            raise ValueError(f"unknown mesh axes {unknown}; the axes are "
                             f"{AXIS_ORDER}")
        self.shape = {a: int(n) for a, n in shape.items()}
        self.process_set = process_set

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def group(self):
        """The ``torch.distributed`` group of the mesh's ranks (None:
        the default group, or no group in a world of one)."""
        return None if self.process_set is None else self.process_set.group

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.process_set})"


def data_parallel_mesh(process_set=None) -> Mesh:
    """Pure-DP mesh, the Horovod layout: every rank of the world (or of
    the registered ``process_set``) on the data axis. Always a 1-axis
    mesh, even in a world of one. Needs ``init``."""
    from ..ops.collective_ops import _pset
    ps = _pset(process_set)
    return Mesh({DATA_AXIS: ps.size}, ps)


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1)


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes the batch dimension is sharded over: dp + fsdp + expert,
    as in the JAX package (l.125)."""
    return tuple(a for a in (DATA_AXIS, FSDP_AXIS, EXPERT_AXIS)
                 if a in mesh.shape)


def _live_axes(mesh: Optional[Mesh]) -> Tuple[str, ...]:
    """Mesh axes with more than one rank, the only axes a reduction
    moves bytes over (``horovod_tpu/parallel/train.py`` l.164)."""
    if mesh is None:
        return ()
    return tuple(a for a in mesh.shape if mesh.shape[a] > 1)


def require_data_parallel(mesh: Optional[Mesh]) -> None:
    """Raise for a mesh that gives an axis other than data more than
    one rank: model parallelism is not ported yet (ROADMAP A.9)."""
    if mesh is None:
        return
    model = [a for a in _live_axes(mesh) if a != DATA_AXIS]
    if model:
        raise NotImplementedError(
            f"mesh axes {model} shard the model; only the data axis is "
            f"ported (fsdp, tensor, seq, expert and pipe parallelism are "
            f"ROADMAP A.9)")
