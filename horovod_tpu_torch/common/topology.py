"""Process topology: rank, size, local rank and local size.

Port of the part of ``horovod_tpu/common/topology.py`` that ``init``
needs: the ``Topology`` record and ``detect`` (l.44-67). The launcher's
knobs (HOROVOD_RANK, HOROVOD_SIZE, HOROVOD_LOCAL_RANK,
HOROVOD_LOCAL_SIZE) win when HOROVOD_SIZE is set; without them, a
``torch.distributed`` group that the caller already initialized gives
rank and size, as the JAX package adopts an initialized
``jax.distributed`` (l.56-58); with neither, the world is this one
process. The cross-host fields, the host name and the device helpers of
the JAX module (meshes over JAX devices) have no counterpart yet: a
torch collective takes its tensors' devices.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist


@dataclasses.dataclass
class Topology:
    rank: int
    size: int
    local_rank: int
    local_size: int


def detect(cfg) -> Topology:
    """The topology from the launcher's knobs, else from an initialized
    ``torch.distributed`` group, else a world of one."""
    if cfg.size > 0:
        return Topology(
            rank=max(cfg.rank, 0), size=cfg.size,
            local_rank=cfg.local_rank if cfg.local_rank >= 0 else 0,
            local_size=cfg.local_size if cfg.local_size >= 0 else 1)
    adopted = dist.is_available() and dist.is_initialized()
    return Topology(rank=dist.get_rank() if adopted else 0,
                    size=dist.get_world_size() if adopted else 1,
                    local_rank=0, local_size=1)
