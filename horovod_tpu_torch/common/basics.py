"""Runtime state and lifecycle: init / shutdown / rank queries.

Port of ``horovod_tpu/common/basics.py`` (``init`` l.90, ``shutdown``
l.270, the rank queries l.334-360) on ``torch.distributed``.

``init(config_overrides=None)`` reads the knobs (the copied registry,
``common/config.py``) and brings up the process group:

- With HOROVOD_SIZE > 1 from a launcher, every rank calls
  ``torch.distributed.init_process_group`` with
  ``tcp://<HOROVOD_COORDINATOR_ADDR>``, its HOROVOD_RANK and the world
  size. The group's timeout is the larger of HOROVOD_START_TIMEOUT and
  HOROVOD_GLOO_TIMEOUT_SECONDS.
- A group the caller already initialized is adopted, as the JAX package
  adopts an initialized ``jax.distributed``; ``shutdown`` then leaves it
  up.
- Otherwise the world is this one process and needs no group.

The backend is chosen once, here, and logged: NCCL when every rank has a
card of its own (CUDA present and HOROVOD_LOCAL_SIZE no larger than the
local card count), gloo otherwise (no card, or several ranks sharing
one: NCCL refuses two ranks on one device). Nothing switches backend
after a failure. Under gloo the collectives stage CUDA tensors through
host memory (``ops/collective_ops.py``).

``init(process_sets=...)`` registers the given sets after the global
one, and ``add_process_set``, ``remove_process_set``,
``process_set_included`` and ``global_process_set`` are the reference's
(``horovod_tpu/__init__.py:118-138``). Every rank must register the
same sets in the same order: each set gets its ``torch.distributed``
group from ``new_group``, a collective over the world
(``ops/process_set.py``).

Not ported: the negotiated engine and controller (ROADMAP A.4),
timeline, autotune, metrics server, tracing, journal and telemetry
wiring.
"""

from __future__ import annotations

import atexit
import datetime
import threading
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from . import logging as hlog
from .config import Config
from .topology import Topology, detect


class HorovodTorchState:
    """The process's runtime state (the JAX package's HorovodTpuState)."""

    def __init__(self):
        self.initialized = False
        self.config: Optional[Config] = None
        self.topology: Optional[Topology] = None
        self.process_set_table = None   # built by ops.process_set at init
        self.backend: Optional[str] = None
        self.handles = None             # ops.collective_ops.HandleTable
        self._lock = threading.Lock()
        self._owns_group = False


_state = HorovodTorchState()


def choose_backend(local_size: int, cuda_available: bool,
                   device_count: int) -> str:
    """NCCL when every local rank has a card of its own, gloo otherwise."""
    if cuda_available and dist.is_nccl_available() \
            and 0 < local_size <= device_count:
        return "nccl"
    return "gloo"


def _group_timeout(cfg: Config) -> datetime.timedelta:
    return datetime.timedelta(seconds=max(
        float(cfg.start_timeout), float(cfg["HOROVOD_GLOO_TIMEOUT_SECONDS"]),
        1.0))


def init(config_overrides: Optional[Dict[str, Any]] = None,
         process_sets: Optional[list] = None) -> None:
    """Initialize the runtime; idempotent. ``process_sets``: ProcessSet
    objects to register after the global set, the same on every rank."""
    with _state._lock:
        if _state.initialized:
            return
        cfg = Config(config_overrides)
        hlog.configure(cfg.log_level, cfg.log_timestamp,
                       cfg.log_rank0_only)
        from ..ops import adasum as _adasum
        _adasum.set_adasum_mode(cfg.adasum_mode)
        adopted = dist.is_available() and dist.is_initialized()
        topo = detect(cfg)
        if adopted and (topo.rank, topo.size) != (dist.get_rank(),
                                                  dist.get_world_size()):
            raise ValueError(
                f"init: HOROVOD_RANK/HOROVOD_SIZE say rank {topo.rank} of "
                f"{topo.size}, the initialized process group says "
                f"{dist.get_rank()} of {dist.get_world_size()}")
        if adopted:
            backend = str(dist.get_backend())
        else:
            backend = choose_backend(
                topo.local_size, torch.cuda.is_available(),
                torch.cuda.device_count() if torch.cuda.is_available()
                else 0)
        owns = False
        if not adopted and topo.size > 1:
            if not cfg.coordinator_addr:
                raise ValueError(
                    f"init: HOROVOD_SIZE={topo.size} needs "
                    f"HOROVOD_COORDINATOR_ADDR (host:port of rank 0)")
            if backend == "nccl":
                torch.cuda.set_device(topo.local_rank)
            dist.init_process_group(
                backend, init_method=f"tcp://{cfg.coordinator_addr}",
                rank=topo.rank, world_size=topo.size,
                timeout=_group_timeout(cfg))
            owns = True
        _state.config = cfg
        _state.topology = topo
        _state.backend = backend if (adopted or owns) else None
        _state._owns_group = owns
        hlog.set_rank(topo.rank)
        from ..ops.process_set import ProcessSetTable
        from ..ops.collective_ops import HandleTable
        table = ProcessSetTable(topo)
        try:
            for ps in process_sets or ():
                table.register(ps)
        except BaseException:
            table.close()
            if owns:
                dist.destroy_process_group()
                _state._owns_group = False
            raise
        _state.process_set_table = table
        _state.handles = HandleTable()
        _state.initialized = True
        hlog.info("horovod_tpu_torch initialized: rank=%d size=%d "
                  "local_rank=%d local_size=%d backend=%s (%s)",
                  topo.rank, topo.size, topo.local_rank, topo.local_size,
                  _state.backend or "none",
                  "adopted" if adopted else
                  "created" if owns else "world of one")


def shutdown() -> None:
    """Tear down what ``init`` brought up; idempotent. A process group
    that ``init`` adopted stays up."""
    with _state._lock:
        if not _state.initialized:
            return
        _state.process_set_table.close()
        if _state._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        _state._owns_group = False
        _state.initialized = False
        _state.config = None
        _state.topology = None
        _state.backend = None
        _state.process_set_table = None
        _state.handles = None
        from ..ops import adasum as _adasum
        _adasum.set_adasum_mode("auto")


atexit.register(shutdown)


def _require_init() -> HorovodTorchState:
    if not _state.initialized:
        raise RuntimeError(
            "horovod_tpu_torch has not been initialized; call hvd.init() "
            "first.")
    return _state


def state() -> HorovodTorchState:
    return _state


def is_initialized() -> bool:
    return _state.initialized


def rank() -> int:
    return _require_init().topology.rank


def size() -> int:
    return _require_init().topology.size


def local_rank() -> int:
    return _require_init().topology.local_rank


def local_size() -> int:
    return _require_init().topology.local_size


def backend() -> Optional[str]:
    """The process group's backend ("nccl" or "gloo"), None in a world
    of one."""
    return _require_init().backend


def add_process_set(ranks):
    """Register a process set after ``init`` on every rank, in the same
    order everywhere; returns the registered set (an existing one with
    the same ranks is reused)."""
    from ..ops.process_set import ProcessSet
    ps = ranks if isinstance(ranks, ProcessSet) else ProcessSet(ranks)
    return _require_init().process_set_table.register(ps)


def remove_process_set(process_set) -> None:
    _require_init().process_set_table.remove(process_set)


def process_set_included(process_set_id: int) -> bool:
    return _require_init().process_set_table.get(process_set_id).included()


def global_process_set():
    return _require_init().process_set_table.global_set
