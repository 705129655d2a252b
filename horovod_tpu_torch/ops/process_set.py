"""Process sets: ordered sets of ranks, each with its own
``torch.distributed`` communicator.

Port of ``horovod_tpu/ops/process_set.py``: ``ProcessSet`` with its
``rank`` (l.45, -1 for a non-member) and ``included`` (l.54), and
``ProcessSetTable`` with ``register`` (l.132: a rank list already
registered is reused, ranks out of range raise), ``remove`` (l.149: the
global set cannot be removed), ``get`` and ``ids``. Where the reference
gives each set a JAX mesh, each set here owns the ``torch.distributed``
group its collectives run over (``group``; None for the global set: the
default group) and the groups of the suffixes of its members that a
collective declared it needs (``need_suffix_groups``,
``suffix_group``; Adasum's vhdd merges reduce over such suffixes).

Declared difference: the reference registers a set without a
collective (``horovod_tpu/__init__.py:118-125``). Here registration
calls ``torch.distributed.new_group``, which every rank of the world
must call in the same order, members or not. So every rank must
register the same sets in the same order (``init(process_sets=...)``,
``add_process_set``, ``remove_process_set``), as Horovod itself
requires. The groups are made once, at registration, and never per
collective.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch.distributed as dist


class ProcessSet:
    """An ordered set of process ranks (reference: hvd.ProcessSet)."""

    def __init__(self, ranks: Sequence[int]):
        ranks = [int(r) for r in ranks]
        if len(set(ranks)) != len(ranks):
            raise ValueError(f"duplicate ranks in process set: {ranks}")
        self.ranks: List[int] = sorted(ranks)
        self.process_set_id: Optional[int] = None
        self.group = None               # torch.distributed group; None = default
        self._suffixes: Dict[int, object] = {}
        self._table: Optional["ProcessSetTable"] = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    def rank(self) -> int:
        """This process's rank within the set; -1 if not a member."""
        if self._table is None:
            raise RuntimeError("process set is not registered")
        try:
            return self.ranks.index(self._table.topology.rank)
        except ValueError:
            return -1

    def included(self) -> bool:
        if self._table is None:
            raise RuntimeError("process set is not registered")
        return self._table.topology.rank in self.ranks

    def suffix_group(self, start: int):
        """The group of the set's members from set index ``start`` on
        (``start`` 0 is the set's own group); the start must have been
        declared through ``need_suffix_groups``."""
        return self.group if start == 0 else self._suffixes[start]

    def __repr__(self) -> str:
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"


_SUFFIX_STARTS: List[Callable[[int], Iterable[int]]] = []


def need_suffix_groups(starts: Callable[[int], Iterable[int]]) -> None:
    """Declare that a collective reduces over suffixes of a set's
    members: ``starts(n)`` gives, for a set of ``n`` members, the set
    indices its suffixes start at. Declared at import, before any set
    is registered; every set registered after gets those groups."""
    if starts not in _SUFFIX_STARTS:
        _SUFFIX_STARTS.append(starts)


class ProcessSetTable:
    """The registered sets: id 0 is the global set (reference:
    horovod/common/process_set.cc ProcessSetTable)."""

    def __init__(self, topology):
        self.topology = topology
        self._lock = threading.Lock()
        self._by_id: Dict[int, ProcessSet] = {}
        self._next_id = 0
        self.global_set = self.register(ProcessSet(range(topology.size)))

    def _needs_groups(self) -> bool:
        return (self.topology.size > 1 and dist.is_available()
                and dist.is_initialized())

    def _make_groups(self, ps: ProcessSet, is_global: bool) -> None:
        """Every rank calls this for every set, in registration order:
        ``new_group`` is collective over the world."""
        if not self._needs_groups():
            return
        if not is_global:
            ps.group = dist.new_group(ps.ranks)
        starts = {s for fn in _SUFFIX_STARTS for s in fn(ps.size)} - {0}
        for start in sorted(starts):
            ps._suffixes[start] = dist.new_group(ps.ranks[start:])

    def register(self, ps: ProcessSet) -> ProcessSet:
        with self._lock:
            for existing in self._by_id.values():
                if existing.ranks == ps.ranks:
                    return existing
            bad = [r for r in ps.ranks if r >= self.topology.size or r < 0]
            if bad:
                raise ValueError(
                    f"process set ranks {bad} out of range for world size "
                    f"{self.topology.size}")
            self._make_groups(ps, is_global=self._next_id == 0)
            ps.process_set_id = self._next_id
            ps._table = self
            self._next_id += 1
            self._by_id[ps.process_set_id] = ps
            return ps

    def remove(self, ps: ProcessSet) -> None:
        with self._lock:
            if ps.process_set_id == 0:
                raise ValueError("cannot remove the global process set")
            if self._by_id.pop(ps.process_set_id, None) is not None:
                _destroy([ps.group, *ps._suffixes.values()])
                ps.group, ps._suffixes = None, {}
            ps.process_set_id = None

    def get(self, process_set_id: int) -> ProcessSet:
        with self._lock:
            return self._by_id[process_set_id]

    def ids(self) -> List[int]:
        with self._lock:
            return sorted(self._by_id)

    def close(self) -> None:
        """Destroy the groups the table made (at shutdown)."""
        with self._lock:
            for ps in self._by_id.values():
                _destroy([ps.group if ps.process_set_id else None,
                          *ps._suffixes.values()])


def _destroy(groups) -> None:
    if not (dist.is_available() and dist.is_initialized()):
        return
    for g in groups:
        if g is not None and g is not dist.GroupMember.NON_GROUP_MEMBER:
            dist.destroy_process_group(g)
