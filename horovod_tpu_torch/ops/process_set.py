"""Process sets: the global set only.

Port of the global-set half of ``horovod_tpu/ops/process_set.py``: an
ordered set of ranks with its size and, here, the ``torch.distributed``
group its collectives run over (None: the default group, or no group in
a world of one). Sets other than the global one (``add_process_set``,
``init(process_sets=...)``) are not ported yet and raise
NotImplementedError (ROADMAP A.2).
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class ProcessSet:
    """An ordered set of process ranks (reference: hvd.ProcessSet)."""

    def __init__(self, ranks: Sequence[int]):
        if len(set(ranks)) != len(ranks):
            raise ValueError(f"duplicate ranks in process set: {ranks}")
        self.ranks: List[int] = sorted(int(r) for r in ranks)
        self.process_set_id: Optional[int] = None
        self.group = None               # torch.distributed group; None = default

    @property
    def size(self) -> int:
        return len(self.ranks)

    def __repr__(self) -> str:
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"


class ProcessSetTable:
    """The registered sets: slot 0 is the global set."""

    def __init__(self, topology):
        self.topology = topology
        self.global_set = ProcessSet(range(topology.size))
        self.global_set.process_set_id = 0

    def register(self, process_set: ProcessSet) -> None:
        raise NotImplementedError(
            "process sets other than the global set are not ported yet "
            "(ROADMAP A.2)")
