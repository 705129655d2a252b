"""Eager collectives on torch tensors: allreduce, grouped allreduce and
broadcast, with their async and in-place variants, synchronize and the
op constants.

Port of the allreduce and broadcast half of
``horovod_tpu/ops/collective_ops.py`` with the torch surface of the
bridge (``horovod_tpu/torch/__init__.py:268-500``), on
``torch.distributed``. The routing of prescale, postscale and
compression is the reference's (``_grouped_by_dtype`` l.285-303,
``allreduce_async`` l.317-342):

- Sum and Average: compress, concatenate the same-dtype group, multiply
  by prescale (in the wire dtype), sum across the set, divide by the
  set's size (Average), multiply by postscale, split and decompress. In
  a world of one the sum is skipped and prescale * postscale applied.
- Adasum: compress each tensor, ``ops.adasum.adasum_allreduce`` the
  group (prescale before the fold, postscale after), decompress.

A mixed-dtype group splits into same-dtype subgroups, in order of
first appearance. Tensors stay on their device: under the gloo backend
a CUDA tensor goes through host memory for the collective and comes
back.

Handles: the collective runs when it is submitted, in the caller's
thread, so every rank must submit the same collectives in the same
order (the negotiated background engine that lifts this is ROADMAP
A.4). ``synchronize(handle)`` returns the result and releases the
handle; the in-place variants have already written their tensor.

An op before ``init`` raises RuntimeError naming ``init``. Min, Max,
Product, allgather, alltoall and reducescatter are not ported yet
(ROADMAP A.2).
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..common.basics import _require_init
from .adasum import adasum_allreduce
from .compression import Compression
from .process_set import ProcessSet

# Op constants, the JAX package's values (ops/dispatch.py:37-39).
Average = AVERAGE = 0
Sum = SUM = 1
Adasum = ADASUM = 2


class HandleTable:
    """Results of submitted collectives by integer handle."""

    def __init__(self):
        self._ids = itertools.count(1)
        self._results: Dict[int, Any] = {}
        self._lock = threading.Lock()

    def put(self, result: Any) -> int:
        with self._lock:
            h = next(self._ids)
            self._results[h] = result
        return h

    def take(self, handle: int) -> Any:
        with self._lock:
            if handle not in self._results:
                raise KeyError(f"unknown or released handle {handle}")
            return self._results.pop(handle)

    def __contains__(self, handle: int) -> bool:
        with self._lock:
            return handle in self._results


def _pset(process_set: Optional[ProcessSet]) -> ProcessSet:
    st = _require_init()
    if process_set is None or process_set is st.process_set_table.global_set:
        return st.process_set_table.global_set
    raise NotImplementedError(
        "collectives over process sets other than the global set are not "
        "ported yet (ROADMAP A.2)")


def _resolve_op(op: Optional[int], average: Optional[bool]) -> int:
    if op is not None and average is not None:
        raise ValueError("specify either op or average, not both")
    if average is not None:
        return AVERAGE if average else SUM
    op = AVERAGE if op is None else op
    if op not in (AVERAGE, SUM, ADASUM):
        raise NotImplementedError(
            f"reduce op {op}: only Average, Sum and Adasum are ported "
            f"(ROADMAP A.2)")
    return op


def _check_inexact_for_average(op: int, tensors) -> None:
    if op == AVERAGE:
        for t in tensors:
            if not (t.is_floating_point() or t.is_complex()):
                raise ValueError(
                    "hvd.Average is not supported for integer tensors; "
                    "use op=hvd.Sum (matches the reference's behavior)")


def _staged(t: torch.Tensor) -> bool:
    return t.is_cuda and _require_init().backend == "gloo"


def _all_reduce_sum(flat: torch.Tensor, pset: ProcessSet) -> torch.Tensor:
    if not _staged(flat):
        dist.all_reduce(flat, group=pset.group)
        return flat
    host = flat.cpu()
    dist.all_reduce(host, group=pset.group)
    return host.to(flat.device)


def _group_by_dtype(tensors: Sequence[torch.Tensor], fn) -> List[Any]:
    """Apply ``fn`` to each same-dtype subgroup (order kept within it,
    subgroups in order of first appearance) and reassemble."""
    out: List[Any] = [None] * len(tensors)
    groups: Dict[Any, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    for idxs in groups.values():
        for i, r in zip(idxs, fn([tensors[i] for i in idxs])):
            out[i] = r
    return out


def _sum_group(tensors, pset, op, prescale, postscale, compression):
    pairs = [compression.compress(t) for t in tensors]
    wires = [w for w, _ in pairs]
    n = pset.size
    if n == 1:
        scale = prescale * postscale
        outs = [w * torch.tensor(scale, dtype=w.dtype, device=w.device)
                if scale != 1.0 else w for w in wires]
    else:
        flat = torch.cat([w.reshape(-1) for w in wires])
        one = lambda f: torch.tensor(f, dtype=flat.dtype,  # noqa: E731
                                     device=flat.device)
        if prescale != 1.0:
            flat = flat * one(prescale)
        red = _all_reduce_sum(flat, pset)
        if op == AVERAGE:
            red = red / one(n)
        if postscale != 1.0:
            red = red * one(postscale)
        outs, off = [], 0
        for w in wires:
            outs.append(red[off:off + w.numel()].view(w.shape))
            off += w.numel()
    return [compression.decompress(o, ctx)
            for o, (_, ctx) in zip(outs, pairs)]


def _adasum_group(tensors, pset, prescale, postscale, compression):
    pairs = [compression.compress(t) for t in tensors]
    outs = adasum_allreduce([w for w, _ in pairs], pset, prescale,
                            postscale)
    return [compression.decompress(o, ctx)
            for o, (_, ctx) in zip(outs, pairs)]


def _allreduce(tensors, average, op, prescale, postscale, compression,
               process_set) -> List[torch.Tensor]:
    pset = _pset(process_set)
    rop = _resolve_op(op, average)
    _check_inexact_for_average(rop, tensors)
    if rop == ADASUM:
        return _group_by_dtype(tensors, lambda g: _adasum_group(
            g, pset, prescale, postscale, compression))
    return _group_by_dtype(tensors, lambda g: _sum_group(
        g, pset, rop, prescale, postscale, compression))


def _put(result) -> int:
    return _require_init().handles.put(result)


def synchronize(handle: int):
    """The result of a submitted collective; releases the handle (a
    second call raises KeyError)."""
    return _require_init().handles.take(handle)


def poll(handle: int) -> bool:
    """True when the collective has completed: always, since it runs
    at submission; KeyError for an unknown handle."""
    if handle not in _require_init().handles:
        raise KeyError(f"unknown or released handle {handle}")
    return True


def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    compression=Compression.none,
                    process_set=None) -> int:
    return _put(_allreduce([tensor], average, op, prescale_factor,
                           postscale_factor, compression, process_set)[0])


def allreduce(tensor, average=None, name=None, op=None,
              prescale_factor=1.0, postscale_factor=1.0,
              compression=Compression.none, process_set=None):
    return synchronize(allreduce_async(
        tensor, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, process_set=process_set))


def allreduce_async_(tensor, average=None, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0,
                     compression=Compression.none,
                     process_set=None) -> int:
    """In-place variant: the result is written into ``tensor``."""
    res = _allreduce([tensor], average, op, prescale_factor,
                     postscale_factor, compression, process_set)[0]
    with torch.no_grad():
        if res is not tensor:
            tensor.copy_(res)
    return _put(tensor)


def allreduce_(tensor, average=None, name=None, op=None,
               prescale_factor=1.0, postscale_factor=1.0,
               compression=Compression.none, process_set=None):
    return synchronize(allreduce_async_(
        tensor, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, process_set=process_set))


def grouped_allreduce_async(tensors: Sequence[torch.Tensor], average=None,
                            name=None, op=None, prescale_factor=1.0,
                            postscale_factor=1.0,
                            compression=Compression.none,
                            process_set=None) -> int:
    return _put(_allreduce(list(tensors), average, op, prescale_factor,
                           postscale_factor, compression, process_set))


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      prescale_factor=1.0, postscale_factor=1.0,
                      compression=Compression.none, process_set=None):
    return synchronize(grouped_allreduce_async(
        tensors, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, process_set=process_set))


def _broadcast_into(buf: torch.Tensor, root_rank: int,
                    pset: ProcessSet) -> None:
    if root_rank not in pset.ranks:
        raise ValueError(f"root_rank {root_rank} not in {pset}")
    if pset.size == 1:
        return
    if not _staged(buf):
        dist.broadcast(buf, src=root_rank, group=pset.group)
        return
    host = buf.cpu()
    dist.broadcast(host, src=root_rank, group=pset.group)
    buf.copy_(host)


def broadcast_async(tensor, root_rank, name=None, process_set=None) -> int:
    out = tensor.detach().clone()
    _broadcast_into(out, root_rank, _pset(process_set))
    return _put(out)


def broadcast(tensor, root_rank, name=None, process_set=None):
    return synchronize(broadcast_async(tensor, root_rank, name=name,
                                       process_set=process_set))


def broadcast_async_(tensor, root_rank, name=None,
                     process_set=None) -> int:
    """In-place variant: ``tensor`` receives the root's value."""
    with torch.no_grad():
        _broadcast_into(tensor, root_rank, _pset(process_set))
    return _put(tensor)


def broadcast_(tensor, root_rank, name=None, process_set=None):
    return synchronize(broadcast_async_(tensor, root_rank, name=name,
                                        process_set=process_set))


def broadcast_object(obj, root_rank: int = 0, name=None,
                     process_set=None):
    """A picklable object from ``root_rank`` on every rank."""
    pset = _pset(process_set)
    if root_rank not in pset.ranks:
        raise ValueError(f"root_rank {root_rank} not in {pset}")
    if pset.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=root_rank, group=pset.group)
    return box[0]
