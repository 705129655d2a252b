"""Eager collectives on torch tensors: allreduce (Average, Sum, Adasum,
Min, Max, Product), allgather, broadcast, alltoall and reducescatter,
their grouped, async and in-place variants, ``allgather_object``,
``broadcast_object``, ``barrier``, synchronize and the op constants,
each over the global set or a registered process set.

Port of ``horovod_tpu/ops/collective_ops.py`` (``allgather_async``
l.358, ``alltoall_async`` l.426, ``reducescatter_async`` l.491,
``grouped_allgather_async`` l.185, ``grouped_reducescatter_async``
l.211, ``barrier`` l.534, the ``_pset`` checks l.40-50) with the torch
surface of the bridge (``horovod_tpu/torch/__init__.py:335-583``), on
``torch.distributed``. The semantics are the reference dispatch's:

- Allreduce: compress, concatenate the same-dtype group, multiply by
  prescale (in the wire dtype), reduce across the set (Sum, Min, Max or
  Product; Product keeps the dtype), divide by the set's size
  (Average), multiply by postscale, split and decompress
  (``dispatch._allreduce_kernel`` l.153-177). In a world of one the
  reduction is skipped and prescale * postscale applied. Adasum:
  compress each tensor, ``ops.adasum.adasum_allreduce`` the group,
  decompress.
- Allgather: the members' first dims are exchanged, every tensor is
  padded to the largest, gathered and trimmed (``dispatch.allgather``
  l.1483, ``exchange_int_vector`` l.1849); bool rides as uint8.
- Alltoall: ``splits[i]`` rows go to member i (even splits when none
  are given); returns ``(output, received_splits)`` when splits are
  given (``dispatch.alltoall`` l.1609).
- Reducescatter, Sum or Average: member i gets rows
  ``reducescatter_rows(d0, n)[i]`` of the reduction, the remainder
  going to low members (``dispatch.reducescatter`` l.1712,
  ``reducescatter_group`` l.1798).

A mixed-dtype group splits into same-dtype subgroups, in order of
first appearance. Tensors stay on their device: under the gloo backend
a CUDA tensor goes through host memory for the collective and comes
back. Small control exchanges (first dims, splits, pickled objects)
run on the host under gloo and on the current card under NCCL.

Handles: the collective runs when it is submitted, in the caller's
thread, so every member must submit the same collectives in the same
order (the negotiated background engine that lifts this, and
``join``, are ROADMAP A.4). ``synchronize(handle)`` returns the result
and releases the handle; the in-place variants have already written
their tensor.

An op before ``init`` raises RuntimeError naming ``init``; an op over a
set that is not registered, or on a rank that is not a member, raises
ValueError.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..common.basics import _require_init
from .adasum import adasum_allreduce
from .compression import Compression
from .process_set import ProcessSet

# Op constants, the JAX package's values (ops/dispatch.py:37-42).
Average = AVERAGE = 0
Sum = SUM = 1
Adasum = ADASUM = 2
Min = MIN = 3
Max = MAX = 4
Product = PRODUCT = 5

_REDUCE_OPS = {AVERAGE: dist.ReduceOp.SUM, SUM: dist.ReduceOp.SUM,
               MIN: dist.ReduceOp.MIN, MAX: dist.ReduceOp.MAX,
               PRODUCT: dist.ReduceOp.PRODUCT}


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
    if process_set is None:
        return st.process_set_table.global_set
    if process_set.process_set_id is None \
            or process_set._table is not st.process_set_table:
        raise ValueError("process set is not registered; pass it to "
                         "hvd.init(process_sets=...) or hvd.add_process_set")
    if not process_set.included():
        raise ValueError(
            f"rank {st.topology.rank} is not a member of {process_set}")
    return process_set


def _resolve_op(op: Optional[int], average: Optional[bool]) -> int:
    if op is not None and average is not None:
        raise ValueError("specify either op or average, not both")
    if average is not None:
        return AVERAGE if average else SUM
    op = AVERAGE if op is None else op
    if op != ADASUM and op not in _REDUCE_OPS:
        raise ValueError(f"unknown reduce op {op}")
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


class _PendingReduce:
    """An allreduce in flight: ``wait()`` returns its result on the
    input's device; ``future`` completes when the collective has."""

    def __init__(self, work, host: torch.Tensor, device: torch.device):
        self._work, self._host, self._device = work, host, device

    @property
    def future(self):
        return self._work.get_future()

    def wait(self) -> torch.Tensor:
        self._work.wait()
        return self._host.to(self._device)


def _all_reduce_async(flat: torch.Tensor, pset: ProcessSet,
                      op: int) -> _PendingReduce:
    host = flat.cpu() if _staged(flat) else flat
    work = dist.all_reduce(host, op=_REDUCE_OPS[op], group=pset.group,
                           async_op=True)
    return _PendingReduce(work, host, flat.device)


def _all_reduce(flat: torch.Tensor, pset: ProcessSet,
                op: int) -> torch.Tensor:
    return _all_reduce_async(flat, pset, op).wait()


def _control_device() -> torch.device:
    """Where small control tensors live: the current card under NCCL,
    which takes no host tensors, else the host."""
    if _require_init().backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _exchange_ints(values: Sequence[int], pset: ProcessSet
                   ) -> List[List[int]]:
    """Every member's ``values`` (the same length on each), in member
    order: the reference's ``exchange_int_vector``."""
    values = [int(v) for v in values]
    if pset.size == 1:
        return [values]
    mine = torch.tensor(values, dtype=torch.int64, device=_control_device())
    rows = mine.new_empty((pset.size, len(values)))
    dist.all_gather(list(rows.unbind(0)), mine, group=pset.group)
    return rows.cpu().tolist()


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


def _reduce_group(tensors, pset, op, prescale, postscale, compression):
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
        red = _all_reduce(flat, pset, op)
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
    return _group_by_dtype(tensors, lambda g: _reduce_group(
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


def allgather_object(obj, name=None, process_set=None) -> list:
    """One picklable object per member; every member gets the list in
    member order (the reference's ``optim/functions.py:121``)."""
    pset = _pset(process_set)
    if pset.size == 1:
        return [obj]
    out = [None] * pset.size
    dist.all_gather_object(out, obj, group=pset.group)
    return out


# ---------------------------------------------------------------------------
# allgather

def _allgather(tensor: torch.Tensor, pset: ProcessSet) -> torch.Tensor:
    """The members' tensors concatenated along dim 0 (first dims may
    differ; the rest must match); a 0-d tensor counts as one row."""
    x = tensor.reshape(1) if tensor.dim() == 0 else tensor
    was_bool = x.dtype == torch.bool
    if was_bool:
        x = x.to(torch.uint8)
    if pset.size == 1:
        out = x.clone()
    else:
        rows = [r[0] for r in _exchange_ints([x.shape[0]], pset)]
        maxr = max(rows)
        if x.shape[0] < maxr:
            x = torch.cat([x, x.new_zeros((maxr - x.shape[0],)
                                          + tuple(x.shape[1:]))])
        src = x.contiguous().cpu() if _staged(x) else x.contiguous()
        buf = src.new_empty((pset.size,) + tuple(src.shape))
        dist.all_gather(list(buf.unbind(0)), src, group=pset.group)
        out = torch.cat([buf[i, :r] for i, r in enumerate(rows)]) \
            .to(tensor.device)
    return out.to(torch.bool) if was_bool else out


def allgather_async(tensor, name=None, process_set=None) -> int:
    return _put(_allgather(tensor, _pset(process_set)))


def allgather(tensor, name=None, process_set=None):
    return synchronize(allgather_async(tensor, name=name,
                                       process_set=process_set))


def grouped_allgather_async(tensors: Sequence[torch.Tensor], name=None,
                            process_set=None) -> int:
    """One handle for the group: a list of allgathers, each with its
    own first dims."""
    pset = _pset(process_set)
    return _put([_allgather(t, pset) for t in tensors])


def grouped_allgather(tensors, name=None, process_set=None):
    return synchronize(grouped_allgather_async(tensors, name=name,
                                               process_set=process_set))


# ---------------------------------------------------------------------------
# alltoall

def _alltoall(tensor: torch.Tensor, splits, pset: ProcessSet):
    """``(output, received_splits)``: ``splits[i]`` rows of ``tensor``
    go to member i, and ``received_splits[i]`` rows arrive from it."""
    n = pset.size
    if splits is None:
        if tensor.shape[0] % n:
            raise ValueError(
                f"alltoall without splits needs first dim divisible by "
                f"set size ({tensor.shape[0]} % {n})")
        splits = [tensor.shape[0] // n] * n
    splits = [int(s) for s in splits]
    if len(splits) != n:
        raise ValueError(f"splits must have length {n}, got {len(splits)}")
    if sum(splits) != tensor.shape[0]:
        raise ValueError("splits must sum to the first dimension")
    if n == 1:
        return tensor.clone(), torch.tensor(splits, dtype=torch.int32)
    me = pset.rank()
    recv = [row[me] for row in _exchange_ints(splits, pset)]
    was_bool = tensor.dtype == torch.bool
    x = tensor.to(torch.uint8) if was_bool else tensor
    src = x.contiguous().cpu() if _staged(x) else x.contiguous()
    out = src.new_empty((sum(recv),) + tuple(src.shape[1:]))
    dist.all_to_all_single(out, src, output_split_sizes=recv,
                           input_split_sizes=splits, group=pset.group)
    out = out.to(tensor.device)
    return (out.to(torch.bool) if was_bool else out,
            torch.tensor(recv, dtype=torch.int32))


def alltoall_async(tensor, splits=None, name=None, process_set=None) -> int:
    """The handle's result is ``(output, received_splits)`` when
    ``splits`` is given, else the output alone."""
    out, recv = _alltoall(tensor, splits, _pset(process_set))
    return _put(out if splits is None else (out, recv))


def alltoall(tensor, splits=None, name=None, process_set=None):
    return synchronize(alltoall_async(tensor, splits=splits, name=name,
                                      process_set=process_set))


# ---------------------------------------------------------------------------
# reducescatter

def reducescatter_rows(d0: int, n: int) -> List[int]:
    """The reference's uneven sizing rule: first dim split across
    members, the remainder going to low members."""
    base, rem = divmod(d0, n)
    return [base + (1 if i < rem else 0) for i in range(n)]


def _reducescatter_group(tensors, pset, op, prescale, postscale):
    """This member's row block of each tensor's reduction: one
    ``reduce_scatter`` of the destination-major buffer (every tensor's
    chunk for member i padded to its largest chunk)."""
    n = pset.size
    if n == 1:
        one = prescale * postscale
        return [t * torch.tensor(one, dtype=t.dtype, device=t.device)
                if one != 1.0 else t.clone() for t in tensors]
    for t in tensors:
        if t.dim() == 0 or t.shape[0] < n:
            raise ValueError(f"reducescatter needs first dim >= set size "
                             f"({t.shape[0] if t.dim() else 0} < {n})")
    layout = []                         # (rows per member, rest shape)
    pieces = [[] for _ in range(n)]
    for t in tensors:
        rows = reducescatter_rows(t.shape[0], n)
        maxr, rest = max(rows), tuple(t.shape[1:])
        for i, chunk in enumerate(torch.split(t, rows)):
            if chunk.shape[0] < maxr:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (maxr - chunk.shape[0],) + rest)])
            pieces[i].append(chunk.reshape(-1))
        layout.append((rows, maxr, rest))
    buf = torch.stack([torch.cat(p) for p in pieces])
    one = lambda f: torch.tensor(f, dtype=buf.dtype,  # noqa: E731
                                 device=buf.device)
    if prescale != 1.0:
        buf = buf * one(prescale)
    src = buf.cpu() if _staged(buf) else buf
    red = src.new_empty(src.shape[1:])
    dist.reduce_scatter(red, list(src.unbind(0)), group=pset.group)
    red = red.to(buf.device)
    if op == AVERAGE:
        red = red / one(n)
    if postscale != 1.0:
        red = red * one(postscale)
    me, outs, off = pset.rank(), [], 0
    for rows, maxr, rest in layout:
        size = maxr * int(np.prod(rest, dtype=np.int64))
        outs.append(red[off:off + size].view((maxr,) + rest)[:rows[me]])
        off += size
    return outs


def _reducescatter(tensors, op, prescale, postscale, process_set):
    pset = _pset(process_set)
    rop = _resolve_op(op, None)
    if rop not in (SUM, AVERAGE):
        raise ValueError("reducescatter supports Sum and Average only")
    _check_inexact_for_average(rop, tensors)
    return _group_by_dtype(tensors, lambda g: _reducescatter_group(
        g, pset, rop, prescale, postscale))


def reducescatter_async(tensor, op=None, name=None, prescale_factor=1.0,
                        postscale_factor=1.0, process_set=None) -> int:
    return _put(_reducescatter([tensor], op, prescale_factor,
                               postscale_factor, process_set)[0])


def reducescatter(tensor, op=None, name=None, prescale_factor=1.0,
                  postscale_factor=1.0, process_set=None):
    return synchronize(reducescatter_async(
        tensor, op=op, name=name, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set))


def grouped_reducescatter_async(tensors: Sequence[torch.Tensor], op=None,
                                name=None, prescale_factor=1.0,
                                postscale_factor=1.0,
                                process_set=None) -> int:
    return _put(_reducescatter(list(tensors), op, prescale_factor,
                               postscale_factor, process_set))


def grouped_reducescatter(tensors, op=None, name=None, prescale_factor=1.0,
                          postscale_factor=1.0, process_set=None):
    return synchronize(grouped_reducescatter_async(
        tensors, op=op, name=name, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set))


def barrier(process_set=None) -> None:
    """Block until every member of the set reaches the barrier."""
    pset = _pset(process_set)
    if pset.size > 1:
        dist.barrier(group=pset.group)
