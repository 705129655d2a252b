"""Eager collectives on torch tensors: allreduce (Average, Sum, Adasum,
Min, Max, Product), allgather, broadcast, alltoall and reducescatter,
their grouped, async and in-place variants, ``allgather_object``,
``broadcast_object``, ``barrier``, ``join``, ``check_execution_order``,
synchronize, poll and the op constants, each over the global set or a
registered process set.

Port of ``horovod_tpu/ops/collective_ops.py`` (``_controller_for`` l.66,
``_run`` l.80, ``grouped_allreduce_async`` l.103,
``_controller_mixed_group`` l.247, ``allgather_async`` l.358,
``alltoall_async`` l.426, ``reducescatter_async`` l.491, ``barrier``
l.534, ``join`` l.546, ``check_execution_order`` l.578, the ``_pset``
checks l.40-50) with the torch surface of the bridge
(``horovod_tpu/torch/__init__.py:335-583``), on ``torch.distributed``.
The semantics are the reference dispatch's:

- Allreduce: compress, pack the same-wire-dtype group into one flat
  buffer on the tensors' device, multiply by prescale (in the wire
  dtype), reduce across the set (Sum, Min, Max or Product; Product
  keeps the dtype), divide by the set's size (Average), multiply by
  postscale, unpack and decompress (``dispatch._allreduce_kernel``
  l.153-177). In a world of one the reduction is skipped and prescale
  * postscale applied. Adasum: compress each tensor,
  ``ops.adasum.adasum_allreduce`` the same-dtype group as one vector,
  decompress; the controller does this per submitted entry.
- Allgather: the members' first dims are exchanged (or come with the
  negotiated entry), every tensor is padded to the largest, the group
  gathered in one buffer and trimmed (``dispatch.allgather_group``
  l.1526, ``exchange_int_vector`` l.1849); bool rides as uint8.
- Broadcast: the group packed in one buffer, one broadcast from the
  root (``dispatch.broadcast_group`` l.1450).
- Alltoall: ``splits[i]`` rows go to member i (even splits when none
  are given); returns ``(output, received_splits)`` when splits are
  given (``dispatch.alltoall`` l.1609).
- Reducescatter, Sum or Average: member i gets rows
  ``reducescatter_rows(d0, n)[i]`` of the reduction, the remainder
  going to low members, the group in one ``reduce_scatter``
  (``dispatch.reducescatter_group`` l.1798).

A mixed-dtype group splits into same-dtype subgroups, in order of
first appearance. Tensors stay on their device: under the gloo backend
a CUDA tensor goes through host memory for the collective and comes
back. Small control exchanges (first dims, splits, pickled objects)
run on the host under gloo and on the current card under NCCL.

Routing, as the reference's: when the negotiated controller is on
(``ops/controller.py``; by default whenever size > 1), every op over the
global set is submitted to it and returns at once; the controller's
C++ core agrees one order of fused batches on every rank, so ranks may
submit in any order, and its single dispatch thread runs each batch
through the executors above, over world groups of its own, so that
collectives the caller's thread still issues (the train step's
bucketed exchange) never pair with the controller's. Ops over a subset
process set, and every op when the controller is off (a world of one,
or HOROVOD_CONTROLLER=inline), run inline in the caller's thread, and
their members must call them in the same order. Names must be unique
among ops in flight (``name=None`` gives ``<kind>.noname.N``).
``synchronize(handle)`` returns the result (raising the op's error) and
releases the handle; the in-place variants write their tensor before
it returns; ``poll(handle)`` says whether the result is ready. ``join``
needs the controller: a joined rank takes part in the allreduces the
others still submit with zeros, and Average divides by the ranks still
active.

An op before ``init`` raises RuntimeError naming ``init``; an op over a
set that is not registered, or on a rank that is not a member, raises
ValueError.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..common.basics import _require_init
from .adasum import adasum_allreduce
from .bucketing import dtype_name
from .compression import Compression, wire_dtype_of
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


def _unpack(flat: torch.Tensor, like: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
    outs, off = [], 0
    for t in like:
        outs.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return outs


def _wire_nbytes(tensors, compression) -> int:
    return int(sum(t.numel() * wire_dtype_of(compression, t.dtype).itemsize
                   for t in tensors))


def _nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


# ---------------------------------------------------------------------------
# Group executors: one packed buffer and one collective per group. The
# inline path calls them per same-dtype subgroup, the controller's
# dispatch thread once per agreed batch.

def _reduce_group(tensors, pset, op, prescale, postscale, compressors,
                  divisor: Optional[int] = None):
    """Allreduce a group sharing one wire dtype (``compressors``: one
    per tensor) in one flat buffer on the tensors' device. Average
    divides by ``divisor`` (the set's size unless given: the controller
    passes the ranks still active under ``join``)."""
    pairs = [c.compress(t) for c, t in zip(compressors, tensors)]
    wires = [w for w, _ in pairs]
    flat = torch.cat([w.reshape(-1) for w in wires])
    one = lambda f: torch.tensor(f, dtype=flat.dtype,  # noqa: E731
                                 device=flat.device)
    n = pset.size
    if n == 1:
        scale = prescale * postscale
        red = flat * one(scale) if scale != 1.0 else flat
    else:
        if prescale != 1.0:
            flat = flat * one(prescale)
        red = _all_reduce(flat, pset, op)
        if op == AVERAGE:
            red = red / one(n if divisor is None else divisor)
        if postscale != 1.0:
            red = red * one(postscale)
    return [c.decompress(o, ctx) for c, o, (_, ctx)
            in zip(compressors, _unpack(red, wires), pairs)]


def _adasum_group(tensors, pset, prescale, postscale, compressors):
    """Adasum of the group as one vector (``adasum_allreduce``
    concatenates its group)."""
    pairs = [c.compress(t) for c, t in zip(compressors, tensors)]
    outs = adasum_allreduce([w for w, _ in pairs], pset, prescale,
                            postscale)
    return [c.decompress(o, ctx)
            for c, o, (_, ctx) in zip(compressors, outs, pairs)]


def _allreduce_inline(tensors, pset, rop, prescale, postscale,
                      compression) -> List[torch.Tensor]:
    def run(g):
        comps = [compression] * len(g)
        if rop == ADASUM:
            return _adasum_group(g, pset, prescale, postscale, comps)
        return _reduce_group(g, pset, rop, prescale, postscale, comps)
    return _group_by_dtype(tensors, run)


def _broadcast_into(buf: torch.Tensor, root_rank: int,
                    pset: ProcessSet) -> None:
    if pset.size == 1:
        return
    if not _staged(buf):
        dist.broadcast(buf, src=root_rank, group=pset.group)
        return
    host = buf.cpu()
    dist.broadcast(host, src=root_rank, group=pset.group)
    buf.copy_(host)


def _broadcast_group(tensors, root_rank: int, pset: ProcessSet
                     ) -> List[torch.Tensor]:
    """New tensors holding the root's values of a same-dtype group:
    one packed buffer, one broadcast."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    _broadcast_into(flat, root_rank, pset)
    return [o.clone() for o in _unpack(flat, tensors)] \
        if len(tensors) > 1 else [flat.view(tensors[0].shape)]


def _allgather_group(tensors, pset: ProcessSet,
                     rows: Optional[Sequence[Sequence[int]]] = None
                     ) -> List[torch.Tensor]:
    """The members' tensors concatenated along dim 0, for a same-dtype
    group in one ``all_gather`` of one packed buffer (first dims may
    differ across members, the rest must match; a 0-d tensor counts as
    one row). ``rows[j][i]`` is member i's first dim of tensor j: the
    negotiated entries carry it, else it is exchanged here."""
    xs = [t.reshape(1) if t.dim() == 0 else t for t in tensors]
    bools = [x.dtype == torch.bool for x in xs]
    xs = [x.to(torch.uint8) if b else x for x, b in zip(xs, bools)]
    n = pset.size
    if n == 1:
        outs = [x.clone() for x in xs]
    else:
        if rows is None:
            mat = _exchange_ints([x.shape[0] for x in xs], pset)
            rows = [[mat[i][j] for i in range(n)] for j in range(len(xs))]
        rests = [tuple(x.shape[1:]) for x in xs]
        padded = []
        for x, r in zip(xs, rows):
            if x.shape[0] < max(r):
                x = torch.cat([x, x.new_zeros((max(r) - x.shape[0],)
                                              + tuple(x.shape[1:]))])
            padded.append(x.reshape(-1))
        flat = torch.cat(padded)
        src = flat.cpu() if _staged(flat) else flat
        buf = src.new_empty((n, src.numel()))
        dist.all_gather(list(buf.unbind(0)), src, group=pset.group)
        buf = buf.to(flat.device)
        outs, off = [], 0
        for r, rest in zip(rows, rests):
            width = int(np.prod(rest, dtype=np.int64))
            outs.append(torch.cat([
                buf[i, off:off + r[i] * width].view((r[i],) + rest)
                for i in range(n)]))
            off += max(r) * width
    return [o.to(torch.bool) if b else o for o, b in zip(outs, bools)]


def _alltoall(tensor: torch.Tensor, splits, pset: ProcessSet,
              split_matrix: Optional[List[List[int]]] = None):
    """``(output, received_splits)``: ``splits[i]`` rows of ``tensor``
    go to member i, and ``received_splits[i]`` rows arrive from it.
    ``split_matrix`` (every member's splits) comes with the negotiated
    entry, else it is exchanged here."""
    n = pset.size
    if n == 1:
        return tensor.clone(), torch.tensor(splits, dtype=torch.int32)
    me = pset.rank()
    mat = split_matrix or _exchange_ints(splits, pset)
    recv = [row[me] for row in mat]
    was_bool = tensor.dtype == torch.bool
    x = tensor.to(torch.uint8) if was_bool else tensor
    src = x.contiguous().cpu() if _staged(x) else x.contiguous()
    out = src.new_empty((sum(recv),) + tuple(src.shape[1:]))
    dist.all_to_all_single(out, src, output_split_sizes=recv,
                           input_split_sizes=splits, group=pset.group)
    out = out.to(tensor.device)
    return (out.to(torch.bool) if was_bool else out,
            torch.tensor(recv, dtype=torch.int32))


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


# ---------------------------------------------------------------------------
# Routing

def _controller_for(st, pset):
    """The negotiated controller for this op, or None for the inline
    path. Subset process sets dispatch inline: the negotiation is
    world-scoped (the coordinator waits for every non-joined rank), so
    a subset op would block on non-members that never submit."""
    ctl = st.engine.controller
    if ctl is None or pset.size != st.topology.size:
        return None
    return ctl


def _run(st, name: str, nbytes: int, fn, pset) -> int:
    """Route a generic op, ``fn(set)``, through the controller when
    active (the agreed-order path; the set it gets has the dispatch
    thread's own groups), else run it inline over ``pset``."""
    ctl = _controller_for(st, pset)
    if ctl is not None:
        return ctl.submit_generic(name, nbytes, fn, pset).id
    return st.engine.run(name, nbytes, lambda: fn(pset)).id


def synchronize(handle: int):
    """The result of a submitted collective (raising its error);
    releases the handle (a second call raises KeyError)."""
    st = _require_init()
    return st.engine.synchronize(st.engine.get_handle(handle))


def poll(handle: int) -> bool:
    """True when the collective's result is ready; KeyError for an
    unknown or released handle."""
    return _require_init().engine.get_handle(handle).done()


# ---------------------------------------------------------------------------
# allreduce

def _allreduce_async(tensors, average, name, op, prescale, postscale,
                     compression, process_set, kind, grouped,
                     inplace=False) -> int:
    st = _require_init()
    pset = _pset(process_set)
    rop = _resolve_op(op, average)
    tensors = list(tensors)
    _check_inexact_for_average(rop, tensors)
    name = name or st.engine.auto_name(kind)
    ctl = _controller_for(st, pset)
    if ctl is not None:
        wires = [dtype_name(wire_dtype_of(compression, t.dtype))
                 for t in tensors]
        if len(set(wires)) == 1:
            return ctl.submit_allreduce(
                name, tensors, pset, rop, prescale, postscale,
                compression, grouped=grouped, inplace=inplace).id
        # Mixed wire dtypes: one submission per wire dtype under one
        # composite handle (the reference's _controller_mixed_group).
        by_wire: Dict[str, List[int]] = {}
        for i, w in enumerate(wires):
            by_wire.setdefault(w, []).append(i)
        subs = [(ctl.submit_allreduce(
            f"{name}.{w}", [tensors[i] for i in idxs], pset, rop,
            prescale, postscale, compression, grouped=True), idxs)
            for w, idxs in by_wire.items()]

        def assemble(results):
            out: List[Any] = [None] * len(tensors)
            for res, (_, idxs) in zip(results, subs):
                for i, r in zip(idxs, res):
                    out[i] = r
            return out
        return st.engine.new_group_handle(
            name, [h for h, _ in subs], assemble).id

    def fn():
        outs = _allreduce_inline(tensors, pset, rop, prescale, postscale,
                                 compression)
        if inplace:
            with torch.no_grad():
                for t, o in zip(tensors, outs):
                    if o is not t:
                        t.copy_(o)
            outs = tensors
        return outs if grouped else outs[0]

    return st.engine.run(name, _wire_nbytes(tensors, compression), fn).id


def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    compression=Compression.none,
                    process_set=None) -> int:
    return _allreduce_async([tensor], average, name, op, prescale_factor,
                            postscale_factor, compression, process_set,
                            "allreduce", grouped=False)


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
    return _allreduce_async([tensor], average, name, op, prescale_factor,
                            postscale_factor, compression, process_set,
                            "allreduce", grouped=False, inplace=True)


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
    return _allreduce_async(tensors, average, name, op, prescale_factor,
                            postscale_factor, compression, process_set,
                            "grouped_allreduce", grouped=True)


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      prescale_factor=1.0, postscale_factor=1.0,
                      compression=Compression.none, process_set=None):
    return synchronize(grouped_allreduce_async(
        tensors, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, process_set=process_set))


# ---------------------------------------------------------------------------
# broadcast

def _broadcast_async(tensor, root_rank, name, process_set, inplace) -> int:
    st = _require_init()
    pset = _pset(process_set)
    if root_rank not in pset.ranks:
        raise ValueError(f"root_rank {root_rank} not in {pset}")
    name = name or st.engine.auto_name("broadcast")
    ctl = _controller_for(st, pset)
    if ctl is not None:
        return ctl.submit_broadcast(name, tensor, pset.ranks.index(root_rank),
                                    pset, inplace=inplace).id

    def fn():
        if inplace:
            with torch.no_grad():
                _broadcast_into(tensor, root_rank, pset)
            return tensor
        return _broadcast_group([tensor], root_rank, pset)[0]

    return st.engine.run(name, _nbytes([tensor]), fn).id


def broadcast_async(tensor, root_rank, name=None, process_set=None) -> int:
    return _broadcast_async(tensor, root_rank, name, process_set, False)


def broadcast(tensor, root_rank, name=None, process_set=None):
    return synchronize(broadcast_async(tensor, root_rank, name=name,
                                       process_set=process_set))


def broadcast_async_(tensor, root_rank, name=None,
                     process_set=None) -> int:
    """In-place variant: ``tensor`` receives the root's value."""
    return _broadcast_async(tensor, root_rank, name, process_set, True)


def broadcast_(tensor, root_rank, name=None, process_set=None):
    return synchronize(broadcast_async_(tensor, root_rank, name=name,
                                        process_set=process_set))


def broadcast_object(obj, root_rank: int = 0, name=None,
                     process_set=None):
    """A picklable object from ``root_rank`` on every rank."""
    st = _require_init()
    pset = _pset(process_set)
    if root_rank not in pset.ranks:
        raise ValueError(f"root_rank {root_rank} not in {pset}")
    if pset.size == 1:
        return obj

    def fn(ps):
        box = [obj]
        dist.broadcast_object_list(box, src=root_rank, group=ps.group)
        return box[0]

    name = name or st.engine.auto_name("broadcast_object")
    return synchronize(_run(st, name, 0, fn, pset))


def allgather_object(obj, name=None, process_set=None) -> list:
    """One picklable object per member; every member gets the list in
    member order (the reference's ``optim/functions.py:121``)."""
    st = _require_init()
    pset = _pset(process_set)
    if pset.size == 1:
        return [obj]

    def fn(ps):
        out = [None] * ps.size
        dist.all_gather_object(out, obj, group=ps.group)
        return out

    name = name or st.engine.auto_name("allgather_object")
    return synchronize(_run(st, name, 0, fn, pset))


# ---------------------------------------------------------------------------
# allgather

def allgather_async(tensor, name=None, process_set=None) -> int:
    st = _require_init()
    pset = _pset(process_set)
    name = name or st.engine.auto_name("allgather")
    ctl = _controller_for(st, pset)
    if ctl is not None:
        # Uneven first dims ride the negotiation metadata; same-dtype
        # allgathers agreed together run as one gather.
        return ctl.submit_allgather(name, tensor, pset).id
    return st.engine.run(name, _nbytes([tensor]), lambda: _allgather_group(
        [tensor], pset)[0]).id


def allgather(tensor, name=None, process_set=None):
    return synchronize(allgather_async(tensor, name=name,
                                       process_set=process_set))


def grouped_allgather_async(tensors: Sequence[torch.Tensor], name=None,
                            process_set=None) -> int:
    """One handle for the group: a list of allgathers, each with its
    own first dims (one gather per dtype)."""
    st = _require_init()
    pset = _pset(process_set)
    tensors = list(tensors)
    name = name or st.engine.auto_name("grouped_allgather")
    if _controller_for(st, pset) is not None:
        hs = [st.engine.controller.submit_allgather(f"{name}.{i}", t, pset)
              for i, t in enumerate(tensors)]
        return st.engine.new_group_handle(name, hs, list).id
    return st.engine.run(name, _nbytes(tensors), lambda: _group_by_dtype(
        tensors, lambda g: _allgather_group(g, pset))).id


def grouped_allgather(tensors, name=None, process_set=None):
    return synchronize(grouped_allgather_async(tensors, name=name,
                                               process_set=process_set))


# ---------------------------------------------------------------------------
# alltoall

def alltoall_async(tensor, splits=None, name=None, process_set=None) -> int:
    """The handle's result is ``(output, received_splits)`` when
    ``splits`` is given, else the output alone."""
    st = _require_init()
    pset = _pset(process_set)
    n = pset.size
    given = splits is not None
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
    name = name or st.engine.auto_name("alltoall")

    def result(ps, split_matrix=None):
        out, recv = _alltoall(tensor, splits, ps, split_matrix)
        return (out, recv) if given else out

    ctl = _controller_for(st, pset)
    if ctl is not None:
        # Every member's splits ride the negotiation metadata.
        def fn_meta(ps, metas):
            return result(ps, [[int(x) for x in metas[r].split(",")]
                               for r in ps.ranks])
        return ctl.submit_generic(
            name, _nbytes([tensor]), fn_meta, pset,
            meta=",".join(str(s) for s in splits), tensors=[tensor]).id
    return st.engine.run(name, _nbytes([tensor]),
                         lambda: result(pset)).id


def alltoall(tensor, splits=None, name=None, process_set=None):
    return synchronize(alltoall_async(tensor, splits=splits, name=name,
                                      process_set=process_set))


# ---------------------------------------------------------------------------
# reducescatter

def _rs_op(op, tensors) -> int:
    rop = _resolve_op(op, None)
    if rop not in (SUM, AVERAGE):
        raise ValueError("reducescatter supports Sum and Average only")
    _check_inexact_for_average(rop, tensors)
    return rop


def reducescatter_async(tensor, op=None, name=None, prescale_factor=1.0,
                        postscale_factor=1.0, process_set=None) -> int:
    st = _require_init()
    pset = _pset(process_set)
    rop = _rs_op(op, [tensor])
    name = name or st.engine.auto_name("reducescatter")
    ctl = _controller_for(st, pset)
    if ctl is not None:
        return ctl.submit_reducescatter(name, tensor, pset, rop,
                                        prescale_factor,
                                        postscale_factor).id
    return st.engine.run(name, _nbytes([tensor]), lambda: _reducescatter_group(
        [tensor], pset, rop, prescale_factor, postscale_factor)[0]).id


def reducescatter(tensor, op=None, name=None, prescale_factor=1.0,
                  postscale_factor=1.0, process_set=None):
    return synchronize(reducescatter_async(
        tensor, op=op, name=name, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set))


def grouped_reducescatter_async(tensors: Sequence[torch.Tensor], op=None,
                                name=None, prescale_factor=1.0,
                                postscale_factor=1.0,
                                process_set=None) -> int:
    st = _require_init()
    pset = _pset(process_set)
    tensors = list(tensors)
    rop = _rs_op(op, tensors)
    name = name or st.engine.auto_name("grouped_reducescatter")
    ctl = _controller_for(st, pset)
    if ctl is not None:
        hs = [ctl.submit_reducescatter(f"{name}.{i}", t, pset, rop,
                                       prescale_factor, postscale_factor)
              for i, t in enumerate(tensors)]
        return st.engine.new_group_handle(name, hs, list).id
    return st.engine.run(name, _nbytes(tensors), lambda: _group_by_dtype(
        tensors, lambda g: _reducescatter_group(
            g, pset, rop, prescale_factor, postscale_factor))).id


def grouped_reducescatter(tensors, op=None, name=None, prescale_factor=1.0,
                          postscale_factor=1.0, process_set=None):
    return synchronize(grouped_reducescatter_async(
        tensors, op=op, name=name, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set))


# ---------------------------------------------------------------------------
# barrier, join, the order check

def barrier(process_set=None) -> None:
    """Block until every member of the set reaches the barrier."""
    st = _require_init()
    pset = _pset(process_set)
    if pset.size > 1:
        synchronize(_run(st, st.engine.auto_name("barrier"), 4,
                         lambda ps: dist.barrier(group=ps.group), pset))


def join(device: int = -1) -> int:
    """Mark this rank as done submitting; blocks until every rank has
    joined and returns the last rank to join (reference:
    horovod/common/ops/collective_operations.cc JoinOp). Needs the
    negotiated controller (on by default when size > 1, or
    HOROVOD_CONTROLLER=native/python)."""
    st = _require_init()
    if st.engine.controller is None:
        raise NotImplementedError(
            "hvd.join() needs the negotiated controller: run multi-"
            "process (it is on by default) or set "
            "HOROVOD_CONTROLLER=native")
    return st.engine.controller.join()


def check_execution_order() -> int:
    """Assert every rank executed the identical collective sequence.

    Needs HOROVOD_ORDER_CHECK=1: each rank digests executed op names in
    order; this call (itself a collective over the world, which every
    rank must reach at the same point) allgathers the digests and
    raises RuntimeError on divergence. Returns the number of ops folded
    into the digest so far."""
    st = _require_init()
    oc = st.engine.order_check
    if oc is None:
        raise RuntimeError(
            "check_execution_order() needs HOROVOD_ORDER_CHECK=1 "
            "(set before hvd.init())")
    # The gather is named by the number of check calls (the same on
    # every rank), never by the per-rank op count it compares.
    call_idx = oc.checks
    oc.checks += 1
    count = oc.count
    payload = oc.digest() + int(count).to_bytes(8, "big", signed=False)
    dig = torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(
        _control_device())
    rows = allgather(dig, name=f"__order_check__.{call_idx}").cpu() \
        .reshape(-1, dig.numel())
    if not all(torch.equal(rows[0], r) for r in rows[1:]):
        bad = [r for r in range(rows.shape[0])
               if not torch.equal(rows[0], rows[r])]
        counts = [int.from_bytes(bytes(rows[r][-8:].tolist()), "big")
                  for r in range(rows.shape[0])]
        raise RuntimeError(
            f"execution order diverged: rank(s) {bad} executed a "
            f"different collective sequence than rank 0 "
            f"(per-rank op counts: {counts})")
    return count
