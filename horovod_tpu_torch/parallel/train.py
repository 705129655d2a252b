"""Training step: on one device, or data parallel over a mesh of ranks.

Port of ``horovod_tpu/parallel/train.py`` ``build_train_step`` (l.762)
on a pure data-parallel mesh (``parallel/mesh.py``): its knobs
(``overlap_enabled``, ``overlap_threshold_bytes``, ``compression_spec``,
l.53-104), ``last_overlap_info`` (l.106), the bucket plan (``WireGroup``,
``OverlapPlan``, ``_plan_wire``, ``_flag_carrier_group`` and
``plan_overlap``, l.124-309, computed from shapes and dtypes as there),
``init_compression_state`` (l.311), the bucketed reduction of
``_make_bucket_tag``'s backward rule (l.570-654), which also stands for
the monolithic ``reduce_grads`` (l.949-981) and its unanimity vote
(l.916), the PowerSGD round of ``_make_powersgd_tag`` (l.660-757), and
``_finish_step`` (l.1199). A step computes
the local loss on this rank's batch, runs the backward (through every
layer's flash attention kernels on the card), reduces the gradients
over the mesh's data axis and applies the optimizer in place.

- **Bucketed (overlap on, the HOROVOD_JIT_OVERLAP default).** The
  gradients pack into ``overlap_threshold``-byte buckets in reverse
  registration order (``ops/bucketing.py``). A post-accumulate-grad
  hook marks each parameter ready; a bucket launches when all its
  parameters are ready and every earlier bucket of the plan has
  launched, so every rank submits the same collectives in the same
  order. A launch packs the bucket per dtype group, casts floating
  groups to the fp16/bf16 wire, and sends one asynchronous SUM
  allreduce per group; with the guard on, the finite flag rides the
  first float32/float64 group, or goes in an exact float32 allreduce of
  its own where none rides or the wire is cast. After the backward the
  step waits for every bucket, casts back, and scales each gradient by
  1/n in its own dtype.
- **PowerSGD** (``compression="powersgd[:r]"``, bucketed path only).
  ``plan_overlap`` keeps the eligible matrices (``ops/compression.py``
  ``powersgd_eligible``) in buckets of their own, tagged ``powersgd:r``;
  the rest take the exact buckets above. A low-rank bucket's launch
  adds each residual to its gradient (M = g + e, float32), starts the
  SUM allreduce of the packed P = M Q, and with the guard on an exact
  float32 allreduce of its finite flag (the flag never rides the
  factor wire). After the backward the step waits for each bucket's P,
  orthogonalizes it, starts the allreduce of the packed Q' = M^T P,
  then decompresses (P Q'^T, scaled by 1/n in float32 and cast to the
  gradient's dtype) and keeps Q' and e' = M - P Q'^T / n as the next
  step's state. A vetoed step (any bucket's vote) leaves every Q and e
  bitwise as they were.
  The state is the step's ``compression_state()`` / ``set_compression_
  state(state)``, ``{"q": {leaf index: (m, r)}, "e": {leaf index: (n,
  m)}}`` of float32 tensors on the parameters' device.
  HOROVOD_COMPRESSION_WARMUP_STEPS keeps the reference's meaning on
  this plane: the caller runs a ``compression="none"`` step for those
  steps, then this one.
- **Monolithic (overlap off).** No hook: after the backward the same
  buckets launch in plan order and the step waits for them. The
  reference's docstring says its two paths are numerically the same
  (l.828-831); here they are one exchange, so they are bitwise equal
  wherever the sums are (two ranks).

On both paths a custom ``grad_reducer`` receives the SUMMED gradients
as ``{name: gradient}`` and owns the scaling; a failed vote imprints
NaN on the reduced gradients (``numerics.imprint_non_finite``), which a
``numerics.guard_non_finite`` optimizer skips; ``metrics["loss"]`` and
``metrics["aux"]`` are averaged over the batch axes. A mesh of one rank,
or no mesh, has no bucket and no collective: the single-device step.

The ``numerics.grad`` chaos seam (``numerics.maybe_corrupt_grads``)
fires once per step, on the first bucket's gradients before its finite
flag: the reference's jitted step skips the seam (it fires on concrete
values only), the port's step runs eagerly and takes it, as the eager
plane does.

Declared differences from the JAX package: each rank passes its own
batch shard (Horovod's way), not a global batch that shard_map splits;
the step takes the model and updates it in place. Under gloo, CUDA
tensors go through host memory (``ops/collective_ops.py``). Mesh axes
that shard the model are ROADMAP A.9. PowerSGD compresses each torch
parameter as its own matrix in its stored (out, in) layout, where the
reference's flagship tree stacks the layers, (L, in, out), and folds
them into one matrix; the warm-start Q is the port's own draw
(``ops/compression.py``); each rank holds its own residual (n, m), the
rows [r n, (r + 1) n) of the reference's global (n_ranks n, m) one; the
step's veto freezes every low-rank bucket's Q and e, as the reference's
eager plane does, where its jitted step gates each bucket by that
bucket's own flag (so a step vetoed elsewhere still advances it); the
step keeps the state itself instead of taking and returning it, and
``init_compression_state`` returns the state alone (there are no
shard_map specs).

Optimizer parity: the counterpart of ``optax.adamw(lr)`` is
``torch.optim.AdamW(params, lr, betas=(0.9, 0.999), eps=1e-8,
weight_decay=1e-4)``, which ``adamw`` builds. optax's default weight
decay is 1e-4 and torch's is 1e-2, so the decay must be given. Both
decay the parameter before the update (p - lr * (wd * p + m_hat /
(sqrt(v_hat) + eps))) and keep the moments in the parameter's dtype.
"""

from __future__ import annotations

import threading
from typing import (Any, Callable, Dict, Iterable, List, Mapping,
                    NamedTuple, Optional, Tuple)

import numpy as np
import torch

from .. import numerics as _numerics
from ..metrics import record_wire
from ..common.device import DeviceLike, resolve_device
from ..ops.bucketing import (assignment_digest, dtype_name,
                             partition_buckets, split_by_dtype, tree_leaves)
from ..ops.collective_ops import (Average, Sum, _all_reduce_async,
                                  _reduce_group)
from ..ops.compression import (Compression, CompressionSpec,
                                effective_rank, init_q, matrix_shape,
                                powersgd_compress, powersgd_decompress,
                                powersgd_eligible, powersgd_pack,
                                powersgd_project,
                                powersgd_wire_elements, resolve_compression)
from .mesh import Mesh, _live_axes, batch_axes, require_data_parallel


def adamw(params: Iterable[torch.nn.Parameter],
          lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)`` with optax's defaults, as torch's AdamW."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def overlap_enabled() -> bool:
    """The HOROVOD_JIT_OVERLAP knob (build-time read, Config-aware)."""
    from ..common.config import knob_default
    return bool(_numerics._cfg("HOROVOD_JIT_OVERLAP",
                               knob_default("HOROVOD_JIT_OVERLAP")))


def overlap_threshold_bytes() -> int:
    """Bucket size: the HOROVOD_FUSION_THRESHOLD knob."""
    from ..common.config import knob_default
    return int(_numerics._cfg("HOROVOD_FUSION_THRESHOLD",
                              knob_default("HOROVOD_FUSION_THRESHOLD")))


_WIRE_DTYPES = {"fp16": torch.float16, "bf16": torch.bfloat16}


def compression_spec(compression: Optional[str] = None,
                     rank: Optional[int] = None,
                     min_elements: Optional[int] = None) -> CompressionSpec:
    """Resolve the builder's compression config: explicit arguments win,
    else the HOROVOD_COMPRESSION knob family (Config-aware, like the
    overlap knobs). A rank given here wins over a "powersgd:r" suffix,
    which wins over HOROVOD_COMPRESSION_RANK."""
    from ..common.config import knob_default
    name = compression
    if name is None:
        name = str(_numerics._cfg("HOROVOD_COMPRESSION",
                                  knob_default("HOROVOD_COMPRESSION")))
    if rank is None and not any(c in str(name) for c in ":("):
        rank = int(_numerics._cfg(
            "HOROVOD_COMPRESSION_RANK",
            knob_default("HOROVOD_COMPRESSION_RANK")))
    if min_elements is None:
        min_elements = int(_numerics._cfg(
            "HOROVOD_COMPRESSION_MIN_ELEMENTS",
            knob_default("HOROVOD_COMPRESSION_MIN_ELEMENTS")))
    return resolve_compression(name, rank=rank, min_elements=min_elements)


# The LAST build_train_step's overlap resolution (written at build time,
# traced=False) and the bucket plan of its first step (traced=True).
_last_overlap_info: dict = {}


def last_overlap_info() -> dict:
    return dict(_last_overlap_info)


# ---------------------------------------------------------------------------
# The plan

class WireGroup(NamedTuple):
    """One per-dtype wire array of a bucket's reduction. ``n`` counts
    payload elements including the finite flag when it rides this
    group; ``natural_shape`` is the leaf's shape when the group is one
    leaf with nothing riding it."""
    dtype: str
    n: int
    rides_flag: bool
    natural_shape: Optional[Tuple[int, ...]]


class OverlapPlan(NamedTuple):
    """The bucketed reduction plan; indices refer to ``tree_leaves``
    order (an ``nn.Module``'s parameters in registration order).
    ``digest`` is what every rank must derive identically."""
    threshold: int
    guard: bool
    n_leaves: int
    bucket_leaf_indices: Tuple[Tuple[int, ...], ...]
    bucket_raxes: Tuple[Tuple[str, ...], ...]
    bucket_nbytes: Tuple[int, ...]
    wire: Tuple[Tuple[WireGroup, ...], ...]
    digest: str
    leaf_raxes: Tuple[Tuple[str, ...], ...]
    loose_inexact: Tuple[int, ...]
    bucket_compression: Tuple[str, ...] = ()


def _is_inexact(dtype: Any) -> bool:
    return dtype_name(dtype).startswith(("float", "bfloat", "complex"))


def _itemsize(name: str) -> int:
    return 2 if name == "bfloat16" else np.dtype(name).itemsize


def _numel(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def _flag_carrier_group(groups, dtypes) -> Optional[int]:
    """Index of the dtype group whose reduction the finite flag rides:
    the first float32/float64 group (a vote count in a 16-bit wire
    stops being exact), or None."""
    for gi, positions in enumerate(groups):
        if dtype_name(dtypes[positions[0]]) in ("float32", "float64"):
            return gi
    return None


def _plan_wire(idxs, leaves, guard: bool,
               comp: str = "none") -> Tuple[WireGroup, ...]:
    """Per-dtype wire groups of one bucket, from shapes and dtypes; a
    "powersgd:r" bucket's are its two float32 factor allreduces, packed
    P then packed Q (its flag is an allreduce of its own, no group)."""
    dtypes = [dtype_name(leaves[i].dtype) for i in idxs]
    shapes = [tuple(leaves[i].shape) for i in idxs]
    if comp.startswith("powersgd"):
        rank = int(comp.split(":", 1)[1])
        els = [powersgd_wire_elements(s, rank) for s in shapes]
        return (WireGroup("float32", sum(e[0] for e in els), False, None),
                WireGroup("float32", sum(e[1] for e in els), False, None))
    groups = split_by_dtype(dtypes)
    if comp in _WIRE_DTYPES:
        out = []
        for positions in groups:
            wd = (dtype_name(_WIRE_DTYPES[comp])
                  if _is_inexact(dtypes[positions[0]])
                  and not dtypes[positions[0]].startswith("complex")
                  else dtypes[positions[0]])
            n = sum(_numel(shapes[p]) for p in positions)
            natural = shapes[positions[0]] if len(positions) == 1 else None
            out.append(WireGroup(wd, n, False, natural))
        return tuple(out)
    has_inexact = any(_is_inexact(d) for d in dtypes)
    flag_gi = (_flag_carrier_group(groups, dtypes)
               if guard and has_inexact else None)
    out = []
    for gi, positions in enumerate(groups):
        rides = flag_gi is not None and gi == flag_gi
        n = sum(_numel(shapes[p]) for p in positions)
        if len(positions) == 1 and not rides:
            out.append(WireGroup(dtypes[positions[0]], n, False,
                                 shapes[positions[0]]))
        else:
            out.append(WireGroup(dtypes[positions[0]],
                                 n + (1 if rides else 0), rides, None))
    return tuple(out)


def _bucketable(leaf) -> bool:
    """Inexact, and not a parameter left out of the backward."""
    return _is_inexact(leaf.dtype) and not (
        isinstance(leaf, torch.nn.Parameter) and not leaf.requires_grad)


def plan_overlap(params: Any, mesh: Optional[Mesh], *,
                 overlap_threshold: Optional[int] = None,
                 guard: Optional[bool] = None,
                 compression: Optional[str] = None,
                 compression_rank: Optional[int] = None,
                 compression_min_elements: Optional[int] = None
                 ) -> OverlapPlan:
    """The bucket plan ``build_train_step(overlap=True)`` follows: a
    pure function of the leaves' order, shapes and dtypes, the mesh's
    axis sizes, the threshold, the guard and the compression config, so
    every rank derives the same plan. Defaults are the builder's (the
    HOROVOD_FUSION_THRESHOLD, HOROVOD_NUMERICS_GUARD and
    HOROVOD_COMPRESSION knobs). Parameters that need no gradient are
    left out, as integer leaves are in the JAX package. Under powersgd
    the eligible leaves form bucket families of their own (the
    partition key is (reduce axes, eligible)), each bucket is tagged
    "powersgd:r" or "none", and the digest carries the tags."""
    require_data_parallel(mesh)
    bthresh = (overlap_threshold_bytes() if overlap_threshold is None
               else int(overlap_threshold))
    g = _numerics.guard_enabled() if guard is None else bool(guard)
    spec = compression_spec(compression, compression_rank,
                            compression_min_elements)
    leaves = tree_leaves(params)
    live = _live_axes(mesh)
    raxes_of = [live for _ in leaves]
    bucketable = [i for i in range(len(leaves))
                  if raxes_of[i] and _bucketable(leaves[i])]
    lowrank = ({i for i in bucketable if raxes_of[i] == live
                and powersgd_eligible(leaves[i].shape, leaves[i].dtype,
                                      spec.min_elements)}
               if spec.kind == "powersgd" else set())
    parts = partition_buckets(
        [leaves[i] for i in bucketable], bthresh,
        key_fn=lambda j, leaf: (raxes_of[bucketable[j]],
                                bucketable[j] in lowrank))
    bucket_idx = tuple(tuple(bucketable[j] for j in b.indices)
                       for b in parts)
    bucketed = {i for idxs in bucket_idx for i in idxs}
    if spec.kind == "powersgd":
        comp_tags = tuple(spec.tag() if idxs[0] in lowrank else "none"
                          for idxs in bucket_idx)
    else:
        comp_tags = tuple(spec.kind for _ in bucket_idx)
    return OverlapPlan(
        threshold=bthresh, guard=g, n_leaves=len(leaves),
        bucket_leaf_indices=bucket_idx,
        bucket_raxes=tuple(raxes_of[idxs[0]] for idxs in bucket_idx),
        bucket_nbytes=tuple(int(b.nbytes) for b in parts),
        wire=tuple(_plan_wire(idxs, leaves, g, comp_tags[bid])
                   for bid, idxs in enumerate(bucket_idx)),
        digest=assignment_digest(
            parts, compression=comp_tags if spec.kind != "none" else None),
        leaf_raxes=tuple(raxes_of),
        loose_inexact=tuple(i for i in range(len(leaves))
                            if i not in bucketed and _bucketable(leaves[i])),
        bucket_compression=comp_tags)


def _wire_bytes(plan: OverlapPlan) -> int:
    return int(sum(g.n * _itemsize(g.dtype)
                   for groups in plan.wire for g in groups))


def init_compression_state(params: Any, mesh: Optional[Mesh], *,
                           compression: Optional[str] = None,
                           compression_rank: Optional[int] = None,
                           compression_min_elements: Optional[int] = None,
                           overlap_threshold: Optional[int] = None,
                           guard: Optional[bool] = None
                           ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The PowerSGD state a ``compression="powersgd..."`` step starts
    from: ``{"q": {str(leaf index): (m, r)}, "e": {str(leaf index): (n,
    m)}}``, float32 on each parameter's device, keyed by the leaves of
    the same ``plan_overlap``'s low-rank buckets. Q is ``init_q``'s warm
    start (the same on every rank); e, this rank's residual, is zero."""
    plan = plan_overlap(params, mesh, overlap_threshold=overlap_threshold,
                        guard=guard, compression=compression,
                        compression_rank=compression_rank,
                        compression_min_elements=compression_min_elements)
    leaves = tree_leaves(params)
    state: Dict[str, Dict[str, torch.Tensor]] = {"q": {}, "e": {}}
    for bid, idxs in enumerate(plan.bucket_leaf_indices):
        tag = plan.bucket_compression[bid]
        if not tag.startswith("powersgd"):
            continue
        rank = int(tag.split(":", 1)[1])
        for i in idxs:
            shape, dev = tuple(leaves[i].shape), leaves[i].device
            state["q"][str(i)] = init_q(shape, rank, i, dev)
            state["e"][str(i)] = torch.zeros(matrix_shape(shape),
                                             dtype=torch.float32, device=dev)
    return state


# ---------------------------------------------------------------------------
# The bucketed exchange of one step

class _Group(NamedTuple):
    positions: List[int]     # into the bucket's leaves
    pending: Any             # collective_ops._PendingReduce
    dtype: torch.dtype       # the group's own dtype (before the cast)
    rides: bool


class _LowRank:
    """A PowerSGD bucket in flight: M and P per leaf, the packed P's
    allreduce, then Q's, and the flag's."""

    def __init__(self, ms, ps, pending, flag_pending, nbytes):
        self.ms, self.ps, self.pending = ms, ps, pending
        self.flag_pending, self.nbytes = flag_pending, nbytes
        self.out_ps = self.qns = self.q_pending = None


class _BucketExchange:
    """One step's bucketed reduction: ``ready(i)`` from parameter i's
    hook (overlap on), ``finish()`` after the backward. ``cstate`` is
    the PowerSGD state the low-rank buckets read and update."""

    def __init__(self, plan: OverlapPlan, params: List[torch.Tensor],
                 pset, n_devices: int, wire_dtype: Optional[torch.dtype],
                 guard: bool, scale: Optional[float],
                 probe: Optional[Callable], cstate=None):
        self.plan, self.params, self.pset = plan, params, pset
        self.n_devices, self.wire_dtype = n_devices, wire_dtype
        self.guard, self.scale, self.probe = guard, scale, probe
        self.cstate = cstate
        self.bucket_of = {i: b for b, idxs in
                          enumerate(plan.bucket_leaf_indices) for i in idxs}
        self.waiting = [len(idxs) for idxs in plan.bucket_leaf_indices]
        self.next = 0
        self.launched: List[Any] = []
        self.callbacks: List[Any] = []
        self._lock = threading.Lock()

    def ready(self, i: int) -> None:
        with self._lock:
            self.waiting[self.bucket_of[i]] -= 1
            while self.next < len(self.waiting) and \
                    self.waiting[self.next] == 0:
                self.launch(self.next)
                self.next += 1

    def _on_reduced(self, pending, bid: int, nbytes: int) -> None:
        probe = self.probe
        self.callbacks.append(pending.future.then(
            lambda _f: probe(bid, "reduced", nbytes)))

    def _grads(self, bid: int) -> List[torch.Tensor]:
        """Bucket ``bid``'s gradients (zeros where a parameter got none);
        the first bucket's pass the ``numerics.grad`` seam."""
        idxs = self.plan.bucket_leaf_indices[bid]
        for i in idxs:
            p = self.params[i]
            if p.grad is None:          # no gradient this step: zeros
                p.grad = torch.zeros_like(p)
        grads = [self.params[i].grad for i in idxs]
        if bid == 0:
            seamed = _numerics.maybe_corrupt_grads(grads)
            if seamed is not grads:
                for i, g in zip(idxs, seamed):
                    self.params[i].grad = g
                grads = seamed
        return grads

    def launch(self, bid: int) -> None:
        """Pack bucket ``bid`` per dtype group, cast, and start one
        allreduce per group (and the flag's own where it rides none);
        a PowerSGD bucket starts its P allreduce."""
        grads = self._grads(bid)
        if self.plan.bucket_compression[bid].startswith("powersgd"):
            self._launch_lowrank(bid, grads)
            return
        dtypes = [g.dtype for g in grads]
        groups = split_by_dtype(dtypes)
        flag = (_numerics.local_finite_flag(grads)
                if self.guard and any(_is_inexact(d) for d in dtypes)
                else None)
        flag_gi = (_flag_carrier_group(groups, dtypes)
                   if flag is not None and self.wire_dtype is None else None)
        out = []
        for gi, positions in enumerate(groups):
            rides = flag is not None and gi == flag_gi
            parts = [grads[p].reshape(-1) for p in positions]
            if rides:
                parts.append(flag.to(parts[0].dtype).reshape(1))
            flat = torch.cat(parts) if len(parts) > 1 else parts[0]
            gdt = flat.dtype
            if self.wire_dtype is not None and flat.is_floating_point():
                flat = flat.to(self.wire_dtype)
            nbytes = flat.numel() * flat.element_size()
            if self.probe is not None:
                self.probe(bid, "ready", nbytes)
            pending = _all_reduce_async(flat, self.pset, Sum)
            if self.probe is not None:
                self._on_reduced(pending, bid, nbytes)
            out.append(_Group(positions, pending, gdt, rides))
        flag_pending = None
        if flag is not None and flag_gi is None:
            flag_pending = _all_reduce_async(flag.reshape(1), self.pset, Sum)
        self.launched.append((out, flag_pending))

    def _launch_lowrank(self, bid: int, grads: List[torch.Tensor]) -> None:
        idxs = self.plan.bucket_leaf_indices[bid]
        flag = _numerics.local_finite_flag(grads) if self.guard else None
        ms, ps = powersgd_compress(
            [g.reshape(matrix_shape(g.shape)) for g in grads],
            [self.cstate["q"][str(i)] for i in idxs],
            [self.cstate["e"][str(i)] for i in idxs])
        nbytes = 4 * sum(g.n for g in self.plan.wire[bid])
        if self.probe is not None:
            self.probe(bid, "ready", nbytes)
        pending = _all_reduce_async(powersgd_pack(ps), self.pset, Sum)
        flag_pending = (_all_reduce_async(flag.reshape(1), self.pset, Sum)
                        if flag is not None else None)
        self.launched.append(_LowRank(ms, ps, pending, flag_pending, nbytes))

    def _finish_lowrank(self, bid: int, lr: _LowRank):
        """Decompress a low-rank bucket into its ``.grad``s; returns
        its vote (None with the guard off) and its new state,
        ``{leaf key: (q, e)}``."""
        idxs = self.plan.bucket_leaf_indices[bid]
        outs, new_qs, new_es = powersgd_decompress(
            lr.ms, lr.out_ps, lr.qns, lr.q_pending.wait(), self.n_devices)
        vote = None
        if lr.flag_pending is not None:
            vote = lr.flag_pending.wait()[0] > self.n_devices - 0.5
        for i, out in zip(idxs, outs):
            p = self.params[i]
            if self.scale is not None:
                out = out * torch.tensor(self.scale, dtype=out.dtype,
                                         device=out.device)
            p.grad = out.reshape(p.shape).to(p.dtype)
        return vote, {str(i): qe for i, qe in zip(idxs,
                                                  zip(new_qs, new_es))}

    def finish(self) -> Optional[torch.Tensor]:
        """Launch what no hook launched (parameters without a gradient),
        wait for every bucket, unpack, cast back and scale into each
        parameter's ``.grad``, and keep the new PowerSGD state unless
        the step is vetoed. Returns the step's vote, every bucket's
        (None with the guard off)."""
        with self._lock:
            while self.next < len(self.waiting):
                self.launch(self.next)
                self.next += 1
        # Each low-rank bucket's Q' allreduce starts as soon as its P is
        # in, in plan order, while the later buckets' traffic flows.
        for bid, lr in enumerate(self.launched):
            if isinstance(lr, _LowRank):
                lr.out_ps, lr.qns = powersgd_project(lr.ms, lr.ps,
                                                     lr.pending.wait())
                lr.q_pending = _all_reduce_async(powersgd_pack(lr.qns),
                                                 self.pset, Sum)
                if self.probe is not None:
                    self._on_reduced(lr.q_pending, bid, lr.nbytes)
        votes, new_state = [], {}
        for bid, entry in enumerate(self.launched):
            if isinstance(entry, _LowRank):
                vote, state = self._finish_lowrank(bid, entry)
                new_state.update(state)
                if vote is not None:
                    votes.append(vote)
                continue
            groups, flag_pending = entry
            idxs = self.plan.bucket_leaf_indices[bid]
            rflag = None
            for grp in groups:
                red = grp.pending.wait()
                if red.dtype != grp.dtype:
                    red = red.to(grp.dtype)
                if grp.rides:
                    rflag = red[-1].to(torch.float32)
                    red = red[:-1]
                off = 0
                for pos in grp.positions:
                    p = self.params[idxs[pos]]
                    n = p.numel()
                    seg = red[off:off + n].view(p.shape)
                    if self.scale is not None:
                        seg = seg * torch.tensor(self.scale, dtype=seg.dtype,
                                                 device=seg.device)
                    p.grad = seg
                    off += n
            if flag_pending is not None:
                rflag = flag_pending.wait()[0]
            if rflag is not None:
                votes.append(rflag > self.n_devices - 0.5)
        ok = None
        for vote in votes:
            ok = vote if ok is None else torch.logical_and(
                ok, vote.to(ok.device))
        for key, (q, e) in new_state.items():
            if ok is not None:          # a veto keeps every Q and e
                q = torch.where(ok, q, self.cstate["q"][key])
                e = torch.where(ok, e, self.cstate["e"][key])
            self.cstate["q"][key], self.cstate["e"][key] = q, e
        for fut in self.callbacks:
            fut.wait()
        return ok


# ---------------------------------------------------------------------------
# The step

def _tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every tensor of a tree of mappings, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def build_train_step(
    loss_fn: Callable[..., Any],
    optimizer: torch.optim.Optimizer,
    device: DeviceLike = None,
    *,
    loss_has_aux: bool = False,
    mesh: Optional[Mesh] = None,
    grad_reducer: Optional[Callable[[Dict[str, torch.Tensor]],
                                    Dict[str, torch.Tensor]]] = None,
    overlap: Optional[bool] = None,
    overlap_threshold: Optional[int] = None,
    overlap_probe: Optional[Callable[[int, str, int], None]] = None,
    compression: Optional[str] = None,
    compression_rank: Optional[int] = None,
    compression_min_elements: Optional[int] = None,
) -> Callable[[torch.nn.Module, Mapping[str, Any]], Dict[str, Any]]:
    """Build ``step(model, batch) -> metrics``.

    ``loss_fn(model, batch)`` returns the local loss on this rank's
    batch (or ``(loss, aux)`` with ``loss_has_aux=True``); ``optimizer``
    holds the model's parameters. A step moves the batch's arrays to
    ``device`` (the card unless ``device="cpu"``), clears the gradients,
    runs forward and backward, reduces the gradients over ``mesh``
    (``mesh.data_parallel_mesh()``; None: no reduction) as the module
    docstring says, and steps the optimizer. ``metrics["loss"]`` (and
    ``metrics["aux"]``) are detached tensors on the device, averaged
    over the mesh's batch axes.

    ``overlap`` (default HOROVOD_JIT_OVERLAP) picks the bucketed path,
    ``overlap_threshold`` its bucket size (default
    HOROVOD_FUSION_THRESHOLD) and ``compression`` its wire ("none",
    "fp16", "bf16" or "powersgd[:r]", with ``compression_rank`` and
    ``compression_min_elements``; default the HOROVOD_COMPRESSION knob
    family), which needs the bucketed path. ``overlap_probe(bucket_id,
    phase, nbytes)`` is called with "ready" when a bucket's group (a
    PowerSGD bucket's P) is launched and "reduced" when its allreduce
    (a PowerSGD bucket's Q') completes (from the collective's thread),
    as ``tracing.OverlapProbe`` records them. ``grad_reducer`` receives
    the summed gradients ``{name: gradient}`` and returns the gradients
    to apply, scaled as it sees fit.

    Under powersgd the returned step also has ``compression_state()``,
    the live ``{"q": ..., "e": ...}`` state (``init_compression_state``
    at the first step), and ``set_compression_state(state)``, which
    replaces it (checked against the plan at the next step)."""
    dev = resolve_device(device, "build_train_step")
    require_data_parallel(mesh)
    cspec = compression_spec(compression, compression_rank,
                             compression_min_elements)
    comp = cspec.tag()
    use_overlap = overlap_enabled() if overlap is None else bool(overlap)
    bthresh = (overlap_threshold_bytes() if overlap_threshold is None
               else int(overlap_threshold))
    if comp != "none" and not use_overlap:
        raise ValueError(
            f"HOROVOD_COMPRESSION={comp} requires the bucketed "
            "overlap path (the buckets are the compression carrier); "
            "enable HOROVOD_JIT_OVERLAP / overlap=True or set "
            "compression='none'")
    guard = _numerics.guard_enabled()
    live = _live_axes(mesh)
    pset = mesh.process_set if mesh is not None else None
    n_devices = mesh.size if mesh is not None else 1
    n_batch = 1
    for a in batch_axes(mesh) if mesh is not None else ():
        n_batch *= mesh.shape[a]
    scale = (1.0 / n_batch
             if grad_reducer is None and n_batch != 1 else None)
    wire_dtype = _WIRE_DTYPES.get(comp)
    use_powersgd = cspec.kind == "powersgd"

    _last_overlap_info.clear()
    _last_overlap_info.update(enabled=use_overlap, threshold=bthresh,
                              traced=False)

    # The model the step last saw: its parameters, names and plan; the
    # PowerSGD state (``cstate``), and one set for the next step
    # (``given``).
    bound: Dict[str, Any] = {"model": None, "cstate": None, "given": None}

    def bind(model: torch.nn.Module) -> None:
        named = list(model.named_parameters())
        plan = plan_overlap(model, mesh, overlap_threshold=bthresh,
                            guard=guard, compression=comp,
                            compression_min_elements=cspec.min_elements)
        bound.update(model=model, names=[n for n, _ in named],
                     params=[p for _, p in named], plan=plan, cstate=None)
        if use_overlap:
            _last_overlap_info.clear()
            _last_overlap_info.update(
                enabled=True, traced=True, threshold=bthresh,
                buckets=len(plan.bucket_leaf_indices),
                bucket_bytes=list(plan.bucket_nbytes),
                bucket_leaves=[len(idxs)
                               for idxs in plan.bucket_leaf_indices],
                n_leaves=plan.n_leaves, digest=plan.digest,
                compression=comp,
                raw_bucket_bytes=int(sum(plan.bucket_nbytes)),
                wire_bucket_bytes=_wire_bytes(plan))

    def compression_state_for(model: torch.nn.Module):
        """The state this step runs with: a given one, checked, else
        the one in use, else a fresh one."""
        if bound["given"] is not None:
            bound["cstate"] = _checked_state(bound["given"], bound["plan"],
                                             bound["params"])
            bound["given"] = None
        elif bound["cstate"] is None:
            bound["cstate"] = init_compression_state(
                model, mesh, compression=comp,
                compression_min_elements=cspec.min_elements,
                overlap_threshold=bthresh, guard=guard)
        return bound["cstate"]

    def batch_mean(x: torch.Tensor) -> torch.Tensor:
        # Off the eager engine, like the bucketed exchange: the
        # reference averages inside the jitted step.
        return _reduce_group([x], pset, Average, 1.0, 1.0,
                             [Compression.none])[0] if live else x

    def step(model: torch.nn.Module,
             batch: Mapping[str, Any]) -> Dict[str, Any]:
        first = next(model.parameters())
        if first.device != dev:
            raise ValueError(f"build_train_step: the model lies on "
                             f"{first.device}, the step runs on {dev}")
        if bound["model"] is not model:
            bind(model)
        params, plan = bound["params"], bound["plan"]
        cstate = compression_state_for(model) if use_powersgd else None
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        optimizer.zero_grad(set_to_none=True)
        exchange, hooks = None, []
        if plan.bucket_leaf_indices:    # a live axis
            exchange = _BucketExchange(plan, params, pset, n_devices,
                                       wire_dtype, guard, scale,
                                       overlap_probe, cstate)
            record_wire(comp, int(sum(plan.bucket_nbytes)),
                        _wire_bytes(plan))
            if use_overlap:
                hooks = [params[i].register_post_accumulate_grad_hook(
                    lambda _p, i=i: exchange.ready(i))
                    for idxs in plan.bucket_leaf_indices for i in idxs]
        try:
            out = loss_fn(model, batch)
            loss, aux = out if loss_has_aux else (out, None)
            loss.backward()
        finally:
            for h in hooks:
                h.remove()
        ok = None
        if exchange is not None:
            ok = exchange.finish()
        elif guard:                     # one rank: its own vote
            ok = _numerics.local_finite_flag(
                [p.grad for p in params if p.grad is not None]) > 0.5
        with_grad = {n: p for n, p in zip(bound["names"], params)
                     if p.grad is not None}
        grads = {n: p.grad for n, p in with_grad.items()}
        if grad_reducer is not None:
            grads = grad_reducer(grads)
        if ok is not None:
            grads = _numerics.imprint_non_finite(grads, ok)
        for n, p in with_grad.items():
            p.grad = grads[n]
        metrics = {"loss": batch_mean(loss.detach())}
        if loss_has_aux:
            metrics["aux"] = _tree_map(lambda a: batch_mean(a.detach()),
                                       aux)
        optimizer.step()
        return metrics

    if use_powersgd:
        def compression_state() -> Dict[str, Dict[str, torch.Tensor]]:
            """The live PowerSGD state (None before the first step,
            unless one was set)."""
            return bound["given"] or bound["cstate"]

        def set_compression_state(state: Mapping[str, Mapping[str, Any]]
                                  ) -> None:
            """Replace the PowerSGD state: ``{"q": {...}, "e": {...}}``
            keyed by leaf index; taken as float32 on each parameter's
            device at the next step, which checks its keys and shapes
            against the plan."""
            bound["given"] = {k: dict(state[k]) for k in ("q", "e")}

        step.compression_state = compression_state
        step.set_compression_state = set_compression_state
    return step


def _checked_state(state, plan: OverlapPlan, params: List[torch.Tensor]):
    """``state`` as float32 tensors on each parameter's device, after
    checking that it holds exactly the plan's low-rank leaves, Q at
    (m, r) and e at (n, m); a mismatch raises rather than drop the
    residual or put another rank's factors on the wire."""
    rank_of = {str(i): int(plan.bucket_compression[bid].split(":", 1)[1])
               for bid, idxs in enumerate(plan.bucket_leaf_indices)
               if plan.bucket_compression[bid].startswith("powersgd")
               for i in idxs}
    have = set(state["q"])
    if have != set(rank_of) or set(state["e"]) != set(rank_of):
        raise ValueError(
            f"compression state does not match the compressed leaf set "
            f"(state has {sorted(have)}, plan compresses "
            f"{sorted(rank_of, key=int)}); build it with "
            f"init_compression_state under the same mesh, threshold and "
            f"compression config")
    out: Dict[str, Dict[str, torch.Tensor]] = {"q": {}, "e": {}}
    for key, rank in rank_of.items():
        p = params[int(key)]
        n, m = matrix_shape(p.shape)
        want = {"q": (m, effective_rank(p.shape, rank)), "e": (n, m)}
        for part, shape in want.items():
            t = torch.as_tensor(state[part][key]).to(
                device=p.device, dtype=torch.float32)
            if tuple(t.shape) != shape:
                raise ValueError(f"compression state {part}[{key}] is "
                                 f"{tuple(t.shape)}, not {shape}, for a "
                                 f"parameter of shape {tuple(p.shape)}")
            out[part][key] = t
    return out
