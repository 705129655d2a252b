"""Training step: on one device, or data parallel over a mesh of ranks.

Port of ``horovod_tpu/parallel/train.py`` ``build_train_step`` (l.762)
on a pure data-parallel mesh (``parallel/mesh.py``): its knobs
(``overlap_enabled``, ``overlap_threshold_bytes``, ``compression_spec``,
l.53-104), ``last_overlap_info`` (l.106), the bucket plan (``WireGroup``,
``OverlapPlan``, ``_plan_wire``, ``_flag_carrier_group`` and
``plan_overlap``, l.124-309, computed from shapes and dtypes as there),
the bucketed reduction of ``_make_bucket_tag``'s backward rule
(l.570-654), which also stands for the monolithic ``reduce_grads``
(l.949-981) and its unanimity vote (l.916), and ``_finish_step``
(l.1199). A step computes
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

Declared differences from the JAX package: each rank passes its own
batch shard (Horovod's way), not a global batch that shard_map splits;
the step takes the model and updates it in place. Under gloo, CUDA
tensors go through host memory (``ops/collective_ops.py``). PowerSGD
compression is ROADMAP A.8 and mesh axes that shard the model are A.9.

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
from ..ops.collective_ops import Average, Sum, _all_reduce_async, allreduce
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


def compression_spec(compression: Optional[str] = None) -> str:
    """Resolve the builder's compression to the wire transform of every
    bucket, the reference's tag: the argument, else the
    HOROVOD_COMPRESSION knob. Accepted: "none", "fp16", "bf16"; PowerSGD
    ("powersgd", "powersgd:4", "powersgd(rank=4)") raises, citing
    ROADMAP A.8; anything else raises ValueError."""
    from ..common.config import knob_default
    name = compression
    if name is None:
        name = str(_numerics._cfg("HOROVOD_COMPRESSION",
                                  knob_default("HOROVOD_COMPRESSION")))
    raw = str(name).strip().lower()
    if raw.startswith("powersgd"):
        raise NotImplementedError(
            f"compression={raw!r}: PowerSGD is not ported yet (ROADMAP "
            f"A.8); the port takes none, fp16 and bf16")
    if raw not in ("none", "fp16", "bf16"):
        raise ValueError(
            f"unknown HOROVOD_COMPRESSION value {raw!r} (expected "
            f"none / fp16 / bf16 / powersgd[:rank])")
    return raw


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
    """Per-dtype wire groups of one bucket, from shapes and dtypes."""
    dtypes = [dtype_name(leaves[i].dtype) for i in idxs]
    shapes = [tuple(leaves[i].shape) for i in idxs]
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
                 compression: Optional[str] = None) -> OverlapPlan:
    """The bucket plan ``build_train_step(overlap=True)`` follows: a
    pure function of the leaves' order, shapes and dtypes, the mesh's
    axis sizes, the threshold, the guard and the compression, so every
    rank derives the same plan. Defaults are the builder's (the
    HOROVOD_FUSION_THRESHOLD, HOROVOD_NUMERICS_GUARD and
    HOROVOD_COMPRESSION knobs). Parameters that need no gradient are
    left out, as integer leaves are in the JAX package."""
    require_data_parallel(mesh)
    bthresh = (overlap_threshold_bytes() if overlap_threshold is None
               else int(overlap_threshold))
    g = _numerics.guard_enabled() if guard is None else bool(guard)
    comp = compression_spec(compression)
    leaves = tree_leaves(params)
    live = _live_axes(mesh)
    raxes_of = [live for _ in leaves]
    bucketable = [i for i in range(len(leaves))
                  if raxes_of[i] and _bucketable(leaves[i])]
    parts = partition_buckets([leaves[i] for i in bucketable], bthresh,
                              key_fn=lambda j, leaf: raxes_of[
                                  bucketable[j]])
    bucket_idx = tuple(tuple(bucketable[j] for j in b.indices)
                       for b in parts)
    bucketed = {i for idxs in bucket_idx for i in idxs}
    comp_tags = tuple(comp for _ in bucket_idx)
    return OverlapPlan(
        threshold=bthresh, guard=g, n_leaves=len(leaves),
        bucket_leaf_indices=bucket_idx,
        bucket_raxes=tuple(raxes_of[idxs[0]] for idxs in bucket_idx),
        bucket_nbytes=tuple(int(b.nbytes) for b in parts),
        wire=tuple(_plan_wire(idxs, leaves, g, comp_tags[bid])
                   for bid, idxs in enumerate(bucket_idx)),
        digest=assignment_digest(
            parts, compression=comp_tags if comp != "none" else None),
        leaf_raxes=tuple(raxes_of),
        loose_inexact=tuple(i for i in range(len(leaves))
                            if i not in bucketed and _bucketable(leaves[i])),
        bucket_compression=comp_tags)


def _wire_bytes(plan: OverlapPlan) -> int:
    return int(sum(g.n * _itemsize(g.dtype)
                   for groups in plan.wire for g in groups))


# ---------------------------------------------------------------------------
# The bucketed exchange of one step

class _Group(NamedTuple):
    positions: List[int]     # into the bucket's leaves
    pending: Any             # collective_ops._PendingReduce
    dtype: torch.dtype       # the group's own dtype (before the cast)
    rides: bool


class _BucketExchange:
    """One step's bucketed reduction: ``ready(i)`` from parameter i's
    hook (overlap on), ``finish()`` after the backward."""

    def __init__(self, plan: OverlapPlan, params: List[torch.Tensor],
                 pset, n_devices: int, wire_dtype: Optional[torch.dtype],
                 guard: bool, scale: Optional[float],
                 probe: Optional[Callable]):
        self.plan, self.params, self.pset = plan, params, pset
        self.n_devices, self.wire_dtype = n_devices, wire_dtype
        self.guard, self.scale, self.probe = guard, scale, probe
        self.bucket_of = {i: b for b, idxs in
                          enumerate(plan.bucket_leaf_indices) for i in idxs}
        self.waiting = [len(idxs) for idxs in plan.bucket_leaf_indices]
        self.next = 0
        self.launched: List[Tuple[List[_Group], Any]] = []
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

    def launch(self, bid: int) -> None:
        """Pack bucket ``bid`` per dtype group, cast, and start one
        allreduce per group (and the flag's own where it rides none)."""
        idxs = self.plan.bucket_leaf_indices[bid]
        grads = []
        for i in idxs:
            p = self.params[i]
            if p.grad is None:          # no gradient this step: zeros
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
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

    def finish(self) -> List[torch.Tensor]:
        """Launch what no hook launched (parameters without a gradient),
        wait for every bucket, unpack, cast back and scale into each
        parameter's ``.grad``. Returns the buckets' votes."""
        with self._lock:
            while self.next < len(self.waiting):
                self.launch(self.next)
                self.next += 1
        votes = []
        for bid, (groups, flag_pending) in enumerate(self.launched):
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
        for fut in self.callbacks:
            fut.wait()
        return votes


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
    "fp16" or "bf16"; default HOROVOD_COMPRESSION), which needs the
    bucketed path. ``overlap_probe(bucket_id, phase, nbytes)`` is called
    with "ready" when a bucket's group is launched and "reduced" when
    its allreduce completes (from the collective's thread), as
    ``tracing.OverlapProbe`` records them. ``grad_reducer`` receives
    the summed gradients ``{name: gradient}`` and returns the gradients
    to apply, scaled as it sees fit."""
    dev = resolve_device(device, "build_train_step")
    require_data_parallel(mesh)
    comp = compression_spec(compression)
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

    _last_overlap_info.clear()
    _last_overlap_info.update(enabled=use_overlap, threshold=bthresh,
                              traced=False)

    # The model the step last saw: its parameters, names and plan.
    bound: Dict[str, Any] = {"model": None}

    def bind(model: torch.nn.Module) -> None:
        named = list(model.named_parameters())
        plan = plan_overlap(model, mesh, overlap_threshold=bthresh,
                            guard=guard, compression=comp)
        bound.update(model=model, names=[n for n, _ in named],
                     params=[p for _, p in named], plan=plan)
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

    def batch_mean(x: torch.Tensor) -> torch.Tensor:
        return allreduce(x, op=Average, process_set=pset) if live else x

    def step(model: torch.nn.Module,
             batch: Mapping[str, Any]) -> Dict[str, Any]:
        first = next(model.parameters())
        if first.device != dev:
            raise ValueError(f"build_train_step: the model lies on "
                             f"{first.device}, the step runs on {dev}")
        if bound["model"] is not model:
            bind(model)
        params, plan = bound["params"], bound["plan"]
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        optimizer.zero_grad(set_to_none=True)
        exchange, hooks = None, []
        if plan.bucket_leaf_indices:    # a live axis
            exchange = _BucketExchange(plan, params, pset, n_devices,
                                       wire_dtype, guard, scale,
                                       overlap_probe)
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
            for vote in exchange.finish():
                ok = vote if ok is None else torch.logical_and(
                    ok, vote.to(ok.device))
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

    return step
