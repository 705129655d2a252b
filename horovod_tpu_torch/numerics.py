"""Numerical-integrity guard: coordinated skip-step and replica-divergence
(silent-data-corruption) detection.

Port of ``horovod_tpu/numerics.py``: its knobs (``guard_enabled``,
``max_consecutive_skips``, ``check_every``, l.139-152), its finite flags
and imprint (l.155-201), ``guard_non_finite`` (l.224) with its skip
counters and escalation (l.285-347), ``LossScaleState`` and
``DistributedLossScaler`` (l.350-430), ``params_digest`` (l.438),
``check_replica_divergence`` (l.455) and the chaos seams
``maybe_corrupt_grads`` (l.537) and ``maybe_flip_param`` (l.561), on
torch tensors and ``torch.distributed``.

- With ``HOROVOD_NUMERICS_GUARD=1`` the data-parallel step
  (``parallel/train.py``) reduces every rank's 0/1 finite flag with the
  gradients and imprints a veto as NaN on the reduced gradients, so
  every rank sees the same decision. ``guard_non_finite(optimizer)``
  then skips ``step()`` when any gradient is non-finite: the inner
  optimizer's state (AdamW's step count and moments) does not move.
  ``HOROVOD_NUMERICS_MAX_CONSECUTIVE_SKIPS`` escalates a spinning job to
  ``HorovodInternalError``.
- ``check_replica_divergence`` hashes the parameters to the reference's
  64-bit digest, allgathers the digests and raises
  ``ReplicaDivergenceError`` naming the divergent ranks.

- ``DistributedLossScaler`` is the reference's functional dynamic loss
  scale (``init`` / ``scale`` / ``unscale`` / ``update(state,
  grads_finite)``) on device tensors: fed the coordinated finite flag,
  every rank derives bitwise the same scale with no collective.
- The chaos seams: ``maybe_corrupt_grads`` (``numerics.grad``) poisons
  one element of a rank-local gradient at a reduction's entry (the
  data-parallel step's and ``DistributedOptimizer``'s);
  ``maybe_flip_param`` (``numerics.param``) flips one parameter bit.

The torch optimizer takes the place of the optax transformation: the
guard is a subclass of the optimizer's own class (``isinstance`` still
holds) whose ``step`` skips, not a transformation that zeroes updates.
``on_commit``, which fires the parameter seam at the elastic commit,
comes with the elastic slice (ROADMAP A.7).
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .common import logging as hlog
from .common.exceptions import HorovodInternalError, ReplicaDivergenceError
from .metrics import REGISTRY as _METRICS
from .ops.bucketing import tree_leaves

_m_skipped = _METRICS.counter(
    "hvd_skipped_steps_total",
    "Coordinated optimizer skip-steps, by reason (non_finite = the "
    "gradient finite-flag vetoed the step; overflow = the loss scaler "
    "backed off).", ("reason",))
_m_consec = _METRICS.gauge(
    "hvd_numerics_consecutive_skips",
    "Current consecutive coordinated skip-steps (worst guard state "
    "observed; resets to 0 on the first clean step).")
_m_loss_scale = _METRICS.gauge(
    "hvd_loss_scale",
    "Current dynamic loss scale (DistributedLossScaler).")
_m_checks = _METRICS.counter(
    "hvd_replica_digest_checks_total",
    "Replica-divergence digest checks performed.")
_m_divergence = _METRICS.counter(
    "hvd_replica_divergence_total",
    "Replica-divergence events detected (digest disagreement across "
    "ranks — silent data corruption surfaced).")


# ---------------------------------------------------------------------------
# config access

def _cfg(env: str, default):
    """A knob from the live Config after ``init``, else the environment
    through the knob's own parser (the reference's l.102)."""
    from .common import basics
    cfg = basics.state().config if basics.is_initialized() else None
    if cfg is not None:
        try:
            return cfg[env]
        except KeyError:
            pass
    raw = os.environ.get(env, "")
    if raw == "":
        return default
    from .common.config import _KNOBS_BY_ENV
    knob = _KNOBS_BY_ENV.get(env)
    if knob is None:
        return default
    try:
        return knob.type(raw)
    except (ValueError, TypeError):
        hlog.warning("numerics: bad value %r for %s; using default %r",
                     raw, env, default)
        return default


def guard_enabled() -> bool:
    return bool(_cfg("HOROVOD_NUMERICS_GUARD", False))


def max_consecutive_skips() -> int:
    return int(_cfg("HOROVOD_NUMERICS_MAX_CONSECUTIVE_SKIPS", 0))


def check_every() -> int:
    return int(_cfg("HOROVOD_NUMERICS_CHECK_EVERY", 0))


# ---------------------------------------------------------------------------
# trees: dicts by sorted key, lists and tuples in order, an nn.Module as
# {name: parameter}; jax.tree_util's order and key paths.

def _flatten_with_path(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten_with_path(v, f"{path}[{i}]")]
    return [(path, tree)]


def _inexact(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


# ---------------------------------------------------------------------------
# finite flags

def all_finite(tree: Any) -> torch.Tensor:
    """Scalar bool tensor: every inexact tensor of ``tree`` is finite.
    Integer and bool tensors are finite by construction and skipped."""
    flags = [torch.isfinite(t).all() for t in tree_leaves(tree)
             if isinstance(t, torch.Tensor) and _inexact(t)]
    if not flags:
        return torch.tensor(True)
    if len(flags) == 1:
        return flags[0]
    dev = flags[0].device
    return torch.stack([f.to(dev) for f in flags]).all()


def local_finite_flag(leaves: List[Any]) -> torch.Tensor:
    """The wire form of the local decision: 1.0 when every leaf is
    finite, 0.0 otherwise, float32 so that it rides float32 payloads.
    The vote COUNT is exact only in float32/float64 wires, so lossy
    (fp16/bf16) reductions carry the flag in an exact allreduce of its
    own."""
    return all_finite(leaves).to(torch.float32)


def imprint_non_finite(tree: Any, ok) -> Any:
    """When ``ok`` is false, every inexact tensor of ``tree`` becomes
    NaN, so a downstream ``guard_non_finite`` sees the veto even where
    the reduction laundered the bad value; when true, ``tree`` itself.
    Every rank holds the same ``ok``, so the imprint keeps replicas in
    agreement."""
    if bool(ok):
        return tree

    def one(t):
        if isinstance(t, torch.Tensor) and _inexact(t):
            return t + torch.tensor(float("nan"), dtype=t.dtype,
                                    device=t.device)
        return t

    if isinstance(tree, dict):
        return {k: imprint_non_finite(v, False) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(imprint_non_finite(v, False) for v in tree)
    return one(tree)


# ---------------------------------------------------------------------------
# the coordinated skip-step wrapper

class _GuardedOptimizer:
    """Skip-step mixin composed in front of the wrapped optimizer's own
    class (the reference's ``GuardState``: consecutive and total skips)."""

    def _guard_init(self, max_consecutive: Optional[int]) -> None:
        self._guard_max_consecutive = max_consecutive
        self.consecutive_skips = 0
        self.total_skips = 0

    def step(self, closure=None):
        grads = [p.grad for group in self.param_groups
                 for p in group["params"] if p.grad is not None]
        if bool(all_finite(grads)):
            self.consecutive_skips = 0
            _m_consec.set(0)
            return super().step(closure)
        # Skipped: the inner step never runs, so its state stays as
        # committed (GradScaler's semantics).
        self.consecutive_skips += 1
        self.total_skips += 1
        _m_skipped.labels(reason="non_finite").inc()
        _m_consec.set(self.consecutive_skips)
        hlog.warning("numerics: non-finite gradients — coordinated "
                     "skip-step (consecutive %d)", self.consecutive_skips)
        _escalate(self.consecutive_skips, self._guard_max_consecutive)
        return None


def guard_non_finite(optimizer: torch.optim.Optimizer, *,
                     enabled: Optional[bool] = None,
                     max_consecutive: Optional[int] = None):
    """Wrap a torch optimizer with the coordinated skip-step.

    ``step()`` checks the (already reduced) gradients; when any is
    non-finite the step is skipped and the optimizer's state left as it
    was. The reduction paths imprint every rank's veto on the reduced
    gradients, so the decision is the same on every rank. The counts
    are the optimizer's ``consecutive_skips`` and ``total_skips``.

    ``enabled=None`` reads ``HOROVOD_NUMERICS_GUARD``; when the guard is
    off this returns ``optimizer`` unchanged. When on, it returns the
    same instance, re-classed as a subclass of its own class. After
    ``max_consecutive`` consecutive skips (default
    ``HOROVOD_NUMERICS_MAX_CONSECUTIVE_SKIPS``; 0 = never) ``step``
    raises ``HorovodInternalError``. Wrap the inner optimizer:
    ``DistributedOptimizer(guard_non_finite(opt))``."""
    if enabled is None:
        enabled = guard_enabled()
    if not enabled:
        return optimizer
    if isinstance(optimizer, _GuardedOptimizer):
        raise ValueError("optimizer is already guarded")
    cls = type("Guarded" + optimizer.__class__.__name__,
               (_GuardedOptimizer, optimizer.__class__), {})
    optimizer.__class__ = cls
    optimizer._guard_init(max_consecutive)
    return optimizer


def _escalate(consec: int, max_consecutive: Optional[int]) -> None:
    """Raise when the consecutive-skip streak reached the (explicit or
    knob-configured) limit."""
    m = (max_consecutive if max_consecutive is not None
         else max_consecutive_skips())
    if m and consec >= m:
        from . import journal as _journal
        _journal.record("numerics_escalation", skips=int(consec),
                        limit=int(m))
        raise HorovodInternalError(
            f"numerics: {consec} consecutive non-finite skip-steps "
            f"reached HOROVOD_NUMERICS_MAX_CONSECUTIVE_SKIPS={m}; "
            "escalating so elastic training restores the last commit")


def _guards(optimizers: Any) -> List[_GuardedOptimizer]:
    if isinstance(optimizers, torch.optim.Optimizer):
        optimizers = [optimizers]
    return [o for o in optimizers if isinstance(o, _GuardedOptimizer)]


def consecutive_skips(optimizers: Any) -> int:
    """Worst current consecutive-skip count across guarded optimizers
    (an optimizer or an iterable of them; 0 when none is guarded)."""
    return max((g.consecutive_skips for g in _guards(optimizers)),
               default=0)


def check_escalation(optimizers: Any,
                     max_consecutive: Optional[int] = None) -> None:
    """Raise HorovodInternalError when a guarded optimizer's
    consecutive-skip count reached the limit. No-op when the limit is
    0/unset."""
    if not (max_consecutive if max_consecutive is not None
            else max_consecutive_skips()):
        return
    c = consecutive_skips(optimizers)
    _m_consec.set(c)
    _escalate(c, max_consecutive)


# ---------------------------------------------------------------------------
# distributed dynamic loss scaling

class LossScaleState(NamedTuple):
    scale: torch.Tensor          # float32 scalar
    growth_count: torch.Tensor   # int32 scalar: clean steps since change


class DistributedLossScaler:
    """Dynamic loss scaling with torch.amp.GradScaler's schedule (back
    off on overflow, grow after ``growth_interval`` clean steps), as a
    functional state the loop threads:

        scaler = DistributedLossScaler()
        sstate = scaler.init(device)
        loss   = scaler.scale(raw_loss, sstate)
        ...                                     # backward, reduction
        grads  = scaler.unscale(grads, sstate)
        ok     = numerics.all_finite(grads)     # the reduced gradients
        sstate = scaler.update(sstate, ok)

    ``update`` must be fed the coordinated finite flag (of the reduced
    or guard-imprinted gradients), the same on every rank, so every
    rank derives bitwise the same scale with no collective. Pair it
    with ``guard_non_finite`` so the overflowed step is skipped."""

    def __init__(self, init_scale: Optional[float] = None,
                 growth_factor: float = 2.0,
                 backoff_factor: float = 0.5,
                 growth_interval: Optional[int] = None,
                 min_scale: float = 1.0):
        if init_scale is None:
            init_scale = float(_cfg("HOROVOD_NUMERICS_INIT_SCALE",
                                    65536.0))
        if growth_interval is None:
            growth_interval = int(_cfg(
                "HOROVOD_NUMERICS_GROWTH_INTERVAL", 2000))
        if growth_factor <= 1.0 or not 0.0 < backoff_factor < 1.0:
            raise ValueError("growth_factor must be > 1 and "
                             "backoff_factor in (0, 1)")
        self.init_scale = float(init_scale)
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.min_scale = float(min_scale)

    def init(self, device=None) -> LossScaleState:
        """The starting state on ``device`` (the card unless
        ``device="cpu"``)."""
        from .common.device import resolve_device
        dev = resolve_device(device, "DistributedLossScaler.init")
        return LossScaleState(
            scale=torch.tensor(self.init_scale, dtype=torch.float32,
                               device=dev),
            growth_count=torch.zeros((), dtype=torch.int32, device=dev))

    def scale(self, loss: torch.Tensor, state: LossScaleState
              ) -> torch.Tensor:
        return loss * state.scale.to(loss.dtype)

    def unscale(self, grads: Any, state: LossScaleState) -> Any:
        """Every tensor of ``grads`` (a tensor, or dicts, lists and
        tuples of them) times 1 / scale in its own dtype."""
        inv = torch.tensor(1.0, dtype=torch.float32,
                           device=state.scale.device) / state.scale

        def one(g):
            if isinstance(g, dict):
                return {k: one(v) for k, v in g.items()}
            if isinstance(g, (list, tuple)):
                return type(g)(one(v) for v in g)
            return g * inv.to(device=g.device, dtype=g.dtype)
        return one(grads)

    def update(self, state: LossScaleState, grads_finite) -> LossScaleState:
        ok = torch.as_tensor(grads_finite, device=state.scale.device)
        grown = (state.growth_count + 1) >= self.growth_interval
        new_scale = torch.where(
            ok,
            torch.where(grown, state.scale * self.growth_factor,
                        state.scale),
            torch.clamp(state.scale * self.backoff_factor,
                        min=self.min_scale))
        new_count = torch.where(
            torch.logical_and(ok, torch.logical_not(grown)),
            state.growth_count + 1,
            torch.zeros((), dtype=torch.int32, device=ok.device))
        _m_loss_scale.set(float(new_scale))
        if not bool(ok):
            _m_skipped.labels(reason="overflow").inc()
            hlog.warning("numerics: loss-scale overflow — backing off "
                         "to %g", float(new_scale))
        return LossScaleState(new_scale, new_count)


# ---------------------------------------------------------------------------
# replica-divergence (SDC) sentinel

def _host_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf's bytes as a contiguous numpy array, and its numpy dtype
    name ("bfloat16" for torch.bfloat16, which numpy lacks)."""
    name = None
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf, name = leaf.view(torch.int16), "bfloat16"
        leaf = leaf.numpy()
    # ascontiguousarray makes a scalar (1,), as the reference hashes it.
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr, name or str(arr.dtype)


def params_digest(tree: Any) -> int:
    """Deterministic 64-bit digest of a tree's values (paths, dtypes,
    shapes and raw bytes): the reference's value for the same tree. A
    dict's key paths are ``jax.tree_util.keystr``'s (``['layers']['wq']``);
    an ``nn.Module`` hashes as ``dict(named_parameters())``. One host
    pass over the data: run it periodically, not per step."""
    h = hashlib.blake2b(digest_size=8)
    for path, leaf in _flatten_with_path(tree):
        arr, name = _host_array(leaf)
        h.update(path.encode())
        h.update(name.encode())
        h.update(repr(arr.shape).encode())
        h.update(arr.tobytes())
    return int.from_bytes(h.digest(), "big")


def check_replica_divergence(params: Any, name: str = "numerics.digest",
                             process_set=None) -> None:
    """Hash ``params``, allgather the 64-bit digests and raise
    ``ReplicaDivergenceError`` naming the divergent ranks when they
    disagree. Consensus is the largest digest group; ties break toward
    the group holding the lowest rank and are flagged AMBIGUOUS, since a
    tie cannot prove which side is corrupted. A rank-0 digest in the
    minority raises RuntimeError (restore + rank-0 sync would launder
    it). No-op before init or at world size 1."""
    from .common import basics
    if not basics.is_initialized() or basics.size() <= 1:
        return
    digest = params_digest(params)
    from .ops.collective_ops import allgather_object
    digests = allgather_object(digest, name=name, process_set=process_set)
    _m_checks.inc()
    groups = {}
    for r, d in enumerate(digests):
        groups.setdefault(d, []).append(r)
    if len(groups) == 1:
        return
    consensus = max(groups,
                    key=lambda d: (len(groups[d]), -min(groups[d])))
    divergent = sorted(r for d, ranks in groups.items()
                       if d != consensus for r in ranks)
    _m_divergence.inc()
    msg = (f"numerics: replica divergence — divergent ranks "
           f"{divergent} disagree with consensus digest "
           f"{consensus:#018x} (silent data corruption or a "
           "nondeterministic update)")
    if len(groups[consensus]) * 2 <= len(digests):
        msg += (" [AMBIGUOUS: no strict digest majority — trusting "
                "rank 0's group; if rank 0 itself is corrupted this "
                "recovery propagates the corruption, verify against a "
                "trusted checkpoint]")
    hlog.error("%s", msg)
    from . import journal as _journal
    if 0 in divergent:
        _journal.record("replica_divergence",
                        divergent_ranks=sorted(divergent),
                        non_restorable=True)
        raise RuntimeError(
            msg + " — rank 0 (the elastic sync broadcast root) holds "
            "a minority digest, so restore + rank-0 sync would "
            "launder the corruption onto healthy ranks; restart from "
            "a trusted checkpoint instead")
    _journal.record("replica_divergence",
                    divergent_ranks=sorted(divergent))
    raise ReplicaDivergenceError(
        msg + "; elastic restore + rank-0 sync recovers",
        divergent_ranks=divergent)


# ---------------------------------------------------------------------------
# chaos seams (faults.py points numerics.grad and numerics.param)

def _dense_inexact(t: Any) -> bool:
    return (isinstance(t, torch.Tensor) and not t.is_sparse
            and _inexact(t))


def maybe_corrupt_grads(leaves: List[Any]) -> List[Any]:
    """The ``numerics.grad`` seam: on a scheduled fire ("nan" or
    "inf"), a new list whose first dense inexact tensor is a copy with
    its first element poisoned (rank-local; the coordinated skip is what
    must catch it). Returns ``leaves`` itself when nothing fires."""
    from . import faults
    if not faults.active():
        return leaves
    dense = [i for i, t in enumerate(leaves) if _dense_inexact(t)]
    if not dense:
        return leaves
    act = faults.fire("numerics.grad")
    if act not in ("nan", "inf"):
        return leaves
    i = dense[0]
    leaves = list(leaves)
    t = leaves[i].detach().clone()
    t.view(-1)[0] = float("nan") if act == "nan" else float("inf")
    leaves[i] = t
    return leaves


def _flipped(t: torch.Tensor) -> torch.Tensor:
    out = t.detach().contiguous().clone()
    raw = out.view(-1).view(torch.uint8)
    raw[raw.numel() // 2] ^= 0x10
    return out


def maybe_flip_param(tree: Any) -> Any:
    """The ``numerics.param`` seam: on a scheduled "flip", a new tree
    (dicts visited by sorted key, lists and tuples in order) whose first
    inexact tensor is a copy with one bit flipped in the middle of its
    byte image (a simulated silent data corruption). Returns ``tree``
    itself when nothing fires."""
    from . import faults
    if not faults.active():
        return tree
    if faults.fire("numerics.param") != "flip":
        return tree
    done = [False]

    def walk(node):
        if isinstance(node, dict):
            new = {k: walk(node[k]) for k in sorted(node)}
            return {k: new[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if not done[0] and _dense_inexact(node):
            done[0] = True
            hlog.warning("faults: flipped one parameter bit "
                         "(simulated silent data corruption)")
            return _flipped(node)
        return node
    out = walk(tree)
    return out if done[0] else tree
