"""DistributedOptimizer for torch optimizers.

Port of the bridge's ``_DistributedOptimizer`` and ``DistributedOptimizer``
(``horovod_tpu/torch/__init__.py:649-820``, the reference's
torch/optimizer.py): the returned object is the wrapped optimizer itself,
re-classed into a dynamic subclass of its own class, so
``isinstance(opt, torch.optim.AdamW)`` (and every isinstance-gated
integration: lr schedulers, GradScaler) still holds.

Each parameter gets a post-accumulate-grad hook that submits one
allreduce of its gradient, in place, named
``DistributedOptimizer.<parameter name>``, with the optimizer's op
(Average by default; Sum; Adasum), compression and scale factors. With
size > 1 the negotiated controller takes the submissions
(``ops/controller.py``): they return at once, ranks may submit in any
order, and the coordinator fuses the gradients that are ready together
into batches of up to HOROVOD_FUSION_THRESHOLD bytes, one packed
collective each (under Adasum each gradient stays its own Adasum
vector). Under HOROVOD_CONTROLLER=inline each reduction runs when it
is submitted, one gradient tensor at a time. ``step`` synchronizes the
submissions, then steps the wrapped optimizer; ``synchronize`` and
``skip_synchronize`` give the reference's GradScaler pattern.

``compression=Compression.powersgd(rank=r)`` is the eager plane of the
reference's ``DistributedGradientTransformation`` PowerSGD path
(``horovod_tpu/optim/distributed_optimizer.py``, refusals l.271-301,
``_reduce_powersgd`` l.413-497): the parameters ``powersgd_eligible``
picks submit nothing from their hooks; ``synchronize`` runs one packed
PowerSGD round over their gradients (``ops/compression.py``
``powersgd_reduce``), two float32 SUM allreduces named
``DistributedOptimizer.powersgd.P`` and ``DistributedOptimizer.powersgd.Q``
(so the negotiated controller pairs them across ranks whatever order
the ranks reach them in), scaled by 1/n under Average. The other
parameters submit as before. The first HOROVOD_COMPRESSION_WARMUP_STEPS
steps (counted here) reduce every gradient exactly. With the guard on,
each hook takes its gradient's finite flag before any reduction, and
one exact Min allreduce (``numerics.flag``) decides: a veto imprints NaN
on every gradient and leaves Q and the residuals bitwise as they were.
Q and e live outside ``self.state`` (AdamW creates a parameter's state
only while that is empty); ``compression_state()``,
``set_compression_state`` and the ``"powersgd"`` key of
``state_dict()`` carry them. The reference's groups refusal has no
counterpart: this optimizer has no groups.

The ``numerics.grad`` chaos seam fires once per step, on the first
gradient a hook submits (or holds for the round).
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Dict, List, Tuple

import torch

from .. import numerics as _numerics
from ..common import basics
from ..metrics import record_wire
from ..ops.collective_ops import (AVERAGE, MIN, SUM, allreduce,
                                  allreduce_async_, synchronize)
from ..ops.compression import (Compression, PowerSGD, effective_rank,
                               init_q, matrix_shape, powersgd_eligible,
                               powersgd_reduce, powersgd_wire_elements)


class _DistributedOptimizer:
    """Hook/step/synchronize mixin composed in front of the wrapped
    optimizer's own class."""

    def _hvd_init(self, named_parameters=None,
                  compression=Compression.none,
                  backward_passes_per_step: int = 1,
                  op=None, gradient_predivide_factor: float = 1.0,
                  process_set=None, sparse_as_dense: bool = False):
        self._compression = compression
        self._op = AVERAGE if op is None else op
        self._pset = process_set
        self._sparse_as_dense = sparse_as_dense
        self._k = int(backward_passes_per_step)
        if self._k < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        if gradient_predivide_factor != 1.0 and self._op != AVERAGE:
            raise ValueError("gradient_predivide_factor requires "
                             "op=Average (as in the reference)")
        self._psgd_spec = None
        if isinstance(compression, PowerSGD):
            if self._op not in (AVERAGE, SUM):
                raise ValueError(
                    "PowerSGD compression supports op=Average/Sum (Adasum "
                    "folds are nonlinear in the compressed factors)")
            if gradient_predivide_factor != 1.0:
                raise ValueError(
                    "gradient_predivide_factor is incompatible with "
                    "PowerSGD compression (the prescale would scale the "
                    "error-feedback residual out of gradient units)")
            if self._k != 1:
                raise ValueError(
                    "backward_passes_per_step > 1 with PowerSGD "
                    "compression is not supported (the local aggregation "
                    "accumulator and the error residual would double-"
                    "count); aggregate locally before the wrapper instead")
            self._psgd_spec = compression.spec
            self._compression = Compression.none    # the exact leaves
        self._prescale = 1.0
        self._postscale = 1.0
        if gradient_predivide_factor != 1.0:
            n = (process_set.size if process_set is not None
                 else basics.size())
            self._prescale = 1.0 / gradient_predivide_factor
            self._postscale = gradient_predivide_factor / n
            self._op = SUM
        if named_parameters is not None:
            named = [(n, p) for n, p in named_parameters]
        else:
            named = [(f"param.{gi}.{pi}", p)
                     for gi, g in enumerate(self.param_groups)
                     for pi, p in enumerate(g["params"])]
        names = [n for n, _ in named]
        if len(set(names)) != len(names):
            raise ValueError("parameter names must be unique")
        self._named = named
        self._name_of = {id(p): n for n, p in named}
        self._handles: Dict[int, Tuple[torch.Tensor, int]] = {}
        self._passes: Dict[int, int] = {}
        self._skip = False
        self._step_open = False
        self._flags: List[torch.Tensor] = []
        self._guard = False
        if self._psgd_spec is not None:
            spec = self._psgd_spec
            # Leaf index = position in the named list, the tree order.
            self._psgd_idx = [
                j for j, (_, p) in enumerate(named) if p.requires_grad
                and powersgd_eligible(p.shape, p.dtype, spec.min_elements)]
            self._psgd_ids = {id(named[j][1]) for j in self._psgd_idx}
            self._psgd = {"q": {}, "e": {}, "step": 0}
            for j in self._psgd_idx:
                p = named[j][1]
                self._psgd["q"][str(j)] = init_q(tuple(p.shape), spec.rank,
                                                 j, p.device)
                self._psgd["e"][str(j)] = torch.zeros(
                    matrix_shape(p.shape), dtype=torch.float32,
                    device=p.device)
        # The parameters hold their hooks where Python's collector
        # cannot see them, so a hook bound to the optimizer would keep
        # it, its state and its parameters alive for good.
        hook = weakref.WeakMethod(self._hook)

        def fire(p):
            method = hook()
            if method is not None:
                method(p)
        self._hooks = [p.register_post_accumulate_grad_hook(fire)
                       for _, p in named if p.requires_grad]

    def zero_grad(self, set_to_none: bool = True):
        if self._handles:
            raise RuntimeError(
                "zero_grad() with allreduce submissions in flight; call "
                "step() (or synchronize()) first, as in the reference")
        return super().zero_grad(set_to_none=set_to_none)

    def _hook(self, p: torch.Tensor) -> None:
        cnt = self._passes.get(id(p), 0) + 1
        self._passes[id(p)] = cnt
        if cnt < self._k:
            return
        self._passes[id(p)] = 0
        grad = p.grad
        if grad is None:
            return
        if grad.is_sparse:
            if not self._sparse_as_dense:
                raise NotImplementedError(
                    "hook-based sparse gradients: pass sparse_as_dense=True "
                    "(the reference optimizer's option)")
            grad = grad.to_dense()
            p.grad = grad
        if not self._step_open:
            self._step_open = True
            self._guard = (self._psgd_spec is not None
                           and _numerics.guard_enabled())
            seamed = _numerics.maybe_corrupt_grads([grad])
            if seamed[0] is not grad:
                grad = p.grad = seamed[0]
        if self._psgd_spec is not None:
            if self._guard:
                self._flags.append(torch.isfinite(grad).all())
            if id(p) in self._psgd_ids and \
                    self._psgd["step"] >= self._psgd_spec.warmup_steps:
                return                  # synchronize() runs the round
        name = self._name_of[id(p)]
        scale = 1.0 / self._k if self._k > 1 else 1.0
        h = allreduce_async_(
            grad, op=self._op, name=f"DistributedOptimizer.{name}",
            prescale_factor=self._prescale * scale,
            postscale_factor=self._postscale,
            compression=self._compression, process_set=self._pset)
        self._handles[h] = (p, h)

    def synchronize(self) -> None:
        """Wait for every submitted gradient reduction (and run the
        step's PowerSGD round). Drains every handle even when one errs,
        then raises the first error."""
        err, new = None, None
        psgd = self._psgd_spec is not None and self._step_open
        if psgd and self._psgd["step"] >= self._psgd_spec.warmup_steps:
            try:
                new = self._powersgd_round()
            except Exception as ex:  # noqa: BLE001 — re-raised below
                err = ex
        for h in list(self._handles):
            try:
                synchronize(h)
            except Exception as ex:  # noqa: BLE001 — re-raised below
                if err is None:
                    err = ex
        self._handles.clear()
        self._step_open = False
        if err is not None:
            self._flags = []
            raise err
        if psgd:
            self._finish_powersgd(new)

    def _size(self) -> int:
        return (self._pset.size if self._pset is not None
                else basics.size())

    def _powersgd_round(self):
        """The packed PowerSGD round over the eligible gradients, into
        their ``.grad``; returns the new (q, e) by leaf key."""
        spec = self._psgd_spec
        params = [self._named[j][1] for j in self._psgd_idx]
        if not params:
            return {}
        for p in params:
            if p.grad is None:          # no gradient this step: zeros
                p.grad = torch.zeros_like(p)
        keys = [str(j) for j in self._psgd_idx]
        names = iter(("DistributedOptimizer.powersgd.P",
                      "DistributedOptimizer.powersgd.Q"))
        n = self._size()

        def psum_fn(flat):
            return allreduce(flat, op=SUM, name=next(names),
                             process_set=self._pset)

        outs, new_qs, new_es = powersgd_reduce(
            [p.grad.reshape(matrix_shape(p.shape)) for p in params],
            [self._psgd["q"][k] for k in keys],
            [self._psgd["e"][k] for k in keys], psum_fn, n)
        record_wire(spec.tag(),
                    sum(p.numel() * p.element_size() for p in params),
                    4 * sum(sum(powersgd_wire_elements(p.shape, spec.rank))
                            for p in params))
        inv = 1.0 / n if self._op == AVERAGE else 1.0
        for p, o in zip(params, outs):
            if inv != 1.0:
                o = o * torch.tensor(inv, dtype=o.dtype, device=o.device)
            p.grad = o.reshape(p.shape).to(p.dtype)
        return {k: (q, e) for k, q, e in zip(keys, new_qs, new_es)}

    def _finish_powersgd(self, new) -> None:
        """The guard's vote (one exact Min allreduce of the hooks'
        finite flags), its imprint, the new Q and e unless it vetoed,
        and the step count."""
        ok = None
        if self._guard:
            grads = [p.grad for _, p in self._named if p.grad is not None]
            dev = grads[0].device if grads else torch.device("cpu")
            flag = (torch.stack([f.to(dev) for f in self._flags]).all()
                    if self._flags else torch.tensor(True, device=dev))
            ok = allreduce(flag.to(torch.float32).reshape(1), op=MIN,
                           name="numerics.flag",
                           process_set=self._pset)[0] > 0.5
            for _, p in self._named:
                if p.grad is not None:
                    p.grad = _numerics.imprint_non_finite(p.grad, ok)
        self._flags = []
        for k, (q, e) in (new or {}).items():
            if ok is not None:
                q = torch.where(ok, q, self._psgd["q"][k])
                e = torch.where(ok, e, self._psgd["e"][k])
            self._psgd["q"][k], self._psgd["e"][k] = q, e
        self._psgd["step"] += 1

    def compression_state(self):
        """The PowerSGD state: ``{"q": {leaf index: (m, r)}, "e": {leaf
        index: (n, m)}, "step": steps taken}`` (None without PowerSGD)."""
        if self._psgd_spec is None:
            return None
        return {"q": dict(self._psgd["q"]), "e": dict(self._psgd["e"]),
                "step": int(self._psgd["step"])}

    def set_compression_state(self, state) -> None:
        """Replace the PowerSGD state (as ``compression_state`` gives
        it; "step" optional), as float32 on each parameter's device,
        after checking its keys and shapes."""
        if self._psgd_spec is None:
            raise ValueError("this optimizer does not compress with "
                             "PowerSGD: it has no compression state")
        want = {str(j) for j in self._psgd_idx}
        if set(state["q"]) != want or set(state["e"]) != want:
            raise ValueError(
                f"compression state has leaves {sorted(state['q'])}, the "
                f"optimizer compresses {sorted(want, key=int)}")
        for k in want:
            p = self._named[int(k)][1]
            n, m = matrix_shape(p.shape)
            q = torch.as_tensor(state["q"][k]).to(p.device, torch.float32)
            e = torch.as_tensor(state["e"][k]).to(p.device, torch.float32)
            r = effective_rank(p.shape, self._psgd_spec.rank)
            if tuple(q.shape) != (m, r) or tuple(e.shape) != (n, m):
                raise ValueError(f"compression state of leaf {k}: q "
                                 f"{tuple(q.shape)}, e {tuple(e.shape)}; "
                                 f"want {(m, r)} and {(n, m)}")
            self._psgd["q"][k], self._psgd["e"][k] = q, e
        if "step" in state:
            self._psgd["step"] = int(state["step"])

    def state_dict(self):
        sd = super().state_dict()
        if self._psgd_spec is not None:
            sd["powersgd"] = self.compression_state()
        return sd

    def load_state_dict(self, state_dict):
        if "powersgd" in state_dict:
            state_dict = dict(state_dict)
            self.set_compression_state(state_dict.pop("powersgd"))
        return super().load_state_dict(state_dict)

    @contextlib.contextmanager
    def skip_synchronize(self):
        """``with optimizer.skip_synchronize(): optimizer.step()``
        applies the update without synchronizing (after a manual
        ``synchronize()``)."""
        self._skip = True
        try:
            yield
        finally:
            self._skip = False

    def step(self, closure=None):
        if not self._skip:
            self.synchronize()
        return super().step(closure)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op=None,
                         gradient_predivide_factor: float = 1.0,
                         process_set=None,
                         sparse_as_dense: bool = False):
    """Make ``optimizer`` distributed: hook-based gradient reduction
    (Average by default). Returns the same instance, re-classed as a
    dynamic subclass of its own class."""
    basics._require_init()
    if isinstance(optimizer, _DistributedOptimizer):
        raise ValueError("optimizer is already a DistributedOptimizer")
    cls = type("Distributed" + optimizer.__class__.__name__,
               (_DistributedOptimizer, optimizer.__class__), {})
    optimizer.__class__ = cls
    optimizer._hvd_init(
        named_parameters=named_parameters, compression=compression,
        backward_passes_per_step=backward_passes_per_step, op=op,
        gradient_predivide_factor=gradient_predivide_factor,
        process_set=process_set, sparse_as_dense=sparse_as_dense)
    return optimizer
