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
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Tuple

import torch

from ..common import basics
from ..ops.collective_ops import (AVERAGE, SUM, allreduce_async_,
                                  synchronize)
from ..ops.compression import Compression


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
        name = self._name_of[id(p)]
        scale = 1.0 / self._k if self._k > 1 else 1.0
        h = allreduce_async_(
            grad, op=self._op, name=f"DistributedOptimizer.{name}",
            prescale_factor=self._prescale * scale,
            postscale_factor=self._postscale,
            compression=self._compression, process_set=self._pset)
        self._handles[h] = (p, h)

    def synchronize(self) -> None:
        """Wait for every submitted gradient reduction. Drains every
        handle even when one errs, then raises the first error."""
        err = None
        for h in list(self._handles):
            try:
                synchronize(h)
            except Exception as ex:  # noqa: BLE001 — re-raised below
                if err is None:
                    err = ex
        self._handles.clear()
        if err is not None:
            raise err

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
