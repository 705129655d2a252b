"""Training step on one device.

Port of the single-device case of ``horovod_tpu/parallel/train.py``
``build_train_step`` (l.762): its ``local_step`` and ``_finish_step``
(l.1199-1237) with ``overlap=False`` on a one-device mesh, where no
gradient is reduced. The step computes the loss, runs the backward
(through every layer's flash attention kernels on the card) and applies
the optimizer's update to the model in place.

What belongs to the data-parallel slice over NCCL (ROADMAP A.3) is not
here: a mesh, a gradient reducer, backprop-overlapped buckets and wire
compression raise NotImplementedError when asked for.

Optimizer parity: the counterpart of ``optax.adamw(lr)`` is
``torch.optim.AdamW(params, lr, betas=(0.9, 0.999), eps=1e-8,
weight_decay=1e-4)``, which ``adamw`` builds. optax's default weight
decay is 1e-4 and torch's is 1e-2, so the decay must be given. Both
decay the parameter before the update (p - lr * (wd * p + m_hat /
(sqrt(v_hat) + eps))) and keep the moments in the parameter's dtype.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import torch

from ..common.device import DeviceLike, resolve_device


def adamw(params: Iterable[torch.nn.Parameter],
          lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)`` with optax's defaults, as torch's AdamW."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _detached(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, Mapping):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree


def build_train_step(
    loss_fn: Callable[..., Any],
    optimizer: torch.optim.Optimizer,
    device: DeviceLike = None,
    *,
    loss_has_aux: bool = False,
    mesh: Any = None,
    grad_reducer: Optional[Callable[[Any], Any]] = None,
    overlap: Optional[bool] = None,
    compression: Optional[str] = None,
) -> Callable[[torch.nn.Module, Mapping[str, Any]], Dict[str, Any]]:
    """Build ``step(model, batch) -> metrics`` for one device.

    ``loss_fn(model, batch)`` returns the loss (or ``(loss, aux)`` with
    ``loss_has_aux=True``); ``optimizer`` holds the model's parameters.
    A step moves the batch's arrays to ``device`` (the card unless
    ``device="cpu"``), clears the gradients, runs forward and backward,
    and steps the optimizer. ``metrics["loss"]`` (and ``metrics["aux"]``
    with ``loss_has_aux``) are detached tensors on the device, as the
    JAX step's metrics are device arrays: reading them waits for the
    step."""
    asked = [name for name, value in (
        ("mesh", mesh), ("grad_reducer", grad_reducer),
        ("overlap", overlap or None),
        ("compression", None if compression in (None, "none")
         else compression)) if value is not None]
    if asked:
        raise NotImplementedError(
            f"build_train_step: {', '.join(asked)} belong to the "
            f"data-parallel slice over NCCL (ROADMAP A.3), which is not "
            f"ported yet")
    dev = resolve_device(device, "build_train_step")

    def step(model: torch.nn.Module,
             batch: Mapping[str, Any]) -> Dict[str, Any]:
        first = next(model.parameters())
        if first.device != dev:
            raise ValueError(f"build_train_step: the model lies on "
                             f"{first.device}, the step runs on {dev}")
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        optimizer.zero_grad(set_to_none=True)
        out = loss_fn(model, batch)
        loss, aux = out if loss_has_aux else (out, None)
        loss.backward()
        optimizer.step()
        metrics = {"loss": loss.detach()}
        if loss_has_aux:
            metrics["aux"] = _detached(aux)
        return metrics

    return step
