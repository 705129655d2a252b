"""Parameter and optimizer-state broadcast for torch modules and
optimizers.

Port of the bridge's torch surface (``horovod_tpu/torch/__init__.py``
``broadcast_parameters`` l.561 and ``broadcast_optimizer_state`` l.587,
the reference's torch/functions.py): every rank takes the root's values
in place.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.collective_ops import (broadcast_async_, broadcast_object,
                                  synchronize)


def broadcast_parameters(params, root_rank: int = 0,
                         process_set=None) -> None:
    """Broadcast a module's state, a state_dict or an iterable of
    (name, tensor) IN PLACE, in name order on every rank."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    items = sorted(params.items()) if isinstance(params, dict) \
        else sorted(params, key=lambda kv: kv[0])
    handles = [broadcast_async_(t, root_rank, name=f"bp.{n}",
                                process_set=process_set)
               for n, t in items if isinstance(t, torch.Tensor)]
    for h in handles:
        synchronize(h)


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0,
                              process_set=None) -> None:
    """Broadcast a torch optimizer's state dict from the root.

    The root's state defines the structure: its skeleton and tensor
    manifest (paths, shapes, dtypes) go first as one pickled object,
    then every rank broadcasts the same tensors in the same order,
    zeros where its own state lacks an entry (a root resumed from a
    checkpoint, workers fresh), so no rank submits a different set."""
    sd = optimizer.state_dict()
    local: Dict[tuple, torch.Tensor] = {}

    def strip(x, path):
        if isinstance(x, torch.Tensor):
            local[tuple(path)] = x
            return None
        if isinstance(x, dict):
            return {k: strip(v, path + [k]) for k, v in x.items()}
        if isinstance(x, list):
            return [strip(v, path + [i]) for i, v in enumerate(x)]
        return x

    skeleton = strip(sd, [])
    manifest = [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for p, t in sorted(local.items(), key=lambda kv: str(kv[0]))]
    skeleton, manifest = broadcast_object(
        (skeleton, manifest), root_rank=root_rank,
        name="opt_state_skeleton", process_set=process_set)

    bufs = []
    for path, shape, dtype_name in manifest:
        dt = getattr(torch, dtype_name)
        t = local.get(tuple(path))
        if t is None or tuple(t.shape) != tuple(shape) or t.dtype != dt:
            # load_state_dict moves state to its parameter's device.
            t = torch.zeros(shape, dtype=dt)
        bufs.append((tuple(path), t))
    handles = [broadcast_async_(t, root_rank, name=f"opt_state.{i}",
                                process_set=process_set)
               for i, (_, t) in enumerate(bufs)]
    for h in handles:
        synchronize(h)

    for path, t in bufs:
        node = skeleton
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = t
    optimizer.load_state_dict(skeleton)
