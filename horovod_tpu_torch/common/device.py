"""The port's device rule: entry points run on the card unless the
caller passes ``device="cpu"``; with no device given and no CUDA
present they raise, and never move to the CPU on their own."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None,
                   what: str = "horovod_tpu_torch") -> torch.device:
    """An explicit ``torch.device``: ``device`` as given (a bare
    ``"cuda"`` becomes the current card's index), or the current card
    when ``device`` is None. Raises RuntimeError when no card is
    present and no device was given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what}: no CUDA device is available; pass "
                f"device=\"cpu\" to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def pool_devices(device: Optional[DeviceLike] = None,
                 what: str = "horovod_tpu_torch") -> list:
    """The devices a worker pool spreads over: every local card when
    ``device`` is None (raising without one, like ``resolve_device``),
    else just ``resolve_device(device)``."""
    if device is None:
        resolve_device(None, what)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(device, what)]


def rank_device(backend: Optional[str]) -> torch.device:
    """This rank's device: the current card under NCCL, or under gloo
    when CUDA is present, else the CPU (a rank without a card runs its
    collectives on host tensors)."""
    if backend == "nccl" or torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
