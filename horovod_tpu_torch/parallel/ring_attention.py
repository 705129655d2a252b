"""Single-device attention with the (B, L, H, D) layout.

Port of the single-device half of
``horovod_tpu/parallel/ring_attention.py``: ``attention``. It is the
autograd Function ``ops.flash_attention.FlashAttention`` on both
devices, so the CPU and the card share one autograd node. Where it runs
is decided by where the tensors lie, and nowhere else: CUDA tensors go
through the flash-attention kernels (forward, and dK/dV and dQ in the
backward), which raise ValueError before any launch for a shape they do
not take; CPU tensors take the kernels' plain versions, whose forward is
the JAX module's einsum path (``_blockwise_scores``, mask, softmax).

Deliberate differences from the JAX module: HOROVOD_FLASH_ATTENTION is
not read (its knob stays in the copied registry), so ``_flash_mode``,
``flash_wanted`` and ``_flash_supported`` have no counterpart here; the
kernels' shape rule is ``ops.flash_attention.check_inputs``; nothing
catches a kernel error to fall back. The sequence-parallel ring
(``ring_attention`` / ``_ring_body``) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import FlashAttention


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, L, H, D) inputs, output in q's dtype: the
    flash kernels for CUDA tensors, their plain versions for CPU
    tensors, one autograd Function for both."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, bool(causal), float(scale))
