"""horovod_tpu_torch — the PyTorch and CUDA port of horovod_tpu, grown
slice by slice beside the JAX package, which stays the reference.

Two slices so far. Serving: ``ServingFrontend`` batches requests onto
padded ladder shapes and runs a two-argument forward on a worker that
owns one ``torch.device``. Training on one device:
``parallel.train.build_train_step`` runs the loss (``models.transformer.
loss_fn``), its backward and an AdamW update (``parallel.train.adamw``,
optax.adamw's settings). The model sends every layer's attention through
the autograd Function ``ops.flash_attention.FlashAttention``: on the
card, the hand-written CUDA flash-attention forward and its dK/dV and
dQ backward kernels. Entry points run on the card unless the caller
passes ``device="cpu"``, and raise when there is no card and no device
was given.

The package imports torch and numpy, never jax and nothing of
horovod_tpu: framework-neutral modules (config, logging, metrics,
faults, journal, telemetry, tracing) are copies, pinned against the
reference by the tests.
"""

from .common.exceptions import (  # noqa: F401
    HorovodInternalError, ReplicaDivergenceError,
)
from .models.transformer import (  # noqa: F401
    Transformer, TransformerConfig, forward, init_params, logits_fn,
    loss_fn, params_from_jax, params_to_jax, vocab_parallel_xent,
)
from .ops.flash_attention import (  # noqa: F401
    FlashAttention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_fwd_plain,
)
from .parallel.ring_attention import attention  # noqa: F401
from .parallel.train import adamw, build_train_step  # noqa: F401
from .serving import (  # noqa: F401
    BucketLadder, ServingError, ServingFrontend, ServingFuture,
    build_ladder,
)

__version__ = "0.1.0"
