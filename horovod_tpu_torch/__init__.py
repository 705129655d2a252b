"""horovod_tpu_torch — the PyTorch and CUDA port of horovod_tpu, grown
slice by slice beside the JAX package, which stays the reference.

Five slices so far. Serving: ``ServingFrontend`` batches requests onto
padded ladder shapes and runs a two-argument forward on a worker that
owns one ``torch.device``. Training on one device:
``parallel.train.build_train_step`` runs the loss (``models.transformer.
loss_fn``), its backward and an AdamW update (``parallel.train.adamw``,
optax.adamw's settings). The model sends every layer's attention through
the autograd Function ``ops.flash_attention.FlashAttention``: on the
card, the hand-written CUDA flash-attention forward and its dK/dV and
dQ backward kernels. Horovod's data-parallel loop on
``torch.distributed``: ``init``, ``broadcast_parameters``, the eager
collectives (allreduce with Average, Sum, Min, Max, Product and Adasum,
allgather, broadcast, alltoall, reducescatter, their grouped forms,
``allgather_object``, ``barrier``, ``join``), process sets, and
``DistributedOptimizer``; with size > 1 the negotiated engine (the C++
control core of ``core/cc``, built at first use, and a background
controller) agrees one order of fused batches on every rank, so ranks
may submit in any order. Adasum runs on the vhdd route by default and
on the gather route when asked; its arithmetic on the card is the
hand-written CUDA kernels K1 and K2 of ``ops.adasum_kernels``. The
data-parallel train step: ``build_train_step(..., mesh=
data_parallel_mesh())`` reduces the gradients in buckets inside the
backward (or in one pass after it), with fp16/bf16 wire casts, the
numerics guard (``guard_non_finite``) and replica digests
(``check_replica_divergence``). Entry
points run on the card unless the caller passes ``device="cpu"``, and
raise when there is no card and no device was given.

The package imports torch and numpy, never jax and nothing of
horovod_tpu: framework-neutral modules (config, logging, metrics,
faults, journal, telemetry, tracing, bucketing) are copies, pinned
against the reference by the tests.
"""

from .common.basics import (  # noqa: F401
    add_process_set, backend, global_process_set, init, is_initialized,
    local_rank, local_size, process_set_included, rank, remove_process_set,
    shutdown, size,
)
from .common.exceptions import (  # noqa: F401
    HorovodInternalError, ReplicaDivergenceError,
)
from .models.transformer import (  # noqa: F401
    Transformer, TransformerConfig, forward, init_params, logits_fn,
    loss_fn, params_from_jax, params_to_jax, vocab_parallel_xent,
)
from .ops.collective_ops import (  # noqa: F401
    Adasum, Average, Max, Min, Product, Sum, allgather, allgather_async,
    allgather_object, allreduce, allreduce_, allreduce_async,
    allreduce_async_, alltoall, alltoall_async, barrier, broadcast,
    broadcast_, broadcast_async, broadcast_async_, broadcast_object,
    check_execution_order, grouped_allgather, grouped_allgather_async,
    grouped_allreduce, grouped_allreduce_async, grouped_reducescatter,
    grouped_reducescatter_async, join, poll, reducescatter,
    reducescatter_async, synchronize,
)
from .ops.compression import Compression  # noqa: F401
from .ops.process_set import ProcessSet  # noqa: F401
from .ops.flash_attention import (  # noqa: F401
    FlashAttention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_fwd_plain,
)
from .numerics import (  # noqa: F401
    check_replica_divergence, guard_non_finite, params_digest,
)
from .optim.distributed_optimizer import DistributedOptimizer  # noqa: F401
from .optim.functions import (  # noqa: F401
    broadcast_optimizer_state, broadcast_parameters,
)
from .parallel.mesh import data_parallel_mesh  # noqa: F401
from .parallel.ring_attention import attention  # noqa: F401
from .parallel.train import adamw, build_train_step  # noqa: F401
from .serving import (  # noqa: F401
    BucketLadder, ServingError, ServingFrontend, ServingFuture,
    build_ladder,
)

__version__ = "0.1.0"
