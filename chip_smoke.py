#!/usr/bin/env python3
"""Smoke run of horovod_tpu_torch on one NVIDIA card: builds the port's
CUDA kernels and its C++ control core from this checkout and drives its
serving, training, Adasum data-parallel, collective, data-parallel
train-step, negotiated-engine and PowerSGD paths.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

1. Device and build: the card's name and power limit (nvidia-smi), then
   nvcc builds the flash-attention forward and backward libraries and
   the Adasum pair-combine library, one nvcc per source, started
   together, and g++ the negotiation core (``core/cc``) beside them;
   one line per kernel instantiation with ptxas's registers, static
   shared memory and spill bytes (and the forward's, the dK/dV kernel's
   and the dQ kernel's dynamic shared memory per head dim).
2. Forward kernel vs plain: the kernel against its plain PyTorch version
   at the served shapes (B in 1, 2, 4; L 2048; 32 heads; head dim 128;
   bf16; causal), non-causal, head dim 64, ragged lengths (L = 16, 1000,
   2047), float16 at L = 2048, head dims the wrapper zero-pads to a
   kernel width (16, 80, 96, 192), and small float32 cases.
   Error on o and lse, kernel time (CUDA events), plain time,
   F.scaled_dot_product_attention's time as a yardstick (timed here,
   never called by the port), the bound and the achieved TFLOP/s. At
   the first served shape it also shows that the o check fails two
   faults planted in a copy of the plain version, each by 10x its
   tolerance or more.
3. Served forward vs plain: the served forward at Llama-2-7B width and
   2 layers, flash kernel vs the plain attention swapped in for it, on
   the same weights and tokens.
4. Serving at Llama-2-7B width and full depth (32 layers, bf16):
   ServingFrontend with one worker on the card, ladder b = 1, 2, 4,
   6 requests of 2048 tokens. Asserts 6 completed, 0 failed, no worker
   failure, 3 warm-ups and no growth, finite logits, and kernel
   launches = 32 x (warm-ups + served batches). Then the length ladder
   (HOROVOD_SERVING_MAX_LEN=64: rungs 16, 32, 64) at 2 layers: it warms
   up, answers requests of 10, 30 and 50 tokens, and each answer's
   per-position logits match the plain path at the request's own length.
5. Backward kernels vs plain: dK/dV and dQ against the plain backward
   (float32) on the same inputs, at the training shape (2, 2048, 32,
   128) causal bf16, at B = 4, non-causal, head dim 64, head dim 256,
   ragged lengths (L = 16, 1000, 2047), float16 at L = 2048, the padded
   head dims, and small float32 cases. At the training shape it shows
   that the check fails four faults planted in a copy of the plain
   backward, each by 10x its tolerance or more, and it times each
   kernel, the plain backward and the backward of
   F.scaled_dot_product_attention (timed only).
6. Training path vs plain: Llama-2-7B width, 2 layers, B = 2, L =
   2048: loss and every parameter's gradient with the kernels against
   the same step with both plain versions swapped in; wq's gradient is
   non-zero, and two backward passes give bitwise equal gradients.
7. Training at Llama-2-7B width, 4 layers, B = 2, L = 2048, bf16:
   ``build_train_step`` with AdamW (optax.adamw(3e-4)'s settings), 5
   steps on one batch. The loss is finite at every step and falls from
   step 0 to step 4; each of the three kernels launches 4 x 5 times.
   Median step time, tokens/s and peak memory, then one more step timed
   in parts (layers' forward, LM head and loss, backward, AdamW). The
   tied LM head: its forward and forward + backward with the card's
   mixed product against the float32 product it replaced (same inputs,
   CUDA events; logits and gradients checked against it), and the
   median step with the float32 head swapped back in.
8. Adasum kernels vs plain: K1 (partials and coefficients) and K2
   (scaled add) against their plain versions for n in 1, 1000,
   2^20 + 7, 4096 * 11008 and 32000 * 4096, in float16, bfloat16 and
   float32, plus a zero norm, orthogonal vectors (the result is a + b)
   and a = -b (the result is 0). Checks: |dot - dot64| / (|a| |b|) <=
   1e-5 against float64 sums (and the same for |a|^2, |b|^2); the
   output's relative error (norm of the error over the plain result's)
   <= 1e-6 in float32 and 4e-3 in 16 bits (one rounding); two runs
   bitwise equal. Two faults planted in copies of the plain version
   (K1 without its last block of 32768 elements; K2 with ca for both
   operands) fail the check by 10x its tolerance or more. CUDA-event
   times of each kernel, its plain version and its bound at the
   gradient sizes.
9. Adasum data-parallel training, two ranks on one card: spawned
   processes on a gloo group (NCCL refuses two ranks on one device),
   Llama-2-7B width, 2 layers, B = 1, L = 2048, bf16, default knobs
   (Adasum's vhdd route): init -> broadcast_parameters (rank 1 starts
   from another seed) -> DistributedOptimizer(adamw(3e-4), op=Adasum,
   compression=fp16) -> 3 steps, each rank on its own batch. Gates:
   finite losses; parameters bitwise equal across ranks after the
   broadcast and after every step; K1 and K2 each launched once per
   gradient tensor per step on each rank (n = 2: one halving level); at
   step 0 one reduced FFN gradient equals the plain fold of both ranks'
   wires (gathered after the step) within phase 8's tolerance. Per
   step: forward and backward (hooks included), the exchange (host
   staging and gloo, host clock), the K1/K2 work (CUDA events), AdamW,
   peak memory per rank. Then the gather route
   (HOROVOD_ADASUM_PALLAS=1) for two steps with the same gates, and
   step 0's reduced FFN gradient of the two routes within phase 8's
   fp16 tolerance of each other.
10. Three gloo ranks on one card, default knobs (a power-of-two block
   of 2 and a block of 1, then one merge): vhdd Adasum of 4096 x 11008
   and 32000 x 4096 contributions in float16, bfloat16 and float32
   against the float64 ``adasum_reference`` of the same three (relative
   error of the norm within TOL_FOLD3: two roundings to the dtype),
   ranks bitwise equal, K1 and K2 launched twice on ranks 0 and 1 and
   once on rank 2 per call. The contributions share a common part
   (``coll_contribution``), so the coefficients sit near 0.6, and the
   phase fails unless the plain sum and a merge without its projection
   each land more than COLL_SEPARATION times the tolerance from the
   reference (both distances are logged beside the limit). Then
   allgather with uneven first dims, alltoall with uneven splits,
   reducescatter with a remainder, Min, Max and Product with prescale
   and postscale, grouped allgather and reducescatter,
   ``allgather_object``, ``barrier``, and a process set {0, 2}
   (allreduce, and Adasum in float16 and float32 within phase 8's
   tolerance, with one K1 and one K2 launch on each member; rank 1 is
   refused), each checked against host-computed answers and timed.
11. The data-parallel train step (``parallel/train.py`` on
   ``data_parallel_mesh()``), Llama-2-7B width, 2 layers, bf16. A world
   of one in a spawned process that adopts a one-rank NCCL group: 2
   steps (B = 2, L = 2048) with the mesh and 2 without, from the same
   weights; gates: 0 buckets and bitwise equal parameters. Then two
   ranks sharing the card on gloo (as phase 9), B = 1, L = 2048 per
   rank, each on its own batch, HOROVOD_NUMERICS_GUARD=1,
   ``guard_non_finite(adamw(3e-4))``, overlap on, the default 64 MiB
   threshold, 3 steps. Gates: the plan is DPS_PLAN's 13 buckets on both
   ranks; finite losses, equal across ranks; parameters bitwise equal
   across ranks after every step and ``check_replica_divergence``
   passes; K3 launched 2 x 3 times per kernel per rank; the probe shows
   13 ready events per step in plan order (one per wire group: one per
   bucket here) and 13 reduced events, each after its ready (gloo's
   worker threads complete them in their own order). Per step, on the
   host clock from hooks outside the step (``_StepClock``): forward +
   backward, the exchange after it up to AdamW and of that the bucket
   waits (to the probe's last reduced event), the exchange inside the
   backward (forward + backward less that of the overlap-off step),
   the share of the buckets' reduction time before the backward's end
   and that of the last bucket, AdamW, peak memory. Then: a step where
   rank 1's loss is NaN (both ranks
   skip; parameters and AdamW state unchanged bitwise, one consecutive
   skip) and a clean step that applies; a bit flipped on rank 1, which
   the divergence check names on both ranks as an AMBIGUOUS 1-vs-1
   split; and from the saved start, the overlap-off step (bitwise equal
   to the bucketed step 0) and the fp16 wire (each reduced gradient
   within TOL_FP16_WIRE of the uncompressed step's; its wire bytes).
   Phases 9 to 12 run with more than one rank, so their eager
   collectives go through the negotiated engine (HOROVOD_CONTROLLER
   "auto"); phase 11's bucketed exchange stays off it.
12. The negotiated engine, two gloo ranks sharing the card in a group
   they make themselves (rank 0's control port reaches rank 1 through
   it), Llama-2-7B width, 2 layers, bf16, HOROVOD_ORDER_CHECK=1:
   (a) eight named 4096 x 11008 bf16 allreduces with integer values,
   rank 1 submitting in reverse order: every result exactly its host
   answer; the same submission inline (at 4096 elements) must miss it
   (both distances logged beside the limit, 0). (b)
   DistributedOptimizer(adamw(3e-4), Average), 3 steps, B = 1, L =
   2048 per rank, each rank on its own batch, the default 64 MiB
   threshold, from seed 0's weights, then the same steps inline from
   the same weights: finite losses, ranks bitwise equal after every
   step, negotiated bitwise equal to inline, K3 launched 2 x 3 times
   per kernel per rank; per step the host-clock step time, agreed
   batches and entries per batch, mean negotiation latency, the host
   time of the agreed batches or inline ops (``hvd_dispatch_latency_
   seconds``: packing, staging and gloo), AdamW and peak memory. (d)
   Adasum of two fp16 4096 x 11008 gradients (a shared part plus each
   rank's noise), usually agreed in one batch (threshold raised to 256
   MiB), else in two: each within phase 8's fp16 tolerance of the
   float64 reference, one K1 and one K2 per tensor per rank. (e) A
   shape mismatch errors both ranks and the next op works;
   ``check_execution_order`` passes. (c) join: rank 1 joins after 2
   steps, rank 0 runs a third whose reduced gradients equal its own
   bitwise (one active rank), a broadcast gets the coordinator's join
   error, ``join`` returns 0 on both. (f) A world of one adopting a
   one-rank NCCL group, HOROVOD_CONTROLLER=native: a 16-tensor grouped
   allreduce of tensors a side stream is still producing, bitwise
   equal to the inputs and to the inline path.
13. PowerSGD (``ops/compression.py``) on both reduction planes, two
   gloo ranks sharing the card, Llama-2-7B width, 2 layers, bf16, B = 1,
   L = 2048 per rank, HOROVOD_NUMERICS_GUARD=1, the default 64 MiB:
   ``build_train_step(compression="powersgd:4")`` with
   ``guard_non_finite(adamw(3e-4))`` for 3 steps from the broadcast
   start, then a step rank 1's ``numerics.grad`` seam poisons and a
   clean one; then from the same start ``DistributedOptimizer(adamw,
   Average, compression=Compression.powersgd(rank=4))`` for 3
   negotiated steps and a poisoned one. Gates: (a) both ranks' plan is
   PSGD_PLAN (every matrix in a powersgd:4 bucket, the norms in one
   exact bucket); (b) hvd_wire_bytes_total{compression="powersgd:4"}
   moves by the reckoning per step, (n + m) 4 float32 elements per
   matrix plus the norms and the guard's flag (3,158,020 bytes; the
   optimizer records its factors, 3,076,096), where phase 11 moves
   1,071,726,592; (c) parameters bitwise equal across ranks after every
   step; (d) step 0's reduced ``layers.0.w_up`` gradient (the float32
   round) has sigma_5 / sigma_1 < PSGD_LOW_RANK, the exact average of
   the two ranks' gradients does not, and the applied gradient is that
   round halved and cast, bitwise; (e) the round within TOL_PSGD of the
   same round in float64 on the host over both ranks' gathered
   gradients, while a plain sum and a round with P left
   unorthogonalized each miss it by FAULT_MARGIN times the gate (all
   three logged); (f) the poisoned step skips on both ranks with the
   parameters, AdamW's state, Q and e bitwise unchanged, on both
   planes, and the next clean step applies; (g) K3 launched 2 x 3 times
   per kernel per rank on each plane. Per step: forward + backward,
   the exchange after it and the bucket waits (train step, as phase
   11), the synchronize and ``hvd_dispatch_latency_seconds``' delta
   (optimizer), the PowerSGD arithmetic (CUDA events around
   compress, project and decompress), AdamW, peak memory.
14. A ``{"kernels": [...]}`` line, the card line, then the last line
   ``{"ok": true, "device": {...}}``.

Forward tolerances, on the worst row's relative error (``row_rel_err``:
the 2-norm of the error over the 2-norm of the plain result, per query
row of o and per request's logits): bf16 1e-2 (the kernel rounds P to
bf16 before the P V product, and both paths round o and every
activation to bf16, about 2^-9 relative each); float32 1e-5 (summation
order only); float16 2e-3 (the same roundings with 3 more mantissa
bits). lse, on max abs error: 1e-4 (float32 statistics of the same
scores).

Backward tolerances, on the worst (b, h) slice's relative error
(``slice_rel_err``: the Frobenius norm of the error over that of the
plain result, per (b, h) slice of dq, dk and dv; a row measure does not
fit here: with causal masking query row 0's exact dq is 0): bf16 1e-2
(the kernels round P and dS to bf16 before their products and the
gradients to bf16, about 2^-9 relative each; a CPU emulation of that
rounding gives 2.4e-3); float16 2e-3 (the same with 3 more mantissa
bits); float32 1e-5 (summation order only). Training
path: every parameter gradient within 2e-2 of the plain path's
(``rel_err``, the Frobenius norm of the whole tensor's error over its
own; each attention's gradient differs by up to the bf16 tolerance, and
the forward's bf16 differences ride along), the loss within 1e-3
relative. float32 matrix products run in full float32 (TF32 off).

Without a CUDA device, or run from a directory without the package, it
exits non-zero and prints no result.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks of one H100 SXM at its 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Llama-2-7B (the repo's examples/llama2_7b_dp.py configuration).
LLAMA2_7B = dict(vocab=32000, d_model=4096, n_layers=32, n_heads=32,
                 n_kv_heads=32, head_dim=128, d_ff=11008, max_seq=2048)
SEQ = 2048
MAX_BATCH = 4
N_REQUESTS = 6
TOL_ROW = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-5}
TOL_LSE = 1e-4
FAULT_TILE = 128         # the forward kernel's key tile at head dim 128
BWD_FAULT_TILE = 64      # the dK/dV kernel's query tile at head dim 128
TOL_SLICE = {torch.bfloat16: 1e-2, torch.float16: 2e-3,
             torch.float32: 1e-5}
FAULT_MARGIN = 10.0      # a planted fault must exceed the tolerance 10x
TOL_GRAD = 2e-2          # training path: per-parameter gradient
TOL_LOSS = 1e-3          # training path: relative loss difference
TRAIN_BATCH = 2
TRAIN_LAYERS = 4
TRAIN_STEPS = 5
LR = 3e-4
# Adasum (phases 8 and 9).
TOL_DOT = 1e-5           # |dot - dot64| / (|a| |b|), and |a|^2, |b|^2
TOL_COMBINE = {torch.float32: 1e-6, torch.bfloat16: 4e-3,
               torch.float16: 4e-3}
ADASUM_SIZES = (1, 1000, 2 ** 20 + 7, 4096 * 11008, 32000 * 4096)
FAULT_BLOCK = 256 * 128  # the JAX kernel's block: BLOCK_ROWS x LANES
DP_LAYERS = 2
DP_STEPS = 3
DP_GATHER_STEPS = 2
DP_RANKS = 2


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def max_abs_err(got, ref):
    return float((got.float() - ref.float()).abs().max())


def row_rel_err(got, ref):
    """The worst row's relative error: over the last dim, the 2-norm of
    got - ref over the 2-norm of ref, maximised over all other dims."""
    got, ref = got.float(), ref.float()
    num = (got - ref).norm(dim=-1)
    return float((num / ref.norm(dim=-1).clamp_min(1e-30)).max())


def rel_err(got, ref, dims=None):
    """The Frobenius norm of got - ref over that of ref, taken over
    ``dims`` (all of them by default) and maximised over the rest."""
    got, ref = (x.detach().float() if isinstance(x, torch.Tensor)
                else torch.from_numpy(np.array(x, np.float32))
                for x in (got, ref))
    dims = tuple(range(ref.dim())) if dims is None else dims
    norm = torch.linalg.vector_norm
    return float((norm(got - ref, dim=dims)
                  / norm(ref, dim=dims).clamp_min(1e-30)).max())


def slice_rel_err(got, ref):
    """The worst (b, h) slice's relative error of (B, L, H, D) tensors."""
    return rel_err(got, ref, dims=(1, 3))


def grads_rel_err(got, ref):
    """The worst of ``slice_rel_err`` over matching (dq, dk, dv)."""
    return max(slice_rel_err(g, r) for g, r in zip(got, ref))


def planted_faults(fa, q, k, v, causal, tile=FAULT_TILE):
    """o of two faulty copies of the plain version, each a bug a flash
    kernel can have: ``no_rescale`` never rescales earlier key tiles'
    terms when the running max grows; ``v_first_tile`` reads every
    key tile's V from the first tile."""
    B, L, H, D = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D ** -0.5
    if causal:
        mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    m_run = s.unflatten(-1, (L // tile, tile)).amax(-1).cummax(-1).values
    p = torch.exp(s - m_run.repeat_interleave(tile, -1))
    del s, m_run
    no_rescale = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / \
        p.sum(-1).transpose(1, 2)[..., None]
    del p
    v_bad = v[:, :tile].repeat(1, L // tile, 1, 1)
    v_first_tile = fa.flash_attention_fwd_plain(q, k, v_bad, causal)[0]
    return {"no_rescale": no_rescale.to(q.dtype),
            "v_first_tile": v_first_tile}


def planted_backward_faults(q, k, v, o, lse, do, causal,
                            tile=BWD_FAULT_TILE):
    """(dq, dk, dv) of four faulty copies of the plain backward, each a
    bug a flash backward kernel can have: ``no_di`` leaves di out of dS;
    ``no_causal_mask`` recomputes P over every key; ``dk_unscaled``
    leaves the softmax scale out of dK; ``ring_first_tile`` computes dK
    and dV from the first query tile's Q, dO, lse and di in place of
    every tile's (a ring stage read on the wrong parity)."""
    D = q.shape[-1]
    scale = D ** -0.5

    def first_tile(x, dim):
        reps = [1] * x.dim()
        reps[dim] = x.shape[dim] // tile
        return x.narrow(dim, 0, tile).repeat(*reps)

    def bwd(di_on=True, mask_on=True, dk_scale=scale, q=q, o=o, lse=lse,
            do=do):
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        if causal and mask_on:
            L = q.shape[1]
            mask = torch.ones(L, L, dtype=torch.bool,
                              device=q.device).tril()
            s = s.masked_fill(~mask, float("-inf"))
        p = torch.exp(s - lse[..., None])
        del s
        dof = do.float()
        dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
        ds = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
        if di_on:
            ds -= (o.float() * dof).sum(-1).transpose(1, 2)[..., None]
        ds *= p
        del p
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * dk_scale
        return tuple(x.to(q.dtype) for x in (dq, dk, dv))

    ring = bwd(q=first_tile(q, 1), o=first_tile(o, 1),
               lse=first_tile(lse, 2), do=first_tile(do, 1))
    return {"no_di": bwd(di_on=False), "no_causal_mask": bwd(mask_on=False),
            "dk_unscaled": bwd(dk_scale=1.0),
            "ring_first_tile": (bwd()[0], *ring[1:])}


def time_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(B, L, H, D, causal, dtype, products=2, tensors=4,
                    stats=1):
    """Least time for attention work: ``products`` matrix products of
    2*D operations per visible (query, key) pair, and ``tensors``
    (B, L, H, D) tensors and ``stats`` (B, H, L) float32 rows each read
    or written once. The defaults are the forward's: q k^T and P v;
    q, k, v and o; lse."""
    pairs = L * (L + 1) // 2 if causal else L * L
    ops = 2.0 * products * B * H * D * pairs
    esize = torch.finfo(dtype).bits // 8
    nbytes = float(tensors) * B * L * H * D * esize + stats * 4.0 * B * H * L
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", ops)


# The backward's work, as attention_bound's (products, tensors, stats):
# dK/dV does S^T, dP^T, P^T dO and dS^T Q, reads q, k, v, dO, lse and
# di and writes dk, dv; dQ does S, dP and dS K, reads the same and
# writes dq; the function as a whole needs five products (S, dP and the
# three gradients), reads q, k, v, o, dO and lse and writes dq, dk, dv.
BWD_WORK = {"dkv": (4, 6, 2), "dq": (3, 5, 2), "function": (5, 8, 1)}


# Lengths the kernels take since they mask a ragged last tile (the
# serving ladder's first rungs, lengths that are not a multiple of a
# tile) and float16; phases 2 and 5 hold both directions to them.
RAGGED_AND_F16_CASES = [(1, 16, 32, 128, True, torch.bfloat16),
                        (1, 1000, 32, 128, True, torch.bfloat16),
                        (1, 2047, 32, 128, False, torch.bfloat16),
                        (1, 1000, 8, 64, False, torch.float32),
                        (2, SEQ, 32, 128, True, torch.float16)]
# Head dims the kernels are not built for: the wrapper zero-pads them to
# the next kernel width (the repo's small configurations use 16).
PADDED_HEAD_DIM_CASES = [(2, 512, 8, 16, True, torch.bfloat16),
                         (1, 1000, 8, 80, False, torch.bfloat16),
                         (1, 512, 8, 96, True, torch.float16),
                         (1, 512, 8, 192, True, torch.bfloat16),
                         (1, 256, 4, 80, True, torch.float32)]


def phase_kernel_vs_plain(fa, dev):
    cases = [(4, SEQ, 32, 128, True, torch.bfloat16),
             (2, SEQ, 32, 128, True, torch.bfloat16),
             (1, SEQ, 32, 128, True, torch.bfloat16),
             (4, SEQ, 32, 128, False, torch.bfloat16),
             (4, SEQ, 32, 64, True, torch.bfloat16),
             (1, 256, 4, 64, True, torch.float32),
             (1, 256, 4, 128, False, torch.float32),
             (1, 256, 2, 256, True, torch.float32),
             (1, 256, 2, 256, True, torch.bfloat16),
             *RAGGED_AND_F16_CASES, *PADDED_HEAD_DIM_CASES]
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for i, (B, L, H, D, causal, dtype) in enumerate(cases):
        q, k, v = (torch.randn((B, L, H, D), generator=gen, device=dev,
                               dtype=torch.float32).to(dtype)
                   for _ in range(3))
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal)
        o_rel, l_abs = row_rel_err(o, o_ref), max_abs_err(lse, lse_ref)
        tol = TOL_ROW[dtype]
        if not (o_rel <= tol and l_abs <= TOL_LSE):
            raise AssertionError(
                f"flash_attention_fwd disagrees with its plain version "
                f"at {(B, L, H, D)} causal={causal} {dtype}: o row rel "
                f"{o_rel:.3e} (tol {tol}), lse abs {l_abs:.3e} "
                f"(tol {TOL_LSE})")
        bound_ms, bound_by, ops = attention_bound(B, L, H, D, causal, dtype)
        case = {"shape": [B, L, H, D], "causal": causal,
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": max_abs_err(o, o_ref), "row_rel_err": o_rel,
                "lse_max_abs_err": l_abs,
                "bound_ms": bound_ms, "bound_by": bound_by}
        if i == 0:
            faults = {name: row_rel_err(bad, o_ref) for name, bad in
                      planted_faults(fa, q, k, v, causal).items()}
            if not all(err >= FAULT_MARGIN * tol
                       for err in faults.values()):
                raise AssertionError(
                    f"the o check (tol {tol}) does not reject every "
                    f"planted fault by {FAULT_MARGIN}x: {faults}")
            case["planted_fault_row_rel_err"] = faults
        if L == SEQ:
            ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal),
                         20)
            plain_ms = time_ms(
                lambda: fa.flash_attention_fwd_plain(q, k, v, causal), 3,
                warmup=1)
            qt, kt, vt = (x.transpose(1, 2).contiguous()
                          for x in (q, k, v))
            library_ms = time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal), 20)
            case.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        tflops=ops / (ms * 1e-3) / 1e12,
                        roofline_share=bound_ms / ms)
        log("phase 2: " + json.dumps(case))
        out.append(case)
        del q, k, v, o, lse, o_ref, lse_ref
    torch.cuda.empty_cache()
    return out


def composed_forward(tfm, cfg):
    """Transformer forward, then the LM head on the last position: the
    (B, vocab) float32 logits a serving client gets back."""
    def forward_fn(params, tokens):
        hidden, _ = tfm.forward(cfg, params, tokens)
        return tfm.logits_fn(cfg, params, hidden[:, -1:])[:, -1]
    return forward_fn


@contextlib.contextmanager
def plain_attention(fa):
    """Run the model's attention, forward and backward, through the
    kernels' plain versions."""
    kernels = fa.flash_attention_fwd, fa.flash_attention_bwd
    fa.flash_attention_fwd = fa.flash_attention_fwd_plain
    fa.flash_attention_bwd = fa.flash_attention_bwd_plain
    try:
        yield
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = kernels


def launch_counts(fa):
    return {"fwd": fa.launches, "dkv": fa.launches_dkv, "dq": fa.launches_dq}


def reset_counts(fa):
    fa.launches = fa.launches_dkv = fa.launches_dq = 0


def phase_path_vs_plain(fa, tfm, dev):
    cfg = tfm.TransformerConfig(**dict(LLAMA2_7B, n_layers=2),
                                dtype=torch.bfloat16)
    model = tfm.init_params(cfg, seed=1, device=dev)
    fwd = composed_forward(tfm, cfg)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (MAX_BATCH, SEQ)).astype(np.int32)).to(dev)
    with torch.inference_mode():
        before = fa.launches
        with plain_attention(fa):
            ref = fwd(model, tokens)
        plain_launches = fa.launches - before
        got = fwd(model, tokens)
        torch.cuda.synchronize()
        kernel_launches = fa.launches - before - plain_launches
    if (plain_launches, kernel_launches) != (0, cfg.n_layers):
        raise AssertionError(
            f"phase 3: {plain_launches} launches on the plain path, "
            f"{kernel_launches} on the kernel path, want 0 and "
            f"{cfg.n_layers}")
    err, rel = max_abs_err(got, ref), row_rel_err(got, ref)
    log(f"phase 3: 2-layer Llama-2-7B-width logits {tuple(got.shape)}, "
        f"kernel vs plain max abs err {err:.4e}, row rel {rel:.3e} (tol "
        f"{TOL_ROW[torch.bfloat16]})")
    if not (torch.isfinite(got).all() and rel <= TOL_ROW[torch.bfloat16]):
        raise AssertionError("served forward: kernel path disagrees with "
                             "the plain path")
    del model
    torch.cuda.empty_cache()
    return {"logits_max_abs_err": err, "logits_row_rel_err": rel}


def phase_serving(fa, tfm, serving):
    cfg = tfm.TransformerConfig(**LLAMA2_7B, dtype=torch.bfloat16)
    t0 = time.monotonic()
    model = tfm.init_params(cfg, seed=0)          # on the card
    torch.cuda.synchronize()
    log(f"phase 4: {sum(p.numel() for p in model.parameters())} "
        f"parameters drawn on {model.embed.device} in "
        f"{time.monotonic() - t0:.1f} s")
    env = {"HOROVOD_SERVING_MAX_BATCH": str(MAX_BATCH),
           "HOROVOD_SERVING_LATENCY_BUDGET_MS": "50",
           "HOROVOD_SERVING_MIN_WORKERS": "1",
           "HOROVOD_SERVING_MAX_WORKERS": "1",
           "HOROVOD_SERVING_WORKER_TIMEOUT_S": "300"}
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    t0 = time.monotonic()
    fe = serving.ServingFrontend(composed_forward(tfm, cfg), (SEQ,),
                                 "int32", env=env, autoscale=False,
                                 params=model)
    t_built = time.monotonic() - t0
    try:
        shapes = len(fe.ladder.shapes((SEQ,)))
        deadline = time.monotonic() + 600
        while fe.stats()["compiles"] < shapes:
            if fe.stats()["worker_failures"] or time.monotonic() > deadline:
                raise AssertionError(f"warm-up failed: {fe.stats()}")
            time.sleep(0.05)
        warm_launches = fa.launches
        log(f"phase 4: ladder {fe.ladder.digest}; frontend built in "
            f"{t_built:.1f} s (host digest of the weights), {shapes} "
            f"shapes warm {time.monotonic() - t0 - t_built:.1f} s later, "
            f"{warm_launches} kernel launches")
        rng = np.random.RandomState(2)
        futs = [fe.submit(rng.randint(0, cfg.vocab, SEQ).astype(np.int32))
                for _ in range(N_REQUESTS)]
        rows = [f.result(timeout=600) for f in futs]
        stats = fe.stats()
    finally:
        fe.close()
    launches = fa.launches
    lat_ms = [1e3 * (f.t_done - f.t_submit) for f in futs]
    log(f"phase 4: stats {json.dumps(stats)}")
    problems = []
    if stats["completed"] != N_REQUESTS or stats["failed"] != 0:
        problems.append("not every request completed")
    if stats["worker_failures"] or stats["retries"]:
        problems.append("a worker failed")
    if stats["compiles"] != shapes:
        problems.append("warm-up count grew under traffic")
    if warm_launches != cfg.n_layers * shapes or \
            launches != cfg.n_layers * (shapes + stats["batches"]):
        problems.append(f"kernel launches {warm_launches} warm, "
                        f"{launches} total, for {stats['batches']} "
                        f"batches of {cfg.n_layers} layers")
    for r in rows:
        if r.shape != (cfg.vocab,) or r.dtype != np.float32 \
                or not np.isfinite(r).all():
            problems.append(f"bad logits {r.shape} {r.dtype}")
    if problems:
        raise AssertionError("phase 4: " + "; ".join(problems))
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 4: {N_REQUESTS}/{N_REQUESTS} requests in "
        f"{stats['batches']} batches; latency ms "
        f"{[round(x, 1) for x in lat_ms]}; peak memory {peak} bytes; "
        f"{launches} flash launches ({cfg.n_layers} per executed batch)")
    return {"launches": launches,
            "launches_per_batch": launches // (shapes + stats["batches"]),
            "batches": stats["batches"],
            "warmups": shapes, "latency_ms": lat_ms,
            "max_memory_allocated": peak}


LADDER_MAX_LEN = 64
LADDER_LENGTHS = (10, 30, 50)    # rungs 16, 32, 64


def phase_serving_ladder(fa, tfm, serving):
    """The length ladder on the card (HOROVOD_SERVING_MAX_LEN=64: rungs
    16, 32, 64, so every served attention is a ragged tile) at
    Llama-2-7B width and 2 layers: it warms up, answers, and each
    answer's per-position logits (the padded tail cut off by the
    frontend) match the plain path at the request's own length."""
    cfg = tfm.TransformerConfig(**dict(LLAMA2_7B, n_layers=2),
                                dtype=torch.bfloat16)
    model = tfm.init_params(cfg, seed=6)

    def forward_fn(params, tokens):
        hidden, _ = tfm.forward(cfg, params, tokens)
        return tfm.logits_fn(cfg, params, hidden)

    env = {"HOROVOD_SERVING_MAX_BATCH": "2",
           "HOROVOD_SERVING_MAX_LEN": str(LADDER_MAX_LEN),
           "HOROVOD_SERVING_LATENCY_BUDGET_MS": "20",
           "HOROVOD_SERVING_MIN_WORKERS": "1",
           "HOROVOD_SERVING_MAX_WORKERS": "1",
           "HOROVOD_SERVING_WORKER_TIMEOUT_S": "300"}
    rng = np.random.RandomState(8)
    requests = [rng.randint(0, cfg.vocab, n).astype(np.int32)
                for n in LADDER_LENGTHS]
    fa.launches = 0
    fe = serving.ServingFrontend(forward_fn, (), "int32", env=env,
                                 autoscale=False, params=model)
    try:
        shapes = len(fe.ladder.shapes(()))
        deadline = time.monotonic() + 300
        while fe.stats()["compiles"] < shapes:
            if fe.stats()["worker_failures"] or time.monotonic() > deadline:
                raise AssertionError(f"phase 4 ladder: warm-up failed: "
                                     f"{fe.stats()}")
            time.sleep(0.05)
        rows = [f.result(timeout=300)
                for f in [fe.submit(r) for r in requests]]
        stats = fe.stats()
    finally:
        fe.close()
    launches = fa.launches
    errs = []
    with torch.inference_mode(), plain_attention(fa):
        for req, row in zip(requests, rows):
            tokens = torch.from_numpy(req[None].astype(np.int64)).to(
                model.embed.device)
            ref = forward_fn(model, tokens)[0].cpu()
            got = torch.from_numpy(np.asarray(row))
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise AssertionError(f"phase 4 ladder: answer "
                                     f"{tuple(got.shape)}, want "
                                     f"{tuple(ref.shape)}, finite")
            errs.append(row_rel_err(got, ref))
    result = {"ladder": fe.ladder.digest, "shapes": shapes,
              "lengths": list(LADDER_LENGTHS),
              "row_rel_err": errs, "launches": launches,
              "stats": {k: stats[k] for k in ("completed", "failed",
                                              "compiles", "batches")}}
    log("phase 4 ladder: " + json.dumps(result))
    if stats["completed"] != len(requests) or stats["failed"] \
            or stats["worker_failures"] or stats["compiles"] != shapes:
        raise AssertionError(f"phase 4 ladder: {stats}")
    if max(errs) > TOL_ROW[torch.bfloat16]:
        raise AssertionError(f"phase 4 ladder: served logits disagree with "
                             f"the plain path: {errs}")
    if launches != cfg.n_layers * (shapes + stats["batches"]):
        raise AssertionError(f"phase 4 ladder: {launches} launches for "
                             f"{shapes} warm-ups and {stats['batches']} "
                             f"batches of {cfg.n_layers} layers")
    del model
    torch.cuda.empty_cache()
    return result


BWD_CASES = [(2, SEQ, 32, 128, True, torch.bfloat16),   # training shape
             (4, SEQ, 32, 128, True, torch.bfloat16),
             (2, SEQ, 32, 128, False, torch.bfloat16),
             (2, SEQ, 32, 64, True, torch.bfloat16),
             (2, SEQ, 16, 256, True, torch.bfloat16),
             (1, 256, 4, 128, True, torch.float32),
             (1, 256, 2, 64, False, torch.float32),
             (1, 256, 2, 256, True, torch.float32),
             *RAGGED_AND_F16_CASES, *PADDED_HEAD_DIM_CASES]


def sdpa_backward_ms(q, k, v, do, causal):
    """The backward of F.scaled_dot_product_attention on the same
    inputs, in its (B, H, L, D) layout: timed as a yardstick only."""
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal)
    return time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 20)


def phase_backward_vs_plain(fa, dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    out = []
    for i, (B, L, H, D, causal, dtype) in enumerate(BWD_CASES):
        q, k, v, do = (torch.randn((B, L, H, D), generator=gen, device=dev,
                                   dtype=torch.float32).to(dtype)
                       for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
        names = ("dq", "dk", "dv")
        errs = {n: slice_rel_err(g, r) for n, g, r in zip(names, got, ref)}
        tol = TOL_SLICE[dtype]
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        if not (finite and max(errs.values()) <= tol):
            raise AssertionError(
                f"flash_attention_bwd disagrees with its plain version at "
                f"{(B, L, H, D)} causal={causal} {dtype}: worst (b, h) "
                f"slice rel err {errs} (tol {tol}), finite={finite}")
        case = {"shape": [B, L, H, D], "causal": causal,
                "dtype": str(dtype).replace("torch.", ""),
                "slice_rel_err": errs,
                "max_abs_err": {n: max_abs_err(g, r)
                                for n, g, r in zip(names, got, ref)}}
        if i == 0:
            faults = {name: grads_rel_err(bad, ref) for name, bad in
                      planted_backward_faults(q, k, v, o, lse, do,
                                              causal).items()}
            if not all(err >= FAULT_MARGIN * tol for err in faults.values()):
                raise AssertionError(
                    f"the backward check (tol {tol}) does not reject "
                    f"every planted fault by {FAULT_MARGIN}x: {faults}")
            case["planted_fault_slice_rel_err"] = faults
        if L == SEQ:
            scale = D ** -0.5
            di = fa.backward_di(o, do)
            timed = {
                "dkv": lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, do, lse, di, causal, scale),
                "dq": lambda: fa.flash_attention_bwd_dq(
                    q, k, v, do, lse, di, causal, scale),
                "function": lambda: fa.flash_attention_bwd(
                    q, k, v, o, lse, do, causal)}
            for name, fn in timed.items():
                bound_ms, bound_by, ops = attention_bound(
                    B, L, H, D, causal, dtype, *BWD_WORK[name])
                ms = time_ms(fn, 20)
                case[name] = {"ms": ms, "bound_ms": bound_ms,
                              "bound_by": bound_by,
                              "tflops": ops / (ms * 1e-3) / 1e12,
                              "roofline_share": bound_ms / ms}
            case["plain_ms"] = time_ms(
                lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                     causal), 3, warmup=1)
            case["library_ms"] = sdpa_backward_ms(q, k, v, do, causal)
        log("phase 5: " + json.dumps(case))
        out.append(case)
        del q, k, v, do, o, lse, got, ref
        torch.cuda.empty_cache()
    return out


def train_batch(cfg, seed):
    """One fixed next-token batch from a seed, on the host: the step
    moves it to the card."""
    tokens = np.random.RandomState(seed).randint(
        0, cfg.vocab, (TRAIN_BATCH, SEQ)).astype(np.int64)
    return {"tokens": torch.from_numpy(tokens),
            "targets": torch.from_numpy(np.roll(tokens, -1, axis=1))}


def phase_training_path_vs_plain(fa, tfm, dev):
    cfg = tfm.TransformerConfig(**dict(LLAMA2_7B, n_layers=2),
                                dtype=torch.bfloat16)
    model = tfm.init_params(cfg, seed=1, device=dev)
    batch = {k: v.to(dev) for k, v in train_batch(cfg, seed=3).items()}

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = tfm.loss_fn(cfg, model, batch)
        loss.backward()
        return loss.detach(), {n: p.grad.clone()
                               for n, p in model.named_parameters()}

    reset_counts(fa)
    with plain_attention(fa):
        loss_ref, ref = loss_and_grads()
    plain_launches = launch_counts(fa)
    loss1, got = loss_and_grads()
    loss2, again = loss_and_grads()
    torch.cuda.synchronize()
    kernel_launches = launch_counts(fa)
    want = {n: 2 * cfg.n_layers for n in kernel_launches}
    if any(plain_launches.values()) or kernel_launches != want:
        raise AssertionError(
            f"phase 6: launches {plain_launches} on the plain path and "
            f"{kernel_launches} on two kernel passes, want none and {want}")
    errs = {n: rel_err(got[n], ref[n]) for n in ref}
    worst = max(errs, key=errs.get)
    loss_rel = abs(float(loss1) - float(loss_ref)) / abs(float(loss_ref))
    unequal = [n for n in got if not torch.equal(got[n], again[n])]
    wq_norm = float(got["layers.0.wq"].float().norm())
    result = {"loss": float(loss1), "loss_plain": float(loss_ref),
              "loss_rel_err": loss_rel, "worst_grad": worst,
              "worst_grad_rel_err": errs[worst],
              "grad_rel_err": errs, "wq_grad_norm": wq_norm,
              "bitwise_repeatable": not unequal and bool(
                  torch.equal(loss1, loss2))}
    log("phase 6: " + json.dumps(result))
    problems = []
    if not (errs[worst] <= TOL_GRAD and loss_rel <= TOL_LOSS):
        problems.append(f"kernel path disagrees with the plain path "
                        f"(tol {TOL_GRAD} per gradient, {TOL_LOSS} loss)")
    if not (wq_norm > 0 and all(bool(torch.isfinite(g).all())
                                for g in got.values())):
        problems.append("wq gets no gradient or a gradient is not finite")
    if not result["bitwise_repeatable"]:
        problems.append(f"two backward passes differ in {unequal}")
    if problems:
        raise AssertionError("phase 6: " + "; ".join(problems))
    del model, got, again, ref
    torch.cuda.empty_cache()
    return result


def step_breakdown(tfm, cfg, model, optimizer, batch):
    """One more step, the work of ``build_train_step``'s step written
    out, with CUDA events between its parts: the layers' forward, the
    LM head and loss, the backward, the AdamW update."""
    batch = {k: v.to(model.embed.device) for k, v in batch.items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    optimizer.zero_grad(set_to_none=True)
    hidden, aux = tfm.forward(cfg, model, batch["tokens"])
    ev[1].record()
    nll = tfm.vocab_parallel_xent(cfg, tfm.logits_fn(cfg, model, hidden),
                                  batch["targets"])
    loss = nll.mean() + 0.01 * aux
    ev[2].record()
    loss.backward()
    ev[3].record()
    optimizer.step()
    ev[4].record()
    torch.cuda.synchronize()
    parts = ("forward", "head_and_loss", "backward", "optimizer")
    return {p: a.elapsed_time(b) for p, a, b in zip(parts, ev, ev[1:])}


def f32_lm_head(cfg, params, hidden):
    """The LM head as the parent tree computed it on the card: both
    operands copied to float32, a float32 product."""
    return torch.einsum("bld,vd->blv", hidden.to(cfg.dtype).float(),
                        params.embed.to(cfg.dtype).float())


def lm_head_before_after(tfm, cfg, model, optimizer, step, batch):
    """The tied LM head on the training shape: the card's mixed product
    (``tfm.logits_fn``) against the float32 product it replaced, forward
    and forward + backward (CUDA events), logits and gradients checked
    against it; then the median of 3 steps with the float32 head swapped
    back in, beside the steps above."""
    gen = torch.Generator(device=model.embed.device).manual_seed(11)
    hidden = torch.randn((TRAIN_BATCH, SEQ, cfg.d_model), generator=gen,
                         device=model.embed.device).to(cfg.dtype)
    heads = {"mixed": tfm.logits_fn, "f32": f32_lm_head}
    out = {}
    grads = {}
    for name, head in heads.items():
        with torch.no_grad():
            out[f"{name}_fwd_ms"] = time_ms(
                lambda: head(cfg, model, hidden), 10)
        h = hidden.detach().clone().requires_grad_()
        g = torch.randn((TRAIN_BATCH, SEQ, cfg.vocab), generator=gen,
                        device=hidden.device) if not grads else grads["g"]
        grads["g"] = g

        def fwd_bwd():
            model.embed.grad = None
            h.grad = None
            head(cfg, model, h).backward(g)

        out[f"{name}_fwd_bwd_ms"] = time_ms(fwd_bwd, 5)
        with torch.no_grad():
            grads[f"{name}_logits"] = head(cfg, model, hidden)
        fwd_bwd()
        grads[name] = (h.grad.clone(), model.embed.grad.clone())
    model.embed.grad = None
    out["logits_rel_err"] = rel_err(grads["mixed_logits"],
                                    grads["f32_logits"])
    out["grad_rel_err"] = max(rel_err(a, b) for a, b in
                              zip(grads["mixed"], grads["f32"]))
    del grads
    kept = tfm.logits_fn
    tfm.logits_fn = f32_lm_head
    try:
        times = []
        for _ in range(4):
            t0 = time.monotonic()
            float(step(model, batch)["loss"])
            times.append(time.monotonic() - t0)
    finally:
        tfm.logits_fn = kept
    out["f32_head_step_ms"] = [1e3 * t for t in times]
    out["f32_head_median_step_ms"] = 1e3 * statistics.median(times[1:])
    torch.cuda.empty_cache()
    return out


def phase_training(fa, tfm, train):
    cfg = tfm.TransformerConfig(**dict(LLAMA2_7B, n_layers=TRAIN_LAYERS),
                                dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    model = tfm.init_params(cfg, seed=0)            # on the card
    optimizer = train.adamw(model.parameters(), LR)
    step = train.build_train_step(
        lambda m, b: tfm.loss_fn(cfg, m, b), optimizer)
    batch = train_batch(cfg, seed=4)
    reset_counts(fa)
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.monotonic()
        losses.append(float(step(model, batch)["loss"]))  # waits
        step_s.append(time.monotonic() - t0)
    launches = launch_counts(fa)
    peak = torch.cuda.max_memory_allocated()
    median_ms = 1e3 * statistics.median(step_s[1:])
    result = {"n_parameters": sum(p.numel() for p in model.parameters()),
              "losses": losses, "step_ms": [1e3 * t for t in step_s],
              "median_step_ms": median_ms,
              "tokens_per_s": TRAIN_BATCH * SEQ / (median_ms * 1e-3),
              "max_memory_allocated": peak, "launches": launches,
              "breakdown_ms": step_breakdown(tfm, cfg, model, optimizer,
                                             batch)}
    result["lm_head"] = lm_head_before_after(tfm, cfg, model, optimizer,
                                             step, batch)
    log("phase 7: " + json.dumps(result))
    want = TRAIN_LAYERS * TRAIN_STEPS
    problems = []
    if not (result["lm_head"]["logits_rel_err"] <= 1e-5
            and result["lm_head"]["grad_rel_err"] <= TOL_COMBINE[
                torch.bfloat16]):
        problems.append(f"the mixed LM head disagrees with the float32 "
                        f"product: {result['lm_head']}")
    if not all(np.isfinite(losses)):
        problems.append("a loss is not finite")
    if not losses[-1] < losses[0]:
        problems.append("the loss did not fall")
    if any(n != want for n in launches.values()):
        problems.append(f"launches {launches}, want {want} of each")
    if problems:
        raise AssertionError("phase 7: " + "; ".join(problems))
    del model, optimizer
    torch.cuda.empty_cache()
    return result


def adasum_bound(n, dtype, kernel):
    """Least time of K1 (reads a and b: 2n elements, 6 operations per
    pair) or K2 (reads 2n, writes n: 3n elements, 3 operations per
    element), float32 operations outside the tensor cores."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = (2 if kernel == "k1" else 3) * n * esize
    ops = (6 if kernel == "k1" else 3) * n
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def adasum_errors(stats, out, a, b, ref_out):
    """K1's sums against float64 ones (|delta dot| / (|a| |b|); |a|^2 and
    |b|^2 relative) and K2's output against the plain result (norm of
    the error over the plain result's); an absolute error where the
    reference is zero."""
    ad, bd = a.reshape(-1).double(), b.reshape(-1).double()
    dot, asq, bsq = float(ad @ bd), float(ad @ ad), float(bd @ bd)
    got = [float(x) for x in stats[2:5].double().cpu()]

    def rel(x, ref, scale):
        return abs(x - ref) / scale if scale else abs(x - ref)

    ref_norm = float(ref_out.float().norm())
    return {"dot": rel(got[0], dot, (asq * bsq) ** 0.5),
            "asq": rel(got[1], asq, asq), "bsq": rel(got[2], bsq, bsq),
            "out": rel_err(out, ref_out) if ref_norm
            else float(out.float().abs().max())}


def adasum_check_ratio(errs, dtype):
    """The worst error over its tolerance: <= 1 passes."""
    return max(errs["dot"] / TOL_DOT, errs["asq"] / TOL_DOT,
               errs["bsq"] / TOL_DOT, errs["out"] / TOL_COMBINE[dtype])


def planted_adasum_faults(ak, a, b):
    """(stats, out) of two faulty copies of the plain version, each a bug
    the kernels can have: ``k1_tail_block_dropped`` leaves the last block
    of the JAX kernel's grid (FAULT_BLOCK elements, or the ragged rest)
    out of K1's sums; ``k2_ca_for_both`` scales b by ca in K2."""
    n = a.numel()
    keep = ((n - 1) // FAULT_BLOCK) * FAULT_BLOCK
    af, bf = a.reshape(-1)[:keep], b.reshape(-1)[:keep]
    dropped = ak.adasum_partials_plain(af, bf)
    good = ak.adasum_partials_plain(a, b)
    both = good.clone()
    both[1] = both[0]
    return {"k1_tail_block_dropped": (
                dropped, ak.adasum_scaled_add_plain(dropped, a, b)),
            "k2_ca_for_both": (good, ak.adasum_scaled_add_plain(both, a,
                                                                 b))}


def adasum_inputs(dev, n, dtype, seed, kind="random"):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(n, generator=gen, device=dev)
    if kind == "zero":
        return torch.zeros(n, device=dev).to(dtype), a.to(dtype)
    if kind == "orthogonal":
        b = torch.zeros(n, device=dev)
        b[n // 2:] = a[n // 2:]
        a[n // 2:] = 0
        return a.to(dtype), b.to(dtype)
    if kind == "opposite":
        a = a.to(dtype)
        return a, -a
    b = 0.3 * a + torch.randn(n, generator=gen, device=dev)
    return a.to(dtype), b.to(dtype)


def phase_adasum_kernels(ak, dev):
    cases = [(n, dtype, "random") for n in ADASUM_SIZES
             for dtype in (torch.float16, torch.bfloat16, torch.float32)]
    cases += [(4096, torch.float16, kind)
              for kind in ("zero", "orthogonal", "opposite")]
    out = []
    for i, (n, dtype, kind) in enumerate(cases):
        a, b = adasum_inputs(dev, n, dtype, seed=i, kind=kind)
        stats = ak.adasum_partials(a, b)
        got = ak.adasum_scaled_add(stats, a, b)
        stats2 = ak.adasum_partials(a, b)
        got2 = ak.adasum_scaled_add(stats2, a, b)
        torch.cuda.synchronize()
        ref = ak.adasum_pair_combine_plain(a, b)
        errs = adasum_errors(stats, got, a, b, ref)
        case = {"n": n, "dtype": str(dtype).replace("torch.", ""),
                "kind": kind, "errors": errs,
                "coeffs": stats[:2].tolist(),
                "max_abs_err": max_abs_err(got, ref),
                "coeff_max_abs_err": max_abs_err(
                    stats[:2], ak.adasum_partials_plain(a, b)[:2]),
                "bitwise_repeatable": bool(torch.equal(stats, stats2)
                                           and torch.equal(got, got2))}
        problems = []
        if adasum_check_ratio(errs, dtype) > 1:
            problems.append(f"errors {errs}")
        if not case["bitwise_repeatable"]:
            problems.append("two runs differ")
        if kind == "orthogonal" and not torch.equal(
                got.float(), (a.float() + b.float()).to(dtype).float()):
            problems.append("orthogonal vectors do not give a + b")
        if kind == "opposite" and float(got.float().abs().max()) != 0.0:
            problems.append("a = -b does not give 0")
        if kind == "zero" and stats[:2].tolist() != [1.0, 1.0]:
            problems.append(f"zero-norm guard gives {stats[:2].tolist()}")
        if problems:
            raise AssertionError(f"phase 8: n={n} {dtype} {kind}: "
                                 + "; ".join(problems))
        if n == 4096 * 11008 and dtype == torch.float32:
            faults = {}
            for name, (fs, fo) in planted_adasum_faults(ak, a, b).items():
                faults[name] = adasum_check_ratio(
                    adasum_errors(fs, fo, a, b, ref), dtype)
            if not all(r >= FAULT_MARGIN for r in faults.values()):
                raise AssertionError(f"phase 8: the check does not reject "
                                     f"every planted fault by "
                                     f"{FAULT_MARGIN}x: {faults}")
            case["planted_fault_check_ratio"] = faults
        if n >= 4096 * 11008 and dtype == torch.float16:
            for kernel, fn, plain in (
                    ("k1", lambda: ak.adasum_partials(a, b),
                     lambda: ak.adasum_partials_plain(a, b)),
                    ("k2", lambda: ak.adasum_scaled_add(stats, a, b),
                     lambda: ak.adasum_scaled_add_plain(stats, a, b))):
                bound_ms, bound_by = adasum_bound(n, dtype, kernel)
                ms = time_ms(fn, 20)
                case[kernel] = {"ms": ms, "plain_ms": time_ms(plain, 5),
                                "bound_ms": bound_ms, "bound_by": bound_by,
                                "roofline_share": bound_ms / ms}
        log("phase 8: " + json.dumps(case))
        out.append(case)
        del a, b, stats, got, stats2, got2, ref
        torch.cuda.empty_cache()
    return out


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _params_digest(model):
    import hashlib
    h = hashlib.sha256()
    for name, p in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(p.detach().contiguous().view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def _join_world(rank, size, port, device, extra_env=None):
    """Environment and init of one spawned rank of a gloo world on one
    card (NCCL refuses two ranks on one device)."""
    os.environ.update({
        "HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(size),
        "HOROVOD_LOCAL_RANK": str(rank), "HOROVOD_LOCAL_SIZE": str(size),
        "HOROVOD_COORDINATOR_ADDR": f"localhost:{port}",
        "HOROVOD_GLOO_TIMEOUT_SECONDS": "300", **(extra_env or {})})
    sys.path.insert(0, REPO)
    import horovod_tpu_torch as hvd
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    hvd.init()
    return hvd


class _Clock:
    """Sums of host-clock seconds (``exchange``: host staging and gloo)
    and of device milliseconds (``combine``: K1/K2 work, CUDA events;
    host clock on the CPU) around the wrapped functions."""

    def __init__(self, cuda):
        self.cuda = cuda
        self.reset()

    def reset(self):
        self.exchange_s, self.combine_ms = 0.0, 0.0

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def exchange(self, fn):
        def timed(*args, **kw):
            self.sync()
            t0 = time.monotonic()
            out = fn(*args, **kw)
            self.sync()
            self.exchange_s += time.monotonic() - t0
            return out
        return timed

    def combine(self, fn):
        def timed(*args, **kw):
            if not self.cuda:
                t0 = time.monotonic()
                out = fn(*args, **kw)
                self.combine_ms += 1e3 * (time.monotonic() - t0)
                return out
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*args, **kw)
            end.record()
            torch.cuda.synchronize()
            self.combine_ms += start.elapsed_time(end)
            return out
        return timed


def dp_rank_main(rank, port, results, device, cfg_kw, seq, route, steps):
    """One rank of phase 9, in a spawned process: the port's
    init -> broadcast_parameters -> DistributedOptimizer(adamw,
    op=Adasum, compression=fp16) -> steps, on Adasum's ``route``:
    "vhdd" under default knobs, "gather" under
    HOROVOD_ADASUM_PALLAS=1. The exchange and the K1/K2 work are timed
    around the port's own functions. ``device``, ``cfg_kw`` and ``seq``
    are the card, the model's config and the sequence length (the tests
    rehearse the phase on the CPU at a small size)."""
    status, payload = "error", None
    cuda = device.startswith("cuda")
    try:
        hvd = _join_world(rank, DP_RANKS, port, device,
                          {"HOROVOD_ADASUM_PALLAS": "1"}
                          if route == "gather" else None)
        from horovod_tpu_torch.models import transformer as tfm
        from horovod_tpu_torch.ops import adasum as adasum_mod
        from horovod_tpu_torch.ops import adasum_kernels as ak
        from horovod_tpu_torch.parallel import train
        cfg = tfm.TransformerConfig(**cfg_kw, dtype=torch.bfloat16)
        model = tfm.init_params(cfg, seed=rank, device=device)
        before = _params_digest(model)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            train.adamw(model.parameters(), LR),
            named_parameters=model.named_parameters(), op=hvd.Adasum,
            compression=hvd.Compression.fp16)
        clock = _Clock(cuda)
        probe = {}
        ffn = cfg.d_ff * cfg.d_model
        if route == "vhdd":
            wire = adasum_mod._DistWire
            for name in ("swap", "partials", "merge"):
                setattr(wire, name, clock.exchange(getattr(wire, name)))
            for name in ("_local_partials", "_blend"):
                setattr(adasum_mod, name,
                        clock.combine(getattr(adasum_mod, name)))
            inner = adasum_mod.vhdd

            def probed(seg, me, n, wire, use_kernel=False):
                red = inner(seg, me, n, wire, use_kernel)
                if "red" not in probe and seg.numel() == ffn:
                    probe["wire"], probe["red"] = seg.clone(), red.clone()
                return red
            adasum_mod.vhdd = probed
        else:
            adasum_mod.gather_rows = clock.exchange(adasum_mod.gather_rows)
            inner = clock.combine(adasum_mod._tree_fold)

            def probed(rows, use_pallas=False):
                red = inner(rows, use_pallas)
                if "red" not in probe and rows[0].numel() == ffn:
                    probe["wire"], probe["red"] = rows[rank].clone(), \
                        red.clone()
                return red
            adasum_mod._tree_fold = probed
        steps_out = []
        digests = [_params_digest(model)]
        ak.launches_partials = ak.launches_scaled_add = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        for step in range(steps):
            tokens = np.random.RandomState(100 * rank + step).randint(
                0, cfg.vocab, (1, seq)).astype(np.int64)
            batch = {"tokens": torch.from_numpy(tokens).to(device),
                     "targets": torch.from_numpy(
                         np.roll(tokens, -1, axis=1)).to(device)}
            clock.reset()
            opt.zero_grad()
            clock.sync()
            t0 = time.monotonic()
            loss = tfm.loss_fn(cfg, model, batch)
            loss.backward()
            clock.sync()
            t1 = time.monotonic()
            # With more than one rank the reductions run on the
            # negotiated engine's thread: wait for them, then step.
            opt.synchronize()
            clock.sync()
            t2 = time.monotonic()
            with opt.skip_synchronize():
                opt.step()
            clock.sync()
            t3 = time.monotonic()
            steps_out.append({"loss": float(loss.detach()),
                              "forward_backward_ms": 1e3 * (t1 - t0),
                              "wait_ms": 1e3 * (t2 - t1),
                              "exchange_ms": 1e3 * clock.exchange_s,
                              "combine_ms": clock.combine_ms,
                              "adamw_ms": 1e3 * (t3 - t2),
                              "step_ms": 1e3 * (t3 - t0)})
            digests.append(_params_digest(model))
        launches = (ak.launches_partials, ak.launches_scaled_add)
        # Outside the timed window: both ranks' step-0 FFN wires, and
        # their plain fold.
        rows = adasum_mod.gather_rows(probe["wire"],
                                      hvd.global_process_set())
        plain = ak.adasum_pair_combine_plain(*rows)
        payload = {
            "route": route, "backend": hvd.backend(), "rank": hvd.rank(),
            "n_parameters": sum(p.numel() for p in model.parameters()),
            "n_grad_tensors": len(list(model.parameters())),
            "wire_bytes": 2 * sum(p.numel() for p in model.parameters()),
            "digest_before_broadcast": before, "digests": digests,
            "steps": steps_out, "launches": launches,
            "probe_rel_err": rel_err(probe["red"], plain),
            "probe_norm": float(probe["red"].float().norm()),
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if cuda else None)}
        if rank == 0:
            payload["probe_red"] = probe["red"].cpu().numpy()
        status = "ok"
        hvd.shutdown()
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        payload = traceback.format_exc()
    finally:
        results.put((rank, status, payload))


def spawn_ranks(target, size, args, timeout, phase):
    """Run ``target(rank, port, results, *args)`` on ``size`` spawned
    processes; their payloads in rank order. Every process is joined,
    and killed if it outlives the timeout."""
    import multiprocessing as mp
    import queue
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, port, results, *args))
             for r in range(size)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < size and time.monotonic() < deadline:
            try:
                rank, status, payload = results.get(timeout=1.0)
            except queue.Empty:
                if all(not p.is_alive() for p in procs):
                    break
                continue
            got[rank] = (status, payload)
    finally:
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()) + 10)
            if p.is_alive():
                p.kill()
                p.join(10)
    failed = {r: v for r, (st, v) in got.items() if st != "ok"}
    if failed or len(got) != size:
        raise AssertionError(f"{phase}: ranks {sorted(got)} reported; "
                             f"failures: {failed}")
    return [got[r][1] for r in range(size)]


def phase_adasum_training(device="cuda:0", cfg_kw=None, seq=SEQ,
                          timeout=900.0, route="vhdd", steps=DP_STEPS):
    cfg_kw = cfg_kw or dict(LLAMA2_7B, n_layers=DP_LAYERS)
    tag = "phase 9" if route == "vhdd" else "phase 9 gather"
    ranks = spawn_ranks(dp_rank_main, DP_RANKS,
                        (device, cfg_kw, seq, route, steps), timeout, tag)
    for r in ranks:
        log(f"{tag}: " + json.dumps({k: v for k, v in r.items()
                                     if k != "probe_red"}))
    problems = []
    if any(r["backend"] != "gloo" for r in ranks):
        problems.append("the two ranks on one card are not on gloo")
    if ranks[0]["digest_before_broadcast"] == \
            ranks[1]["digest_before_broadcast"]:
        problems.append("rank 1 did not start from other weights")
    for step in range(steps + 1):
        if len({r["digests"][step] for r in ranks}) != 1:
            problems.append(f"parameters differ across ranks after "
                            f"{'the broadcast' if step == 0 else f'step {step - 1}'}")
    for r in ranks:
        if not all(np.isfinite(s["loss"]) for s in r["steps"]):
            problems.append(f"rank {r['rank']}: a loss is not finite")
        # n = 2: one halving level (vhdd) or one pair combine (gather)
        # per gradient tensor. A CPU rehearsal runs the plain versions,
        # which count nothing.
        want = r["n_grad_tensors"] * steps if device.startswith(
            "cuda") else 0
        if r["launches"] != (want, want):
            problems.append(f"rank {r['rank']}: launches {r['launches']}, "
                            f"want {want} of K1 and of K2")
        if not (r["probe_rel_err"] <= TOL_COMBINE[torch.float16]
                and r["probe_norm"] > 0):
            problems.append(f"rank {r['rank']}: reduced FFN gradient vs the "
                            f"plain fold: {r['probe_rel_err']}")
    if problems:
        raise AssertionError(f"{tag}: " + "; ".join(problems))
    return ranks


def routes_rel_err(vhdd_ranks, gather_ranks):
    """Step 0's reduced FFN gradient on rank 0, vhdd against gather."""
    return rel_err(torch.from_numpy(vhdd_ranks[0]["probe_red"]).float(),
                   torch.from_numpy(gather_ranks[0]["probe_red"]).float())


# Phase 10: three gloo ranks on the card (blocks of 2 and 1, one merge).
COLL_RANKS = 3
COLL_SIZES = {"adasum": ((4096, 11008), (32000, 4096)), "width": 4096,
              "rows": 1000, "pair_adasum": (4096, 11008)}
TOL_SUM = 1e-6        # float32 sums, products of 3 rows in another order
# The non-power-of-two fold rounds to the dtype twice (the block's blend
# and the merge's), each within phase 8's one-rounding tolerance.
TOL_FOLD3 = {dtype: 2 * tol for dtype, tol in TOL_COMBINE.items()}


COLL_DTYPES = (torch.float16, torch.bfloat16, torch.float32)
# A wrong combine (a plain sum, a merge without its projection) must miss
# the float64 reference by more than this many times the tolerance.
COLL_SEPARATION = 10.0


def coll_contribution(device, shape, dtype, case, rank):
    """Rank ``rank``'s contribution to Adasum case ``case``: a part that
    every rank shares plus half as much of the rank's own noise. The
    Adasum coefficients then sit near 0.6; of independent vectors of
    this size they would be 1 +- 1e-4, and the sum would pass for
    Adasum."""
    def draw(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=device)
    return (draw(1000 * case + 999) + 0.5 * draw(1000 * case + rank)
            ).to(dtype)


def _norm_rel(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def adasum_gaps(contributions, ref):
    """How far two wrong combines land from the float64 Adasum ``ref``
    of ``contributions`` (float64 numpy vectors): the plain sum and,
    past two members, the fold whose last merge adds without its
    projection."""
    gaps = {"plain_sum_gap": _norm_rel(sum(contributions), ref)}
    if len(contributions) > 2:
        from horovod_tpu_torch.ops.adasum import adasum_reference
        gaps["unprojected_merge_gap"] = _norm_rel(
            adasum_reference(contributions[:-1]) + contributions[-1], ref)
    return gaps


def _host_rows(rank, rows, width, seed, dtype=torch.float32):
    x = np.random.RandomState(seed + 31 * rank).randn(rows, width)
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _digest(t):
    import hashlib
    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu()
                          .numpy()).hexdigest()


def coll_rank_main(rank, port, results, device, sizes):
    """One rank of phase 10: every collective of the port under
    default knobs, each checked against host-computed answers where it
    ran, timed on the host clock around a synchronised call."""
    status, payload = "error", None
    cuda = device.startswith("cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    try:
        hvd = _join_world(rank, COLL_RANKS, port, device)
        from horovod_tpu_torch.ops import adasum_kernels as ak
        n, width, rows = COLL_RANKS, sizes["width"], sizes["rows"]
        cases = {}

        def timed(name, fn):
            sync()
            t0 = time.monotonic()
            out = fn()
            sync()
            cases[name] = {"ms": 1e3 * (time.monotonic() - t0)}
            return out

        def check(name, ok, err=None):
            cases[name].update(ok=bool(ok), err=err)

        adasum = []
        case = 0
        for shape in sizes["adasum"]:
            for dtype in COLL_DTYPES:
                x = coll_contribution(device, shape, dtype, case, rank)
                ak.launches_partials = ak.launches_scaled_add = 0
                name = f"adasum {shape} {str(dtype)[6:]}"
                out = timed(name, lambda: hvd.allreduce(x, op=hvd.Adasum))
                res = {"case": case, "shape": list(shape),
                       "dtype": str(dtype)[6:], "digest": _digest(out),
                       "launches": (ak.launches_partials,
                                    ak.launches_scaled_add),
                       "ms": cases.pop(name)["ms"]}
                if rank == 0:
                    res["bits"] = out.view(torch.int16).cpu().numpy()
                adasum.append(res)
                case += 1
                del x, out
        dev = torch.device(device)
        # allgather, uneven first dims
        xs = [_host_rows(r, rows + 7 * r, width, 1, torch.bfloat16)
              for r in range(n)]
        got = timed("allgather", lambda: hvd.allgather(xs[rank].to(dev)))
        check("allgather", torch.equal(got.cpu(), torch.cat(xs)))
        # alltoall, uneven splits
        splits = [[64 * ((r + 2 * j) % 3 + 1) for j in range(n)]
                  for r in range(n)]
        ins = [_host_rows(r, sum(splits[r]), width, 2, torch.bfloat16)
               for r in range(n)]
        got, recv = timed("alltoall", lambda: hvd.alltoall(
            ins[rank].to(dev), splits=splits[rank]))
        want = torch.cat([torch.split(ins[src], splits[src])[rank]
                          for src in range(n)])
        check("alltoall", torch.equal(got.cpu(), want)
              and recv.tolist() == [splits[src][rank] for src in range(n)])
        # reducescatter, a remainder (3 * rows + 1 rows)
        rs = [_host_rows(r, n * rows + 1, width, 3) for r in range(n)]
        got = timed("reducescatter", lambda: hvd.reducescatter(
            rs[rank].to(dev), op=hvd.Sum))
        base, rem = divmod(n * rows + 1, n)
        start = rank * base + min(rank, rem)
        want = sum(x.double() for x in rs)[start:start + base
                                           + (rank < rem)]
        err = rel_err(got.double().cpu(), want)
        check("reducescatter", err <= TOL_SUM, err)
        # Min, Max, Product with prescale 2 and postscale 0.5
        ms = [_host_rows(r, rows, width, 4) for r in range(n)]
        for name, op, fold in (("min", hvd.Min, torch.minimum),
                               ("max", hvd.Max, torch.maximum),
                               ("product", hvd.Product, torch.mul)):
            got = timed(name, lambda: hvd.allreduce(
                ms[rank].to(dev), op=op, prescale_factor=2.0,
                postscale_factor=0.5))
            want = 2.0 * ms[0].double()
            for x in ms[1:]:
                want = fold(want, 2.0 * x.double())
            want = 0.5 * want
            err = rel_err(got.double().cpu(), want)
            check(name, err <= (TOL_SUM if op == hvd.Product else 0.0), err)
        # grouped allgather and reducescatter
        ga = [[_host_rows(r, 64 * (r + 1), width, 5, torch.bfloat16),
               _host_rows(r, 2 * r + 1, 128, 6, torch.float16)]
              for r in range(n)]
        got = timed("grouped_allgather", lambda: hvd.grouped_allgather(
            [t.to(dev) for t in ga[rank]]))
        check("grouped_allgather", all(
            torch.equal(g.cpu(), torch.cat([ga[r][i] for r in range(n)]))
            for i, g in enumerate(got)))
        gr = [[_host_rows(r, 301, width, 7), _host_rows(r, 7, 1000, 8)]
              for r in range(n)]
        got = timed("grouped_reducescatter",
                    lambda: hvd.grouped_reducescatter(
                        [t.to(dev) for t in gr[rank]], op=hvd.Sum))
        errs = []
        for i, g in enumerate(got):
            total = sum(gr[r][i].double() for r in range(n))
            b, m = divmod(total.shape[0], n)
            lo = rank * b + min(rank, m)
            errs.append(rel_err(g.double().cpu(),
                                total[lo:lo + b + (rank < m)]))
        check("grouped_reducescatter", max(errs) <= TOL_SUM, max(errs))
        # allgather_object and barrier
        objs = timed("allgather_object", lambda: hvd.allgather_object(
            {"rank": rank, "pad": "x" * (1000 * rank)}))
        check("allgather_object", objs == [{"rank": r, "pad": "x" * (1000 * r)}
                                           for r in range(n)])
        timed("barrier", hvd.barrier)
        check("barrier", True)
        # A process set {0, 2}: allreduce and Adasum over it.
        pair = hvd.add_process_set([0, 2])
        if pair.included():
            px = [_host_rows(r, rows, width, 9) for r in (0, 2)]
            got = timed("set allreduce", lambda: hvd.allreduce(
                px[pair.rank()].to(dev), op=hvd.Sum, process_set=pair))
            err = rel_err(got.double().cpu(), px[0].double()
                          + px[1].double())
            check("set allreduce", err <= TOL_SUM, err)
            from horovod_tpu_torch.ops.adasum import adasum_reference
            # Two members: one halving level, one rounding to the dtype
            # (phase 8's tolerance).
            for case, dtype in ((99, torch.float16), (98, torch.float32)):
                name = f"set adasum {str(dtype)[6:]}"
                ax = [coll_contribution(device, sizes["pair_adasum"],
                                        dtype, case, r).double().cpu()
                      .numpy().reshape(-1) for r in (0, 2)]
                x = coll_contribution(device, sizes["pair_adasum"], dtype,
                                      case, rank)
                ak.launches_partials = ak.launches_scaled_add = 0
                got = timed(name, lambda: hvd.allreduce(
                    x, op=hvd.Adasum, process_set=pair))
                launches = (ak.launches_partials, ak.launches_scaled_add)
                ref = adasum_reference(ax)
                err = _norm_rel(got.double().cpu().numpy().reshape(-1), ref)
                gaps = adasum_gaps(ax, ref)
                check(name, err <= TOL_COMBINE[dtype] and min(gaps.values())
                      > COLL_SEPARATION * TOL_COMBINE[dtype], err)
                cases[name].update(launches=launches, digest=_digest(got),
                                   limit=TOL_COMBINE[dtype], **gaps)
                del ax, x, got, ref
        else:
            try:
                hvd.allreduce(torch.ones(2, device=dev), process_set=pair)
                refused = False
            except ValueError:
                refused = True
            cases["set refuses a non-member"] = {"ok": refused}
        hvd.barrier()
        payload = {"rank": rank, "backend": hvd.backend(), "adasum": adasum,
                   "cases": cases}
        status = "ok"
        hvd.shutdown()
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        payload = traceback.format_exc()
    finally:
        results.put((rank, status, payload))


def phase_collectives(device="cuda:0", sizes=None, timeout=900.0):
    sizes = sizes or COLL_SIZES
    ranks = spawn_ranks(coll_rank_main, COLL_RANKS, (device, sizes),
                        timeout, "phase 10")
    from horovod_tpu_torch.ops import adasum as adasum_mod
    cuda = device.startswith("cuda")
    problems = []
    if any(r["backend"] != "gloo" for r in ranks):
        problems.append("the three ranks on one card are not on gloo")
    # Blocks of 2 and 1: ranks 0 and 1 run one halving level and the
    # merge, rank 2 the merge alone.
    want_launches = [(2, 2), (2, 2), (1, 1)] if cuda else [(0, 0)] * 3
    for i, res in enumerate(ranks[0]["adasum"]):
        dtype = getattr(torch, res["dtype"])
        contributions = [coll_contribution(device, tuple(res["shape"]),
                                           dtype, res["case"], r)
                         for r in range(COLL_RANKS)]
        contributions = [c.double().cpu().numpy().reshape(-1)
                         for c in contributions]
        ref = adasum_mod.adasum_reference(contributions)
        got = torch.from_numpy(res.pop("bits")).view(dtype)
        res["rel_err"] = _norm_rel(got.double().numpy().reshape(-1), ref)
        res["limit"] = TOL_FOLD3[dtype]
        res.update(adasum_gaps(contributions, ref))
        res["ms_per_rank"] = [r["adasum"][i]["ms"] for r in ranks]
        res["launches_per_rank"] = [r["adasum"][i]["launches"]
                                    for r in ranks]
        log("phase 10: " + json.dumps({k: v for k, v in res.items()
                                       if k != "digest"}))
        if len({r["adasum"][i]["digest"] for r in ranks}) != 1:
            problems.append(f"adasum case {i}: ranks differ")
        if [tuple(x) for x in res["launches_per_rank"]] != want_launches:
            problems.append(f"adasum case {i}: launches "
                            f"{res['launches_per_rank']}, want "
                            f"{want_launches}")
        if res["rel_err"] > TOL_FOLD3[dtype]:
            problems.append(f"adasum case {i}: error {res['rel_err']} "
                            f"against the float64 reference")
        gap = min(res["plain_sum_gap"], res["unprojected_merge_gap"])
        if gap <= COLL_SEPARATION * TOL_FOLD3[dtype]:
            problems.append(f"adasum case {i}: a wrong combine lands "
                            f"{gap} from the reference, too close to "
                            f"tell at {TOL_FOLD3[dtype]}")
        del contributions, ref, got
    for r in ranks:
        log(f"phase 10: rank {r['rank']} " + json.dumps(
            {k: {kk: vv for kk, vv in v.items() if kk != "digest"}
             for k, v in r["cases"].items()}))
        for name, case in r["cases"].items():
            if not case["ok"]:
                problems.append(f"rank {r['rank']}: {name} {case}")
    want = (1, 1) if cuda else (0, 0)
    for name in ("set adasum float16", "set adasum float32"):
        pair = [ranks[0]["cases"][name], ranks[2]["cases"][name]]
        if pair[0]["digest"] != pair[1]["digest"]:
            problems.append(f"{name}: ranks 0 and 2 differ")
        if any(tuple(c["launches"]) != want for c in pair):
            problems.append(f"{name}: launches "
                            f"{[c['launches'] for c in pair]}, want {want}")
    if problems:
        raise AssertionError("phase 10: " + "; ".join(problems))
    return ranks


# Phase 11: the data-parallel train step (parallel/train.py) on the card.
DPS_WORLD1_BATCH = 2
DPS_WORLD1_STEPS = 2
DPS_STEPS = 3
# The plan of the flagship at Llama-2-7B width, 2 layers, the default
# 64 MiB threshold: leaf indices (registration order) and bytes per
# bucket, last-produced first.
DPS_PLAN = ("19:90177536;18:90177536;17:90177536;16,15:67108864;"
            "14,13:67108864;12,11:32768;10:90177536;9:90177536;"
            "8:90177536;7,6:67108864;5,4:67108864;3,2,1:49152;"
            "0:262144000")
# An fp16 wire against the uncompressed step's reduced gradients, the
# Frobenius norm of the error over that of the gradient per tensor: a
# bf16 gradient is exact in fp16 at or above 2^-14 (fp16's smallest
# normal), so the sum's fp16 rounding before the bf16 one and the
# absolute 6e-8 that fp16 keeps below 2^-14 move it, by about one bf16
# rounding (2^-8; 6.3e-4 at the flagship, PERF.md); a float32 one rounds
# to fp16 on each rank and in the sum, three roundings of 2^-11.
TOL_FP16_WIRE = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -9}


def dps_batch(cfg, seq, rank, step, batch=1, scale=1.0):
    """Rank ``rank``'s own batch of ``step`` on the host, with the loss
    scale the guard check sets to NaN."""
    tokens = np.random.RandomState(1000 * step + rank).randint(
        0, cfg.vocab, (batch, seq)).astype(np.int64)
    return {"tokens": torch.from_numpy(tokens),
            "targets": torch.from_numpy(np.roll(tokens, -1, axis=1)),
            "scale": torch.tensor(scale, dtype=torch.float32)}


def dps_world1_main(rank, port, results, device, cfg_kw, seq, steps):
    """Phase 11's world of one, in a spawned process: the port adopts a
    one-rank group (NCCL on the card), and ``DPS_WORLD1_STEPS`` steps
    with ``mesh=data_parallel_mesh()`` against the same steps without a
    mesh, from the same weights."""
    import torch.distributed as dist
    status, payload = "error", None
    cuda = device.startswith("cuda")
    try:
        if cuda:
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
        sys.path.insert(0, REPO)
        torch.backends.cuda.matmul.allow_tf32 = False
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.models import transformer as tfm
        from horovod_tpu_torch.parallel import mesh as mesh_mod
        from horovod_tpu_torch.parallel import train
        hvd.init()
        cfg = tfm.TransformerConfig(**cfg_kw, dtype=torch.bfloat16)
        runs = {}
        for name, mesh in (("mesh", mesh_mod.data_parallel_mesh()),
                           ("no mesh", None)):
            model = tfm.init_params(cfg, seed=0, device=device)
            step = train.build_train_step(
                lambda m, b: tfm.loss_fn(cfg, m, b),
                train.adamw(model.parameters(), LR), device, mesh=mesh,
                overlap=True)
            losses, times = [], []
            for s in range(steps):
                batch = dps_batch(cfg, seq, 0, s, DPS_WORLD1_BATCH)
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.monotonic()
                losses.append(float(step(model, batch)["loss"]))
                times.append(1e3 * (time.monotonic() - t0))
            runs[name] = {"losses": losses, "step_ms": times,
                          "buckets": train.last_overlap_info()["buckets"],
                          "digest": _params_digest(model),
                          "mesh_shape": None if mesh is None
                          else mesh.shape}
            del model, step
            if cuda:
                torch.cuda.empty_cache()
        payload = {"backend": hvd.backend(), "runs": runs}
        status = "ok"
        hvd.shutdown()
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        payload = traceback.format_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        results.put((rank, status, payload))


class _StepClock:
    """Host-clock stamps of one data-parallel step, from hooks a user
    could add, with no change to the step: a post-accumulate-grad hook
    on the tied embedding, the last parameter the backward finishes
    (registered before the step registers its own, so it fires first),
    stamps the backward's end; the optimizer's step pre- and post-hooks
    bracket AdamW. Each stamp synchronises the card first. Under gloo
    with card tensors that moves no work: right after the first stamp
    the last bucket's launch copies it to the host, which waits for the
    card, and before AdamW the guard's finite check waits for it too."""

    def __init__(self, cuda, model):
        self.cuda = cuda
        self.reset()
        model.embed.register_post_accumulate_grad_hook(
            lambda _p: self._stamp("backward_end"))

    def watch(self, optimizer):
        optimizer.register_step_pre_hook(
            lambda *_: self._stamp("adamw_start"))
        optimizer.register_step_post_hook(
            lambda *_: self._stamp("adamw_end"))

    def reset(self):
        self.t = {}

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _stamp(self, name):
        self.sync()
        self.t[name] = time.monotonic()

    def parts(self, t0, events):
        """The step's parts in ms from its start ``t0`` and the probe's
        (ns, bucket, phase, bytes) events."""
        t = self.t
        last_reduced = max((e[0] for e in events if e[2] == "reduced"),
                           default=None)
        return {
            "forward_backward_ms": 1e3 * (t["backward_end"] - t0),
            "exchange_after_backward_ms":
                1e3 * (t["adamw_start"] - t["backward_end"]),
            "bucket_waits_ms": None if last_reduced is None else max(
                0.0, 1e-6 * last_reduced - 1e3 * t["backward_end"]),
            "adamw_ms": 1e3 * (t["adamw_end"] - t["adamw_start"])}


def _overlap_of(events, n_buckets, backward_end):
    """Per step from the probe's (ns, bucket, phase, bytes) events: the
    ready order, the buckets reduced, whether each reduced after its
    ready, the share of bucket time [ready, reduced] before the
    backward's end, and that share for the last bucket."""
    ready = {b: t for t, b, ph, _ in events if ph == "ready"}
    reduced = {b: t for t, b, ph, _ in events if ph == "reduced"}
    end_ns = int(backward_end * 1e9)
    spans = {b: (ready[b], reduced[b]) for b in ready if b in reduced}
    hidden = {b: max(0, min(r1, end_ns) - r0) for b, (r0, r1)
              in spans.items()}
    total = sum(r1 - r0 for r0, r1 in spans.values())
    last = n_buckets - 1
    return {
        "ready_order": [b for _, b, ph, _ in events if ph == "ready"],
        "reduced_order": [b for _, b, ph, _ in events if ph == "reduced"],
        "reduced_after_ready": all(r1 >= r0 for r0, r1 in spans.values()),
        "n_ready": len([e for e in events if e[2] == "ready"]),
        "n_reduced": len([e for e in events if e[2] == "reduced"]),
        "hidden_share": (sum(hidden.values()) / total) if total else None,
        "last_bucket_hidden": (hidden[last] / max(1, spans[last][1]
                                                  - spans[last][0]))
        if last in spans else None,
        "last_bucket_ms_after_backward": (
            1e-6 * max(0, spans[last][1] - end_ns)) if last in spans
        else None}


def _state_digest(model, optimizer):
    """sha256 of the parameters and the AdamW state (step, moments)."""
    import hashlib
    h = hashlib.sha256(_params_digest(model).encode())
    for p in model.parameters():
        for key, t in sorted(optimizer.state.get(p, {}).items()):
            h.update(key.encode())
            h.update(t.detach().reshape(-1).contiguous()
                     .view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def _flip_one_bit(t):
    """One flipped bit in the middle of ``t``'s bytes, in place (a
    simulated silent data corruption)."""
    with torch.no_grad():
        raw = t.view(-1).view(torch.uint8)
        raw[raw.numel() // 2] ^= 0x10


def dps_rank_main(rank, port, results, device, cfg_kw, seq, steps):
    """One rank of phase 11's two-rank world, in a spawned process: the
    guarded, bucketed step (HOROVOD_NUMERICS_GUARD=1, overlap on, the
    default 64 MiB threshold) for ``steps`` steps, timed in parts, then
    the divergence check, the guard's coordinated skip, a flipped bit,
    and from the saved start the overlap-off step and the fp16 wire."""
    status, payload = "error", None
    cuda = device.startswith("cuda")
    try:
        hvd = _join_world(rank, DP_RANKS, port, device,
                          {"HOROVOD_NUMERICS_GUARD": "1"})
        from horovod_tpu_torch import numerics, tracing
        from horovod_tpu_torch.models import transformer as tfm
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.parallel import mesh as mesh_mod
        from horovod_tpu_torch.parallel import train
        cfg = tfm.TransformerConfig(**cfg_kw, dtype=torch.bfloat16)
        model = tfm.init_params(cfg, seed=rank, device=device)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        mesh = mesh_mod.data_parallel_mesh()

        def loss(m, b):
            return tfm.loss_fn(cfg, m, b) * b["scale"]

        def fresh(**kw):
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(start[n])
            opt = numerics.guard_non_finite(
                train.adamw(model.parameters(), LR))
            return opt, train.build_train_step(loss, opt, device, mesh=mesh,
                                               **kw)

        probe = tracing.OverlapProbe()
        probe.armed = True
        clock = _StepClock(cuda, model)
        opt, step = fresh(overlap=True, overlap_probe=probe)
        clock.watch(opt)
        reset_counts(fa)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        steps_out, digests, grads0 = [], [], None
        for s in range(steps):
            clock.reset()
            with probe._lock:
                probe.events.clear()
            clock.sync()
            t0 = time.monotonic()
            metrics = step(model, dps_batch(cfg, seq, rank, s))
            clock.sync()
            t1 = time.monotonic()
            with probe._lock:
                events = list(probe.events)
            info = train.last_overlap_info()
            steps_out.append({
                "loss": float(metrics["loss"]),
                **clock.parts(t0, events),
                "step_ms": 1e3 * (t1 - t0),
                **_overlap_of(events, info["buckets"],
                              clock.t["backward_end"])})
            digests.append(_params_digest(model))
            if s == 0:
                grads0 = {n: p.grad.detach().clone()
                          for n, p in model.named_parameters()}
        launches = launch_counts(fa)
        peak = torch.cuda.max_memory_allocated() if cuda else None
        # One probe event of each phase per wire group, in plan order.
        wire = train.plan_overlap(model, mesh, guard=True).wire
        events_per_step = [b for b, groups in enumerate(wire)
                           for _ in groups]
        numerics.check_replica_divergence(model)       # agreement passes
        out = {"rank": rank, "backend": hvd.backend(), "plan": info,
               "steps": steps_out, "digests": digests,
               "events_per_step": events_per_step,
               "launches": launches, "max_memory_allocated": peak,
               "divergence_check_passed": True,
               "n_parameters": sum(p.numel() for p in model.parameters())}
        # The guard: rank 1's loss is NaN for one step, then a clean one.
        before = _state_digest(model, opt)
        metrics = step(model, dps_batch(cfg, seq, rank, steps,
                                        scale=float("nan") if rank == 1
                                        else 1.0))
        out["guard"] = {"loss": float(metrics["loss"]),
                        "kept_state": _state_digest(model, opt) == before,
                        "consecutive_skips": numerics.consecutive_skips(opt)}
        metrics = step(model, dps_batch(cfg, seq, rank, steps + 1))
        out["guard"].update(
            next_loss=float(metrics["loss"]),
            next_applied=_state_digest(model, opt) != before,
            next_consecutive_skips=numerics.consecutive_skips(opt),
            total_skips=opt.total_skips, digest=_params_digest(model))
        # A flipped bit on rank 1.
        if rank == 1:
            _flip_one_bit(model.layers[0].w_down)
        try:
            numerics.check_replica_divergence(model)
            out["divergence"] = {"raised": None}
        except hvd.ReplicaDivergenceError as e:
            out["divergence"] = {"raised": type(e).__name__,
                                 "ranks": list(e.divergent_ranks),
                                 "text": str(e)}
        # From the saved start: overlap off, then the fp16 wire.
        opt, step = fresh(overlap=False)
        clock.reset()
        clock.sync()
        t0 = time.monotonic()
        step(model, dps_batch(cfg, seq, rank, 0))
        off_ms = 1e3 * (clock.t["backward_end"] - t0)
        out["overlap_off_digest"] = _params_digest(model)
        out["overlap_off_forward_backward_ms"] = off_ms
        for st in steps_out:
            st["exchange_in_backward_ms"] = st["forward_backward_ms"] - off_ms
        opt, step = fresh(overlap=True, compression="fp16")
        step(model, dps_batch(cfg, seq, rank, 0))
        info = train.last_overlap_info()
        errs = {n: rel_err(p.grad, grads0[n])
                for n, p in model.named_parameters()}
        out["fp16"] = {
            "digest": info["digest"],
            "raw_bucket_bytes": info["raw_bucket_bytes"],
            "wire_bucket_bytes": info["wire_bucket_bytes"],
            "rel_err": errs,
            "within": all(errs[n] <= TOL_FP16_WIRE[p.dtype]
                          for n, p in model.named_parameters()),
            "moved": max(errs.values()) > 0}
        payload = out
        status = "ok"
        hvd.shutdown()
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        payload = traceback.format_exc()
    finally:
        results.put((rank, status, payload))


def phase_dp_step(device="cuda:0", cfg_kw=None, seq=SEQ, timeout=900.0,
                  plan=DPS_PLAN, layers=DP_LAYERS):
    """Phase 11: the world of one on NCCL, then two ranks sharing the
    card on gloo; returns both."""
    cfg_kw = cfg_kw or dict(LLAMA2_7B, n_layers=layers)
    cuda = device.startswith("cuda")
    problems = []
    (w1,) = spawn_ranks(dps_world1_main, 1,
                        (device, cfg_kw, seq, DPS_WORLD1_STEPS), timeout,
                        "phase 11 world 1")
    log("phase 11 world 1: " + json.dumps(w1))
    if w1["backend"] != ("nccl" if cuda else "gloo"):
        problems.append(f"world 1: backend {w1['backend']}")
    if w1["runs"]["mesh"]["buckets"] != 0:
        problems.append("world 1: buckets in a world of one")
    if w1["runs"]["mesh"]["digest"] != w1["runs"]["no mesh"]["digest"]:
        problems.append("world 1: the mesh changed the parameters")
    ranks = spawn_ranks(dps_rank_main, DP_RANKS,
                        (device, cfg_kw, seq, DPS_STEPS), timeout,
                        "phase 11")
    for r in ranks:
        log("phase 11: " + json.dumps(
            {k: v for k, v in r.items() if k not in ("fp16", "plan")}))
        log(f"phase 11: rank {r['rank']} plan " + json.dumps(r["plan"]))
        log(f"phase 11: rank {r['rank']} fp16 wire " + json.dumps(r["fp16"]))
    n_buckets = len(plan.split(";"))
    if plan == DPS_PLAN and ranks[0]["events_per_step"] != list(
            range(n_buckets)):
        problems.append("the flagship's buckets are not one wire group each")
    if any(r["backend"] != "gloo" for r in ranks):
        problems.append("the two ranks on one card are not on gloo")
    for r in ranks:
        tag = f"rank {r['rank']}"
        if r["plan"]["digest"] != plan or r["plan"]["buckets"] != n_buckets:
            problems.append(f"{tag}: plan {r['plan']['digest']}")
        for s, st in enumerate(r["steps"]):
            if not np.isfinite(st["loss"]):
                problems.append(f"{tag}: step {s} loss {st['loss']}")
            if st["ready_order"] != r["events_per_step"] or sorted(
                    st["reduced_order"]) != r["events_per_step"] or \
                    not st["reduced_after_ready"]:
                problems.append(f"{tag}: step {s} probe events "
                                f"{st['ready_order']} {st['reduced_order']}")
        want = layers * DPS_STEPS if cuda else 0
        if r["launches"] != {"fwd": want, "dkv": want, "dq": want}:
            problems.append(f"{tag}: K3 launches {r['launches']}, want "
                            f"{want} each")
        g = r["guard"]
        if not (g["kept_state"] and g["consecutive_skips"] == 1
                and np.isnan(g["loss"]) and g["next_applied"]
                and g["next_consecutive_skips"] == 0
                and g["total_skips"] == 1 and np.isfinite(g["next_loss"])):
            problems.append(f"{tag}: guard {g}")
        d = r["divergence"]
        if not (d["raised"] == "ReplicaDivergenceError" and d["ranks"] == [1]
                and "AMBIGUOUS" in d["text"]):
            problems.append(f"{tag}: divergence check {d}")
        if r["overlap_off_digest"] != r["digests"][0]:
            problems.append(f"{tag}: overlap off differs from the bucketed "
                            f"step 0")
        if not (r["fp16"]["within"] and r["fp16"]["moved"]):
            problems.append(f"{tag}: fp16 wire {r['fp16']['rel_err']}")
    for s in range(DPS_STEPS):
        if len({r["digests"][s] for r in ranks}) != 1:
            problems.append(f"parameters differ across ranks after step {s}")
        if len({r["steps"][s]["loss"] for r in ranks}) != 1:
            problems.append(f"losses differ across ranks at step {s}")
    if len({r["guard"]["digest"] for r in ranks}) != 1:
        problems.append("parameters differ across ranks after the guard")
    if problems:
        raise AssertionError("phase 11: " + "; ".join(problems))
    return {"world1": w1, "ranks": ranks}


# Phase 12: the negotiated engine (ops/controller.py, core/cc) on the card.
NEG_RANKS = 2
NEG_OOO = {"names": 8, "shape": (4096, 11008), "inline_shape": (4096,)}
NEG_STEPS = 3
NEG_JOIN_STEPS = 2       # rank 1 joins after these; rank 0 runs one more
NEG_ADASUM = {"shape": (4096, 11008), "cases": (200, 201),
              # room for both fp16 gradients (86 MiB each) in one agreed
              # batch, and the cut held until the ready set has not
              # grown for 100 cycles, so they are usually agreed
              # together; the gates hold for one batch or two (each
              # entry is its own Adasum vector either way)
              "threshold": 256 << 20, "quiescence": 100}
NEG_SIDE_TENSORS = 16


def neg_values(i, rank, shape):
    """Name ``i``'s contribution on ``rank``: integers in [-8, 8], a
    different pattern per name and rank, so every sum of two is exact
    in bf16 and its host answer is exact."""
    n = int(np.prod(shape))
    x = torch.arange(n, dtype=torch.int64)
    return ((x * (2 * i + 1) + 7 * rank + 3 * i) % 17 - 8).to(
        torch.bfloat16).view(shape)


def _neg_out_of_order(hvd, rank, device, shape, prefix):
    """Every rank submits the same named allreduces (Sum); rank 1 in
    reverse order. Per name: the largest distance from the host answer,
    and the seconds from the first submission to the last result."""
    names = [f"{prefix}{i}" for i in range(NEG_OOO["names"])]
    xs = {nm: neg_values(i, rank, shape).to(device)
          for i, nm in enumerate(names)}
    order = names[::-1] if rank == 1 else names
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    t0 = time.monotonic()
    hs = {nm: hvd.allreduce_async(xs[nm], name=nm, op=hvd.Sum)
          for nm in order}
    outs = {nm: hvd.synchronize(hs[nm]).cpu() for nm in names}
    seconds = time.monotonic() - t0
    dist = {}
    for i, nm in enumerate(names):
        want = sum(neg_values(i, r, shape).float() for r in range(NEG_RANKS))
        dist[nm] = float((outs[nm].float() - want).abs().max())
    return {"distance": dist, "s": seconds}


class _HistDelta:
    """Count and sum of a process-wide histogram since construction."""

    def __init__(self, metrics, name):
        self.metrics, self.name = metrics, name
        self.count, self.sum = self._now()

    def _now(self):
        series = self.metrics.snapshot().get(self.name, {}).get(())
        return (series["count"], series["sum"]) if series else (0, 0.0)

    def take(self):
        count, total = self._now()
        out = (count - self.count, total - self.sum)
        self.count, self.sum = count, total
        return out


def _neg_optimizer_steps(hvd, rank, device, cfg, seq, steps,
                         capture=None):
    """DistributedOptimizer(adamw(LR), Average) from seed 0's weights,
    each rank on its own batch; per step the loss, host-clock parts,
    agreed batches and the digest. ``capture(step)`` -> True makes the
    step keep each local gradient as it was submitted."""
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.common.basics import state
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel import train
    cuda = device.startswith("cuda")
    model = tfm.init_params(cfg, seed=0, device=device)
    start = _params_digest(model)
    local = {}
    armed = [False]
    for p in model.parameters():       # before the optimizer's own hooks
        p.register_post_accumulate_grad_hook(
            lambda p: local.__setitem__(id(p), p.grad.detach().clone())
            if armed[0] else None)
    opt = hvd.DistributedOptimizer(
        train.adamw(model.parameters(), LR),
        named_parameters=model.named_parameters())
    ctl = state().engine.controller
    hist = {k: _HistDelta(metrics, f"hvd_{k}") for k in (
        "fusion_batch_entries", "negotiation_latency_seconds",
        "dispatch_latency_seconds")}
    out = []
    for s in range(steps):
        armed[0] = bool(capture and capture(s))
        local.clear()
        ar = list(ctl.exec_counts.get("ar", [0, 0])) if ctl else None
        for h in hist.values():
            h.take()
        batch = {k: v.to(device) for k, v in
                 dps_batch(cfg, seq, rank, s).items() if k != "scale"}
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        opt.zero_grad()
        loss = tfm.loss_fn(cfg, model, batch)
        loss.backward()
        t1 = time.monotonic()
        opt.synchronize()
        t2 = time.monotonic()
        with opt.skip_synchronize():
            opt.step()
        if cuda:
            torch.cuda.synchronize()
        t3 = time.monotonic()
        st = {"loss": float(loss.detach()), "step_ms": 1e3 * (t3 - t0),
              "backward_returned_ms": 1e3 * (t1 - t0),
              "wait_after_backward_ms": 1e3 * (t2 - t1),
              "adamw_ms": 1e3 * (t3 - t2),
              # host time of the agreed batches (negotiated) or the ops
              # (inline): packing, host staging, gloo, the copy back
              "dispatch_ms":
              1e3 * hist["dispatch_latency_seconds"].take()[1],
              "peak_bytes": torch.cuda.max_memory_allocated()
              if cuda else None}
        if ctl is not None:
            now = ctl.exec_counts.get("ar", [0, 0])
            st["batches"], st["entries"] = now[0] - ar[0], now[1] - ar[1]
            n, total = hist["fusion_batch_entries"].take()
            st["entries_per_batch"] = total / n if n else None
            n, total = hist["negotiation_latency_seconds"].take()
            st["negotiation_ms_mean"] = 1e3 * total / n if n else None
        if armed[0]:
            st["local_bitwise"] = all(
                torch.equal(p.grad, local[id(p)]) for p in model.parameters())
        st["digest"] = _params_digest(model)
        out.append(st)
    return model, opt, {"start": start, "steps": out}


def neg_rank_main(rank, port, results, device, cfg_kw, seq, sizes):
    """One rank of phase 12, in a spawned process: a gloo group the
    process makes itself and the port adopts, HOROVOD_CONTROLLER left
    at "auto" (the C++ core; rank 0's control port reaches rank 1
    through the adopted group), HOROVOD_ORDER_CHECK=1. (a) out-of-order
    submission, (b) DistributedOptimizer steps, (d) Adasum through the
    engine, (e) a shape mismatch and the order check, (c) join (last:
    once a rank has joined, the coordinator refuses every op but
    allreduce, the order check's gather included); then,
    with HOROVOD_CONTROLLER=inline, (a) at ``inline_shape`` and (b)
    from the same start."""
    import datetime
    import torch.distributed as dist
    status, payload = "error", None
    cuda = device.startswith("cuda")
    try:
        if cuda:
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=NEG_RANKS,
                                timeout=datetime.timedelta(seconds=300))
        sys.path.insert(0, REPO)
        torch.backends.cuda.matmul.allow_tf32 = False
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.common.basics import state
        from horovod_tpu_torch.models import transformer as tfm
        from horovod_tpu_torch.ops import adasum as adasum_mod
        from horovod_tpu_torch.ops import adasum_kernels as ak
        from horovod_tpu_torch.ops import flash_attention as fa
        t0 = time.monotonic()
        hvd.init(config_overrides={"HOROVOD_ORDER_CHECK": True})
        ctl = state().engine.controller
        out = {"rank": rank, "backend": hvd.backend(),
               "core": type(ctl.core).__name__,
               "init_s": time.monotonic() - t0}
        cfg = tfm.TransformerConfig(**cfg_kw, dtype=torch.bfloat16)
        # (a) out of order, negotiated
        out["ooo"] = _neg_out_of_order(hvd, rank, device, sizes["ooo_shape"],
                                       "ooo_")
        # (b) DistributedOptimizer, negotiated
        reset_counts(fa)
        model, opt, run = _neg_optimizer_steps(hvd, rank, device, cfg, seq,
                                               NEG_STEPS)
        run["launches"] = launch_counts(fa)
        out["optimizer"] = run
        del model, opt
        # (d) Adasum: two fp16 FFN-sized gradients, one agreed batch or two
        dev = torch.device(device)
        ctl.core.set_fusion_threshold(NEG_ADASUM["threshold"])
        ctl.core.set_quiescence(NEG_ADASUM["quiescence"])
        xs = [coll_contribution(device, sizes["adasum_shape"], torch.float16,
                                case, rank) for case in NEG_ADASUM["cases"]]
        ar = list(ctl.exec_counts.get("ar", [0, 0]))
        ak.launches_partials = ak.launches_scaled_add = 0
        if cuda:
            torch.cuda.synchronize()
        t0 = time.monotonic()
        hs = [hvd.allreduce_async(x, op=hvd.Adasum, name=f"adasum_{k}")
              for k, x in enumerate(xs)]
        got = [hvd.synchronize(h) for h in hs]
        if cuda:
            torch.cuda.synchronize()
        adasum = {"s": time.monotonic() - t0,
                  "launches": (ak.launches_partials, ak.launches_scaled_add),
                  "batches": ctl.exec_counts["ar"][0] - ar[0],
                  "entries": ctl.exec_counts["ar"][1] - ar[1],
                  "digests": [_digest(g) for g in got]}
        ctl.core.set_fusion_threshold(ctl.cfg.fusion_threshold)
        ctl.core.set_quiescence(0)
        if rank == 0:
            errs = []
            for case, g in zip(NEG_ADASUM["cases"], got):
                rows = [coll_contribution(device, sizes["adasum_shape"],
                                          torch.float16, case, r)
                        .double().cpu().numpy().reshape(-1)
                        for r in range(NEG_RANKS)]
                errs.append(_norm_rel(g.double().cpu().numpy().reshape(-1),
                                      adasum_mod.adasum_reference(rows)))
                del rows
            adasum["rel_err"] = errs
        out["adasum"] = adasum
        del xs, got
        # (e) a shape mismatch errors every rank; the next op works; the
        # order check over everything so far.
        try:
            hvd.allreduce(torch.ones(2 + rank, device=dev), name="mismatch",
                          op=hvd.Sum)
            out["mismatch"] = "no error"
        except RuntimeError as e:
            out["mismatch"] = str(e)
        out["after_mismatch"] = hvd.allreduce(
            torch.ones(3, device=dev), name="after_mismatch",
            op=hvd.Sum).tolist()
        out["order_count"] = hvd.check_execution_order()
        # (c) join: rank 1 stops after NEG_JOIN_STEPS; rank 0 runs one
        # more step with a joined peer, then a broadcast.
        steps = NEG_JOIN_STEPS + (1 if rank == 0 else 0)
        model, opt, run = _neg_optimizer_steps(
            hvd, rank, device, cfg, seq, steps,
            capture=lambda s: s == NEG_JOIN_STEPS)
        join = {"steps": run["steps"]}
        if rank == 0:
            try:
                hvd.broadcast(torch.ones(2, device=dev), root_rank=0,
                              name="join_bcast")
                join["broadcast"] = "no error"
            except RuntimeError as e:
                join["broadcast"] = str(e)
        join["returned"] = hvd.join()
        out["join"] = join
        del model, opt
        # Inline from here, in the same group.
        hvd.shutdown()
        hvd.init(config_overrides={"HOROVOD_CONTROLLER": "inline"})
        out["inline_controller"] = state().engine.controller is not None
        out["ooo_inline"] = _neg_out_of_order(
            hvd, rank, device, sizes["inline_shape"], "ooo_inline_")
        model, opt, run = _neg_optimizer_steps(hvd, rank, device, cfg, seq,
                                               NEG_STEPS)
        out["optimizer_inline"] = run
        del model, opt
        payload = out
        status = "ok"
        hvd.shutdown()
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        payload = traceback.format_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        results.put((rank, status, payload))


def neg_world1_main(rank, port, results, device, n_tensors):
    """Phase 12 (f), in a spawned process: a world of one adopting a
    one-rank NCCL group (gloo on the CPU), HOROVOD_CONTROLLER=native
    (the C++ core, no sockets). A grouped allreduce of ``n_tensors``
    tensors that a side stream is still producing when they are
    submitted, against the inline path on the same tensors: bitwise.
    The dispatch thread must wait for the side stream's work before it
    packs, and the side stream for the dispatch thread's before it
    reads the results."""
    import torch.distributed as dist
    status, payload = "error", None
    cuda = device.startswith("cuda")
    try:
        if cuda:
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
        sys.path.insert(0, REPO)
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.common.basics import state
        dev = torch.device(device)
        side = torch.cuda.Stream(dev) if cuda else None
        n = 4096 if cuda else 64
        gen = torch.Generator(device=dev).manual_seed(7)
        a = torch.randn(n, n, device=dev, generator=gen,
                        dtype=torch.bfloat16)

        def produce():
            # Long matmul chains on the side stream: the tensors are
            # still being written when the host submits them.
            ts, x = [], a
            for k in range(n_tensors):
                for _ in range(4):
                    x = torch.tanh(x @ a) if cuda else x
                ts.append(x[k:k + 64 + 32 * k].float().clone())
            return ts

        runs = {}
        for mode in ("native", "inline"):
            hvd.init(config_overrides={"HOROVOD_CONTROLLER": mode})
            ctl = state().engine.controller
            with torch.cuda.stream(side) if cuda else \
                    contextlib.nullcontext():
                ts = produce()
                got = hvd.grouped_allreduce(ts, op=hvd.Sum)
                # Read on the side stream, after synchronize.
                digest = _digest(torch.cat([g.reshape(-1) for g in got]))
                same_as_input = all(torch.equal(g, t)
                                    for g, t in zip(got, ts))
            runs[mode] = {"core": type(ctl.core).__name__ if ctl else None,
                          "digest": digest, "equal_inputs": same_as_input,
                          "batches": dict(ctl.exec_counts) if ctl else None}
            hvd.shutdown()
        payload = {"backend": str(dist.get_backend()), "runs": runs}
        status = "ok"
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        payload = traceback.format_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        results.put((rank, status, payload))


NEG_SIZES = {"ooo_shape": NEG_OOO["shape"],
             "inline_shape": NEG_OOO["inline_shape"],
             "adasum_shape": NEG_ADASUM["shape"]}


def phase_negotiated(device="cuda:0", cfg_kw=None, seq=SEQ, sizes=None,
                     timeout=900.0):
    """Phase 12: the negotiated engine, two gloo ranks sharing the
    card, then (f) the world of one on NCCL."""
    cfg_kw = cfg_kw or dict(LLAMA2_7B, n_layers=DP_LAYERS)
    sizes = sizes or NEG_SIZES
    cuda = device.startswith("cuda")
    t0 = time.monotonic()
    ranks = spawn_ranks(neg_rank_main, NEG_RANKS,
                        (device, cfg_kw, seq, sizes), timeout, "phase 12")
    for r in ranks:
        log("phase 12: " + json.dumps(r))
    problems = []
    neg = {"limit": 0.0}
    for r in ranks:
        tag = f"rank {r['rank']}"
        if r["backend"] != "gloo" or r["core"] != "NativeCore":
            problems.append(f"{tag}: {r['backend']}, {r['core']}")
        # (a)
        worst = max(r["ooo"]["distance"].values())
        inline = max(r["ooo_inline"]["distance"].values())
        neg[tag] = {"negotiated_distance": worst, "inline_distance": inline}
        if worst != 0.0:
            problems.append(f"{tag}: out of order, distance {worst}")
        if inline <= 0.0 or r["inline_controller"]:
            problems.append(f"{tag}: the inline run gave the host answers "
                            "(the out-of-order check cannot fail)")
        # (b)
        n_steps = [r["optimizer"]["steps"], r["optimizer_inline"]["steps"]]
        for run in n_steps:
            if not all(np.isfinite(s["loss"]) for s in run):
                problems.append(f"{tag}: a loss is not finite")
        if r["optimizer"]["start"] != r["optimizer_inline"]["start"]:
            problems.append(f"{tag}: the runs started from other weights")
        for s, (a, b) in enumerate(zip(*n_steps)):
            if a["digest"] != b["digest"]:
                problems.append(f"{tag}: step {s} negotiated differs from "
                                "inline")
        want = DP_LAYERS * NEG_STEPS if cuda else 0
        if r["optimizer"]["launches"] != {"fwd": want, "dkv": want,
                                          "dq": want}:
            problems.append(f"{tag}: K3 launches "
                            f"{r['optimizer']['launches']}, want {want}")
        # (c)
        j = r["join"]
        if j["returned"] != 0:
            problems.append(f"{tag}: join returned {j['returned']}")
        # (d)
        a = r["adasum"]
        want = (2, 2) if cuda else (0, 0)
        if tuple(a["launches"]) != want or a["entries"] != 2 or \
                a["batches"] not in (1, 2):
            problems.append(f"{tag}: Adasum launches {a['launches']} "
                            f"(want {want}), {a['batches']} batch(es) of "
                            f"{a['entries']}")
        # (e)
        if "mismatch" not in r["mismatch"].lower() or \
                r["after_mismatch"] != [2.0] * 3:
            problems.append(f"{tag}: mismatch {r['mismatch']!r}, then "
                            f"{r['after_mismatch']}")
    log("phase 12 (a): " + json.dumps(neg))
    for key in ("optimizer", "optimizer_inline"):
        for s in range(NEG_STEPS):
            if len({r[key]["steps"][s]["digest"] for r in ranks}) != 1:
                problems.append(f"{key}: ranks differ after step {s}")
    for s in range(NEG_JOIN_STEPS):
        if len({r["join"]["steps"][s]["digest"] for r in ranks}) != 1:
            problems.append(f"join run: ranks differ after step {s}")
    last = ranks[0]["join"]["steps"][NEG_JOIN_STEPS]
    if not (last.get("local_bitwise") and np.isfinite(last["loss"])):
        problems.append("join: rank 0's reduced gradients are not its own")
    if "join" not in ranks[0]["join"]["broadcast"].lower():
        problems.append("join: the broadcast gave "
                        f"{ranks[0]['join']['broadcast']!r}")
    if len({r["order_count"] for r in ranks}) != 1:
        problems.append("order check counts differ")
    if len({tuple(r["adasum"]["digests"]) for r in ranks}) != 1:
        problems.append("Adasum: ranks differ")
    errs = ranks[0]["adasum"]["rel_err"]
    if max(errs) > TOL_COMBINE[torch.float16]:
        problems.append(f"Adasum: {errs} against the float64 reference")
    (w1,) = spawn_ranks(neg_world1_main, 1, (device, NEG_SIDE_TENSORS),
                        timeout, "phase 12 (f)")
    log("phase 12 (f): " + json.dumps(w1))
    if w1["backend"] != ("nccl" if cuda else "gloo"):
        problems.append(f"(f): backend {w1['backend']}")
    runs = w1["runs"]
    if runs["native"]["core"] != "NativeCore" or \
            runs["native"]["digest"] != runs["inline"]["digest"] or \
            not (runs["native"]["equal_inputs"]
                 and runs["inline"]["equal_inputs"]):
        problems.append(f"(f): {runs}")
    log(f"phase 12: {time.monotonic() - t0:.1f} s")
    if problems:
        raise AssertionError("phase 12: " + "; ".join(problems))
    return {"ranks": ranks, "world1": w1, "out_of_order": neg}


# Phase 13: PowerSGD on both reduction planes.
PSGD_RANK = 4
PSGD_STEPS = 3
PSGD_MIN_ELEMENTS = 4096  # the knob's default: every matrix, no norm
# The flagship's plan under powersgd:4 at the default 64 MiB: each
# matrix in its own low-rank bucket family, the five float32 norms in
# one exact bucket.
PSGD_PLAN = (
    "19:90177536|c=powersgd:4;18:90177536|c=powersgd:4;"
    "17:90177536|c=powersgd:4;16,15:67108864|c=powersgd:4;"
    "14,13:67108864|c=powersgd:4;12,11,3,2,1:81920;"
    "10:90177536|c=powersgd:4;9:90177536|c=powersgd:4;"
    "8:90177536|c=powersgd:4;7,6:67108864|c=powersgd:4;"
    "5,4:67108864|c=powersgd:4;0:262144000|c=powersgd:4")
PSGD_PROBE = "layers.0.w_up"
# Gate (e): step 0's reduced probe gradient (the float32 round, before
# the 1/n scale and the bf16 cast) against the same round in float64 on
# the host, Frobenius norm of the error over the reference's. The
# orthogonalization goes through the Cholesky factor of P^T P, whose
# float32 error grows with cond(P)^2 (about 6e-8 * cond(P)^2 relative):
# 1e-3 admits cond(P) up to ~100.
TOL_PSGD = 1e-3
# Gate (d): sigma_5 / sigma_1 below this is numerical rank <= 4.
PSGD_LOW_RANK = 1e-3


def _gram64(p):
    """``gram_orthogonalize`` in float64 on the host."""
    g = p.T @ p
    jitter = np.trace(g) * 1e-7 + 1e-30
    chol = np.linalg.cholesky(g + jitter * np.eye(g.shape[0]))
    return np.linalg.solve(chol, p.T).T


def powersgd_round_f64(mats, q):
    """One PowerSGD round in float64 on the host over every rank's
    matrix (residuals zero): the reduced sum P Q'^T, and two wrong
    answers a gate must reject, the plain sum and the round with P left
    unorthogonalized."""
    ms = [np.asarray(m, np.float64) for m in mats]
    q = np.asarray(q, np.float64)
    p = sum(m @ q for m in ms)
    po = _gram64(p)
    right = po @ sum(m.T @ po for m in ms).T
    return right, {"plain_sum": sum(ms),
                   "unorthogonalized": p @ sum(m.T @ p for m in ms).T}


def _rel64(got, ref):
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _sigma_ratio(m):
    """sigma_5 / sigma_1 of a matrix on its device, from the float64
    eigenvalues of its Gram matrix."""
    m = m.double()
    g = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
    ev = torch.linalg.eigvalsh(g).clamp(min=0).sqrt().flip(0)
    return float(ev[PSGD_RANK] / ev[0])


def psgd_reckoning(model, min_elements, rank=PSGD_RANK):
    """(factor bytes, exact bytes) per rank and step under powersgd:r,
    from the parameters alone: (n + m) r float32 elements per matrix of
    at least ``min_elements``, and the float32 norms with the guard's
    flag riding their bucket."""
    factors, exact = 0, 0
    for p in model.parameters():
        if p.dim() >= 2 and p.numel() >= min_elements:
            n, m = p.shape[0], p.numel() // p.shape[0]
            factors += 4 * (n + m) * min(rank, n, m)
        else:
            exact += p.numel() * p.element_size()
    return factors, exact + 4


class _EventTimer:
    """Device milliseconds of the wrapped calls (CUDA events, read after
    the step; the host clock on the CPU)."""

    def __init__(self, cuda):
        self.cuda, self.pairs, self.host_ms = cuda, [], 0.0

    def wrap(self, fn):
        def timed(*args, **kw):
            if not self.cuda:
                t0 = time.monotonic()
                out = fn(*args, **kw)
                self.host_ms += 1e3 * (time.monotonic() - t0)
                return out
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.pairs.append((start, end))
            return out
        return timed

    def take(self):
        if self.cuda:
            torch.cuda.synchronize()
        ms = self.host_ms + sum(s.elapsed_time(e) for s, e in self.pairs)
        self.pairs, self.host_ms = [], 0.0
        return ms


def _wire_bytes_now(metrics, tag):
    return metrics.snapshot().get("hvd_wire_bytes_total", {}).get(
        (tag,), 0.0)


def _state_clone(state):
    return {k: {i: t.clone() for i, t in state[k].items()}
            for k in ("q", "e")}


def _state_equal(a, b):
    return all(torch.equal(a[k][i], b[k][i]) for k in ("q", "e")
               for i in a[k])


def psgd_rank_main(rank, port, results, device, cfg_kw, seq, steps,
                   min_elements):
    """One rank of phase 13, in a spawned process: the train step with
    ``compression="powersgd:4"`` (guard on, overlap on, the default 64
    MiB) for ``steps`` steps from the broadcast start, a step rank 1's
    ``numerics.grad`` seam poisons and a clean one; then from the same
    start DistributedOptimizer(AdamW, Average, Compression.powersgd(
    rank=4)) on the negotiated engine, the same way."""
    status, payload = "error", None
    cuda = device.startswith("cuda")
    try:
        hvd = _join_world(rank, DP_RANKS, port, device, {
            "HOROVOD_NUMERICS_GUARD": "1",
            "HOROVOD_COMPRESSION_MIN_ELEMENTS": str(min_elements)})
        from horovod_tpu_torch import faults, metrics, numerics, tracing
        from horovod_tpu_torch.models import transformer as tfm
        from horovod_tpu_torch.ops import compression as comp
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.parallel import mesh as mesh_mod
        from horovod_tpu_torch.parallel import train
        tag = f"powersgd:{PSGD_RANK}"
        cfg = tfm.TransformerConfig(**cfg_kw, dtype=torch.bfloat16)
        model = tfm.init_params(cfg, seed=rank, device=device)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        names = [n for n, _ in model.named_parameters()]
        probe_idx = names.index(PSGD_PROBE)
        probe_param = model.get_parameter(PSGD_PROBE)
        mesh = mesh_mod.data_parallel_mesh()
        timer = _EventTimer(cuda)
        for mod in (comp, train):
            for name in ("powersgd_compress", "powersgd_project",
                         "powersgd_decompress"):
                setattr(mod, name, timer.wrap(getattr(mod, name)))
        capture = {"armed": False, "calls": 0, "at": None}
        inner_decompress = train.powersgd_decompress

        def decompress(ms, ps, qns, red_q, n):
            out = inner_decompress(ms, ps, qns, red_q, n)
            if capture["armed"]:
                if capture["calls"] == capture["at"][0]:
                    capture["out"] = out[0][capture["at"][1]].detach().clone()
                capture["calls"] += 1
            return out
        train.powersgd_decompress = decompress
        local = {}
        probe_param.register_post_accumulate_grad_hook(
            lambda p: local.__setitem__("g", p.grad.detach().clone())
            if capture["armed"] else None)

        def fresh_model():
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(start[n])
                    p.grad = None

        def loss(m, b):
            return tfm.loss_fn(cfg, m, b)

        out = {"rank": rank, "backend": hvd.backend(),
               "reckoning": psgd_reckoning(model, min_elements)}
        # --- the train step -------------------------------------------
        opt = numerics.guard_non_finite(train.adamw(model.parameters(), LR))
        probe = tracing.OverlapProbe()
        probe.armed = True
        clock = _StepClock(cuda, model)
        clock.watch(opt)
        step = train.build_train_step(loss, opt, device, mesh=mesh,
                                      overlap=True, overlap_probe=probe,
                                      compression=tag)
        plan = train.plan_overlap(model, mesh, guard=True, compression=tag)
        lowrank = [b for b, t in enumerate(plan.bucket_compression)
                   if t != "none"]
        bid = next(b for b, idxs in enumerate(plan.bucket_leaf_indices)
                   if probe_idx in idxs)
        capture["at"] = (lowrank.index(bid),
                         plan.bucket_leaf_indices[bid].index(probe_idx))
        reset_counts(fa)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        steps_out, digests = [], []
        for s in range(steps):
            batch = {k: v for k, v in dps_batch(cfg, seq, rank, s).items()
                     if k != "scale"}
            capture.update(armed=s == 0, calls=0)
            clock.reset()
            with probe._lock:
                probe.events.clear()
            w0 = _wire_bytes_now(metrics, tag)
            timer.take()
            clock.sync()
            t0 = time.monotonic()
            metrics_ = step(model, batch)
            clock.sync()
            t1 = time.monotonic()
            with probe._lock:
                events = list(probe.events)
            steps_out.append({
                "loss": float(metrics_["loss"]),
                **clock.parts(t0, events),
                "step_ms": 1e3 * (t1 - t0),
                "powersgd_compute_ms": timer.take(),
                "wire_bytes": _wire_bytes_now(metrics, tag) - w0})
            digests.append(_params_digest(model))
            if s == 0:
                capture["armed"] = False
                applied = probe_param.grad.detach().clone()
        out["train"] = {
            "steps": steps_out, "digests": digests,
            "plan": train.last_overlap_info(),
            "tags": list(plan.bucket_compression),
            "launches": launch_counts(fa),
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if cuda else None)}
        # (e), (d): step 0's probe gradient. The float32 round, scaled
        # and cast, is what the step applied; both ranks' local
        # gradients go to rank 0, which repeats the round in float64.
        red32 = capture["out"]
        scaled = (red32 * torch.tensor(1.0 / DP_RANKS, dtype=red32.dtype,
                                       device=red32.device)).to(
            probe_param.dtype)
        out["train"]["applied_is_the_round"] = torch.equal(scaled, applied)
        rows = hvd.allgather(local["g"].unsqueeze(0))
        out["train"]["probe_sigma_ratio"] = _sigma_ratio(red32)
        out["train"]["exact_sigma_ratio"] = _sigma_ratio(
            rows.float().mean(0))
        if rank == 0:
            q0 = comp.init_q(tuple(probe_param.shape), PSGD_RANK, probe_idx,
                             "cpu")
            mats = [r.float().cpu().numpy().reshape(
                comp.matrix_shape(probe_param.shape)) for r in rows]
            ref, wrong = powersgd_round_f64(mats, q0.numpy())
            got = red32.cpu().numpy()
            out["train"]["probe_rel_err"] = _rel64(got, ref)
            out["train"]["wrong_rel_err"] = {k: _rel64(w, ref)
                                             for k, w in wrong.items()}
        del rows, local["g"], red32, scaled, applied
        # (f): rank 1's seam poisons one gradient element.
        state = step.compression_state()
        before_state = _state_clone(state)
        before = _state_digest(model, opt)
        if rank == 1:
            faults.configure("numerics.grad:nan:at=1")
        step(model, {k: v for k, v in dps_batch(cfg, seq, rank, steps)
                     .items() if k != "scale"})
        faults.configure(None)
        out["train"]["nan"] = {
            "kept_state": _state_digest(model, opt) == before,
            "kept_q_e": _state_equal(before_state, step.compression_state()),
            "skips": opt.total_skips}
        del before_state
        step(model, {k: v for k, v in dps_batch(cfg, seq, rank, steps + 1)
                     .items() if k != "scale"})
        out["train"]["nan"]["next_applied"] = \
            _state_digest(model, opt) != before
        out["train"]["nan"]["digest"] = _params_digest(model)
        del step, opt, state
        if cuda:
            torch.cuda.empty_cache()
        # --- DistributedOptimizer -------------------------------------
        fresh_model()
        opt = hvd.DistributedOptimizer(
            numerics.guard_non_finite(train.adamw(model.parameters(), LR)),
            named_parameters=model.named_parameters(), op=hvd.Average,
            compression=hvd.Compression.powersgd(rank=PSGD_RANK))
        dispatch = _HistDelta(metrics, "hvd_dispatch_latency_seconds")
        reset_counts(fa)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        steps_out, digests = [], []
        for s in range(steps):
            batch = {k: v.to(device) for k, v in
                     dps_batch(cfg, seq, rank, s).items() if k != "scale"}
            dispatch.take()
            w0 = _wire_bytes_now(metrics, tag)
            timer.take()
            clock.sync()
            t0 = time.monotonic()
            opt.zero_grad()
            loss_ = tfm.loss_fn(cfg, model, batch)
            loss_.backward()
            clock.sync()
            t1 = time.monotonic()
            opt.synchronize()
            clock.sync()
            t2 = time.monotonic()
            with opt.skip_synchronize():
                opt.step()
            clock.sync()
            t3 = time.monotonic()
            steps_out.append({
                "loss": float(loss_.detach()),
                "forward_backward_ms": 1e3 * (t1 - t0),
                "synchronize_ms": 1e3 * (t2 - t1),
                "adamw_ms": 1e3 * (t3 - t2), "step_ms": 1e3 * (t3 - t0),
                "dispatch_ms": 1e3 * dispatch.take()[1],
                "powersgd_compute_ms": timer.take(),
                "wire_bytes": _wire_bytes_now(metrics, tag) - w0})
            digests.append(_params_digest(model))
        out["optimizer"] = {
            "steps": steps_out, "digests": digests,
            "launches": launch_counts(fa),
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if cuda else None)}
        st = opt.compression_state()
        before_state = _state_clone(st)
        before = _state_digest(model, opt)
        if rank == 1:
            faults.configure("numerics.grad:nan:at=1")
        opt.zero_grad()
        tfm.loss_fn(cfg, model, {k: v.to(device) for k, v in dps_batch(
            cfg, seq, rank, steps).items() if k != "scale"}).backward()
        opt.step()
        faults.configure(None)
        out["optimizer"]["nan"] = {
            "kept_state": _state_digest(model, opt) == before,
            "kept_q_e": _state_equal(before_state, opt.compression_state()),
            "skips": opt.total_skips, "digest": _params_digest(model)}
        payload = out
        status = "ok"
        hvd.shutdown()
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        payload = traceback.format_exc()
    finally:
        results.put((rank, status, payload))


def phase_powersgd(device="cuda:0", cfg_kw=None, seq=SEQ, timeout=900.0,
                   plan=PSGD_PLAN, min_elements=PSGD_MIN_ELEMENTS):
    """Phase 13: PowerSGD rank 4 on the train step and on
    DistributedOptimizer, two gloo ranks sharing the card."""
    cfg_kw = cfg_kw or dict(LLAMA2_7B, n_layers=DP_LAYERS)
    cuda = device.startswith("cuda")
    t0 = time.monotonic()
    ranks = spawn_ranks(psgd_rank_main, DP_RANKS,
                        (device, cfg_kw, seq, PSGD_STEPS, min_elements),
                        timeout, "phase 13")
    for r in ranks:
        log(f"phase 13: rank {r['rank']} train step " + json.dumps(
            {k: v for k, v in r["train"].items() if k != "plan"}))
        log(f"phase 13: rank {r['rank']} plan " + json.dumps(
            r["train"]["plan"]))
        log(f"phase 13: rank {r['rank']} optimizer " + json.dumps(
            r["optimizer"]))
    problems = []
    factors, exact = ranks[0]["reckoning"]
    want_k3 = DP_LAYERS * PSGD_STEPS if cuda else 0
    for r in ranks:
        tag = f"rank {r['rank']}"
        tr, op = r["train"], r["optimizer"]
        if r["backend"] != "gloo":
            problems.append(f"{tag}: backend {r['backend']}")
        # (a) the plan; every bucket of matrices is low-rank
        if tr["plan"]["digest"] != plan or tr["plan"]["compression"] != \
                f"powersgd:{PSGD_RANK}":
            problems.append(f"{tag}: plan {tr['plan']['digest']}")
        if tr["tags"].count("none") != 1:
            problems.append(f"{tag}: bucket tags {tr['tags']}")
        # (b) the wire per step
        for s, st in enumerate(tr["steps"]):
            if st["wire_bytes"] != factors + exact:
                problems.append(f"{tag}: step {s} wire {st['wire_bytes']}, "
                                f"reckoned {factors + exact}")
            if not np.isfinite(st["loss"]):
                problems.append(f"{tag}: step {s} loss {st['loss']}")
        for s, st in enumerate(op["steps"]):
            if st["wire_bytes"] != factors:
                problems.append(f"{tag}: optimizer step {s} wire "
                                f"{st['wire_bytes']}, reckoned {factors}")
            if not np.isfinite(st["loss"]):
                problems.append(f"{tag}: optimizer step {s} loss")
        # (d) compression happened
        if not (tr["probe_sigma_ratio"] < PSGD_LOW_RANK
                <= tr["exact_sigma_ratio"]):
            problems.append(f"{tag}: sigma_5/sigma_1 reduced "
                            f"{tr['probe_sigma_ratio']}, exact "
                            f"{tr['exact_sigma_ratio']}")
        if not tr["applied_is_the_round"]:
            problems.append(f"{tag}: the applied gradient is not the round")
        # (f) the poisoned step
        for plane in (tr, op):
            n = plane["nan"]
            if not (n["kept_state"] and n["kept_q_e"] and n["skips"] == 1):
                problems.append(f"{tag}: poisoned step {n}")
        if not tr["nan"]["next_applied"]:
            problems.append(f"{tag}: the clean step after it did not apply")
        # (g) K3
        for name, plane in (("train step", tr), ("optimizer", op)):
            if plane["launches"] != {"fwd": want_k3, "dkv": want_k3,
                                     "dq": want_k3}:
                problems.append(f"{tag}: {name} K3 launches "
                                f"{plane['launches']}, want {want_k3}")
    # (e) the round against float64, and the wrong answers it rejects
    tr0 = ranks[0]["train"]
    wrong = tr0["wrong_rel_err"]
    log(f"phase 13 (e): probe {PSGD_PROBE} against the float64 round "
        f"{tr0['probe_rel_err']:.3e} (gate {TOL_PSGD}); wrong answers "
        + json.dumps(wrong) + f", each must exceed "
        f"{FAULT_MARGIN * TOL_PSGD}")
    if tr0["probe_rel_err"] > TOL_PSGD:
        problems.append(f"(e): {tr0['probe_rel_err']} against float64")
    for k, v in wrong.items():
        if not v > FAULT_MARGIN * TOL_PSGD:
            problems.append(f"(e): the gate cannot tell the {k} ({v})")
    # (c) ranks bitwise equal
    for key in ("train", "optimizer"):
        for s in range(PSGD_STEPS):
            if len({r[key]["digests"][s] for r in ranks}) != 1:
                problems.append(f"{key}: ranks differ after step {s}")
        if len({r[key]["nan"]["digest"] for r in ranks}) != 1:
            problems.append(f"{key}: ranks differ after the poisoned step")
    log(f"phase 13: wire per rank and step {factors + exact} bytes "
        f"(train step), {factors} (optimizer's factors); "
        f"{time.monotonic() - t0:.1f} s")
    if problems:
        raise AssertionError("phase 13: " + "; ".join(problems))
    return {"ranks": ranks}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import _cuda_build
    from horovod_tpu_torch.ops import adasum_kernels as ak
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.monotonic()
    # The C++ control core (g++) builds beside the nvcc builds; the
    # spawned ranks of phases 9-12 then find it built.
    from horovod_tpu_torch.core import native
    core_build = {}

    def build_core():
        try:
            core_build["path"] = native.build()
        except BaseException as e:  # noqa: BLE001 — raised below
            core_build["error"] = e
        core_build["s"] = time.monotonic() - t0
    core_thread = threading.Thread(target=build_core)
    core_thread.start()
    paths = _cuda_build.build(verbose=True)
    for name in paths:
        _cuda_build.load_library(name)
    log(f"phase 1: built {[os.path.relpath(p, REPO) for p in paths.values()]}"
        f" in {time.monotonic() - t0:.1f} s")
    core_thread.join()
    if "error" in core_build:
        raise core_build["error"]
    native.load()
    log(f"phase 1: built {os.path.relpath(core_build['path'], REPO)} "
        f"(the control core) in {core_build['s']:.1f} s")
    for name, build_log in _cuda_build.build_logs.items():
        for res in _cuda_build.ptxas_resources(build_log):
            log(f"phase 1: ptxas {name}: " + json.dumps(res))
    fwd_lib = _cuda_build.load_library("flash_attention_fwd")
    bwd_lib = _cuda_build.load_library("flash_attention_bwd")
    smem = {"flash_attention_fwd": fwd_lib.hvd_flash_attention_fwd_smem_bytes,
            "flash_attention_bwd_dkv":
                bwd_lib.hvd_flash_attention_bwd_dkv_smem_bytes,
            "flash_attention_bwd_dq":
                bwd_lib.hvd_flash_attention_bwd_dq_smem_bytes}
    log("phase 1: dynamic shared memory bytes " + json.dumps(
        {name: {D: fn(D) for D in fa.KERNEL_HEAD_DIMS}
         for name, fn in smem.items()}))

    cases = phase_kernel_vs_plain(fa, dev)
    log("phase 2: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60).stdout.strip())
    path = phase_path_vs_plain(fa, tfm, dev)
    served = phase_serving(fa, tfm, serving)
    served["length_ladder"] = phase_serving_ladder(fa, tfm, serving)
    bwd_cases = phase_backward_vs_plain(fa, dev)
    train_path = phase_training_path_vs_plain(fa, tfm, dev)
    trained = phase_training(fa, tfm, train)
    adasum_cases = phase_adasum_kernels(ak, dev)
    dp = phase_adasum_training()
    dp_gather = phase_adasum_training(route="gather", steps=DP_GATHER_STEPS)
    routes_err = routes_rel_err(dp, dp_gather)
    log(f"phase 9: step 0's reduced FFN gradient, vhdd against gather: "
        f"{routes_err}")
    if routes_err > TOL_COMBINE[torch.float16]:
        raise AssertionError(f"phase 9: the routes disagree at step 0: "
                             f"{routes_err}")
    t0 = time.monotonic()
    coll = phase_collectives()
    log(f"phase 10: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    dps = phase_dp_step()
    log(f"phase 11: {time.monotonic() - t0:.1f} s")
    neg = phase_negotiated()
    neg_launches = [r["optimizer"]["launches"] for r in neg["ranks"]]
    psgd = phase_powersgd()
    psgd_launches = [{"train_step": r["train"]["launches"],
                      "optimizer": r["optimizer"]["launches"]}
                     for r in psgd["ranks"]]

    main_case = cases[0]                     # (4, 2048, 32, 128) causal
    bwd_case = bwd_cases[0]                  # (2, 2048, 32, 128) causal
    per_step = {n: c // TRAIN_STEPS for n, c in trained["launches"].items()}
    forward = {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "horovod_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "horovod_tpu/parallel/ring_attention.py:163",
        "launches": trained["launches"]["fwd"],
        "launches_per_step": per_step["fwd"],
        "launches_dp_step_per_rank": [r["launches"]["fwd"]
                                      for r in dps["ranks"]],
        "launches_negotiated_steps_per_rank": [n["fwd"]
                                               for n in neg_launches],
        "launches_powersgd_steps_per_rank": [
            {plane: n[plane]["fwd"] for plane in n} for n in psgd_launches],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": main_case["shape"],
        "tflops": main_case["tflops"],
        "cases": cases,
        "path_vs_plain": path,
        "serving": served,
        "card": card,
    }
    backward = []
    for name, key, outs, line in (
            ("flash_attention_bwd_dkv", "dkv", ("dk", "dv"), 796),
            ("flash_attention_bwd_dq", "dq", ("dq",), 1146)):
        backward.append({
            "name": name,
            "route": "cuda",
            "source": "horovod_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"jax/experimental/pallas/ops/tpu/"
                        f"flash_attention.py:{line}",
            "reached_from": "horovod_tpu/parallel/ring_attention.py:163",
            "launches": trained["launches"][key],
            "launches_per_step": per_step[key],
            "launches_dp_step_per_rank": [r["launches"][key]
                                          for r in dps["ranks"]],
            "launches_negotiated_steps_per_rank": [n[key]
                                                   for n in neg_launches],
            "launches_powersgd_steps_per_rank": [
                {plane: n[plane][key] for plane in n}
                for n in psgd_launches],
            "max_abs_err": max(bwd_case["max_abs_err"][o] for o in outs),
            "slice_rel_err": max(bwd_case["slice_rel_err"][o] for o in outs),
            "ms": bwd_case[key]["ms"],
            "plain_ms": bwd_case["plain_ms"],
            "bound_ms": bwd_case[key]["bound_ms"],
            "bound_by": bwd_case[key]["bound_by"],
            "library_ms": bwd_case["library_ms"],
            "shape": bwd_case["shape"],
            "tflops": bwd_case[key]["tflops"],
            "card": card,
        })
    backward[0].update(cases=bwd_cases, training_path_vs_plain=train_path,
                       training=trained, dp_train_step=dps,
                       negotiated=neg, powersgd=psgd,
                       function=bwd_case["function"])
    ffn = next(c for c in adasum_cases if c["n"] == 4096 * 11008
               and c["dtype"] == "float16")
    embed = next(c for c in adasum_cases if c["n"] == 32000 * 4096
                 and c["dtype"] == "float16")
    adasum = []
    for name, key, line, err in (
            ("adasum_partials", "k1", 50, "coeff_max_abs_err"),
            ("adasum_scaled_add", "k2", 70, "max_abs_err")):
        adasum.append({
            "name": name,
            "route": "cuda",
            "source": "horovod_tpu_torch/csrc/adasum_pair_combine.cu",
            "replaces": f"horovod_tpu/ops/pallas_kernels.py:{line}",
            "launches": sum(r["launches"][0 if key == "k1" else 1]
                            for r in dp),
            "launches_per_rank_per_step": dp[0]["n_grad_tensors"],
            "launches_gather_route": sum(
                r["launches"][0 if key == "k1" else 1] for r in dp_gather),
            "launches_three_ranks_per_case": coll[0]["adasum"][0][
                "launches_per_rank"],
            "launches_negotiated_batch_per_rank": [
                r["adasum"]["launches"][0 if key == "k1" else 1]
                for r in neg["ranks"]],
            "max_abs_err": ffn[err],
            "ms": ffn[key]["ms"],
            "plain_ms": ffn[key]["plain_ms"],
            "bound_ms": ffn[key]["bound_ms"],
            "bound_by": ffn[key]["bound_by"],
            "library_ms": None,
            "n": ffn["n"], "dtype": ffn["dtype"],
            "at_embedding_size": embed[key],
            "card": card,
        })
    for r in dp_gather:
        r.pop("probe_red", None)
    for r in dp:
        r.pop("probe_red", None)
    adasum[0].update(cases=adasum_cases, training=dp,
                     training_gather_route=dp_gather,
                     routes_rel_err=routes_err, three_ranks=coll)
    print(json.dumps({"kernels": [forward, *backward, *adasum]}),
          flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
