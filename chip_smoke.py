#!/usr/bin/env python3
"""Smoke run of horovod_tpu_torch on one NVIDIA card: builds the port's
CUDA kernels from this checkout and drives its serving and training
paths.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

1. Device and build: the card's name and power limit (nvidia-smi), then
   nvcc builds the flash-attention forward and backward libraries, one
   nvcc per source, started together (ptxas register report printed).
2. Forward kernel vs plain: the kernel against its plain PyTorch version
   at the served shapes (B in 1, 2, 4; L 2048; 32 heads; head dim 128;
   bf16; causal), non-causal, head dim 64, and small float32 cases.
   Error on o and lse, kernel time (CUDA events), plain time,
   F.scaled_dot_product_attention's time as a yardstick (timed here,
   never called by the port), the bound and the achieved TFLOP/s. At
   the first served shape it also shows that the o check fails two
   faults planted in a copy of the plain version.
3. Served forward vs plain: the served forward at Llama-2-7B width and
   2 layers, flash kernel vs the plain attention swapped in for it, on
   the same weights and tokens.
4. Serving at Llama-2-7B width and full depth (32 layers, bf16):
   ServingFrontend with one worker on the card, ladder b = 1, 2, 4,
   6 requests of 2048 tokens. Asserts 6 completed, 0 failed, no worker
   failure, 3 warm-ups and no growth, finite logits, and kernel
   launches = 32 x (warm-ups + served batches).
5. Backward kernels vs plain: dK/dV and dQ against the plain backward
   (float32) on the same inputs, at the training shape (2, 2048, 32,
   128) causal bf16, at B = 4, non-causal, head dim 64, head dim 256,
   and small float32 cases. At the training shape it shows that the
   check fails three faults planted in a copy of the plain backward,
   each by 10x its tolerance or more, and it times each kernel, the
   plain backward and the backward of F.scaled_dot_product_attention
   (timed only).
6. Training path vs plain: Llama-2-7B width, 2 layers, B = 2, L =
   2048: loss and every parameter's gradient with the kernels against
   the same step with both plain versions swapped in; wq's gradient is
   non-zero, and two backward passes give bitwise equal gradients.
7. Training at Llama-2-7B width, 4 layers, B = 2, L = 2048, bf16:
   ``build_train_step`` with AdamW (optax.adamw(3e-4)'s settings), 5
   steps on one batch. The loss is finite at every step and falls from
   step 0 to step 4; each of the three kernels launches 4 x 5 times.
   Median step time, tokens/s and peak memory, then one more step timed
   in parts (layers' forward, LM head and loss, backward, AdamW).
8. A ``{"kernels": [...]}`` line, the card line, then the last line
   ``{"ok": true, "device": {...}}``.

Forward tolerances, on the worst row's relative error (``row_rel_err``:
the 2-norm of the error over the 2-norm of the plain result, per query
row of o and per request's logits): bf16 1e-2 (the kernel rounds P to
bf16 before the P V product, and both paths round o and every
activation to bf16, about 2^-9 relative each); float32 1e-5 (summation
order only). lse, on max abs error: 1e-4 (float32 statistics of the
same scores).

Backward tolerances, on the worst (b, h) slice's relative error
(``slice_rel_err``: the Frobenius norm of the error over that of the
plain result, per (b, h) slice of dq, dk and dv; a row measure does not
fit here: with causal masking query row 0's exact dq is 0): bf16 1e-2
(the kernels round P and dS to bf16 before their products and the
gradients to bf16, about 2^-9 relative each; a CPU emulation of that
rounding gives 2.4e-3); float32 1e-5 (summation order only). Training
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
TOL_ROW = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
TOL_LSE = 1e-4
FAULT_TILE = 64          # the kernel's key tile
TOL_SLICE = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
FAULT_MARGIN = 10.0      # a planted fault must exceed the tolerance 10x
TOL_GRAD = 2e-2          # training path: per-parameter gradient
TOL_LOSS = 1e-3          # training path: relative loss difference
TRAIN_BATCH = 2
TRAIN_LAYERS = 4
TRAIN_STEPS = 5
LR = 3e-4


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


def planted_backward_faults(q, k, v, o, lse, do, causal):
    """(dq, dk, dv) of three faulty copies of the plain backward, each a
    bug a flash backward kernel can have: ``no_di`` leaves di out of dS;
    ``no_causal_mask`` recomputes P over every key; ``dk_unscaled``
    leaves the softmax scale out of dK."""
    D = q.shape[-1]
    scale = D ** -0.5

    def bwd(di_on=True, mask_on=True, dk_scale=scale):
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

    return {"no_di": bwd(di_on=False), "no_causal_mask": bwd(mask_on=False),
            "dk_unscaled": bwd(dk_scale=1.0)}


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
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", ops)


# The backward's work, as attention_bound's (products, tensors, stats):
# dK/dV does S^T, dP^T, P^T dO and dS^T Q, reads q, k, v, dO, lse and
# di and writes dk, dv; dQ does S, dP and dS K, reads the same and
# writes dq; the function as a whole needs five products (S, dP and the
# three gradients), reads q, k, v, o, dO and lse and writes dq, dk, dv.
BWD_WORK = {"dkv": (4, 6, 2), "dq": (3, 5, 2), "function": (5, 8, 1)}


def phase_kernel_vs_plain(fa, dev):
    cases = [(4, SEQ, 32, 128, True, torch.bfloat16),
             (2, SEQ, 32, 128, True, torch.bfloat16),
             (1, SEQ, 32, 128, True, torch.bfloat16),
             (4, SEQ, 32, 128, False, torch.bfloat16),
             (4, SEQ, 32, 64, True, torch.bfloat16),
             (1, 256, 4, 64, True, torch.float32),
             (1, 256, 4, 128, False, torch.float32),
             (1, 256, 2, 256, True, torch.float32),
             (1, 256, 2, 256, True, torch.bfloat16)]
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
            if not all(err > tol for err in faults.values()):
                raise AssertionError(f"the o check (tol {tol}) misses a "
                                     f"planted fault: {faults}")
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


BWD_CASES = [(2, SEQ, 32, 128, True, torch.bfloat16),   # training shape
             (4, SEQ, 32, 128, True, torch.bfloat16),
             (2, SEQ, 32, 128, False, torch.bfloat16),
             (2, SEQ, 32, 64, True, torch.bfloat16),
             (2, SEQ, 16, 256, True, torch.bfloat16),
             (1, 256, 4, 128, True, torch.float32),
             (1, 256, 2, 64, False, torch.float32),
             (1, 256, 2, 256, True, torch.float32)]


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
    log("phase 7: " + json.dumps(result))
    want = TRAIN_LAYERS * TRAIN_STEPS
    problems = []
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.monotonic()
    paths = fa.build(verbose=True)
    for name in paths:
        fa.load_library(name)
    log(f"phase 1: built {[os.path.relpath(p, REPO) for p in paths.values()]}"
        f" in {time.monotonic() - t0:.1f} s")

    cases = phase_kernel_vs_plain(fa, dev)
    log("phase 2: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60).stdout.strip())
    path = phase_path_vs_plain(fa, tfm, dev)
    served = phase_serving(fa, tfm, serving)
    bwd_cases = phase_backward_vs_plain(fa, dev)
    train_path = phase_training_path_vs_plain(fa, tfm, dev)
    trained = phase_training(fa, tfm, train)

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
                       training=trained,
                       function=bwd_case["function"])
    print(json.dumps({"kernels": [forward, *backward]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
