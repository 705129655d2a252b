#!/usr/bin/env python3
"""Time the flash-attention kernels of one checkout of horovod_tpu_torch
on the card, for comparing two versions within one call.

    python3 scripts/torch_port_kernel_ab.py --tree PATH [--label NAME] [--e2e]

Imports ``horovod_tpu_torch`` from the checkout at PATH (building its
kernels there), then times with CUDA events (20 launches after 2
warm-ups):

- K3-fwd at (4, 2048, 32, 128) and (2, 2048, 32, 128) causal bf16, at
  (4, 2048, 32, 128) non-causal, at head dim 64, in float16, at ragged
  lengths (L = 1000 and 2047, the latter beside the whole-tile 2048),
  and at head dim 256 (2, 2048, 16, 256);
- K3-bwd dK/dV and dQ at (2, 2048, 32, 128) causal bf16, non-causal,
  at head dim 64, in float16, at ragged lengths (L = 1000 and 2047),
  and at head dim 256 (2, 2048, 16, 256), and the whole backward
  (``flash_attention_bwd``: di, dK/dV and dQ) at the first of them;
- F.scaled_dot_product_attention at the first shape, as a yardstick.

With ``--e2e`` it also times what the forward moves end to end, at
Llama-2-7B width with random weights: one served batch (the 32-layer
forward and the last position's logits at B = 4, L = 2048, CUDA events,
3 runs after 1 warm-up) and the 4-layer training step (B = 2, L = 2048,
AdamW, host clock around synchronised steps, median of 4 after 1
warm-up). It prints one JSON line with the card's name and power limit.
Run it from two checkouts in turns (A, B, B, A) in one call: two calls
may land on two cards.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# (name, (B, L, H, D), causal, dtype name)
FWD_CASES = [("fwd_b4", (4, 2048, 32, 128), True, "bfloat16"),
             ("fwd_b2", (2, 2048, 32, 128), True, "bfloat16"),
             ("fwd_b4_noncausal", (4, 2048, 32, 128), False, "bfloat16"),
             ("fwd_b4_d64", (4, 2048, 32, 64), True, "bfloat16"),
             ("fwd_b2_f16", (2, 2048, 32, 128), True, "float16"),
             ("fwd_b4_l1000", (4, 1000, 32, 128), True, "bfloat16"),
             ("fwd_b4_l2047", (4, 2047, 32, 128), True, "bfloat16"),
             ("fwd_b2_d256", (2, 2048, 16, 256), True, "bfloat16")]
# The backward's cases, timed for dK/dV and dQ as ``dkv_<name>_ms`` and
# ``dq_<name>_ms``.
BWD_CASES = [("b2", (2, 2048, 32, 128), True, "bfloat16"),
             ("b2_noncausal", (2, 2048, 32, 128), False, "bfloat16"),
             ("b2_d64", (2, 2048, 32, 64), True, "bfloat16"),
             ("b2_f16", (2, 2048, 32, 128), True, "float16"),
             ("b2_l1000", (2, 1000, 32, 128), True, "bfloat16"),
             ("b2_l2047", (2, 2047, 32, 128), True, "bfloat16"),
             ("b2_d256", (2, 2048, 16, 256), True, "bfloat16")]
LLAMA2_7B = dict(vocab=32000, d_model=4096, n_layers=32, n_heads=32,
                 n_kv_heads=32, head_dim=128, d_ff=11008, max_seq=2048)


def time_ms(torch, fn, iters=20, warmup=2):
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


def kernels(torch, fa, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, shape, causal, dtype in FWD_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   .to(getattr(torch, dtype)) for _ in range(3))
        out[f"{name}_ms"] = time_ms(
            torch, lambda: fa.flash_attention_fwd(q, k, v, causal))
        if name == "fwd_b4":
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            out["sdpa_b4_ms"] = time_ms(
                torch, lambda: torch.nn.functional.
                scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        del q, k, v
    for name, shape, causal, dtype in BWD_CASES:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       .to(getattr(torch, dtype)) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        di = fa.backward_di(o, do)
        scale = shape[-1] ** -0.5
        out[f"dkv_{name}_ms"] = time_ms(
            torch, lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, di,
                                                      causal, scale))
        out[f"dq_{name}_ms"] = time_ms(
            torch, lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, di,
                                                     causal, scale))
        if name == "b2":
            out["bwd_b2_ms"] = time_ms(
                torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                      causal))
        del q, k, v, do, o, lse, di
    return out


def end_to_end(torch, dev):
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel import train
    out = {}
    cfg = tfm.TransformerConfig(**LLAMA2_7B, dtype=torch.bfloat16)
    model = tfm.init_params(cfg, seed=0, device=dev)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (4, 2048)).astype(np.int32)).to(dev)

    def served_batch():
        hidden, _ = tfm.forward(cfg, model, tokens)
        return tfm.logits_fn(cfg, model, hidden[:, -1:])[:, -1]

    with torch.inference_mode():
        out["serving_b4_32_layers_ms"] = time_ms(torch, served_batch,
                                                 iters=3, warmup=1)
    del model
    torch.cuda.empty_cache()

    cfg = tfm.TransformerConfig(**dict(LLAMA2_7B, n_layers=4),
                                dtype=torch.bfloat16)
    model = tfm.init_params(cfg, seed=0, device=dev)
    step = train.build_train_step(lambda m, b: tfm.loss_fn(cfg, m, b),
                                  train.adamw(model.parameters(), 3e-4))
    toks = np.random.RandomState(4).randint(0, cfg.vocab, (2, 2048))
    batch = {"tokens": torch.from_numpy(toks).to(dev),
             "targets": torch.from_numpy(np.roll(toks, -1, 1)).to(dev)}
    times = []
    for _ in range(5):
        t0 = time.monotonic()
        float(step(model, batch)["loss"])             # waits
        times.append(time.monotonic() - t0)
    out["train_4_layers_step_ms"] = 1e3 * statistics.median(times[1:])
    del model, step
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--e2e", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_port_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.abspath(args.tree))
    from horovod_tpu_torch.ops import flash_attention as fa
    dev = torch.device("cuda", 0)
    out = {"label": args.label or args.tree}
    out.update(kernels(torch, fa, dev))
    if args.e2e:
        out.update(end_to_end(torch, dev))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
