#!/usr/bin/env python3
"""Time the flash-attention kernels of one checkout of horovod_tpu_torch
on the card, for comparing two versions within one call.

    python3 scripts/torch_port_kernel_ab.py --tree PATH [--label NAME]

Imports ``horovod_tpu_torch`` from the checkout at PATH (building its
kernels there), then times K3-fwd at (4, 2048, 32, 128) and
(2, 2048, 32, 128), and K3-bwd dK/dV and dQ at (2, 2048, 32, 128), all
causal bf16, with CUDA events (20 launches after 2 warm-ups), and prints
one JSON line with the card's name and power limit. Run it from two
checkouts in turns (A, B, B, A) in one call: two calls may land on two
cards.
"""

import argparse
import json
import os
import subprocess
import sys


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_port_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    from horovod_tpu_torch.ops import flash_attention as fa
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"label": args.label or args.tree}
    for B in (4, 2):
        q, k, v, do = (torch.randn((B, 2048, 32, 128), generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for _ in range(4))
        out[f"fwd_b{B}_ms"] = time_ms(
            torch, lambda: fa.flash_attention_fwd(q, k, v, True))
        if B == 2:
            o, lse = fa.flash_attention_fwd(q, k, v, True)
            di = fa.backward_di(o, do)
            scale = 128 ** -0.5
            out["dkv_b2_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dkv(
                q, k, v, do, lse, di, True, scale))
            out["dq_b2_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dq(
                q, k, v, do, lse, di, True, scale))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
