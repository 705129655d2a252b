"""Adasum adaptive summation (arXiv:2006.02924) on the gather route.

Port of ``horovod_tpu/ops/adasum.py``'s gather route. The pairwise
combine of contributions a and b is the orthogonal-projection blend

    combined = (1 - (a.b) / (2*|a|^2)) * a  +  (1 - (a.b) / (2*|b|^2)) * b

with zero-norm guards, folded over the process set's contributions in a
deterministic binary tree whose odd member passes through to the next
round (``_tree_fold``, reference l.125). ``adasum_allreduce`` (l.409)
takes a same-dtype group of tensors, all-gathers the group's flattened,
concatenated contributions (one ``all_gather``) and folds the rows on
every rank, so every rank ends with bitwise the same result.

The pair combine (``_pair_combine``, l.110) has two branches, chosen as
in the reference by HOROVOD_ADASUM_PALLAS and the dtype:

- the kernel: ``ops/adasum_kernels.adasum_pair_combine``, K1 then K2,
  the hand-written CUDA kernels on CUDA tensors and their plain versions
  on CPU tensors (f32, bf16, f16; the sums in f32);
- the reference's non-kernel branch: the dot products in the input
  dtype, the coefficients cast to it (float64 and complex take it, as
  there).

Routing, with the reference's knob values and answers:
HOROVOD_ADASUM_PALLAS "1"/"true"/"yes" forces the kernel and, under
HOROVOD_ADASUM_MODE=auto, the gather route; "0"/"false"/"no" forces the
non-kernel branch; "auto" means the kernel for CUDA tensors (the JAX
package's "on the TPU"). HOROVOD_ADASUM_MODE "gather" forces the gather
route. The vhdd route (vector halving, distance doubling) is not ported
yet: ``adasum_allreduce`` raises NotImplementedError where the reference
would take it (mode "vhdd", or "auto" without a forced kernel, at world
size above 1) and never reroutes.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..common import config as _config
from . import adasum_kernels
from .adasum_kernels import adasum_coeffs as _adasum_coeffs
from .process_set import ProcessSet

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _knob(name: str) -> str:
    """A knob from the initialized config (so ``init(config_overrides=)``
    works as for every knob), else from the environment."""
    from ..common import basics
    cfg = basics.state().config
    value = cfg[name] if cfg is not None else _config.env_value(name)
    return str(value).lower()


def _use_pallas(cuda: bool = False) -> bool:
    """HOROVOD_ADASUM_PALLAS: "1"/"true"/"yes" force the kernel,
    "0"/"false"/"no" the non-kernel branch; "auto" (default) is the
    kernel for CUDA tensors (``cuda``), as the reference's is the
    Pallas kernel on the TPU."""
    v = _knob("HOROVOD_ADASUM_PALLAS")
    if v in ("1", "true", "yes"):
        return True
    if v in ("0", "false", "no"):
        return False
    return bool(cuda)


def _pallas_forced() -> bool:
    """True when HOROVOD_ADASUM_PALLAS explicitly forces the kernel,
    which under HOROVOD_ADASUM_MODE=auto selects the gather route."""
    return _knob("HOROVOD_ADASUM_PALLAS") in ("1", "true", "yes")


def _pallas_ok_dtype(dtype) -> bool:
    """Dtypes the kernel takes without semantic loss: its f32
    accumulation would drop imaginary parts (complex) or precision
    (float64), so those take the non-kernel branch."""
    return dtype in _KERNEL_DTYPES


# HOROVOD_ADASUM_MODE: auto | vhdd | gather (set by init).
_adasum_mode = "auto"


def set_adasum_mode(mode: str) -> None:
    global _adasum_mode
    mode = str(mode or "auto").lower()
    if mode not in ("auto", "vhdd", "gather"):
        raise ValueError(
            f"HOROVOD_ADASUM_MODE must be auto/vhdd/gather, got {mode!r}")
    _adasum_mode = mode


def _pair_combine(a: torch.Tensor, b: torch.Tensor,
                  use_pallas: bool = False, out=None) -> torch.Tensor:
    """The Adasum combine for one pair. With ``use_pallas`` it is K1 and
    K2 (``out``, which may be ``a``, takes the result); otherwise the
    reference's non-kernel branch."""
    if use_pallas:
        return adasum_kernels.adasum_pair_combine(a, b, out)
    af, bf = a.reshape(-1), b.reshape(-1)
    dot = torch.vdot(af, bf).real.to(torch.float32)
    asq = torch.vdot(af, af).real.to(torch.float32)
    bsq = torch.vdot(bf, bf).real.to(torch.float32)
    ca, cb = _adasum_coeffs(dot, asq, bsq)
    return ca.to(a.dtype) * a + cb.to(b.dtype) * b


def _tree_fold(rows: Sequence[torch.Tensor],
               use_pallas: bool = False) -> torch.Tensor:
    """Deterministic binary-tree fold of the contributions ``rows``;
    the odd member passes through to the next round. The rows are not
    written: with the kernel, the first round's combines get new
    buffers and later rounds write into them."""
    items = list(rows)
    owned = set()
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            a = items[i]
            out = a if (use_pallas and id(a) in owned) else None
            c = _pair_combine(a, items[i + 1], use_pallas, out)
            owned.add(id(c))
            nxt.append(c)
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


def _scale(ts: List[torch.Tensor], f: float) -> List[torch.Tensor]:
    if f == 1.0:
        return ts
    return [t * torch.tensor(f, dtype=t.dtype, device=t.device)
            for t in ts]


def gather_rows(flat: torch.Tensor, pset: ProcessSet) -> List[torch.Tensor]:
    """Every member's ``flat`` (1-D, same length and dtype on every
    rank), in rank order: one ``all_gather`` into one buffer whose rows
    start on 16-byte boundaries. Under gloo a CUDA tensor goes through
    host memory and the rows come back to its device."""
    from ..common import basics
    total = flat.numel()
    stride = -(-total // 8) * 8
    staged = flat.is_cuda and basics.backend() == "gloo"
    src = flat.cpu() if staged else flat
    buf = torch.empty((pset.size, stride), dtype=flat.dtype,
                      device=src.device)
    dist.all_gather([buf[i, :total] for i in range(pset.size)], src,
                    group=pset.group)
    if staged:
        buf = buf.to(flat.device)
    return [buf[i, :total] for i in range(pset.size)]


def adasum_allreduce(tensors: List[torch.Tensor], pset: ProcessSet,
                     prescale: float = 1.0, postscale: float = 1.0
                     ) -> List[torch.Tensor]:
    """Adasum-allreduce a same-dtype group across the process set:
    prescale multiplies each contribution before the fold, postscale
    the combined result. Returns new tensors of the inputs' shapes."""
    tensors = list(tensors)
    if pset.size == 1:
        return _scale(_scale(tensors, prescale), postscale)
    if len({(t.dtype, t.device) for t in tensors}) != 1:
        raise ValueError("adasum_allreduce: the group must share one "
                         "dtype and device")
    complex_in = any(t.is_complex() for t in tensors)
    vhdd = not complex_in and (
        _adasum_mode == "vhdd"
        or (_adasum_mode == "auto" and not _pallas_forced()))
    if vhdd:
        raise NotImplementedError(
            f"Adasum's vhdd route (HOROVOD_ADASUM_MODE={_adasum_mode}, "
            f"HOROVOD_ADASUM_PALLAS={_knob('HOROVOD_ADASUM_PALLAS')}) is "
            f"not ported yet (ROADMAP A.1); the gather route runs under "
            f"HOROVOD_ADASUM_PALLAS=1 or HOROVOD_ADASUM_MODE=gather")
    tensors = _scale(tensors, prescale)
    use_pallas = _use_pallas(tensors[0].is_cuda) and all(
        _pallas_ok_dtype(t.dtype) for t in tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    red = _tree_fold(gather_rows(flat, pset), use_pallas)
    outs, off = [], 0
    for t in tensors:
        outs.append(red[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return _scale(outs, postscale)


def adasum_reference(contributions: List[np.ndarray]) -> np.ndarray:
    """Pure-numpy model of the tree fold, for tests (a copy of the
    reference's, l.466)."""
    def comb(a, b):
        dot = float(np.vdot(a, b))
        asq = float(np.vdot(a, a))
        bsq = float(np.vdot(b, b))
        ca = 1.0 if asq == 0 else 1.0 - dot / (2 * asq)
        cb = 1.0 if bsq == 0 else 1.0 - dot / (2 * bsq)
        return ca * a + cb * b

    items = [np.asarray(c, np.float64) for c in contributions]
    while len(items) > 1:
        nxt = [comb(items[i], items[i + 1])
               for i in range(0, len(items) - 1, 2)]
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]
