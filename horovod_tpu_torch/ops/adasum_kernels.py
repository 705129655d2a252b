"""The Adasum pair combine: the hand-written CUDA kernels K1 and K2, their
wrappers and launch counters, and their plain PyTorch versions.

Counterpart of ``horovod_tpu/ops/pallas_kernels.py``: K1
(``adasum_partials``, csrc/adasum_pair_combine.cu) replaces
``_partials_kernel`` (l.50) and K2 (``adasum_scaled_add``) replaces
``_scaled_add_kernel`` (l.70); ``adasum_pair_combine`` (l.79) is the JAX
function of that name, the two passes in a row:

    out = (1 - a.b/(2|a|^2)) * a + (1 - a.b/(2|b|^2)) * b

with the zero-norm guards (a zero norm gives the coefficient 1), the
three sums accumulated in float32 whatever the input dtype (float32,
bfloat16, float16), and one rounding of the result to the input dtype.

``adasum_partials(a, b) -> stats``: a (5,) float32 tensor on a's device,
``[ca, cb, a.b, |a|^2, |b|^2]``. ``adasum_scaled_add(stats, a, b, out)``
writes ``cast(ca * a + cb * b)`` into ``out`` (a new tensor by default;
``out`` may be ``a``). Both take tensors of any shape, read as flat
vectors; a and b must match in shape and dtype.

Where they run is decided by where the tensors lie, and nowhere else:
CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. On the card each wrapper adds one to its launch counter where it
launches its kernel (K1's two stages count as one launch).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda_build

DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}

# Kernel launches since import (or since the caller last reset them).
launches_partials = 0
launches_scaled_add = 0


def _check(what: str, a: torch.Tensor, b: torch.Tensor) -> str:
    """Raise ValueError unless the kernels take (a, b); return the
    device type."""
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(
            f"{what}: a {tuple(a.shape)} {a.dtype} on {a.device} and b "
            f"{tuple(b.shape)} {b.dtype} on {b.device} must match")
    if a.dtype not in DTYPE_CODES:
        raise ValueError(
            f"{what}: dtype {a.dtype} is not one of "
            f"{sorted(str(d) for d in DTYPE_CODES)} (the JAX kernel's "
            f"_pallas_ok_dtype)")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors on {a.device} are neither CPU "
                         f"nor CUDA")
    return a.device.type


def adasum_coeffs(dot: torch.Tensor, asq: torch.Tensor,
                  bsq: torch.Tensor):
    """The Adasum blend coefficients with the zero-norm guards, in
    float32: the JAX package's ``_adasum_coeffs`` (ops/adasum.py:240)."""
    one = torch.ones((), dtype=torch.float32, device=dot.device)
    ca = torch.where(asq == 0, one,
                     1.0 - dot / (2.0 * torch.clamp_min(asq, 1e-30)))
    cb = torch.where(bsq == 0, one,
                     1.0 - dot / (2.0 * torch.clamp_min(bsq, 1e-30)))
    return ca, cb


def adasum_partials_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1's function in plain PyTorch: float32 sums, then the guarded
    coefficients; ``[ca, cb, a.b, |a|^2, |b|^2]``."""
    af, bf = a.reshape(-1).float(), b.reshape(-1).float()
    dot, asq, bsq = (af * bf).sum(), (af * af).sum(), (bf * bf).sum()
    ca, cb = adasum_coeffs(dot, asq, bsq)
    return torch.stack([ca, cb, dot, asq, bsq])


def adasum_scaled_add_plain(stats: torch.Tensor, a: torch.Tensor,
                            b: torch.Tensor,
                            out: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """K2's function in plain PyTorch: ``cast(ca * a + cb * b)``, each
    product rounded to float32 before the add."""
    res = (stats[0] * a.float() + stats[1] * b.float()).to(a.dtype)
    if out is None:
        return res
    out.copy_(res)
    return out


def adasum_pair_combine_plain(a: torch.Tensor,
                              b: torch.Tensor) -> torch.Tensor:
    """``adasum_pair_combine`` through the plain versions."""
    return adasum_scaled_add_plain(adasum_partials_plain(a, b), a, b)


def _contiguous_flat(what: str, t: torch.Tensor) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{what}: the kernels read contiguous tensors, "
                         f"got strides {t.stride()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def adasum_partials(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1: ``[ca, cb, a.b, |a|^2, |b|^2]`` as a (5,) float32 tensor on
    a's device; see the module docstring."""
    global launches_partials
    if _check("adasum_partials", a, b) == "cpu":
        return adasum_partials_plain(a, b)
    _contiguous_flat("adasum_partials", a)
    _contiguous_flat("adasum_partials", b)
    lib = _cuda_build.load_library("adasum_pair_combine")
    n, code = a.numel(), DTYPE_CODES[a.dtype]
    blocks = lib.hvd_adasum_partials_blocks(n, code)
    scratch = torch.empty(3 * blocks, dtype=torch.float32, device=a.device)
    stats = torch.empty(5, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.hvd_adasum_partials(
            a.data_ptr(), b.data_ptr(), scratch.data_ptr(),
            stats.data_ptr(), code, n, _stream(a))
    if err != 0:
        raise RuntimeError(f"adasum_partials: kernel launch failed with "
                           f"cudaError_t {err}")
    launches_partials += 1
    return stats


def adasum_scaled_add(stats: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: ``cast(stats[0] * a + stats[1] * b)`` into ``out`` (new by
    default; may be ``a``); see the module docstring."""
    global launches_scaled_add
    kind = _check("adasum_scaled_add", a, b)
    if out is not None and (out.shape != a.shape or out.dtype != a.dtype
                            or out.device != a.device):
        raise ValueError(f"adasum_scaled_add: out {tuple(out.shape)} "
                         f"{out.dtype} on {out.device} must be like a")
    if stats.dtype != torch.float32 or stats.numel() < 2 \
            or stats.device != a.device:
        raise ValueError(f"adasum_scaled_add: stats must hold float32 "
                         f"[ca, cb, ...] on {a.device}, got "
                         f"{tuple(stats.shape)} {stats.dtype} on "
                         f"{stats.device}")
    if kind == "cpu":
        return adasum_scaled_add_plain(stats, a, b, out)
    if out is None:
        out = torch.empty_like(a, memory_format=torch.contiguous_format)
    for t in (a, b, out, stats):
        _contiguous_flat("adasum_scaled_add", t)
    lib = _cuda_build.load_library("adasum_pair_combine")
    with torch.cuda.device(a.device):
        err = lib.hvd_adasum_scaled_add(
            a.data_ptr(), b.data_ptr(), stats.data_ptr(), out.data_ptr(),
            DTYPE_CODES[a.dtype], a.numel(), _stream(a))
    if err != 0:
        raise RuntimeError(f"adasum_scaled_add: kernel launch failed with "
                           f"cudaError_t {err}")
    launches_scaled_add += 1
    return out


def adasum_pair_combine(a: torch.Tensor, b: torch.Tensor,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused Adasum combine of two equal-shape contributions: K1,
    then K2 (the JAX ``adasum_pair_combine``). ``out`` may be ``a``."""
    return adasum_scaled_add(adasum_partials(a, b), a, b, out)
