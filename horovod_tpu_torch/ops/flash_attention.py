"""Flash attention: the hand-written CUDA kernels' wrappers, their launch
counters, their plain PyTorch versions, and the autograd Function that
joins forward and backward.

Counterparts of the TPU kernels the JAX package reaches through
``horovod_tpu/parallel/ring_attention.py`` ``flash_attention_path``
(jax.experimental.pallas.ops.tpu.flash_attention): its forward
(``csrc/flash_attention_fwd.cu``) and its dK/dV and dQ backward kernels
(``csrc/flash_attention_bwd.cu``). Each source's header says what bounds
it on the card and what its design does about that.

``flash_attention_fwd(q, k, v, causal, scale) -> (o, lse)``:
q, k, v and o are (B, L, H, D) (strides are read, no transposed
copies), o is in q's dtype, lse is (B, H, L) float32.
``flash_attention_bwd(q, k, v, o, lse, do, causal, scale) -> (dq, dk,
dv)`` takes the forward's inputs and outputs and o's cotangent ``do``
and returns the gradients in q's dtype and layout. The kernels take any
sequence length L >= 1 (a ragged last tile is masked in the kernel), k
and v shaped like q, in bfloat16, float16 or float32, and any head dim
1 <= D <= 256. The kernels are built for D in {64, 128, 256}
(``KERNEL_HEAD_DIMS``); on CUDA tensors any other D is zero-padded to
the next of them (``pad_head_dim``), launched with the caller's scale
(default D ** -0.5 of the real D), and the outputs are cut back to D
(``cut_head_dim``). The pad is exact: zero columns of q and k add exact
zeros to q k^T, zero columns of v give zero columns of o; the
backward takes di = rowsum(o dO) from the unpadded o and dO, and with
zero columns of q, k, v and dO the padded columns of dq, dk and dv are
zero. The pad is one copy of each padded input per call; at 64, 128 and
256 nothing is copied. Above 256 is a declared difference from the JAX
package, whose einsum path computes any D (its kernel path stops at 256
too): it raises ValueError before any launch.

Where they run is decided by where the tensors lie, and nowhere else:
CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. The kernels are built from the repo's sources with nvcc at first
use, one library per source, into ``horovod_tpu_torch/_build/``
(``ops/_cuda_build.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._cuda_build import load_library

KERNEL_HEAD_DIMS = (64, 128, 256)   # the widths the kernels are built for
MAX_HEAD_DIM = KERNEL_HEAD_DIMS[-1]
# The code each 16-bit entry (hvd_flash_attention_fwd, _bwd_dkv and
# _bwd_dq) returns for a failed tensor-map encode, plus the CUresult.
_TENSOR_MAP_ERROR = 100000
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}

# Kernel launches since import (or since the caller last reset them), one
# counter per kernel: a run reads them to show its path went through the
# kernels. ``launches`` counts the forward.
launches = 0
launches_dkv = 0
launches_dq = 0


def check_inputs(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """Raise ValueError unless the kernels take these inputs."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be (B, L, H, D), "
                         f"got shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} and v "
            f"{tuple(v.shape)} must match q {tuple(q.shape)} (repeat "
            f"GQA heads first)")
    _, L, _, D = q.shape
    if L < 1:
        raise ValueError(f"flash_attention: needs L >= 1, got L={L}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention: the CUDA kernels take a head dim "
            f"1 <= D <= {MAX_HEAD_DIM}, got D={D}; larger head dims are a "
            f"declared difference from the JAX package's einsum path, "
            f"which computes any D (its kernel path also stops at "
            f"{MAX_HEAD_DIM})")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: q, k, v must share one dtype of "
            f"{sorted(str(d) for d in _DTYPE_CODES)}, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}; other dtypes (float64 "
            f"among them) are a declared difference from the JAX "
            f"package's einsum path, which computes them")
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"flash_attention: q, k, v lie on {q.device}, "
            f"{k.device}, {v.device}")


def _check_backward_inputs(q: torch.Tensor, o: torch.Tensor,
                           lse: torch.Tensor, do: torch.Tensor) -> None:
    """o and do must be like q, lse the forward's (B, H, L) float32."""
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"flash_attention_bwd: {name} is {tuple(t.shape)} "
                f"{t.dtype} on {t.device}, q is {tuple(q.shape)} "
                f"{q.dtype} on {q.device}")
    B, L, H, _ = q.shape
    if lse.shape != (B, H, L) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(
            f"flash_attention_bwd: lse must be ({B}, {H}, {L}) float32 on "
            f"{q.device}, got {tuple(lse.shape)} {lse.dtype} on "
            f"{lse.device}")


def _device_kind(q: torch.Tensor, what: str) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors on {q.device} are neither CPU "
                         f"nor CUDA")
    return q.device.type


def _blockwise_scores(q: torch.Tensor, k: torch.Tensor,
                      scale: float) -> torch.Tensor:
    # q: (B, Lq, H, D), k: (B, Lk, H, D) -> (B, H, Lq, Lk) float32
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def _masked(s: torch.Tensor, causal: bool) -> torch.Tensor:
    if not causal:
        return s
    mask = torch.ones(s.shape[-2:], dtype=torch.bool,
                      device=s.device).tril()
    return s.masked_fill(~mask, float("-inf"))


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: float32 scores,
    the causal mask, log-sum-exp, same layout and outputs. It is also
    the forward of the port's attention on CPU tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _masked(_blockwise_scores(q, k, scale), causal)
    lse = torch.logsumexp(s, dim=-1)                       # (B, H, L)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernels' function in plain PyTorch, in float32, with
    their layout and outputs: the Pallas library's ``mha_reference_bwd``
    with ``scale`` applied. P is recomputed from the saved lse."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p = torch.exp(_masked(_blockwise_scores(q, k, scale), causal)
                  - lse[..., None])                       # (B, H, Lq, Lk)
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    di = backward_di(o, do)                                # (B, H, Lq)
    ds = p * (dp - di[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of attention over (B, L, H, D) inputs; see the module
    docstring for shapes, types and where it runs."""
    check_inputs(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _device_kind(q, "flash_attention_fwd") == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    return _launch_fwd(q, k, v, causal, float(scale))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """(dq, dk, dv) of attention given the forward's inputs, its (o,
    lse) and o's cotangent ``do``; see the module docstring. On CUDA
    tensors it launches the dK/dV kernel, then the dQ kernel."""
    check_inputs(q, k, v)
    _check_backward_inputs(q, o, lse, do)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _device_kind(q, "flash_attention_bwd") == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    return _launch_bwd(q, k, v, o, lse, do, causal, float(scale))


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) whose gradient is the flash backward: the
    forward saves (q, k, v, o, lse) and the backward recomputes P from
    lse. CUDA tensors run the kernels (``flash_attention_fwd`` /
    ``flash_attention_bwd``); CPU tensors run their plain versions, which
    take any shape, as the JAX package's einsum path does.

    ``FlashAttention.apply(q, k, v, causal, scale) -> o``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        if _device_kind(q, "FlashAttention") == "cpu":
            o, lse = flash_attention_fwd_plain(q, k, v, causal, scale)
        else:
            o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = (flash_attention_bwd_plain if q.device.type == "cpu"
               else flash_attention_bwd)
        dq, dk, dv = bwd(q, k, v, o, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def _readable(t: torch.Tensor) -> bool:
    """The kernels read a head dim that is contiguous and 16-byte
    aligned, with (b, l, h) strides that are multiples of 8 elements."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:3]))


def _check_readable(what: str, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not _readable(t):
            raise ValueError(
                f"{what}: {name} needs a contiguous, 16-byte aligned head "
                f"dim and strides that are multiples of 8, got strides "
                f"{t.stride()}")


def kernel_head_dim(D: int) -> int:
    """The narrowest kernel width that holds head dim D (<= 256)."""
    return next(w for w in KERNEL_HEAD_DIMS if w >= D)


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """t with its head dim zero-padded to ``width``: one contiguous
    copy, or t itself when it is already that wide."""
    if t.shape[-1] == width:
        return t
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def cut_head_dim(t: torch.Tensor, D: int) -> torch.Tensor:
    """The first D columns of t's head dim, contiguous; t itself when it
    is D wide."""
    if t.shape[-1] == D:
        return t
    return t[..., :D].contiguous()


def _launch_fwd(q, k, v, causal: bool, scale: float):
    global launches
    D = q.shape[-1]
    q, k, v = (pad_head_dim(t, kernel_head_dim(D)) for t in (q, k, v))
    _check_readable("flash_attention_fwd", q=q, k=k, v=v)
    lib = load_library("flash_attention_fwd")
    B, L, H, Dp = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hvd_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _DTYPE_CODES[q.dtype], B, L, H, Dp,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(bool(causal)), scale, stream)
    if err >= _TENSOR_MAP_ERROR:
        raise RuntimeError(f"flash_attention_fwd: tensor-map encode failed "
                           f"with CUresult {err - _TENSOR_MAP_ERROR} "
                           f"(strides {q.stride()}, {k.stride()}, "
                           f"{v.stride()})")
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd: kernel launch failed "
                           f"with cudaError_t {err}")
    launches += 1
    return cut_head_dim(o, D), lse


def backward_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(o * do), (B, H, L) float32: computed outside the
    kernels, as the TPU library does (flash_attention.py's
    _flash_attention_bwd)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _launch_bwd(q, k, v, o, lse, do, causal: bool, scale: float):
    D = q.shape[-1]
    lse = lse.contiguous()
    di = backward_di(o, do)           # o itself is not read by the kernels
    q, k, v, do = (pad_head_dim(t, kernel_head_dim(D))
                   for t in (q, k, v, do))
    _check_readable("flash_attention_bwd", q=q, k=k, v=v)
    if not _readable(do):
        do = do.contiguous()          # a copy the kernels can read
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, causal, scale)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, di, causal, scale)
    return tuple(cut_head_dim(t, D) for t in (dq, dk, dv))


def _bwd_call(entry: str, q, k, v, do, lse, di, outs, causal: bool,
              scale: float) -> None:
    """Launch one backward kernel on q's device and current stream.
    The caller has checked shapes, types and strides (lse and di are
    contiguous (B, H, L) float32)."""
    B, L, H, D = q.shape
    fn = getattr(load_library("flash_attention_bwd"), entry)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), di.data_ptr(),
                 *(t.data_ptr() for t in outs), _DTYPE_CODES[q.dtype], B, L,
                 H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *do.stride()[:3], int(bool(causal)), scale,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err >= _TENSOR_MAP_ERROR:
        raise RuntimeError(f"flash_attention_bwd: {entry}: tensor-map "
                           f"encode failed with CUresult "
                           f"{err - _TENSOR_MAP_ERROR} (strides "
                           f"{q.stride()}, {k.stride()}, {v.stride()}, "
                           f"{do.stride()})")
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd: {entry} launch failed "
                           f"with cudaError_t {err}")


def flash_attention_bwd_dkv(q, k, v, do, lse, di, causal: bool,
                            scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the dK/dV kernel, on CUDA tensors that
    ``flash_attention_bwd`` has checked and prepared."""
    global launches_dkv
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
              for _ in range(2))
    _bwd_call("hvd_flash_attention_bwd_dkv", q, k, v, do, lse, di, (dk, dv),
              causal, scale)
    launches_dkv += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, di, causal: bool,
                           scale: float) -> torch.Tensor:
    """dq from the dQ kernel, on CUDA tensors that
    ``flash_attention_bwd`` has checked and prepared."""
    global launches_dq
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_call("hvd_flash_attention_bwd_dq", q, k, v, do, lse, di, (dq,),
              causal, scale)
    launches_dq += 1
    return dq
