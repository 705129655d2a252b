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
and returns the gradients in q's dtype and layout. Supported shapes are
the ones the JAX package's ``_flash_supported`` admits (D in
{64, 128, 256}, L % 128 == 0, k and v shaped like q), in bfloat16 or
float32; anything else raises ValueError before any launch.

Where they run is decided by where the tensors lie, and nowhere else:
CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. The kernels are built from the repo's sources with nvcc at first
use, one library per source, into ``horovod_tpu_torch/_build/``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
HEADERS = ("flash_common.cuh",)

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# causal, scale, stream
_TAIL = [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
# Library (= source file stem) -> its C entry points' argument types.
LIBRARIES = {
    "flash_attention_fwd": {
        "hvd_flash_attention_fwd": [_PTR] * 5 + [_INT] * 5 + [_LL] * 9
        + _TAIL},
    "flash_attention_bwd": {
        "hvd_flash_attention_bwd_dkv": [_PTR] * 8 + [_INT] * 5 + [_LL] * 12
        + _TAIL,
        "hvd_flash_attention_bwd_dq": [_PTR] * 7 + [_INT] * 5 + [_LL] * 12
        + _TAIL},
}

SUPPORTED_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

# Kernel launches since import (or since the caller last reset them), one
# counter per kernel: a run reads them to show its path went through the
# kernels. ``launches`` counts the forward.
launches = 0
launches_dkv = 0
launches_dq = 0

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


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
    if D not in SUPPORTED_HEAD_DIMS or L % 128 != 0:
        raise ValueError(
            f"flash_attention: needs D in {SUPPORTED_HEAD_DIMS} and "
            f"L % 128 == 0, got L={L}, D={D}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: q, k, v must share one dtype of "
            f"{sorted(str(d) for d in _DTYPE_CODES)}, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
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


def _launch_fwd(q, k, v, causal: bool, scale: float):
    global launches
    _check_readable("flash_attention_fwd", q=q, k=k, v=v)
    lib = load_library("flash_attention_fwd")
    B, L, H, D = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hvd_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _DTYPE_CODES[q.dtype], B, L, H, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(bool(causal)), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd: kernel launch failed "
                           f"with cudaError_t {err}")
    launches += 1
    return o, lse


def backward_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(o * do), (B, H, L) float32: computed outside the
    kernels, as the TPU library does (flash_attention.py's
    _flash_attention_bwd)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _launch_bwd(q, k, v, o, lse, do, causal: bool, scale: float):
    _check_readable("flash_attention_bwd", q=q, k=k, v=v)
    if not _readable(do):
        do = do.contiguous()          # a copy the kernels can read
    lse = lse.contiguous()
    di = backward_di(o, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, causal, scale)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, di, causal, scale)
    return dq, dk, dv


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


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "flash_attention: nvcc not found (PATH, CUDA_HOME or "
            "/usr/local/cuda/bin); the CUDA kernels cannot be built")
    return path


def _source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    """Where the build of library ``name`` goes: the file name carries
    the hash of its source, the shared headers and the flags, so an
    edited source is rebuilt."""
    tag = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (_source_path(name),
                 *(os.path.join(CSRC_DIR, h) for h in HEADERS)):
        with open(path, "rb") as f:
            tag.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{tag.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> Dict[str, str]:
    """Compile every library whose current build is missing, one nvcc
    per source, all started together; concurrent builds serialise on
    a lock file. Returns each library's path."""
    paths = {name: library_path(name) for name in LIBRARIES}
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        jobs = []
        for name, path in paths.items():
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _source_path(name)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            jobs.append((name, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for name, path, tmp, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{out}{err}")
                continue
            if verbose:
                print(f"nvcc {name}:\n{out}{err}", flush=True)
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("flash_attention: nvcc failed for "
                               + "\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load library ``name`` once."""
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(build()[name])
            for fn_name, argtypes in LIBRARIES[name].items():
                fn = getattr(lib, fn_name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _libs[name] = lib
    return _libs[name]
