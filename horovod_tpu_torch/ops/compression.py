"""Gradient compression on the wire: the casts and PowerSGD.

Port of ``horovod_tpu/ops/compression.py``. The cast half (l.46-90,
``Compression`` l.173): ``Compression.none`` sends a tensor as it is;
``Compression.fp16`` and ``Compression.bf16`` cast a floating tensor to
float16 or bfloat16 for the collective and back to its own dtype after
(integer and complex tensors travel as they are). ``compress(t)``
returns ``(wire, ctx)`` and ``decompress(wire, ctx)`` undoes it.
``wire_dtype_of`` (l.90) and ``compressor_for`` (l.123) are the
reference's: the negotiated controller keys fusion on the wire dtype
and rebuilds a joined rank's compressor from the agreed signature.

The registry and PowerSGD: ``PowerSGD`` (l.140), ``CompressionSpec``
(l.185), ``resolve_compression`` (l.212) and ``spec_of`` (l.257) parse
the HOROVOD_COMPRESSION knob family; ``matrix_shape`` (l.284),
``powersgd_eligible`` (l.309), ``effective_rank`` (l.328),
``gram_orthogonalize`` (l.335), ``init_q`` (l.353),
``powersgd_wire_elements`` (l.367) and ``powersgd_reduce`` (l.376) are
the low-rank compression with error feedback (Vogels et al., NeurIPS
2019) that both reduction planes run, the bucketed train step
(``parallel/train.py``) and ``DistributedOptimizer``:

    M   = grad.reshape(n, m) + residual        # error feedback in
    P   = M @ Q                                # allreduce (n x r wire)
    P   = gram_orthogonalize(P)                # one Gram-matrix orth
    Q'  = M.T @ P                              # allreduce (m x r wire)
    out = P @ Q'.T                             # ~= sum_ranks(M)
    e'  = M - out / n_ranks                    # error feedback out

They are plain functions on tensors, run on the device the tensors lie
on. The products stay ``torch.matmul`` (the JAX package computes them
outside any Pallas kernel); the orthogonalization is
``torch.linalg.cholesky_ex`` and ``solve_triangular`` on the device,
with the reference's jitter, and no error check that would wait for
the card.

Declared difference: ``init_q`` draws the warm-start Q from a
``torch.Generator`` on the CPU seeded from the reference's 0x9d5c and
the leaf index (the reference's threefry draw needs jax), so the same
leaf starts from another Q than in the JAX package; every rank draws
the same one, as there. The tests give both sides the same Q.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .bucketing import dtype_name


class Compressor:
    @staticmethod
    def compress(tensor):
        """Returns (compressed_tensor, context_for_decompress)."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype = None

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point():
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class FP16Compressor(_CastCompressor):
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    wire_dtype = torch.bfloat16


def wire_dtype_of(compression, dtype: torch.dtype) -> torch.dtype:
    """The dtype ``compression`` puts on the wire for ``dtype``
    inputs, without casting: a cast compressor's wire dtype for
    floating inputs, else ``dtype``."""
    wd = getattr(compression, "wire_dtype", None)
    if wd is not None and dtype.is_floating_point:
        return wd
    return dtype


def compressor_for(raw_dtype: torch.dtype, wire_dtype: torch.dtype):
    """The compressor class whose ``compress`` maps ``raw_dtype`` to
    ``wire_dtype`` (a joined rank's zero-fill uses the live ranks')."""
    if wire_dtype == raw_dtype:
        return NoneCompressor
    if wire_dtype == torch.float16:
        return FP16Compressor
    if wire_dtype == torch.bfloat16:
        return BF16Compressor
    raise ValueError(
        f"no compressor maps {raw_dtype} to wire dtype {wire_dtype}")


class PowerSGD:
    """PowerSGD marker for the eager plane
    (``DistributedOptimizer(..., compression=Compression.powersgd(
    rank=4))``). Carries the config only: the warm Q factors and the
    error-feedback residuals live in the optimizer. No ``wire_dtype``:
    the cast-fusion keys do not apply, the wire is the rank-r factor
    pair, reduced as exact float32."""

    def __init__(self, rank: Optional[int] = None,
                 min_elements: Optional[int] = None,
                 warmup_steps: Optional[int] = None):
        spec = resolve_compression(
            "powersgd", rank=rank, min_elements=min_elements,
            warmup_steps=warmup_steps)
        self.rank = spec.rank
        self.min_elements = spec.min_elements
        self.warmup_steps = spec.warmup_steps

    @property
    def spec(self) -> "CompressionSpec":
        return CompressionSpec("powersgd", self.rank,
                               self.min_elements, self.warmup_steps)

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"PowerSGD(rank={self.rank}, "
                f"min_elements={self.min_elements}, "
                f"warmup_steps={self.warmup_steps})")


class Compression:
    """Namespace matching hvd.Compression."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    powersgd = PowerSGD


# ---------------------------------------------------------------------------
# Registry: the HOROVOD_COMPRESSION knob family -> CompressionSpec

class CompressionSpec(NamedTuple):
    """Parsed per-bucket compression config. ``kind`` is "none",
    "fp16", "bf16" or "powersgd"; ``rank``, ``min_elements`` and
    ``warmup_steps`` matter for powersgd only. ``tag()`` is the short
    form the bucket digest and ``OverlapPlan.bucket_compression`` carry
    ("powersgd:4")."""
    kind: str
    rank: int
    min_elements: int
    warmup_steps: int

    def tag(self) -> str:
        return (f"powersgd:{self.rank}" if self.kind == "powersgd"
                else self.kind)


def _knob(env: str):
    """A knob from the environment through its registry parser, else
    its default (the reference's read: the environment, not the live
    Config)."""
    from ..common.config import env_value, knob_default
    try:
        return env_value(env)
    except Exception:
        return knob_default(env)


def resolve_compression(name: Optional[str] = None, *,
                        rank: Optional[int] = None,
                        min_elements: Optional[int] = None,
                        warmup_steps: Optional[int] = None
                        ) -> CompressionSpec:
    """Parse the HOROVOD_COMPRESSION knob family (or explicit
    overrides) into a CompressionSpec. Accepted spellings: "none",
    "fp16", "bf16", "powersgd", "powersgd:4", "powersgd(rank=4)", in
    any case. Unknown names raise: a typo must not train uncompressed."""
    raw = (str(_knob("HOROVOD_COMPRESSION")) if name is None
           else str(name)).strip().lower()
    r = None
    if raw.startswith("powersgd"):
        rest = raw[len("powersgd"):]
        kind = "powersgd"
        if rest.startswith(":"):
            r = int(rest[1:])
        elif rest.startswith("(") and rest.endswith(")"):
            body = rest[1:-1].strip()
            if body.startswith("rank="):
                body = body[len("rank="):]
            r = int(body)
        elif rest:
            raise ValueError(
                f"unparseable HOROVOD_COMPRESSION value {raw!r}")
    elif raw in ("none", "fp16", "bf16"):
        kind = raw
    else:
        raise ValueError(
            f"unknown HOROVOD_COMPRESSION value {raw!r} (expected "
            f"none / fp16 / bf16 / powersgd[:rank])")
    if rank is not None:
        r = int(rank)
    if r is None:
        r = int(_knob("HOROVOD_COMPRESSION_RANK"))
    me = (int(_knob("HOROVOD_COMPRESSION_MIN_ELEMENTS"))
          if min_elements is None else int(min_elements))
    ws = (int(_knob("HOROVOD_COMPRESSION_WARMUP_STEPS"))
          if warmup_steps is None else int(warmup_steps))
    if kind == "powersgd" and r < 1:
        raise ValueError(f"powersgd rank must be >= 1, got {r}")
    return CompressionSpec(kind, r, me, ws)


def spec_of(compression) -> CompressionSpec:
    """CompressionSpec of any eager-API ``compression=`` value: a
    compressor class (none/fp16/bf16), a PowerSGD instance, a spec, a
    registry string, or None (the knob's value)."""
    if compression is None:
        return resolve_compression()
    if isinstance(compression, CompressionSpec):
        return compression
    if isinstance(compression, PowerSGD):
        return compression.spec
    if isinstance(compression, str):
        return resolve_compression(compression)
    if isinstance(compression, type) and issubclass(compression,
                                                    Compressor):
        if compression is NoneCompressor:
            return resolve_compression("none")
        if compression is FP16Compressor:
            return resolve_compression("fp16")
        if compression is BF16Compressor:
            return resolve_compression("bf16")
    raise ValueError(f"unrecognized compression {compression!r}")


# ---------------------------------------------------------------------------
# PowerSGD: shapes, eligibility and wire accounting (pure functions of
# static shapes, so every rank derives the same)

def matrix_shape(shape: Sequence[int]) -> Tuple[int, int]:
    """The (n, m) 2-D view PowerSGD compresses: of the folds at an axis
    boundary, the one whose two sides are closest (the leading fold
    when none is closer). Defined for ndim >= 2."""
    dims = tuple(int(s) for s in shape)
    best = (int(dims[0]), int(np.prod(dims[1:])))
    for k in range(1, len(dims)):
        n = int(np.prod(dims[:k]))
        m = int(np.prod(dims[k:]))
        if abs(n - m) < abs(best[0] - best[1]):
            best = (n, m)
    return best


def _floating(dtype) -> bool:
    return dtype_name(dtype).startswith(("float", "bfloat"))


def powersgd_eligible(shape, dtype, min_elements: int) -> bool:
    """Whether one leaf takes the low-rank path: a floating leaf of
    ndim >= 2, at least ``min_elements`` elements, and a matrix view
    with both sides >= 2. Everything else takes the exact path."""
    shape = tuple(int(s) for s in shape)
    if len(shape) < 2:
        return False
    if not _floating(dtype):
        return False
    if int(np.prod(shape)) < int(min_elements):
        return False
    n, m = matrix_shape(shape)
    return n >= 2 and m >= 2


def effective_rank(shape: Sequence[int], rank: int) -> int:
    """The rank one leaf uses: r capped by both matrix sides."""
    n, m = matrix_shape(shape)
    return max(1, min(int(rank), n, m))


def powersgd_wire_elements(shape: Sequence[int],
                           rank: int) -> Tuple[int, int]:
    """(P elements, Q elements) one leaf puts on its bucket's two
    float32 factor allreduces."""
    n, m = matrix_shape(shape)
    r = effective_rank(shape, rank)
    return n * r, m * r


# ---------------------------------------------------------------------------
# PowerSGD: the math, on the tensors' own device

def gram_orthogonalize(p: torch.Tensor) -> torch.Tensor:
    """Orthogonalize the columns of ``p`` (n x r) in one pass: the
    Cholesky factor L of G = p^T p (plus the reference's jitter,
    trace(G) * 1e-7 + 1e-30, which keeps G positive definite when
    columns are zero) and p L^-T. ``cholesky_ex`` does not check its
    result on the host, so nothing waits for the card."""
    p = p.to(torch.float32)
    r = p.shape[-1]
    g = p.T @ p
    jitter = torch.trace(g) * 1e-7 + 1e-30
    chol, _ = torch.linalg.cholesky_ex(
        g + jitter * torch.eye(r, dtype=g.dtype, device=g.device))
    return torch.linalg.solve_triangular(chol, p.T, upper=False).T


def init_q(shape: Sequence[int], rank: int, leaf_index: int,
           device) -> torch.Tensor:
    """Warm-start Q (m x r, float32) of one leaf on ``device``: a
    standard normal draw from a CPU ``torch.Generator`` seeded with
    0x9d5c and the leaf index, orthogonalized once on the CPU, so every
    rank and device gets the same bytes."""
    _, m = matrix_shape(shape)
    r = effective_rank(shape, rank)
    gen = torch.Generator(device="cpu").manual_seed(
        (0x9d5c << 32) + int(leaf_index))
    q = torch.randn((m, r), generator=gen, dtype=torch.float32)
    return gram_orthogonalize(q).to(device)


def powersgd_pack(mats: List[torch.Tensor]) -> torch.Tensor:
    """A list of factors as one flat float32 wire array."""
    return (torch.cat([x.reshape(-1) for x in mats]) if len(mats) > 1
            else mats[0].reshape(-1))


def _unpacked(flat: torch.Tensor, like: List[torch.Tensor]
              ) -> List[torch.Tensor]:
    outs, off = [], 0
    for x in like:
        outs.append(flat[off:off + x.numel()].view(x.shape))
        off += x.numel()
    return outs


def powersgd_compress(mats, qs, es):
    """The first half of a round: ``(ms, ps)`` with M = mat + e in
    float32 and P = M @ Q per leaf. The packed P is what goes on the
    wire (``powersgd_pack``)."""
    ms = [m.to(torch.float32) + e for m, e in zip(mats, es)]
    return ms, [m @ q for m, q in zip(ms, qs)]


def powersgd_project(ms, ps, red_p: torch.Tensor) -> Tuple[list, list]:
    """The middle of a round: the reduced packed P unpacked and
    orthogonalized per leaf, and Q' = M^T P. Returns (ps, qs)."""
    out_ps = [gram_orthogonalize(x) for x in _unpacked(red_p, ps)]
    return out_ps, [m.T @ p for m, p in zip(ms, out_ps)]


def powersgd_decompress(ms, ps, qns, red_q: torch.Tensor, n_ranks: int):
    """The end of a round: (outs, new qs, new es) from the reduced
    packed Q'; out = P Q'^T approximates the sum over ranks and
    e' = M - out / n_ranks."""
    new_qs = _unpacked(red_q, qns)
    outs = [p @ q.T for p, q in zip(ps, new_qs)]
    inv = 1.0 / float(max(1, n_ranks))
    new_es = [m - o * torch.tensor(inv, dtype=o.dtype, device=o.device)
              for m, o in zip(ms, outs)]
    return outs, new_qs, new_es


def powersgd_reduce(mats, qs, es,
                    psum_fn: Callable[[torch.Tensor], torch.Tensor],
                    n_ranks: int):
    """One PowerSGD round over a bucket of 2-D matrices, both planes'
    arithmetic. ``mats`` are this rank's gradient matrices (already
    (n_i, m_i)), ``qs`` the warm Q factors, ``es`` the residuals;
    ``psum_fn(flat)`` sums one packed 1-D float32 array over the ranks.
    Returns (sum-semantics decompressed mats, new qs, new es)."""
    ms, ps = powersgd_compress(mats, qs, es)
    out_ps, qns = powersgd_project(ms, ps, psum_fn(powersgd_pack(ps)))
    return powersgd_decompress(ms, out_ps, qns,
                               psum_fn(powersgd_pack(qns)), n_ranks)
