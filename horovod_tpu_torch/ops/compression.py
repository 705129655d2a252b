"""Gradient compression on the wire: the casts.

Port of the cast half of ``horovod_tpu/ops/compression.py`` (l.46-90,
``Compression`` l.173): ``Compression.none`` sends a tensor as it is;
``Compression.fp16`` and ``Compression.bf16`` cast a floating tensor to
float16 or bfloat16 for the collective and back to its own dtype after
(integer and complex tensors travel as they are). ``compress(t)``
returns ``(wire, ctx)`` and ``decompress(wire, ctx)`` undoes it.
``wire_dtype_of`` (l.90) and ``compressor_for`` (l.123) are the
reference's: the negotiated controller keys fusion on the wire dtype
and rebuilds a joined rank's compressor from the agreed signature.

PowerSGD and the HOROVOD_COMPRESSION registry are not ported yet
(ROADMAP A.8): ``Compression.powersgd(...)`` raises NotImplementedError.
"""

from __future__ import annotations

import torch


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


def powersgd(*args, **kwargs):
    raise NotImplementedError(
        "Compression.powersgd is not ported yet (ROADMAP A.8)")


class Compression:
    """Namespace matching hvd.Compression."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    powersgd = staticmethod(powersgd)
