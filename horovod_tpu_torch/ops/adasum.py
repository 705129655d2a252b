"""Adasum adaptive summation (arXiv:2006.02924): the vhdd and gather
routes.

Port of ``horovod_tpu/ops/adasum.py``. The pairwise combine of
contributions a and b is the orthogonal-projection blend

    combined = (1 - (a.b) / (2*|a|^2)) * a  +  (1 - (a.b) / (2*|b|^2)) * b

with zero-norm guards. ``adasum_allreduce`` (l.409) takes a same-dtype
group of tensors, flattens and concatenates it, and routes it:

- **vhdd** (vector halving, distance doubling; ``_adasum_kernel_vhdd``,
  l.359), the default. The bucket is padded to a multiple of the
  largest power-of-two block of the set (l.385). Halving round at
  distance d: each rank splits its segment in half and swaps the half
  that bit d of its set index does not keep with partner ``i ^ d``
  (``dist.batch_isend_irecv``); ``a`` is the bit-0 side's contribution.
  The partials ``(a.b, |a|^2, |b|^2)`` are summed over the merged
  2d-rank group, and both sides blend with the group's coefficients.
  Doubling rounds reverse the swaps. A set whose size is not a power of
  two runs one schedule per block of its binary decomposition
  (``_pow2_blocks``, l.225; the blocks run side by side), then the
  right-to-left merges of ``_merge_pass`` (l.316): one masked sum over
  the union hands every member both block results, and each member
  blends redundantly. No bucket-sized all-gather; in a power-of-two
  set the largest message is half the padded bucket.
- **gather**: one ``all_gather`` of every member's bucket and a
  deterministic binary-tree fold whose odd member passes through
  (``_tree_fold``, l.125), on every rank.

Ranks stay bitwise equal on both routes: every member of a group sums
the group's partials in set order (an all-gather of three floats per
member, ``_DistWire.partials``), so all get the same coefficients.

The arithmetic of a combine has two branches, chosen as in the reference
by HOROVOD_ADASUM_PALLAS and the dtype:

- the kernels K1 and K2 (``ops/adasum_kernels.py``), on CUDA tensors of
  float32, bfloat16 or float16 when the knob is "auto" or forces them.
  On vhdd, K1 gives the rank's own partials (``stats[2:5]``), the
  coefficients of the group's sum go into a fresh ``(5,)`` stats tensor
  and K2 blends with it; a merge is K1 then K2 on the whole vectors.
  The gather route's fold takes them for CPU tensors too (their plain
  versions), as before;
- the reference's non-kernel branch otherwise (CPU tensors on vhdd,
  HOROVOD_ADASUM_PALLAS=0, float64, complex): vhdd's partials are
  ``_partial_dots`` (l.250: float32 sums, float64 stays float64), the
  gather fold's are dot products in the input dtype; the coefficients
  are cast to the input dtype before the blend.

Routing, with the reference's knob values and answers:
HOROVOD_ADASUM_MODE "vhdd" forces vhdd and "gather" the gather route;
"auto" takes vhdd unless HOROVOD_ADASUM_PALLAS forces the kernel
("1"/"true"/"yes"), which takes the gather route. Complex tensors always
take the gather route. The device-spanning ``_adasum_kernel_vhdd_wide``
(l.168) has no counterpart: one process of the port drives one card.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..common import config as _config
from . import adasum_kernels
from .adasum_kernels import adasum_coeffs as _adasum_coeffs
from .process_set import ProcessSet, need_suffix_groups

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


def _pow2_blocks(n: int):
    """Binary decomposition of n into descending power-of-two rank
    blocks: 7 -> [(0,4),(4,2),(6,1)]. Each block start is a multiple
    of its size (sum of strictly larger powers of two), so block-local
    vhdd partner/group arithmetic works on global indices."""
    blocks = []
    start, m = 0, n
    while m:
        p = 1 << (m.bit_length() - 1)
        blocks.append((start, p))
        start += p
        m -= p
    return blocks


def _merge_starts(n: int) -> List[int]:
    """Set indices at which vhdd's merges over a set of ``n`` members
    start: every power-of-two block of ``n`` but the last (each merge
    reduces over the members from its left block on)."""
    return [start for start, _ in _pow2_blocks(n)[:-1]]


need_suffix_groups(_merge_starts)


def _partial_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a.b, |a|^2, |b|^2)`` as a (3,) float32 tensor: the sums in
    float32, float64 inputs in float64 (the reference's l.250)."""
    af = a if a.dtype == torch.float64 else a.float()
    bf = b if b.dtype == torch.float64 else b.float()
    return torch.stack([torch.vdot(af, bf).real, torch.vdot(af, af).real,
                        torch.vdot(bf, bf).real]).to(torch.float32)


def _local_partials(a, b, use_kernel: bool) -> torch.Tensor:
    """This rank's partials over its piece: K1's ``stats[2:5]``, or
    ``_partial_dots``."""
    if use_kernel:
        return adasum_kernels.adasum_partials(a, b)[2:5]
    return _partial_dots(a, b)


def _blend(a, b, dots: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """``ca * a + cb * b`` with the coefficients of the summed partials
    ``dots``: K2 reading a fresh ``[ca, cb, a.b, |a|^2, |b|^2]``, or the
    coefficients cast to the input dtype."""
    ca, cb = _adasum_coeffs(dots[0], dots[1], dots[2])
    if use_kernel:
        stats = torch.cat([torch.stack([ca, cb]), dots])
        return adasum_kernels.adasum_scaled_add(stats, a, b)
    return ca.to(a.dtype) * a + cb.to(b.dtype) * b


def vhdd(seg: torch.Tensor, me: int, n: int, wire,
         use_kernel: bool = False) -> torch.Tensor:
    """The Adasum combine of the ``n`` members' ``seg`` (1-D, the same
    length on every member, a multiple of the largest power-of-two
    block of ``n``), as member ``me`` runs it; returns the combined
    vector. ``wire`` carries the exchanges (``_DistWire`` on
    ``torch.distributed``; the tests pass one for ranks simulated in
    threads):

    - ``wire.swap(send, partner)`` sends ``send`` to member ``partner``
      and returns what the partner sent, of the same shape;
    - ``wire.partials(part)`` all-gathers every member's (3,) float32
      ``part`` and returns them in member order, (n, 3);
    - ``wire.merge(seg, ra, rb)`` returns ``(x, y)`` on every member
      from ``ra`` on: the ``seg`` of member ``ra`` and of member ``rb``.

    The blocks of ``_pow2_blocks(n)`` halve side by side: every member
    takes part in each level's ``partials`` (zeros once its block is
    done), and the members of one 2d-group sum its rows in member
    order, so all of them blend with bitwise the same coefficients."""
    blocks = _pow2_blocks(n)
    start, size = next(b for b in blocks if b[0] <= me < b[0] + b[1])
    levels = blocks[0][1].bit_length() - 1
    mine = size.bit_length() - 1
    for lvl in range(levels):
        d = 1 << lvl
        if lvl < mine:
            half = seg.numel() // 2
            low = (me // d) % 2 == 0
            keep, send = (seg[:half], seg[half:]) if low else \
                (seg[half:], seg[:half])
            recv = wire.swap(send, me ^ d)
            a, b = (keep, recv) if low else (recv, keep)
            part = _local_partials(a, b, use_kernel)
        else:
            part = torch.zeros(3, dtype=torch.float32, device=seg.device)
        rows = wire.partials(part)
        if lvl < mine:
            base = (me // (2 * d)) * (2 * d)
            dots = rows[base]
            for i in range(base + 1, base + 2 * d):
                dots = dots + rows[i]
            seg = _blend(a, b, dots, use_kernel)
    for lvl in reversed(range(mine)):
        d = 1 << lvl
        recv = wire.swap(seg, me ^ d)
        seg = torch.cat([seg, recv] if (me // d) % 2 == 0 else [recv, seg])
    for j in reversed(range(len(blocks) - 1)):
        ra, rb = blocks[j][0], blocks[j + 1][0]
        if me >= ra:
            x, y = wire.merge(seg, ra, rb)
            seg = _blend(x, y, _local_partials(x, y, use_kernel), use_kernel)
    return seg


class _DistWire:
    """``vhdd``'s exchanges over a registered process set on
    ``torch.distributed``. Under gloo a CUDA tensor goes through host
    memory and comes back to its device."""

    def __init__(self, pset: ProcessSet):
        from ..common import basics
        self.pset = pset
        self.gloo = basics.backend() == "gloo"

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if (t.is_cuda and self.gloo) else t

    def swap(self, send: torch.Tensor, partner: int) -> torch.Tensor:
        out = self._host(send.contiguous())
        recv = torch.empty_like(out)
        peer = self.pset.ranks[partner]
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, out, peer, self.pset.group),
                dist.P2POp(dist.irecv, recv, peer, self.pset.group)]):
            req.wait()
        return recv.to(send.device)

    def partials(self, part: torch.Tensor) -> torch.Tensor:
        src = self._host(part)
        rows = torch.empty((self.pset.size, 3), dtype=src.dtype,
                           device=src.device)
        dist.all_gather(list(rows.unbind(0)), src, group=self.pset.group)
        return rows.to(part.device)

    def merge(self, seg: torch.Tensor, ra: int, rb: int):
        me = self.pset.rank()
        both = torch.zeros((2,) + tuple(seg.shape), dtype=seg.dtype,
                           device=seg.device)
        if me in (ra, rb):
            both[0 if me == ra else 1] = seg
        host = self._host(both)
        dist.all_reduce(host, group=self.pset.suffix_group(ra))
        both = host.to(seg.device)
        return both[0], both[1]


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
    tensors = _scale(tensors, prescale)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    kernel_dtype = all(_pallas_ok_dtype(t.dtype) for t in tensors)
    # The reference's route rule (l.437-439): vhdd unless complex, mode
    # "gather", or a kernel forced under mode "auto".
    vhdd_route = not any(t.is_complex() for t in tensors) and (
        _adasum_mode == "vhdd"
        or (_adasum_mode == "auto" and not _pallas_forced()))
    if vhdd_route:
        total, n = flat.numel(), pset.size
        pad = (-total) % _pow2_blocks(n)[0][1]
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        use_kernel = flat.is_cuda and kernel_dtype and _use_pallas(True)
        red = vhdd(flat, pset.rank(), n, _DistWire(pset),
                   use_kernel)[:total]
    else:
        use_pallas = _use_pallas(flat.is_cuda) and kernel_dtype
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
