"""Shared gradient-bucketing layer: deterministic reverse-order
packing of pytree leaves into `HOROVOD_FUSION_THRESHOLD`-sized buckets.

Port copy (horovod_tpu_torch): byte-identical to the JAX package's
module but for this paragraph, `leaf_nbytes` and `dtype_name`, which
size torch tensors, numpy arrays and dtype names ("bfloat16"
included) without ml_dtypes, `partition_tree`, which flattens a port
tree instead of importing jax, and `split_by_dtype`, which keys on
the normalised dtype name, so a torch bucket splits as the
reference's does (pinned by tests/test_torch_port_isolation.py).

This is the partitioning half of the reference's fusion buffer
(reference: horovod/common/fusion_buffer_manager.cc + the controller's
FuseResponses greedy packing), factored out so BOTH reduction planes
share one authority:

  * the eager grouped allreduce (`optim/distributed_optimizer.py`)
    submits its gradient tree in these buckets — reverse
    (last-produced-first) order, the order backward hooks would have
    submitted them (reference: torch/optimizer.py _make_hook fires in
    reverse layer order), so negotiation and fusion see the same
    schedule the reference's background thread does;
  * the jitted bucketed-overlap path (`parallel/train.py`) emits one
    psum per bucket inside the backward pass, and SPMD safety demands
    every process derive the IDENTICAL bucket assignment from its
    (identical) gradient tree — which is why the partition is a pure
    function of structure, shapes, dtypes and threshold, with no
    environment or data dependence.

Reverse topological order: pytree flattening yields leaves in
registration (forward) order; backprop produces cotangents roughly in
the REVERSE of that, so packing `reversed(leaves)` greedily puts the
first-available gradients into the first-emitted bucket — bucket 0's
reduction can start while the bulk of backprop still runs (SURVEY.md
§0 "the magic"; §2.1 gradient-hook pipeline).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np


class Bucket(NamedTuple):
    """One fusion bucket: `indices` index the FLATTENED leaf list (in
    emission order — reverse topological within the bucket), `nbytes`
    is the summed raw payload."""
    indices: tuple
    nbytes: int


def dtype_name(dtype: Any) -> str:
    """The numpy-style name of a torch, numpy or jax dtype, or of a
    dtype name: torch.bfloat16, "torch.bfloat16" and "bfloat16" are
    all "bfloat16" (the reference's ``str(leaf.dtype)``)."""
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


def leaf_nbytes(leaf: Any) -> int:
    """Raw payload bytes of one array-like leaf (shape x itemsize;
    scalars count their itemsize)."""
    shape = getattr(leaf, "shape", ())
    size = int(np.prod(shape)) if shape else 1
    name = dtype_name(leaf.dtype)
    return size * (2 if name == "bfloat16" else np.dtype(name).itemsize)


def partition_buckets(leaves: Sequence[Any], threshold_bytes: int,
                      key_fn: Optional[Callable[[int, Any], Any]]
                      = None) -> List[Bucket]:
    """Deterministically pack `leaves` into reverse-order buckets of
    at most `threshold_bytes` raw bytes each.

    The walk runs over `reversed(leaves)` (last-produced-first); a
    bucket closes when adding the next leaf would exceed the
    threshold, so a single leaf larger than the threshold travels
    alone (the reference fuses oversized tensors as singleton
    responses rather than splitting them). `threshold_bytes <= 0`
    disables fusion: every leaf becomes its own bucket, mirroring
    HOROVOD_FUSION_THRESHOLD=0.

    `key_fn(index, leaf)` (optional) partitions leaves into
    incompatible families that never share a bucket — the same-key
    rule of the reference controller's FuseResponses (dtype for wire
    packing, reduce-axes signature for the jit path). Each family
    packs greedily over its own reversed subsequence; returned
    buckets are ordered by first emission (the reversed position of
    their first member), so the overall emission schedule stays
    last-produced-first across families.

    Purity contract (SPMD safety, pinned by tests): the result is a
    pure function of (leaf order, shapes, dtypes, threshold, key_fn)
    — identical on every process that holds the same tree.
    """
    n = len(leaves)
    if n == 0:
        return []
    open_buckets: dict = {}
    closed: List[tuple] = []    # (first_rev_pos, indices, nbytes)

    def close(key) -> None:
        ent = open_buckets.pop(key, None)
        if ent is not None:
            closed.append(ent)

    for rev_pos, i in enumerate(range(n - 1, -1, -1)):
        leaf = leaves[i]
        nb = leaf_nbytes(leaf)
        key = key_fn(i, leaf) if key_fn is not None else None
        ent = open_buckets.get(key)
        if ent is not None and (threshold_bytes <= 0
                                or ent[2] + nb > threshold_bytes):
            close(key)
            ent = None
        if ent is None:
            open_buckets[key] = (rev_pos, [i], nb)
        else:
            ent[1].append(i)
            open_buckets[key] = (ent[0], ent[1], ent[2] + nb)
        if threshold_bytes <= 0:
            close(key)
    for key in list(open_buckets):
        close(key)
    closed.sort(key=lambda ent: ent[0])
    return [Bucket(indices=tuple(idxs), nbytes=nb)
            for _, idxs, nb in closed]


def partition_tree(tree: Any, threshold_bytes: int,
                   key_fn: Optional[Callable[[int, Any], Any]]
                   = None) -> List[Bucket]:
    """`partition_buckets` over a port tree's flattened leaves
    (indices refer to `tree_leaves(tree)` order)."""
    return partition_buckets(tree_leaves(tree), threshold_bytes, key_fn)


def tree_leaves(tree: Any) -> List[Any]:
    """A port tree's leaves in `jax.tree_util.tree_leaves` order: an
    ``nn.Module``'s parameters in registration order, a dict's values
    by sorted key, a list's or tuple's in order; None is no leaf."""
    if tree is None:
        return []
    if hasattr(tree, "named_parameters"):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def assignment_digest(buckets: Sequence[Bucket],
                      compression: Optional[Sequence[str]] = None
                      ) -> str:
    """Canonical string form of a bucket assignment — what the
    determinism tests (and any cross-process assertion) compare.
    Byte-identical assignments have byte-identical digests.

    `compression` (optional, one tag per bucket — "none", "bf16",
    "powersgd:4", ...) extends each bucket's entry with `|c=<tag>`
    when the tag is not "none", so the cross-process contract now
    states the TRANSFORM each bucket's wire takes, not just its
    membership: two processes that agree on the partition but
    disagree on a bucket's compressor would compile different
    programs, and the digest (checked by HVD007 against the traced
    collectives) catches it. An all-"none" assignment keeps the
    historical digest byte-identical."""
    ents = []
    for bi, b in enumerate(buckets):
        ent = ",".join(str(i) for i in b.indices) + f":{b.nbytes}"
        if compression is not None and compression[bi] != "none":
            ent += f"|c={compression[bi]}"
        ents.append(ent)
    return ";".join(ents)


class _SigLeaf(NamedTuple):
    """Shape/dtype stand-in so the cached signature partition reuses
    leaf_nbytes unchanged."""
    shape: tuple
    dtype: str


@functools.lru_cache(maxsize=4096)
def partition_signature(sig: Tuple[Tuple[tuple, str], ...],
                        threshold_bytes: int) -> Tuple[Bucket, ...]:
    """Cached partition over a dispatch-style signature tuple
    `((shape, dtype_str), ...)` — the eager hot path calls this per
    step with an (almost always) repeating gradient-tree signature,
    so the O(n-leaves) greedy walk runs once per distinct
    (signature, threshold), not once per step. Purity of
    partition_buckets is what makes the cache sound."""
    leaves = [_SigLeaf(tuple(s), d) for s, d in sig]
    return tuple(partition_buckets(leaves, threshold_bytes))


def partition_cached(leaves: Sequence[Any],
                     threshold_bytes: int) -> Tuple[Bucket, ...]:
    """`partition_buckets` through the signature cache (no key_fn —
    signature-keyed families would defeat the cache key)."""
    sig = tuple((tuple(getattr(x, "shape", ())), str(x.dtype))
                for x in leaves)
    return partition_signature(sig, int(threshold_bytes))


def partition_digest(leaves: Sequence[Any], threshold_bytes: int,
                     key_fn: Optional[Callable[[int, Any], Any]]
                     = None) -> str:
    """`assignment_digest` of a fresh partition — the one-call form of
    the SPMD cross-process contract ("every process derives this
    identical string from its identical tree"). The HVD007 jaxpr
    verifier compares this against `parallel.train.plan_overlap`'s
    digest and against the eager grouped-allreduce plan
    (`partition_cached`), so a partitioner change that would compile
    different programs on different processes fails lint, not a
    rollout."""
    return assignment_digest(
        partition_buckets(leaves, threshold_bytes, key_fn))


def split_by_dtype(items: Sequence[Any]) -> List[List[int]]:
    """Same-dtype index subgroups preserving order within each — the
    per-dtype wire-packing rule both the eager fusion
    (`dispatch.group_by_dtype`) and the jit bucket packer apply
    before concatenating payloads into one wire array."""
    by_dtype: dict = {}
    for i, a in enumerate(items):
        by_dtype.setdefault(dtype_name(getattr(a, "dtype", a)),
                            []).append(i)
    return list(by_dtype.values())
