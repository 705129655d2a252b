"""Negotiated-cycle controller: routes eager collectives through the
control plane so ranks may submit in any order.

Port of ``horovod_tpu/ops/controller.py``: the C++ core (``core/cc``,
loaded by ``core/native.py``) negotiates one ordered list of fused
batches, the same on every rank; a single dispatch thread here owns
every world-set collective and runs one packed collective per agreed
batch through the group executors of ``ops/collective_ops.py``, over
world groups of its own (``ProcessSetTable.twin``): the caller's
thread may still issue collectives over the default group (the train
step's bucketed exchange, the ops of an inline path), and the two
threads' collectives must never pair with each other. Python
never decides the order, the core does: that is what relaxes the
same-order requirement of the inline path to Horovod's "submit
whenever ready".

Signature format (the Request metadata), byte for byte the reference's,
with dtypes by their numpy names ("bfloat16", never "torch.bfloat16"):
  allreduce:  "ar|<wiredtype>|<op>|<pset>|<pre>|<post>#<raw0>:s0xs1;<raw1>:..."
  broadcast:  "bc|<dtype>|<root>|<pset>#s0xs1..."
  allgather:  "ag|<dtype>|<pset>#r0xr1..."  (trailing dims; each rank's
              first dim rides the Request meta)
  reducescatter: "rs|<dtype>|<op>|<pset>|<pre>|<post>#s0xs1..."
  generic:    "g|<name>#"  (alltoall, barrier, object collectives)
The part before '#' is the fuse key: the coordinator packs only
same-key entries into one batch, up to HOROVOD_FUSION_THRESHOLD bytes.

Differences from the reference, for torch tensors on a card:

- Streams (Horovod's ReadyEvent, horovod/torch/ready_event.cc): a
  submission of CUDA tensors records an event on the submitting
  thread's current stream; the dispatch thread makes its own stream
  wait on it before it packs, and records the tensors on its stream
  for the allocator. After it unpacks a batch it records an event that
  the caller's stream waits on in ``synchronize`` (``ops/engine.py``).
  The in-place variants are written on the dispatch thread's stream
  before that event.
- A joined rank's zero-fill is made on the device of the batch's live
  tensors, or on the rank's device (``common/device.rank_device``)
  when it has none, not on the host.
- Average divides the sum by the agreed active-rank count (the set's
  size on a subset), as the inline path divides by the set's size; the
  reference multiplies by postscale / divisor. The two agree bitwise
  when the divisor is a power of two and postscale is 1.
- Adasum: each entry of an agreed batch is its own Adasum vector (a
  gradient tensor submitted alone, or a grouped submission's
  same-dtype group), as on the inline path and in Horovod's fused
  Adasum (adasum.h: coefficients per tensor); the reference's
  controller hands the whole batch to ``adasum_allreduce``
  (l.1076-1088), which folds its concatenation as one vector, so its
  result depends on which gradients the coordinator happened to fuse.
- The profiler span of a batch is ``torch.profiler.record_function``;
  the timeline and autotune hooks are not ported (ROADMAP A.10).
- The hierarchical control tree (HOROVOD_CONTROL_TREE_ARITY >= 2) is
  not wired: such a setting raises at init (ROADMAP A.7, with the
  multi-host launcher). Every rank attaches to rank 0's flat star.
- A generic op's function gets the set to run over, the dispatch
  thread's own groups included, as its first argument.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import tracing as _tracing
from ..common import logging as hlog
from ..core import native
from ..metrics import (BYTES_BUCKETS, COUNT_BUCKETS, LATENCY_BUCKETS,
                       REGISTRY as _METRICS)
from . import collective_ops as C
from .bucketing import dtype_name
from .collective_ops import ADASUM, AVERAGE
from .compression import compressor_for, wire_dtype_of


def control_plane_secret() -> str:
    """Per-job secret for the native control plane's mutual
    challenge-response rank rendezvous (HMAC-SHA256, core/cc/sha256.h):
    the launcher's HOROVOD_SECRET, empty (unauthenticated) when none is
    configured."""
    return os.environ.get("HOROVOD_SECRET", "")


def allreduce_sig(wire_dtype, raw_dtypes, shapes_list, rop: int,
                  pset_id: int, prescale: float, postscale: float) -> str:
    """Fuse key + per-tensor metadata. The key holds only the on-wire
    dtype, so entries whose different raw dtypes compress to one wire
    dtype fuse into one batch; per-tensor raw dtypes and shapes ride
    past the '#' so a joined rank can zero-fill each tensor in its raw
    dtype."""
    shapes = ";".join(
        f"{dtype_name(rd)}:" + "x".join(str(d) for d in s)
        for rd, s in zip(raw_dtypes, shapes_list))
    return (f"ar|{dtype_name(wire_dtype)}|{rop}|"
            f"{pset_id}|{prescale}|{postscale}#{shapes}")


def parse_allreduce_sig(sig: str):
    """-> (wire_dt, rop, pset_id, pre, post, metas) with metas a list
    of per-tensor (raw_dtype_str, shape_tuple)."""
    head, shapes = sig.split("#", 1)
    _, wire_dt, rop, pset_id, pre, post = head.split("|")
    metas = []
    for s in shapes.split(";"):
        raw, _, dims = s.partition(":")
        metas.append((raw, tuple(int(d) for d in dims.split("x") if d)))
    return (wire_dt, int(rop), int(pset_id), float(pre),
            float(post), metas)


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} in a negotiated signature")
    return dt


def _shape(t: torch.Tensor) -> str:
    return "x".join(str(d) for d in t.shape)


class _Pending:
    """One submitted op awaiting agreement: its tensors, its handle,
    the op's own fields, and, for CUDA tensors, the event recorded on
    the submitting thread's stream that they were produced behind."""

    inplace = grouped = False

    def __init__(self, tensors, handle, **fields):
        self.tensors = list(tensors)
        self.handle = handle
        self.__dict__.update(fields)
        self.submitted = time.monotonic()
        self.event = None
        cuda = [t for t in self.tensors if t.is_cuda]
        if cuda:
            dev = cuda[0].device
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            self.event = (ev, dev)


class PythonCore:
    """In-process stand-in for the native core: same submit/next_batch
    protocol, single-process only (reference analog: running with one
    rank, where negotiation degenerates to local FIFO + fusion).

    Intentional semantic divergences from the C++ core, acceptable
    because there are no peers: no cross-rank signature-mismatch
    checking (nothing to mismatch against) and therefore no error
    entries in batches; fusion packing is the same greedy same-key
    rule but runs on the caller's thread, not a cycle thread."""

    def __init__(self, fusion_threshold: int, cycle_time_ms: float = 0.0):
        self.fusion_threshold = fusion_threshold
        self.cycle_time_ms = float(cycle_time_ms)
        self.quiesce = 0
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._pending: collections.deque = collections.deque()
        self._joined = False
        self._shutdown = False
        self._cycles = 0

    def submit(self, name: str, sig: str, nbytes: int,
               meta: str = "") -> None:
        with self._cv:
            # single process: the aggregated meta is just our own
            self._pending.append(
                (native.BatchEntry(name, sig, 1, "", 0, meta), nbytes))
            self._cv.notify_all()

    def join(self) -> None:
        with self._cv:
            self._joined = True
            self._cv.notify_all()

    def all_joined(self) -> int:
        with self._mu:
            return 0 if self._joined else -1

    def cycles(self) -> int:
        return self._cycles

    def next_batch(self, timeout_s: float):
        with self._cv:
            self._cv.wait_for(
                lambda: self._pending or self._shutdown,
                timeout=timeout_s)
            if self._shutdown and not self._pending:
                return None
            if not self._pending:
                return []
            if self.cycle_time_ms > 0:
                # Cycle pacing: linger so concurrent submitters can land
                # in the same fused batch (reference: the background
                # loop's HOROVOD_CYCLE_TIME sleep). This is what the
                # autotuner's set_cycle_time actually tunes here.
                deadline = time.monotonic() + self.cycle_time_ms / 1e3
                while not self._shutdown:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(left)
            if self.quiesce > 0:
                # Quiescence batching (native-core SetQuiescence
                # analog): keep lingering while the queue is still
                # growing so a submission storm cuts as ONE
                # stable-composition batch — unless some single fuse
                # key already has enough bytes to fill the fusion
                # threshold (the same escape the C++ coordinator
                # applies). Per-KEY, not whole-queue: a cut only fuses
                # one key, so a mixed-key backlog must not release the
                # hold when no single batch would fill the threshold.
                tick = max(self.cycle_time_ms, 1.0) / 1e3
                stable, last = 0, len(self._pending)
                while not self._shutdown and stable < self.quiesce:
                    per_key: Dict[str, int] = {}
                    for e, nb in self._pending:
                        k = e.sig.split("#", 1)[0]
                        per_key[k] = per_key.get(k, 0) + nb
                    if per_key and max(per_key.values()) >= \
                            self.fusion_threshold:
                        break
                    self._cv.wait(tick)
                    if len(self._pending) == last:
                        stable += 1
                    else:
                        last = len(self._pending)
                        stable = 0
            self._cycles += 1
            # greedy same-key fusion from the front (mirrors the C++
            # coordinator's FuseResponses loop); deque keeps drain O(1)
            # per entry under backlog
            first, _ = self._pending[0]
            key = first.sig.split("#", 1)[0]
            batch, total = [], 0
            while self._pending:
                e, nb = self._pending[0]
                if e.sig.split("#", 1)[0] != key:
                    break
                if total > 0 and total + nb > self.fusion_threshold:
                    break
                batch.append(e)
                total += nb
                self._pending.popleft()
            return batch

    def set_fusion_threshold(self, nbytes: int) -> None:
        with self._cv:
            self.fusion_threshold = int(nbytes)

    def set_cycle_time(self, ms: float) -> None:
        # Paces next_batch's accumulation window (see above) — the
        # same knob the NativeCore's coordinator cycle honors.
        with self._cv:
            self.cycle_time_ms = float(ms)

    def set_quiescence(self, cycles: int) -> None:
        with self._cv:
            self.quiesce = int(cycles)

    def control_bytes(self) -> int:
        return 0  # nothing crosses a wire in-process

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()

    def destroy(self) -> None:
        pass


class NegotiatedController:
    """Owns the pending-op registry + the single dispatch worker.

    ``endpoint``: the coordinator's (host, port) for size > 1 (see
    ``common/basics.py``); ``device``: the rank's device, where a
    joined rank's zero-fill goes when a batch has no live tensor;
    ``world``: the global set's twin with groups of its own, which the
    dispatch thread runs every batch over (None: the sets as given)."""

    def __init__(self, cfg, topology, engine, core: Optional[Any] = None,
                 endpoint=None, device: Optional[torch.device] = None,
                 world=None):
        self.cfg = cfg
        self.topology = topology
        self.engine = engine
        self.device = device or torch.device("cpu")
        self._world = world
        self._pending: Dict[str, _Pending] = {}
        self._mu = threading.Lock()
        self._join_event = threading.Event()
        self._join_result = -1
        self._error: Optional[BaseException] = None
        # Terminal marker: set (before _fail_pending) when the dispatch
        # worker exits; submissions after that fail fast instead of
        # waiting forever on a worker that will never deliver.
        self._terminated: Optional[BaseException] = None
        # Introspection: per-kind [batches, entries] executed — a
        # fused batch increments batches by 1 and entries by N.
        self.exec_counts: Dict[str, List[int]] = {}
        # Distinct fused allreduce compositions (shapes and dtypes).
        self._ar_compositions: set = set()

        self._m_negotiation = _METRICS.histogram(
            "hvd_negotiation_latency_seconds",
            "Submit-to-agreement latency per locally-submitted "
            "collective (coordinator-measured).",
            buckets=LATENCY_BUCKETS)
        self._m_batch_entries = _METRICS.histogram(
            "hvd_fusion_batch_entries",
            "Entries per agreed fused batch (fusion efficiency: "
            "1 = nothing fused).", buckets=COUNT_BUCKETS)
        self._m_batch_bytes = _METRICS.histogram(
            "hvd_fusion_batch_bytes",
            "Raw payload bytes per fused allreduce batch (compare "
            "against HOROVOD_FUSION_THRESHOLD).",
            buckets=BYTES_BUCKETS)
        self._m_batches = _METRICS.counter(
            "hvd_fused_batches_total",
            "Agreed batches executed, by collective kind.", ("kind",))
        self._m_entries = _METRICS.counter(
            "hvd_fused_entries_total",
            "Entries executed inside agreed batches, by kind.",
            ("kind",))
        self._m_cache_hits = _METRICS.counter(
            "hvd_fused_program_cache_hits_total",
            "Fused allreduce batches whose composition was seen "
            "before.")
        self._m_cache_misses = _METRICS.counter(
            "hvd_fused_program_cache_misses_total",
            "Fused allreduce batches with a new composition.")
        self._m_stalled = _METRICS.gauge(
            "hvd_stalled_tensors",
            "Collectives pending negotiation longer than "
            "HOROVOD_STALL_CHECK_TIME_SECONDS right now.")
        self._m_stall_age = _METRICS.gauge(
            "hvd_stall_max_age_seconds",
            "Age of the oldest currently-stalled pending collective "
            "(0 when nothing is stalled).")
        self._m_tree_depth = _METRICS.gauge(
            "hvd_control_tree_depth",
            "This rank's control-tree tier: 0 = root/coordinator, "
            "1 = attached directly to it (every worker in the flat "
            "star), 2+ = below an aggregator.")
        self._m_round = _METRICS.histogram(
            "hvd_control_round_seconds",
            "Coordinator-measured negotiation round latency per "
            "agreed batch (slowest entry's submit-to-agreement; must "
            "stay under the cycle budget).", buckets=LATENCY_BUCKETS)
        self._tree_tier = 0

        if cfg.controller == "python" and topology.size > 1 and \
                core is None:
            # The in-process python core cannot negotiate across
            # processes.
            raise RuntimeError(
                "HOROVOD_CONTROLLER=python drives negotiation "
                "in-process and is single-process only; with size "
                f"{topology.size} use HOROVOD_CONTROLLER=native (or "
                "auto), which builds the C++ core "
                "(horovod_tpu_torch/core/cc)")
        if core is not None:
            self.core = core
        elif topology.size > 1 or cfg.controller == "native":
            if topology.size > 1:
                if endpoint is None:
                    raise RuntimeError(
                        "negotiated controller needs the coordinator's "
                        "control endpoint for size > 1")
                host, port = endpoint
            else:
                host, port = "127.0.0.1", 0  # size 1: no sockets
            self.core = native.NativeCore(
                rank=topology.rank, size=topology.size,
                coord_host=host, coord_port=port,
                fusion_threshold=cfg.fusion_threshold,
                cycle_time_ms=cfg.cycle_time_ms,
                stall_warn_s=(0.0 if cfg.stall_check_disable
                              else cfg.stall_check_time),
                stall_kill_s=cfg.stall_shutdown_time,
                connect_timeout_s=cfg.start_timeout,
                cache_capacity=cfg.cache_capacity,
                auth_secret=control_plane_secret())
            self._tree_tier = self.core.tree_tier()
        else:
            self.core = PythonCore(cfg.fusion_threshold,
                                   cfg.cycle_time_ms)

        if getattr(cfg, "batch_quiescence", 0):
            self.core.set_quiescence(cfg.batch_quiescence)
        self._m_tree_depth.set(self._tree_tier)

        self._worker = threading.Thread(
            target=self._worker_loop, name="hvdtorch-controller",
            daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    # submission (any thread)
    # ------------------------------------------------------------------

    def _submit(self, name: str, sig: str, nbytes: int, pending: _Pending,
                meta: str = ""):
        h = pending.handle
        with self._mu:
            if name in self._pending:
                h.set_error(ValueError(
                    f"a collective named '{name}' is already pending "
                    "(names must be unique among in-flight ops, as in "
                    "the reference)"))
                return h
            self._pending[name] = pending
        _tracing.record("submit", name)
        self.core.submit(name, sig, nbytes, meta)
        self._check_terminated(name, h)
        return h

    def submit_allreduce(self, name: str, tensors: List[torch.Tensor],
                         pset, rop: int, prescale: float, postscale: float,
                         compression, grouped: bool = False,
                         inplace: bool = False):
        h = self.engine.new_handle(name)
        wires = [wire_dtype_of(compression, t.dtype) for t in tensors]
        if len(set(wires)) != 1:
            h.set_error(ValueError(
                f"grouped allreduce submission mixes wire dtypes "
                f"{sorted({dtype_name(w) for w in wires})}; split by "
                "wire dtype first (grouped_allreduce does this)"))
            return h
        wire_dt = wires[0]
        sig = allreduce_sig(wire_dt, [t.dtype for t in tensors],
                            [t.shape for t in tensors], rop,
                            pset.process_set_id, prescale, postscale)
        nbytes = sum(t.numel() for t in tensors) * wire_dt.itemsize
        return self._submit(name, sig, nbytes, _Pending(
            tensors, h, compression=compression, grouped=grouped,
            inplace=inplace))

    def submit_broadcast(self, name: str, tensor: torch.Tensor,
                         set_root: int, pset, inplace: bool = False):
        """Same-dtype/root broadcasts agreed in one cycle run as one
        packed broadcast (the reference's FuseResponses)."""
        h = self.engine.new_handle(name)
        sig = (f"bc|{dtype_name(tensor.dtype)}|{set_root}|"
               f"{pset.process_set_id}#{_shape(tensor)}")
        return self._submit(
            name, sig, tensor.numel() * tensor.element_size(),
            _Pending([tensor], h, root=pset.ranks[set_root], pset=pset,
                     inplace=inplace))

    def submit_allgather(self, name: str, tensor: torch.Tensor, pset):
        """Each rank's first dim rides the Request meta; trailing dims
        live in the sig, so cross-rank mismatches become error entries."""
        h = self.engine.new_handle(name)
        t = tensor.reshape(1) if tensor.dim() == 0 else tensor
        rest = "x".join(str(d) for d in t.shape[1:])
        sig = f"ag|{dtype_name(t.dtype)}|{pset.process_set_id}#{rest}"
        return self._submit(name, sig, t.numel() * t.element_size(),
                            _Pending([t], h, pset=pset),
                            meta=str(t.shape[0]))

    def submit_reducescatter(self, name: str, tensor: torch.Tensor, pset,
                             rop: int, prescale: float, postscale: float):
        h = self.engine.new_handle(name)
        sig = (f"rs|{dtype_name(tensor.dtype)}|{rop}|"
               f"{pset.process_set_id}|{prescale}|{postscale}"
               f"#{_shape(tensor)}")
        return self._submit(
            name, sig, tensor.numel() * tensor.element_size(),
            _Pending([tensor], h, pset=pset, rop=rop, prescale=prescale,
                     postscale=postscale))

    def submit_generic(self, name: str, nbytes: int,
                       fn: Callable[..., Any], pset,
                       meta: Optional[str] = None, tensors=()):
        """A non-fusable op over ``pset``: ``fn(set)`` runs on the
        dispatch thread with the set to run over (its own groups). With
        `meta` set, the string rides the Request, the coordinator
        aggregates it per rank, and `fn` is called as ``fn(set,
        metas)`` with every rank's metas. `tensors`: the inputs `fn`
        reads, which the dispatch thread waits for on a card."""
        h = self.engine.new_handle(name)
        return self._submit(name, f"g|{name}#", nbytes,
                            _Pending(tensors, h, fn=fn, pset=pset,
                                     wants_meta=meta is not None),
                            meta=meta or "")

    def join(self, timeout_s: Optional[float] = None) -> int:
        """Declare this rank done (reference: hvd.join()); blocks until
        every rank joined; returns the last rank to join."""
        self.core.join()
        if not self._join_event.wait(timeout_s):
            raise TimeoutError("hvd.join() timed out")
        if self._join_result < 0:
            raise RuntimeError(
                "hvd.join() aborted: the controller shut down before "
                "every rank joined"
                + (f" ({self._error})" if self._error else ""))
        return self._join_result

    # ------------------------------------------------------------------
    # worker (the single dispatching thread)
    # ------------------------------------------------------------------

    def _worker_loop(self):
        from ..common.exceptions import HorovodInternalError
        try:
            if self.device.type == "cuda":
                # The current card is per thread: NCCL's communicator and
                # the object collectives want the rank's own.
                torch.cuda.set_device(self.device)
            while True:
                batch = self.core.next_batch(0.05)
                if batch is None:
                    # Control plane gone (clean shutdown or lost
                    # coordinator): poll the all-joined sentinel one
                    # last time, fail anything still pending and
                    # unblock join() waiters. The terminal marker is set
                    # first, so racing submissions fail fast.
                    self._terminated = HorovodInternalError(
                        "collective cannot complete: the controller "
                        "shut down"
                        + (f" ({self._error})" if self._error else ""))
                    self._poll_join()
                    self._fail_pending(self._terminated)
                    self._join_event.set()
                    self._clear_stall_gauges()
                    break
                if batch:
                    self._execute(batch)
                self._poll_join()
                self._update_stall_gauges()
        except BaseException as e:  # pragma: no cover - defensive
            hlog.error("controller worker died: %s", e)
            self._error = e
            self._terminated = e
            self._fail_pending(e)
            self._join_event.set()

    def _poll_join(self) -> None:
        if not self._join_event.is_set():
            lastrank = self.core.all_joined()
            if lastrank >= 0:
                self._join_result = lastrank
                self._join_event.set()

    def _update_stall_gauges(self) -> None:
        warn = self.cfg.stall_check_time
        if self.cfg.stall_check_disable or warn <= 0:
            return
        now = time.monotonic()
        with self._mu:
            ages = [now - p.submitted for p in self._pending.values()]
        stalled = [a for a in ages if a >= warn]
        self._m_stalled.set(len(stalled))
        self._m_stall_age.set(max(stalled) if stalled else 0.0)

    def _clear_stall_gauges(self) -> None:
        # A dead controller must not leave a stuck "stalled" alert.
        self._m_stalled.set(0)
        self._m_stall_age.set(0.0)

    def _fail_pending(self, err: BaseException) -> None:
        with self._mu:
            pending = list(self._pending.values())
            self._pending.clear()
        for p in pending:
            p.handle.set_error(err)

    def _check_terminated(self, name: str, h) -> bool:
        """Fail-fast for submissions racing the dispatch worker's
        exit."""
        if self._terminated is None:
            return False
        with self._mu:
            p = self._pending.pop(name, None)
        if p is not None:
            h.set_error(self._terminated)
        return True

    def _execute(self, batch):
        t_agree = time.monotonic()
        # One collective sequence id per agreed entry, in batch order:
        # the same on every rank with no wire bytes.
        seq0 = _tracing.next_seq(len(batch))
        with self._mu:
            local = {e.name: self._pending[e.name] for e in batch
                     if e.name in self._pending}
        self._m_round.observe(
            max((e.negotiate_us or 0) for e in batch) / 1e6)
        for i, e in enumerate(batch):
            p = local.get(e.name)
            if p is None:
                continue
            neg_s = max(e.negotiate_us or 0, 0) / 1e6
            self._m_negotiation.observe(neg_s)
            wait_s = max(t_agree - p.submitted, 0.0)
            _tracing.record_skew(max(neg_s - wait_s, 0.0))
            _tracing.record("agree", e.name, seq0 + i, wait_s)
        # error entries: deliver and drop (all ranks got the same ones)
        live = []
        for e in batch:
            if e.error:
                with self._mu:
                    p = self._pending.pop(e.name, None)
                if p is not None:
                    p.handle.set_error(RuntimeError(e.error))
                continue
            live.append(e)
        if not live:
            return
        if self.engine.order_check is not None:
            # The agreed order is the executed order, identically on
            # every rank (zero-fill participation included).
            for e in live:
                self.engine.order_check.record(e.name)
        kind = live[0].sig.split("|", 1)[0]
        c = self.exec_counts.setdefault(kind, [0, 0])
        c[0] += 1
        c[1] += len(live)
        self._m_batches.labels(kind=kind).inc()
        self._m_entries.labels(kind=kind).inc(len(live))
        self._m_batch_entries.observe(len(live))
        label = (f"hvd::fused_{kind}[{len(live)}]" if len(live) > 1
                 else f"hvd::{live[0].name}")
        cm = (torch.profiler.record_function(label)
              if _tracing.profiler_active() else contextlib.nullcontext())
        with cm:
            if kind == "ar":
                self._execute_allreduce_batch(live)
            elif kind == "g":
                self._execute_generic(live)
            else:
                self._execute_fused(kind, live)

    def _execute_generic(self, entries):
        for e in entries:
            with self._mu:
                p = self._pending.pop(e.name, None)
            if p is None:
                # The coordinator errors generic ops agreed while ranks
                # had joined, so this is a defensive path.
                hlog.error("agreed op '%s' was never submitted here",
                           e.name)
                continue
            try:
                dev = self._ready([p])
                ps = self._own(p.pset)
                res = p.fn(ps, e.metas()) if p.wants_meta else p.fn(ps)
                p.handle.set_result(res, self._done_event(dev))
            except Exception as ex:  # noqa: BLE001 — delivered
                p.handle.set_error(ex)

    # -- fused batches -----------------------------------------------------

    def _own(self, pset):
        """The set this thread runs ``pset``'s collectives over: the
        global set's twin, whose groups no other thread uses."""
        if self._world is not None and \
                pset.process_set_id == self._world.process_set_id:
            return self._world
        return pset

    @staticmethod
    def _ready(pendings) -> Optional[torch.device]:
        """Make this thread's stream wait for each submission's tensors
        and record them on it; the batch's CUDA device, if any."""
        dev = None
        for p in pendings:
            if p.event is None:
                continue
            ev, dev = p.event
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(ev)
            for t in p.tensors:
                if t.is_cuda:
                    t.record_stream(stream)
        return dev

    def _deliver(self, slots, outs, dev, t0: float) -> None:
        """Hand each pending its results (written into its own tensors
        for the in-place variants), behind one event on this thread's
        stream when the batch is on a card; the batch's dispatch latency
        since ``t0`` is observed before any caller can see a result."""
        results, i = [], 0
        for p, cnt in slots:
            res = list(outs[i:i + cnt])
            i += cnt
            if p is None:
                continue
            if p.inplace:
                with torch.no_grad():
                    for t, o in zip(p.tensors, res):
                        if o is not t:
                            t.copy_(o)
                res = p.tensors
            results.append((p, res if p.grouped else res[0]))
        event = self._done_event(dev)
        self.engine.dispatch_latency.observe(time.perf_counter() - t0)
        for p, res in results:
            p.handle.set_result(res, event)

    @staticmethod
    def _done_event(dev: Optional[torch.device]):
        """(event, device) recorded on this thread's stream after a
        batch's results were written, or None off the card."""
        if dev is None:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        return ev, dev

    def _pop(self, entries):
        with self._mu:
            return [(e, self._pending.pop(e.name, None)) for e in entries]

    def _execute_fused(self, kind: str, entries):
        """One packed collective for a bc/ag/rs batch. The coordinator
        errors these kinds while any rank has joined (they cannot
        zero-fill), so every live entry has a local pending."""
        slots = []
        for e, p in self._pop(entries):
            if p is None:  # pragma: no cover - defensive
                hlog.error("agreed op '%s' was never submitted here",
                           e.name)
                continue
            slots.append((e, p))
        if not slots:
            return
        pendings = [p for _, p in slots]
        tensors = [p.tensors[0] for p in pendings]
        p0 = pendings[0]
        pset = self._own(p0.pset)
        t0 = time.perf_counter()
        try:
            dev = self._ready(pendings)
            if kind == "bc":
                outs = C._broadcast_group(tensors, p0.root, pset)
            elif kind == "ag":
                # metas are indexed by world rank; project onto the set.
                rows = [[int(e.metas()[r]) for r in pset.ranks]
                        for e, _ in slots]
                outs = C._allgather_group(tensors, pset, rows)
            else:
                outs = C._reducescatter_group(tensors, pset, p0.rop,
                                              p0.prescale, p0.postscale)
            self._deliver([(p, 1) for p in pendings], outs, dev, t0)
        except Exception as ex:  # noqa: BLE001 — delivered
            for p in pendings:
                p.handle.set_error(ex)

    def _execute_allreduce_batch(self, entries):
        """One packed allreduce for the whole agreed batch (same fuse
        key: same wire dtype, op, set and scales)."""
        popped = self._pop(entries)

        def fail(err):
            for _, p in popped:
                if p is not None:
                    p.handle.set_error(err)

        try:
            wire_dt, rop, pset_id, pre, post, _ = \
                parse_allreduce_sig(entries[0].sig)
            wire = _torch_dtype(wire_dt)
            pset = self._own(self.engine.pset_table.get(pset_id))
        except Exception as ex:  # noqa: BLE001 — delivered
            # A malformed agreed sig errors this batch, not the worker.
            fail(RuntimeError(f"malformed negotiated allreduce signature "
                              f"{entries[0].sig!r}: {ex}"))
            return
        live = [t for _, p in popped if p is not None for t in p.tensors]
        zdev = live[0].device if live else self.device
        tensors, compressors, slots = [], [], []
        try:
            for e, p in popped:
                if p is None:
                    # Joined rank: zeros of the agreed shapes in each
                    # tensor's raw dtype, compressed as the live ranks
                    # compress theirs (reference: JoinOp's zeros).
                    metas = parse_allreduce_sig(e.sig)[5]
                    raws = [_torch_dtype(raw) for raw, _ in metas]
                    tensors += [torch.zeros(s, dtype=r, device=zdev)
                                for r, (_, s) in zip(raws, metas)]
                    compressors += [compressor_for(r, wire) for r in raws]
                    slots.append((None, len(metas)))
                else:
                    tensors += p.tensors
                    compressors += [p.compression] * len(p.tensors)
                    slots.append((p, len(p.tensors)))
        except Exception as ex:  # noqa: BLE001 — delivered
            fail(ex)
            return
        comp = tuple((tuple(t.shape), str(t.dtype)) for t in tensors)
        if comp in self._ar_compositions:
            self._m_cache_hits.inc()
        else:
            self._ar_compositions.add(comp)
            self._m_cache_misses.inc()
        self._m_batch_bytes.observe(C._nbytes(tensors))
        t0 = time.perf_counter()
        try:
            dev = self._ready([p for _, p in popped if p is not None])
            if rop == ADASUM:
                # One Adasum vector per entry (declared difference,
                # module docstring).
                outs, i = [], 0
                for _, cnt in slots:
                    outs += C._adasum_group(
                        tensors[i:i + cnt], pset, pre, post,
                        compressors[i:i + cnt])
                    i += cnt
            else:
                # Join-aware Average: active_ranks is world-level, so it
                # applies to the global set only; a subset divides by
                # its own size.
                divisor = (entries[0].active_ranks
                           if pset.size == self.topology.size
                           else pset.size)
                outs = C._reduce_group(tensors, pset, rop, pre, post,
                                       compressors,
                                       divisor=max(divisor, 1)
                                       if rop == AVERAGE else None)
            self._deliver(slots, outs, dev, t0)
        except Exception as ex:  # noqa: BLE001 — delivered
            fail(ex)

    def shutdown(self):
        self.core.shutdown()
        self._worker.join(timeout=10)
        self.core.destroy()
        with self._mu:
            for p in self._pending.values():
                p.handle.set_error(RuntimeError("shutdown"))
            self._pending.clear()
        self._clear_stall_gauges()
