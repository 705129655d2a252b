"""Eager execution engine: handles, naming, release hooks, metrics.

Port of ``horovod_tpu/ops/engine.py`` (``Handle`` l.38, ``Engine``
l.95). The engine owns the integer handles of every eager
collective, the ``allreduce.noname.N`` names and the dispatch metrics;
``run`` executes an op inline, in the caller's thread. When the
negotiated controller is attached (``ops/controller.py``, on by
default for size > 1) the world-set ops go through it instead and the
engine only hands out and resolves their handles.

Differences from the reference, for torch tensors:

- A handle carries the CUDA event its result was recorded behind (the
  controller's dispatch worker records one after it unpacks a batch on
  its own stream). ``Handle.done()`` queries that event where the
  reference asks ``jax.Array.is_ready``; ``Engine.synchronize`` makes
  the caller's current stream wait on it, so a result (or a tensor
  written in place) is safe to use on the caller's stream, and records
  the caller's stream on the result tensors for the allocator.
- The profiler span of an inline op is ``torch.profiler.record_function``,
  built only while ``tracing.profiler_active()`` is true.
- The timeline and autotune attach points stay None (ROADMAP A.10).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from .. import tracing as _tracing
from ..common import logging as hlog
from ..metrics import LATENCY_BUCKETS, REGISTRY as _METRICS


class Handle:
    """Async op handle (reference: horovod/torch/handle_manager.cc)."""

    __slots__ = ("id", "result", "error", "_done", "name", "event",
                 "event_device")

    def __init__(self, hid: int, name: str):
        self.id = hid
        self.name = name
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.event: Optional[torch.cuda.Event] = None
        self.event_device: Optional[torch.device] = None
        self._done = threading.Event()

    def set_result(self, result: Any, event=None) -> None:
        """``event``: None, or (CUDA event, its device) recorded after
        the result was written on the dispatching thread's stream."""
        self.result = result
        if event is not None:
            self.event, self.event_device = event
        self._done.set()

    def set_error(self, err: BaseException) -> None:
        self.error = err
        self._done.set()

    def done(self) -> bool:
        if not self._done.is_set():
            return False
        return self.event is None or self.event.query()

    def wait(self) -> Any:
        """Block until the op is agreed, launched and delivered;
        negotiation errors and launch exceptions raise here, as the
        reference's synchronize() does."""
        self._done.wait()
        if self.error is not None:
            raise self.error
        return self.result


class GroupHandle(Handle):
    """One handle over several submissions (a grouped op the
    controller negotiates entry by entry): its result is
    ``assemble([each child's result])``, resolved in the caller's
    thread at synchronize (the reference's lazy ``GroupedHandle``)."""

    __slots__ = ("children", "assemble")

    def done(self) -> bool:
        return all(c.done() for c in self.children)


def _cuda_leaves(res: Any):
    if isinstance(res, torch.Tensor):
        if res.is_cuda:
            yield res
    elif isinstance(res, (list, tuple)):
        for r in res:
            yield from _cuda_leaves(r)


class Engine:
    """Owns handle bookkeeping, op naming and the metrics; the
    collective math lives in ops/collective_ops.py."""

    def __init__(self, cfg, topology, pset_table):
        self.cfg = cfg
        self.topology = topology
        self.pset_table = pset_table
        self._handles: Dict[int, Handle] = {}
        self._hid = itertools.count(1)
        self._name_counters: Dict[str, itertools.count] = {}
        self._lock = threading.Lock()
        self._release_hooks: list = []
        self.timeline = None
        self.autotuner = None
        self.controller = None      # negotiated-cycle controller (optional)
        self.order_check = None
        if getattr(cfg, "order_check", False):
            from .order_check import OrderCheck
            self.order_check = OrderCheck()
        self._shutdown = False
        self._bytes_processed = _METRICS.counter(
            "hvd_engine_bytes_total",
            "Payload bytes dispatched through the eager engine.")
        self._ops_processed = _METRICS.counter(
            "hvd_engine_ops_total",
            "Eager ops dispatched through the engine (inline path).")
        self.dispatch_latency = _METRICS.histogram(
            "hvd_dispatch_latency_seconds",
            "Host-side dispatch latency per eager launch or agreed "
            "batch (host clock; card work may still be running).",
            buckets=LATENCY_BUCKETS)
        self._bytes_at_start = self._bytes_processed.value()

    # -- naming --------------------------------------------------------------
    def auto_name(self, kind: str) -> str:
        """allreduce.noname.N-style deterministic names
        (reference: horovod/torch/mpi_ops.py name counters)."""
        with self._lock:
            ctr = self._name_counters.setdefault(kind, itertools.count())
            return f"{kind}.noname.{next(ctr)}"

    # -- handle management ---------------------------------------------------
    def new_handle(self, name: str) -> Handle:
        h = Handle(next(self._hid), name)
        with self._lock:
            self._handles[h.id] = h
        return h

    def new_group_handle(self, name: str, children, assemble) -> Handle:
        h = GroupHandle(next(self._hid), name)
        h.children, h.assemble = list(children), assemble
        with self._lock:
            self._handles[h.id] = h
        return h

    def get_handle(self, hid: int) -> Handle:
        with self._lock:
            return self._handles[hid]

    def add_release_hook(self, fn) -> None:
        """Register `fn(hid)` to run whenever a handle id is
        released (idempotent per function object)."""
        with self._lock:
            if fn not in self._release_hooks:
                self._release_hooks.append(fn)

    def release_handle(self, hid: int) -> None:
        with self._lock:
            self._handles.pop(hid, None)
            hooks = list(self._release_hooks)
        for fn in hooks:
            fn(hid)

    # -- execution -----------------------------------------------------------
    def run(self, name: str, nbytes: int,
            fn: Callable[[], Any]) -> Handle:
        """Run `fn` (a closure over the collectives) inline."""
        if self._shutdown:
            raise RuntimeError("horovod_tpu_torch engine is shut down")
        h = self.new_handle(name)
        t0 = time.perf_counter()
        # No cross-rank sequence id inline: subset process-set ops run
        # here on member ranks only (seq=-1 marks a local-only span).
        _tracing.record("dispatch", name)
        try:
            cm = (torch.profiler.record_function(f"hvd::{name}")
                  if _tracing.profiler_active()
                  else contextlib.nullcontext())
            with cm:
                result = fn()
            h.set_result(result)
        except Exception as e:  # noqa: BLE001 — raised at synchronize
            h.set_error(e)
            _tracing.record("error", name)
            return h
        _tracing.record("dispatched", name,
                        arg=time.perf_counter() - t0)
        if self.order_check is not None:
            self.order_check.record(name)
        self.dispatch_latency.observe(time.perf_counter() - t0)
        self._bytes_processed.inc(nbytes)
        self._ops_processed.inc()
        return h

    def synchronize(self, h: Handle) -> Any:
        if isinstance(h, GroupHandle):
            # Drain every child even when one errs, then raise the
            # first error, so no engine handle leaks.
            results, err = [], None
            for c in h.children:
                try:
                    results.append(self.synchronize(c))
                except Exception as e:  # noqa: BLE001 — re-raised
                    err = err or e
            self.release_handle(h.id)
            if err is not None:
                raise err
            return h.assemble(results)
        res = h.wait()
        if h.event is not None:
            torch.cuda.current_stream(h.event_device).wait_event(h.event)
            for t in _cuda_leaves(res):
                t.record_stream(torch.cuda.current_stream(t.device))
        _tracing.record("done", h.name)
        self.release_handle(h.id)
        return res

    def shutdown(self) -> None:
        self._shutdown = True
        if self.controller is not None:
            self.controller.shutdown()
            self.controller = None
        hlog.debug("engine shut down; %d bytes processed",
                   int(self._bytes_processed.value()
                       - self._bytes_at_start))
