"""Inference serving: the request/response plane of
``horovod_tpu/serving.py``, ported to PyTorch.

A request is one array in, one array out. ``submit()`` enqueues it; a
batcher thread cuts a batch at HOROVOD_SERVING_MAX_BATCH or when the
oldest queued request has waited HOROVOD_SERVING_LATENCY_BUDGET_MS;
the batch is padded to a power-of-two ``BucketLadder`` shape (the same
digest string as the JAX package's for the same knobs); a worker thread
that owns one explicit ``torch.device`` runs ``forward_fn(params, x)``
on it; each request's future carries the exactly-once completion latch.
Workers warm every ladder shape at start (``parallel.aot``), so the warm
count is workers x ladder shapes and traffic never grows it. The
``hvd_serving_*`` metrics, the ``serving.batch`` fault seam, the
journal records, request-lifecycle tracing and the postmortem provider
are the JAX module's.

Where it runs: ``ServingFrontend(..., device=None)`` puts its workers
on the local cards, round-robin, and raises RuntimeError when there is
none; ``device="cpu"`` (or one named card) puts every worker there. A
worker never changes device, and a failure in warm-up or in a batch is
counted in ``stats()["worker_failures"]`` with its cause.

bfloat16, declared: the port imports torch and numpy only, and numpy has
no bfloat16 without ml_dtypes, so a bfloat16 row travels as a CPU
``torch.Tensor`` of dtype ``torch.bfloat16``. ``dtype="bfloat16"`` means
requests of ``torch.bfloat16`` (``submit`` converts what it is given and
the padded batch is such a tensor), and a forward that returns bfloat16
gives each request its row as such a tensor. The values are the JAX
package's bfloat16 values; every other dtype travels as numpy, as there.

Not ported yet: the remote pool (``serve_endpoint`` /
``remote_worker_loop``), membership listeners, live weight hot-swap
(``weights=``) and ``write_timeline``.
"""

from __future__ import annotations

import copy
import threading
import time
import weakref
from collections import deque
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from . import faults as _faults
from . import journal as _journal
from . import telemetry as _telemetry
from . import tracing as _tracing
from . import weights as _weights_mod
from .common import config as _config
from .common import logging as hlog
from .common.device import DeviceLike, pool_devices
from .metrics import (COUNT_BUCKETS, REGISTRY as _METRICS,
                      SERVING_LATENCY_BUCKETS,
                      SERVING_PHASE_BUCKETS)
from .parallel.aot import aot_compile

LADDER_SCHEMA = "serving-ladder-v1"

_m_requests = _METRICS.counter(
    "hvd_serving_requests_total",
    "Serving requests by terminal outcome (ok / failed). Zero "
    "dropped requests means submitted == ok + failed at close.",
    ("outcome",))
_m_batches = _METRICS.counter(
    "hvd_serving_batches_total",
    "Dynamic batches admitted, by padded batch-bucket size.",
    ("bucket",))
_m_retries = _METRICS.counter(
    "hvd_serving_retries_total",
    "Batches re-dispatched after a worker died mid-batch, by cause.",
    ("cause",))
_m_latency = _METRICS.histogram(
    "hvd_serving_request_latency_seconds",
    "Submit-to-completion latency per request (queueing + padding + "
    "executable run + any retries).",
    buckets=SERVING_LATENCY_BUCKETS)
_m_batch_size = _METRICS.histogram(
    "hvd_serving_batch_fill",
    "Real (unpadded) requests per admitted batch.",
    buckets=COUNT_BUCKETS)
_m_queue = _METRICS.gauge(
    "hvd_serving_queue_depth",
    "Requests admitted but not yet dispatched to a worker (the "
    "autoscaler's scale-out signal).")
_m_workers = _METRICS.gauge(
    "hvd_serving_workers",
    "Live members of the serving worker pool.")
_m_compiles = _METRICS.counter(
    "hvd_serving_compiles_total",
    "Per-shape warm-ups across the pool (the JAX package's executable "
    "compilations) — bounded by workers x ladder shapes; growth under "
    "traffic means a request shape escaped the bucket ladder.")
_m_padding = _METRICS.counter(
    "hvd_serving_padding_rows_total",
    "Padding rows executed (bucket size minus real batch fill) — "
    "the throughput cost of the no-recompile pin.")
_m_dupes = _METRICS.counter(
    "hvd_serving_duplicates_suppressed_total",
    "Late completions from revenant workers rejected by the "
    "per-request exactly-once latch.")
_m_phase = _METRICS.histogram(
    "hvd_serving_phase_seconds",
    "Per-request lifecycle decomposition (HOROVOD_SERVING_TRACE): "
    "batch_cut (enqueue to batch admission), queue_wait (admission "
    "to worker claim), pad, compute, unpad, complete (unpad to "
    "latch). The winning dispatch attempt's stamps; retries show up "
    "as inflated queue_wait.",
    ("phase",), buckets=SERVING_PHASE_BUCKETS)
_m_goodput = _METRICS.counter(
    "hvd_serving_goodput_total",
    "Requests completed within their SLO deadline, by SLO class "
    "(the slo_ms= passed to submit(); 'default' = the latency "
    "budget / HOROVOD_SERVING_DEFAULT_SLO_MS).",
    ("slo",))
_m_slo_miss = _METRICS.counter(
    "hvd_serving_slo_miss_total",
    "Requests that missed their SLO deadline, by class and reason: "
    "late = completed past the deadline, failed = never completed "
    "(retry budget exhausted or frontend closed).",
    ("slo", "reason"))
_m_loop_occupancy = _METRICS.gauge(
    "hvd_serving_batch_loop_occupancy",
    "Busy fraction of the single dispatch (batcher) loop over the "
    "window since the previous admission — sustained values near "
    "1.0 mean the loop itself serializes scale-out.")
_m_latch_wait = _METRICS.gauge(
    "hvd_serving_latch_wait_seconds",
    "Wall seconds the most recent completing worker spent inside "
    "_complete_batch (per-request latches + the frontend lock) — "
    "the completion-side serialization cost per batch.")


class ServingError(RuntimeError):
    """A request failed visibly (retry budget exhausted / shutdown)."""


class _WorkerDied(RuntimeError):
    """Internal: the serving.batch seam's 'error' action."""


# ---------------------------------------------------------------------------
# Bucket ladder


class BucketLadder(NamedTuple):
    """Deterministic padded-shape ladder. `digest` is the canonical
    string every process derives identically from the same knobs —
    the cross-process pin (same idiom as OverlapPlan's assignment
    digest): frontends and workers that disagree on it would compile
    different executable sets, and comparing digests catches that
    before any batch is dispatched."""

    batch_buckets: Tuple[int, ...]
    len_buckets: Tuple[int, ...]  # () = fixed-shape requests
    digest: str

    def batch_bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        raise ServingError(
            f"batch of {n} exceeds ladder max {self.batch_buckets[-1]}")

    def len_bucket(self, length: int) -> int:
        for b in self.len_buckets:
            if b >= length:
                return b
        raise ServingError(
            f"request length {length} exceeds ladder max "
            f"{self.len_buckets[-1]}")

    def shapes(self, feature_shape: Sequence[int]
               ) -> List[Tuple[int, ...]]:
        """Every padded executable shape the ladder admits."""
        feats = tuple(feature_shape)
        if not self.len_buckets:
            return [(b,) + feats for b in self.batch_buckets]
        return [(b, l) + feats
                for b in self.batch_buckets for l in self.len_buckets]


def _pow2_ladder(lo: int, hi: int) -> Tuple[int, ...]:
    rungs = []
    b = lo
    while b < hi:
        rungs.append(b)
        b *= 2
    rungs.append(hi)
    return tuple(rungs)


def build_ladder(max_batch: Optional[int] = None,
                 max_len: Optional[int] = None,
                 env: Optional[Dict[str, str]] = None) -> BucketLadder:
    """Build the ladder from the HOROVOD_SERVING_* knobs (or explicit
    overrides): powers of two up to max_batch on the batch axis, and
    — when max_len > 0 — powers of two from 16 up to max_len on the
    variable leading axis."""
    if max_batch is None:
        max_batch = _config.env_value("HOROVOD_SERVING_MAX_BATCH",
                                      env=env)
    if max_len is None:
        max_len = _config.env_value("HOROVOD_SERVING_MAX_LEN", env=env)
    if max_batch < 1:
        raise ValueError(f"HOROVOD_SERVING_MAX_BATCH must be >= 1, "
                         f"got {max_batch}")
    batch = _pow2_ladder(1, max_batch)
    lens: Tuple[int, ...] = ()
    if max_len and max_len > 0:
        lens = ((max_len,) if max_len <= 16
                else _pow2_ladder(16, max_len))
    digest = "{}|b={}|l={}".format(
        LADDER_SCHEMA, ",".join(str(b) for b in batch),
        ",".join(str(l) for l in lens) or "-")
    return BucketLadder(batch, lens, digest)


# ---------------------------------------------------------------------------
# Requests and batches

# Lifecycle phases, in request order. Every completed request's
# latency decomposes exactly into these (stamps from the winning
# dispatch attempt): batch_cut = enqueue to batch admission,
# queue_wait = admission to worker claim (inflated by retries — a
# requeued batch goes back through the dispatch queue), pad = claim
# to executable entry (padding + host→device transfer), compute =
# executable run (for remote members: the pull→push round trip,
# wire included), unpad = output slicing, complete = unpad to the
# exactly-once latch. serving_trace.py carries the same list.
PHASES = ("batch_cut", "queue_wait", "pad", "compute", "unpad",
          "complete")


def _pct(sorted_vals: Sequence[int], q: float) -> int:
    """Nearest-rank percentile over an already-sorted sequence —
    deterministic (no interpolation), shared with serving_trace.py's
    offline aggregation so live digests and doctor-serve reports
    agree bit-for-bit on the same samples."""
    if not sorted_vals:
        return 0
    rank = max(1, int(-(-q * len(sorted_vals) // 1)))  # ceil
    return sorted_vals[min(len(sorted_vals), rank) - 1]


class _Hop:
    """One dispatch attempt of one batch: which worker claimed it and
    the monotonic-ns stamps of its execution edges. The winning hop's
    stamps become the requests' phase decomposition; losing hops keep
    their outcome (`retried:<cause>`) so retry chains reconstruct as
    linked child spans in `write_timeline()` and `doctor serve`."""

    __slots__ = ("worker", "attempt", "t_claim_ns", "t_exec0_ns",
                 "t_exec1_ns", "t_unpad1_ns", "outcome")

    def __init__(self, worker: str, attempt: int):
        self.worker = worker
        self.attempt = attempt
        self.t_claim_ns = time.monotonic_ns()
        self.t_exec0_ns = 0
        self.t_exec1_ns = 0
        self.t_unpad1_ns = 0
        self.outcome = "pending"

    def summary(self) -> List[Any]:
        return [self.worker, self.attempt, self.outcome,
                self.t_claim_ns]


class ServingFuture:
    """One request's handle. `result()` blocks until the request
    completes (the padded row of the executable's output) or fails
    with ServingError. The `_finish` latch is the exactly-once
    guarantee: whichever worker finishes first wins, every later
    completion is suppressed and counted."""

    def __init__(self, req_id: str, payload: np.ndarray,
                 slo_ms: float = 0.0, slo_class: str = "default"):
        self.id = req_id
        self.payload = payload
        self.t_submit = time.monotonic()
        self.t_submit_ns = time.monotonic_ns()
        self.t_done: Optional[float] = None
        self.t_done_ns = 0
        self.slo_ms = slo_ms
        self.slo_class = slo_class
        # Deadline on the same clock as t_submit/t_done; 0 slo means
        # no deadline was derivable (goodput then counts it a hit).
        self.deadline = (self.t_submit + slo_ms / 1e3 if slo_ms > 0
                         else float("inf"))
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def _finish(self, value: Any = None,
                error: Optional[BaseException] = None) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._value, self._error = value, error
            self.t_done = time.monotonic()
            self.t_done_ns = time.monotonic_ns()
            self._event.set()
            return True

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.id} still pending")
        if self._error is not None:
            raise self._error
        return self._value


class _Batch:
    __slots__ = ("id", "requests", "bucket_b", "bucket_len",
                 "attempts", "t_admitted", "t_admit_ns", "hops")

    def __init__(self, bid: str, requests: List[ServingFuture],
                 bucket_b: int, bucket_len: int):
        self.id = bid
        self.requests = requests
        self.bucket_b = bucket_b
        self.bucket_len = bucket_len
        self.attempts = 0
        self.t_admitted = time.monotonic()
        self.t_admit_ns = time.monotonic_ns()
        self.hops: List[_Hop] = []

    @property
    def done(self) -> bool:
        return all(r.done for r in self.requests)


# ---------------------------------------------------------------------------
# Local (in-process) worker


def _on_device(params: Any, device: torch.device) -> Any:
    """``params`` (an nn.Module or a {name: tensor} dict) on
    ``device``: itself when it is already there, else a copy."""
    if isinstance(params, torch.nn.Module):
        if all(t.device == device for t in params.state_dict().values()):
            return params
        return copy.deepcopy(params).to(device)
    return {k: v.to(device) for k, v in params.items()}


class _LocalWorker:
    """One pool member: a thread owning one explicit torch.device and
    the set of ladder shapes it has warmed, all of them at start
    (pinned against growth by `compiles`, which traffic must never
    grow)."""

    def __init__(self, frontend: "ServingFrontend", wid: str,
                 device: torch.device):
        self.frontend = frontend
        self.wid = wid
        self.device = device
        self.compiles = 0
        self._warm: Dict[Tuple[int, ...], Callable] = {}
        self._params = None
        self._w_digest = frontend._params0_digest
        self._thread = threading.Thread(
            target=self._run, name=f"hvd-serving-{wid}", daemon=True)
        self._thread.start()

    def _get_exec(self, shape: Tuple[int, ...]) -> Callable:
        fn = self._warm.get(shape)
        if fn is None:
            ex = torch.zeros(shape, dtype=self.frontend._torch_dtype,
                             device=self.device)
            if self._params is not None:
                fn = aot_compile(self.frontend._forward, self._params, ex)
            else:
                fn = aot_compile(self.frontend._forward, ex)
            self._warm[shape] = fn
            self.compiles += 1
            _m_compiles.inc()
        return fn

    def _run(self) -> None:
        fe = self.frontend
        try:
            if fe._params0 is not None:
                self._params = _on_device(fe._params0, self.device)
            for shape in fe.ladder.shapes(fe._feature_shape):
                self._get_exec(shape)
        except Exception as e:  # noqa: BLE001 — warmup must not hang pool
            hlog.error("serving: worker %s warmup failed: %s",
                       self.wid, e)
            fe._worker_failed(self.wid, "warmup", e)
            return
        while True:
            if fe._retired(self.wid):
                return
            batch = fe._next_batch(self.wid, timeout=0.05)
            if batch is None:
                if fe._closing:
                    return
                continue
            try:
                act = _faults.fire("serving.batch", exc=_WorkerDied,
                                   tag=self.wid)
            except _WorkerDied as e:
                # Injected mid-batch death: this member is gone; the
                # frontend requeues the batch on a survivor.
                fe._worker_failed(self.wid, "fault_error", e)
                return
            if act == "hang":
                # Park holding the batch until well past the dispatch
                # deadline (the watchdog requeues it), then fall
                # through and attempt completion anyway — the revenant
                # path the exactly-once latch must absorb.
                t_end = time.monotonic() + 4 * fe._worker_timeout
                while time.monotonic() < t_end and not fe._closing:
                    time.sleep(0.02)
            try:
                rows = self._execute(batch)
            except Exception as e:  # noqa: BLE001
                hlog.error("serving: worker %s failed batch %s: %s",
                           self.wid, batch.id, e)
                fe._worker_failed(self.wid, "execute_error", e)
                return
            fe._complete_batch(batch, rows, self.wid,
                               weights=self._w_digest)

    def _execute(self, batch: _Batch) -> List[np.ndarray]:
        fe = self.frontend
        hop = fe._hop_for(batch, self.wid) if fe._trace else None
        arr = fe._pad(batch)
        x = (arr if isinstance(arr, torch.Tensor)
             else torch.from_numpy(arr)).to(self.device)
        if hop is not None:
            hop.t_exec0_ns = time.monotonic_ns()
            _tracing.record("serving_exec", batch.id,
                            seq=batch.attempts,
                            arg=float(batch.bucket_b))
        ex = self._get_exec(tuple(arr.shape))
        with torch.inference_mode():
            y = (ex(self._params, x) if self._params is not None
                 else ex(x))
        y = y.cpu()
        if y.dtype != torch.bfloat16:         # bf16 rows stay tensors
            y = y.numpy()
        if hop is not None:
            hop.t_exec1_ns = time.monotonic_ns()
        rows = fe._unpad(batch, y)
        if hop is not None:
            hop.t_unpad1_ns = time.monotonic_ns()
        return rows


# ---------------------------------------------------------------------------
# Frontend

# Live frontends, for the postmortem provider below: a SIGKILLed (or
# watchdog-dumped) process's postmortem-rank{r}.json must name the
# requests that were in flight and their last completed phase, or a
# death under load silently loses that attribution.
_live_frontends: "weakref.WeakSet" = weakref.WeakSet()


class ServingFrontend:
    """Request admission, dynamic batching, dispatch, retry, and pool
    management. See the module docstring; every tunable is a declared
    HOROVOD_SERVING_* knob (env overridable per-instance via
    ``env=``). With ``params`` the forward is two-arg (params, x) and
    every worker serves ``params`` on its own device. ``device``: see
    the module docstring."""

    def __init__(self, forward_fn: Callable,
                 feature_shape: Sequence[int],
                 dtype: str = "float32", *,
                 env: Optional[Dict[str, str]] = None,
                 start_pool: bool = True,
                 autoscale: bool = True,
                 trace_tag: Optional[str] = None,
                 params: Optional[Any] = None,
                 device: DeviceLike = None):
        self._devices = pool_devices(device, "ServingFrontend")
        self._forward = forward_fn
        self._feature_shape = tuple(int(d) for d in feature_shape)
        if str(dtype) in ("bfloat16", "torch.bfloat16"):
            self._dtype = None                # rows are torch.bfloat16
            self._torch_dtype = torch.bfloat16
        else:
            self._dtype = np.dtype(dtype)
            self._torch_dtype = torch.from_numpy(
                np.zeros((), self._dtype)).dtype
        self._params0 = params
        self._params0_digest = ""
        if params is not None:
            self._params0_digest = _weights_mod.content_digest(
                _weights_mod.named_leaves(params))
        self.ladder = build_ladder(env=env)
        ev = lambda name: _config.env_value(name, env=env)  # noqa: E731
        self._max_batch = ev("HOROVOD_SERVING_MAX_BATCH")
        self._budget_s = ev("HOROVOD_SERVING_LATENCY_BUDGET_MS") / 1e3
        self._min_workers = ev("HOROVOD_SERVING_MIN_WORKERS")
        self._max_workers = ev("HOROVOD_SERVING_MAX_WORKERS")
        self._scale_interval = ev("HOROVOD_SERVING_SCALE_INTERVAL_S")
        self._scale_up_queue = ev("HOROVOD_SERVING_SCALE_UP_QUEUE")
        self._scale_down_idle = ev("HOROVOD_SERVING_SCALE_DOWN_IDLE_S")
        self._retry_limit = ev("HOROVOD_SERVING_RETRY_LIMIT")
        self._worker_timeout = ev("HOROVOD_SERVING_WORKER_TIMEOUT_S")
        self._trace = bool(ev("HOROVOD_SERVING_TRACE"))
        default_slo = ev("HOROVOD_SERVING_DEFAULT_SLO_MS")
        self._default_slo_ms = (default_slo if default_slo > 0
                                else self._budget_s * 1e3)
        self._trace_log: deque = deque(
            maxlen=max(1, ev("HOROVOD_SERVING_TRACE_BUFFER")))
        self.trace_tag = trace_tag

        self._lock = threading.RLock()
        self._queue_cond = threading.Condition(self._lock)
        self._dispatch_cond = threading.Condition(self._lock)
        self._queue: deque = deque()          # ServingFuture
        self._ready: deque = deque()          # _Batch
        self._inflight: Dict[str, Tuple[_Batch, str, float]] = {}
        self._batches: Dict[str, _Batch] = {}
        self._workers: Dict[str, Any] = {}
        self._closing = False
        self._draining = False
        self._req_seq = 0
        self._batch_seq = 0
        self._worker_seq = 0
        self._last_nonempty = time.monotonic()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.admitted = 0
        self.retries = 0
        self.dupes = 0
        self.scale_events = 0
        # (worker, cause, error text) of every pool member that died.
        self.worker_failures: List[Tuple[str, str, str]] = []

        _journal.configure(f"serving-{trace_tag}" if trace_tag
                           else "serving", env=env)
        # Health telemetry rides the same role naming so one record
        # dir collects journal + telemetry shards side by side
        # (disarmed when HOROVOD_TELEMETRY_DIR is unset).
        _telemetry.configure(f"serving-{trace_tag}" if trace_tag
                             else "serving", env=env)
        _journal.record(
            "serving_meta", ladder=self.ladder.digest,
            max_batch=self._max_batch,
            budget_ms=round(self._budget_s * 1e3, 3),
            trace=self._trace,
            default_slo_ms=round(self._default_slo_ms, 3),
            tag=trace_tag or "", weights="")
        _live_frontends.add(self)
        self._batcher = threading.Thread(
            target=self._batch_loop, name="hvd-serving-batcher",
            daemon=True)
        self._batcher.start()
        self._watchdog = threading.Thread(
            target=self._watchdog_loop, name="hvd-serving-watchdog",
            daemon=True)
        self._watchdog.start()
        if autoscale:
            self._autoscaler = threading.Thread(
                target=self._autoscale_loop,
                name="hvd-serving-autoscaler", daemon=True)
            self._autoscaler.start()
        if start_pool:
            self.start_pool(self._min_workers)

    # -- pool management ----------------------------------------------------

    def start_pool(self, n: Optional[int] = None,
                   reason: str = "start") -> None:
        """Grow the local pool to ``n`` workers (default the floor),
        round-robin over the frontend's devices."""
        target = self._min_workers if n is None else n
        with self._lock:
            cur = len(self._workers)
        if target > cur:
            self._resize(target, reason)

    def _add_local_worker(self) -> None:
        with self._lock:
            wid = f"w{self._worker_seq}"
            self._worker_seq += 1
            dev = self._devices[(self._worker_seq - 1)
                                % len(self._devices)]
            self._workers[wid] = _LocalWorker(self, wid, dev)
            _m_workers.set(len(self._workers))

    def _resize(self, target: int, reason: str,
                **extra: Any) -> None:
        target = max(self._min_workers,
                     min(self._max_workers, target))
        with self._lock:
            before = len(self._workers)
            qdepth = len(self._ready)
        if target == before:
            return
        while len(self._workers) < target:
            self._add_local_worker()
        with self._lock:
            while len(self._workers) > target:
                # Retire the newest idle-eligible member; its loop
                # observes the membership loss and exits cleanly.
                wid = next(reversed(self._workers))
                self._workers.pop(wid)
            after = len(self._workers)
            _m_workers.set(after)
            self.scale_events += 1
        _journal.record(
            "scale_event",
            direction="up" if after > before else "down",
            workers_from=before, workers_to=after,
            queue_depth=qdepth, reason=reason, **extra)

    def _retired(self, wid: str) -> bool:
        with self._lock:
            return wid not in self._workers

    def _worker_failed(self, wid: str, cause: str,
                       error: Optional[BaseException] = None) -> None:
        with self._lock:
            self.worker_failures.append(
                (wid, cause, repr(error) if error is not None else ""))
            known = self._workers.pop(wid, None)
            _m_workers.set(len(self._workers))
            doomed = [b for b, (bt, owner, _) in
                      list(self._inflight.items()) if owner == wid]
            batches = [self._inflight.pop(bid)[0] for bid in doomed]
            before = len(self._workers) + (1 if known else 0)
            if known is not None:
                self.scale_events += 1
        if known is not None:
            _journal.record("scale_event", direction="down",
                            workers_from=before, workers_to=before - 1,
                            queue_depth=len(self._ready),
                            reason=f"worker_death:{cause}", worker=wid)
        for batch in batches:
            self._retry(batch, cause, wid)

    # -- admission / batching -----------------------------------------------

    def submit(self, x: Any,
               slo_ms: Optional[float] = None) -> ServingFuture:
        """Enqueue one request. ``slo_ms`` sets its completion
        deadline (and goodput class); None means the default class
        (HOROVOD_SERVING_DEFAULT_SLO_MS, falling back to the latency
        budget)."""
        if self._dtype is None:
            arr = torch.as_tensor(np.asarray(x) if not isinstance(
                x, torch.Tensor) else x).to("cpu", torch.bfloat16)
        else:
            arr = np.asarray(x, dtype=self._dtype)
        if self.ladder.len_buckets:
            want = self._feature_shape
            if arr.ndim != len(want) + 1 or arr.shape[1:] != want:
                raise ValueError(
                    f"request shape {arr.shape} != (L, {want})")
            self.ladder.len_bucket(arr.shape[0])  # validates length
        elif arr.shape != self._feature_shape:
            raise ValueError(
                f"request shape {arr.shape} != {self._feature_shape}")
        if slo_ms is None:
            eff_slo, slo_class = self._default_slo_ms, "default"
        else:
            eff_slo = float(slo_ms)
            slo_class = f"{eff_slo:g}ms"
        with self._lock:
            if self._closing or self._draining:
                raise ServingError("frontend is shutting down")
            self._req_seq += 1
            fut = ServingFuture(f"r{self._req_seq}", arr,
                                slo_ms=eff_slo, slo_class=slo_class)
            self._queue.append(fut)
            self.submitted += 1
            self._last_nonempty = time.monotonic()
            _m_queue.set(self._pending_locked())
            self._queue_cond.notify()
            if self._trace:
                _tracing.record("serving_submit", fut.id,
                                seq=self._req_seq)
        return fut

    def _pending_locked(self) -> int:
        return (len(self._queue)
                + sum(len(b.requests) for b in self._ready))

    def _cut_ready_locked(self) -> bool:
        if not self._queue:
            return False
        if self._draining or len(self._queue) >= self._max_batch:
            return True
        oldest = self._queue[0].t_submit
        return (time.monotonic() - oldest) >= self._budget_s

    def _batch_loop(self) -> None:
        # Occupancy: the busy fraction of this (single) loop since
        # the previous admission — everything that is not blocked in
        # cond.wait(). Sustained ~1.0 under scale-out is the "the
        # batcher loop is the bottleneck" signal ROADMAP item 2 asks
        # tracing to confirm or refute.
        win0_ns = time.monotonic_ns()
        idle_ns = 0
        while True:
            # Telemetry beat at the loop's natural tick: samples (and
            # the stall dual that catches a loop that STOPPED beating)
            # key on it. One load + compare when disarmed.
            _telemetry.beat("serving")
            with self._queue_cond:
                while not self._cut_ready_locked():
                    if self._closing and not self._queue:
                        return
                    wait = None
                    if self._queue:
                        wait = max(0.001, self._budget_s - (
                            time.monotonic()
                            - self._queue[0].t_submit))
                    t0_ns = time.monotonic_ns()
                    self._queue_cond.wait(wait)
                    idle_ns += time.monotonic_ns() - t0_ns
                batch = self._admit_locked()
                self._dispatch_cond.notify_all()
            now_ns = time.monotonic_ns()
            if now_ns > win0_ns:
                _m_loop_occupancy.set(
                    max(0.0, 1.0 - idle_ns / (now_ns - win0_ns)))
            win0_ns, idle_ns = now_ns, 0
            if self._trace:
                _tracing.record("serving_cut", batch.id,
                                seq=batch.attempts,
                                arg=float(len(batch.requests)))
            _journal.record(
                "batch_admitted", batch=batch.id,
                size=len(batch.requests), bucket=batch.bucket_b,
                bucket_len=batch.bucket_len or None,
                queue_depth=len(self._ready),
                wait_ms=round(1e3 * (time.monotonic()
                                     - batch.requests[0].t_submit), 3))

    def _admit_locked(self) -> _Batch:
        take = min(len(self._queue), self._max_batch)
        reqs = [self._queue.popleft() for _ in range(take)]
        bucket_b = self.ladder.batch_bucket(take)
        bucket_len = 0
        if self.ladder.len_buckets:
            bucket_len = max(self.ladder.len_bucket(r.payload.shape[0])
                             for r in reqs)
        self._batch_seq += 1
        batch = _Batch(f"b{self._batch_seq}", reqs, bucket_b,
                       bucket_len)
        self._batches[batch.id] = batch
        self._ready.append(batch)
        self.admitted += 1
        _m_batches.labels(bucket=str(bucket_b)).inc()
        _m_batch_size.observe(float(take))
        _m_padding.inc(float(bucket_b - take))
        _m_queue.set(self._pending_locked())
        return batch

    # -- dispatch / completion ----------------------------------------------

    def _next_batch(self, wid: str,
                    timeout: float) -> Optional[_Batch]:
        deadline = time.monotonic() + timeout
        with self._dispatch_cond:
            while not self._ready:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closing:
                    return None
                self._dispatch_cond.wait(remaining)
            batch = self._ready.popleft()
            self._inflight[batch.id] = (
                batch, wid,
                time.monotonic() + self._worker_timeout)
            if self._trace:
                batch.hops.append(_Hop(wid, batch.attempts))
                _tracing.record("serving_claim", batch.id,
                                seq=batch.attempts)
            _m_queue.set(self._pending_locked())
            return batch

    def _hop_for(self, batch: _Batch,
                 wid: str) -> Optional[_Hop]:
        """The newest dispatch attempt `wid` owns (a revenant worker
        matches its own old hop, never the current owner's)."""
        for hop in reversed(batch.hops):
            if hop.worker == wid:
                return hop
        return None

    def _zeros(self, shape: Tuple[int, ...]):
        if self._dtype is None:
            return torch.zeros(shape, dtype=torch.bfloat16)
        return np.zeros(shape, dtype=self._dtype)

    def _pad(self, batch: _Batch):
        if batch.bucket_len:
            out = self._zeros((batch.bucket_b, batch.bucket_len)
                              + self._feature_shape)
            for i, r in enumerate(batch.requests):
                out[i, :r.payload.shape[0]] = r.payload
        else:
            out = self._zeros((batch.bucket_b,) + self._feature_shape)
            for i, r in enumerate(batch.requests):
                out[i] = r.payload
        return out

    def _unpad(self, batch: _Batch, y: np.ndarray) -> List[np.ndarray]:
        rows = []
        for i, r in enumerate(batch.requests):
            row = y[i]
            if (batch.bucket_len and row.ndim >= 1
                    and row.shape[0] == batch.bucket_len):
                # The forward kept the padded length axis: return only
                # the request's true length.
                row = row[:r.payload.shape[0]]
            rows.append(row if isinstance(row, torch.Tensor)
                        else np.asarray(row))
        return rows

    def _complete_batch(self, batch: _Batch,
                        rows: Sequence[np.ndarray],
                        wid: str, weights: str = "") -> int:
        t0_ns = time.monotonic_ns()
        now = time.monotonic()
        won = 0
        dup = 0
        winners: List[ServingFuture] = []
        for req, row in zip(batch.requests, rows):
            if req._finish(value=row):
                won += 1
                winners.append(req)
                _m_requests.labels(outcome="ok").inc()
                _m_latency.observe(now - req.t_submit)
                if req.t_done is not None \
                        and req.t_done <= req.deadline:
                    _m_goodput.labels(slo=req.slo_class).inc()
                else:
                    _m_slo_miss.labels(slo=req.slo_class,
                                       reason="late").inc()
            else:
                dup += 1
                _m_dupes.inc()
        with self._lock:
            self.completed += won
            self.dupes += dup
            ent = self._inflight.get(batch.id)
            if ent is not None and (ent[1] == wid or batch.done):
                self._inflight.pop(batch.id, None)
            if batch.done:
                self._batches.pop(batch.id, None)
                try:
                    self._ready.remove(batch)
                except ValueError:
                    pass
            _m_queue.set(self._pending_locked())
            if not self._queue and not self._ready:
                self._last_nonempty = now
        if self._trace and won:
            self._finalize_traces(batch, winners, wid, weights)
            _tracing.record("serving_done", batch.id,
                            seq=batch.attempts, arg=float(won))
        _m_latch_wait.set((time.monotonic_ns() - t0_ns) / 1e9)
        return won

    def _finalize_traces(self, batch: _Batch,
                         winners: Sequence[ServingFuture],
                         wid: str, weights: str = "") -> None:
        """Fold the winning hop's stamps into per-request trace
        records (ring buffer + phase histograms) and one `batch_trace`
        journal event `doctor serve` aggregates offline."""
        hop = self._hop_for(batch, wid)
        if hop is None:
            return
        hop.outcome = "ok"
        hops = [h.summary() for h in batch.hops]
        recs = []
        for req in winners:
            phases = {
                "batch_cut": batch.t_admit_ns - req.t_submit_ns,
                "queue_wait": hop.t_claim_ns - batch.t_admit_ns,
                "pad": hop.t_exec0_ns - hop.t_claim_ns,
                "compute": hop.t_exec1_ns - hop.t_exec0_ns,
                "unpad": hop.t_unpad1_ns - hop.t_exec1_ns,
                "complete": req.t_done_ns - hop.t_unpad1_ns,
            }
            phases = {p: max(0, int(d)) for p, d in phases.items()}
            rec = {
                "id": req.id, "batch": batch.id, "worker": wid,
                "attempt": batch.attempts,
                "slo": req.slo_class,
                "slo_ms": round(req.slo_ms, 3),
                "outcome": ("ok" if req.t_done is not None
                            and req.t_done <= req.deadline
                            else "late"),
                "t_submit_ns": req.t_submit_ns,
                "t_done_ns": req.t_done_ns,
                "phases_ns": phases,
                "hops": hops,
                # Epoch-fence witness: the single weight-version
                # digest this request's winning batch executed on.
                "weights": weights,
            }
            recs.append(rec)
            for phase, dns in phases.items():
                _m_phase.labels(phase=phase).observe(dns / 1e9)
        with self._lock:
            self._trace_log.extend(recs)
        _journal.record(
            "batch_trace", batch=batch.id, worker=wid,
            attempt=batch.attempts, bucket=batch.bucket_b,
            size=len(winners),
            requests=[r["id"] for r in recs],
            slo=[r["slo"] for r in recs],
            deadline_hit=[r["outcome"] == "ok" for r in recs],
            submit_ns=[r["t_submit_ns"] for r in recs],
            done_ns=[r["t_done_ns"] for r in recs],
            admit_ns=batch.t_admit_ns, claim_ns=hop.t_claim_ns,
            exec0_ns=hop.t_exec0_ns, exec1_ns=hop.t_exec1_ns,
            unpad_ns=hop.t_unpad1_ns, hops=hops, weights=weights)

    def _retry(self, batch: _Batch, cause: str, wid: str) -> None:
        if batch.done:
            return
        if self._trace:
            hop = self._hop_for(batch, wid)
            if hop is not None and hop.outcome == "pending":
                hop.outcome = f"retried:{cause}"
            _tracing.record("serving_retry", batch.id,
                            seq=batch.attempts + 1)
        batch.attempts += 1
        if batch.attempts > self._retry_limit:
            lost = 0
            lost_slo = []
            for req in batch.requests:
                if req._finish(error=ServingError(
                        f"request {req.id} failed after "
                        f"{batch.attempts} dispatch attempts "
                        f"(last cause: {cause})")):
                    lost += 1
                    lost_slo.append(req.slo_class)
                    _m_requests.labels(outcome="failed").inc()
                    _m_slo_miss.labels(slo=req.slo_class,
                                       reason="failed").inc()
            with self._lock:
                self.failed += lost
                self._batches.pop(batch.id, None)
            _journal.record(
                "batch_failed", batch=batch.id,
                attempts=batch.attempts, cause=cause, worker=wid,
                lost=lost, slo=lost_slo,
                hops=[h.summary() for h in batch.hops])
            return
        with self._lock:
            self.retries += 1
        _m_retries.labels(cause=cause).inc()
        _journal.record("batch_retried", batch=batch.id,
                        attempt=batch.attempts, cause=cause,
                        worker=wid,
                        pending=sum(1 for r in batch.requests
                                    if not r.done))
        with self._lock:
            self._ready.appendleft(batch)
            _m_queue.set(self._pending_locked())
            self._dispatch_cond.notify_all()

    def _watchdog_loop(self) -> None:
        while not self._closing:
            time.sleep(min(0.05, self._worker_timeout / 4))
            now = time.monotonic()
            with self._lock:
                expired = sorted({wid for _, (b, wid, dl)
                                  in self._inflight.items()
                                  if dl < now})
            for wid in expired:
                hlog.warning("serving: worker %s missed the batch "
                             "deadline; requeueing its work", wid)
                self._worker_failed(wid, "timeout")

    def _autoscale_loop(self) -> None:
        while not self._closing:
            time.sleep(self._scale_interval)
            if self._closing or self._draining:
                continue
            with self._lock:
                qdepth = len(self._ready)
                n = len(self._workers)
                busy = bool(self._inflight or self._queue
                            or self._ready)
                idle_for = time.monotonic() - self._last_nonempty
            if n < self._min_workers:
                # A death took the pool below the floor; restore it.
                self._resize(self._min_workers, "floor")
            elif qdepth > self._scale_up_queue * max(1, n) \
                    and n < self._max_workers:
                self._resize(n + 1, "queue_depth")
            elif (not busy and n > self._min_workers
                    and idle_for > self._scale_down_idle):
                self._resize(n - 1, "idle")

    # -- lifecycle ----------------------------------------------------------

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admission, flush every queued request through the
        pool; True when nothing is left pending."""
        with self._lock:
            self._draining = True
            self._queue_cond.notify_all()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not (self._queue or self._ready or self._inflight
                        or self._batches):
                    return True
            time.sleep(0.01)
        return False

    def close(self, timeout: float = 30.0) -> None:
        drained = self.drain(timeout)
        if not drained:
            hlog.warning("serving: close() draining timed out; "
                         "failing the stragglers")
            with self._lock:
                stuck = list(self._batches.values())
            lost = 0
            for batch in stuck:
                for req in batch.requests:
                    if req._finish(error=ServingError(
                            "frontend closed before completion")):
                        lost += 1
                        _m_requests.labels(outcome="failed").inc()
                        _m_slo_miss.labels(slo=req.slo_class,
                                           reason="failed").inc()
            with self._lock:
                self.failed += lost
        with self._lock:
            self._closing = True
            self._queue_cond.notify_all()
            self._dispatch_cond.notify_all()
            self._workers.clear()
            _m_workers.set(0)
        self._batcher.join(timeout=2)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            compiles = sum(getattr(w, "compiles", 0)
                           for w in self._workers.values())
            workers = len(self._workers)
        out = {
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "dropped": self.submitted - self.completed - self.failed,
            "batches": self.admitted,
            "retries": self.retries,
            "duplicates_suppressed": self.dupes,
            "scale_events": self.scale_events,
            "workers": workers,
            "compiles": compiles,
            "worker_failures": [list(f) for f in self.worker_failures],
            "ladder": {
                "batch_buckets": list(self.ladder.batch_buckets),
                "len_buckets": list(self.ladder.len_buckets),
                "digest": self.ladder.digest,
            },
        }
        if self._trace:
            out["trace"] = self.trace_digest()
        return out

    # -- trace queries --------------------------------------------------------

    def traces(self) -> List[Dict[str, Any]]:
        """The retained per-request trace records (newest last,
        bounded by HOROVOD_SERVING_TRACE_BUFFER)."""
        with self._lock:
            return list(self._trace_log)

    def trace_digest(self) -> Dict[str, Any]:
        """Per-phase p50/p99/mean decomposition over the retained
        traces, plus goodput-vs-SLO tallies — the live (in-memory)
        view of what `doctor serve` computes offline from journals."""
        recs = self.traces()
        by_phase: Dict[str, List[int]] = {p: [] for p in PHASES}
        goodput: Dict[str, Dict[str, int]] = {}
        for rec in recs:
            cls = goodput.setdefault(
                rec["slo"], {"hit": 0, "late": 0, "failed": 0})
            cls[rec["outcome"] if rec["outcome"] != "ok"
                else "hit"] += 1
            for p, dns in rec["phases_ns"].items():
                if p in by_phase:
                    by_phase[p].append(dns)
        phases = {}
        for p in PHASES:
            vals = sorted(by_phase[p])
            if not vals:
                phases[p] = {"n": 0}
                continue
            phases[p] = {
                "n": len(vals),
                "p50_ms": round(_pct(vals, 0.50) / 1e6, 4),
                "p99_ms": round(_pct(vals, 0.99) / 1e6, 4),
                "mean_ms": round(sum(vals) / len(vals) / 1e6, 4),
            }
        return {"requests": len(recs), "phases": phases,
                "goodput": goodput}

    def _inflight_table(self) -> Dict[str, Any]:
        # Postmortem provider path: deliberately lock-free (the dump
        # may fire with self._lock held by a dying thread); dict/deque
        # snapshots are GIL-atomic enough for a best-effort table.
        batches = []
        for batch in list(self._batches.values()):
            hops = list(batch.hops)
            last = hops[-1] if hops else None
            if last is None:
                phase = "queued"
            elif last.t_unpad1_ns:
                phase = "complete"
            elif last.t_exec1_ns:
                phase = "unpad"
            elif last.t_exec0_ns:
                phase = "compute"
            else:
                phase = "pad"
            batches.append({
                "batch": batch.id,
                "attempts": batch.attempts,
                "worker": last.worker if last else None,
                "last_phase": phase,
                "requests": [r.id for r in batch.requests],
                "pending": sum(1 for r in batch.requests
                               if not r.done),
            })
        return {
            "tag": self.trace_tag or "",
            "queued": [r.id for r in list(self._queue)],
            "batches": sorted(batches, key=lambda b: b["batch"]),
        }


# ---------------------------------------------------------------------------
# Postmortem provider

# Rides tracing.write_postmortem's provider hook: every postmortem
# dump (watchdog stall, fatal signal) gets a "serving" section with
# each live frontend's queued request ids and in-flight batches with
# their last completed phase — the SIGKILL story the in-memory trace
# log alone cannot tell, because it dies with the process while the
# postmortem file survives it.


def _postmortem_inflight() -> List[Dict[str, Any]]:
    return [fe._inflight_table() for fe in list(_live_frontends)]


_tracing.register_postmortem_provider("serving", _postmortem_inflight)
