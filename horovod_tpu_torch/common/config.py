"""Central configuration registry for horovod_tpu.

Port copy (horovod_tpu_torch): the same knobs, types and defaults as
the JAX package's registry. Deliberate differences, each pinned by
tests/test_torch_port_isolation.py: this paragraph; the doc of
HOROVOD_FLASH_ATTENTION, which here says the port does not read it; the
docs of the four HOROVOD_COMPRESSION knobs, which describe the port's
two planes; and the registry path named in the unknown-knob errors.

Environment variables are the config system, mirroring the reference
(reference: horovod/common/utils/env_parser.cc — SetBoolFromEnv /
ParseStallInspectorFromEnv; constants declared in horovod/common/common.h).
Every knob is declared here once with its env name, type, default and doc,
so `hvdrun --help` and the doctor can enumerate them.

The reference's HOROVOD_* names are kept verbatim where the concept carries
over so users migrating from Horovod find the same switches; TPU-specific
knobs use the same prefix for a single coherent namespace.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional


def _parse_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class Knob:
    env: str
    type: Callable[[str], Any]
    default: Any
    doc: str


# Registry of every configuration knob. Order matters only for docs.
KNOBS: List[Knob] = [
    # -- core engine ---------------------------------------------------------
    Knob("HOROVOD_FUSION_THRESHOLD", int, 64 * 1024 * 1024,
         "Tensor-fusion buffer threshold in bytes; pending gradients are "
         "greedily packed into buckets up to this size before a single "
         "fused allreduce is launched. 0 disables fusion."),
    Knob("HOROVOD_JIT_OVERLAP", _parse_bool, True,
         "Bucketed reverse-order gradient reduction in the jitted "
         "train step (parallel/train.py build_train_step): gradient "
         "leaves pack into HOROVOD_FUSION_THRESHOLD-sized buckets in "
         "reverse (last-produced-first) order and each bucket's psum "
         "is emitted inside the backward pass as soon as its "
         "cotangents exist, so XLA's async collectives hide the "
         "reduction under remaining backprop — the jit-path mirror "
         "of the eager fusion-buffer overlap. On by default; 0 "
         "restores the monolithic end-of-step reduction (byte-"
         "identical HLO to the pre-overlap builder, test-pinned). "
         "Leaves with no wire (reduce axes multiplying out to one "
         "device — e.g. every leaf on a single-chip mesh) are never "
         "bucketed: their psum is the identity, so the pack/unpack "
         "round trip is pure overhead (elided since r08; "
         "single-chip programs lower with no bucket machinery)."),
    Knob("HOROVOD_COMPRESSION", str, "none",
         "Gradient wire compression of the data-parallel train step's "
         "buckets and of DistributedOptimizer: none (default), fp16 / "
         "bf16 (cast wire), or powersgd[:rank] (low-rank factor wire "
         "with error feedback — Vogels et al. NeurIPS 2019). The "
         "numerics finite-flag vote never rides a compressed wire: it "
         "travels as an exact float32 allreduce of its own."),
    Knob("HOROVOD_COMPRESSION_RANK", int, 4,
         "PowerSGD approximation rank r when HOROVOD_COMPRESSION="
         "powersgd carries no explicit :rank suffix. The wire of one "
         "compressed n x m matrix drops from n*m elements in its own "
         "dtype to r*(n+m) float32 elements."),
    Knob("HOROVOD_COMPRESSION_WARMUP_STEPS", int, 0,
         "Steps to run the EXACT reduction before switching to the "
         "compressed wire. DistributedOptimizer counts its steps and "
         "switches in place; for the data-parallel train step the "
         "caller runs a compression='none' step for the first N steps "
         "and then the compressed one."),
    Knob("HOROVOD_COMPRESSION_MIN_ELEMENTS", int, 4096,
         "PowerSGD bypass floor: parameters with fewer elements (and "
         "all that are not matrices — biases, scalars, norm gains) "
         "take the exact path."),
    Knob("HOROVOD_CYCLE_TIME", float, 1.0,
         "Background engine cycle time in milliseconds: how often the "
         "pending-tensor queue is drained and negotiated."),
    Knob("HOROVOD_BATCH_QUIESCENCE", int, 0,
         "Quiescence batching (XLA-specific; no reference analog): the "
         "coordinator holds fused-batch cuts until the fully-ready set "
         "has been stable for this many cycles (or a batch fills the "
         "fusion threshold). A per-tensor submission storm then agrees "
         "as ONE batch with a step-stable composition — and a stable "
         "composition is a stable compiled XLA program, where ragged "
         "cuts would recompile nearly every step. 0 disables (cut "
         "every cycle, the reference's behavior); 2-3 suits "
         "hook-style per-parameter eager submission."),
    Knob("HOROVOD_CACHE_CAPACITY", int, 1024,
         "Response-cache capacity (entries). Tensors seen before skip full "
         "negotiation via a bit-vector exchange. 0 disables the cache."),
    Knob("HOROVOD_SHUTDOWN_BARRIER_TIMEOUT", int, 0,
         "Coordination-service shutdown-barrier timeout in seconds; a "
         "straggler past it is FATALLY terminated by the service. 0 = "
         "auto: 60 under the elastic launcher (worlds tear down often; "
         "bound the blast radius of a raggedly-informed world), 300 "
         "(the jax default) otherwise."),
    Knob("HOROVOD_HIERARCHICAL_ALLREDUCE", _parse_bool, False,
         "Use hierarchical allreduce: reduce-scatter over ICI within a "
         "slice, allreduce over DCN across slices, allgather over ICI."),
    # (HOROVOD_BATCH_D2D_MEMCOPIES and HOROVOD_NUM_NCCL_STREAMS have no
    # TPU analog — XLA fuses bucket gather/scatter copies and owns the
    # launch lanes. Deliberately NOT declared: a knob that silently
    # does nothing is worse than an unknown-variable warning.)
    Knob("HOROVOD_EAGER_SPAN_DEVICES", str, "auto",
         "Device-spanning eager data plane (no reference analog — the "
         "reference runs one rank per accelerator): when member "
         "processes own several chips, shard each fused allreduce "
         "bucket across ALL local chips (each chip reduces 1/D over "
         "its own ICI links, then an intra-host all_gather "
         "reassembles). 'auto' (default) enables it for payloads "
         "large enough to split; 1 forces, 0 keeps the one-"
         "representative-device-per-process mesh."),
    Knob("HOROVOD_ALLTOALL_MODE", str, "auto",
         "alltoallv exchange layout: 'padded' = one all_to_all padded "
         "to the global max split (n*max wire bytes); 'ragged' = "
         "shift-round ppermutes with per-round bucketed maxima (wire "
         "bytes track the real split matrix — the MPI_Alltoallv exact-"
         "counts analog); 'auto' picks ragged for skewed routing."),
    Knob("HOROVOD_LAUNCH_OVERHEAD_US", float, -1.0,
         "Per-XLA-launch dispatch overhead (microseconds) used by the "
         "alltoall auto heuristic's cost model. -1 (default) measures "
         "it once per process with a few tiny dispatches; pin it for "
         "deterministic decisions (0 = byte-only comparison)."),
    Knob("HOROVOD_WIRE_BYTES_PER_SEC", float, 4e10,
         "Assumed collective wire rate (bytes/s) for the alltoall "
         "auto cost model; only its ratio to the launch overhead "
         "matters."),
    Knob("HOROVOD_ALLTOALL_MAX_ROUNDS", int, 16,
         "Auto mode never picks the ragged alltoall when it would "
         "need more than this many ppermute rounds (n-1 launches "
         "dominate on high-latency hosts regardless of byte "
         "savings); forced HOROVOD_ALLTOALL_MODE=ragged ignores the "
         "cap."),
    Knob("HOROVOD_ADASUM_MODE", str, "auto",
         "Adasum exchange schedule: 'vhdd' = recursive vector-halving/"
         "distance-doubling (log2(n) ppermute rounds, O(bucket) wire "
         "and HBM per rank — the reference's adasum.h schedule; "
         "non-power-of-two sets run it per pow2 block of the binary "
         "decomposition plus masked-psum merges, still gather-free); "
         "'gather' = one all_gather + local binary-tree fold "
         "(O(n*bucket) per rank); 'auto' (default) = vhdd for any "
         "size (complex dtypes and a forced HOROVOD_ADASUM_PALLAS=1 "
         "fall back to gather; an explicit vhdd outranks the pallas "
         "force)."),
    Knob("HOROVOD_ADASUM_PALLAS", str, "auto",
         "Adasum pair-combine implementation: 'auto' = fused Pallas "
         "kernel on TPU / plain jnp elsewhere; 1 forces the Pallas "
         "path (interpreter off-TPU; under HOROVOD_ADASUM_MODE=auto "
         "this also selects the gather schedule, the only one running "
         "the Pallas pair-combine), 0 forces jnp."),
    # -- controller / backends ----------------------------------------------
    Knob("HOROVOD_CONTROLLER", str, "auto",
         "Control-plane implementation: 'native' (C++ core), 'python' "
         "(pure-python fallback), or 'auto' (native if built)."),
    Knob("HOROVOD_CONTROL_TREE_ARITY", int, 0,
         "Hierarchical control-plane fan-out: with N >= 2, non-root "
         "ranks attach to an intermediate aggregator instead of the "
         "rank-0 coordinator (contiguous-interval N-ary tree, "
         "core/cc/tree.h); aggregators merge readiness bitsets and "
         "request metadata upward and relay agreed batches downward, "
         "so every node's per-cycle control work is O(arity) instead "
         "of the root's O(world). 0 (default) keeps the flat star — "
         "measured fine through a few hundred ranks "
         "(benchmarks/control_plane_scale.md); 32 is the measured "
         "sweet spot at 1024. Aggregator rank r listens on the "
         "control port + r (every rank must agree on the topology, "
         "so set this identically across the job — hvdrun forwards "
         "it like every HOROVOD_* knob)."),
    Knob("HOROVOD_CONTROL_TREE_LINGER_US", int, 200,
         "Aggregator forward window (tree mode): after the first "
         "upward wake an aggregator holds its merged frame until "
         "every connected child has reported or this many "
         "microseconds passed, so a steady-state submission storm "
         "goes upward as ONE merged frame per tier. 0 forwards "
         "eagerly (more, smaller frames at the root)."),
    Knob("HOROVOD_CONTROL_HOSTS", str, "",
         "Comma-separated per-rank host list (rank-indexed), exported "
         "by the launcher so tree-mode workers can resolve their "
         "aggregator parent's address. Empty = every rank assumed on "
         "the coordinator host (correct for single-host jobs; "
         "multi-host tree mode needs the launcher's export)."),
    Knob("HOROVOD_CPU_OPERATIONS", str, "xla",
         "CPU data plane. Only 'xla' is supported: XLA CPU collectives "
         "(the reference's gloo/mpi analog for tests)."),
    # hvdlint: disable-next=HVD002 (compat: recognised and deliberately
    # ignored on TPU — declaring it keeps migrating users' env files
    # from tripping unknown-variable warnings)
    Knob("HOROVOD_GPU_OPERATIONS", str, "",
         "Unused on TPU; recognised for compatibility and ignored. The "
         "data plane is always XLA collectives over ICI/DCN via PJRT."),
    # -- metrics -------------------------------------------------------------
    Knob("HOROVOD_METRICS_PORT", int, 0,
         "Opt-in Prometheus scrape endpoint: serve the process-wide "
         "metrics registry (hvd.metrics()) as text exposition on "
         "http://0.0.0.0:<port + local_rank>/metrics — each rank "
         "offsets by its local rank so single-host multi-rank jobs "
         "don't collide on the bind. 0 disables serving; the registry "
         "itself is always on (registry-only fast path)."),
    Knob("HOROVOD_METRICS_SUMMARY_SECONDS", float, 0.0,
         "Rank-0 periodic metrics summary: log an INFO line with the "
         "registry's nonzero counters/gauges every this many seconds "
         "(the greppable heartbeat when no scraper is attached). "
         "0 disables."),
    # -- timeline / profiling -----------------------------------------------
    Knob("HOROVOD_TIMELINE", str, "",
         "Path to write a Chrome-trace JSON timeline of per-tensor "
         "negotiation/queue/fusion/collective phases (rank 0 only)."),
    Knob("HOROVOD_TIMELINE_MARK_CYCLES", _parse_bool, False,
         "Mark background-engine cycles in the timeline."),
    # -- distributed tracing / flight recorder -------------------------------
    Knob("HOROVOD_TRACE_RING_SIZE", int, 4096,
         "Flight-recorder capacity: the last N span events per rank "
         "are kept in an always-on in-memory ring (one tuple append "
         "on the collective hot path, no file IO) and dumped into "
         "postmortem-rank{r}.json on SIGUSR2, the elastic control "
         "plane's 'dump' verb, or a HorovodInternalError. 0 disables "
         "the recorder entirely."),
    Knob("HOROVOD_TRACE_POSTMORTEM_DIR", str, "",
         "Directory for flight-recorder postmortem dumps. Empty = "
         "the HOROVOD_TIMELINE file's directory, else the working "
         "directory."),
    Knob("HOROVOD_TRACE_CLOCK_SYNC_INTERVAL", float, 30.0,
         "Seconds between clock-calibration re-estimations against "
         "rank 0 (NTP-style midpoint over the authenticated control-"
         "plane wire) while a timeline is recording. Each estimate "
         "rides the per-rank trace as a CLOCK_SYNC record consumed "
         "by `hvdrun --timeline-merge`. 0 = calibrate once at init "
         "only."),
    Knob("HOROVOD_TRACE_CLOCK_PROBES", int, 8,
         "Round-trip probes per clock-calibration estimate; the "
         "min-RTT sample wins (offset error is bounded by that "
         "RTT)."),
    Knob("HOROVOD_TRACE_SIGUSR2", _parse_bool, True,
         "Install the SIGUSR2 handler that dumps the flight "
         "recorder to postmortem-rank{r}.json (main-thread init "
         "only; the elastic 'dump' verb works regardless)."),
    # -- job-lifecycle journal (recovery observability) -----------------------
    Knob("HOROVOD_JOURNAL_DIR", str, "",
         "Directory for the crash-safe job-lifecycle event journal "
         "(journal.py): the elastic driver and every worker append "
         "typed JSONL lifecycle events (membership epochs, heartbeat "
         "verdicts, gang-restart phases, commits, fault firings, "
         "postmortem references) that survive SIGKILL; "
         "`python -m horovod_tpu.runner.doctor incident <dir>` merges "
         "them into an MTTR-decomposed incident report. Empty "
         "(default) disables journaling entirely (one load + compare "
         "per seam)."),
    Knob("HOROVOD_JOURNAL_FSYNC", int, 1,
         "Journal flush cadence: fsync after every N appended "
         "records. 1 (default) makes every event durable before the "
         "writer proceeds; lifecycle-critical events (fault firings, "
         "failure detection, commits, recovery phase edges) fsync "
         "regardless of this batching."),
    Knob("HOROVOD_JOURNAL_ROTATE_MB", int, 64,
         "Journal rotation cap in MiB: past it the live file rotates "
         "to a single .1 sibling (the offline analyzer reads both), "
         "bounding an unattended soak at two segments per process. "
         "0 disables rotation."),
    Knob("HOROVOD_JOURNAL_STRICT", _parse_bool, False,
         "Validate every journaled event against the declared "
         "journal.EVENT_SCHEMAS registry at write time and warn "
         "(once per event type, never raise) on an undeclared event, "
         "a missing required field, or an undeclared field. Off by "
         "default: the same contract is enforced statically by "
         "hvdlint HVD008; this runtime leg exists for soaks and "
         "chaos runs exercising code paths lint cannot see."),
    # -- continuous health telemetry (telemetry.py) ---------------------------
    Knob("HOROVOD_TELEMETRY_DIR", str, "",
         "Directory for the per-rank health-telemetry time-series "
         "shards (telemetry.py): each process samples the metrics "
         "registry at its plane's natural beats (elastic commits, "
         "serving/decode loop ticks, weight adoptions), folds "
         "counter deltas into rates, and appends monotonic-anchored "
         "JSONL records to telemetry-rank{r}.jsonl with the "
         "journal's fsync/rotation discipline; "
         "`python -m horovod_tpu.runner.doctor health <dir>` folds "
         "shards + journals into a health report. Empty (default) "
         "disables telemetry entirely (one load + compare per "
         "beat)."),
    Knob("HOROVOD_TELEMETRY_INTERVAL_S", float, 1.0,
         "Minimum seconds between persisted telemetry samples; "
         "beats arriving inside the interval only update beat "
         "bookkeeping. 0 samples at every beat (tests/benches)."),
    Knob("HOROVOD_TELEMETRY_RING", int, 512,
         "Bounded in-memory ring of recent samples kept for "
         "in-process consumers (the live autotuner objective); "
         "oldest samples fall off, the shard keeps everything."),
    Knob("HOROVOD_TELEMETRY_FSYNC", int, 32,
         "Telemetry shard flush cadence: fsync after every N "
         "samples (telemetry is volume, not lifecycle — losing the "
         "unflushed tail on SIGKILL costs trend points, not "
         "recovery truth; telemetry_meta/health-critical records "
         "fsync regardless)."),
    Knob("HOROVOD_TELEMETRY_ROTATE_MB", int, 64,
         "Telemetry shard rotation cap in MiB (same single-.1 "
         "sibling discipline as the journal). 0 disables rotation."),
    Knob("HOROVOD_TELEMETRY_DETECT_WINDOW", int, 16,
         "Rolling window (samples) the online detectors compute "
         "median/MAD baselines over; also bounds each beat source's "
         "inter-beat period history."),
    Knob("HOROVOD_TELEMETRY_TREND_RUN", int, 5,
         "Consecutive strictly-increasing samples before the trend "
         "detectors (collective skew, queue depth) alert."),
    Knob("HOROVOD_TELEMETRY_STEP_MAD_K", float, 8.0,
         "Step-time regression threshold: alert when the current "
         "beat period / histogram mean exceeds rolling median + "
         "K*MAD (MAD floored at 5% of median) for 3 consecutive "
         "samples; also scales the beat-stall age threshold "
         "(K*median period)."),
    Knob("HOROVOD_TELEMETRY_STALL_FLOOR_S", float, 0.5,
         "Floor on the beat-stall age threshold so millisecond-"
         "period sources don't alert on ordinary scheduling jitter: "
         "a source is stalled when its age exceeds "
         "max(K*median_period, this floor)."),
    Knob("HOROVOD_TELEMETRY_SLO_BURST", int, 5,
         "SLO-miss burst threshold: alert when any "
         "*_slo_miss_total series advances by at least this many "
         "misses within one sample interval."),
    Knob("HOROVOD_TELEMETRY_QUEUE_MIN", int, 8,
         "Queue-depth growth detector floor: a strictly-growing "
         "admission/decode queue only alerts once its depth also "
         "reaches this many entries (small queues breathe)."),
    Knob("HOROVOD_TELEMETRY_STALENESS_LIMIT", int, 50,
         "Weight-staleness runaway threshold: alert when a serving "
         "worker's hvd_weights_staleness_steps gauge reaches this "
         "many train steps and is still climbing."),
    Knob("HOROVOD_TELEMETRY_ALERT_COOLDOWN_S", float, 30.0,
         "Per-(detector, signal) alert cooldown: a persisting "
         "condition re-alerts at most this often instead of "
         "flooding the journal every sample."),
    Knob("HOROVOD_TELEMETRY_RECOVERY_GRACE_S", float, 10.0,
         "Runtime recovery-attribution stickiness: after any "
         "recovery-signal counter (recoveries, elastic resets, "
         "decode resumes, serving retries, fault firings) moves, "
         "alerts within this many seconds carry "
         "attributed=\"recovery\" instead of counting as anomalies. "
         "The offline analyzer uses its own fixed "
         "journal-anchored windows (telemetry.RECOVERY_GRACE_S) so "
         "committed reports stay byte-stable."),
    # -- autotune ------------------------------------------------------------
    Knob("HOROVOD_AUTOTUNE", _parse_bool, False,
         "Enable online autotuning of fusion threshold and cycle time."),
    Knob("HOROVOD_AUTOTUNE_LOG", str, "",
         "If set, append autotune samples (params, score) to this CSV."),
    Knob("HOROVOD_AUTOTUNE_MODE", str, "hillclimb",
         "Search strategy: 'hillclimb' (coordinate descent) or 'gp' "
         "(Gaussian-process Bayesian optimization with expected "
         "improvement, the reference parameter_manager's "
         "BayesianParameter)."),
    Knob("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", int, 3,
         "Autotune warmup samples discarded before scoring."),
    Knob("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", int, 10,
         "Training steps contributing to one autotune sample."),
    # -- order check ---------------------------------------------------------
    Knob("HOROVOD_ORDER_CHECK", _parse_bool, False,
         "Record every executed collective's name into a per-rank "
         "digest; hvd.check_execution_order() then asserts all ranks "
         "executed the identical sequence (the coordinator's core "
         "ordering guarantee, made checkable at runtime)."),
    # -- stall inspector -----------------------------------------------------
    Knob("HOROVOD_STALL_CHECK_DISABLE", _parse_bool, False,
         "Disable the stall inspector."),
    Knob("HOROVOD_STALL_CHECK_TIME_SECONDS", float, 60.0,
         "Warn when a tensor has waited this long for missing ranks."),
    Knob("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", float, 0.0,
         "Hard-fail the job when a tensor stalls this long (0 = never)."),
    # -- logging -------------------------------------------------------------
    Knob("HOROVOD_LOG_LEVEL", str, "warning",
         "Log level: trace, debug, info, warning, error, fatal."),
    Knob("HOROVOD_LOG_TIMESTAMP", _parse_bool, True,
         "Prefix log lines with a timestamp."),
    Knob("HOROVOD_LOG_RANK0_ONLY", _parse_bool, False,
         "Suppress INFO-and-below log records on nonzero ranks "
         "(warnings and errors always pass everywhere) — the log "
         "declutter for large jobs where every rank saying the same "
         "thing N times drowns the signal. Rank 0 keeps full "
         "verbosity."),
    # -- elastic -------------------------------------------------------------
    Knob("HOROVOD_ELASTIC_TIMEOUT", float, 600.0,
         "Seconds to wait for the elastic job to reach min size after a "
         "membership change before giving up."),
    Knob("HOROVOD_ELASTIC_INIT_BASE_TIMEOUT", float, 15.0,
         "First-attempt coordination-service init timeout during an "
         "elastic re-init; doubles per retry (churn-stale workers "
         "abandon a wrong coordinator quickly and re-poll)."),
    Knob("HOROVOD_ELASTIC_INIT_TIMEOUT", float, 120.0,
         "Per-attempt cap the growing elastic re-init timeout doubles "
         "up to."),
    Knob("HOROVOD_ELASTIC_TEARDOWN_GRACE", float, 10.0,
         "Seconds a gang-restart teardown waits after SIGTERM before "
         "escalating to SIGKILL. The first incident report "
         "(benchmarks/INCIDENT_chaos_r11.json) measured this fallback "
         "as the dominant MTTR term: XLA's coordination service "
         "installs a preemption notifier that CATCHES SIGTERM without "
         "exiting, so jax.distributed workers never die on the "
         "polite signal and every teardown pays the full grace. "
         "Restore comes from the last durable commit either way — "
         "lower this to trade teardown latency for the (journal-"
         "fsync-protected) tail of worker-side shutdown work."),
    Knob("HOROVOD_ELASTIC_DRAIN_GRACE", float, 30.0,
         "Seconds a gracefully-removed worker may keep running past "
         "the resize before the driver terminates it."),
    Knob("HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT", float, 0.0,
         "Worker-liveness failure detector: workers PUT a signed "
         "heartbeat to the rendezvous (background pacer + commit "
         "boundaries); the elastic driver kills a worker whose last "
         "heartbeat is older than this and gang-restarts, so a "
         "hung-but-alive worker is recovered like a crash instead of "
         "stalling the job forever. 0 disables (no heartbeats, no "
         "detection)."),
    Knob("HOROVOD_ELASTIC_HEARTBEAT_INTERVAL", float, 0.0,
         "Heartbeat pacer period in seconds. 0 = auto: a third of "
         "HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT (three missed beats "
         "before a worker is declared hung), floored at 0.5 s."),
    Knob("HOROVOD_ELASTIC_REGISTER_RETRIES", int, 5,
         "Retries (with jittered exponential backoff) for the "
         "worker's notify-listener registration at the rendezvous; a "
         "worker that never registers misses every resize poke."),
    Knob("HOROVOD_CONTROL_RETRY_BACKOFF", float, 0.2,
         "Base seconds for control-plane retry backoff (doubles per "
         "attempt, capped at 5 s, +/-50% jitter so a gang of workers "
         "does not re-stampede a recovering endpoint in lockstep)."),
    Knob("HOROVOD_ELASTIC_BLACKLIST_WINDOW", float, 60.0,
         "Base host-blacklist window after a worker failure; the "
         "window doubles per repeated failure of the same host."),
    Knob("HOROVOD_ELASTIC_BLACKLIST_WINDOW_MAX", float, 900.0,
         "Cap on the escalating per-host blacklist window."),
    Knob("HOROVOD_DISCOVERY_STALENESS_WINDOW", float, 60.0,
         "Discovery circuit breaker: consecutive discovery-script "
         "failures are served from the last-known-good host list for "
         "up to this many seconds before failures propagate again."),
    Knob("HOROVOD_ELASTIC_SLICE_ATOMIC", _parse_bool, True,
         "Slice-atomic membership for multi-slice pods: when the "
         "discovery script tags hosts with slice=<id>, any member-"
         "host failure blacklists the WHOLE slice (escalating window "
         "keyed by slice id) and an incomplete (rump) slice is "
         "parked, never assigned ranks, until every expected member "
         "is back. Off = slices still group TPU_PROCESS_ADDRESSES "
         "and keep ranks contiguous, but admission falls back to "
         "per-host. No effect on slice-less host lists."),
    Knob("HOROVOD_ELASTIC_SLICE_FORGET_SECONDS", float, 0.0,
         "Seconds a slice may stay rump before the driver re-"
         "baselines its expected membership to the hosts actually "
         "present (a deliberate shrink stops looking like an outage "
         "after this long). 0 disables: a rump slice parks until its "
         "full membership returns or the driver restarts."),
    Knob("HOROVOD_ELASTIC_PREEMPT_GRACE", float, 5.0,
         "host.preempt fault action: seconds between the SIGTERM "
         "storm to a host's workers (the spot-eviction notice) and "
         "the SIGKILL (the VM poweroff). XLA's preemption notifier "
         "catches SIGTERM without exiting, so the kill is what "
         "actually ends the workers — as on a real spot VM."),
    Knob("HOROVOD_ELASTIC_SLICE_ID", str, "",
         "TPU slice this worker's host belongs to, set per worker by "
         "the elastic driver when discovery reports slice ids (absent "
         "for single-slice jobs). Journal metadata records it so "
         "doctor incident can attribute recoveries to slices."),
    # -- numerics (numerical integrity) --------------------------------------
    Knob("HOROVOD_NUMERICS_GUARD", _parse_bool, False,
         "Coordinated skip-step guard (numerics.py): each rank's "
         "scalar gradient finite-flag rides the existing reduction "
         "(min-reduce semantics — an extra fused leaf eagerly, a pmin "
         "in-jit), and guard_non_finite() zeroes the update on EVERY "
         "rank when any rank saw a non-finite gradient. Off by "
         "default; when off guard_non_finite() returns the inner "
         "transformation unchanged (identical HLO, zero overhead)."),
    Knob("HOROVOD_NUMERICS_MAX_CONSECUTIVE_SKIPS", int, 0,
         "Escalate to HorovodInternalError after this many "
         "CONSECUTIVE coordinated skip-steps, so hvd.elastic.run "
         "restores the last commit instead of spinning on poisoned "
         "inputs (eager loops raise from the guard; jitted loops "
         "escalate at the elastic commit boundary or via "
         "numerics.check_escalation). 0 disables escalation."),
    Knob("HOROVOD_NUMERICS_CHECK_EVERY", int, 0,
         "Replica-divergence (SDC) sentinel cadence: every N elastic "
         "commits, hash the replicated parameters to a 64-bit digest, "
         "allgather the digests (8 bytes/rank), and raise "
         "ReplicaDivergenceError naming the divergent ranks on "
         "disagreement — silent data corruption becomes a clean, "
         "restorable failure. 0 disables."),
    Knob("HOROVOD_NUMERICS_INIT_SCALE", float, 65536.0,
         "Initial dynamic loss scale for hvd.DistributedLossScaler "
         "(2^16, torch GradScaler's default)."),
    Knob("HOROVOD_NUMERICS_GROWTH_INTERVAL", int, 2000,
         "Clean (finite) steps between loss-scale growth attempts in "
         "hvd.DistributedLossScaler (GradScaler's growth_interval)."),
    # -- fault injection (chaos testing) -------------------------------------
    Knob("HOROVOD_FAULTS", str, "",
         "Deterministic fault-injection spec (faults.py): rules "
         "'point:action[:k=v,...]' joined by ';', e.g. "
         "'wire.send:drop:p=0.05;elastic.step:crash:at=40'. Points: "
         "wire.send, wire.recv, rendezvous.http, discovery.poll, "
         "elastic.step, dispatch.entry, numerics.grad, "
         "numerics.param, host.preempt, serving.batch, "
         "weights.publish, weights.adopt, decode.step, kv.page. "
         "Actions: "
         "drop, delay, corrupt, torn, error, crash, hang, nan, inf, "
         "flip, preempt. Empty = every injection point compiles to a "
         "no-op."),
    Knob("HOROVOD_FAULTS_SEED", int, 0,
         "Seed for the fault-injection schedule; each rule draws from "
         "a private stream keyed on (seed, point, action), so the "
         "same spec + seed reproduces the same failure schedule."),
    # -- elastic inference serving -------------------------------------------
    Knob("HOROVOD_SERVING_MAX_BATCH", int, 8,
         "Largest dynamic-batch bucket in the serving frontend's "
         "padded-shape ladder (serving.py). The ladder is the powers "
         "of two up to this value, so every admitted batch hits a "
         "precompiled executable shape; raising it trades per-request "
         "latency for throughput."),
    Knob("HOROVOD_SERVING_LATENCY_BUDGET_MS", float, 10.0,
         "Admission-latency budget in milliseconds: the batcher cuts "
         "a partial batch as soon as its oldest queued request has "
         "waited this long, instead of holding out for a full "
         "HOROVOD_SERVING_MAX_BATCH."),
    Knob("HOROVOD_SERVING_MAX_LEN", int, 0,
         "Longest variable leading (sequence) dimension the bucket "
         "ladder covers; requests are padded up to the next "
         "power-of-two length bucket. 0 = requests are fixed-shape "
         "and the ladder has no length axis."),
    Knob("HOROVOD_SERVING_MIN_WORKERS", int, 1,
         "Autoscaler floor: the worker pool never drains below this "
         "many members."),
    Knob("HOROVOD_SERVING_MAX_WORKERS", int, 4,
         "Autoscaler ceiling: the worker pool never grows past this "
         "many members."),
    Knob("HOROVOD_SERVING_SCALE_INTERVAL_S", float, 0.5,
         "Seconds between autoscaler evaluations of the queue-depth "
         "and latency gauges."),
    Knob("HOROVOD_SERVING_SCALE_UP_QUEUE", float, 2.0,
         "Scale-out watermark: add a worker when queued batches per "
         "live worker exceed this."),
    Knob("HOROVOD_SERVING_SCALE_DOWN_IDLE_S", float, 5.0,
         "Scale-in watermark: retire a worker (down to the floor) "
         "after the queue has been empty this many seconds."),
    Knob("HOROVOD_SERVING_RETRY_LIMIT", int, 3,
         "Re-dispatch attempts per batch after a worker dies "
         "mid-batch before the frontend fails the batch's requests "
         "(a failed request surfaces an error; it is never silently "
         "dropped)."),
    Knob("HOROVOD_SERVING_WORKER_TIMEOUT_S", float, 30.0,
         "Per-batch execution deadline, the serving-side heartbeat "
         "detector: a batch outstanding on a worker longer than this "
         "marks the worker dead and requeues the batch on a "
         "survivor."),
    Knob("HOROVOD_SERVING_TRACE", _parse_bool, True,
         "Request-lifecycle tracing in the serving frontend: every "
         "request carries monotonic-ns phase stamps (batch-cut, "
         "queue-wait, pad, compute, unpad, complete) feeding the "
         "hvd_serving_phase_seconds histograms, the flight-recorder "
         "ring, per-batch `batch_trace` journal events, and "
         "`doctor serve`'s offline attribution. Off, the submit "
         "path's trace seam is one attribute load + compare (the "
         "faults.fire/journal.record discipline)."),
    Knob("HOROVOD_SERVING_TRACE_BUFFER", int, 4096,
         "Completed request traces retained in the frontend's "
         "in-memory buffer (bounded deque) for trace_digest() / "
         "write_timeline(); oldest entries fall off first."),
    Knob("HOROVOD_SERVING_DEFAULT_SLO_MS", float, 0.0,
         "Default per-request SLO deadline in milliseconds for "
         "submit() calls that pass no slo_ms, driving the "
         "hvd_serving_goodput_total / hvd_serving_slo_miss_total "
         "accounting. 0 = use HOROVOD_SERVING_LATENCY_BUDGET_MS "
         "(the admission budget) as the default deadline."),
    # -- continuous-batching decode (serving v2) -----------------------------
    Knob("HOROVOD_SERVING_DECODE_SLOTS", int, 4,
         "Running-batch width of each decode worker (decoding.py): "
         "the number of sequences a worker advances per token step. "
         "Sequences join and leave the running batch at step "
         "boundaries (continuous batching), so a free slot is the "
         "admission unit, not a batch lifetime."),
    Knob("HOROVOD_SERVING_DECODE_MAX_NEW_TOKENS", int, 64,
         "Default generation cap for submit() calls that pass no "
         "max_new_tokens: a sequence finishes when it has emitted "
         "this many tokens (or its prompt+output reaches "
         "HOROVOD_KV_MAX_CONTEXT, whichever is first)."),
    Knob("HOROVOD_SERVING_DECODE_WATERMARK_STRIDE", int, 8,
         "Journal a seq_watermark record (last durably-emitted token "
         "index) every N emitted tokens per sequence. Recovery "
         "re-prefills from the in-memory latch, so the stride bounds "
         "journal volume, not recovery work; doctor serve's "
         "watermark-resume spans read these records."),
    Knob("HOROVOD_SERVING_DECODE_INTERACTIVE_SLO_MS", float, 250.0,
         "Lane classifier: a sequence submitted with slo_ms at or "
         "below this is 'interactive', above it (or with no slo_ms) "
         "'batch'. Interactive sequences are admitted first and keep "
         "their deadline when the pool shrinks; batch sequences shed "
         "first."),
    Knob("HOROVOD_SERVING_DECODE_LANE_BUDGET", float, 0.5,
         "Fraction of the pool's running-batch slots reserved for "
         "the interactive lane while interactive sequences are "
         "waiting: batch-lane sequences are not admitted into (and "
         "under pool shrinkage are shed from) the reserved slots. "
         "0 disables the reservation."),
    Knob("HOROVOD_SERVING_DECODE_RETRY_LIMIT", int, 3,
         "Re-admissions per sequence after worker deaths before the "
         "frontend fails it visibly (a failed sequence surfaces a "
         "DecodeError through its future; it is never silently "
         "dropped)."),
    Knob("HOROVOD_SERVING_DECODE_RETRY_BACKOFF_MS", float, 25.0,
         "Base backoff in milliseconds before a dead worker's "
         "sequence becomes admission-eligible again, doubling per "
         "re-admission of the same sequence (25, 50, 100, ...) so a "
         "crash-looping pool does not thrash re-prefills."),
    Knob("HOROVOD_SERVING_DECODE_LEASE_TIMEOUT_S", float, 10.0,
         "Per-worker liveness deadline for leased sequences: a "
         "decode worker that neither emits nor finishes anything for "
         "this long is declared dead and its in-flight sequences are "
         "re-admitted on survivors from their watermarks."),
    Knob("HOROVOD_SERVING_DECODE_EMIT_STRIDE", int, 1,
         "Remote decode members flush emitted tokens to the frontend "
         "every N token steps (1 = per step). Tokens are 'delivered' "
         "only when the frontend latches them, so a larger stride "
         "trades wire round-trips for up to N-1 tokens of re-decode "
         "after a worker death — never duplicate delivery."),
    Knob("HOROVOD_KV_PAGE_TOKENS", int, 16,
         "Tokens per KV-cache page: the base rung of the pow2 "
         "KV-page ladder (decoding.py). A worker's cache is padded "
         "to whole rungs, so context growth moves between a small "
         "closed set of shapes the warmup pass already compiled — "
         "cache growth never recompiles."),
    Knob("HOROVOD_KV_MAX_CONTEXT", int, 256,
         "Longest context (prompt + generated tokens) the KV-page "
         "ladder covers; the rung set is HOROVOD_KV_PAGE_TOKENS "
         "doublings up to this value, and a sequence that would "
         "outgrow it finishes with outcome 'truncated'."),
    # -- live weight pipeline (train-to-serve) -------------------------------
    Knob("HOROVOD_WEIGHTS_DIR", str, "",
         "Directory of the live weight pipeline (weights.py): the "
         "trainer publishes digest-versioned sharded snapshots here "
         "at elastic commit boundaries and serving workers adopt "
         "them between batches (shared filesystem between trainer "
         "and pool). Empty = the pipeline is disarmed and the "
         "commit-path hook is two registry reads."),
    Knob("HOROVOD_WEIGHTS_PUBLISH_EVERY", int, 0,
         "Publish a weight version every N elastic commits (rank 0; "
         "the first commit always publishes so a fresh serving pool "
         "has a version to adopt). 0 = never publish from the "
         "commit path; WeightPublisher.publish() is still available "
         "for manual publication."),
    Knob("HOROVOD_WEIGHTS_SHARD_MB", int, 64,
         "Target shard size in MiB for published weight versions: "
         "leaves are greedily packed into shards of roughly this "
         "many bytes, each carrying its own digest so a torn or "
         "corrupted shard is rejected at adoption without reading "
         "the rest."),
    Knob("HOROVOD_WEIGHTS_POLL_MS", float, 200.0,
         "Serving-side poll cadence in milliseconds for the CURRENT "
         "weight-version pointer; the watcher publishes a new "
         "adoption target and each worker swaps at its next "
         "between-batches fence point."),
    Knob("HOROVOD_WEIGHTS_KEEP", int, 2,
         "Published weight versions retained on disk (min 2: the "
         "live version plus its predecessor, so rollback — "
         "republishing the previous digest — always has a source). "
         "Older version directories are garbage-collected at "
         "publish time."),
    # -- process sets --------------------------------------------------------
    # hvdlint: disable-next=HVD002 (compat: the reference gates
    # post-init add_process_set on this; here registration is
    # collective-free and always allowed, so the knob is recognised
    # and ignored — see hvd.add_process_set's docstring)
    Knob("HOROVOD_DYNAMIC_PROCESS_SETS", _parse_bool, False,
         "Allow process sets to be registered after init (recognised "
         "for compatibility; registration is collective-free here and "
         "always allowed)."),
    # -- bootstrap / topology (TPU-specific) ---------------------------------
    Knob("HOROVOD_RANK", int, -1,
         "Process rank, set by the launcher. -1 = single-process mode."),
    Knob("HOROVOD_SIZE", int, -1,
         "World size (number of processes), set by the launcher."),
    Knob("HOROVOD_LOCAL_RANK", int, -1,
         "Rank within the host, set by the launcher."),
    Knob("HOROVOD_LOCAL_SIZE", int, -1,
         "Number of ranks on this host, set by the launcher."),
    Knob("HOROVOD_CROSS_RANK", int, -1,
         "Host index (rank across hosts / slices), set by the launcher."),
    Knob("HOROVOD_CROSS_SIZE", int, -1,
         "Number of hosts / slices, set by the launcher."),
    Knob("HOROVOD_COORDINATOR_ADDR", str, "",
         "host:port of the JAX coordination service (rendezvous, KV store, "
         "heartbeats). Set by the launcher; empty = single-process."),
    Knob("HOROVOD_CONTROL_ADDR", str, "",
         "host:port of the control-plane KV/negotiation server used by the "
         "eager engine. Defaults to the coordinator host on port+1."),
    Knob("HOROVOD_GLOO_TIMEOUT_SECONDS", float, 30.0,
         "Control-plane message timeout (name kept from the reference; "
         "applies to the KV-store control plane)."),
    Knob("HOROVOD_START_TIMEOUT", float, 30.0,
         "Seconds each rank waits for the coordination service to come "
         "up at init before aborting (set by hvdrun --start-timeout)."),
    Knob("HOROVOD_HOSTNAME", str, "",
         "This worker's host name as the launcher knows it (used to "
         "key rendezvous slots and blacklists). Empty = "
         "socket.gethostname()."),
    Knob("HOROVOD_ELASTIC", _parse_bool, False,
         "Set by the elastic launcher in every worker's environment; "
         "switches init defaults (e.g. a short shutdown-barrier "
         "timeout) to elastic-appropriate values."),
    Knob("HOROVOD_ELASTIC_EPOCH", int, 0,
         "Monotonic world-incarnation counter, set by the elastic "
         "launcher on every (re)spawn; workers compare it against "
         "notification payloads to drop stale resize pokes."),
    Knob("HOROVOD_ELASTIC_RESET_LIMIT", int, 0,
         "Abort the elastic run after this many world resets "
         "(reference: --reset-limit). 0 = unlimited."),
    Knob("HOROVOD_RENDEZVOUS_ADDR", str, "",
         "host:port of the elastic rendezvous server, set by the "
         "elastic launcher. Empty = not running under the elastic "
         "launcher."),
    # -- topology overrides (TPU-specific) -----------------------------------
    Knob("HOROVOD_TPU_PROCESS_BOUNDS", str, "",
         "Override for the TPU_PROCESS_BOUNDS topology the launcher "
         "exports to workers ('x,y,z' grid). Empty = derived from the "
         "host list."),
    Knob("HOROVOD_TPU_CHIPS_PER_PROCESS_BOUNDS", str, "",
         "Override for TPU_CHIPS_PER_PROCESS_BOUNDS exported to "
         "workers. Empty = '1,1,1' (one chip per process)."),
    # -- attention kernels ---------------------------------------------------
    Knob("HOROVOD_FLASH_ATTENTION", str, "0",
         "Read by the JAX package only: the port's attention launches "
         "its CUDA flash-attention kernel (ops/flash_attention.py) for "
         "every CUDA tensor and takes the plain PyTorch path for CPU "
         "tensors, whatever this knob says."),
]

_KNOBS_BY_ENV: Dict[str, Knob] = {k.env: k for k in KNOBS}


class Config:
    """Snapshot of all knobs, parsed once at `hvd.init()`.

    Mirrors the reference's one-shot env parse in InitializeHorovodOnce
    (reference: horovod/common/operations.cc). Values may be overridden
    programmatically via `hvd.init(config_overrides={...})`.
    """

    def __init__(self, overrides: Optional[Dict[str, Any]] = None,
                 env: Optional[Dict[str, str]] = None):
        env = os.environ if env is None else env
        overrides = overrides or {}
        self._values: Dict[str, Any] = {}
        for knob in KNOBS:
            if knob.env in overrides:
                self._values[knob.env] = overrides[knob.env]
            elif knob.env in env and env[knob.env] != "":
                try:
                    self._values[knob.env] = knob.type(env[knob.env])
                except (ValueError, TypeError) as e:
                    raise ValueError(
                        f"Bad value for {knob.env}={env[knob.env]!r}: {e}")
            else:
                self._values[knob.env] = knob.default

    def __getitem__(self, env_name: str) -> Any:
        return self._values[env_name]

    def get(self, env_name: str, default: Any = None) -> Any:
        return self._values.get(env_name, default)

    # Convenience attribute access: cfg.fusion_threshold etc.
    _ATTR_MAP = {
        "fusion_threshold": "HOROVOD_FUSION_THRESHOLD",
        "jit_overlap": "HOROVOD_JIT_OVERLAP",
        "compression": "HOROVOD_COMPRESSION",
        "compression_rank": "HOROVOD_COMPRESSION_RANK",
        "compression_warmup_steps": "HOROVOD_COMPRESSION_WARMUP_STEPS",
        "compression_min_elements": "HOROVOD_COMPRESSION_MIN_ELEMENTS",
        "cycle_time_ms": "HOROVOD_CYCLE_TIME",
        "batch_quiescence": "HOROVOD_BATCH_QUIESCENCE",
        "cache_capacity": "HOROVOD_CACHE_CAPACITY",
        "shutdown_barrier_timeout": "HOROVOD_SHUTDOWN_BARRIER_TIMEOUT",
        "hierarchical_allreduce": "HOROVOD_HIERARCHICAL_ALLREDUCE",
        "controller": "HOROVOD_CONTROLLER",
        "control_tree_arity": "HOROVOD_CONTROL_TREE_ARITY",
        "control_tree_linger_us": "HOROVOD_CONTROL_TREE_LINGER_US",
        "control_hosts": "HOROVOD_CONTROL_HOSTS",
        "metrics_port": "HOROVOD_METRICS_PORT",
        "metrics_summary_seconds": "HOROVOD_METRICS_SUMMARY_SECONDS",
        "timeline_path": "HOROVOD_TIMELINE",
        "timeline_mark_cycles": "HOROVOD_TIMELINE_MARK_CYCLES",
        "trace_ring_size": "HOROVOD_TRACE_RING_SIZE",
        "trace_postmortem_dir": "HOROVOD_TRACE_POSTMORTEM_DIR",
        "trace_clock_sync_interval": "HOROVOD_TRACE_CLOCK_SYNC_INTERVAL",
        "trace_clock_probes": "HOROVOD_TRACE_CLOCK_PROBES",
        "trace_sigusr2": "HOROVOD_TRACE_SIGUSR2",
        "journal_dir": "HOROVOD_JOURNAL_DIR",
        "journal_fsync": "HOROVOD_JOURNAL_FSYNC",
        "journal_rotate_mb": "HOROVOD_JOURNAL_ROTATE_MB",
        "journal_strict": "HOROVOD_JOURNAL_STRICT",
        "telemetry_dir": "HOROVOD_TELEMETRY_DIR",
        "telemetry_interval_s": "HOROVOD_TELEMETRY_INTERVAL_S",
        "telemetry_ring": "HOROVOD_TELEMETRY_RING",
        "autotune": "HOROVOD_AUTOTUNE",
        "autotune_log": "HOROVOD_AUTOTUNE_LOG",
        "autotune_mode": "HOROVOD_AUTOTUNE_MODE",
        "autotune_warmup_samples": "HOROVOD_AUTOTUNE_WARMUP_SAMPLES",
        "autotune_steps_per_sample": "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE",
        "adasum_mode": "HOROVOD_ADASUM_MODE",
        "adasum_pallas": "HOROVOD_ADASUM_PALLAS",
        "alltoall_mode": "HOROVOD_ALLTOALL_MODE",
        "eager_span_devices": "HOROVOD_EAGER_SPAN_DEVICES",
        "launch_overhead_us": "HOROVOD_LAUNCH_OVERHEAD_US",
        "wire_bytes_per_sec": "HOROVOD_WIRE_BYTES_PER_SEC",
        "alltoall_max_rounds": "HOROVOD_ALLTOALL_MAX_ROUNDS",
        "order_check": "HOROVOD_ORDER_CHECK",
        "stall_check_disable": "HOROVOD_STALL_CHECK_DISABLE",
        "stall_check_time": "HOROVOD_STALL_CHECK_TIME_SECONDS",
        "stall_shutdown_time": "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS",
        "log_level": "HOROVOD_LOG_LEVEL",
        "log_timestamp": "HOROVOD_LOG_TIMESTAMP",
        "log_rank0_only": "HOROVOD_LOG_RANK0_ONLY",
        "elastic_timeout": "HOROVOD_ELASTIC_TIMEOUT",
        "elastic_init_base_timeout": "HOROVOD_ELASTIC_INIT_BASE_TIMEOUT",
        "elastic_init_timeout": "HOROVOD_ELASTIC_INIT_TIMEOUT",
        "elastic_teardown_grace": "HOROVOD_ELASTIC_TEARDOWN_GRACE",
        "elastic_drain_grace": "HOROVOD_ELASTIC_DRAIN_GRACE",
        "heartbeat_timeout": "HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT",
        "heartbeat_interval": "HOROVOD_ELASTIC_HEARTBEAT_INTERVAL",
        "register_retries": "HOROVOD_ELASTIC_REGISTER_RETRIES",
        "control_retry_backoff": "HOROVOD_CONTROL_RETRY_BACKOFF",
        "blacklist_window": "HOROVOD_ELASTIC_BLACKLIST_WINDOW",
        "blacklist_window_max": "HOROVOD_ELASTIC_BLACKLIST_WINDOW_MAX",
        "discovery_staleness_window": "HOROVOD_DISCOVERY_STALENESS_WINDOW",
        "elastic_slice_atomic": "HOROVOD_ELASTIC_SLICE_ATOMIC",
        "elastic_slice_forget_seconds":
            "HOROVOD_ELASTIC_SLICE_FORGET_SECONDS",
        "elastic_preempt_grace": "HOROVOD_ELASTIC_PREEMPT_GRACE",
        "elastic_slice_id": "HOROVOD_ELASTIC_SLICE_ID",
        "numerics_guard": "HOROVOD_NUMERICS_GUARD",
        "numerics_max_consecutive_skips":
            "HOROVOD_NUMERICS_MAX_CONSECUTIVE_SKIPS",
        "numerics_check_every": "HOROVOD_NUMERICS_CHECK_EVERY",
        "numerics_init_scale": "HOROVOD_NUMERICS_INIT_SCALE",
        "numerics_growth_interval": "HOROVOD_NUMERICS_GROWTH_INTERVAL",
        "faults": "HOROVOD_FAULTS",
        "faults_seed": "HOROVOD_FAULTS_SEED",
        "serving_max_batch": "HOROVOD_SERVING_MAX_BATCH",
        "serving_latency_budget_ms": "HOROVOD_SERVING_LATENCY_BUDGET_MS",
        "serving_max_len": "HOROVOD_SERVING_MAX_LEN",
        "serving_min_workers": "HOROVOD_SERVING_MIN_WORKERS",
        "serving_max_workers": "HOROVOD_SERVING_MAX_WORKERS",
        "serving_scale_interval_s": "HOROVOD_SERVING_SCALE_INTERVAL_S",
        "serving_scale_up_queue": "HOROVOD_SERVING_SCALE_UP_QUEUE",
        "serving_scale_down_idle_s": "HOROVOD_SERVING_SCALE_DOWN_IDLE_S",
        "serving_retry_limit": "HOROVOD_SERVING_RETRY_LIMIT",
        "serving_worker_timeout_s": "HOROVOD_SERVING_WORKER_TIMEOUT_S",
        "serving_trace": "HOROVOD_SERVING_TRACE",
        "serving_trace_buffer": "HOROVOD_SERVING_TRACE_BUFFER",
        "serving_default_slo_ms": "HOROVOD_SERVING_DEFAULT_SLO_MS",
        "serving_decode_slots": "HOROVOD_SERVING_DECODE_SLOTS",
        "serving_decode_max_new_tokens":
            "HOROVOD_SERVING_DECODE_MAX_NEW_TOKENS",
        "serving_decode_watermark_stride":
            "HOROVOD_SERVING_DECODE_WATERMARK_STRIDE",
        "serving_decode_interactive_slo_ms":
            "HOROVOD_SERVING_DECODE_INTERACTIVE_SLO_MS",
        "serving_decode_lane_budget":
            "HOROVOD_SERVING_DECODE_LANE_BUDGET",
        "serving_decode_retry_limit":
            "HOROVOD_SERVING_DECODE_RETRY_LIMIT",
        "serving_decode_retry_backoff_ms":
            "HOROVOD_SERVING_DECODE_RETRY_BACKOFF_MS",
        "serving_decode_lease_timeout_s":
            "HOROVOD_SERVING_DECODE_LEASE_TIMEOUT_S",
        "serving_decode_emit_stride":
            "HOROVOD_SERVING_DECODE_EMIT_STRIDE",
        "kv_page_tokens": "HOROVOD_KV_PAGE_TOKENS",
        "kv_max_context": "HOROVOD_KV_MAX_CONTEXT",
        "weights_dir": "HOROVOD_WEIGHTS_DIR",
        "weights_publish_every": "HOROVOD_WEIGHTS_PUBLISH_EVERY",
        "weights_shard_mb": "HOROVOD_WEIGHTS_SHARD_MB",
        "weights_poll_ms": "HOROVOD_WEIGHTS_POLL_MS",
        "weights_keep": "HOROVOD_WEIGHTS_KEEP",
        "dynamic_process_sets": "HOROVOD_DYNAMIC_PROCESS_SETS",
        "rank": "HOROVOD_RANK",
        "size": "HOROVOD_SIZE",
        "local_rank": "HOROVOD_LOCAL_RANK",
        "local_size": "HOROVOD_LOCAL_SIZE",
        "cross_rank": "HOROVOD_CROSS_RANK",
        "cross_size": "HOROVOD_CROSS_SIZE",
        "coordinator_addr": "HOROVOD_COORDINATOR_ADDR",
        "control_addr": "HOROVOD_CONTROL_ADDR",
        "control_timeout": "HOROVOD_GLOO_TIMEOUT_SECONDS",
        "start_timeout": "HOROVOD_START_TIMEOUT",
    }

    def __getattr__(self, name: str) -> Any:
        try:
            return self._values[self._ATTR_MAP[name]]
        except KeyError:
            raise AttributeError(name)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._values)


def env_value(env_name: str,
              env: Optional[Dict[str, str]] = None) -> Any:
    """Registry-routed point read of one declared knob at CALL time.

    The sanctioned replacement for scattered
    ``os.environ.get("HOROVOD_*")`` reads (hvdlint rule HVD002): the
    name must be declared in KNOBS — so ``hvdrun --help`` and the
    doctor can enumerate it — and the raw string goes through the
    knob's type and default exactly like the init-time snapshot.

    Use ``Config`` for the coherent one-shot parse at ``hvd.init()``;
    use this for pre-init plumbing (launcher-set variables read before
    any Config exists) and for knobs that are deliberately re-read as
    the environment changes (e.g. the elastic epoch bumped on every
    respawn).
    """
    knob = _KNOBS_BY_ENV.get(env_name)
    if knob is None:
        raise KeyError(
            f"{env_name} is not a declared knob; add a Knob to "
            f"KNOBS in horovod_tpu_torch/common/config.py")
    raw = (os.environ if env is None else env).get(env_name, "")
    if raw == "":
        return knob.default
    try:
        return knob.type(raw)
    except (ValueError, TypeError) as e:
        raise ValueError(f"Bad value for {env_name}={raw!r}: {e}")


def knob_default(env_name: str) -> Any:
    """Declared default of a registered knob — the single authority
    for fallback values at call sites that read a knob pre-init (so a
    changed default in KNOBS never leaves stale literals behind)."""
    knob = _KNOBS_BY_ENV.get(env_name)
    if knob is None:
        raise KeyError(
            f"{env_name} is not a declared knob; add a Knob to "
            f"KNOBS in horovod_tpu_torch/common/config.py")
    return knob.default


def describe_knobs() -> str:
    """Human-readable table of every knob for --help / doctor output."""
    lines = []
    for k in KNOBS:
        lines.append(f"{k.env:<42} default={k.default!r}")
        lines.append(f"    {k.doc}")
    return "\n".join(lines)
