"""The environment knobs the port reads.

Counterpart of ``mxnet_tpu/config.py`` (``declare``/``get``/``refresh``),
holding only the knobs that the port's code reads so far. Each keeps the
reference's name, type and default. A knob is read from the environment on
first use and cached until :func:`refresh`, except the knobs the reference
declares uncached (``cached=False``: the serving, fault, preemption, engine
and trace knobs), which are read from the environment at every call.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, NamedTuple, Optional

__all__ = ["VARIABLES", "get", "refresh"]


class EnvVar(NamedTuple):
    name: str
    type: Callable
    default: Any
    doc: str
    cached: bool = True
    # a value it refuses raises ValueError at get()
    validator: Optional[Callable[[Any], bool]] = None


VARIABLES: Dict[str, EnvVar] = {v.name: v for v in (
    EnvVar("MXNET_FUSED_EPILOGUE", int, 0,
           "Fused conv/BN/ReLU epilogue for the model-zoo ResNet bottleneck "
           "1x1 convs (ops/cuda_kernels.py matmul_stats + matmul_epilogue "
           "through conv1x1_bn_act_train) under hybridized training: 0 = "
           "off, 1 = on where the input lies on a CUDA device, 2 = also on "
           "the CPU through the kernels' plain versions (tests)."),
    EnvVar("MXNET_FUSED_CONV_BN", int, 0,
           "Fusion of conv + BatchNorm(training) pairs into the conv + "
           "batch-statistics kernels (ops/cuda_kernels.py matmul_bn_stats "
           "for 1x1 convs at any stride, convkxk_bn_stats for KxK stride-1 "
           "convs) under hybridized training: 0 = off, 1 = on where the "
           "input lies on a CUDA device, 2 = also on the CPU through the "
           "kernels' plain versions (tests)."),
    EnvVar("MXNET_FUSED_CONV_BN_KINDS", str, "1x1,kxk",
           "Which conv + BatchNorm fusion kinds MXNET_FUSED_CONV_BN admits: "
           "a comma-separated set of '1x1' (any-stride 1x1) and 'kxk' "
           "(KxK stride-1). Another kind raises ValueError."),
    EnvVar("MXNET_BN_TWO_PASS_VAR", bool, False,
           "BatchNorm batch variance by the two-pass shifted formula instead "
           "of the single-pass E[x^2] - E[x]^2 (one extra pass; use when "
           "activation |mean| >> std makes the single pass cancel)."),
    EnvVar("MXNET_INT8_PALLAS", int, 0,
           "The retired route of quantized convs through the int8 matmul "
           "kernel, kept as the reference keeps it: quantized convs always "
           "run the exact s8 -> s32 convolution (contrib/quantization.py). "
           "0 (the only valid value) counts each conv that the route would "
           "have claimed (quantization.pallas_skipped_count, logged once); "
           "nonzero refuses with MXNetError."),
    EnvVar("MXNET_COMPILED_STEP", int, 1,
           "Compiled whole train step (cached_step.TrainStep through "
           "Trainer.compile_step, and models.make_train_step): forward, "
           "backward and optimizer update captured as one CUDA graph over "
           "fixed buffers, cached by input shapes and dtypes, the route "
           "knobs and the parameters' storage, and replayed: 1 dispatch a "
           "step. 1 = on (the setups TrainStep cannot capture run the eager "
           "tape and name their reason), 0 = the eager tape everywhere: "
           "also parallel.ShardedTrainer's step and the recorded forward "
           "of a hybridized block run eagerly."),
    EnvVar("MXNET_COMPILED_STEP_CACHE", int, 16,
           "Per-owner cap of the program store's 'train_step' namespace "
           "(LRU over program keys); a new key past the cap evicts the "
           "oldest program and frees its graph."),
    EnvVar("MXNET_FORWARD_CACHE", int, 32,
           "Per-owner cap of the program store's 'hybrid_forward' namespace "
           "and of the 'serving', 'serving_decode' and 'serving_spec' "
           "namespaces (the captured forwards of a hybridized block or of an "
           "engine, LRU).", cached=False),
    EnvVar("MXNET_BACKWARD_DO_MIRROR", bool, False,
           "Recompute the forward during the backward (torch.utils."
           "checkpoint) instead of keeping activations alive: about one "
           "extra forward of work for less peak memory (the reference's "
           "mirror path); ShardedTrainer(remat=None) follows it."),
    EnvVar("MXNET_SHAPE_BUCKETS", str, "pow2",
           "Shape-bucket grid for padded programs (serving.BucketPolicy): "
           "'pow2' (round a dynamic axis up to the next power of two), "
           "'none' (exact shapes, bucketing off), or an ascending comma "
           "list '8,16,32,64' (a length above the largest bucket keeps its "
           "exact shape). Used by Trainer.compile_step(bucket=True) and "
           "hybridize(bucket=True), which verify the padded result against "
           "the unpadded one once per bucket, and by ServingEngine and "
           "GenerativeEngine's prefill grid.", cached=False),
    EnvVar("MXNET_SERVE_VERIFY", int, 1,
           "ServingEngine, hybridize(bucket=True) and compile_step("
           "bucket=True): verify the first padded (or coalesced) call per "
           "signature against the unpadded eager forward. 1 = bit-exact "
           "passes, and for a forward a last-ulp difference (rtol 1e-5, "
           "atol 1e-6) too, counted as verify_ulp_accepts; anything larger "
           "refuses bucketing for good (ServingEngine.bucket_refused keeps "
           "the reason, and the engine serves exact shapes). 2 = strict: "
           "bit-exact or refuse. 0 = trust padding unchecked.",
           cached=False),
    EnvVar("MXNET_SERVE_MAX_BATCH", int, 32,
           "ServingEngine: max total rows one coalesced dispatch may carry; "
           "concurrent infer() requests batch together up to this bound",
           cached=False),
    EnvVar("MXNET_SERVE_MAX_DELAY_US", int, 2000,
           "ServingEngine: how long (microseconds) a dispatch may wait for "
           "more requests to coalesce before flushing the batch; 0 = "
           "dispatch immediately (no coalescing window)", cached=False),
    EnvVar("MXNET_KV_PAGE", int, 16,
           "Paged KV-cache (serving_decode.PagePool): tokens per cache "
           "page. Sequences hold ceil(len/page) pages from the fixed "
           "shared device pool and release them at retirement; smaller "
           "pages waste less tail memory per sequence but deepen the "
           "page-table gather inside the decode program.", cached=False),
    EnvVar("MXNET_KV_PAGES", int, 512,
           "Paged KV-cache: total pages in the process-shared pool "
           "(serving_decode.shared_pool), the device budget every "
           "co-hosted GenerativeEngine draws from. Exhaustion at admission "
           "sheds loudly (faults.ShedError, site serving.admit); "
           "exhaustion mid-decode preempts the youngest sequence (pages "
           "freed, request re-queued, greedy continuation token-exact).",
           cached=False),
    EnvVar("MXNET_SERVE_MAX_QUEUE", int, 64,
           "GenerativeEngine admission bound: pending generate() requests "
           "past this depth are refused immediately with faults.ShedError "
           "(site serving.admit): overload degrades loudly, never a "
           "timeout.", cached=False),
    EnvVar("MXNET_SERVE_SLO_US", int, 0,
           "GenerativeEngine per-request latency SLO in microseconds. 0 = "
           "off. When set, admission consults the per-bucket cost table "
           "(EMA of measured prefill/decode-step times, no trial "
           "dispatch): a request whose estimated queue wait already busts "
           "the SLO sheds at admission (ShedError, counted shed_slo); "
           "delivered requests that exceeded it count slo_violations in "
           "engine.stats().", cached=False),
    EnvVar("MXNET_SERVE_DECODE_ROWS", int, 8,
           "GenerativeEngine decode-step row capacity: the ONE captured "
           "token-decode program always runs this many sequence rows (live "
           "sequences occupy rows, dead rows are masked), so join/retire "
           "never re-captures. Also the continuous-batching concurrency "
           "ceiling per engine.", cached=False),
    EnvVar("MXNET_PREFIX_CACHE", bool, True,
           "Content-addressed KV prefix cache (serving_decode.PagePool): "
           "pages are keyed by a rolling hash of their token block "
           "(chain-hashed, so a block's key commits to its full prefix); "
           "requests sharing a prompt reference ONE physical prefill "
           "(refcounted, copy-on-write at divergence) and prefill only the "
           "uncached suffix. Unreferenced cached pages are kept and "
           "evicted LRU under pool pressure: PagePoolExhausted only when "
           "even eviction cannot help. Off (0) = the pre-cache pool: no "
           "hashing, no index, prefix.* counters stay 0.", cached=False),
    EnvVar("MXNET_SPEC_DECODE", bool, False,
           "Speculative decoding (serving_decode.GenerativeEngine): when on "
           "AND the engine was built with a draft model, each decode round "
           "has the cheap draft propose MXNET_SPEC_K tokens and the target "
           "score all k+1 positions in ONE verify dispatch (standard "
           "rejection sampling: the output distribution is the target's; "
           "exact token match under greedy). Whether speculation PAYS is "
           "arbitrated per round from the cost table's measured "
           "draft/verify/decode EMAs, and persistently low measured "
           "acceptance auto-disables it (spec.autodisabled). Off (0) = the "
           "plain decode loop: no draft dispatches, spec.* counters stay 0.",
           cached=False),
    EnvVar("MXNET_SPEC_K", str, "4",
           "Speculative decoding draft depth: tokens proposed per round "
           "(the verify program scores k+1 positions in one dispatch). "
           "'auto' picks k per round from the cost table (measured "
           "acceptance EMA and draft/verify EMAs) over 1..4, the draft "
           "round's captured depth.", cached=False,
           validator=lambda v: v == "auto" or (v.isdigit() and int(v) >= 1)),
    EnvVar("MXNET_SPMD_MESH", str, "auto",
           "SPMD mesh for kvstore='tpu'/'nccl' (parallel.spmd.resolve_mesh; "
           "cached_step.TrainStep runs its one program a step on each rank "
           "of the torch.distributed world over it). 'auto' = every rank "
           "on 'dp' (a world of one stays on the plain single-device "
           "path); an integer = that many ranks on 'dp' (1 gives a mesh of "
           "one); '0'/'off' disables; 'dp=4,fsdp=2' axis specs go through "
           "parallel.mesh.make_mesh: the batch shards over 'dp' only, an "
           "'fsdp' axis shards parameters and optimizer state "
           "(spmd.param_spec), and a 'tp' axis carries model-code "
           "sharding.constraint annotations.", cached=False),
    EnvVar("MXNET_FSDP_MIN_SIZE", int, 1024,
           "FSDP sharding floor (spmd.param_spec): parameter and optimizer-"
           "state leaves with fewer elements stay replicated on an 'fsdp' "
           "mesh axis.", cached=False, validator=lambda v: v >= 0),
    EnvVar("MXNET_MOE_AUX_WEIGHT", float, 0.01,
           "Weight on the MoE load-balance auxiliary loss "
           "(parallel.moe.MoEBlock records the Shazeer balance penalty into "
           "moe.aux_scope; cached_step.TrainStep folds weight*sum(aux) into "
           "the differentiated loss heads on both the compiled and eager "
           "paths, so the penalty reaches the optimizer without widening "
           "the user loss_fn contract). 0 disables the fold.", cached=False,
           validator=lambda v: v >= 0),
    EnvVar("MXNET_FAULT_PLAN", str, None,
           "Deterministic fault-injection plan for subprocess tests: "
           "'site[@after]:times[:kind]' comma-list (kind: transient|fatal|"
           "oserror|timeout) installed at import (faults.FaultPlan."
           "from_env). Unset = injection disabled (faults.inject is a "
           "no-op None check).", cached=False),
    EnvVar("MXNET_RETRY_MAX", int, 3,
           "faults.retry_call default: max re-attempts after the first try "
           "(total attempts = value + 1) for retryable failures",
           cached=False),
    EnvVar("MXNET_RETRY_BACKOFF", float, 0.05,
           "faults.retry_call default: base delay (s) of the deterministic "
           "exponential backoff min(backoff * 2**(attempt-1), max)",
           cached=False),
    EnvVar("MXNET_RETRY_BACKOFF_MAX", float, 2.0,
           "faults.retry_call default: backoff delay cap in seconds",
           cached=False),
    EnvVar("MXNET_FAULT_EVENTS", int, 1024,
           "Capacity of the faults structured event log (faults.events()): "
           "the bounded deque keeps the newest N entries (retry, raise, "
           "deadline, inject, degradation records). Read once at import; "
           "fault events also mirror onto the telemetry bus with step "
           "indices."),
    EnvVar("MXNET_PREEMPTION_GRACE_S", float, 30.0,
           "Preemption-notice grace budget (seconds): after SIGTERM/SIGINT "
           "the preemption handler (preemption.install) stops admission, "
           "drains every async queue (engine.waitall: serving/decode "
           "queues), runs the drain hooks, and exits with "
           "MXNET_PREEMPTION_EXIT_CODE; a watchdog force-exits if the "
           "drain has not finished inside this budget. 0 = no watchdog.",
           cached=False),
    EnvVar("MXNET_PREEMPTION_EXIT_CODE", int, 83,
           "Exit code of a SUCCESSFUL graceful preemption drain (flag -> "
           "waitall -> drain hooks): a supervisor seeing this code knows "
           "the drain completed. A drain that FAILED exits 1 instead; the "
           "watchdog force-exit uses this code + 1.", cached=False),
    EnvVar("MXNET_ENGINE_TYPE", str, "ThreadedEnginePerDevice",
           "Engine facade selection (engine.engine_type): "
           "ThreadedEnginePerDevice = the asynchronous pipeline; "
           "NaiveEngine forces prefetch depth 0 (engine.prefetch_depth).",
           cached=False),
    EnvVar("MXNET_ENGINE_PREFETCH", int, 2,
           "Async pipeline depth (engine.prefetch_depth): also the depth of "
           "ServingEngine's staging queue, floored at 2 so the double "
           "buffer survives depth 0. MXNET_ENGINE_TYPE=NaiveEngine forces "
           "0.", cached=False),
    EnvVar("MXNET_AMP_LAG", int, 1,
           "Deferred AMP gate lag window (cached_step.TrainStep): 1 = step "
           "N-1's all-finite flag is read on the host after step N is "
           "launched; step N carries both scale candidates "
           "(LossScaler.branch_scales) and the device picks by the flag, "
           "so the read never waits on the current program and the result "
           "is bitwise the synchronous gate's. 0 = the flag read after its "
           "own step; values above 1 clamp to 1. "
           "MXNET_ENGINE_TYPE=NaiveEngine forces 0.", cached=False,
           validator=lambda v: v >= 0),
    EnvVar("MXNET_FUSED_OPTIMIZER", int, 1,
           "Trainer.step under an AMP loss scaler: 1 = one all-finite "
           "reduction whose device flag gates the update (where(ok, new, "
           "old) on every weight and state) and one host read for the "
           "scale policy; 0 = the scalar path: read the overflow first and "
           "skip the update on the host.", cached=False),
    EnvVar("MXNET_TELEMETRY_EVENTS", int, 4096,
           "Telemetry event-bus capacity: the bounded buffer keeps the "
           "newest N structured events (shed, preempt, fault, admit, "
           "retire, ...); older events drop (the emitted counter "
           "telemetry.events keeps the true total). Read once at import."),
    EnvVar("MXNET_TELEMETRY_TRACE", int, 1,
           "End-to-end request tracing: every request admitted by "
           "ServingEngine.infer or GenerativeEngine.generate mints a "
           "trace_id carried in a thread-local trace context that the "
           "engines' worker threads re-enter; shed/fault events and "
           "serving/decode spans stamp it, and telemetry.trace(id) returns "
           "the stitched lifecycle. 0 = no ids minted, no trace fields.",
           cached=False),
    EnvVar("MXNET_TELEMETRY_XLA", int, 1,
           "Wrap telemetry.span brackets in torch.profiler."
           "record_function ranges, so host-side spans (serving dispatch, "
           "decode iteration) land inside torch.profiler traces of the "
           "device. 0 = spans record host-side only.", cached=False),
    EnvVar("MXNET_TELEMETRY_DIR", str, None,
           "Telemetry flight recorder: when set, telemetry.flush() (called "
           "by engine.waitall() and the preemption drain) writes the event "
           "bus, the spans and a counter snapshot as JSON lines to "
           "<dir>/telemetry-r<rank>-p<pid>.jsonl. Unset = recorder off.",
           cached=False),
    EnvVar("MXNET_TELEMETRY_MAX_MB", float, 64.0,
           "Flight-recorder size cap: when the MXNET_TELEMETRY_DIR shards "
           "exceed this many megabytes after a flush, the oldest shards "
           "(never the flushing process's own) are deleted until they fit "
           "(telemetry.shards_rotated). <= 0 disables rotation.",
           cached=False),
    EnvVar("MXNET_TPU_PROC_ID", int, None,
           "This process's rank, stamped on its flight-recorder shard "
           "(unset: the torch.distributed rank when a world is up, else "
           "0).", cached=False),
    EnvVar("MXNET_METRIC_DEVICE", int, 1,
           "Device-side metric accumulators: EvalMetric.update on device "
           "tensors or NDArrays adds (sum, count) device scalars with no "
           "host read; the host reads them at .get(), engine.waitall() or "
           "every MXNET_METRIC_SYNC_STEPS updates. 0 = host accumulation "
           "everywhere (each update counted in metric.host_sync_count); "
           "MXNET_ENGINE_TYPE=NaiveEngine forces 0.", cached=False),
    EnvVar("MXNET_METRIC_SYNC_STEPS", int, 50,
           "Device-side metric accumulators: fold the device scalars into "
           "the host sums every N update() calls.", cached=False,
           validator=lambda v: v >= 1),
    EnvVar("MXNET_PROFILER_AUTOSTART", bool, False,
           "Start the profiler at import (reference profiler env var)."),
    EnvVar("MXNET_BARRIER_TIMEOUT", float, 0.0,
           "Barrier deadline in seconds; with it set, run_elastic(kvstore=) "
           "attaches a HeartbeatMonitor under the checkpoint directory. "
           "0 = wait forever.", cached=False, validator=lambda v: v >= 0),
    EnvVar("MXNET_ELASTIC_BACKOFF", float, 0.0,
           "run_elastic: base delay (s) of the exponential backoff between "
           "restore-and-resume restarts (capped at "
           "MXNET_RETRY_BACKOFF_MAX); 0 = restart at once.", cached=False,
           validator=lambda v: v >= 0),
    EnvVar("MXNET_SENTINEL_EVERY", int, 20,
           "Training-integrity sentinel cadence (sentinel.py): every N "
           "compiled train-step dispatches run the step's digest form, "
           "which also emits a state fingerprint (uint32 fold over the "
           "post-update parameters and optimizer state, parameter sum, "
           "gradient norm) in the same one dispatch; the host read is "
           "deferred a full cadence. 0 = sentinel off.", cached=False,
           validator=lambda v: v >= 0),
    EnvVar("MXNET_SENTINEL_ZMAX", float, 6.0,
           "Sentinel anomaly window z-score threshold: a grad-norm or loss "
           "sample farther than zmax standard deviations from its EMA, or "
           "any non-finite sample, trips the window.", cached=False,
           validator=lambda v: v > 0),
    EnvVar("MXNET_SENTINEL_STRIKES", int, 1,
           "Replica divergences a device may accumulate before the "
           "sentinel quarantines it.", cached=False,
           validator=lambda v: v >= 1),
    # -- the replica router and the elastic fleet (serving_router.py,
    # serving_remote.py; reference config.py:537-660)
    EnvVar("MXNET_ROUTER_PREFIX_AFFINITY", float, 1.0,
           "ReplicaRouter prefix-affinity weight: each leading page-block "
           "of a request's prompt hash chain already resident in a "
           "replica's KV pool lowers that replica's dispatch score by this "
           "much (one unit == one queued request of load), so "
           "shared-prefix traffic converges on the replica holding the "
           "warm pages. 0 disables affinity; ignored when "
           "MXNET_PREFIX_CACHE is off.", cached=False,
           validator=lambda v: v >= 0),
    EnvVar("MXNET_ROUTER_BREAKER_ERRS", int, 3,
           "ReplicaRouter circuit breaker: dispatch failures within the "
           "last MXNET_ROUTER_BREAKER_WINDOW outcomes that OPEN a "
           "replica's breaker (the replica stops receiving traffic until a "
           "half-open probe succeeds). A wedged dispatch or replica death "
           "trips the breaker immediately, regardless of this count.",
           cached=False, validator=lambda v: v >= 1),
    EnvVar("MXNET_ROUTER_BREAKER_WINDOW", int, 16,
           "ReplicaRouter circuit breaker: size of the per-replica rolling "
           "dispatch-outcome window the error threshold "
           "(MXNET_ROUTER_BREAKER_ERRS) is evaluated over.", cached=False,
           validator=lambda v: v >= 1),
    EnvVar("MXNET_ROUTER_BREAKER_COOLDOWN_S", float, 2.0,
           "ReplicaRouter circuit breaker: seconds an OPEN breaker stays "
           "open before transitioning to HALF-OPEN, where exactly one "
           "probe request is admitted: success closes the breaker "
           "(replica re-admitted), failure re-opens it for another "
           "cooldown. This is the probe budget the availability gate "
           "(tools/torch_check_availability_budget.py) holds re-admission "
           "to.", cached=False, validator=lambda v: v > 0),
    EnvVar("MXNET_ROUTER_HEDGE_PCTL", int, 0,
           "ReplicaRouter hedged requests: 0 (default) = off; N in [50, "
           "99] = a dispatch still outstanding past the fleet's p<N> "
           "dispatch latency issues ONE duplicate on a different healthy "
           "replica, first completion wins and the loser is cancelled "
           "(counted hedge_cancelled). Hedging stays dormant until 16 "
           "latency samples exist; greedy decode keeps the duplicate "
           "token-exact, so first-wins is safe.", cached=False,
           validator=lambda v: v == 0 or 50 <= v <= 99),
    EnvVar("MXNET_ROUTER_WEDGE_S", float, 30.0,
           "ReplicaRouter liveness: a dispatch outstanding this many "
           "seconds with NO heartbeat from its replica (beats are stamped "
           "per dispatch completion on the in-memory HeartbeatMonitor) "
           "declares the replica WEDGED: its breaker trips open, the "
           "dispatch is abandoned, and the request fails over to a healthy "
           "replica. Tune well above a legitimate worst-case dispatch.",
           cached=False, validator=lambda v: v > 0),
    EnvVar("MXNET_ROUTER_EAGER_FALLBACK", bool, False,
           "ReplicaRouter last-resort degraded mode: with EVERY replica "
           "breaker open, serve single requests through the eager path "
           "(eager_generate for generative routers, the engine's unpadded "
           "eager forward for one-shot inference) instead of shedding "
           "ShedError(kind='unavailable'). Default off: shedding loudly is "
           "usually better than silently serving at eager throughput.",
           cached=False),
    EnvVar("MXNET_ROUTER_AUTOSCALE", bool, False,
           "Elastic fleet autoscaling (FleetSupervisor.start()): a "
           "supervisor thread prices scale-up/down every "
           "MXNET_ROUTER_SCALE_INTERVAL_S from live telemetry (mean queued "
           "work per SERVING replica, worst KV page-pool pressure, fleet "
           "p99) inside [MXNET_ROUTER_MIN_REPLICAS, "
           "MXNET_ROUTER_MAX_REPLICAS] with one action per "
           "MXNET_ROUTER_SCALE_COOLDOWN_S. Scale-down is a scheduled "
           "graceful preemption: drain_replica (typed draining handback, "
           "clean page audit) then SIGTERM -> exit "
           "MXNET_PREEMPTION_EXIT_CODE for process-backed replicas. "
           "Default off: FleetSupervisor.start() is a no-op (no thread, no "
           "timer, dispatch identical to the static router).",
           cached=False),
    EnvVar("MXNET_ROUTER_MIN_REPLICAS", int, 1,
           "Elastic fleet floor: the autoscaler never drains below this "
           "many SERVING replicas, and scales UP toward it regardless of "
           "load/cooldown when the fleet falls under (self-healing after a "
           "host loss).", cached=False, validator=lambda v: v >= 1),
    EnvVar("MXNET_ROUTER_MAX_REPLICAS", int, 4,
           "Elastic fleet ceiling: the autoscaler never joins past this "
           "many SERVING replicas, however saturated the fleet signals "
           "are.", cached=False, validator=lambda v: v >= 1),
    EnvVar("MXNET_ROUTER_SCALE_COOLDOWN_S", float, 10.0,
           "Autoscaler stability: at most one scaling action (up or down) "
           "per this many seconds, so a bursty load cannot flap the fleet, "
           "except scaling up toward MXNET_ROUTER_MIN_REPLICAS, which is "
           "urgent and bypasses the cooldown.", cached=False,
           validator=lambda v: v >= 0),
    EnvVar("MXNET_ROUTER_SCALE_INTERVAL_S", float, 1.0,
           "Autoscaler cadence: seconds between supervisor ticks (each "
           "tick reads the fleet signals and executes at most one scaling "
           "action).", cached=False, validator=lambda v: v > 0),
    EnvVar("MXNET_ROUTER_SCALE_UP_QUEUE", float, 1.5,
           "Autoscaler scale-up threshold: mean queued work per SERVING "
           "replica (engine load(): queue_depth + in_flight occupancy) at "
           "or above which a tick prices a scale-up. Measured from the "
           "same load() surface the router balances on, never a static "
           "request count.", cached=False, validator=lambda v: v > 0),
    EnvVar("MXNET_ROUTER_SCALE_DOWN_QUEUE", float, 0.1,
           "Autoscaler scale-down threshold: mean queued work per SERVING "
           "replica at or below which (with page-pool pressure also low) "
           "a tick prices a scale-down, never below "
           "MXNET_ROUTER_MIN_REPLICAS.", cached=False,
           validator=lambda v: v >= 0),
    EnvVar("MXNET_ROUTER_SCALE_POOL_HIGH", float, 0.85,
           "Autoscaler KV-pressure threshold: worst per-replica page-pool "
           "pressure (1 - free/total) at or above which a tick prices a "
           "scale-up even with short queues (pool exhaustion sheds, so "
           "headroom is capacity). Scale-down additionally requires "
           "pressure under half this value.", cached=False,
           validator=lambda v: 0 < v <= 1),
    EnvVar("MXNET_ROUTER_REMOTE_TIMEOUT_S", float, 120.0,
           "RemoteReplica transport ceiling: seconds a framed call may "
           "wait on connect/reply before the client raises a "
           "TransientFault (breaker-blamed, request fails over). The "
           "ambient request deadline tightens this per call; the ceiling "
           "bounds deadline-less dispatches so a dead host can never hang "
           "a router worker thread forever.", cached=False,
           validator=lambda v: v > 0),
)}

_CACHE: Dict[str, Any] = {}


def _parse(var: EnvVar, raw: str) -> Any:
    if var.type is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return var.type(raw)


def get(name: str) -> Any:
    """The knob's value: the environment's, parsed and cached, else its
    default. Unknown names raise ``KeyError``."""
    if name not in VARIABLES:
        raise KeyError(f"undeclared env var {name}")
    if name in _CACHE:
        return _CACHE[name]
    var = VARIABLES[name]
    raw = os.environ.get(name)
    if raw is None:
        return var.default
    val = _parse(var, raw)
    if var.validator is not None and not var.validator(val):
        raise ValueError(f"{name}={raw!r} is out of range")
    if var.cached:
        _CACHE[name] = val
    return val


def refresh(name: Optional[str] = None) -> None:
    """Drop cached reads (all, or one knob's)."""
    if name is None:
        _CACHE.clear()
    else:
        _CACHE.pop(name, None)
