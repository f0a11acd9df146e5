"""Engine Prometheus metrics, written by hand on the standard library.

Ports the exposition of production_stack_tpu/engine/metrics.py that the
router scrapes (``router/stats.py``) for the families whose state this
package has: ``EngineStatsCollector`` (the perf, KV-tier and tenant
families included; the tenant rows folded to ``tenant_top_k`` +
``other``), ``LifecycleCollector``, ``OverloadCollector`` (the brownout
and fair-share families), ``DiagnosticsCollector`` (the diagnostic-bundle
families) and ``ServerMetrics``' latency and KV-transfer histograms with
the same bucket edges. Names, types, label names and values are the
reference's.

The card's machine has no ``prometheus_client``, so this module writes the
text exposition format (version 0.0.4) itself, as the reference's
``generate_latest`` writes it: one ``# HELP`` and one ``# TYPE`` line a
family; a counter family ``x`` is sampled, and in this format also
declared, as ``x_total`` (a parser reads the family back as ``x``); a
histogram has cumulative ``_bucket{le=...}`` samples ending in ``+Inf``,
then ``_sum`` and ``_count``; label values and help text are escaped.
Gauges and counters that mirror engine state are read from
``LLMEngine.stats()`` at scrape time (host counters only, so a scrape never
waits on the card); histograms are observed by the engine thread as
requests finish and steps complete.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Optional

from production_stack_tpu_torch.tenancy import fold_records

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def format_value(v) -> str:
    """A sample value or ``le`` edge as the exposition writes it."""
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(v)


def _escape_label(v) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _escape_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


class Family:
    """One metric family: its name, type, help and samples, each a
    (name suffix, labels, value)."""

    def __init__(self, name: str, kind: str, doc: str, labels=()):
        self.name = name
        self.kind = kind
        self.doc = doc
        self.labels = tuple(labels)
        self.samples: list[tuple[str, dict, float]] = []

    def add(self, label_values, value, suffix: str = "",
            extra: Optional[dict] = None) -> "Family":
        labels = dict(zip(self.labels, label_values))
        if extra:
            labels.update(extra)
        if self.kind == "counter" and not suffix:
            suffix = "_total"
        self.samples.append((suffix, labels, value))
        return self

    def render(self) -> str:
        declared = self.name + ("_total" if self.kind == "counter" else "")
        lines = [f"# HELP {declared} {_escape_help(self.doc)}",
                 f"# TYPE {declared} {self.kind}"]
        for suffix, labels, value in self.samples:
            lbl = ",".join(f'{k}="{_escape_label(v)}"'
                           for k, v in labels.items())
            lbl = "{" + lbl + "}" if lbl else ""
            lines.append(f"{self.name}{suffix}{lbl} {format_value(value)}")
        return "\n".join(lines) + "\n"


def engine_families(s: dict, model_name: str) -> list[Family]:
    """The families of the reference's ``EngineStatsCollector.collect``,
    from one ``LLMEngine.stats()`` snapshot."""
    lv = [model_name]
    out: list[Family] = []

    def gauge(name, doc, value):
        out.append(Family(name, "gauge", doc, ["model_name"]).add(lv, value))

    def counter(name, doc, value):
        out.append(Family(name, "counter", doc, ["model_name"])
                   .add(lv, value))

    hits = s["gpu_prefix_cache_hits_total"]
    queries = s["gpu_prefix_cache_queries_total"]
    gauge("vllm:num_requests_running",
          "Number of requests currently running on the GPU",
          s["num_requests_running"])
    gauge("vllm:num_requests_waiting",
          "Number of requests waiting to be processed",
          s["num_requests_waiting"])
    gauge("vllm:gpu_cache_usage_perc",
          "KV-cache usage (1 = 100%); GPU HBM block pool",
          s["gpu_cache_usage_perc"])
    gauge("vllm:gpu_prefix_cache_hit_rate", "Prefix cache block hit rate",
          hits / queries if queries else 0.0)
    counter("vllm:gpu_prefix_cache_hits", "Prefix cache block hits", hits)
    counter("vllm:gpu_prefix_cache_queries", "Prefix cache block queries",
            queries)
    # the host-DRAM KV tier (0 without one)
    gauge("vllm:cpu_cache_usage_perc",
          "Host-DRAM KV offload tier usage (1 = 100%)",
          s.get("cpu_cache_usage_perc", 0.0))
    counter("vllm:cpu_prefix_cache_hits", "Host-tier prefix block hits",
            s.get("cpu_prefix_cache_hits_total", 0))
    counter("vllm:cpu_prefix_cache_queries", "Host-tier prefix block queries",
            s.get("cpu_prefix_cache_queries_total", 0))
    # n-gram speculative decoding (vLLM spec-decode metric names)
    counter("vllm:spec_decode_num_draft_tokens",
            "Speculative draft tokens proposed",
            s.get("spec_decode_num_draft_tokens_total", 0))
    counter("vllm:spec_decode_num_accepted_tokens",
            "Speculative draft tokens accepted",
            s.get("spec_decode_num_accepted_tokens_total", 0))
    gauge("vllm:spec_decode_acceptance_rate",
          "Draft acceptance rate (accepted / proposed, cumulative)",
          s.get("spec_decode_acceptance_rate", 0.0))
    gauge("vllm:spec_decode_tokens_per_step",
          "Mean tokens emitted per verified speculative span "
          "(1 guaranteed + accepted drafts)",
          s.get("spec_decode_tokens_per_step", 0.0))
    counter("vllm:aborted_seqs",
            "Sequences aborted (client disconnect / deadline expiry); "
            "KV blocks freed before natural completion",
            s.get("aborted_seqs_total", 0))
    counter("vllm:spliced_seqs",
            "Pushed P→D transfers attached as decode-ready sequences "
            "(disaggregated serving: each one is a skipped re-prefill)",
            s.get("spliced_seqs_total", 0))
    counter("vllm:prompt_tokens", "Cumulative prompt tokens",
            s["prompt_tokens_total"])
    counter("vllm:generation_tokens", "Cumulative generated tokens",
            s["generation_tokens_total"])
    gauge("vllm:batch_occupancy",
          "Running sequences / max_num_seqs (decode-slot utilization)",
          s.get("batch_occupancy", 0.0))
    gauge("vllm:kv_blocks_total", "KV block pool capacity (HBM)",
          s.get("kv_blocks_total", 0))
    gauge("vllm:kv_blocks_free", "Free KV blocks (allocatable right now)",
          s.get("kv_blocks_free", 0))
    counter("vllm:ragged_dispatches",
            "Unified mixed prefill+decode dispatches issued "
            "(attention_impl=ragged)",
            s.get("ragged_dispatches_total", 0))
    counter("vllm:ragged_live_tokens",
            "Live (unpadded) tokens packed into ragged dispatches",
            s.get("ragged_live_tokens_total", 0))
    gauge("vllm:ragged_stream_utilization",
          "Cumulative live-token fill of the budget-wide ragged stream "
          "(live tokens / dispatches x max_num_batched_tokens)",
          s.get("ragged_stream_utilization", 0.0))
    kv_tier = s.get("kv_tier")
    if kv_tier:
        out += tier_families(kv_tier, model_name)
    perf = s.get("perf")
    if not perf:
        return out
    # goodput accounting (engine/perf_accounting.py)
    gauge("vllm:model_flops_utilization",
          "Model FLOPs utilization over the accounting window "
          "(goodput: live tokens only, padding waste excluded)",
          perf["mfu"])
    gauge("vllm:hbm_bandwidth_utilization",
          "Estimated HBM bandwidth utilization over the window",
          perf["hbm_bw_util"])
    tps = Family("vllm:tokens_per_second",
                 "gauge", "Live (unpadded) tokens per second by phase",
                 ["model_name", "phase"])
    tps.add([model_name, "prefill"], perf["prefill_tps"])
    tps.add([model_name, "decode"], perf["decode_tps"])
    out.append(tps)
    gauge("vllm:hbm_bytes_used",
          "Device HBM bytes in use (torch.cuda.memory_stats)",
          perf["hbm_bytes_used"])
    gauge("vllm:hbm_bytes_total",
          "Device HBM bytes available (torch.cuda.mem_get_info total)",
          perf["hbm_bytes_total"])
    gauge("vllm:hbm_bytes_peak", "Peak device HBM bytes observed",
          perf["hbm_bytes_peak"])
    gauge("vllm:ici_bandwidth_utilization",
          "Estimated per-card interconnect bandwidth utilization over the "
          "window (the collective bytes the device group sent vs the "
          "per-card link peak; 0 on one card)",
          perf.get("ici_bw_util", 0.0))
    coll = Family("vllm:collective_bytes", "counter",
                  "Per-card collective bytes the device group sent, by op "
                  "(all_reduce: float32 row-parallel partials and the "
                  "embedding; all_reduce_int32: int8 products' partials; "
                  "all_reduce_max: int8 activation scales; all_gather: "
                  "vocab-sharded logits; moe_combine: MoE combine partials "
                  "over the expert ranks)", ["model_name", "op"])
    for op, n in sorted((perf.get("collective_bytes") or {}).items()):
        coll.add([model_name, op], n)
    out.append(coll)
    compiles = Family("vllm:compile_events", "counter",
                      "Compile events (new step signatures) per program "
                      "kind and shape bucket",
                      ["model_name", "kind", "bucket"])
    for (kind, bucket), n in sorted(perf["compile_counts"].items()):
        compiles.add([model_name, kind, bucket], n)
    out.append(compiles)
    counter("vllm:compile_time_seconds",
            "Cumulative wall seconds of first calls at new program "
            "signatures", perf["compile_seconds_total"])
    counter("vllm:unexpected_recompiles",
            "Compiles observed after warmup marked the engine steady "
            "— a shape leaked past warmup (bug signal)",
            perf["unexpected_recompiles"])
    cm = perf.get("costmodel")
    if cm:
        pred = Family("vllm:costmodel_predicted_seconds", "counter",
                      "Roofline-predicted dispatch seconds by phase (max "
                      "of FLOP/HBM/link transit time for each dispatch's "
                      "live token/byte counts)", ["model_name", "phase"])
        meas = Family("vllm:costmodel_measured_seconds", "counter",
                      "Measured dispatch wall seconds attributed to the "
                      "cost-model drift window, by phase",
                      ["model_name", "phase"])
        ratio = Family("vllm:costmodel_drift_ratio", "gauge",
                       "Windowed measured/predicted dispatch-seconds ratio "
                       "by phase — the roofline cost model's honesty gauge "
                       "(judged relative to its post-warmup baseline)",
                       ["model_name", "phase"])
        for phase in ("prefill", "decode"):
            pred.add([model_name, phase],
                     (cm.get("predicted_seconds") or {}).get(phase, 0.0))
            meas.add([model_name, phase],
                     (cm.get("measured_seconds") or {}).get(phase, 0.0))
            ratio.add([model_name, phase],
                      (cm.get("drift_ratio") or {}).get(phase, 0.0))
        out += [pred, meas, ratio]
        counter("vllm:costmodel_drift_episodes",
                "Sustained cost-model drift episodes (windowed ratio left "
                "the configured band relative to its baseline; one count "
                "per excursion)", cm.get("episodes", 0))
    tn = s.get("tenants")
    if tn and tn.get("enabled") and tn.get("tenants"):
        out += tenant_families(tn, model_name)
    return out


def tenant_families(tn: dict, model_name: str) -> list[Family]:
    """The reference's tenant block from ``LLMEngine.tenant_stats()``: its
    rows folded again to ``top_k`` + ``other`` (idempotent on a folded
    table), so the label set stays bounded."""
    folded = fold_records(tn["tenants"], k=tn.get("top_k", 8),
                          weight_key="chip_seconds")
    tok = Family("vllm:tenant_tokens", "counter",
                 "Live tokens attributed per tenant and phase (prefill "
                 "chunk tokens / decode goodput incl. accepted drafts); "
                 "sums to the vllm:tokens_per_second totals",
                 ["model_name", "tenant", "phase"])
    chip = Family("vllm:tenant_chip_seconds", "counter",
                  "Chip-seconds attributed per tenant: each dispatch's wall "
                  "time split by the tenant's live-token share of the packed "
                  "stream (conserves: per-tenant sum == total dispatch "
                  "seconds)", ["model_name", "tenant"])
    kvb = Family("vllm:tenant_kv_blocks", "gauge",
                 "KV blocks currently held by each tenant's live sequences",
                 ["model_name", "tenant"])
    queue = Family("vllm:tenant_queue_time_seconds", "summary",
                   "Queue wait (arrival to scheduler admission) per tenant "
                   "over finished requests", ["model_name", "tenant"])
    for tenant, row in sorted(folded.items()):
        tok.add([model_name, tenant, "prefill"], row.get("prefill_tokens", 0))
        tok.add([model_name, tenant, "decode"], row.get("decode_tokens", 0))
        chip.add([model_name, tenant], row.get("chip_seconds", 0.0))
        kvb.add([model_name, tenant], row.get("kv_blocks", 0))
        queue.add([model_name, tenant], row.get("requests", 0), "_count")
        queue.add([model_name, tenant], row.get("queue_seconds_sum", 0.0),
                  "_sum")
    return [tok, chip, kvb, queue]


def overload_families(s: dict, model_name: str) -> list[Family]:
    """The reference's ``OverloadCollector`` families from the server's
    overload snapshot: the brownout stage, its sheds by reason and the
    fair-share deficits by tenant (bounded upstream: a deficit exists only
    for a tenant with pending work)."""
    b = s.get("brownout") or {}
    stage = Family("vllm:brownout_stage", "gauge",
                   "Current staged-degradation level (0 healthy; 1 "
                   "spec-decode grants shed; 2 + max_tokens clamped, KV "
                   "prefetch paused; 3 + over-weight tenants' new "
                   "admissions shed)", ["model_name", "tier"])
    stage.add([model_name, "engine"], float(b.get("stage", 0)))
    sheds = Family("vllm:brownout_sheds", "counter",
                   "Work shed by the brownout ladder, by reason (spec grants "
                   "suppressed, max_tokens clamps, prefetches skipped, "
                   "tenant admissions refused)",
                   ["model_name", "reason", "tier"])
    for reason, count in sorted((b.get("sheds") or {}).items()):
        sheds.add([model_name, reason, "engine"], count)
    deficit = Family("vllm:fair_share_deficit", "gauge",
                     "Carried deficit-round-robin credit per tenant, in "
                     "stream tokens (positive = the tenant is owed budget "
                     "next dispatch)", ["model_name", "tenant"])
    fair = s.get("fair_share") or {}
    for tenant, value in sorted((fair.get("deficits") or {}).items()):
        deficit.add([model_name, tenant], value)
    return [stage, sheds, deficit]


def tier_families(kv_tier: dict, model_name: str) -> list[Family]:
    """The reference's tiered-KV families from ``LLMEngine.tier_stats()``:
    hit ratio a tier, bytes a tier and direction, and the prefetch
    pipeline's latency histogram and overlap share."""
    ratio = Family("vllm:kv_tier_hit_ratio", "gauge",
                   "Cumulative prefix-block hit ratio per KV tier (hbm = "
                   "on-device pool, host = DRAM store, remote = shared "
                   "kv_server)", ["model_name", "tier"])
    for tier, t in sorted(kv_tier["tiers"].items()):
        q = t.get("queries", 0)
        ratio.add([model_name, tier], t.get("hits", 0) / q if q else 0.0)
    nbytes = Family("vllm:kv_tier_bytes", "counter",
                    "KV slab bytes moved per tier and direction (from the "
                    "HBM pool's perspective: in = promotion/prefetch import, "
                    "out = demotion/offload export)",
                    ["model_name", "tier", "direction"])
    for key, n in sorted(kv_tier["bytes"].items()):
        tier, direction = key.rsplit("_", 1)
        nbytes.add([model_name, tier, direction], n)
    out = [ratio, nbytes]
    pf = kv_tier.get("prefetch")
    if pf:
        hist = Family("vllm:kv_prefetch_seconds", "histogram",
                      "Warm-tier prefix fetch latency (admission → staged "
                      "slabs ready to commit); overlapped with serving, "
                      "never blocking the loop", ["model_name"])
        acc = 0
        for edge, n in zip(list(pf["hist_buckets"]) + [math.inf],
                           pf["hist_counts"]):
            acc += n
            hist.add([model_name], acc, "_bucket", {"le": format_value(edge)})
        hist.add([model_name], acc, "_count")
        hist.add([model_name], pf["seconds_sum"], "_sum")
        out.append(hist)
        out.append(Family(
            "vllm:kv_prefetch_overlap_fraction", "gauge",
            "Share of prefetch wall time overlapped with useful engine work "
            "(1.0 = the serving loop never waited on a tier fetch)",
            ["model_name"]).add([model_name], pf.get("overlap_fraction", 1.0)))
    return out


def lifecycle_families(s: dict, model_name: str) -> list[Family]:
    """The reference's ``LifecycleCollector`` families (drain, watchdog,
    warmup), from the server's lifecycle snapshot."""
    lv = [model_name]

    def fam(name, kind, doc, value):
        return Family(name, kind, doc, ["model_name"]).add(lv, value)

    return [
        fam("vllm:drain_state", "gauge",
            "1 while the engine is DRAINING (readiness 503, new requests "
            "refused, in-flight sequences finishing under the drain "
            "deadline)", 1.0 if s["draining"] else 0.0),
        fam("vllm:drain_rejected_requests", "counter",
            "Generation requests refused with 503 + Retry-After because "
            "the engine was draining", s["drain_rejected_total"]),
        fam("vllm:drain_aborted_seqs", "counter",
            "Straggler sequences aborted when the drain deadline expired "
            "(KV blocks freed; also counted in vllm:aborted_seqs_total)",
            s["drain_aborted_total"]),
        fam("vllm:watchdog_stalled", "gauge",
            "1 while the stuck-step watchdog sees no scheduler-step "
            "progress with work queued (readiness answers 503)",
            1.0 if s["watchdog_stalled"] else 0.0),
        fam("vllm:watchdog_stalls", "counter",
            "Stall episodes the stuck-step watchdog has detected",
            s["watchdog_stalls_total"]),
        fam("vllm:engine_warming", "gauge",
            "1 while the engine runs its warmup (readiness answers 503 "
            "\"warming\"; the router keeps the replica out of rotation "
            "until this clears)", 1.0 if s.get("warming") else 0.0),
        fam("vllm:engine_warmup_seconds", "gauge",
            "Wall time the completed warmup (all shape variants) took; "
            "0 until it finishes", s.get("warmup_seconds", 0.0)),
    ]


def diagnostics_families(s: dict, model_name: str) -> list[Family]:
    """The reference's ``DiagnosticsCollector`` families, from
    ``DiagnosticsManager.stats()``: bundles captured and capture requests
    dropped, by trigger, and the capture seconds' summary."""
    bundles = Family("vllm:diagnostic_bundles", "counter",
                     "Diagnostic bundles captured on an anomaly trigger "
                     "(GET /debug/diagnostics indexes them)",
                     ["model_name", "trigger", "tier"])
    for trigger, count in sorted(s["bundles_total"].items()):
        bundles.add([model_name, trigger, "engine"], count)
    dropped = Family("vllm:diagnostic_bundles_dropped", "counter",
                     "Capture requests skipped by the cooldown or the "
                     "single-flight gate (evidence already being captured)",
                     ["model_name", "trigger", "tier"])
    for trigger, count in sorted(s["dropped_total"].items()):
        dropped.add([model_name, trigger, "engine"], count)
    seconds = Family("vllm:diagnostic_capture_seconds", "summary",
                     "Wall time spent capturing diagnostic bundles (off the "
                     "serving path: capture runs on its own thread)",
                     ["model_name", "tier"])
    seconds.add([model_name, "engine"], s["capture_seconds_count"], "_count")
    seconds.add([model_name, "engine"], s["capture_seconds_sum"], "_sum")
    return [bundles, dropped, seconds]


BUCKETS_TTFT = (
    0.001, 0.005, 0.01, 0.02, 0.04, 0.06, 0.08, 0.1, 0.25, 0.5, 0.75,
    1.0, 2.5, 5.0, 7.5, 10.0,
)
BUCKETS_E2E = (0.3, 0.5, 0.8, 1.0, 1.5, 2.0, 2.5, 5.0, 10.0, 15.0, 20.0,
               30.0, 40.0, 50.0, 60.0)
BUCKETS_TPOT = (0.01, 0.025, 0.05, 0.075, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5,
                0.75, 1.0, 2.5)
BUCKETS_ITL = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.15,
               0.2, 0.3, 0.4, 0.5, 0.75, 1.0, 2.5)
BUCKETS_STEP = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, 5.0)
BUCKETS_TRANSFER = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                    10.0, 30.0, 60.0, 120.0)


class Histogram:
    """One ``model_name``-labelled histogram: observed on the engine
    thread, rendered on HTTP threads. Like the reference's labelled
    histogram, it has no samples until its first observation."""

    def __init__(self, name: str, doc: str, buckets: tuple):
        self.name = name
        self.doc = doc
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # last: above all
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = next((j for j, b in enumerate(self.buckets) if value <= b),
                 len(self.buckets))
        with self._lock:
            self._counts[i] += 1
            self._sum += value

    def family(self, model_name: str) -> Family:
        fam = Family(self.name, "histogram", self.doc, ["model_name"])
        self.add_samples(fam, [model_name])
        return fam

    def add_samples(self, fam: Family, label_values) -> None:
        """This histogram's cumulative samples into ``fam`` under
        ``label_values`` (none before the first observation)."""
        with self._lock:
            counts, total = list(self._counts), self._sum
        if not sum(counts):
            return
        acc = 0
        for edge, n in zip(self.buckets + (math.inf,), counts):
            acc += n
            fam.add(label_values, acc, "_bucket",
                    {"le": format_value(edge)})
        fam.add(label_values, total, "_sum")
        fam.add(label_values, acc, "_count")


class ServerMetrics:
    """The engine's exposition: engine-state families read at scrape time,
    the lifecycle families from the server's snapshot source, and the
    latency histograms."""

    def __init__(self, engine, model_name: str):
        self.engine = engine
        self.model_name = model_name
        self._lifecycle: Optional[Callable[[], dict]] = None
        self._overload: Optional[Callable[[], dict]] = None
        self._diagnostics: Optional[Callable[[], dict]] = None
        self.ttft = Histogram("vllm:time_to_first_token_seconds",
                              "Time to first token", BUCKETS_TTFT)
        self.tpot = Histogram("vllm:time_per_output_token_seconds",
                              "Time per output token", BUCKETS_TPOT)
        self.e2e = Histogram("vllm:e2e_request_latency_seconds",
                             "End-to-end request latency", BUCKETS_E2E)
        # per-stage decomposition (queue → prefill → decode), observed
        # from the lifecycle stamps carried on finished RequestOutputs
        self.queue_time = Histogram(
            "vllm:request_queue_time_seconds",
            "Time from arrival to scheduler admission (queue wait)",
            BUCKETS_TTFT)
        self.prefill_time = Histogram(
            "vllm:request_prefill_time_seconds",
            "Time from admission to first token (prefill incl. chunking)",
            BUCKETS_TTFT)
        self.decode_time = Histogram(
            "vllm:request_decode_time_seconds",
            "Time from first token to finish (decode)", BUCKETS_E2E)
        self.itl = Histogram(
            "vllm:inter_token_latency_seconds",
            "Mean inter-token latency per finished request", BUCKETS_ITL)
        self.step_duration = Histogram(
            "vllm:scheduler_step_duration_seconds",
            "Engine step wall time (schedule + dispatch + postprocess)",
            BUCKETS_STEP)
        self.histograms = (self.ttft, self.tpot, self.e2e, self.queue_time,
                           self.prefill_time, self.decode_time, self.itl,
                           self.step_duration)
        # P->D KV transfers by direction (push: a prefill engine streaming
        # out; recv: a decode engine landing a push; export: a served
        # /kv/export; import: a pulled one): bytes, one transfer's wall
        # seconds, and a {bytes, seconds, count} mirror for /debug/perf
        self._transfer_lock = threading.Lock()
        self._transfer_hists: dict[str, Histogram] = {}
        self.transfer_totals: dict = {}
        # transfers refused for another KV head grouping, by leg (import:
        # a pull; recv: a push), in /debug/perf's kv_transfer block
        self.transfer_refused: dict = {}

    def register_lifecycle(self, source: Callable[[], dict]) -> None:
        """Attach the drain/watchdog/warmup snapshot source."""
        self._lifecycle = source

    def register_overload(self, source: Callable[[], dict]) -> None:
        """Attach the brownout/fair-share snapshot source."""
        self._overload = source

    def register_diagnostics(self, source: Callable[[], dict]) -> None:
        """Attach the anomaly-capture stats source
        (``DiagnosticsManager.stats``)."""
        self._diagnostics = source

    def observe_transfer(self, direction: str, nbytes: int,
                         seconds: float) -> None:
        with self._transfer_lock:
            hist = self._transfer_hists.get(direction)
            if hist is None:
                hist = self._transfer_hists[direction] = Histogram(
                    "vllm:kv_transfer_seconds", "", BUCKETS_TRANSFER)
            t = self.transfer_totals.setdefault(
                direction, {"bytes": 0, "seconds": 0.0, "count": 0})
            t["bytes"] += nbytes
            t["seconds"] += seconds
            t["count"] += 1
        hist.observe(seconds)

    def refuse_transfer(self, direction: str) -> None:
        with self._transfer_lock:
            self.transfer_refused[direction] = (
                self.transfer_refused.get(direction, 0) + 1)

    def transfer_snapshot(self) -> dict:
        """A copy of ``transfer_totals`` (direction -> bytes, seconds,
        count), safe to serialize while transfers go on."""
        with self._transfer_lock:
            return {d: dict(t) for d, t in self.transfer_totals.items()}

    def transfer_families(self) -> list[Family]:
        """``vllm:kv_transfer_bytes`` and ``vllm:kv_transfer_seconds``,
        labelled by direction; none before the first transfer."""
        totals = self.transfer_snapshot()
        with self._transfer_lock:
            hists = dict(self._transfer_hists)
        if not totals:
            return []
        nbytes = Family("vllm:kv_transfer_bytes", "counter",
                        "KV bytes moved between engines for disaggregated "
                        "serving, by direction (push/recv/export/import)",
                        ["model_name", "direction"])
        secs = Family("vllm:kv_transfer_seconds", "histogram",
                      "Wall time of one KV transfer leg (gather + wire + "
                      "scatter, overlapped), by direction",
                      ["model_name", "direction"])
        for d in sorted(totals):
            nbytes.add([self.model_name, d], totals[d]["bytes"])
            hists[d].add_samples(secs, [self.model_name, d])
        return [nbytes, secs]

    def families(self) -> list[Family]:
        fams = engine_families(self.engine.stats(), self.model_name)
        fams += [h.family(self.model_name) for h in self.histograms]
        fams += self.transfer_families()
        if self._lifecycle is not None:
            fams += lifecycle_families(self._lifecycle(), self.model_name)
        if self._overload is not None:
            fams += overload_families(self._overload(), self.model_name)
        if self._diagnostics is not None:
            fams += diagnostics_families(self._diagnostics(),
                                         self.model_name)
        return fams

    def generate(self) -> bytes:
        return "".join(f.render() for f in self.families()).encode()

    def observe_request(self, start: float, first_token: Optional[float],
                        end: float, n_output: int) -> None:
        if first_token is not None:
            self.ttft.observe(first_token - start)
            if n_output > 1:
                self.tpot.observe((end - first_token) / (n_output - 1))
        self.e2e.observe(end - start)

    def observe_stages(self, out) -> None:
        """Per-stage decomposition from a FINISHED RequestOutput's
        lifecycle stamps (all monotonic). Partial stamps observe only the
        stages that completed."""
        if out.arrival_time is not None and out.admit_time is not None:
            self.queue_time.observe(max(0.0, out.admit_time
                                        - out.arrival_time))
        if out.admit_time is not None and out.first_token_time is not None:
            self.prefill_time.observe(max(0.0, out.first_token_time
                                          - out.admit_time))
        if out.first_token_time is not None and out.finish_time is not None:
            decode = max(0.0, out.finish_time - out.first_token_time)
            self.decode_time.observe(decode)
            if out.num_output_tokens > 1:
                self.itl.observe(decode / (out.num_output_tokens - 1))

    def observe_step(self, duration: float) -> None:
        self.step_duration.observe(duration)
