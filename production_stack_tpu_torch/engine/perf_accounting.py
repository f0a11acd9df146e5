"""Continuous goodput accounting: live MFU / HBM-bandwidth estimates and
compile-event tracking.

A copy of production_stack_tpu/engine/perf_accounting.py for one card:

* ``PerfAccountant`` — a sliding window of per-dispatch FLOP/byte/token
  estimates (prefill and decode recorded separately by the engine's
  ``_run_*`` paths), reduced to ``vllm:model_flops_utilization``,
  ``vllm:hbm_bandwidth_utilization`` and ``vllm:tokens_per_second{phase}``
  at scrape time, plus periodic device-memory snapshots from
  ``torch.cuda.memory_stats``. The arithmetic is the reference's, but
  for the collectives: ``from_runner`` takes the cards the ranks run on
  (``n_chips``) and the degree the heads are sharded over
  (``tensor_parallel``) from the runner, and the collective bytes are
  those rank 0's device group counted as it sent them, by op
  (parallel/distributed.py ``RankGroup.wire``: float32 all-reduces,
  int32 all-reduces and float32 max all-reduces of the int8 route, the
  logits' all-gather), each dispatch taking what was sent since the last
  one; the KV plane's share traffic (``KV_OPS``) and the ring prefill's
  exchange (``RING_OPS``) are no dispatch's, and a ring prefill is
  recorded as a prefill of its prompt's tokens, as the reference's; on
  the seq x tensor grid rank 0's tensor group counts into the same
  ``wire``, so a ring prefill is billed its tensor group's collectives
  as any prefill at that tensor size, and its ring ops stay unbilled; on
  the stage x tensor grid rank 0 counts its stage's tensor collectives
  (stage 0's), and the stage relay (``STAGE_OPS``) stays unbilled; under
  expert parallelism a MoE layer's combine over the expert ranks counts
  under ``moe_combine`` (2 (N - 1) / N of its ``T E`` float32 partial a
  card, billed to its dispatch like the tensor all-reduces). The
  reference's formulas count a bf16 all-reduce of the hidden
  state twice a layer, half of what the port's float32 partials put on
  the wire, and none of its embedding's all-reduce. Zero at tp = 1.
  FLOPs and weight bytes count the whole model, not a rank's shard; the
  bytes rank 0's runner holds, its shard with its experts cut, stand
  beside them (``held_param_bytes``). The
  peaks default to the H100 SXM data sheet (``config.H100_PEAK_*``).
* ``CompileTracker`` — wraps each of the runner's three step programs. A
  never-seen signature is the work a new CUDA graph capture would do, so
  the first call per signature counts as a compile event (its wall time
  approximates the first-call cost); after ``mark_steady()`` (warmup
  complete) any new signature also ticks the unexpected-recompile counter.
  The runner keys each program on what the card runs (``key`` below), not
  on the shapes of its host arguments.

Token counts are LIVE tokens, not padded: padding waste shows as lost MFU.
FLOPs count a token's ACTIVE parameters (``active_param_count``): on a
MoE model every parameter outside the expert stacks plus k/X of them,
where the reference counts every expert for every token; on a dense model
the two counts are equal. Bytes count each leaf at its own element size,
int8 weights and their float32 scales included.

The tenant attribution plane is the reference's: each ``record_*`` call's
``tenants`` (per-tenant ``{"prefill", "decode", "live"}`` token shares of
the dispatch) bills prefill and decode tokens to their tenants and splits
the dispatch's wall ``seconds`` by live-token share with exact
conservation (``tenancy.split_shares``), so per-tenant chip-seconds sum to
the attributed dispatch seconds. The table is bounded: past
``_tenant_cap`` rows the smallest fold into ``"other"``, rows idle past
``tenant_idle_expiry`` fold there too, and every export folds again to
``tenant_top_k`` (``tenant_fields``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from production_stack_tpu_torch.engine.config import (
    H100_PEAK_HBM_GBPS,
    H100_PEAK_NVLINK_GBPS,
    H100_PEAK_TFLOPS,
)
from production_stack_tpu_torch.parallel.distributed import (
    KV_OPS,
    RING_OPS,
    STAGE_OPS,
)
from production_stack_tpu_torch.tenancy import OTHER, fold_records, split_shares

_EVENT_TAIL = 64  # compile events kept verbatim for /debug/perf


def estimate_param_count(model_cfg) -> int:
    """Llama-geometry parameter count from config: the fallback when the
    runner has no parameter dict."""
    h = model_cfg.hidden_size
    inter = model_cfg.intermediate_size
    qkv = (h * model_cfg.num_heads * model_cfg.head_dim
           + 2 * h * model_cfg.num_kv_heads * model_cfg.head_dim
           + model_cfg.num_heads * model_cfg.head_dim * h)
    mlp = 3 * h * inter * max(getattr(model_cfg, "num_experts", 0) or 1, 1)
    return int(2 * model_cfg.vocab_size * h
               + model_cfg.num_layers * (qkv + mlp))


def _dtype_bytes(dtype: str) -> int:
    return 4 if "32" in str(dtype) else 2


def _tensors(tree):
    """The tensors of a nested dict of parameters."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif hasattr(tree, "numel"):
        yield tree


def param_counts(params: dict, model_cfg) -> Tuple[int, int, int]:
    """(parameters, active parameters a token, bytes) of a parameter dict.
    A quantized leaf ``{"q", "s"}`` counts q's elements as parameters and
    both tensors' bytes. A token visits k of X experts, so the expert
    stacks count k/X of their parameters among the active ones."""
    experts = set()
    if (getattr(model_cfg, "architecture", "") == "mixtral"
            and getattr(model_cfg, "num_experts", 0) > 0):
        experts = {"w_gate", "w_up", "w_down"}
    share = (model_cfg.num_experts_per_tok / model_cfg.num_experts
             if experts else 1.0)
    count = active = nbytes = 0

    def add(name: str, leaf) -> None:
        nonlocal count, active, nbytes
        n = int((leaf["q"] if isinstance(leaf, dict) else leaf).numel())
        count += n
        active += n * share if name in experts else n
        nbytes += sum(int(t.numel()) * t.element_size()
                      for t in _tensors(leaf))

    for name, leaf in params.items():
        if name == "layers":
            for lname, lleaf in leaf.items():
                add(lname, lleaf)
        else:
            add(name, leaf)
    return count, int(round(active)), nbytes


def _meta_params(model_cfg) -> dict:
    """The whole model's parameter dict as shapes only (meta tensors),
    quantized as the model's own are (``quant.maybe_quantize``: an int8
    leaf's int8 values and float32 scales)."""
    import torch

    from production_stack_tpu_torch.engine.quant import maybe_quantize
    from production_stack_tpu_torch.models.registry import get_model

    def walk(shapes: dict) -> dict:
        return {k: walk(v) if isinstance(v, dict) else torch.empty(
            v, dtype=model_cfg.torch_dtype, device="meta")
            for k, v in shapes.items()}

    return maybe_quantize(model_cfg, walk(
        get_model(model_cfg).param_shapes(model_cfg)))


class CompileTracker:
    """Wrap a step program and surface compile events.

    By default the signature key is the reference's: per-argument (shape,
    dtype) for arrays, literal values for hashable statics, structural
    markers for containers. ``key(*args, **kwargs)`` replaces it where the
    program's host arguments do not show what the card runs (the ragged
    step cuts its budget-wide arrays to the live stream), and
    ``bucket(*args, **kwargs)`` names the signature's shape bucket. The
    wall time of a signature's first call is its compile event's seconds;
    later calls of a seen signature are not timed."""

    def __init__(self, kind: str, fn: Callable, observer: Callable,
                 bucket_argidx: int = 2, key: Optional[Callable] = None,
                 bucket: Optional[Callable] = None):
        self.kind = kind
        self.fn = fn
        self.observer = observer
        self.bucket_argidx = bucket_argidx
        self.key = key
        self.bucket = bucket
        self._seen: set = set()

    def _sig(self, v):
        shape = getattr(v, "shape", None)
        if shape is not None:
            return ("arr", tuple(shape), str(getattr(v, "dtype", "?")))
        if isinstance(v, (bool, int, float, str, type(None))):
            return v
        if isinstance(v, (tuple, list)):
            return ("seq", tuple(self._sig(x) for x in v))
        if isinstance(v, dict):
            return ("map", tuple(sorted(str(k) for k in v)))
        return type(v).__name__

    def _bucket(self, args) -> str:
        if len(args) > self.bucket_argidx:
            shape = getattr(args[self.bucket_argidx], "shape", None)
            if shape:
                return "x".join(str(int(d)) for d in shape)
        return "-"

    def __call__(self, *args, **kwargs):
        if self.key is not None:
            key = self.key(*args, **kwargs)
        else:
            key = (tuple(self._sig(a) for a in args),
                   tuple((k, self._sig(v))
                         for k, v in sorted(kwargs.items())))
        if key in self._seen:
            return self.fn(*args, **kwargs)
        t0 = time.monotonic()
        out = self.fn(*args, **kwargs)
        self._seen.add(key)
        bucket = (self.bucket(*args, **kwargs) if self.bucket is not None
                  else self._bucket(args))
        self.observer(self.kind, bucket, time.monotonic() - t0)
        return out


class PerfAccountant:
    """Sliding-window goodput accounting + compile-event bookkeeping.

    Recording happens on the engine thread; snapshots are read from the
    HTTP handlers — a lock keeps the two honest."""

    def __init__(self, model_cfg, *, param_count: int, param_bytes: int,
                 window: float = 60.0, peak_tflops: float = 0.0,
                 peak_hbm_gbps: float = 0.0, hbm_poll_interval: float = 5.0,
                 peak_ici_gbps: float = 0.0, device=None,
                 active_param_count: Optional[int] = None,
                 tenant_metering: bool = True, tenant_top_k: int = 8,
                 n_chips: int = 1, tensor_parallel: int = 1):
        self.window = max(window, 1.0)
        self.n_chips = max(int(n_chips), 1)
        self.tp = max(int(tensor_parallel), 1)
        # FLOP and weight-stream costs below are GLOBAL (whole model), so
        # the matching ceilings are the cards' aggregate peaks
        self.peak_flops = ((peak_tflops or H100_PEAK_TFLOPS) * 1e12
                           * self.n_chips)
        self.peak_hbm = ((peak_hbm_gbps or H100_PEAK_HBM_GBPS) * 1e9
                         * self.n_chips)
        # collective bytes are counted PER CARD on the wire, so the link
        # ceiling stays per card
        self.peak_ici = (peak_ici_gbps or H100_PEAK_NVLINK_GBPS) * 1e9
        self.param_count = max(int(param_count), 1)
        # the parameters a token's FLOPs count (module docstring)
        self.active_param_count = max(int(
            param_count if active_param_count is None
            else active_param_count), 1)
        self.param_bytes = max(int(param_bytes), 1)
        # the weight bytes rank 0's runner holds (its tensor shard and its
        # share of the experts; the whole model on one device)
        self.held_param_bytes = self.param_bytes
        self.hbm_poll_interval = hbm_poll_interval
        # the card whose memory counters feed the HBM gauges; None or a
        # CPU device leaves them at 0
        self.device = device
        cfg = model_cfg
        self._attn_per_tok_ctx = (4 * cfg.num_layers * cfg.num_heads
                                  * cfg.head_dim)
        self._kv_bytes_per_tok = (2 * cfg.num_layers * cfg.num_kv_heads
                                  * cfg.head_dim * _dtype_bytes(cfg.dtype))
        # the device group's per-card wire bytes by op (RankGroup.wire),
        # read at each dispatch; None on one device (no collectives)
        self.wire: Optional[Dict[str, float]] = None
        self._wire_seen: Dict[str, float] = {}
        self._lock = threading.Lock()
        # (ts, phase, flops, hbm_bytes, live_tokens, ici_bytes)
        self._events: deque = deque()
        self._totals = {"prefill_tokens": 0, "decode_tokens": 0,
                        "flops": 0.0, "hbm_bytes": 0.0, "ici_bytes": 0.0,
                        "dispatches": 0}
        self._collective = {"all_reduce": 0.0, "all_gather": 0.0}
        # compile tracking
        self._compile_counts: dict = {}
        self._compile_events: deque = deque(maxlen=_EVENT_TAIL)
        self._compile_seconds = 0.0
        self._unexpected = 0
        self._steady = False
        # device memory occupancy (polled at most every hbm_poll_interval)
        self._hbm = {"used": 0, "total": 0, "peak": 0}
        self._hbm_ts = 0.0
        # anomaly subscription (engine/diagnostics.py): called OUTSIDE
        # self._lock with (trigger_name, detail_dict) when a bug signal
        # fires here — an unexpected recompile, device memory past
        # hbm_threshold, a cost-model drift episode. The subscriber must
        # return fast (DiagnosticsManager.trigger spawns its capture
        # thread and returns).
        self.anomaly_hook: Optional[Callable[[str, dict], None]] = None
        self.hbm_threshold = 0.0  # fraction of device memory; 0 = off
        # -- cost-model drift plane ---------------------------------------
        # Every dispatch the window already costs gets a PREDICTED wall
        # time from the same roofline arithmetic — max of FLOP-time,
        # HBM-time and link-time for its live token/byte counts — kept
        # beside the MEASURED wall seconds the engine passes in. Detection
        # is baseline-relative: after warmup the first full window freezes
        # a per-phase baseline ratio, and sustained excursion of
        # ratio/baseline outside [1/band, band] opens one episode.
        # band<=1 (the default 0) disables detection; the gauges export
        # either way.
        self.costmodel_drift_band = 0.0
        # windowed dispatches a phase needs before its ratio is judged
        # (or its baseline frozen) — one outlier dispatch is not drift
        self.costmodel_min_events = 8
        # (ts, phase, predicted_s, measured_s) — same window as _events
        self._drift_events: deque = deque()
        self._costmodel = {
            "predicted_seconds": {"prefill": 0.0, "decode": 0.0},
            "measured_seconds": {"prefill": 0.0, "decode": 0.0},
            "episodes": 0,
        }
        self._drift_baseline: Dict[str, float] = {}
        self._drift_out: Dict[str, bool] = {}
        # -- tenant attribution plane (tenancy.py) --------------------------
        # Per-tenant cumulative counters fed by the record_* calls that
        # bill the window. Observe-only: turning it off changes nothing
        # outside self._tenants / self._tenant_seconds. Bounded: past
        # _tenant_cap the smallest records fold into "other" (sums kept),
        # and every export folds again to tenant_top_k.
        self.tenant_metering = bool(tenant_metering)
        self.tenant_top_k = max(int(tenant_top_k), 1)
        self._tenant_cap = max(4 * self.tenant_top_k, 64)
        self._tenants: Dict[str, Dict[str, float]] = {}
        self._tenant_seconds = 0.0  # total attributed dispatch seconds
        # last activity per tenant: rows idle past tenant_idle_expiry fold
        # into "other" (6 h, the router tracker's bin horizon)
        self.tenant_idle_expiry = 21600.0
        self._tenant_seen: Dict[str, float] = {}

    @classmethod
    def from_runner(cls, config, runner) -> "PerfAccountant":
        """The accountant of ``runner``'s model: parameters, active
        parameters and bytes counted over its parameter tensors
        (``param_counts``; the LoRA bank, the grammar bank and the KV pool
        are not parameters). Under tensor parallelism they are counted
        over the whole model's shapes (a rank holds a shard), the cards
        are those the ranks run on, and the collective degree is the
        runner's ``tensor_parallel`` (1 where the heads are replicated, as
        the reference keys it). A staged runner's are summed over its
        stages' shares (``param_shares``), the whole model's."""
        params = getattr(runner, "params", None)
        if getattr(runner, "ranks", None) is not None:
            params = _meta_params(config.model)
        param_count = active = param_bytes = 0
        if params:
            param_count, active, param_bytes = param_counts(params,
                                                            config.model)
        elif hasattr(runner, "param_shares"):
            param_count, active, param_bytes = (sum(c) for c in zip(*(
                param_counts(p, config.model)
                for p in runner.param_shares())))
        if not param_count:
            param_count = active = estimate_param_count(config.model)
            param_bytes = param_count * _dtype_bytes(config.model.dtype)
        perf = config.perf
        acct = cls(config.model, param_count=param_count,
                   param_bytes=param_bytes, window=perf.window,
                   peak_tflops=perf.peak_tflops,
                   peak_hbm_gbps=perf.peak_hbm_gbps,
                   hbm_poll_interval=perf.hbm_poll_interval,
                   peak_ici_gbps=perf.peak_ici_gbps,
                   device=getattr(runner, "device", None),
                   active_param_count=active,
                   tenant_metering=config.tenant_metering,
                   tenant_top_k=config.tenant_top_k,
                   n_chips=getattr(runner, "cards", 1),
                   tensor_parallel=getattr(runner, "tensor_parallel", 1))
        acct.costmodel_drift_band = perf.costmodel_drift_band
        ranks = getattr(runner, "ranks", None)
        if ranks is not None:
            acct.wire = ranks.wire
            held = getattr(runner, "params", None)
            if held:
                acct.held_param_bytes = param_counts(held, config.model)[2]
        return acct

    def _take_wire(self) -> Dict[str, float]:
        """The collective bytes sent since the last call, by op. The KV
        plane's share traffic (``KV_OPS``), the ring prefill's exchange
        (``RING_OPS``) and the stage relay (``STAGE_OPS``) are no
        dispatch's and are left out, so a step's collective bytes stay its
        own."""
        if self.wire is None:
            return {}
        now = {op: n for op, n in self.wire.items()
               if op not in KV_OPS + RING_OPS + STAGE_OPS}
        sent = {op: n - self._wire_seen.get(op, 0.0)
                for op, n in now.items()}
        self._wire_seen = now
        return {op: n for op, n in sent.items() if n}

    # -- compile events ------------------------------------------------------
    def on_compile(self, kind: str, bucket: str, seconds: float) -> None:
        with self._lock:
            key = (kind, bucket)
            self._compile_counts[key] = self._compile_counts.get(key, 0) + 1
            self._compile_seconds += seconds
            unexpected = self._steady
            if unexpected:
                self._unexpected += 1
            event = {
                "kind": kind, "bucket": bucket,
                "seconds": round(seconds, 4),
                "unexpected": unexpected, "ts": time.time(),
            }
            self._compile_events.append(event)
        if unexpected and self.anomaly_hook is not None:
            self.anomaly_hook("unexpected_recompile", dict(event))

    def mark_steady(self) -> None:
        """Warmup ran every serving variant: from here on a fresh
        signature means a shape leaked past warmup — a bug signal.

        The cost-model drift window resets here: pre-steady dispatch wall
        times carry first-call costs, so the measured/predicted baseline
        is only meaningful from steady state on. The cumulative
        predicted/measured counters keep their pre-steady totals."""
        with self._lock:
            self._steady = True
            self._drift_events.clear()
            self._drift_baseline.clear()
            self._drift_out.clear()

    # -- dispatch accounting -------------------------------------------------
    def record_prefill(self, live_tokens: int, ctx_tokens: int,
                       rows: int, ts: Optional[float] = None, *,
                       seconds: float = 0.0,
                       tenants: Optional[dict] = None) -> None:
        """One prefill dispatch: ``live_tokens`` real prompt tokens over
        ``rows`` chunks whose post-chunk context lengths sum to
        ``ctx_tokens``. ``seconds`` is the dispatch's wall time and
        ``tenants`` its per-tenant token shares (the attribution plane's
        only inputs)."""
        ctx_mean = ctx_tokens / max(rows, 1)
        flops = (2.0 * self.active_param_count * live_tokens
                 + self._attn_per_tok_ctx * live_tokens * ctx_mean)
        hbm = (self.param_bytes
               + (live_tokens + ctx_tokens) * self._kv_bytes_per_tok)
        coll = self._take_wire()
        self._record(ts, "prefill", flops, hbm, live_tokens, coll)
        self._note_costmodel(
            ts, [("prefill", self._predicted_seconds(
                flops, hbm, sum(coll.values())))], seconds)
        self.attribute_tenants(seconds, tenants)

    def record_decode(self, live_seqs: int, steps: int, ctx_tokens: int,
                      ts: Optional[float] = None, *,
                      seconds: float = 0.0,
                      tenants: Optional[dict] = None) -> None:
        """One fused decode dispatch: ``steps`` iterations over
        ``live_seqs`` sequences with ``ctx_tokens`` total context. Decode
        re-reads the weights every step."""
        tokens = live_seqs * steps
        flops = (2.0 * self.active_param_count * tokens
                 + self._attn_per_tok_ctx * ctx_tokens * steps)
        hbm = steps * (self.param_bytes
                       + (ctx_tokens + live_seqs) * self._kv_bytes_per_tok)
        coll = self._take_wire()
        self._record(ts, "decode", flops, hbm, tokens, coll)
        self._note_costmodel(
            ts, [("decode", self._predicted_seconds(
                flops, hbm, sum(coll.values())))], seconds)
        self.attribute_tenants(seconds, tenants)

    def record_ragged(self, prefill_tokens: int, prefill_ctx: int,
                      prefill_rows: int, decode_seqs: int, decode_ctx: int,
                      ts: Optional[float] = None, *,
                      spec_tokens: int = 0, spec_ctx: int = 0,
                      spec_rows: int = 0, seconds: float = 0.0,
                      tenants: Optional[dict] = None) -> None:
        """One unified ragged dispatch: ``prefill_tokens`` prompt tokens
        over ``prefill_rows`` chunks (post-chunk contexts summing to
        ``prefill_ctx``) packed together with ``decode_seqs`` single-token
        decode rows (contexts summing to ``decode_ctx``).

        The cost lands as TWO window events so the phase gauges stay
        meaningful: the prefill share carries the weight pass (read once
        per dispatch, attributed to whichever phase is present), the
        decode share adds its attention context FLOPs and KV traffic on
        top. Speculative verify spans (``spec_tokens`` draft tokens over
        ``spec_rows`` rows, post-span contexts summing to ``spec_ctx``)
        are prefill-shaped work costed into the prefill event with zero
        goodput tokens: accepted drafts land as decode goodput through
        ``record_spec_accepted``. ``seconds`` is the fused dispatch's wall
        time, split over the two events by predicted share, and over the
        tenants by their live-token share of the stream. The dispatch's
        collective bytes split over the two events by their share of the
        stream's tokens."""
        if prefill_tokens <= 0 and decode_seqs <= 0 and spec_tokens <= 0:
            return
        self.attribute_tenants(seconds, tenants)
        predicted: List[Tuple[str, float]] = []
        coll = self._take_wire()
        pre = (prefill_tokens + spec_tokens) / (
            prefill_tokens + spec_tokens + decode_seqs)
        if prefill_tokens > 0 or spec_tokens > 0:
            ctx_mean = prefill_ctx / max(prefill_rows, 1)
            flops = (2.0 * self.active_param_count * prefill_tokens
                     + self._attn_per_tok_ctx * prefill_tokens * ctx_mean)
            hbm = (self.param_bytes
                   + (prefill_tokens + prefill_ctx) * self._kv_bytes_per_tok)
            if spec_tokens > 0:
                spec_ctx_mean = spec_ctx / max(spec_rows, 1)
                flops += (2.0 * self.active_param_count * spec_tokens
                          + self._attn_per_tok_ctx * spec_tokens
                          * spec_ctx_mean)
                hbm += ((spec_tokens + spec_ctx) * self._kv_bytes_per_tok)
            part = {op: n * pre for op, n in coll.items()}
            self._record(ts, "prefill", flops, hbm, prefill_tokens, part)
            predicted.append(("prefill", self._predicted_seconds(
                flops, hbm, sum(part.values()))))
        if decode_seqs > 0:
            flops = (2.0 * self.active_param_count * decode_seqs
                     + self._attn_per_tok_ctx * decode_ctx)
            hbm = (decode_ctx + decode_seqs) * self._kv_bytes_per_tok
            if prefill_tokens <= 0 and spec_tokens <= 0:
                hbm += self.param_bytes  # decode-only pays the weights
            part = {op: n * (1.0 - pre) for op, n in coll.items()}
            self._record(ts, "decode", flops, hbm, decode_seqs, part)
            predicted.append(("decode", self._predicted_seconds(
                flops, hbm, sum(part.values()))))
        self._note_costmodel(ts, predicted, seconds)

    def record_spec_accepted(self, tokens: int,
                             ts: Optional[float] = None,
                             tenant: Optional[str] = None) -> None:
        """Accepted speculative tokens: decode goodput on top of the one
        a row the dispatch already counted. Zero FLOPs/HBM here (the
        verify work was costed in ``record_ragged``). Not a dispatch."""
        if tokens <= 0:
            return
        now = ts if ts is not None else time.monotonic()
        with self._lock:
            self._events.append((now, "decode", 0.0, 0.0, tokens, 0.0))
            self._totals["decode_tokens"] += tokens
            self._trim(now)
        if tenant is not None:
            self.attribute_tenants(0.0, {tenant: {"decode": tokens}})

    # -- cost-model drift detection ------------------------------------------
    def _predicted_seconds(self, flops: float, hbm: float,
                           ici: float) -> float:
        """Roofline-predicted wall time for one dispatch event: the
        binding ceiling's transit time for its live FLOP/byte counts."""
        return max(flops / self.peak_flops, hbm / self.peak_hbm,
                   ici / self.peak_ici)

    def _note_costmodel(self, ts: Optional[float],
                        predicted: List[Tuple[str, float]],
                        seconds: float) -> None:
        """Feed one dispatch's predicted-vs-measured seconds into the
        drift window and judge the band. Measured wall time is split
        across the dispatch's phase events by predicted share; events with
        no wall time still accumulate the predicted counter but never
        enter the ratio window. Fires ``anomaly_hook("costmodel_drift",
        ...)`` OUTSIDE the lock, one call per phase episode edge."""
        if not predicted:
            return
        now = ts if ts is not None else time.monotonic()
        measured = max(float(seconds), 0.0)
        total_pred = sum(p for _, p in predicted)
        alerts: List[dict] = []
        with self._lock:
            for phase, pred in predicted:
                if pred <= 0:
                    continue
                self._costmodel["predicted_seconds"][phase] += pred
                if measured > 0 and total_pred > 0:
                    share = measured * (pred / total_pred)
                    self._costmodel["measured_seconds"][phase] += share
                    self._drift_events.append((now, phase, pred, share))
            self._trim_drift(now)
            if measured > 0:
                alerts = self._evaluate_drift_locked(now)
        if self.anomaly_hook is not None:
            for detail in alerts:
                self.anomaly_hook("costmodel_drift", detail)

    def _trim_drift(self, now: float) -> None:
        while (self._drift_events
               and self._drift_events[0][0] < now - self.window):
            self._drift_events.popleft()

    def _drift_ratios_locked(self) -> Tuple[Dict[str, float],
                                            Dict[str, int]]:
        pred = {"prefill": 0.0, "decode": 0.0}
        meas = {"prefill": 0.0, "decode": 0.0}
        counts = {"prefill": 0, "decode": 0}
        for _, phase, p, m in self._drift_events:
            pred[phase] += p
            meas[phase] += m
            counts[phase] += 1
        ratios = {phase: (meas[phase] / pred[phase]) if pred[phase] > 0
                  else 0.0 for phase in pred}
        return ratios, counts

    def _evaluate_drift_locked(self, now: float) -> List[dict]:
        """Judge each phase's windowed ratio against its frozen baseline
        (under ``self._lock``); returns the anomaly details to fire after
        release. Detection needs band > 1, warmup done, and
        ``costmodel_min_events`` windowed dispatches in the phase. The
        first qualifying window FREEZES the phase's baseline; an episode
        opens (and counts, with one anomaly) when ratio/baseline leaves
        [1/band, band] and closes when it returns."""
        band = self.costmodel_drift_band
        if band <= 1.0 or not self._steady:
            return []
        alerts: List[dict] = []
        ratios, counts = self._drift_ratios_locked()
        for phase, ratio in ratios.items():
            if counts[phase] < self.costmodel_min_events or ratio <= 0:
                continue
            baseline = self._drift_baseline.get(phase)
            if baseline is None or baseline <= 0:
                self._drift_baseline[phase] = ratio
                continue
            relative = ratio / baseline
            out = relative > band or relative < 1.0 / band
            if out and not self._drift_out.get(phase, False):
                self._costmodel["episodes"] += 1
                alerts.append({
                    "phase": phase,
                    "ratio": round(ratio, 6),
                    "baseline": round(baseline, 6),
                    "relative": round(relative, 4),
                    "band": band,
                    "window_events": counts[phase],
                    "ts": time.time(),
                })
            self._drift_out[phase] = out
        return alerts

    def _costmodel_fields_locked(self) -> dict:
        ratios, counts = self._drift_ratios_locked()
        return {
            "band": self.costmodel_drift_band,
            "min_events": self.costmodel_min_events,
            "predicted_seconds": dict(self._costmodel["predicted_seconds"]),
            "measured_seconds": dict(self._costmodel["measured_seconds"]),
            "drift_ratio": ratios,
            "window_events": counts,
            "baseline": {p: round(v, 6) for p, v
                         in self._drift_baseline.items()},
            "out_of_band": sorted(p for p, o in self._drift_out.items()
                                  if o),
            "episodes": self._costmodel["episodes"],
        }

    # -- tenant attribution --------------------------------------------------
    def attribute_tenants(self, seconds: float,
                          tenants: Optional[dict]) -> None:
        """Bill one dispatch to its tenants: per-tenant prefill/decode
        goodput tokens accumulate directly, and the dispatch's wall
        ``seconds`` split by each tenant's ``live`` token share
        (tenancy.split_shares — parts sum to ``seconds`` bit-exactly, the
        conservation invariant). No-op when metering is off or the
        dispatch carried no tenant map (bucketed warmup probes)."""
        if not self.tenant_metering or not tenants:
            return
        live = {t: rec.get("live", 0) for t, rec in tenants.items()
                if rec.get("live", 0) > 0}
        shares = split_shares(seconds, live) if seconds > 0 else {}
        now = time.monotonic()
        with self._lock:
            for t, rec in tenants.items():
                row = self._tenant_row(t)
                row["prefill_tokens"] += int(rec.get("prefill", 0))
                row["decode_tokens"] += int(rec.get("decode", 0))
                row["chip_seconds"] += shares.get(t, 0.0)
                self._tenant_seen[t] = now
            self._tenant_seconds += sum(shares.values())
            self._bound_tenants(now)

    def _tenant_row(self, tenant: str) -> dict:
        return self._tenants.setdefault(
            tenant, {"prefill_tokens": 0, "decode_tokens": 0,
                     "chip_seconds": 0.0, "requests": 0,
                     "queue_seconds_sum": 0.0})

    def _bound_tenants(self, now: Optional[float] = None) -> None:
        self.expire_idle_tenants(now, _locked=True)
        if len(self._tenants) > self._tenant_cap:
            # bound the *internal* table too, not just the export: fold
            # the smallest records into "other" (sums conserved)
            self._tenants = fold_records(
                self._tenants, k=self._tenant_cap // 2,
                weight_key="chip_seconds")
            self._tenant_seen = {t: ts for t, ts in
                                 self._tenant_seen.items()
                                 if t in self._tenants}

    def expire_idle_tenants(self, now: Optional[float] = None,
                            _locked: bool = False) -> int:
        """Fold tenants idle past ``tenant_idle_expiry`` (6h, the router
        tracker's bin horizon) into the ``"other"`` row. Cumulative sums
        conserve — only the identity is forgotten — and the cap slots
        recycle under identity churn instead of pinning every tenant
        ever seen for the life of the process. Returns the number
        expired."""
        now = now if now is not None else time.monotonic()
        if not _locked:
            with self._lock:
                return self.expire_idle_tenants(now, _locked=True)
        cutoff = now - self.tenant_idle_expiry
        stale = [t for t, ts in self._tenant_seen.items()
                 if ts < cutoff and t != OTHER]
        for t in stale:
            row = self._tenants.pop(t, None)
            self._tenant_seen.pop(t, None)
            if row:
                other = self._tenant_row(OTHER)
                for k, v in row.items():
                    other[k] = other.get(k, 0) + v
        return len(stale)

    def note_request(self, tenant: str, queue_seconds: float) -> None:
        """One finished request: per-tenant request count and queue-time
        (arrival → admission) accumulation — the source of
        ``vllm:tenant_queue_time_seconds``."""
        if not self.tenant_metering:
            return
        now = time.monotonic()
        with self._lock:
            row = self._tenant_row(tenant)
            row["requests"] += 1
            row["queue_seconds_sum"] += max(float(queue_seconds), 0.0)
            self._tenant_seen[tenant] = now
            self._bound_tenants(now)

    def attribute_seconds(self, tenant_live: dict,
                          seconds: float) -> None:
        """Attribute extra wall seconds (the deferred result fetch of a
        dispatch already billed) by the same live-token shares — keeps
        the conservation invariant across the dispatch/resolve split."""
        if seconds <= 0 or not tenant_live:
            return
        self.attribute_tenants(
            seconds, {t: {"live": n} for t, n in tenant_live.items()})

    def tenant_fields(self, kv_blocks: Optional[dict] = None) -> dict:
        """Bounded per-tenant export for ``stats()['tenants']`` and
        ``/debug/tenants``: cumulative records folded to the top-K by
        chip-seconds with the remainder under ``tenant="other"``
        (tenancy.fold_records — every field's fleet total survives the
        fold). ``kv_blocks`` is the engine's live per-tenant block count
        from the scheduler, merged here so one fold governs every
        export."""
        with self._lock:
            records = {t: dict(r) for t, r in self._tenants.items()}
            seconds_total = self._tenant_seconds
        for t, blocks in (kv_blocks or {}).items():
            rec = records.get(t)
            if rec is None:
                rec = records[t] = {
                    "prefill_tokens": 0, "decode_tokens": 0,
                    "chip_seconds": 0.0, "requests": 0,
                    "queue_seconds_sum": 0.0}
            rec["kv_blocks"] = int(blocks)
        folded = fold_records(records, k=self.tenant_top_k,
                              weight_key="chip_seconds")
        for row in folded.values():
            row.setdefault("kv_blocks", 0)
        return {
            "enabled": self.tenant_metering,
            "top_k": self.tenant_top_k,
            "tracked": len(records),
            "dispatch_seconds_total": seconds_total,
            "tenants": {t: folded[t] for t in sorted(folded)},
        }

    def _record(self, ts, phase, flops, hbm_bytes, tokens,
                coll: Optional[Dict[str, float]] = None) -> None:
        """One window event; ``coll``: its collective bytes by op."""
        now = ts if ts is not None else time.monotonic()
        coll = coll or {}
        ici = sum(coll.values())
        with self._lock:
            self._events.append((now, phase, flops, hbm_bytes, tokens, ici))
            self._totals[f"{phase}_tokens"] += tokens
            self._totals["flops"] += flops
            self._totals["hbm_bytes"] += hbm_bytes
            self._totals["ici_bytes"] += ici
            for op, n in coll.items():
                self._collective[op] = self._collective.get(op, 0.0) + n
            self._totals["dispatches"] += 1
            self._trim(now)

    def _trim(self, now: float) -> None:
        while self._events and self._events[0][0] < now - self.window:
            self._events.popleft()
        self._trim_drift(now)

    # -- device memory occupancy ---------------------------------------------
    def poll_hbm(self, now: Optional[float] = None) -> None:
        """Read the card's allocator counters (bytes allocated now and at
        peak) and its total memory, at most every ``hbm_poll_interval``.
        Host-side queries only: nothing waits on the card. Without a card
        the gauges stay 0. Fires ``anomaly_hook("hbm_pressure", ...)``
        when allocated / total reaches ``hbm_threshold``."""
        now = now if now is not None else time.monotonic()
        if now - self._hbm_ts < self.hbm_poll_interval and self._hbm_ts:
            return
        self._hbm_ts = now
        dev = self.device
        if dev is None or getattr(dev, "type", str(dev)) != "cuda":
            return
        import torch

        stats = torch.cuda.memory_stats(dev)
        used = int(stats.get("allocated_bytes.all.current", 0))
        peak = int(stats.get("allocated_bytes.all.peak", used))
        total = int(torch.cuda.mem_get_info(dev)[1])
        with self._lock:
            self._hbm["used"] = used
            self._hbm["total"] = total
            self._hbm["peak"] = max(self._hbm["peak"], peak)
        if (self.anomaly_hook is not None and self.hbm_threshold > 0
                and total > 0 and used / total >= self.hbm_threshold):
            self.anomaly_hook("hbm_pressure", {
                "used_bytes": used, "total_bytes": total,
                "fraction": round(used / total, 4),
                "threshold": self.hbm_threshold,
            })

    # -- reductions ----------------------------------------------------------
    def _window_rates(self, now: float) -> dict:
        self._trim(now)
        if not self._events:
            return {"mfu": 0.0, "hbm_bw_util": 0.0, "ici_bw_util": 0.0,
                    "prefill_tps": 0.0, "decode_tps": 0.0}
        span = max(now - self._events[0][0], 1e-3)
        flops = sum(e[2] for e in self._events)
        hbm = sum(e[3] for e in self._events)
        ptok = sum(e[4] for e in self._events if e[1] == "prefill")
        dtok = sum(e[4] for e in self._events if e[1] == "decode")
        ici = sum(e[5] for e in self._events)
        return {
            "mfu": flops / (span * self.peak_flops),
            "hbm_bw_util": hbm / (span * self.peak_hbm),
            "ici_bw_util": ici / (span * self.peak_ici),
            "prefill_tps": ptok / span,
            "decode_tps": dtok / span,
        }

    def stats_fields(self) -> dict:
        """Flat fields merged into ``LLMEngine.stats()`` for the metrics
        exposition (engine/metrics.py reads this at scrape time)."""
        self.poll_hbm()
        now = time.monotonic()
        with self._lock:
            rates = self._window_rates(now)
            return {
                **rates,
                "chips": self.n_chips,
                "collective_bytes": dict(self._collective),
                "hbm_bytes_used": self._hbm["used"],
                "hbm_bytes_total": self._hbm["total"],
                "hbm_bytes_peak": self._hbm["peak"],
                "compile_counts": dict(self._compile_counts),
                "compile_seconds_total": self._compile_seconds,
                "unexpected_recompiles": self._unexpected,
                "dispatches_total": self._totals["dispatches"],
                "costmodel": self._costmodel_fields_locked(),
            }

    def snapshot(self) -> dict:
        """JSON document for ``GET /debug/perf``."""
        self.poll_hbm()
        now = time.monotonic()
        with self._lock:
            rates = self._window_rates(now)
            # per-axis roofline breakdown: achieved window rate against
            # each ceiling, side by side
            rooflines = {
                "flop": {"peak_per_s": self.peak_flops,
                         "achieved_per_s": rates["mfu"] * self.peak_flops,
                         "utilization": rates["mfu"]},
                "hbm": {"peak_per_s": self.peak_hbm,
                        "achieved_per_s": (rates["hbm_bw_util"]
                                           * self.peak_hbm),
                        "utilization": rates["hbm_bw_util"]},
                "ici": {"peak_per_s": self.peak_ici,
                        "achieved_per_s": (rates["ici_bw_util"]
                                           * self.peak_ici),
                        "utilization": rates["ici_bw_util"]},
            }
            return {
                "enabled": True,
                "window_seconds": self.window,
                "chips": self.n_chips,
                "tensor_parallel": self.tp,
                "peaks": {"flops": self.peak_flops,
                          "hbm_bytes_per_s": self.peak_hbm,
                          "ici_bytes_per_s": self.peak_ici},
                "model": {"param_count": self.param_count,
                          "active_param_count": self.active_param_count,
                          "param_bytes": self.param_bytes,
                          "held_param_bytes": self.held_param_bytes},
                "model_flops_utilization": rates["mfu"],
                "hbm_bandwidth_utilization": rates["hbm_bw_util"],
                "ici_bandwidth_utilization": rates["ici_bw_util"],
                "rooflines": rooflines,
                "collective_bytes_total": dict(self._collective),
                "tokens_per_second": {"prefill": rates["prefill_tps"],
                                      "decode": rates["decode_tps"]},
                "hbm_bytes": dict(self._hbm),
                "totals": dict(self._totals),
                "costmodel": self._costmodel_fields_locked(),
                "compile": {
                    "steady": self._steady,
                    "total_events": sum(self._compile_counts.values()),
                    "total_seconds": round(self._compile_seconds, 4),
                    "unexpected_recompiles": self._unexpected,
                    "counts": {f"{k}:{b}": n for (k, b), n
                               in sorted(self._compile_counts.items())},
                    "recent": list(self._compile_events),
                },
            }
