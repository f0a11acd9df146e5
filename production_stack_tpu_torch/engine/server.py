"""OpenAI-compatible HTTP server for the PyTorch engine.

Ports the completions surface of production_stack_tpu/engine/server.py
onto the standard library (``http.server.ThreadingHTTPServer``), since the
machines this package targets need not have ``aiohttp``. Each request is
handled on its own thread; the engine steps on the AsyncEngine's thread.

Generation: ``POST /v1/completions`` and ``POST /v1/chat/completions``
(JSON, or SSE ending in ``data: [DONE]`` with ``"stream": true``;
``guided_regex`` or ``guided_json`` constrain the output, and ``model`` may
name a loaded LoRA adapter), ``POST /v1/load_lora_adapter`` and ``POST
/v1/unload_lora_adapter`` (``{"lora_name", "lora_path"}``, the reference
LoraAdapter operator's calls), ``GET /v1/models`` (the model and each
adapter).

What the router and the fleet read: ``GET /health``; ``GET /ready`` (503
``warming`` while the launch warmup runs, ``draining``, ``stalled`` when
the step watchdog sees no progress); ``POST /drain`` (new ``/v1/*`` POSTs
get 503 + ``Retry-After``, in-flight streams finish under
``--drain-deadline``, stragglers are then aborted; SIGTERM drains, then
exits); ``GET /metrics`` (the reference's ``vllm:*`` families, written by
hand: engine/metrics.py); ``POST /kv/lookup`` (with the host tier's
``matched_tokens_host``); ``POST /tokenize`` and ``/detokenize``; ``GET
/debug/perf`` (the perf accountant, the ``kv_transfer`` and ``kv_tier``
blocks); ``GET /debug/canary`` (golden records of the pinned probes);
``POST /debug/profile`` (a ``torch.profiler`` Chrome trace as tar.gz).
These handlers read host state only: none waits on the card or on a step.

The KV plane (``--role prefill|decode``; engine/kv_transfer.py frames, the
reference's wire format): ``POST /kv/export`` returns blocks' KV, whole or,
with ``"stream": true``, as chunked layer-group frames; ``POST /kv/recv``
lands a pushed transfer (a chunked body this module decodes itself) into
free pool blocks. A completion's ``kv_transfer_params`` drives both of the
router's flows: with ``do_remote_decode`` the prefill hop answers with
``remote_block_ids`` and, given ``push_url`` and ``transfer_id``, first
pushes its blocks to that decode engine; the decode hop splices a landed
push by its ``transfer_id`` (no re-prefill) or pulls ``remote_block_ids``
from ``remote_host`` into its prefix cache before admission, and falls back
to a plain prefill when neither is there. ``--kv-host-cache-bytes`` and
``--remote-kv-url`` put the host and remote tiers behind the pool
(engine/kv_offload.py).

Scoring, on the dense path (engine/engine.py ``embed``,
``choice_logprobs``, ``prompt_logprobs``): completions ``echo`` (the prompt
prepended, with its teacher-forced logprobs under ``logprobs``; with
``max_tokens: 0`` the prompt alone), ``guided_choice`` (one of the given
strings, scored whole: the argmax at temperature 0, else sampled from
softmax(logP / T)), ``POST /v1/embeddings`` and ``/pooling`` (mean-pooled
final hidden states), ``POST /v1/score`` and ``/v1/rerank`` (also
``/rerank``: cosine of pooled states). ``POST /v1/messages`` (Anthropic)
and ``/v1/responses`` (OpenAI), JSON or SSE with the reference's events.
Sleep mode: ``POST /sleep?level=1|2`` (409 with requests in flight),
``POST /wake_up``, ``GET /is_sleeping``.

Resilience, overload and tenants, as the reference's:

- ``x-request-deadline`` (epoch seconds, set by the router) on completions
  and chat: an expired one answers 504 ``timeout_error`` before the
  scheduler is touched; one that expires mid-generation aborts every
  choice (their KV blocks are freed, ``vllm:aborted_seqs_total`` counts
  them) and answers 504, or ends a stream with an in-band error before
  ``[DONE]``. A malformed header means no deadline.
- Overload 429s carry a ``Retry-After`` from the scheduler's queue depth
  over its drain rate, ``--overload-retry-after`` the floor;
  ``--max-queue-len`` bounds the waiting queue.
- ``--fault-injection SPEC`` (``""`` arms it with no fault) faults ``POST
  /v1/*`` (testing/faults.py) and adds ``POST /debug/faults?...`` to flip
  faults on a live engine; unarmed, that route is 404.
- The tenant (tenancy.resolve_tenant: ``x-tenant-id``, the body's
  ``user``, a hash of the API key, else ``anonymous``) rides each
  completion into the engine: ``--fair-share`` and ``--tenant-weights``
  order admission and prefill by it, the ``vllm:tenant_*`` families and
  ``GET /debug/tenants`` meter it, ``--tenant-ledger-path`` writes a usage
  record per finished request.
- ``--brownout``: a thread evaluates queue depth, device memory and the
  watchdog every ``--brownout-interval`` seconds (engine/overload.py);
  stage 1 sheds draft grants, stage 2 clamps ``max_tokens`` and pauses
  tier prefetch, stage 3 answers 429 to new requests of over-weight
  tenants (a pushed P->D continuation always passes). ``GET
  /debug/overload`` shows it.

Observability, as the reference's:

- The flight recorder (flight_recorder.py; ``--flight-recorder-size``):
  each completion and chat request leaves a timeline (received, admitted,
  first token, last token, finished), its token counts summed over its
  choices, its status and its outcome (``completed``, ``rejected``,
  ``deadline_exceeded``, ``client_disconnect``), keyed by its request id
  with the propagated ``x-request-id``, which buffered and error answers
  echo. ``GET /debug/requests?limit=N`` serves them, newest first; one log
  line a request.
- W3C tracing (engine/tracing.py; ``--otel-endpoint``,
  ``--otel-service-name``, ``--otel-secure``): a request's SERVER span
  joins the router's trace through ``traceparent``; a no-op without
  OpenTelemetry.
- Anomaly diagnostics (engine/diagnostics.py; ``--no-diagnostics``,
  ``--diagnostics-*``): an unexpected recompile, a watchdog stall, a
  drain-deadline abort, device memory past ``--diagnostics-hbm-threshold``
  and a cost-model drift episode (``--costmodel-drift-band``) each capture
  a bundle (perf, lifecycle, flight recorder, scheduler and compile-event
  snapshots, the memory snapshot on the card, a short ``torch.profiler``
  trace). ``GET /debug/diagnostics`` indexes them, ``GET
  /debug/diagnostics/{id}`` downloads one as tar.gz, ``POST
  /debug/diagnostics/capture`` (the router's incident fan-out) captures one
  now; the ``vllm:diagnostic_*`` families count them.
- ``GET /debug/memory``: ``torch.cuda.memory._snapshot()`` pickled (the
  reference answers jax's pprof); 500 on a CPU engine.
- The durable perf ledger (perf_ledger.py; ``--perf-ledger-path``,
  ``--perf-ledger-max-bytes``, ``--perf-ledger-interval``): a thread
  journals the accountant's marks every interval and once at drain, in the
  reference's record schema; ``/debug/perf`` shows its health.
- ``--config file.yaml`` (yaml_args.py) sets flags from a file; explicit
  flags win. Two keys have no flag, as the reference's server has none:
  ``chain_decode`` (default false) and ``decode_graphs`` (default true,
  on a CUDA device).

Tensor parallelism (``--tensor-parallel-size``, the reference's flag and
default -1: every visible card on ``cuda``, 1 on the CPU): the server is
rank 0 and starts one process a further rank (engine/multihost.py), each
on ``cuda:r`` over NCCL, or on the CPU over gloo with ``--device cpu``.
It serves completions, chat, messages, responses, scoring and sleep, on
both attention paths, with the prefix cache, sampling, guided decoding,
n-gram speculation, ``--quantization int8`` (W8A8 and W8A16), Mixtral's
MoE presets, multi-LoRA (``/v1/load_lora_adapter``: each rank holds
its share of every adapter) and the KV plane (``--role prefill|decode``,
``/kv/export``, ``/kv/recv``, the host and remote tiers: whole blocks,
every rank's heads joined on rank 0, grouped as the reference's pool is
at that size and named in ``X-KV-Head-Groups``), and Whisper's audio
routes (engine/whisper_server.py: heads, MLP and vocabulary cut, each
request's cross and self K/V held by every rank for its heads).
Pipeline parallelism (``--pipeline-parallel-size S``): one process, the
layers cut into S stages, stage s on ``cuda:s`` (or the CPU), each with
its own KV pool, the host relaying activations between them
(engine/pp_runner.py), on the bucketed path. As in the reference,
logprobs answer 400 and guided regex and JSON are refused; the rest of
the surface serves. With ``--tensor-parallel-size T`` above 1 as well the
server is rank 0 of S x T processes (the stage x tensor grid,
parallel/distributed.py), process g stage g // T and tensor rank g % T on
``cuda:g``: each holds its stage's layers cut to its tensor shard, each
stage's T processes are a tensor group, and the residual stream is
relayed stage to stage. Sequence parallelism
(``--sequence-parallel-size N``): the server is rank
0 of N seq ranks started as tensor ranks are, each holding the whole
model and a whole KV pool; a prompt of at least
``--ring-prefill-threshold`` tokens (default 4096) prefills whole by ring
attention over them (parallel/ring_attention.py), and everything else
runs as at size 1 on every rank. With ``--tensor-parallel-size T`` above
1 as well, of N x T processes, each seq rank T tensor ranks (the seq x
tensor grid, parallel/distributed.py): the ring runs over the seq ranks
of each tensor rank on its shard's heads. MoE models, ``--quantization
int8``, ``--role prefill|decode`` and the host and remote KV tiers serve
at any sequence-parallel size, alone and on the grid: a ring prefill
takes the int8 route and the MoE capacity of its whole padded prompt and
ranks MoE slots across the seq ranks, and the KV plane moves rank 0's
whole blocks (on the grid, seq rank 0's tensor shares joined). With
``--pipeline-parallel-size S`` above 1 as well the server is rank 0 of S
x N (x T) processes in which each seq rank is a whole pipeline: the ring
is off, as the reference's staged runner has no ``seq_parallel``, and
``--ring-prefill-threshold`` has no effect. Every mesh of these flags is
one process grid (parallel/distributed.py ``Grid``). Whisper beyond
tensor ranks exits at start, a later slice. ``--data-parallel-size``
parses to the reference's default; above 1 it exits at start, not
ported.

Multi-host serving (the reference's flags and their environment defaults:
``--distributed-coordinator`` / ``PSTPU_COORDINATOR``, ``--num-processes``
/ ``PSTPU_NUM_PROCESSES``, ``--process-id`` / ``PSTPU_PROCESS_ID``,
``--control-port`` / ``PSTPU_CONTROL_PORT``): every rank is a process
started on its own with the same flags, one a rank, so ``--num-processes``
must equal the tensor size times the sequence size (``-1`` tensor size:
the processes over the seq ranks). Process 0 serves HTTP and leads: it
waits on the control port for the others, then mirrors every runner call,
warmup included, over the authenticated step-plan channel
(engine/multihost.py). Every other process serves ``/health`` as
``{"status": "follower", "process_id": i}`` (404 elsewhere), builds its
runner shard in the leader's order, replays the calls until the channel
closes, and exits 0. Nothing starts without ``PSTPU_CONTROL_SECRET``,
checked before anything touches the card; the host and remote KV tiers,
pipeline stages and Whisper exit at start, as in the reference.

Response bodies have the JAX server's shape, so the same router can front
either engine.

Run: ``python -m production_stack_tpu_torch.engine.server --model
llama-3-8b --port 18077`` (``--device cpu`` for the plain path,
``--attention-impl bucketed`` for the bucketed prefill path,
``--speculative-ngram 4`` for n-gram speculative decoding on the ragged
path, ``--skip-warmup`` to serve at once).
"""

from __future__ import annotations

import argparse
import dataclasses
import http.client
import io
import json
import logging
import os
import signal
import socket
import tarfile
import tempfile
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from production_stack_tpu_torch import __version__, perf_ledger
from production_stack_tpu_torch.canary_golden import (
    DEFAULT_PROBES,
    record_from_response,
)
from production_stack_tpu_torch.engine.async_engine import (
    AsyncEngine,
    DeadlineExceeded,
)
from production_stack_tpu_torch.engine import tracing as etracing
from production_stack_tpu_torch.engine.config import (
    CacheConfig,
    EngineConfig,
    PerfConfig,
    SchedulerConfig,
)
from production_stack_tpu_torch.engine.diagnostics import (
    DiagnosticsConfig,
    DiagnosticsManager,
)
from production_stack_tpu_torch.engine.engine import GrammarBankFull, LLMEngine
from production_stack_tpu_torch.engine.grammar import (
    compile_regex,
    schema_to_regex,
)
from production_stack_tpu_torch.engine.kv_transfer import (
    HEAD_GROUPS_HEADER,
    FrameDigestError,
    consume_frames,
    default_group,
    head_groups_of,
    nbytes_of,
    produce_frames,
    push_kv,
    read_frame,
    tensor_bytes,
)
from production_stack_tpu_torch.engine.lifecycle import StepWatchdog
from production_stack_tpu_torch.engine.lora import LoraManager
from production_stack_tpu_torch.engine.metrics import CONTENT_TYPE, ServerMetrics
from production_stack_tpu_torch.engine.multihost import (
    RankLost,
    check_group,
    control_secret,
    follow_leader,
    process_device,
)
from production_stack_tpu_torch.engine.multihost import refusal as tp_refusal
from production_stack_tpu_torch.engine.overload import (
    SHED_MAX_TOKENS,
    SHED_PREFETCH,
    SHED_SPEC,
    SHED_TENANT,
    BrownoutConfig,
    BrownoutController,
    PressureSignals,
    overweight_tenants,
)
from production_stack_tpu_torch.engine.sampling import (
    MAX_LOGPROBS,
    SamplingParams,
    make_token_controls,
)
from production_stack_tpu_torch.engine.scheduler import SchedulerQueueFull
from production_stack_tpu_torch.flight_recorder import FlightRecorder
from production_stack_tpu_torch.parallel import distributed as pdist
from production_stack_tpu_torch.parallel.distributed import DistributedConfig
from production_stack_tpu_torch.parallel.mesh import (
    AXIS_SEQ,
    AXIS_STAGE,
    AXIS_TENSOR,
    MeshConfig,
    stage_devices as pstage_devices,
    tensor_size,
)
from production_stack_tpu_torch.tenancy import UsageLedger, resolve_tenant
from production_stack_tpu_torch.testing import faults
from production_stack_tpu_torch.yaml_args import parse_with_yaml_config

_log = logging.getLogger(__name__)

MAX_CHOICES = 128  # OpenAI caps n at 128; batched prompts share the cap
# echo + logprobs scores the prompt with a dense teacher-forced pass
MAX_ECHO_SCORE_TOKENS = 2048
MAX_GUIDED_CHOICES = 64
# how long a diagnostic capture waits for a step to end before it skips
# what needs the engine between steps (the memory snapshot, a trace's
# start) and records why in the bundle: a wedged step is what a watchdog
# stall bundle is captured for
ENGINE_WAIT_SECONDS = 5.0
# the endpoint families this engine serves, on its /v1/models card: the
# router sends a path only to engines that advertise its capability
ENGINE_CAPABILITIES = (
    "chat", "completions", "responses", "messages", "embeddings",
    "score", "rerank", "pooling", "tokenize",
)


class BadRequest(ValueError):
    """A request the server answers with 400."""


def _parse_deadline(headers) -> Optional[float]:
    """The absolute epoch-seconds deadline of the router's
    ``x-request-deadline`` header; None when absent or malformed (a
    malformed deadline degrades to no deadline, never to a 400: only the
    router sets this header)."""
    hdr = headers.get("x-request-deadline")
    if not hdr:
        return None
    try:
        return float(hdr)
    except ValueError:
        return None


def _parse_logit_bias(raw) -> Optional[dict]:
    if not raw:
        return None
    if not isinstance(raw, dict):
        raise ValueError("logit_bias must be a map of token id -> bias")
    return {int(k): float(v) for k, v in raw.items()}


def _sampling_from_body(body: dict) -> SamplingParams:
    stop = body.get("stop") or ()
    if isinstance(stop, str):
        stop = (stop,)
    seed = body.get("seed")
    if seed is not None:
        seed = int(seed) & 0xFFFFFFFF  # seeds are uint32
    n = body.get("n")
    return SamplingParams(
        max_tokens=int(body.get("max_tokens") or 16),
        temperature=float(body.get("temperature", 1.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", -1)),
        seed=seed,
        stop=tuple(stop),
        stop_token_ids=tuple(body.get("stop_token_ids") or ()),
        ignore_eos=bool(body.get("ignore_eos", False)),
        n=int(n) if n is not None else 1,
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        logit_bias=_parse_logit_bias(body.get("logit_bias")),
        allowed_token_ids=tuple(body.get("allowed_token_ids") or ()),
    )


def _parse_logprobs(body: dict, chat: bool) -> Optional[int]:
    """OpenAI logprobs knobs -> the engine's top-N count, or None.
    chat: ``logprobs: true`` (+ ``top_logprobs``); completions:
    ``logprobs: <int>``."""
    if chat:
        if not body.get("logprobs"):
            return None
        top = body.get("top_logprobs")
        top = int(top) if top is not None else 0
        if not 0 <= top <= MAX_LOGPROBS:
            raise ValueError(f"top_logprobs must be in [0, {MAX_LOGPROBS}]")
        return top
    raw = body.get("logprobs")
    if raw is None or raw is False:
        return None
    if raw is True:
        raise ValueError(
            "completions logprobs must be an integer count; the boolean "
            "form belongs to /v1/chat/completions"
        )
    n = int(raw)
    if not 0 <= n <= MAX_LOGPROBS:
        raise ValueError(f"logprobs must be in [0, {MAX_LOGPROBS}]")
    return n


def _fmt_chat_logprobs(tk, token_ids: list, lps: list, n_top: int) -> dict:
    content = []
    for t, (lp, top) in zip(token_ids, lps):
        s = tk.decode([t])
        content.append({
            "token": s, "logprob": lp, "bytes": list(s.encode()),
            "top_logprobs": [
                {"token": tk.decode([tid]), "logprob": v,
                 "bytes": list(tk.decode([tid]).encode())}
                for tid, v in top[:n_top]
            ],
        })
    return {"content": content}


def _fmt_completion_logprobs(tk, token_ids: list, lps: list, n_top: int,
                             offset0: int = 0) -> dict:
    tokens, tlps, tops, offsets = [], [], [], []
    off = offset0
    for t, (lp, top) in zip(token_ids, lps):
        s = tk.decode([t])
        tokens.append(s)
        tlps.append(lp)
        offsets.append(off)
        off += len(s)
        if n_top and top:
            d: dict = {}
            for tid, v in top[:n_top]:
                d.setdefault(tk.decode([tid]), v)
            tops.append(d)
        else:
            tops.append(None)
    return {"tokens": tokens, "token_logprobs": tlps, "top_logprobs": tops,
            "text_offset": offsets}


def _tokens_covering(tk, token_ids: list, text_len: int) -> int:
    """Smallest token prefix whose decode covers ``text_len`` chars."""
    if text_len <= 0 or not token_ids:
        return 0
    if len(tk.decode(token_ids)) < text_len:
        return len(token_ids)
    lo, hi = 1, len(token_ids)
    while lo < hi:
        mid = (lo + hi) // 2
        if len(tk.decode(token_ids[:mid])) >= text_len:
            hi = mid
        else:
            lo = mid + 1
    return lo


def _check_stop_str(text: str, sampling: SamplingParams) -> Optional[str]:
    """The text cut at the earliest stop string, or None."""
    cut = None
    for s in sampling.stop:
        idx = text.find(s)
        if idx >= 0 and (cut is None or idx < cut):
            cut = idx
    return None if cut is None else text[:cut]


def _error(message: str, kind: Optional[str] = "invalid_request_error"
           ) -> dict:
    """An error body; ``kind`` None leaves out ``type``, as the
    reference's scoring, messages and sleep routes do."""
    if kind is None:
        return {"error": {"message": message}}
    return {"error": {"message": message, "type": kind}}


def _sse_event(name: str, payload: dict) -> bytes:
    """One named server-sent event (the messages and responses streams)."""
    return f"event: {name}\ndata: {json.dumps(payload)}\n\n".encode()


class _ChunkedReader:
    """``readinto`` over an HTTP/1.1 chunked request body (the stdlib
    handler does not decode one): a pushed KV transfer arrives so."""

    def __init__(self, rfile):
        self.rfile = rfile
        self.left = 0  # bytes left in the current chunk
        self.done = False

    def readinto(self, buf) -> int:
        if self.done:
            return 0
        if self.left == 0:
            line = self.rfile.readline(1024)
            if not line:
                raise EOFError("connection closed inside a chunked body")
            self.left = int(line.split(b";")[0].strip() or b"0", 16)
            if self.left == 0:
                while self.rfile.readline(1024) not in (b"\r\n", b"\n",
                                                        b""):
                    pass  # trailers
                self.done = True
                return 0
        n = self.rfile.readinto(memoryview(buf)[:min(len(buf), self.left)])
        if not n:
            raise EOFError("connection closed inside a chunked body")
        self.left -= n
        if self.left == 0:
            self.rfile.readline(1024)  # the chunk's CRLF
        return n

    def drain(self) -> None:
        """Read to the end of the body, so an early answer reaches a
        sender that is still writing."""
        scratch = bytearray(1 << 20)
        while self.readinto(scratch):
            pass


class _LengthReader:
    """``readinto`` over a Content-Length request body."""

    def __init__(self, rfile, length: int):
        self.rfile = rfile
        self.left = length

    def readinto(self, buf) -> int:
        if self.left <= 0:
            return 0
        n = self.rfile.readinto(memoryview(buf)[:min(len(buf), self.left)])
        self.left -= n or 0
        return n

    def drain(self) -> None:
        scratch = bytearray(1 << 20)
        while self.readinto(scratch):
            pass


@dataclasses.dataclass
class _Admission:
    """An admitted generation request: its choices' streams, and what its
    ``kv_transfer_params`` asked of the KV plane."""

    streams: list
    rids: list
    rid: str
    sampling: SamplingParams
    n_prompt: int
    prompt_ids: list
    produce_kv: bool = False  # answer with remote_block_ids
    push: Optional[dict] = None  # push_url + transfer_id: blocks pinned
    imported_tokens: int = 0  # tokens a pull landed before admission
    # echo: each prompt's ids, and its logprob entries under ``logprobs``
    echo_ids: Optional[list] = None
    echo_lps: Optional[list] = None


class _HTTPServer(ThreadingHTTPServer):
    # socketserver's default backlog of 5 resets connections when a burst
    # (a router fanning out a wave, a client opening one connection per
    # row) arrives faster than the accept loop runs
    request_queue_size = 1024
    daemon_threads = True


class EngineServer:
    """The engine, its thread and the HTTP front end.

    Lifecycle, as the reference's: WARMING (``warmup_on_start``: the
    engine runs its warmup on the engine thread while ``/ready`` answers
    503) -> SERVING -> DRAINING (``POST /drain`` or SIGTERM: ``/ready``
    503, new generation requests 503 + ``Retry-After``, in-flight requests
    finish under ``drain_deadline``, stragglers are then aborted). A step
    watchdog (``watchdog_stall_seconds`` > 0) turns ``/ready`` to 503
    while no step completes with work queued."""

    def __init__(self, config: EngineConfig, engine: Optional[LLMEngine] = None,
                 device="cuda", served_model_name: Optional[str] = None,
                 warmup_on_start: bool = False,
                 overload_retry_after: float = 1.0,
                 drain_deadline: float = 30.0,
                 watchdog_stall_seconds: float = 0.0,
                 fault_injection: Optional[str] = None,
                 brownout: Optional[BrownoutController] = None,
                 otel_endpoint: Optional[str] = None,
                 otel_service_name: str = "tpu-engine",
                 otel_secure: bool = False,
                 flight_recorder_size: int = 256,
                 diagnostics: Optional[DiagnosticsConfig] = None,
                 rank_devices: Optional[list] = None,
                 backend: Optional[str] = None,
                 stage_devices: Optional[list] = None,
                 distributed: Optional[DistributedConfig] = None):
        self.config = config
        self.engine = engine if engine is not None else LLMEngine(
            config, device=device, rank_devices=rank_devices,
            backend=backend, stage_devices=stage_devices,
            distributed=distributed)
        self.async_engine = AsyncEngine(self.engine)
        self.lora = LoraManager(self.engine)
        self.model_name = served_model_name or config.model.name
        self.start_time = time.time()
        self._httpd: Optional[_HTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None
        self.metrics = ServerMetrics(self.engine, self.model_name)
        self.async_engine.step_observer = self.metrics.observe_step
        self.async_engine.finish_observer = self._observe_finished
        etracing.initialize_tracing(otel_endpoint, otel_service_name,
                                    otel_secure)
        # per-request timelines (GET /debug/requests): a request's open
        # record, by its request id, until its handler finishes it; the
        # engine thread merges each choice's stamps in under the lock
        self.flight_recorder = FlightRecorder(flight_recorder_size)
        self._flights: dict[str, dict] = {}
        self._flight_lock = threading.Lock()
        # the Retry-After seconds of a 503 while draining, and the floor of
        # a 429's (scheduler.retry_after_hint scales it with the queue)
        self.overload_retry_after = overload_retry_after
        # set by shutdown(): ends the brownout thread and releases requests
        # an injected fault holds
        self._stop = threading.Event()
        # fault injection is opt-in: unarmed (None) the server has no
        # injectable surface at all, "" arms /debug/faults with no fault
        self._faults_armed = fault_injection is not None
        self.faults = faults.FaultState(
            faults.FaultSpec.parse(fault_injection) if fault_injection
            else None)
        if self.faults.spec is not None:
            _log.warning("FAULT INJECTION ACTIVE: %s", self.faults.spec)
        # staged brownout (engine/overload.py): None = off (the default)
        self.brownout = brownout
        self._brownout_thread: Optional[threading.Thread] = None
        # stage-3 shed set, recomputed each evaluation from the
        # scheduler's per-tenant load; admission checks membership
        self._brownout_shed: frozenset = frozenset()
        self._shed_counts_seen = {SHED_SPEC: 0, SHED_PREFETCH: 0}
        self._shed_lock = threading.Lock()
        # the usage ledger: a JSONL record per finished request, when
        # metering is on and a path is set; request id -> (model, client
        # request id) of the requests it will record
        self.usage_ledger = None
        if config.tenant_metering and config.tenant_ledger_path:
            self.usage_ledger = UsageLedger(
                config.tenant_ledger_path,
                max_bytes=config.tenant_ledger_max_bytes)
        self._ledger_meta: dict[str, tuple] = {}
        # the durable perf ledger (perf_ledger.py): fingerprint-stamped
        # accountant snapshots journaled every perf_ledger_interval seconds
        # by a thread of its own and once at begin_drain; off unless a path
        # is set and the accountant exists. Read-only over stats().
        self.perf_ledger = None
        self._perf_fp: Optional[dict] = None
        self._perf_ledger_thread: Optional[threading.Thread] = None
        if config.perf_ledger_path and self.engine.perf is not None:
            self.perf_ledger = perf_ledger.PerfLedger(
                config.perf_ledger_path,
                max_bytes=config.perf_ledger_max_bytes)
        self.warmup_on_start = warmup_on_start
        self.warming = False
        self.warmup_seconds = 0.0
        self._warmup_t0: Optional[float] = None
        self.drain_deadline = drain_deadline
        self.draining = False
        self.drain_reason: Optional[str] = None
        self._drain_t0: Optional[float] = None
        self._drain_done = threading.Event()
        self._drain_rejected = 0
        self._drain_aborted = 0
        # generation requests past the drain gate and not yet answered
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._profiling = threading.Lock()
        # seconds of the last trace's engine-held start and stop, its
        # sleep and export; of the profiler's warm-up at bind
        self.last_trace: dict = {}
        self.profiler_warmup_seconds: Optional[float] = None
        self.watchdog = StepWatchdog(self.async_engine,
                                     watchdog_stall_seconds)
        self.metrics.register_lifecycle(self._lifecycle_snapshot)
        self.metrics.register_overload(self._overload_snapshot)
        # pushed transfers landing or landed on this (decode) engine, by
        # transfer id: {blocks, layers_done, meta, created, ready}
        self._kv_transfers: dict[str, dict] = {}
        self._kv_lock = threading.Lock()
        # anomaly-triggered diagnostic bundles (engine/diagnostics.py): an
        # unexpected recompile, a watchdog stall, a drain-deadline abort,
        # device-memory pressure and a cost-model drift episode each
        # capture the evidence into GET /debug/diagnostics, on the
        # manager's own thread; the signal's thread only pays for
        # trigger(). The memory snapshot exists only on the card.
        collectors = {
            "perf.json": self._collect_perf,
            "lifecycle.json": self._lifecycle_snapshot,
            "flight_recorder.json": self._collect_flight_recorder,
            "scheduler.json": self._collect_scheduler,
            "compile_events.json": self._collect_compile_tail,
        }
        if self.engine.device.type == "cuda":
            collectors["memory.pickle"] = self._collect_device_memory
        self.diagnostics = DiagnosticsManager(
            diagnostics if diagnostics is not None else DiagnosticsConfig(),
            tier="engine", collectors=collectors,
            profile_fn=self._diag_profile)
        if self.diagnostics.config.enabled:
            perf = self.engine.perf
            if perf is not None:
                perf.anomaly_hook = self.diagnostics.trigger
                perf.hbm_threshold = self.diagnostics.config.hbm_threshold
            self.watchdog.on_stall = (
                lambda d: self.diagnostics.trigger("watchdog_stall", d))
            # recovery is a fact worth indexing, not a second bundle: the
            # stall's capture already holds the evidence
            self.watchdog.on_recover = (
                lambda d: self.diagnostics.note("watchdog_recovered", d))
            self.metrics.register_diagnostics(self.diagnostics.stats)

    def _observe_finished(self, out) -> None:
        """Engine thread: a finished choice's stamps into the latency
        histograms and its request's flight record, and its usage record
        into the ledger. The async engine calls this before it delivers
        the output, so a record is whole when its handler finishes it."""
        if out.arrival_time is None or out.finish_time is None:
            return  # an abort delivered to a waiting stream carries none
        self.metrics.observe_request(out.arrival_time, out.first_token_time,
                                     out.finish_time, out.num_output_tokens)
        self.metrics.observe_stages(out)
        self._merge_flight(out)
        if self.usage_ledger is not None:
            self._ledger_record(out)

    def _merge_flight(self, out) -> None:
        """Merge a finished choice's lifecycle stamps into its request's
        open flight record (min across choices for admission and first
        token, max for the last token) and add its token counts. A choice
        of an n > 1 or batched request is ``<request id>-<index>``."""
        rid = out.request_id
        with self._flight_lock:
            rec = self._flights.get(rid)
            if rec is None:
                rec = self._flights.get(rid.rpartition("-")[0])
            if rec is None:
                return
            tl = rec["timeline"]
            for key, val, pick in (("admitted", out.admit_time, min),
                                   ("first_token", out.first_token_time, min),
                                   ("last_token", out.finish_time, max)):
                if val is not None:
                    tl[key] = val if key not in tl else pick(tl[key], val)
            rec["num_prompt_tokens"] += out.num_prompt_tokens
            rec["num_output_tokens"] += out.num_output_tokens

    def set_flight_outcome(self, rid: str, outcome: str) -> None:
        """Name the outcome of request ``rid``'s open flight record, where
        its status alone would not (a stream that committed 200)."""
        with self._flight_lock:
            rec = self._flights.get(rid)
            if rec is not None and rec.get("outcome") is None:
                rec["outcome"] = outcome

    @staticmethod
    def _finalize_span(span, rec: dict, status: int) -> None:
        """Stamp the stage durations (from the lifecycle stamps merged
        into the flight record) onto the engine's SERVER span."""
        if span is None:
            return
        tl = rec["timeline"]
        span.set_attribute("http.status_code", status)
        if "admitted" in tl:
            span.set_attribute("stage.queue_s", tl["admitted"] - tl["received"])
            span.add_event("admitted")
        if "first_token" in tl and "admitted" in tl:
            span.set_attribute("stage.prefill_s",
                               tl["first_token"] - tl["admitted"])
            span.add_event("first_token")
        if "last_token" in tl and "first_token" in tl:
            span.set_attribute("stage.decode_s",
                               tl["last_token"] - tl["first_token"])
        span.set_attribute("tokens.prompt", rec["num_prompt_tokens"])
        span.set_attribute("tokens.output", rec["num_output_tokens"])

    def _ledger_record(self, out) -> None:
        model, client_rid = self._ledger_meta.pop(
            out.request_id, (self.model_name, None))
        stamps = {}
        if out.admit_time is not None and out.arrival_time is not None:
            stamps["queue_s"] = round(out.admit_time - out.arrival_time, 6)
        if out.first_token_time is not None and out.admit_time is not None:
            stamps["prefill_s"] = round(
                out.first_token_time - out.admit_time, 6)
        if out.finish_time is not None and out.first_token_time is not None:
            stamps["decode_s"] = round(
                out.finish_time - out.first_token_time, 6)
        self.usage_ledger.append({
            "ts": time.time(),
            "tenant": out.tenant,
            "model": model,
            "request_id": out.request_id,
            "client_request_id": client_rid,
            "prompt_tokens": out.num_prompt_tokens,
            "output_tokens": out.num_output_tokens,
            "cached_tokens": out.num_cached_tokens,
            "chip_seconds": round(out.chip_seconds, 9),
            "finish_reason": out.finish_reason,
            **stamps,
        })

    # -- lifecycle -----------------------------------------------------------
    def bind(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start the engine thread (and the warmup, when asked for) and
        bind the HTTP socket; returns the bound port (a free one for port
        0). ``/ready`` answers 503 ``warming`` from here until the warmup
        ends."""
        if (self.diagnostics.config.enabled
                and self.diagnostics.config.profile_seconds > 0):
            self._warm_profiler()
        self.async_engine.start()
        self.watchdog.start()
        if self.perf_ledger is not None:
            self._perf_ledger_thread = threading.Thread(
                target=self._perf_ledger_loop, daemon=True,
                name="perf-ledger")
            self._perf_ledger_thread.start()
        if self.brownout is not None and self.brownout.config.enabled:
            self._brownout_thread = threading.Thread(
                target=self._brownout_loop, daemon=True, name="brownout")
            self._brownout_thread.start()
        if self.warmup_on_start:
            self.warming = True
            self._warmup_t0 = time.monotonic()
            threading.Thread(target=self._run_warmup, daemon=True,
                             name="warmup").start()
        self._httpd = _HTTPServer((host, port), self._handler_class())
        return self._httpd.server_address[1]

    def _run_warmup(self) -> None:
        assert self._warmup_t0 is not None
        try:
            self.async_engine.run_on_engine(lambda eng: eng.warmup())
        except Exception:
            _log.exception("engine warmup failed")
        finally:
            self.warmup_seconds = time.monotonic() - self._warmup_t0
            self.warming = False
        _log.info("engine warmup (all shape variants) done in %.1fs",
                  self.warmup_seconds)

    def begin_drain(self, reason: str) -> bool:
        """Flip SERVING -> DRAINING (idempotent; False when already
        draining) and start the drain watcher."""
        if self.draining:
            return False
        self.draining = True
        self.drain_reason = reason
        self._drain_t0 = time.monotonic()
        try:
            # a last journal entry while the window still holds the run's
            # steady state
            self._journal_perf("drain")
        except Exception:
            _log.exception("perf ledger drain journal failed")
        _log.warning("drain started (%s): %d in-flight request(s), "
                     "deadline %.1fs", reason, self._inflight,
                     self.drain_deadline)
        threading.Thread(target=self._drain_watch, daemon=True,
                         name="drain").start()
        return True

    def _drain_watch(self) -> None:
        """Let in-flight work finish under the drain deadline, then abort
        the stragglers (their KV blocks are freed)."""
        assert self._drain_t0 is not None
        deadline = self._drain_t0 + self.drain_deadline
        try:
            while time.monotonic() < deadline:
                if not self._inflight and not self.engine.has_unfinished():
                    _log.warning("drain complete in %.2fs: no in-flight "
                                 "work", time.monotonic() - self._drain_t0)
                    return
                time.sleep(0.05)
            rids = self.engine.live_request_ids()
            for rid in rids:
                self.async_engine.abort(rid)
            self._drain_aborted += len(rids)
            if rids:
                _log.warning("drain deadline (%.1fs) expired: aborted %d "
                             "straggler sequence(s)", self.drain_deadline,
                             len(rids))
                self.diagnostics.trigger("drain_deadline_abort", {
                    "aborted": len(rids),
                    "deadline_seconds": self.drain_deadline,
                    "reason": self.drain_reason,
                })
        finally:
            self._drain_done.set()

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Block until a started drain has finished or aborted its
        in-flight work."""
        return self._drain_done.wait(timeout)

    def _lifecycle_snapshot(self) -> dict:
        """Scrape-time source of the drain / watchdog / warmup families."""
        return {
            "draining": self.draining,
            "drain_rejected_total": self._drain_rejected,
            "drain_aborted_total": self._drain_aborted,
            "watchdog_stalled": self.watchdog.stalled,
            "watchdog_stalls_total": self.watchdog.stalls_total,
            "warming": self.warming,
            "warmup_seconds": self.warmup_seconds,
        }

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve on a background thread; returns the bound port."""
        bound = self.bind(host, port)
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="http")
        self._serve_thread.start()
        return bound

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def stop_serving(self) -> None:
        """End ``serve_forever`` (from any thread but the one running
        it)."""
        if self._httpd is not None:
            self._httpd.shutdown()

    def shutdown(self) -> None:
        self._stop.set()
        for thread in (self._brownout_thread, self._perf_ledger_thread):
            if thread is not None:
                thread.join(10)
        self._brownout_thread = self._perf_ledger_thread = None
        if self._httpd is not None:
            if self._serve_thread is not None:
                self._httpd.shutdown()
                self._serve_thread.join(10)
                self._serve_thread = None
            self._httpd.server_close()
            self._httpd = None
        self.watchdog.stop()
        # a trace in flight started on the engine thread and must stop there
        with self._profiling:
            self.async_engine.stop()
        self.engine.close()

    # -- the durable perf ledger (perf_ledger.py) ------------------------------
    def _perf_ledger_loop(self) -> None:
        """Journal the accountant's windowed marks every
        ``perf_ledger_interval`` seconds (at least 0.5) until shutdown.
        Read-only over ``engine.stats()``, as a scrape is: the serving path
        never waits on ledger IO, and IO errors are counted, never
        raised."""
        interval = max(float(self.config.perf_ledger_interval), 0.5)
        while not self._stop.wait(interval):
            try:
                self._journal_perf("interval")
            except Exception:
                _log.exception("perf ledger journal failed")

    def _perf_fingerprint(self) -> dict:
        """The config cohort stamp of every ledger record (computed once).
        The port leaves ``jax_version`` empty and names its framework and
        torch's version in the extra fields, so its cohorts never mix with
        the JAX engine's."""
        if self._perf_fp is not None:
            return self._perf_fp
        import torch

        cfg = self.config
        dev = self.engine.device
        chip = ""
        if dev.type == "cuda":
            chip = torch.cuda.get_device_name(dev)
        perf = self.engine.perf
        self._perf_fp = perf_ledger.fingerprint(
            model=cfg.model.name, role=cfg.role,
            tensor_parallel=getattr(perf, "tp", 1),
            attention_impl=self.engine.attention_impl,
            dtype=cfg.model.dtype, quantization=cfg.model.quant or "",
            speculative=bool(cfg.scheduler.spec_ngram_k),
            n_chips=getattr(perf, "n_chips", 1),
            platform="gpu" if dev.type == "cuda" else "cpu", chip=chip,
            extra={"framework": "torch",
                   "torch_version": str(torch.__version__)})
        return self._perf_fp

    def _journal_perf(self, reason: str) -> bool:
        if self.perf_ledger is None:
            return False
        marks = perf_ledger.marks_from_engine_stats(self.engine.stats())
        return self.perf_ledger.append_engine_snapshot(
            time.time(), self._perf_fingerprint(), marks, reason=reason)

    # -- overload (engine/overload.py) ---------------------------------------
    def retry_after(self) -> str:
        """A 429's Retry-After: the scheduler's queue depth over its drain
        rate, with ``overload_retry_after`` as the floor."""
        hint = self.engine.scheduler.retry_after_hint(
            floor=self.overload_retry_after)
        return f"{hint:g}"

    def _record_shed(self, reason: str, n: int = 1) -> None:
        with self._shed_lock:
            self.brownout.record_shed(reason, n)

    def _brownout_loop(self) -> None:
        """Evaluate the pressure every ``interval`` seconds: read the
        signals on the engine thread (the scheduler and the accountant are
        its state), step the controller, then apply the stage's actions on
        the engine thread. It never calls into the runner, skips its turn
        while the engine sleeps, and ends on shutdown()."""
        ctl = self.brownout
        while not self._stop.wait(ctl.config.interval):
            if self.async_engine.is_sleeping:
                continue
            try:
                sig = self.async_engine.run_on_engine(self._pressure_signals)
                prev = ctl.stage
                ctl.evaluate(sig, time.monotonic())
                if ctl.stage != prev:
                    _log.warning("brownout stage %d -> %d (%s)", prev,
                                 ctl.stage,
                                 ",".join(ctl.last_reasons) or "recovered")
                self.async_engine.run_on_engine(self._apply_brownout)
            except Exception:
                if self._stop.is_set():
                    return
                _log.exception("brownout evaluation failed")

    def _pressure_signals(self, eng) -> PressureSignals:
        """One evaluation's signals (engine thread): the waiting queue's
        fill of ``max_queue_len``, device memory in use, the watchdog."""
        sched = eng.scheduler
        qcap = max(1, int(sched.config.max_queue_len or 0))
        hbm_frac = 0.0
        if eng.perf is not None:
            hbm = eng.perf._hbm
            if hbm.get("total"):
                hbm_frac = hbm.get("used", 0) / hbm["total"]
        return PressureSignals(queue_fraction=len(sched.waiting) / qcap,
                               hbm_fraction=hbm_frac,
                               watchdog_stalled=self.watchdog.stalled)

    def _apply_brownout(self, eng) -> None:
        """Push the stage's actions onto engine state (engine thread) and
        fold the engine's shed tallies into the controller's counts."""
        ctl = self.brownout
        sched = eng.scheduler
        sched.spec_shed = ctl.shed_spec
        eng.prefetch_paused = ctl.pause_prefetch
        for reason, total in ((SHED_SPEC, sched.spec_shed_count),
                              (SHED_PREFETCH, eng.prefetch_shed_count)):
            delta = total - self._shed_counts_seen[reason]
            if delta > 0:
                self._record_shed(reason, delta)
                self._shed_counts_seen[reason] = total
        if ctl.shed_overweight:
            self._brownout_shed = frozenset(overweight_tenants(
                sched.tenant_loads(), sched.config.tenant_weights))
        elif self._brownout_shed:
            self._brownout_shed = frozenset()

    def _overload_snapshot(self) -> dict:
        """The source of the vllm:brownout_* / vllm:fair_share_deficit
        families and of /debug/overload."""
        ctl = self.brownout
        with self._shed_lock:
            brownout = (ctl.snapshot() if ctl is not None
                        else {"enabled": False, "stage": 0, "sheds": {}})
        return {
            "brownout": brownout,
            "shed_tenants": sorted(self._brownout_shed),
            "fair_share": self.engine.scheduler.fair_share_snapshot(),
        }

    def debug_overload(self) -> tuple[int, dict]:
        return 200, self._overload_snapshot()

    def debug_tenants(self) -> tuple[int, dict]:
        """The attribution snapshot folded to the top K (+ "other"), with
        the ledger's health: what /debug/fleet and stacktop read."""
        block = dict(self.engine.tenant_stats())
        block["model"] = self.model_name
        if self.usage_ledger is not None:
            block["ledger"] = self.usage_ledger.stats()
        return 200, block

    def debug_faults(self, query: list) -> tuple[int, dict]:
        """Flip fault injection on a live engine: the query's pairs are a
        --fault-injection spec (``?error_rate=0.5&seed=7``); ``?off=1``
        clears. /debug/* is outside the faulted /v1/* surface."""
        try:
            q = dict(query)
            off = q.get("off")
            if off is not None:
                if off.lower() not in ("1", "true"):
                    raise ValueError("off must be 1 or true")
                self.faults.set(None)
            else:
                self.faults.set(faults.FaultSpec.parse(
                    ",".join(f"{k}={v}" for k, v in query)))
        except (TypeError, ValueError) as e:
            return 400, {"error": {"message": str(e)}}
        spec = self.faults.spec
        body = {"active": spec is not None}
        if spec is not None:
            body.update(error_rate=spec.error_rate,
                        latency_ms=spec.latency_ms,
                        drop_rate=spec.drop_rate, stall_ms=spec.stall_ms,
                        stream_abort_rate=spec.stream_abort_rate,
                        stream_abort_after_ms=spec.stream_abort_after_ms,
                        hang_after_ms=spec.hang_after_ms)
        return 200, body

    # -- routes --------------------------------------------------------------
    def models(self) -> dict:
        cards = [{
            "id": self.model_name,
            "object": "model",
            "created": int(self.start_time),
            "owned_by": "production-stack-tpu",
            "root": self.model_name,
            "parent": None,
            "max_model_len": self.config.model.max_model_len,
            "capabilities": list(ENGINE_CAPABILITIES),
            "role": self.config.role,
        }]
        for name in self.lora.list_adapters():
            cards.append({
                "id": name,
                "object": "model",
                "created": int(self.start_time),
                "owned_by": "production-stack-tpu",
                "root": self.model_name,
                "parent": self.model_name,
            })
        return {"object": "list", "data": cards}

    def ready(self) -> tuple[int, dict]:
        """Readiness, distinct from /health liveness: 503 while DRAINING,
        while the launch warmup runs, and while the step watchdog sees a
        wedged engine."""
        if self.draining:
            remaining = 0.0
            if self._drain_t0 is not None:
                remaining = max(0.0, self._drain_t0 + self.drain_deadline
                                - time.monotonic())
            return 503, {"status": "draining", "reason": self.drain_reason,
                         "inflight": self._inflight,
                         "deadline_remaining": round(remaining, 3)}
        if self.warming:
            elapsed = 0.0
            if self._warmup_t0 is not None:
                elapsed = time.monotonic() - self._warmup_t0
            return 503, {"status": "warming",
                         "warming_for": round(elapsed, 3)}
        if self.watchdog.stalled:
            return 503, {"status": "stalled",
                         "stalled_for": round(self.watchdog.progress_age(),
                                              3)}
        return 200, {"status": "ready"}

    def drain(self, body: dict) -> tuple[int, dict]:
        """Begin draining (idempotent). A preStop hook POSTs here so new
        work stops before SIGTERM; the SIGTERM path owns process exit."""
        started = self.begin_drain("api")
        return 200, {"status": "draining", "already_draining": not started,
                     "deadline": self.drain_deadline,
                     "inflight": self._inflight}

    def tokenize(self, body: dict) -> tuple[int, dict]:
        text = body.get("prompt") or body.get("text") or ""
        ids = self.engine.tokenizer.encode(
            text, add_bos=bool(body.get("add_special_tokens", True)))
        return 200, {"tokens": ids, "count": len(ids),
                     "max_model_len": self.config.model.max_model_len}

    def detokenize(self, body: dict) -> tuple[int, dict]:
        return 200, {"prompt": self.engine.tokenizer.decode(
            body.get("tokens") or [])}

    def kv_lookup(self, body: dict) -> tuple[int, dict]:
        """KV-aware routing: how many tokens of this prompt would hit the
        prefix cache now, from the allocator's content-hash table, and,
        with a host tier, how many more it could continue the match with
        (``matched_tokens_host``; a router weights those below a pool hit
        and far above a prefill).

        The walk starts at the base model's chain root (``HASH_SEED``):
        the router sends only ``{"prompt"}`` (or ``{"tokens"}``), never an
        adapter. This port roots each LoRA adapter's chain at its own
        ``kv_cache.adapter_root``, so blocks computed under an adapter are
        invisible here, by design: they could never serve a base-model
        request."""
        if "tokens" in body:
            ids = list(body["tokens"])
        else:
            ids = self.engine.tokenizer.encode(body.get("prompt") or "")
        _, matched = self.engine.scheduler.allocator.match_prefix(ids)
        out = {"matched_tokens": matched, "total_tokens": len(ids)}
        host_kv = self.engine.host_kv
        if host_kv is not None:
            bs = self.config.cache.block_size
            out["matched_tokens_host"] = bs * host_kv.probe_extension(
                ids, matched // bs)
        return 200, out

    def debug_perf(self) -> tuple[int, dict]:
        """The perf accountant's snapshot (engine/perf_accounting.py):
        windowed MFU and HBM-bandwidth utilization, phase throughput,
        device memory, the compile-event log and the cost model, with the
        speculative-decoding picture."""
        perf = self.engine.perf
        with self._kv_lock:
            pending = {tid: list(st["blocks"])
                       for tid, st in self._kv_transfers.items()}
        kv_block = {"role": self.config.role,
                    "pending_transfers": len(pending),
                    # each landed push's pool blocks, until it is attached
                    "pending_blocks": pending,
                    "transfers": self.metrics.transfer_snapshot(),
                    "head_groups": self.engine.runner.kv_head_groups,
                    "refused": dict(self.metrics.transfer_refused)}
        tier_block = None
        if self.engine.host_kv is not None or self.engine.remote_kv is not None:
            tier_block = self.engine.tier_stats()
        if perf is None:
            return 200, {"enabled": False, "kv_transfer": kv_block,
                         "kv_tier": tier_block,
                         "tenants": self.engine.tenant_stats()}
        snap = perf.snapshot()
        snap["kv_transfer"] = kv_block
        snap["kv_tier"] = tier_block
        eng = self.engine
        drafted, steps = eng.spec_drafted, eng.spec_steps
        snap["speculative"] = {
            "enabled": eng._spec is not None,
            "draft_tokens": drafted,
            "accepted_tokens": eng.spec_accepted,
            "acceptance_rate": eng.spec_accepted / drafted if drafted
            else 0.0,
            "tokens_per_step": eng.spec_step_tokens / steps if steps
            else 0.0,
        }
        snap["tenants"] = eng.tenant_stats()
        # the ranks the runner spans, and whether decode runs as graphs
        # (off under tensor parallelism: collectives are not captured)
        snap["ranks"] = eng.rank_info()
        snap["perf_ledger"] = (
            {"enabled": True, **self.perf_ledger.stats(),
             "interval": self.config.perf_ledger_interval}
            if self.perf_ledger is not None else {"enabled": False})
        return 200, snap

    def debug_ranks(self) -> tuple[int, dict]:
        """The ranks (``rank_info``) and, where the runner mirrors its
        calls to follower ranks, every rank's report (``follower_reports``:
        token digest, call count, kernel launches inside the ranks' calls)
        and, over the multi-host channel, each method's frames, median
        payload bytes and median host microseconds to send one (pickle,
        HMAC, socket). Made on the engine thread between steps."""

        def collect(eng) -> dict:
            runner = eng.runner
            reports = getattr(runner, "follower_reports", None)
            channel = getattr(runner, "channel", None)
            return {"ranks": eng.rank_info(),
                    "reports": reports() if reports is not None else None,
                    "channel": channel.stats() if channel is not None
                    else None}

        return 200, self.async_engine.run_on_engine(collect)

    def debug_canary(self, query: dict) -> tuple[int, dict]:
        """Golden records of the pinned probes (canary_golden.py): each
        probe goes through the normal admission, greedy with logprobs on,
        and its response becomes a record. ``?tolerance=`` stamps the
        records' L-infinity band."""
        try:
            tolerance = float(query.get("tolerance", ["0.0"])[0])
        except ValueError:
            return 400, _error("tolerance must be a float")
        tk = self.engine.tokenizer
        records, errors = [], []
        for probe in DEFAULT_PROBES:
            rid = f"canary-{probe.id}-{uuid.uuid4().hex[:8]}"
            sampling = SamplingParams(max_tokens=probe.max_tokens,
                                      temperature=0.0, logprobs=probe.top_k)
            try:
                stream, = self.async_engine.admit_batch(
                    [(rid, tk.encode(probe.prompt), sampling,
                      self.lora.slot_of(self.model_name))])
                token_ids: list[int] = []
                lps: list = []
                for out in stream:
                    token_ids.extend(out.new_token_ids)
                    lps.extend(out.new_logprobs or ())
            except Exception as e:  # a sick engine still answers
                errors.append({"probe": probe.id, "error": str(e)})
                continue
            payload = {"choices": [{
                "text": tk.decode(token_ids),
                "logprobs": _fmt_completion_logprobs(
                    tk, token_ids, lps, probe.top_k),
            }]}
            try:
                rec = record_from_response(
                    self.model_name, probe, payload, tolerance=tolerance,
                    source=f"engine:{self.model_name}", created=time.time())
            except ValueError as e:
                errors.append({"probe": probe.id, "error": str(e)})
                continue
            records.append(rec.to_dict())
        return 200, {"model": self.model_name, "records": records,
                     "errors": errors}

    def profile(self, body: dict):
        """A ``torch.profiler`` trace of ``duration_ms`` of serving (CUDA
        activity included on the card), as a tar.gz of its Chrome trace;
        409 while another capture runs. The profiler is stopped on every
        exit path. Returns (status, JSON) or (200, tar.gz bytes)."""
        duration_ms = min(int(body.get("duration_ms") or 2000), 60_000)
        if not self._profiling.acquire(blocking=False):
            return 409, _error("a profile capture is already running",
                               "conflict")
        try:
            prof = self._profile_for(duration_ms / 1000.0)
            with tempfile.TemporaryDirectory(prefix="torchprof-") as tmp:
                prof.export_chrome_trace(os.path.join(tmp, "trace.json"))
                buf = io.BytesIO()
                with tarfile.open(fileobj=buf, mode="w:gz") as tar:
                    tar.add(tmp, arcname="trace")
            return 200, buf.getvalue()
        except Exception as e:
            return 500, _error(f"profile capture failed: {e}",
                               "server_error")
        finally:
            self._profiling.release()

    def debug_requests(self, query: dict) -> tuple[int, dict]:
        """The flight recorder: recent per-request timelines, newest
        first, so a slow request can be dissected after the fact without a
        tracing backend. ``?limit=N`` bounds the answer."""
        try:
            limit = int(query["limit"][0]) if "limit" in query else None
        except ValueError:
            limit = None
        return 200, {"recorder": self.flight_recorder.stats(),
                     "requests": self.flight_recorder.snapshot(limit)}

    def memory_profile(self):
        """What holds device memory now: ``torch.cuda.memory._snapshot()``
        pickled (PyTorch's ``torch.cuda._memory_viz`` reads it), where the
        reference returns jax's pprof. Allocation history is not recorded:
        that would tax every allocation of the serving path, so the
        snapshot holds the segments and blocks without stack traces. A CPU
        engine answers 500: an empty snapshot would hide the device.
        Returns (status, JSON) or (200, bytes)."""
        if self.engine.device.type != "cuda":
            return 500, {"error": {"message":
                                   "memory profile failed: the engine runs "
                                   "on the CPU, which has no device memory "
                                   "snapshot"}}
        try:
            return 200, self._collect_device_memory()
        except Exception as e:
            return 500, {"error": {"message": f"memory profile failed: {e}"}}

    # -- anomaly diagnostics (engine/diagnostics.py) --------------------------
    def _collect_perf(self) -> dict:
        perf = self.engine.perf
        return perf.snapshot() if perf is not None else {"enabled": False}

    def _collect_flight_recorder(self) -> dict:
        return {"recorder": self.flight_recorder.stats(),
                "requests": self.flight_recorder.snapshot()}

    def _collect_scheduler(self) -> dict:
        stats = self.engine.stats()
        perf = stats.get("perf")
        if isinstance(perf, dict):
            # stats_fields() keys compile_counts by (kind, bucket) tuples
            # for the exposition; JSON needs the "kind:bucket" form
            counts = perf.get("compile_counts")
            if isinstance(counts, dict):
                perf = dict(perf)
                perf["compile_counts"] = {
                    f"{k}:{b}": n for (k, b), n in sorted(counts.items())}
                stats["perf"] = perf
        return stats

    def _collect_compile_tail(self) -> list:
        perf = self.engine.perf
        if perf is None:
            return []
        return perf.snapshot()["compile"]["recent"]

    def _collect_device_memory(self) -> bytes:
        import pickle

        import torch

        snap = self.async_engine.run_on_engine(
            lambda eng: torch.cuda.memory._snapshot(eng.device),
            timeout=ENGINE_WAIT_SECONDS)
        return pickle.dumps(snap)

    def _profiler(self):
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.engine.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    def _warm_profiler(self) -> None:
        """Pay the process's first ``torch.profiler`` start (seconds) at
        server start, before the engine thread runs, and not inside the
        first bundle's trace, whose start holds the engine between steps.
        Runs on the thread that starts the server, which in ``main`` is
        the thread that imported torch."""
        import torch

        if torch.autograd.profiler._is_profiler_enabled:
            return
        t0 = time.monotonic()
        try:
            prof = self._profiler()
            prof.start()
            prof.stop()
        except Exception:  # a broken profiler shows in each bundle's errors
            _log.exception("torch.profiler warm-up failed")
            return
        self.profiler_warmup_seconds = time.monotonic() - t0
        _log.info("torch.profiler warmed up in %.3f s",
                  self.profiler_warmup_seconds)

    def _profile_for(self, seconds: float):
        """A stopped ``torch.profiler`` session of ``seconds`` of serving:
        CPU activity, and the card's with it. The profiler starts and
        stops on the engine thread between two steps, so its state never
        changes under a kernel launch and the engine thread's ops are the
        ones traced. TimeoutError, and no trace, when a step holds the
        engine ``ENGINE_WAIT_SECONDS``; once started, the stop waits for
        the step in flight. ``self.last_trace`` keeps the seconds the
        engine was held for the start and the stop."""
        prof = self._profiler()
        t0 = time.monotonic()
        self.async_engine.run_on_engine(lambda eng: prof.start(),
                                        timeout=ENGINE_WAIT_SECONDS)
        t1 = time.monotonic()
        try:
            time.sleep(seconds)
        finally:
            t2 = time.monotonic()
            self.async_engine.run_on_engine(lambda eng: prof.stop())
            self.last_trace = {"start_s": t1 - t0, "traced_s": t2 - t1,
                               "stop_s": time.monotonic() - t2}
        return prof

    def _diag_profile(self, trace_dir: str) -> bool:
        """A short ``torch.profiler`` trace (CPU and, on the card, CUDA
        activity) for a bundle, written as ``trace_dir/trace.json``. Runs
        on the capture thread; shares ``/debug/profile``'s lock, and
        returns False (the bundle records the skip) while that capture
        runs or any other profiler is enabled in this process: torch's
        profiler cannot run twice at once."""
        import torch

        if not self._profiling.acquire(blocking=False):
            return False
        try:
            if torch.autograd.profiler._is_profiler_enabled:
                return False
            prof = self._profile_for(
                min(self.diagnostics.config.profile_seconds, 10.0))
            t0 = time.monotonic()
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
            self.last_trace["export_s"] = time.monotonic() - t0
            _log.info("bundle trace: engine held %.3f s to start and %.3f "
                      "s to stop; %.3f s traced, %.3f s exported",
                      self.last_trace["start_s"], self.last_trace["stop_s"],
                      self.last_trace["traced_s"],
                      self.last_trace["export_s"])
            return True
        finally:
            self._profiling.release()

    def diagnostics_index(self) -> tuple[int, dict]:
        """The bundle archive's index: what was captured, why, how big,
        and the anomaly event tail (captures the cooldown or the
        single-flight gate skipped among them)."""
        return 200, self.diagnostics.index()

    def diagnostics_bundle(self, bundle_id: str):
        """One bundle as tar.gz, or 404 in the reference's error shape.
        Returns (status, JSON) or (200, bytes)."""
        data = self.diagnostics.tar_bundle(bundle_id)
        if data is None:
            return 404, {"error": {"message":
                                   f"no diagnostic bundle {bundle_id!r}"}}
        return 200, data

    def diagnostics_capture(self, body: dict) -> tuple[int, dict]:
        """A correlated capture: the router's incident fan-out POSTs
        ``{"trigger", "incident", "detail"}`` here so the fleet's bundles
        share an incident id. Answers once the bundle is on disk; 400 when
        diagnostics are off, 409 while another capture runs."""
        if not self.diagnostics.config.enabled:
            return 400, {"captured": False, "reason": "diagnostics disabled"}
        trigger = str(body.get("trigger") or "manual")
        detail = dict(body.get("detail") or {})
        if body.get("incident"):
            detail["incident"] = body["incident"]
        bundle_id = self.diagnostics.trigger(trigger, detail, force=True,
                                             sync=True)
        if bundle_id is None:
            return 409, {"captured": False,
                         "reason": "a capture is in flight"}
        return 200, {"captured": True, "bundle": bundle_id}

    def load_lora(self, body: dict) -> tuple[int, dict]:
        name, path = body.get("lora_name"), body.get("lora_path")
        if not name or not path:
            return 400, _error("lora_name and lora_path required")
        try:
            self.async_engine.run_on_engine(
                lambda eng: self.lora.load(name, path))
        except Exception as e:  # a bad adapter is the caller's error
            return 400, _error(str(e))
        return 200, {"status": "loaded", "lora_name": name}

    def unload_lora(self, body: dict) -> tuple[int, dict]:
        name = body.get("lora_name")
        if not self.async_engine.run_on_engine(
                lambda eng: self.lora.unload(name)):
            return 404, _error(f"adapter {name!r} not loaded", "not_found")
        return 200, {"status": "unloaded", "lora_name": name}

    def guided_sampling(self, body: dict,
                        sampling: SamplingParams) -> SamplingParams:
        """``sampling`` with the request's grammar, validated now (a 400
        before admission, not a failure mid-stream)."""
        g_re = body.get("guided_regex")
        g_js = body.get("guided_json")
        if g_re is None and g_js is None:
            return sampling
        if g_re is not None and g_js is not None:
            raise BadRequest("guided_regex and guided_json are mutually "
                             "exclusive")
        if body.get("guided_choice") is not None:
            raise BadRequest("guided_choice cannot combine with other "
                             "guidance")
        if g_re is not None and not isinstance(g_re, str):
            raise BadRequest("guided_regex must be a string")
        if not hasattr(self.engine.runner, "register_grammar"):
            raise BadRequest("guided decoding is not supported with "
                             "pipeline parallelism")
        try:
            pat = g_re if g_re is not None else schema_to_regex(g_js)
            compile_regex(pat, max_states=self.config.max_grammar_states)
        except (ValueError, IndexError, KeyError, TypeError) as e:
            # RegexError is a ValueError; the other types keep any parser
            # edge case a 400
            raise BadRequest(f"invalid guided grammar: {e}") from None
        return dataclasses.replace(sampling, guided_regex=g_re,
                                   guided_json=g_js)

    def render_chat(self, messages: list[dict]) -> str:
        tk = self.engine.tokenizer
        if hasattr(tk, "tk") and getattr(tk.tk, "chat_template", None):
            return tk.tk.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True)
        parts = [f"<|{m.get('role', 'user')}|>\n{m.get('content', '')}"
                 for m in messages]
        return "\n".join(parts) + "\n<|assistant|>\n"

    def prompts_of(self, body: dict, chat: bool) -> list:
        """The request's prompts: one rendered chat, or the completions
        forms str | [str, ...] | [int, ...] | [[int, ...], ...]."""
        if chat:
            if "messages" not in body:
                raise BadRequest("'messages' is required")
            return [self.render_chat(body["messages"])]
        prompt = body.get("prompt")
        if prompt is None:
            raise BadRequest("'prompt' is required")

        def is_token_list(p):
            return (isinstance(p, list) and p
                    and all(isinstance(t, int) for t in p))

        if isinstance(prompt, str) or is_token_list(prompt):
            return [prompt]
        if (isinstance(prompt, list) and prompt
                and all(isinstance(p, str) or is_token_list(p)
                        for p in prompt)):
            return prompt
        raise BadRequest("invalid 'prompt': expected string, token list, or "
                         "batch thereof")

    def validate(self, body: dict, chat: bool, deadline: Optional[float],
                 rid: str) -> tuple:
        """A generation request's (sampling, prompt ids of each prompt,
        ``rid``), or BadRequest; DeadlineExceeded when ``deadline`` has
        passed (the reference's order: after the sampling checks, before
        the prompt-length one)."""
        prompts = self.prompts_of(body, chat)
        try:
            sampling = _sampling_from_body(body)
            lp_n = _parse_logprobs(body, chat)
            if lp_n is not None:
                sampling = dataclasses.replace(sampling, logprobs=lp_n)
            make_token_controls(sampling, self.config.model.vocab_size)
        except (TypeError, ValueError) as e:
            raise BadRequest(f"invalid sampling parameter: {e}") from None
        if (sampling.logprobs is not None
                and not self.engine.runner.supports_logprobs):
            raise BadRequest("logprobs are not supported with pipeline "
                             "parallelism")
        sampling = self.guided_sampling(body, sampling)
        if sampling.n < 1 or sampling.n * len(prompts) > MAX_CHOICES:
            raise BadRequest(
                f"n x prompt batch size must be in [1, {MAX_CHOICES}]")
        tk = self.engine.tokenizer
        prompt_ids_list = [tk.encode(p) if isinstance(p, str) else list(p)
                           for p in prompts]
        if deadline is not None and deadline <= time.time():
            # expired before admission: refused without touching the
            # scheduler, the cheapest shed there is
            raise DeadlineExceeded("x-request-deadline already expired")
        for ids in prompt_ids_list:
            if len(ids) > self.config.model.max_model_len - 1:
                raise BadRequest("prompt too long")
        return sampling, prompt_ids_list, rid

    def scored(self, body: dict, chat: bool, sampling: SamplingParams,
               prompt_ids_list: list, rid: str):
        """The responses a dense scoring pass answers alone: echo with
        ``max_tokens: 0`` and ``guided_choice``. Returns ("json",
        payload), ("sse", chunks) or None when the request generates.
        Raises BadRequest for echo's and guided_choice's refusals."""
        model = body.get("model", self.model_name)
        stream = bool(body.get("stream", False))
        if body.get("echo") and not chat:
            if stream:
                raise BadRequest("echo is not supported with stream=true")
            if body.get("guided_choice") is not None:
                raise BadRequest("echo cannot be combined with guided_choice")
            if (sampling.logprobs is not None
                    and any(len(p) > MAX_ECHO_SCORE_TOKENS
                            for p in prompt_ids_list)):
                raise BadRequest(f"echo with logprobs is limited to "
                                 f"{MAX_ECHO_SCORE_TOKENS}-token prompts")
            if body.get("max_tokens") == 0:
                return "json", self.echo_score_response(
                    prompt_ids_list, sampling, rid, model)
        guided = body.get("guided_choice")
        if guided is not None:
            return self.guided_choice_response(
                guided, prompt_ids_list, sampling, rid, model, chat, stream)
        return None

    def _prompt_logprobs(self, prompt_ids: list) -> list:
        return self.async_engine.run_on_engine(
            lambda eng: eng.prompt_logprobs(prompt_ids))

    def echo_score_response(self, prompt_ids_list: list,
                            sampling: SamplingParams, rid: str,
                            model) -> dict:
        """Completions ``echo`` with ``max_tokens: 0``: the prompt itself,
        with its teacher-forced logprobs when asked (OpenAI's scoring mode:
        perplexity or classification without generating). With n > 1 the
        deterministic choice repeats, in the generation path's prompt x n
        layout."""
        tk = self.engine.tokenizer
        n = max(1, int(sampling.n))
        choices = []
        for pi, pids in enumerate(prompt_ids_list):
            lp_obj = None
            if sampling.logprobs is not None:
                lp_obj = _fmt_completion_logprobs(
                    tk, list(pids),
                    [(None, [])] + self._prompt_logprobs(pids),
                    sampling.logprobs)
            for j in range(n):
                choices.append({"index": pi * n + j,
                                "text": tk.decode(list(pids)),
                                "finish_reason": "length",
                                "logprobs": lp_obj})
        n_prompt = sum(len(p) for p in prompt_ids_list)
        return {"id": rid, "object": "text_completion",
                "created": int(time.time()), "model": model,
                "choices": choices,
                "usage": {"prompt_tokens": n_prompt, "completion_tokens": 0,
                          "total_tokens": n_prompt}}

    def guided_choice_response(self, guided, prompt_ids_list: list,
                               sampling: SamplingParams, rid: str, model,
                               chat: bool, stream: bool):
        """vLLM's ``guided_choice``, scored whole: log P(choice | prompt)
        of every choice in one teacher-forced pass; temperature 0 takes
        the argmax, otherwise the choice is drawn from softmax(logP / T)
        with ``numpy.random.default_rng(seed)``. Returns ("json", payload)
        or ("sse", chunks)."""
        import numpy as np

        if (not isinstance(guided, list) or not guided
                or not all(isinstance(c, str) and c for c in guided)
                or len(guided) > MAX_GUIDED_CHOICES):
            raise BadRequest(f"guided_choice must be 1..{MAX_GUIDED_CHOICES}"
                             " non-empty strings")
        if len(prompt_ids_list) != 1 or sampling.n != 1:
            raise BadRequest("guided_choice requires a single prompt and n=1")
        tk = self.engine.tokenizer
        prompt_ids = prompt_ids_list[0]
        # a choice is scored mid-sequence: no BOS
        choice_ids = [tk.encode(c, add_bos=False) for c in guided]
        if any(not c for c in choice_ids):
            raise BadRequest("guided_choice entry tokenizes to nothing")
        if (len(prompt_ids) + max(len(c) for c in choice_ids)
                > self.config.model.max_model_len):
            raise BadRequest("prompt + longest choice exceeds max_model_len")
        logps = self.async_engine.run_on_engine(
            lambda eng: eng.choice_logprobs(prompt_ids, choice_ids))
        if sampling.temperature <= 0.0:
            idx = int(np.argmax(logps))
        else:
            z = np.asarray(logps, np.float64) / sampling.temperature
            p = np.exp(z - z.max())
            p /= p.sum()
            idx = int(np.random.default_rng(sampling.seed).choice(len(p),
                                                                  p=p))
        text = guided[idx]
        usage = {"prompt_tokens": len(prompt_ids),
                 "completion_tokens": len(choice_ids[idx]),
                 "total_tokens": len(prompt_ids) + len(choice_ids[idx])}
        created = int(time.time())
        if chat:
            choice = {"index": 0,
                      "message": {"role": "assistant", "content": text},
                      "finish_reason": "stop", "logprobs": None}
        else:
            choice = {"index": 0, "text": text, "finish_reason": "stop",
                      "logprobs": None}
        if not stream:
            return "json", {
                "id": rid, "object": ("chat.completion" if chat
                                      else "text_completion"),
                "created": created, "model": model, "choices": [choice],
                "usage": usage}
        if chat:
            parts = [{"delta": {"role": "assistant", "content": text},
                      "index": 0, "finish_reason": None},
                     {"delta": {}, "index": 0, "finish_reason": "stop"}]
        else:
            parts = [{"text": text, "index": 0, "finish_reason": None},
                     {"text": "", "index": 0, "finish_reason": "stop"}]
        obj = "chat.completion.chunk" if chat else "text_completion"
        return "sse", [{"id": rid, "object": obj, "created": created,
                        "model": model, "choices": [c]} for c in parts]

    def admit(self, body: dict, chat: bool, sampling: SamplingParams,
              prompt_ids_list: list, rid: str, tenant: str = "anonymous",
              deadline: Optional[float] = None) -> _Admission:
        """Run what a validated request's ``kv_transfer_params`` ask for
        before admission (splice a landed push, or pull blocks into the
        prefix cache), apply the brownout's stage (3: 429 for an
        over-weight tenant's new request, SchedulerQueueFull; 2: clamp
        ``max_tokens``), admit its choices for ``tenant`` with their
        ``deadline``, and score an echoed prompt."""
        adapter_slot = self.lora.slot_of(body.get("model", self.model_name))
        n = sampling.n
        nchoices = len(prompt_ids_list) * n
        kv = body.get("kv_transfer_params") or {}
        if kv and (nchoices != 1 or not isinstance(kv, dict)):
            raise BadRequest("kv_transfer_params requires n=1 and a single "
                             "prompt")
        imported = 0
        if kv.get("transfer_id") and not kv.get("do_remote_decode"):
            # the decode hop of a pushed transfer: splice it in; when it is
            # not attachable, the pull or a plain prefill serves the body
            spliced = self._try_attach_spliced(kv["transfer_id"], sampling,
                                               rid, adapter_slot, tenant)
            if spliced is not None:
                stream, n_prompt = spliced
                stream.deadline = deadline
                return _Admission([stream], [rid], rid, sampling, n_prompt,
                                  prompt_ids_list[0])
        if kv.get("remote_block_ids"):
            imported = self._maybe_import_kv(kv, prompt_ids_list[0],
                                             adapter_slot)
        produce_kv = bool(kv.get("do_remote_decode"))
        push = None
        if (produce_kv and kv.get("push_url") and kv.get("transfer_id")
                and not body.get("stream")):
            push = {"push_url": kv["push_url"],
                    "transfer_id": str(kv["transfer_id"])}
        ctl = self.brownout
        if ctl is not None and ctl.stage > 0:
            # stage 3: refuse new work of over-weight tenants. A pushed P->D
            # continuation is not new work (its prefill already ran), so it
            # always passes
            if (ctl.shed_overweight and tenant in self._brownout_shed
                    and not kv.get("transfer_id")):
                self._record_shed(SHED_TENANT)
                raise SchedulerQueueFull(
                    f"brownout stage {ctl.stage}: tenant {tenant!r} is over "
                    "its fair share; new admissions are shed until pressure "
                    "recedes")
            # stage 2: bound tail work by clamping max_tokens
            clamp = ctl.max_tokens_clamp
            if clamp and sampling.max_tokens > clamp:
                self._record_shed(SHED_MAX_TOKENS)
                sampling = dataclasses.replace(sampling, max_tokens=clamp)
        reqs, rids = [], []
        for pi, ids in enumerate(prompt_ids_list):
            for j in range(n):
                idx = pi * n + j
                crid = rid if nchoices == 1 else f"{rid}-{idx}"
                choice_sampling = sampling
                if sampling.seed is not None and nchoices > 1:
                    # seeded n > 1 still yields distinct choices
                    choice_sampling = dataclasses.replace(
                        sampling, seed=(sampling.seed + idx) & 0xFFFFFFFF)
                reqs.append((crid, ids, choice_sampling, adapter_slot,
                             push is not None, tenant))
                rids.append(crid)
        try:
            streams = self.async_engine.admit_batch(reqs)
        except (SchedulerQueueFull, GrammarBankFull):
            raise
        except ValueError as e:
            raise BadRequest(str(e)) from None
        for stream in streams:
            stream.deadline = deadline
        n_prompt = sum(len(p) for p in prompt_ids_list)
        adm = _Admission(streams, rids, rid, sampling, n_prompt,
                         prompt_ids_list[0], produce_kv, push, imported)
        if body.get("echo") and not chat:
            adm.echo_ids = prompt_ids_list
            adm.echo_lps = [self._prompt_logprobs(p)
                            if sampling.logprobs is not None else None
                            for p in prompt_ids_list]
        return adm

    def collect(self, stream, sampling) -> tuple:
        """Drain one choice: (text, n_kept, finish_reason, cached, ids,
        lps, the blocks it held at finish or None)."""
        tk = self.engine.tokenizer
        token_ids: list[int] = []
        lps: list = []
        finish_reason = None
        cached = 0
        blocks = None
        for out in stream:
            token_ids.extend(out.new_token_ids)
            if out.new_logprobs:
                lps.extend(out.new_logprobs)
            cached = out.num_cached_tokens
            if out.block_ids is not None:
                blocks = out.block_ids
            finish_reason = out.finish_reason or finish_reason
            stopped = _check_stop_str(tk.decode(token_ids), sampling)
            if stopped is not None:
                self.async_engine.abort(stream.request_id)
                n_kept = _tokens_covering(tk, token_ids, len(stopped))
                return (stopped, n_kept, "stop", cached, token_ids[:n_kept],
                        lps[:n_kept], blocks)
        return (tk.decode(token_ids), len(token_ids), finish_reason, cached,
                token_ids, lps, blocks)

    def full_response(self, adm: _Admission, model, chat) -> dict:
        tk = self.engine.tokenizer
        sampling = adm.sampling
        results = []
        try:
            for s in adm.streams:
                results.append(self.collect(s, sampling))
        finally:
            blocks = results[0][6] if results else None
            if adm.push is not None and blocks is None:
                adm.push = None  # never finished: nothing was pinned
        if adm.push is not None:
            # the producer of a pushed P->D transfer: its blocks were
            # pinned at finish; stream them to the decode engine, then
            # let them go (the pull fields below stay the fallback)
            ids = results[0][4]
            try:
                pushed = bool(ids) and self._push_kv_blocks(
                    adm.push["push_url"], adm.push["transfer_id"], blocks,
                    adm.prompt_ids, ids[0])
            finally:
                self.async_engine.run_on_engine(
                    lambda eng: eng.scheduler.allocator.free_blocks(blocks))
        n = max(1, int(sampling.n))
        cached = sum(
            max((r[3] for r in results[pi * n:(pi + 1) * n]), default=0)
            for pi in range(len(results) // n)
        )
        n_completion = sum(r[1] for r in results)
        want_lp = sampling.logprobs is not None
        choices = []
        for idx, (text, _n, finish_reason, _c, ids, lps, _b) in enumerate(
                results):
            if chat:
                choice = {"index": idx,
                          "message": {"role": "assistant", "content": text},
                          "finish_reason": finish_reason or "stop"}
                if want_lp:
                    choice["logprobs"] = _fmt_chat_logprobs(
                        tk, ids, lps, sampling.logprobs)
            else:
                if adm.echo_ids is not None:
                    # the prompt first, with its teacher-forced entries
                    # (token 0 has no prediction)
                    p_ids = adm.echo_ids[idx // n]
                    text = tk.decode(p_ids) + text
                    if want_lp:
                        ids = list(p_ids) + list(ids)
                        lps = ([(None, [])] + adm.echo_lps[idx // n]
                               + list(lps))
                choice = {"index": idx, "text": text,
                          "finish_reason": finish_reason or "stop",
                          "logprobs": (_fmt_completion_logprobs(
                              tk, ids, lps, sampling.logprobs)
                              if want_lp else None)}
            choices.append(choice)
        payload = {
            "id": adm.rid,
            "object": "chat.completion" if chat else "text_completion",
            "created": int(time.time()),
            "model": model,
            "choices": choices,
            "usage": {
                "prompt_tokens": adm.n_prompt,
                "completion_tokens": n_completion,
                "total_tokens": adm.n_prompt + n_completion,
                "prompt_tokens_details": {"cached_tokens": cached},
            },
        }
        final_blocks = results[0][6] if results else None
        if adm.produce_kv and final_blocks:
            # the producer's block handles (the router fills remote_host)
            payload["kv_transfer_params"] = {
                "do_remote_prefill": True,
                "remote_engine_id": self.model_name,
                "remote_block_ids": final_blocks,
                "remote_host": None,
                "remote_port": None,
            }
            if adm.push is not None:
                payload["kv_transfer_params"]["transfer_id"] = \
                    adm.push["transfer_id"]
                payload["kv_transfer_params"]["pushed"] = pushed
        return payload

    # -- the dense scoring routes ------------------------------------------
    def _encode_ids(self, text) -> list[int]:
        """The scoring routes' encoder input: a string is tokenized, a list
        of ints taken as ids; cut to max_model_len - 1."""
        tk = self.engine.tokenizer
        ids = tk.encode(text) if isinstance(text, str) else list(text)
        return ids[: self.config.model.max_model_len - 1]

    def _embed(self, ids: list[int]):
        return self.async_engine.run_on_engine(lambda eng: eng.embed(ids))

    def _pair_scores(self, query, documents) -> tuple[list, int]:
        """Cosine similarity of pooled hidden states, the /v1/embeddings
        encoder's, of ``query`` against each document; (scores, tokens)."""
        import numpy as np

        total = 0

        def unit(text):
            nonlocal total
            ids = self._encode_ids(text)
            total += len(ids)
            v = np.asarray(self._embed(ids), np.float32)
            return v / max(float(np.linalg.norm(v)), 1e-9)

        q = unit(query)
        return [float(q @ unit(d)) for d in documents], total

    def score(self, body: dict) -> tuple[int, dict]:
        """vLLM's /v1/score: text_1 against each text_2 (one query), or
        pairwise (lists of equal length)."""
        t1, t2 = body.get("text_1"), body.get("text_2")
        if t1 is None or t2 is None:
            return 400, _error("'text_1' and 'text_2' are required", None)
        queries = t1 if isinstance(t1, list) else [t1]
        docs = t2 if isinstance(t2, list) else [t2]
        if not all(isinstance(x, str) for x in queries + docs):
            return 400, _error("text_1/text_2 must be strings or lists of "
                               "strings", None)
        if len(queries) == 1:
            scores, total = self._pair_scores(queries[0], docs)
        elif len(queries) == len(docs):
            scores, total = [], 0
            for q, d in zip(queries, docs):
                s, t = self._pair_scores(q, [d])
                scores.append(s[0])
                total += t
        else:
            return 400, _error("text_1 list must have length 1 or match "
                               "text_2", None)
        return 200, {
            "id": f"score-{uuid.uuid4().hex[:16]}", "object": "list",
            "model": body.get("model", self.model_name),
            "data": [{"object": "score", "index": i, "score": s}
                     for i, s in enumerate(scores)],
            "usage": {"total_tokens": total}}

    def rerank(self, body: dict) -> tuple[int, dict]:
        """Jina/Cohere rerank: documents (strings or {"text"} objects)
        ordered by their score against the query, ``top_n`` of them."""
        query, documents = body.get("query"), body.get("documents")
        if not query or not isinstance(documents, list) or not documents:
            return 400, _error("'query' and a non-empty 'documents' list are "
                               "required", None)
        texts = [d.get("text") if isinstance(d, dict) else d
                 for d in documents]
        if not all(isinstance(t, str) for t in texts):
            return 400, _error("documents must be strings or objects with "
                               "a 'text' field", None)
        try:
            top_n = int(body.get("top_n") or len(texts))
        except (TypeError, ValueError):
            return 400, _error("'top_n' must be an integer", None)
        if top_n < 1:
            return 400, _error("'top_n' must be >= 1", None)
        scores, total = self._pair_scores(query, texts)
        order = sorted(range(len(texts)), key=lambda i: -scores[i])
        keep = body.get("return_documents", True)
        return 200, {
            "id": f"rerank-{uuid.uuid4().hex[:16]}",
            "model": body.get("model", self.model_name),
            "results": [{"index": i, "relevance_score": scores[i],
                         **({"document": {"text": texts[i]}} if keep
                            else {})}
                        for i in order[:top_n]],
            "usage": {"total_tokens": total}}

    def _embed_batch(self, body: dict, item_of) -> tuple[int, dict]:
        """/v1/embeddings and /pooling: ``input`` as str | [str, ...] |
        [int, ...] | [[int, ...], ...], each prompt mean-pooled, each item
        ``item_of(index, vector)``."""
        inputs = body.get("input")
        if inputs is None:
            return 400, _error("'input' is required", None)
        if isinstance(inputs, str):
            inputs = [inputs]
        elif (isinstance(inputs, list) and inputs
              and isinstance(inputs[0], int)):
            inputs = [inputs]  # one pre-tokenized prompt
        if not isinstance(inputs, list) or not all(
                isinstance(t, str) or (isinstance(t, list) and all(
                    isinstance(x, int) for x in t)) for t in inputs):
            return 400, _error("invalid 'input': expected string, token "
                               "list, or a list thereof")
        data, total = [], 0
        for i, text in enumerate(inputs):
            ids = self._encode_ids(text)
            total += len(ids)
            data.append(item_of(i, self._embed(ids)))
        return 200, {"object": "list",
                     "model": body.get("model", self.model_name),
                     "data": data,
                     "usage": {"prompt_tokens": total,
                               "total_tokens": total}}

    def embeddings(self, body: dict) -> tuple[int, dict]:
        return self._embed_batch(body, lambda i, vec: {
            "object": "embedding", "index": i,
            "embedding": [float(x) for x in vec]})

    def pooling(self, body: dict) -> tuple[int, dict]:
        """vLLM's /pooling: the /v1/embeddings vectors under ``data``."""
        return self._embed_batch(body, lambda i, vec: {
            "object": "pooling", "index": i,
            "data": [float(x) for x in vec]})

    # -- the Messages and Responses APIs ------------------------------------
    def _admit_one(self, rid: str, prompt_ids: list, sampling, model):
        try:
            stream, = self.async_engine.admit_batch(
                [(rid, prompt_ids, sampling, self.lora.slot_of(model))])
        except ValueError as e:
            raise BadRequest(str(e)) from None
        return stream

    def messages(self, body: dict):
        """Anthropic's Messages API over the chat path: ``system``,
        ``messages`` (text blocks joined), ``stop_sequences``. Returns
        (status, JSON body) or (200, SSE bytes generator) with the
        reference's events: message_start, content_block_start,
        content_block_delta..., content_block_stop, message_delta,
        message_stop. The stream holds no text back for stop strings, as
        the reference's does not."""
        msgs = body.get("messages")
        if not msgs:
            return 400, _error("'messages' is required", None)
        chat = []
        if body.get("system"):
            chat.append({"role": "system", "content": body["system"]})
        for m in msgs:
            content = m.get("content")
            if isinstance(content, list):
                content = "".join(b.get("text", "") for b in content
                                  if b.get("type") == "text")
            chat.append({"role": m.get("role", "user"), "content": content})
        prompt_ids = self.engine.tokenizer.encode(self.render_chat(chat))
        if body.get("stop_sequences"):
            body = dict(body, stop=body["stop_sequences"])
        try:
            sampling = _sampling_from_body(body)
            make_token_controls(sampling, self.config.model.vocab_size)
        except (TypeError, ValueError) as e:
            return 400, _error(f"invalid sampling parameter: {e}", None)
        rid = f"msg_{uuid.uuid4().hex[:24]}"
        if len(prompt_ids) > self.config.model.max_model_len - 1:
            return 400, _error("prompt too long", None)
        model = body.get("model", self.model_name)
        stream = self._admit_one(rid, prompt_ids, sampling,
                                 body.get("model", ""))
        if body.get("stream"):
            return 200, self._message_events(stream, rid, model, prompt_ids,
                                             sampling)
        tk = self.engine.tokenizer
        token_ids: list[int] = []
        finish, text = "end_turn", ""
        try:
            for out in stream:
                token_ids.extend(out.new_token_ids)
                text = tk.decode(token_ids)
                stopped = _check_stop_str(text, sampling)
                if stopped is not None:
                    text, finish = stopped, "stop_sequence"
                    break
                if out.finished:
                    finish = ("max_tokens" if out.finish_reason == "length"
                              else "end_turn")
        finally:
            self.async_engine.abort(rid)  # a no-op once finished
        return 200, {
            "id": rid, "type": "message", "role": "assistant",
            "model": model, "content": [{"type": "text", "text": text}],
            "stop_reason": finish,
            "usage": {"input_tokens": len(prompt_ids),
                      "output_tokens": len(token_ids)}}

    def _message_events(self, stream, rid, model, prompt_ids, sampling):
        tk = self.engine.tokenizer
        try:
            yield _sse_event("message_start", {
                "type": "message_start",
                "message": {"id": rid, "type": "message",
                            "role": "assistant", "model": model,
                            "content": [],
                            "usage": {"input_tokens": len(prompt_ids)}}})
            yield _sse_event("content_block_start", {
                "type": "content_block_start", "index": 0,
                "content_block": {"type": "text", "text": ""}})
            token_ids: list[int] = []
            sent = n_out = 0
            finish = "end_turn"
            for out in stream:
                token_ids.extend(out.new_token_ids)
                n_out = out.num_output_tokens
                text = tk.decode(token_ids)
                stopped = _check_stop_str(text, sampling)
                if stopped is not None:
                    text, finish = stopped, "stop_sequence"
                if len(text) > sent:
                    yield _sse_event("content_block_delta", {
                        "type": "content_block_delta", "index": 0,
                        "delta": {"type": "text_delta",
                                  "text": text[sent:]}})
                    sent = len(text)
                if stopped is not None:
                    break
                if out.finished:
                    finish = ("max_tokens" if out.finish_reason == "length"
                              else "end_turn")
            yield _sse_event("content_block_stop",
                             {"type": "content_block_stop", "index": 0})
            yield _sse_event("message_delta", {
                "type": "message_delta", "delta": {"stop_reason": finish},
                "usage": {"output_tokens": n_out}})
            yield _sse_event("message_stop", {"type": "message_stop"})
        finally:
            self.async_engine.abort(rid)

    @staticmethod
    def _responses_chat(raw, instructions) -> tuple:
        """(the chat of a Responses ``input``: a string, or message items
        whose text parts are joined; None) or (None, the 400 body)."""
        chat = []
        if instructions:
            chat.append({"role": "system", "content": instructions})
        if isinstance(raw, str):
            chat.append({"role": "user", "content": raw})
            return chat, None
        if not isinstance(raw, list):
            return None, _error("'input' must be a string or list", None)
        for item in raw:
            if not isinstance(item, dict):
                return None, _error("input items must be objects", None)
            if item.get("type") not in (None, "message"):
                return None, _error(
                    f"unsupported input item type {item.get('type')!r}: "
                    "this engine serves the text modality only")
            content = item.get("content")
            if isinstance(content, list):
                if not all(isinstance(b, dict) for b in content):
                    return None, _error("content parts must be objects")
                content = "".join(
                    b.get("text", "") for b in content
                    if b.get("type") in ("input_text", "output_text",
                                         "text"))
            chat.append({"role": item.get("role", "user"),
                         "content": content or ""})
        return chat, None

    def responses(self, body: dict):
        """OpenAI's Responses API, text only: ``input`` (a string or
        message items) and ``instructions``, ``max_output_tokens``. Returns
        (status, JSON body) or (200, SSE bytes generator) with the
        reference's events: response.created, response.output_item.added,
        response.output_text.delta..., response.output_text.done,
        response.completed. The stream holds back enough trailing text that
        no stop string's prefix is sent, and usage counts only the tokens
        the kept text covers."""
        raw = body.get("input")
        if raw is None:
            return 400, _error("'input' is required", None)
        chat, err = self._responses_chat(raw, body.get("instructions"))
        if err is not None:
            return 400, err
        prompt_ids = self.engine.tokenizer.encode(self.render_chat(chat))
        if len(prompt_ids) > self.config.model.max_model_len - 1:
            return 400, _error("input too long", None)
        if body.get("max_output_tokens") is not None:
            body = dict(body, max_tokens=body["max_output_tokens"])
        try:
            sampling = _sampling_from_body(body)
            make_token_controls(sampling, self.config.model.vocab_size)
        except (TypeError, ValueError) as e:
            return 400, _error(f"invalid sampling parameter: {e}")
        rid = f"resp_{uuid.uuid4().hex[:24]}"
        msg_id = f"msg_{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        model = body.get("model", self.model_name)
        stream = self._admit_one(rid, prompt_ids, sampling,
                                 body.get("model", ""))

        def response_obj(status, text, n_out, incomplete=None):
            return {
                "id": rid, "object": "response", "created_at": created,
                "status": status, "model": model, "error": None,
                "incomplete_details": incomplete,
                "instructions": body.get("instructions"),
                "max_output_tokens": body.get("max_output_tokens"),
                "output": [{
                    "type": "message", "id": msg_id, "status": status,
                    "role": "assistant",
                    "content": [{"type": "output_text", "text": text,
                                 "annotations": []}]}],
                "temperature": sampling.temperature,
                "top_p": sampling.top_p,
                "usage": {"input_tokens": len(prompt_ids),
                          "output_tokens": n_out,
                          "total_tokens": len(prompt_ids) + n_out}}

        if body.get("stream"):
            return 200, self._response_events(stream, rid, msg_id, sampling,
                                              response_obj)
        tk = self.engine.tokenizer
        token_ids: list[int] = []
        text, incomplete, n_out = "", None, 0
        try:
            for out in stream:
                token_ids.extend(out.new_token_ids)
                text = tk.decode(token_ids)
                stopped = _check_stop_str(text, sampling)
                if stopped is not None:
                    text = stopped
                    n_out = _tokens_covering(tk, token_ids, len(stopped))
                    break
                n_out = len(token_ids)
                if out.finished and out.finish_reason == "length":
                    incomplete = {"reason": "max_output_tokens"}
        finally:
            self.async_engine.abort(rid)
        return 200, response_obj("incomplete" if incomplete else "completed",
                                 text, n_out, incomplete)

    def _response_events(self, stream, rid, msg_id, sampling, response_obj):
        tk = self.engine.tokenizer
        seq = 0

        def ev(name, payload):
            nonlocal seq
            payload = dict(payload, type=name, sequence_number=seq)
            seq += 1
            return _sse_event(name, payload)

        try:
            yield ev("response.created",
                     {"response": response_obj("in_progress", "", 0)})
            yield ev("response.output_item.added", {
                "output_index": 0,
                "item": {"type": "message", "id": msg_id,
                         "status": "in_progress", "role": "assistant",
                         "content": []}})
            # a stop string can span steps: never send a prefix of one
            holdback = max((len(s) for s in sampling.stop), default=1) - 1
            token_ids: list[int] = []
            sent = n_out = 0
            text, incomplete, hit_stop = "", None, False
            for out in stream:
                token_ids.extend(out.new_token_ids)
                text = tk.decode(token_ids)
                stopped = _check_stop_str(text, sampling)
                if stopped is not None:
                    text = stopped
                    n_out = _tokens_covering(tk, token_ids, len(stopped))
                    hit_stop = True
                else:
                    n_out = len(token_ids)
                done = out.finished or hit_stop
                limit = (len(text) if done or not holdback
                         else max(sent, len(text) - holdback))
                if limit > sent:
                    yield ev("response.output_text.delta", {
                        "item_id": msg_id, "output_index": 0,
                        "content_index": 0, "delta": text[sent:limit]})
                    sent = limit
                if hit_stop:
                    break
                if out.finished and out.finish_reason == "length":
                    incomplete = {"reason": "max_output_tokens"}
            yield ev("response.output_text.done", {
                "item_id": msg_id, "output_index": 0, "content_index": 0,
                "text": text})
            yield ev("response.completed", {"response": response_obj(
                "incomplete" if incomplete else "completed", text, n_out,
                incomplete)})
        finally:
            self.async_engine.abort(rid)

    # -- sleep mode ----------------------------------------------------------
    def sleep(self, query: dict) -> tuple[int, dict]:
        """``POST /sleep?level=``: 1 drops the KV pool, 2 the weights too;
        409 while requests are in flight."""
        level = int(query.get("level", ["1"])[0])
        try:
            self.async_engine.sleep(level)
        except RuntimeError as e:
            return 409, _error(str(e), None)
        return 200, {"status": "sleeping", "level": level}

    def wake_up(self, body: dict) -> tuple[int, dict]:
        self.async_engine.wake_up()
        return 200, {"status": "awake"}

    # -- the KV plane (P->D disaggregation; engine/kv_transfer.py) ----------
    def _kv_shape(self, n_blocks: int) -> tuple:
        m = self.config.model
        return (m.num_layers, n_blocks, self.config.cache.block_size,
                2 * m.num_kv_heads, m.head_dim)

    def kv_export(self, body: dict, handler) -> None:
        """``POST /kv/export {"blocks", "stream"}``: the blocks' KV (L, n,
        bs, 2KH, D), whole, or as chunked layer-group frames whose gathers
        overlap the send. A streamed export pins the blocks for its length:
        serving steps run between its gathers."""
        num_blocks = self.engine.runner.num_blocks
        blocks = body.get("blocks")
        if (not isinstance(blocks, list) or not blocks
                or not all(isinstance(b, int) and 0 <= b < num_blocks
                           for b in blocks)):
            handler._send_json(_error("invalid block ids"), 400)
            return
        dtype = self.config.model.dtype
        groups = self.engine.runner.kv_head_groups
        if not body.get("stream"):
            data = self.async_engine.run_on_engine(
                lambda eng: eng.export_kv(blocks))
            raw = tensor_bytes(data)
            handler.send_response(200)
            handler.send_header("Content-Type", "application/octet-stream")
            handler.send_header("Content-Length", str(len(raw)))
            handler.send_header("X-KV-Shape", ",".join(map(str, data.shape)))
            handler.send_header("X-KV-Dtype", dtype)
            handler.send_header(HEAD_GROUPS_HEADER, str(groups))
            handler.end_headers()
            handler.wfile.write(raw)
            return
        L = self.config.model.num_layers
        try:
            group = max(1, min(int(body.get("group_layers")
                                   or default_group(L)), L))
        except (TypeError, ValueError):
            handler._send_json(_error("group_layers must be an integer"),
                               400)
            return
        try:
            self.async_engine.run_on_engine(
                lambda eng: eng.scheduler.allocator.pin_blocks(blocks))
        except ValueError as e:  # a free block: nothing cached to export
            handler._send_json(_error(str(e), "conflict"), 409)
            return
        t0 = time.monotonic()
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "application/octet-stream")
            handler.send_header("Transfer-Encoding", "chunked")
            handler.send_header("X-KV-Shape",
                                ",".join(map(str, self._kv_shape(len(blocks)))))
            handler.send_header("X-KV-Dtype", dtype)
            handler.send_header("X-KV-Group-Layers", str(group))
            handler.send_header(HEAD_GROUPS_HEADER, str(groups))
            handler.end_headers()
            for fr in produce_frames(self.async_engine.run_on_engine, blocks,
                                     L, group, self.config.kv_transfer_window):
                handler._write_chunk(fr)
            handler.wfile.write(b"0\r\n\r\n")
            handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            handler.close_connection = True
            return
        finally:
            self.async_engine.run_on_engine(
                lambda eng: eng.scheduler.allocator.free_blocks(blocks))
        self.metrics.observe_transfer(
            "export", nbytes_of(self._kv_shape(len(blocks)), dtype),
            time.monotonic() - t0)

    def _maybe_import_kv(self, kv: dict, prompt_ids: list[int],
                         adapter_slot: int) -> int:
        """The decode hop's pull: stream the producer's full blocks from
        ``remote_host``'s ``/kv/export`` into pool blocks and commit them
        as prefix-cache content on the request's chain, so admission
        computes only the prompt's tail. Best-effort: on a failure the
        blocks go back and the prefill computes everything; so too when
        the producer's KV head grouping is not this engine's (counted in
        ``transfer_refused["import"]``). A tensor-parallel rank that left
        is no such failure: it raises. Returns the tokens landed."""
        host, blocks = kv.get("remote_host"), kv.get("remote_block_ids")
        if not host or not blocks:
            return 0
        root = self.engine.runner.lora_roots[adapter_slot]
        local = None
        try:
            got = self.async_engine.run_on_engine(
                lambda eng: eng.begin_kv_import(list(prompt_ids),
                                                len(blocks)))
            if got is None:
                return 0
            local, n_full = got
            t0 = time.monotonic()
            u = urllib.parse.urlsplit(host)
            conn = http.client.HTTPConnection(u.hostname, u.port or 80,
                                              timeout=120)
            try:
                conn.request("POST", "/kv/export", json.dumps(
                    {"blocks": [int(b) for b in blocks[:n_full]],
                     "stream": True}),
                    {"Content-Type": "application/json"})
                resp = conn.getresponse()
                if resp.status != 200:
                    raise RuntimeError(f"export HTTP {resp.status}")
                shape = tuple(int(x) for x in
                              resp.headers["X-KV-Shape"].split(","))
                dtype = resp.headers["X-KV-Dtype"]
                if shape[2:] != self._kv_shape(0)[2:] or shape[0] != \
                        self.config.model.num_layers:
                    raise ValueError(f"KV shape {shape} does not fit this "
                                     "engine's pool")
                mine = self.engine.runner.kv_head_groups
                theirs = head_groups_of(resp.headers, mine)
                if theirs != mine:
                    self.metrics.refuse_transfer("import")
                    raise ValueError(f"KV grouped in {theirs} head groups; "
                                     f"this engine's pool is grouped in "
                                     f"{mine}")
                consume_frames(resp, self.async_engine.run_on_engine, local,
                               shape, dtype,
                               int(resp.headers["X-KV-Group-Layers"]))
                resp.read()  # the chunked body's end
            finally:
                conn.close()
            cached = self.async_engine.run_on_engine(
                lambda eng: eng.finish_kv_import(list(prompt_ids), local,
                                                 root))
            local = None  # committed
            self.metrics.observe_transfer("import", nbytes_of(shape, dtype),
                                          time.monotonic() - t0)
            return cached
        except RankLost:
            raise
        except Exception as e:  # best-effort: the prefill recomputes
            _log.warning("kv import from %s failed: %s", host, e)
            if local is not None:
                self.async_engine.run_on_engine(
                    lambda eng: eng.abort_kv_import(local))
            return 0

    def _sweep_kv_transfers(self) -> None:
        """Free the blocks of pushed transfers whose decode hop never came
        within ``kv_transfer_ttl`` (a router that died between the push
        and the continuation): a leaked transfer never pins pages for
        good. Runs on every /kv/recv and attach."""
        now = time.monotonic()
        expired = []
        with self._kv_lock:
            for tid, st in list(self._kv_transfers.items()):
                if now - st["created"] > self.config.kv_transfer_ttl:
                    expired.append((tid, self._kv_transfers.pop(tid)))
        for tid, st in expired:
            _log.warning("kv transfer %s expired unattached; freeing %d "
                         "blocks", tid, len(st["blocks"]))
            self.async_engine.run_on_engine(
                lambda eng, b=st["blocks"]:
                eng.scheduler.allocator.free_blocks(b))

    def kv_recv(self, headers, body) -> tuple[int, dict]:
        """``POST /kv/recv``: land a pushed transfer (a JSON meta prologue
        frame, then CRC-tailed layer-group frames) in free pool blocks. The
        decode hop attaches them by ``transfer_id``. A bad CRC or a dropped
        connection answers 409 ``{"resume_layer": n}``: the producer
        resends only the groups that did not land. 503 when the pool
        cannot hold the transfer; 422 when its KV head grouping
        (``X-KV-Head-Groups``) is not this engine's."""
        self._sweep_kv_transfers()
        tid = headers.get("X-KV-Transfer-Id") or ""
        try:
            shape = tuple(int(x) for x in headers["X-KV-Shape"].split(","))
            dtype = headers["X-KV-Dtype"]
            group = max(1, int(headers["X-KV-Group-Layers"]))
            start_layer = int(headers.get("X-KV-Start-Layer") or 0)
            nbytes_of(shape, dtype)
        except (KeyError, ValueError, AttributeError):
            return 400, _error("missing or invalid X-KV-* headers")
        if not tid or len(shape) != 5:
            return 400, _error("X-KV-Transfer-Id and a 5-dim X-KV-Shape are "
                               "required")
        want = self._kv_shape(shape[1])
        if shape[0] != want[0] or shape[2:] != want[2:]:
            return 400, _error(f"KV shape {shape} does not fit this "
                               f"engine's pool {want}")
        mine = self.engine.runner.kv_head_groups
        theirs = head_groups_of(headers, mine)
        if theirs != mine:
            # other heads in the same shape: never landed, never retried
            self.metrics.refuse_transfer("recv")
            return 422, _error(f"KV grouped in {theirs} head groups "
                               f"({HEAD_GROUPS_HEADER}); this engine's pool "
                               f"is grouped in {mine}")
        with self._kv_lock:
            state = self._kv_transfers.get(tid)
        resume_at = state["layers_done"] if state else 0
        try:
            payload = read_frame(body)
            if payload is None:
                raise ValueError("no meta frame")
            meta = json.loads(bytes(payload))
        except (FrameDigestError, EOFError, ValueError):
            return 409, {"resume_layer": resume_at}
        if state is None:
            if start_layer != 0:
                # a resume of a transfer this engine never saw (or swept)
                return 409, {"resume_layer": 0}
            blocks = self.async_engine.run_on_engine(
                lambda eng: eng.begin_kv_receive(int(shape[1])))
            if blocks is None:
                return 503, _error("KV pool cannot hold the transfer right "
                                   "now", "service_unavailable_error")
            state = {"blocks": blocks, "layers_done": 0, "meta": meta,
                     "created": time.monotonic(), "ready": False}
            with self._kv_lock:
                self._kv_transfers[tid] = state
        elif start_layer != state["layers_done"]:
            # the producer's progress disagrees with ours: re-anchor it
            return 409, {"resume_layer": state["layers_done"]}

        def on_group(lo: int, n: int) -> None:
            state["layers_done"] = lo + n

        t0 = time.monotonic()
        try:
            landed = consume_frames(body, self.async_engine.run_on_engine,
                                    state["blocks"], shape, dtype, group,
                                    start_layer=start_layer,
                                    on_group=on_group)
        except (FrameDigestError, EOFError, ValueError, OSError):
            # the groups that landed stay for the retry (the TTL sweep
            # reclaims them if none comes)
            return 409, {"resume_layer": state["layers_done"]}
        state["ready"] = True
        self.metrics.observe_transfer(
            "recv", landed * nbytes_of(shape[1:], dtype),
            time.monotonic() - t0)
        return 200, {"ok": True, "transfer_id": tid, "layers": shape[0]}

    def _push_kv_blocks(self, push_url: str, transfer_id: str, blocks: list,
                        prompt_ids: list, first_token: int) -> bool:
        """The producer's side of the pushed flow: stream the finished
        prefill's blocks (pinned at its finish) to the decode engine's
        /kv/recv. Best-effort: on a failure the decode hop pulls or
        prefills."""
        cfg = self.config
        shape = self._kv_shape(len(blocks))
        meta = {"transfer_id": transfer_id,
                "prompt_token_ids": [int(t) for t in prompt_ids],
                "first_token": int(first_token)}
        t0 = time.monotonic()
        try:
            push_kv(push_url, self.async_engine.run_on_engine, blocks, shape,
                    cfg.model.dtype, meta,
                    group=cfg.kv_transfer_group_layers or None,
                    window=cfg.kv_transfer_window,
                    retries=cfg.kv_transfer_retries,
                    timeout=cfg.kv_transfer_ttl,
                    head_groups=self.engine.runner.kv_head_groups)
        except RankLost:
            raise
        except Exception as e:
            _log.warning("kv push %s -> %s failed: %s", transfer_id,
                         push_url, e)
            return False
        self.metrics.observe_transfer("push",
                                      nbytes_of(shape, cfg.model.dtype),
                                      time.monotonic() - t0)
        return True

    def _try_attach_spliced(self, tid: str, sampling: SamplingParams,
                            rid: str, adapter_slot: int,
                            tenant: str = "anonymous"):
        """Attach a landed push as a decode row; (stream, prompt tokens)
        or None when it is not attachable (unknown, still landing, swept,
        a guided request, no decode slot). The continuation's
        ``max_tokens`` excludes the first token the router already relayed,
        but the spliced sequence holds that token as its first output and
        the length stop counts it, so it runs with max_tokens + 1."""
        self._sweep_kv_transfers()
        if sampling.guided_regex is not None or sampling.guided_json is not None:
            return None  # grammar state is built by a normal admission
        with self._kv_lock:
            state = self._kv_transfers.get(tid)
            if state is None or not state["ready"]:
                return None
            del self._kv_transfers[tid]  # claimed: the sweep cannot free it
        meta = state["meta"]
        try:
            stream = self.async_engine.attach_spliced(
                rid, meta["prompt_token_ids"], meta["first_token"],
                dataclasses.replace(sampling,
                                    max_tokens=sampling.max_tokens + 1),
                state["blocks"], adapter_slot=adapter_slot, tenant=tenant)
        except (SchedulerQueueFull, ValueError, KeyError) as e:
            _log.warning("kv transfer %s attach failed (%s); prefilling",
                         tid, e)
            with self._kv_lock:
                self._kv_transfers[tid] = state
            return None
        return stream, len(meta["prompt_token_ids"]) + 1

    def stream_events(self, streams, rid, model, chat, sampling, n_prompt,
                      include_usage: bool):
        """SSE payloads (dicts) of a streamed response, choice by choice,
        ending with the optional usage chunk. The caller writes ``data:
        [DONE]`` after them. When the streams' deadline passes, every
        choice is aborted (its KV blocks freed) and an in-band
        ``timeout_error`` takes the place of the rest: the stream already
        committed to 200."""
        obj = "chat.completion.chunk" if chat else "text_completion"
        created = int(time.time())
        if chat:
            for idx in range(len(streams)):
                yield {"id": rid, "object": obj, "created": created,
                       "model": model,
                       "choices": [{"index": idx,
                                    "delta": {"role": "assistant"},
                                    "finish_reason": None}]}
        kept: list[int] = []
        try:
            yield from self._stream_choices(streams, rid, model, chat,
                                            sampling, created, kept)
        except DeadlineExceeded as e:
            for stream in streams:
                self.async_engine.abort(stream.request_id)
            # a 200 stream that timed out in-band
            self.set_flight_outcome(rid, "deadline_exceeded")
            yield _error(str(e), "timeout_error")
        n_out = sum(kept)
        if include_usage:
            yield {"id": rid, "object": obj, "created": created,
                   "model": model, "choices": [],
                   "usage": {"prompt_tokens": n_prompt,
                             "completion_tokens": n_out,
                             "total_tokens": n_prompt + n_out}}

    def _stream_choices(self, streams, rid, model, chat, sampling, created,
                        kept: list):
        """The content chunks of each choice in turn; appends each
        finished choice's kept token count to ``kept``."""
        tk = self.engine.tokenizer
        obj = "chat.completion.chunk" if chat else "text_completion"
        want_lp = sampling.logprobs is not None
        # a stop string can span chunks: hold back enough trailing chars
        holdback = max((len(s) for s in sampling.stop), default=1) - 1
        for idx, stream in enumerate(streams):
            token_ids: list[int] = []
            all_lps: list = []
            lp_emitted = sent_len = n_kept = 0
            finish_reason = None
            for out in stream:
                token_ids.extend(out.new_token_ids)
                if out.new_logprobs:
                    all_lps.extend(out.new_logprobs)
                text = tk.decode(token_ids)
                stopped = _check_stop_str(text, sampling)
                if stopped is not None:
                    self.async_engine.abort(stream.request_id)
                    text = stopped
                    finish_reason = "stop"
                    n_kept = _tokens_covering(tk, token_ids, len(stopped))
                else:
                    n_kept = len(token_ids)
                done = out.finished or finish_reason is not None
                limit = (len(text) if done or not holdback
                         else max(sent_len, len(text) - holdback))
                delta = text[sent_len:limit]
                sent_len = limit
                if delta or done:
                    fr = finish_reason or out.finish_reason
                    chunk_lp = None
                    if want_lp:
                        # entries for tokens whose text is fully sent
                        m = _tokens_covering(tk, token_ids, sent_len)
                        if m and len(tk.decode(token_ids[:m])) > sent_len:
                            m -= 1
                        hi = min(n_kept, len(all_lps), m)
                        if lp_emitted < hi:
                            span = token_ids[lp_emitted:hi]
                            span_lps = all_lps[lp_emitted:hi]
                            if chat:
                                chunk_lp = _fmt_chat_logprobs(
                                    tk, span, span_lps, sampling.logprobs)
                            else:
                                chunk_lp = _fmt_completion_logprobs(
                                    tk, span, span_lps, sampling.logprobs,
                                    offset0=len(tk.decode(
                                        token_ids[:lp_emitted])))
                            lp_emitted = hi
                    if chat:
                        choice = {"index": idx,
                                  "delta": {"content": delta} if delta else {},
                                  "finish_reason": fr if done else None}
                        if want_lp:
                            choice["logprobs"] = chunk_lp
                    else:
                        choice = {"index": idx, "text": delta,
                                  "logprobs": chunk_lp,
                                  "finish_reason": fr if done else None}
                    yield {"id": rid, "object": obj, "created": created,
                           "model": model, "choices": [choice]}
                if finish_reason is not None:
                    break
            kept.append(n_kept)

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            server_version = f"production-stack-tpu-torch/{__version__}"

            # a generation request's status on the wire, the x-request-id
            # its JSON answers echo, and the call that finishes its flight
            # record (the shell sets them; one handler serves a
            # connection's requests in turn)
            sent_status: Optional[int] = None
            echo_rid: Optional[str] = None
            flight_finish: Optional[Callable[[], None]] = None

            def log_message(self, fmt, *args):  # route to logging
                _log.debug("%s " + fmt, self.address_string(), *args)

            def send_response(self, code, message=None):
                self.sent_status = code
                super().send_response(code, message)

            def _send_json(self, payload: dict, status: int = 200,
                           headers: Optional[dict] = None) -> None:
                data = json.dumps(payload).encode()
                headers = dict(headers or {})
                if self.echo_rid is not None and not any(
                        k.lower() == "x-request-id" for k in headers):
                    headers["X-Request-Id"] = self.echo_rid
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in headers.items():
                    self.send_header(k, v)
                self.end_headers()
                self._finish_flight()
                self.wfile.write(data)

            def _finish_flight(self) -> None:
                """Finish the request's flight record, once, before the
                answer's last bytes go out: a client that reads the answer
                and then /debug/requests finds the record there."""
                finish, self.flight_finish = self.flight_finish, None
                if finish is not None:
                    finish()

            def _write_chunk(self, data: bytes) -> None:
                # three writes: a KV frame is too large to copy into one
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data)
                self.wfile.write(b"\r\n")
                self.wfile.flush()

            def _send_bytes(self, data: bytes, content_type: str,
                            status: int = 200,
                            filename: Optional[str] = None) -> None:
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                if filename is not None:
                    self.send_header("Content-Disposition",
                                     f'attachment; filename="{filename}"')
                self.end_headers()
                self.wfile.write(data)

            def _send_result(self, result, content_type: str,
                             filename: str) -> None:
                """A (status, JSON) or (status, bytes) route result."""
                status, payload = result
                if isinstance(payload, bytes):
                    self._send_bytes(payload, content_type, status, filename)
                else:
                    self._send_json(payload, status)

            def do_GET(self):  # noqa: N802 (http.server API)
                url = urllib.parse.urlsplit(self.path)
                if url.path == "/health":
                    self._send_json({"status": "healthy"})
                elif url.path == "/ready":
                    status, payload = server.ready()
                    self._send_json(payload, status)
                elif url.path == "/v1/models":
                    self._send_json(server.models())
                elif url.path == "/version":
                    self._send_json({"version": __version__})
                elif url.path == "/metrics":
                    self._send_bytes(server.metrics.generate(), CONTENT_TYPE)
                elif url.path == "/debug/perf":
                    status, payload = server.debug_perf()
                    self._send_json(payload, status)
                elif url.path == "/debug/ranks":
                    status, payload = server.debug_ranks()
                    self._send_json(payload, status)
                elif url.path == "/debug/canary":
                    status, payload = server.debug_canary(
                        urllib.parse.parse_qs(url.query))
                    self._send_json(payload, status)
                elif url.path == "/debug/overload":
                    status, payload = server.debug_overload()
                    self._send_json(payload, status)
                elif url.path == "/debug/tenants":
                    status, payload = server.debug_tenants()
                    self._send_json(payload, status)
                elif url.path == "/debug/requests":
                    status, payload = server.debug_requests(
                        urllib.parse.parse_qs(url.query))
                    self._send_json(payload, status)
                elif url.path == "/debug/memory":
                    self._send_result(server.memory_profile(),
                                      "application/octet-stream",
                                      "memory.pickle")
                elif url.path == "/debug/diagnostics":
                    status, payload = server.diagnostics_index()
                    self._send_json(payload, status)
                elif url.path.startswith("/debug/diagnostics/"):
                    bundle_id = urllib.parse.unquote(
                        url.path[len("/debug/diagnostics/"):])
                    self._send_result(server.diagnostics_bundle(bundle_id),
                                      "application/gzip",
                                      f"{bundle_id}.tar.gz")
                elif url.path == "/is_sleeping":
                    self._send_json(
                        {"is_sleeping": server.async_engine.is_sleeping})
                else:
                    self._send_json(_error("not found", "not_found"), 404)

            def do_POST(self):  # noqa: N802 (http.server API)
                url = urllib.parse.urlsplit(self.path)
                routes = {"/v1/load_lora_adapter": server.load_lora,
                          "/v1/unload_lora_adapter": server.unload_lora,
                          "/drain": server.drain,
                          "/tokenize": server.tokenize,
                          "/detokenize": server.detokenize,
                          "/kv/lookup": server.kv_lookup,
                          "/debug/profile": server.profile,
                          "/debug/diagnostics/capture":
                              server.diagnostics_capture,
                          "/v1/embeddings": server.embeddings,
                          "/pooling": server.pooling,
                          "/v1/score": server.score,
                          "/v1/rerank": server.rerank,
                          "/rerank": server.rerank,
                          "/sleep": lambda body: server.sleep(
                              urllib.parse.parse_qs(url.query)),
                          "/wake_up": server.wake_up}
                if server._faults_armed:
                    routes["/debug/faults"] = lambda body: \
                        server.debug_faults(urllib.parse.parse_qsl(
                            url.query, keep_blank_values=True))
                # generation: admitted, counted in flight while draining
                generate = {"/v1/completions": None,
                            "/v1/chat/completions": None,
                            "/v1/messages": server.messages,
                            "/v1/responses": server.responses}
                path = url.path
                if path == "/kv/recv":
                    self._kv_recv()
                    return
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length)
                # fault injection before the drain gate, as the reference's
                # middleware order: drills can fault the drain surface too
                verdict, abort_timer = faults.inject_faults(
                    server.faults, "POST", path, self.connection,
                    server._stop)
                if verdict == faults.ERROR:
                    self._send_json(faults.ERROR_BODY, 500)
                    return
                if verdict == faults.DROP:
                    self._drop()
                    return
                try:
                    self._route_post(path, raw, routes, generate)
                except (BrokenPipeError, ConnectionResetError):
                    if abort_timer is None:
                        raise
                    self.close_connection = True  # an injected abort
                finally:
                    if abort_timer is not None:
                        abort_timer.cancel()

            def _drop(self) -> None:
                """Close the connection before any response byte."""
                self.close_connection = True
                try:
                    self.connection.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

            def _route_post(self, path, raw, routes, generate) -> None:
                if (path not in generate and path not in routes
                        and path != "/kv/export"):
                    self._send_json(_error("not found", "not_found"), 404)
                    return
                if server.draining and (path.startswith("/v1/") or path in (
                        "/pooling", "/rerank")):
                    # live streams keep running; infra routes stay up
                    server._drain_rejected += 1
                    self._send_json(
                        _error("engine is draining; no new requests are "
                               "admitted", "service_unavailable_error"), 503,
                        {"Retry-After": f"{server.overload_retry_after:g}"})
                    return
                try:
                    body = json.loads(raw or (b"{}" if path in routes
                                              else b"null"))
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                except ValueError:
                    self._send_json(_error("invalid JSON body"), 400)
                    return
                if path == "/kv/export":
                    server.kv_export(body, self)
                    return
                if path not in generate:
                    try:
                        status, payload = routes[path](body)
                    except Exception as e:  # aiohttp's answer to a fault
                        _log.exception("POST %s failed", path)
                        self._send_json(_error(str(e), "server_error"), 500)
                        return
                    if isinstance(payload, bytes):
                        self._send_bytes(payload, "application/gzip", status)
                    else:
                        self._send_json(payload, status)
                    return
                with server._inflight_lock:
                    server._inflight += 1
                try:
                    if generate[path] is None:
                        self._generate(body, path)
                    else:
                        self._api(generate[path], body)
                finally:
                    with server._inflight_lock:
                        server._inflight -= 1

            def _kv_recv(self) -> None:
                if "chunked" in (self.headers.get("Transfer-Encoding")
                                 or "").lower():
                    body = _ChunkedReader(self.rfile)
                else:
                    body = _LengthReader(
                        self.rfile, int(self.headers.get("Content-Length")
                                        or 0))
                status, payload = server.kv_recv(self.headers, body)
                # read the body to its end (a landed stream's last chunk;
                # a refused body's rest, so the answer reaches a sender
                # still writing it) before answering on this connection
                try:
                    body.drain()
                except (EOFError, OSError, ValueError):
                    self.close_connection = True
                self._send_json(payload, status)

            def _api(self, route, body: dict) -> None:
                """The Messages or Responses API: a JSON body, or an SSE
                stream of named events."""
                try:
                    status, payload = route(body)
                except BadRequest as e:
                    self._send_json(_error(str(e)), 400)
                    return
                except SchedulerQueueFull as e:
                    self._send_json(
                        _error(str(e), "rate_limit_error"), 429,
                        {"Retry-After": server.retry_after()})
                    return
                except Exception as e:  # aiohttp's answer to a fault
                    _log.exception("POST %s failed", self.path)
                    self._send_json(_error(str(e), "server_error"), 500)
                    return
                if isinstance(payload, dict):
                    self._send_json(payload, status)
                    return
                self._begin_sse({})
                try:
                    for event in payload:
                        self._write_chunk(event)
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True
                finally:
                    payload.close()  # its abort runs on every exit

            def _begin_sse(self, headers: dict) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                for k, v in headers.items():
                    self.send_header(k, v)
                self.end_headers()

            def _generate(self, body: dict, path: str) -> None:
                """The observability shell around a completion or chat
                request: joins the router's trace through the propagated
                W3C traceparent (a child SERVER span with the queue,
                prefill and decode stage times), opens a flight record
                keyed by the request id with the propagated x-request-id,
                finishes it once with its outcome and status, and logs one
                line a request."""
                chat = path == "/v1/chat/completions"
                try:
                    # the reference answers these before its record opens
                    server.prompts_of(body, chat)
                except BadRequest as e:
                    self._send_json(_error(str(e)), 400)
                    return
                rid = f"{'chatcmpl' if chat else 'cmpl'}-{uuid.uuid4().hex}"
                client_rid = self.headers.get("x-request-id") or rid
                model = str(body.get("model", server.model_name))
                inbound = etracing.extract_context(self.headers)
                span_cm = etracing.request_span(
                    f"engine {path}", context=inbound, kind="server",
                    attributes={"request.id": rid,
                                "client.request.id": client_rid,
                                "http.target": path, "model": model})
                # the tenant, resolved once: x-tenant-id > the body's user >
                # a hash of the API key > anonymous
                tenant = resolve_tenant(self.headers, body)
                rec = server.flight_recorder.begin(
                    request_id=rid, client_request_id=client_rid,
                    endpoint=path, model=model, tenant=tenant,
                    streaming=bool(body.get("stream", False)),
                    trace_id=None, outcome=None, status=None,
                    num_prompt_tokens=0, num_output_tokens=0)
                with server._flight_lock:
                    server._flights[rid] = rec
                self.sent_status = None
                self.echo_rid = client_rid

                def finish() -> None:
                    status = self.sent_status or 500
                    with server._flight_lock:
                        server._flights.pop(rid, None)
                        if rec.get("outcome") is None:
                            rec["outcome"] = (
                                "completed" if status < 400
                                else "deadline_exceeded" if status == 504
                                else "rejected")
                    rec["status"] = status
                    server.flight_recorder.finish(rec)
                    tl = rec["timeline"]
                    _log.info(
                        "request %s x-request-id=%s status=%s outcome=%s "
                        "prompt_tokens=%d output_tokens=%d e2e=%.3fs",
                        rid, client_rid, status, rec["outcome"],
                        rec["num_prompt_tokens"], rec["num_output_tokens"],
                        tl["finished"] - tl["received"])

                self.flight_finish = finish
                try:
                    with span_cm as span:
                        rec["trace_id"] = (etracing.trace_id_hex()
                                           or etracing.trace_id_hex(inbound))
                        try:
                            self._generate_inner(body, chat, rid, tenant,
                                                 client_rid)
                        finally:
                            server._finalize_span(
                                span, rec, self.sent_status or 500)
                except (BrokenPipeError, ConnectionResetError):
                    server.set_flight_outcome(rid, "client_disconnect")
                    raise
                finally:
                    self.echo_rid = None
                    self._finish_flight()

            def _generate_inner(self, body: dict, chat: bool, rid: str,
                                tenant: str, xrid: str) -> None:
                deadline = _parse_deadline(self.headers)
                try:
                    request = server.validate(body, chat, deadline, rid)
                    direct = server.scored(body, chat, *request)
                    if direct is None:
                        adm = server.admit(body, chat, *request,
                                           tenant=tenant, deadline=deadline)
                except BadRequest as e:
                    self._send_json(_error(str(e)), 400)
                    return
                except DeadlineExceeded as e:
                    self._send_json(_error(str(e), "timeout_error"), 504)
                    return
                except SchedulerQueueFull as e:
                    self._send_json(_error(str(e), "rate_limit_error"), 429,
                                    {"Retry-After": server.retry_after()})
                    return
                except GrammarBankFull:
                    self._send_json(_error(
                        "all guided-decoding grammar slots are in use; retry "
                        "when in-flight guided requests finish",
                        "rate_limit_error"), 429,
                        {"Retry-After": server.retry_after()})
                    return
                if direct is not None:
                    self._scored(direct, request[2])
                    return
                model = body.get("model", server.model_name)
                if server.usage_ledger is not None:
                    for r in adm.rids:
                        server._ledger_meta[r] = (model, xrid)
                try:
                    if body.get("stream"):
                        so = body.get("stream_options")
                        so = so if isinstance(so, dict) else {}
                        self._stream(adm.streams, adm.rid, model, chat,
                                     adm.sampling, adm.n_prompt,
                                     bool(so.get("include_usage")), xrid)
                    else:
                        try:
                            payload = server.full_response(adm, model, chat)
                        except DeadlineExceeded as e:
                            # expired mid-generation: the sequences leave
                            # the scheduler and free their KV blocks first
                            for r in adm.rids:
                                server.async_engine.abort(r)
                            self._send_json(_error(str(e), "timeout_error"),
                                            504)
                            return
                        self._send_json(payload,
                                        headers={"X-Request-Id": xrid})
                finally:
                    for r in adm.rids:  # a no-op for finished requests
                        server.async_engine.abort(r)
                        server._ledger_meta.pop(r, None)

            def _scored(self, direct: tuple, rid: str) -> None:
                """A response the scoring pass answered alone (echo with
                max_tokens 0, guided_choice), as JSON or SSE."""
                kind, payload = direct
                if kind == "json":
                    self._send_json(payload, headers={"X-Request-Id": rid})
                    return
                self._begin_sse({"X-Request-Id": rid})
                try:
                    for chunk in payload:
                        self._write_chunk(
                            f"data: {json.dumps(chunk)}\n\n".encode())
                    self._finish_flight()
                    self._write_chunk(b"data: [DONE]\n\n")
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True

            def _stream(self, streams, rid, model, chat, sampling, n_prompt,
                        include_usage, xrid) -> None:
                self._begin_sse({"X-Request-Id": xrid})
                done = False
                try:
                    try:
                        for payload in server.stream_events(
                                streams, rid, model, chat, sampling,
                                n_prompt, include_usage):
                            self._write_chunk(
                                f"data: {json.dumps(payload)}\n\n".encode())
                    except RuntimeError as e:  # an engine step failed
                        err = json.dumps(_error(str(e), "server_error"))
                        self._write_chunk(f"data: {err}\n\n".encode())
                    done = True
                    self._finish_flight()
                    self._write_chunk(b"data: [DONE]\n\n")
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    # the client left, perhaps right after [DONE]
                    self.close_connection = True
                    if not done:
                        server.set_flight_outcome(rid, "client_disconnect")

        return Handler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="tiny-llama",
                   help="model preset name (engine/config.py MODEL_PRESETS) "
                        "or a local HF checkpoint directory (config.json "
                        "and *.safetensors)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--max-model-len", type=int, default=None)
    p.add_argument("--max-num-seqs", type=int, default=None)
    p.add_argument("--prefill-batch", type=int, default=None,
                   help="prefill chunks batched per dispatch (bucketed)")
    p.add_argument("--max-num-batched-tokens", type=int, default=None)
    p.add_argument("--prefill-buckets", default=None,
                   help="comma-separated token buckets, e.g. 128,512,2048 "
                        "(bucketed)")
    p.add_argument("--attention-impl", default=None,
                   choices=["auto", "ragged", "bucketed"],
                   help="attention dispatch shape: 'ragged' packs prefill "
                        "chunks and decode rows into one token-budget "
                        "stream per step (K2), 'bucketed' runs prefill "
                        "chunks padded to --prefill-buckets, up to "
                        "--prefill-batch a step (K4), and decode in steps "
                        "of their own; 'auto' is ragged")
    p.add_argument("--num-scheduler-steps", type=int, default=None,
                   help="decode iterations per decode dispatch")
    p.add_argument("--block-size", type=int, default=None)
    p.add_argument("--num-blocks", type=int, default=None)
    p.add_argument("--tensor-parallel-size", type=int, default=-1,
                   help="tensor-parallel ranks, one process each (-1: "
                        "every visible card on cuda, 1 on the CPU); rank r "
                        "runs on cuda:r over NCCL, or on the CPU over gloo")
    p.add_argument("--data-parallel-size", type=int, default=1,
                   help="not ported yet: above 1 exits at start")
    p.add_argument("--pipeline-parallel-size", type=int, default=1,
                   help="pipeline stages, one process: stage s runs its "
                        "share of the layers and its own KV pool on "
                        "cuda:s, or on the CPU; with a tensor-parallel "
                        "size T above 1, one process a stage and tensor "
                        "rank, process g (stage times T plus tensor rank) "
                        "on cuda:g")
    p.add_argument("--sequence-parallel-size", type=int, default=1,
                   help="seq ranks, one process each (times the tensor-"
                        "parallel size): long prompts prefill via ring "
                        "attention sharded over them; process g (seq rank "
                        "times the tensor size plus tensor rank) runs on "
                        "cuda:g over NCCL, or on the CPU over gloo")
    p.add_argument("--ring-prefill-threshold", type=int, default=4096,
                   help="prompt length at which prefill switches to the "
                        "ring-attention sequence-parallel path (needs "
                        "--sequence-parallel-size > 1)")
    p.add_argument("--dtype", default=None)
    p.add_argument("--quantization", default=None, choices=["int8"],
                   help="int8: per-channel int8 weights, quantized when "
                        "they are made or loaded; products below 512 "
                        "tokens run W8A8 (cuBLAS int8 GEMM), larger ones "
                        "W8A16 (PSTPU_QUANT_A16_THRESHOLD)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--speculative-ngram", type=int, default=0,
                   help="n-gram (prompt-lookup) speculative decoding: "
                        "propose up to this many draft tokens a step from "
                        "the sequence's own history and verify them inside "
                        "the ragged step (vLLM --speculative-config ngram). "
                        "Per sequence: greedy rows speculate, sampled or "
                        "penalised rows in the same step decode normally; "
                        "an acceptance EWMA adapts the width. 0 = off; "
                        "ragged path only")
    p.add_argument("--speculative-ngram-max", type=int, default=3,
                   help="longest tail n-gram matched against the history")
    p.add_argument("--speculative-ngram-min", type=int, default=1,
                   help="shortest tail n-gram matched against the history "
                        "(the proposer tries max..min, longest first)")
    p.add_argument("--speculative-window", type=int, default=4096,
                   help="trailing history tokens the n-gram proposer "
                        "searches for a recurrence")
    p.add_argument("--skip-warmup", action="store_true",
                   help="serve at once, without first running every step "
                        "signature (GET /ready answers 503 \"warming\" "
                        "while the warmup runs)")
    p.add_argument("--fault-injection", default=None,
                   help="inject faults on the OpenAI surface for "
                        "resilience drills, e.g. error_rate=0.3,"
                        "latency_ms=100,stall_ms=500,stream_abort_rate=0.1 "
                        "(testing/faults.py); \"\" arms POST /debug/faults "
                        "with no fault. Without it the env FAULT_INJECTION "
                        "is read; the flag wins when both are set")
    p.add_argument("--max-queue-len", type=int, default=None,
                   help="waiting-queue bound; admissions past it get 429 "
                        "+ Retry-After so the router fails over instead "
                        "of piling onto an overloaded engine (0 = "
                        "unbounded)")
    p.add_argument("--overload-retry-after", type=float, default=1.0,
                   help="floor for the Retry-After seconds advertised on "
                        "overload 429s (the actual value scales with queue "
                        "depth over the recent admission drain rate), and "
                        "the Retry-After of a draining engine's 503s")
    p.add_argument("--fair-share", action="store_true",
                   help="per-tenant deficit-round-robin scheduling: split "
                        "the prefill token budget across tenants with "
                        "pending work by weight and a weighted-fair "
                        "admission dequeue, so one flooding tenant queues "
                        "behind everyone else instead of starving them. "
                        "With a single active tenant the schedule is "
                        "bit-identical to FCFS")
    p.add_argument("--tenant-weights", default=None,
                   help="JSON object tenant -> relative weight for "
                        "--fair-share and stage-3 brownout shedding, e.g. "
                        "'{\"team-a\": 3, \"team-b\": 1}'; unlisted "
                        "tenants weigh 1.0")
    p.add_argument("--brownout", action="store_true",
                   help="staged brownout degradation under sustained "
                        "pressure (queue depth, device memory, watchdog "
                        "stall): stage 1 sheds speculative-decode grants, "
                        "stage 2 clamps max_tokens and pauses KV "
                        "prefetch, stage 3 sheds over-weight tenants' new "
                        "admissions; recovery needs sustained calm")
    p.add_argument("--brownout-interval", type=float, default=2.0,
                   help="seconds between brownout pressure evaluations")
    p.add_argument("--brownout-queue-high", type=float, default=0.5,
                   help="waiting/max-queue-len fraction treated as hot")
    p.add_argument("--brownout-hbm-high", type=float, default=0.92,
                   help="device memory used/total fraction treated as hot")
    p.add_argument("--brownout-up-evals", type=int, default=2,
                   help="consecutive hot evaluations per stage up")
    p.add_argument("--brownout-calm-evals", type=int, default=3,
                   help="consecutive calm evaluations per stage down")
    p.add_argument("--brownout-max-tokens-clamp", type=int, default=256,
                   help="stage-2 per-request max_tokens ceiling")
    p.add_argument("--drain-deadline", type=float, default=30.0,
                   help="graceful-drain budget (seconds): on SIGTERM or "
                        "POST /drain, in-flight sequences get this long "
                        "to finish before stragglers are aborted (KV "
                        "blocks freed) and the process exits; readiness "
                        "(GET /ready) answers 503 for the whole window "
                        "while /health stays truthful")
    p.add_argument("--watchdog-stall-seconds", type=float, default=0.0,
                   help="stuck-step watchdog: flip readiness (GET /ready) "
                        "to 503 when no scheduler step completes for this "
                        "many seconds while work is queued. 0 = disabled")
    p.add_argument("--no-diagnostics", dest="diagnostics",
                   action="store_false", default=True,
                   help="disable anomaly-triggered diagnostic bundles "
                        "(engine/diagnostics.py: an unexpected recompile, "
                        "a watchdog stall, a drain-deadline abort, device-"
                        "memory pressure and a cost-model drift episode "
                        "each capture evidence to GET /debug/diagnostics)")
    p.add_argument("--diagnostics-dir", default="",
                   help="bundle archive directory (default: a per-pid "
                        "directory under the system tmpdir)")
    p.add_argument("--diagnostics-max-bundles", type=int, default=16,
                   help="bundle count retention cap; oldest evicted first")
    p.add_argument("--diagnostics-max-bytes", type=int,
                   default=256 * 1024 * 1024,
                   help="bundle archive size cap in bytes")
    p.add_argument("--diagnostics-cooldown", type=float, default=60.0,
                   help="minimum seconds between captures of the SAME "
                        "trigger (a recompile storm produces one bundle, "
                        "not a bundle a recompile)")
    p.add_argument("--diagnostics-profile-seconds", type=float, default=2.0,
                   help="torch.profiler trace length captured into each "
                        "bundle (capped at 10; 0 disables the trace: the "
                        "JSON snapshots are still captured)")
    p.add_argument("--diagnostics-hbm-threshold", type=float, default=0.92,
                   help="device memory allocated/total fraction that fires "
                        "the hbm_pressure capture trigger")
    p.add_argument("--otel-endpoint", default=None,
                   help="OTLP gRPC endpoint; engine spans JOIN the "
                        "router's trace through the propagated traceparent "
                        "(needs opentelemetry-sdk; propagation only "
                        "without it, a no-op without opentelemetry-api)")
    p.add_argument("--otel-service-name", default="tpu-engine")
    p.add_argument("--otel-secure", action="store_true",
                   help="use TLS for the OTLP exporter connection")
    p.add_argument("--flight-recorder-size", type=int, default=256,
                   help="per-request timelines kept in the /debug/requests "
                        "ring buffer")
    p.add_argument("--no-perf-accounting", dest="perf_accounting",
                   action="store_false", default=True,
                   help="disable live goodput accounting (MFU / HBM "
                        "bandwidth gauges, compile-event tracking, "
                        "GET /debug/perf — engine/perf_accounting.py)")
    p.add_argument("--perf-window", type=float, default=60.0,
                   help="sliding window (seconds) the utilization gauges "
                        "are computed over")
    p.add_argument("--no-tenant-metering", dest="tenant_metering",
                   action="store_false", default=True,
                   help="disable per-tenant token/chip-second attribution "
                        "(vllm:tenant_* series, GET /debug/tenants, usage "
                        "ledger — tenancy.py). Observe-only either way: "
                        "total metrics are the same with metering on or "
                        "off")
    p.add_argument("--tenant-top-k", type=int, default=8,
                   help="tenants exported individually per metric; the "
                        "remainder folds into tenant=\"other\" (bounded "
                        "label cardinality)")
    p.add_argument("--tenant-ledger-path", default="",
                   help="rotating JSONL usage-ledger path (one record per "
                        "finished request: tenant, model, tokens by phase, "
                        "chip-seconds, stage stamps); empty = ledger off")
    p.add_argument("--tenant-ledger-max-bytes", type=int, default=16 << 20,
                   help="ledger rotation threshold in bytes")
    p.add_argument("--perf-peak-tflops", type=float, default=0.0,
                   help="the card's peak TFLOP/s for MFU; 0 = the H100 SXM "
                        "data sheet's dense bf16 (989)")
    p.add_argument("--perf-peak-hbm-gbps", type=float, default=0.0,
                   help="the card's peak HBM GB/s; 0 = the H100 SXM data "
                        "sheet's (3350)")
    p.add_argument("--perf-peak-ici-gbps", type=float, default=0.0,
                   help="per-card interconnect GB/s for the collective "
                        "roofline; 0 = the H100 SXM data sheet's NVLink, "
                        "per direction (450)")
    p.add_argument("--perf-ledger-path", default="",
                   help="rotating JSONL perf-ledger path (fingerprint-"
                        "stamped accountant snapshots journaled every "
                        "--perf-ledger-interval seconds and on drain: "
                        "perf_ledger.py); empty = ledger off")
    p.add_argument("--perf-ledger-max-bytes", type=int, default=16 << 20,
                   help="perf-ledger rotation threshold in bytes")
    p.add_argument("--perf-ledger-interval", type=float, default=60.0,
                   help="seconds between periodic perf-ledger journal "
                        "entries")
    p.add_argument("--costmodel-drift-band", type=float, default=0.0,
                   help="cost-model drift band: sustained excursion of "
                        "the windowed measured/predicted dispatch-seconds "
                        "ratio beyond this factor of its post-warmup "
                        "baseline fires the costmodel_drift anomaly (a "
                        "diagnostics bundle). <=1 (default 0) = detection "
                        "off; the vllm:costmodel_* gauges export "
                        "regardless")
    p.add_argument("--host-offload-blocks", type=int, default=0,
                   help="host-DRAM KV tier capacity in blocks (0 = off; "
                        "prefer --kv-host-cache-bytes)")
    p.add_argument("--kv-host-cache-bytes", type=int, default=0,
                   help="host-DRAM KV tier capacity in bytes (overrides "
                        "--host-offload-blocks when both are set)")
    p.add_argument("--kv-prefetch-workers", type=int, default=0,
                   help="threads of the tier prefix-prefetch pipeline "
                        "(0 = the config default, 2)")
    p.add_argument("--remote-kv-url", default=None,
                   help="shared remote KV server URL "
                        "(python -m production_stack_tpu_torch.kv_server)")
    p.add_argument("--role", default="unified",
                   choices=["unified", "prefill", "decode"],
                   help="role in a disaggregated deployment: 'prefill' "
                        "runs prompts to their first token and pushes the "
                        "KV to a decode engine (POST {decode}/kv/recv), "
                        "'decode' takes pushed transfers and splices them "
                        "in decode-ready, 'unified' (default) does both. "
                        "Advisory for routing: every role serves the whole "
                        "OpenAI surface")
    p.add_argument("--kv-transfer-group-layers", type=int, default=0,
                   help="layers a KV-transfer frame; 0 = half the stack")
    p.add_argument("--kv-transfer-window", type=int, default=2,
                   help="producer-side layer-group gathers in flight ahead "
                        "of the frame being sent")
    p.add_argument("--kv-transfer-retries", type=int, default=3,
                   help="attempts a push; a digest mismatch resumes from "
                        "the first layer group that did not land")
    p.add_argument("--kv-transfer-ttl", type=float, default=120.0,
                   help="seconds a received, unattached transfer may hold "
                        "KV blocks before the sweep frees them")
    # multi-host serving: defaults come from the environment
    # (PSTPU_COORDINATOR, PSTPU_NUM_PROCESSES, PSTPU_PROCESS_ID,
    # PSTPU_CONTROL_PORT), so the chart's StatefulSet wires them without
    # templating argv (parallel/distributed.py DistributedConfig)
    p.add_argument("--distributed-coordinator", default=None,
                   help="host:port of process 0's rendezvous store "
                        "(multi-host serving; env PSTPU_COORDINATOR)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="processes in the multi-host group, one a rank: "
                        "the tensor size times the sequence size (env "
                        "PSTPU_NUM_PROCESSES)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's id; 0 serves HTTP and leads, "
                        ">0 replays step plans (env PSTPU_PROCESS_ID)")
    p.add_argument("--control-port", type=int, default=None,
                   help="the leader's step-plan channel port "
                        "(engine/multihost.py; env PSTPU_CONTROL_PORT)")
    p.add_argument("--config", default=None,
                   help="YAML file of flag values (keys = flag names); "
                        "explicit flags win (yaml_args.py; needs PyYAML "
                        "only when given)")
    # scheduler switches the reference's server has no flag for: only a
    # --config file sets them (yaml_args.py, config-only keys)
    p.set_defaults(chain_decode=False, decode_graphs=True)
    return p


def _mesh_from_args(args, processes: Optional[int] = None) -> MeshConfig:
    """The parallel sizes of the command line: pipeline stages and seq
    ranks as given, tensor parallelism resolved on the engine's device
    (parallel/mesh.tensor_size, over the cards left to each seq rank or
    stage), or, in a multi-host group of ``processes``, over the processes
    left to each seq rank (``multihost.check_group`` then holds the count
    to the mesh's). Any two or three of them above 1 make one process grid
    (parallel/distributed.py ``Grid``); data parallelism above 1 exits,
    not ported."""
    if args.data_parallel_size > 1:
        raise SystemExit(f"--data-parallel-size {args.data_parallel_size}: "
                         "data parallelism is not ported to the PyTorch "
                         "engine (tensor, pipeline and sequence "
                         "parallelism are)")
    pp, sp = args.pipeline_parallel_size, args.sequence_parallel_size
    tensor = args.tensor_parallel_size
    if processes is not None and tensor == -1:
        tensor = max(processes // max(sp, 1), 1)
    try:
        tp = tensor_size(MeshConfig(stage=pp, seq=sp, tensor=tensor),
                         args.device)
    except ValueError as e:
        raise SystemExit(f"--tensor-parallel-size / --pipeline-parallel-"
                         f"size / --sequence-parallel-size: {e}")
    return MeshConfig(stage=pp, seq=sp, tensor=tp)


# each parallel axis's command-line flag, ``--<name>-parallel-size``
_FLAG_NAMES = {AXIS_STAGE: "pipeline", AXIS_SEQ: "sequence",
               AXIS_TENSOR: "tensor"}


def _flags(grid: pdist.Grid) -> str:
    """The flags that ask for ``grid``'s axes above 1."""
    return " ".join(f"--{_FLAG_NAMES[a]}-parallel-size {grid.shape[a]}"
                    for a in grid.axes if a in _FLAG_NAMES)


def config_from_args(args, processes: Optional[int] = None) -> EngineConfig:
    """The engine's config from parsed flags (``processes``: the
    multi-host group's process count, ``_mesh_from_args``)."""
    mesh = _mesh_from_args(args, processes)
    overrides = {}
    if args.max_model_len is not None:
        overrides["max_model_len"] = args.max_model_len
    if args.dtype is not None:
        overrides["dtype"] = args.dtype
    if args.quantization:
        overrides["quant"] = args.quantization
    cache = CacheConfig(host_offload_blocks=args.host_offload_blocks,
                        kv_host_cache_bytes=args.kv_host_cache_bytes,
                        remote_kv_url=args.remote_kv_url or None)
    if args.kv_prefetch_workers:
        cache.kv_prefetch_workers = args.kv_prefetch_workers
    if args.block_size is not None:
        cache.block_size = args.block_size
    if args.num_blocks is not None:
        cache.num_blocks = args.num_blocks
    sched = SchedulerConfig(chain_decode=args.chain_decode,
                            decode_graphs=args.decode_graphs)
    if mesh.seq > 1:
        sched.ring_prefill_threshold = args.ring_prefill_threshold
    if args.max_num_seqs is not None:
        sched.max_num_seqs = args.max_num_seqs
    if args.max_num_batched_tokens is not None:
        sched.max_num_batched_tokens = args.max_num_batched_tokens
    if args.num_scheduler_steps is not None:
        sched.multi_step = args.num_scheduler_steps
    if args.prefill_batch:
        sched.prefill_batch = args.prefill_batch
    if args.prefill_buckets:
        sched.prefill_buckets = tuple(
            int(x) for x in args.prefill_buckets.split(","))
    if args.attention_impl:
        overrides["attention_impl"] = args.attention_impl
    if args.speculative_ngram:
        sched.spec_ngram_k = args.speculative_ngram
        sched.spec_ngram_max = args.speculative_ngram_max
        sched.spec_ngram_min = args.speculative_ngram_min
        sched.spec_window = args.speculative_window
    if args.max_queue_len is not None:
        sched.max_queue_len = args.max_queue_len
    sched.fair_share = args.fair_share
    if args.tenant_weights:
        try:
            weights = json.loads(args.tenant_weights)
        except ValueError as e:
            raise SystemExit(f"--tenant-weights is not valid JSON: {e}")
        if not isinstance(weights, dict):
            raise SystemExit("--tenant-weights must be a JSON object "
                             "(tenant -> weight)")
        sched.tenant_weights = weights
    perf = PerfConfig(enabled=args.perf_accounting)
    if args.perf_window:
        perf.window = args.perf_window
    if args.perf_peak_tflops:
        perf.peak_tflops = args.perf_peak_tflops
    if args.perf_peak_hbm_gbps:
        perf.peak_hbm_gbps = args.perf_peak_hbm_gbps
    if args.perf_peak_ici_gbps:
        perf.peak_ici_gbps = args.perf_peak_ici_gbps
    perf.costmodel_drift_band = args.costmodel_drift_band or 0.0
    config = EngineConfig.for_model(
        args.model, cache=cache, scheduler=sched, seed=args.seed, perf=perf,
        role=args.role,
        kv_transfer_group_layers=args.kv_transfer_group_layers,
        kv_transfer_window=args.kv_transfer_window,
        kv_transfer_retries=args.kv_transfer_retries,
        kv_transfer_ttl=args.kv_transfer_ttl,
        tenant_metering=args.tenant_metering,
        tenant_top_k=args.tenant_top_k or 8,
        tenant_ledger_path=args.tenant_ledger_path or "",
        tenant_ledger_max_bytes=args.tenant_ledger_max_bytes or (16 << 20),
        perf_ledger_path=args.perf_ledger_path or "",
        perf_ledger_max_bytes=args.perf_ledger_max_bytes or (16 << 20),
        perf_ledger_interval=args.perf_ledger_interval or 60.0,
        mesh=mesh, **overrides)
    grid = pdist.Grid.of(mesh, mesh.tensor)
    if tp_refusal(config, grid) is not None:
        raise SystemExit(f"Whisper under {grid.parallelism} is a later slice "
                         f"of the PyTorch engine ({_flags(grid)}, --model "
                         f"{config.model.name})")
    return config


def brownout_from_args(args) -> Optional[BrownoutController]:
    """The staged-brownout controller of the command line's flags (None
    when ``--brownout`` is off, the default)."""
    if not args.brownout:
        return None
    return BrownoutController(BrownoutConfig(
        enabled=True,
        interval=args.brownout_interval,
        queue_high=args.brownout_queue_high,
        hbm_high=args.brownout_hbm_high,
        up_evals=args.brownout_up_evals,
        calm_evals=args.brownout_calm_evals,
        max_tokens_clamp=args.brownout_max_tokens_clamp,
    ))


def diagnostics_config_from_args(args) -> DiagnosticsConfig:
    return DiagnosticsConfig(
        enabled=args.diagnostics,
        dir=args.diagnostics_dir,
        max_bundles=args.diagnostics_max_bundles,
        max_bytes=args.diagnostics_max_bytes,
        cooldown=args.diagnostics_cooldown,
        profile_seconds=args.diagnostics_profile_seconds,
        hbm_threshold=args.diagnostics_hbm_threshold,
    )


def distributed_from_args(args) -> DistributedConfig:
    """The multi-host topology of the flags, the environment filling what
    they leave out (the reference's ``DistributedConfig.from_env``)."""
    return DistributedConfig.from_env(
        coordinator=args.distributed_coordinator,
        num_processes=args.num_processes, process_id=args.process_id,
        control_port=args.control_port)


def check_multihost(args) -> None:
    """The server's own start-up refusals of a multi-host process, first
    of all and in the reference's order: no secret (before anything
    touches the card), then the host or remote KV tier. The rest of the
    policy is ``multihost.check_group``'s (``_multihost_config``)."""
    try:
        control_secret()  # fail fast: no secret, no multi-host
    except ValueError as e:
        raise SystemExit(str(e))
    if args.host_offload_blocks or args.kv_host_cache_bytes or \
            args.remote_kv_url:
        raise SystemExit(
            "multi-host serving does not yet compose with the host-offload "
            "/ remote-KV tiers (their device transfers run outside the "
            "mirrored runner)")


def _multihost_config(args, dcfg: DistributedConfig) -> EngineConfig:
    """The engine's config in a multi-host group, its tensor size
    resolved over the processes (``config_from_args``); what the group
    cannot run exits (``multihost.check_group``: pipeline stages, no
    coordinator, Whisper, a process count other than the mesh's)."""
    config = config_from_args(args, dcfg.num_processes)
    try:
        check_group(config, dcfg, pdist.Grid.of(config.mesh,
                                                config.mesh.tensor))
    except ValueError as e:
        raise SystemExit(str(e))
    return config


def _follower_main(args, dcfg: DistributedConfig,
                   rank_devices: Optional[list] = None,
                   backend: Optional[str] = None) -> None:
    """A multi-host follower (the reference's ``_follower_main``): serve
    a minimal ``/health`` for the orchestrator's probes, build the same
    runner shard in the same order as the leader, and replay the leader's
    calls until the channel closes."""
    config = _multihost_config(args, dcfg)
    body = json.dumps({"status": "follower",
                       "process_id": dcfg.process_id}).encode()

    class Health(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            self.send_response(200 if self.path == "/health" else 404)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer((args.host, args.port), Health)
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="follower-health").start()
    try:
        follow_leader(config, dcfg, args.device, rank_devices, backend,
                      pdist.Grid.of(config.mesh, config.mesh.tensor))
    finally:
        httpd.shutdown()
        httpd.server_close()
    _log.info("process %d: the leader's channel closed; exiting",
              dcfg.process_id)


def server_from_args(args, rank_devices: Optional[list] = None,
                     backend: Optional[str] = None,
                     stage_devices: Optional[list] = None,
                     distributed: Optional[DistributedConfig] = None):
    """The server ``main`` runs for parsed command-line ``args``, not yet
    bound: the warmup starts at ``bind`` unless ``--skip-warmup``. A
    Whisper model gets its own runner and server
    (engine/whisper_server.py); the paged text engine never starts.
    ``rank_devices`` and ``backend`` place the processes of the mesh's
    grid (parallel/distributed.py ``Grid``) by global rank (default: rank
    r on ``cuda:r`` over NCCL, or the CPU over gloo); a rank whose card
    does not exist exits before any rank starts. With pipeline stages
    alone ``stage_devices`` places the stages of the one process
    (default: stage s on ``cuda:s``, or the CPU); a stage whose card does
    not exist exits before any weight is made. A multi-host
    ``distributed`` topology makes the server its process 0
    (``rank_devices``: this process's device,
    ``multihost.process_device``), and what the group cannot run exits
    (``_multihost_config``)."""
    multi = distributed is not None and distributed.enabled
    config = (_multihost_config(args, distributed) if multi
              else config_from_args(args))
    mesh = config.mesh
    grid = pdist.Grid.of(mesh, mesh.tensor)
    # the stages are processes where another axis is above 1, and one
    # process's devices otherwise
    staged = grid.axes == (AXIS_STAGE,)
    if multi:
        try:
            pdist.check_devices(
                [process_device(args.device, distributed, rank_devices)],
                grid.parallelism)
        except (RuntimeError, ValueError) as e:
            raise SystemExit(f"--num-processes {distributed.num_processes}:"
                             f" {e}")
    elif grid.size > 1 and not staged:
        try:
            pdist.check_devices(
                rank_devices or pdist.rank_devices(args.device, grid.size),
                grid.parallelism)
        except RuntimeError as e:
            raise SystemExit(f"{_flags(grid)}: {e}")
    if staged:
        try:
            stage_devices = pstage_devices(args.device, grid.stage,
                                           stage_devices)
        except (RuntimeError, ValueError) as e:
            raise SystemExit(f"--pipeline-parallel-size {grid.stage}: {e}")
    if config.model.architecture == "whisper":
        from production_stack_tpu_torch.engine.whisper_server import (
            WhisperServer,
        )

        return WhisperServer(config, device=args.device,
                             served_model_name=args.served_model_name,
                             rank_devices=rank_devices, backend=backend)
    fault_spec = args.fault_injection
    if fault_spec is None:
        fault_spec = os.environ.get("FAULT_INJECTION")
    return EngineServer(config, device=args.device,
                        served_model_name=args.served_model_name,
                        warmup_on_start=not args.skip_warmup,
                        overload_retry_after=args.overload_retry_after,
                        drain_deadline=args.drain_deadline,
                        watchdog_stall_seconds=args.watchdog_stall_seconds,
                        fault_injection=fault_spec,
                        brownout=brownout_from_args(args),
                        otel_endpoint=args.otel_endpoint,
                        otel_service_name=args.otel_service_name,
                        otel_secure=args.otel_secure,
                        flight_recorder_size=args.flight_recorder_size,
                        diagnostics=diagnostics_config_from_args(args),
                        rank_devices=rank_devices, backend=backend,
                        stage_devices=stage_devices,
                        distributed=distributed if multi else None)


def main(argv=None, rank_devices: Optional[list] = None,
         backend: Optional[str] = None,
         stage_devices: Optional[list] = None) -> None:
    """The command line's server (``rank_devices``, ``backend`` and
    ``stage_devices``: see ``server_from_args``). In a multi-host group
    the start-up refusals come first (``check_multihost``, then
    ``_multihost_config``); a follower
    then replays the leader's calls (``_follower_main``) and returns when
    the channel closes."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    args = parse_with_yaml_config(build_parser(), argv)
    dcfg = distributed_from_args(args)
    if dcfg.enabled:
        check_multihost(args)
        if not dcfg.is_leader:
            _follower_main(args, dcfg, rank_devices, backend)
            return
    server = server_from_args(args, rank_devices, backend, stage_devices,
                              dcfg)
    port = server.bind(args.host, args.port)
    if server.config.model.architecture == "whisper":
        _log.info("serving %s (whisper) on %s:%d (device %s)",
                  server.model_name, args.host, port, server.runner.device)
        # SIGTERM stops serving; in-flight transcriptions end with it
        signal.signal(signal.SIGTERM, lambda signum, frame: threading.Thread(
            target=server.stop_serving, daemon=True).start())
        try:
            server.serve_forever()
        finally:
            server.shutdown()
        return
    _log.info("serving %s on %s:%d (device %s, %d KV blocks)",
              server.model_name, args.host, port, server.engine.device,
              server.engine.runner.num_blocks)

    def _exit_when_drained():
        server.wait_drained()
        time.sleep(0.1)  # a beat for handlers to deliver their last bytes
        server.stop_serving()

    def _term(signum, frame):
        # SIGTERM drains: in-flight requests finish under --drain-deadline
        # (a drain already started by POST /drain is joined), then the
        # server stops and the process exits 0
        server.begin_drain("sigterm")
        threading.Thread(target=_exit_when_drained, daemon=True,
                         name="exit-when-drained").start()

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
