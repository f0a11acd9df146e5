"""The port's hand-written ``/metrics`` exposition against the JAX
package's ``prometheus_client`` one, on the CPU.

The JAX engine and the port's engine, on the same tiny-llama weights and
the ragged path with n-gram speculation, serve the same requests of two
tenants to the end, a repeated prompt among them. Both expositions are
parsed with ``prometheus_client.parser``:

- every port family is a JAX family of the same type and label names;
- the JAX families the port lacks are exactly ``NOT_PORTED``, which is
  empty: the port writes every family;
- the engine-state samples are equal, as are the histograms' bucket edges
  and counts after the same observations (the KV-transfer families by
  direction among them);
- with a host KV tier on both engines, after the same A/B/A waves, the
  tier families (hit ratio by tier, bytes by tier and direction, the
  prefetch histogram's edges and count) and the CPU cache samples are
  equal;
- the router's ``EngineStats.from_scrape`` reads both texts alike;
- the tenant families (tokens by tenant and phase, KV blocks, the queue
  summary's counts) are equal, and the port's chip-seconds by tenant sum
  to its attributed dispatch seconds; the overload families carry the same
  snapshot alike, as do the diagnostics families the same
  ``DiagnosticsManager.stats()`` snapshot.
"""

import types

import pytest
import torch
from prometheus_client.parser import text_string_to_metric_families

from _torch_parity import drain, engine_configs, jax_engine, port_engine, \
    tiny_weights
from production_stack_tpu.engine.metrics import ServerMetrics as JaxMetrics
from production_stack_tpu.router.protocols import EngineStats
from production_stack_tpu_torch.engine.metrics import (
    CONTENT_TYPE,
    Family,
    ServerMetrics,
    format_value,
)
from production_stack_tpu_torch.engine.sampling import SamplingParams

torch.set_num_threads(2)

MODEL = "tiny-llama"
NOT_PORTED: set = set()
# samples of engine state both engines must give alike
STATE = (
    "vllm:num_requests_running", "vllm:num_requests_waiting",
    "vllm:gpu_cache_usage_perc", "vllm:gpu_prefix_cache_hit_rate",
    "vllm:gpu_prefix_cache_hits_total", "vllm:gpu_prefix_cache_queries_total",
    "vllm:prompt_tokens_total", "vllm:generation_tokens_total",
    "vllm:kv_blocks_total", "vllm:kv_blocks_free", "vllm:batch_occupancy",
    "vllm:ragged_dispatches_total", "vllm:ragged_live_tokens_total",
    "vllm:ragged_stream_utilization",
    "vllm:spec_decode_num_draft_tokens_total",
    "vllm:spec_decode_num_accepted_tokens_total",
    "vllm:spec_decode_acceptance_rate", "vllm:spec_decode_tokens_per_step",
    "vllm:aborted_seqs_total", "vllm:cpu_cache_usage_perc",
    "vllm:cpu_prefix_cache_hits_total", "vllm:spliced_seqs_total",
)
LIFECYCLE = {"draining": True, "drain_rejected_total": 3,
             "drain_aborted_total": 1, "watchdog_stalled": False,
             "watchdog_stalls_total": 2, "warming": False,
             "warmup_seconds": 12.5}
GREEDY = SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)
MOTIF = [31, 32, 33, 34]
# two tenants, the second sending one request
FIRST = [("long", list(range(1, 50)), GREEDY, 0, "team-a"),
         ("loop", MOTIF * 4, GREEDY, 0, "team-a"),
         ("short", [7, 8, 9, 10, 11, 12, 13], GREEDY, 0, "team-b")]
# the long prompt again: its full blocks hit the prefix cache
AGAIN = [("again", list(range(1, 50)), GREEDY, 0, "team-a")]
DIAGNOSTICS = {"bundles_total": {"unexpected_recompile": 2, "manual": 1},
               "dropped_total": {"hbm_pressure": 4},
               "capture_seconds_count": 3, "capture_seconds_sum": 1.75}
OVERLOAD = {"brownout": {"enabled": True, "stage": 2,
                         "sheds": {"spec": 3, "tenant": 1}},
            "shed_tenants": [],
            "fair_share": {"enabled": True,
                           "deficits": {"team-a": 1.5, "team-b": 0.25},
                           "admit_pass": {}}}


def _finished(arrival=1.0):
    return types.SimpleNamespace(
        arrival_time=arrival, admit_time=arrival + 0.004,
        first_token_time=arrival + 0.07, finish_time=arrival + 1.9,
        num_output_tokens=24)


def _observe(metrics):
    """The same observations on either package's ServerMetrics."""
    for i, d in enumerate((0.0004, 0.003, 0.02, 0.3, 7.0)):
        metrics.observe_step(d)
        metrics.observe_request(1.0, 1.0 + d, 2.5 + d, 3 + i)
        metrics.observe_stages(_finished(1.0 + d))
    metrics.observe_request(1.0, None, 1.2, 0)
    # KV transfers, each direction first seen in sorted order (the port
    # writes directions sorted, prometheus_client in first-seen order)
    for direction, nbytes, secs in (("export", 4096, 0.004),
                                    ("push", 1 << 20, 0.02),
                                    ("recv", 1 << 20, 0.03),
                                    ("push", 3 << 20, 0.3),
                                    ("export", 1 << 26, 7.5)):
        metrics.observe_transfer(direction, nbytes, secs)


@pytest.fixture(scope="module")
def texts():
    weights = tiny_weights()
    jconf, tconf = engine_configs("ragged", max_num_seqs=4,
                                  max_num_batched_tokens=32, spec_ngram_k=4)
    jeng = jax_engine(weights, jconf)
    teng = port_engine(weights, tconf)
    for reqs in (FIRST, AGAIN):
        assert drain(jeng, reqs)[0] == drain(teng, reqs)[0]
    assert teng.spec_accepted > 0 and teng.scheduler.allocator.prefix_hits
    jm = JaxMetrics(jeng, MODEL)
    jm.register_lifecycle(lambda: dict(LIFECYCLE))
    jm.register_overload(lambda: OVERLOAD)
    jm.register_diagnostics(lambda: DIAGNOSTICS)
    tm = ServerMetrics(teng, MODEL)
    tm.register_lifecycle(lambda: dict(LIFECYCLE))
    tm.register_overload(lambda: OVERLOAD)
    tm.register_diagnostics(lambda: DIAGNOSTICS)
    for m in (jm, tm):
        _observe(m)
    return (jm.generate().decode(), tm.generate().decode(),
            dict(teng.tenant_stats(), totals=teng.perf.snapshot()["totals"]))


def _families(text):
    return {f.name: f for f in text_string_to_metric_families(text)}


def _label_names(fam):
    return {k for s in fam.samples for k in s.labels if k != "le"}


def _samples(text):
    return {(s.name, tuple(sorted(s.labels.items()))): s.value
            for f in text_string_to_metric_families(text) for s in f.samples}


def test_every_port_family_is_a_reference_family(texts):
    jax_text, port_text, _ = texts
    jf, tf = _families(jax_text), _families(port_text)
    assert all(name.startswith("vllm:") for name in tf)
    for name, fam in tf.items():
        assert name in jf, name
        assert fam.type == jf[name].type, name
        assert fam.samples, name
        assert _label_names(fam) == _label_names(jf[name]), name
    # prometheus_client also writes each histogram's creation time as a
    # gauge family ``<name>_created``: bookkeeping of that library, which
    # the port does not write
    created = {n for n in jf if n.endswith("_created")}
    assert {n[: -len("_created")] for n in created} <= set(tf)
    assert set(jf) - set(tf) - created == NOT_PORTED


def test_engine_state_samples_equal(texts):
    jax_text, port_text, _ = texts
    js, ts = _samples(jax_text), _samples(port_text)
    labels = (("model_name", MODEL),)
    for name in STATE:
        assert ts[(name, labels)] == pytest.approx(js[(name, labels)],
                                                   rel=1e-12), name
    assert ts[("vllm:gpu_prefix_cache_hits_total", labels)] > 0
    assert ts[("vllm:spec_decode_num_accepted_tokens_total", labels)] > 0
    # the lifecycle families carry the server's snapshot
    for name in ("vllm:drain_state", "vllm:drain_rejected_requests_total",
                 "vllm:drain_aborted_seqs_total", "vllm:watchdog_stalled",
                 "vllm:watchdog_stalls_total", "vllm:engine_warming",
                 "vllm:engine_warmup_seconds"):
        assert ts[(name, labels)] == js[(name, labels)], name
    # the collective bytes are zero on one card, in both
    for op in ("all_gather", "all_reduce"):
        key = ("vllm:collective_bytes_total",
               (("model_name", MODEL), ("op", op)))
        assert ts[key] == js[key] == 0.0


def test_histograms_match(texts):
    jax_text, port_text, _ = texts
    jf, tf = _families(jax_text), _families(port_text)
    hists = [n for n, f in tf.items() if f.type == "histogram"]
    assert len(hists) == 9
    for name in hists:
        def edges(f):
            return [float(s.labels["le"]) for s in f.samples
                    if s.name == name + "_bucket"]

        def series(f):
            return {s.name: s.value for s in f.samples
                    if not s.name.endswith("_created")
                    and s.name != name + "_bucket"}

        assert edges(tf[name]) == edges(jf[name]), name
        assert edges(tf[name])[-1] == float("inf")
        counts = [s.value for s in tf[name].samples
                  if s.name == name + "_bucket"]
        assert counts == [s.value for s in jf[name].samples
                          if s.name == name + "_bucket"], name
        by_series: dict = {}
        for smp in tf[name].samples:
            if smp.name == name + "_bucket":
                key = tuple(sorted((k, v) for k, v in smp.labels.items()
                                   if k != "le"))
                by_series.setdefault(key, []).append(smp.value)
        for c in by_series.values():
            assert c == sorted(c)  # cumulative within each series
        assert series(tf[name]) == pytest.approx(series(jf[name]),
                                                 rel=1e-12), name


def test_engine_stats_from_scrape_equal(texts):
    jax_text, port_text, _ = texts
    want = EngineStats.from_scrape(jax_text)
    got = EngineStats.from_scrape(port_text)
    assert got == want
    assert got.gpu_prefix_cache_queries_total > 0


@pytest.mark.parametrize("value, text", [
    (3, "3.0"), (0.25, "0.25"), (float("inf"), "+Inf"),
    (float("-inf"), "-Inf"), (1e-05, "1e-05")])
def test_format_value(value, text):
    assert format_value(value) == text


def test_exposition_escapes_and_parses():
    fam = Family("vllm:x", "counter", 'help with \\ and\nnewline',
                 ["model_name", "kind"])
    fam.add(['m"1', "a\\b\nc"], 2)
    text = fam.render()
    assert text.startswith("# HELP vllm:x_total help with \\\\ and\\n")
    parsed, = text_string_to_metric_families(text)
    assert parsed.name == "vllm:x" and parsed.type == "counter"
    sample, = parsed.samples
    assert sample.name == "vllm:x_total"
    assert sample.labels == {"model_name": 'm"1', "kind": "a\\b\nc"}
    assert sample.value == 2.0
    assert CONTENT_TYPE.startswith("text/plain; version=0.0.4")


def test_kv_transfer_samples_equal(texts):
    js, ts = _samples(texts[0]), _samples(texts[1])
    for d, nbytes in (("export", 4096 + (1 << 26)), ("push", 4 << 20),
                      ("recv", 1 << 20)):
        key = ("vllm:kv_transfer_bytes_total",
               (("direction", d), ("model_name", MODEL)))
        assert ts[key] == js[key] == nbytes
        key = ("vllm:kv_transfer_seconds_count",
               (("direction", d), ("model_name", MODEL)))
        assert ts[key] == js[key]


@pytest.fixture(scope="module")
def tier_texts():
    """Both engines with a host tier, through the same A/B/A waves."""
    import numpy as np

    weights = tiny_weights()
    jconf, tconf = engine_configs("ragged", num_blocks=40, max_num_seqs=4,
                                  max_num_batched_tokens=64)
    for c in (jconf.cache, tconf.cache):
        c.kv_host_cache_bytes = 10 ** 7
    jeng, teng = jax_engine(weights, jconf), port_engine(weights, tconf)
    rng = np.random.default_rng(7)
    a = [("a", rng.integers(1, 500, 30).tolist(), GREEDY)]
    b = [(f"b{i}", rng.integers(1, 500, 30).tolist(), GREEDY)
         for i in range(4)]
    for reqs in (a, b, [("a2", a[0][1], GREEDY)]):
        assert drain(jeng, reqs)[0] == drain(teng, reqs)[0]
    assert teng.host_kv.hits > 0
    out = JaxMetrics(jeng, MODEL).generate().decode(), \
        ServerMetrics(teng, MODEL).generate().decode()
    jeng._prefetcher.shutdown()
    teng.shutdown_tiers()
    return out


def test_tier_families_equal(tier_texts):
    jax_text, port_text = tier_texts
    jf, tf = _families(jax_text), _families(port_text)
    for name in ("vllm:kv_tier_hit_ratio", "vllm:kv_tier_bytes",
                 "vllm:kv_prefetch_seconds",
                 "vllm:kv_prefetch_overlap_fraction"):
        assert name in tf and tf[name].type == jf[name].type, name
        assert _label_names(tf[name]) == _label_names(jf[name]), name
    js, ts = _samples(jax_text), _samples(port_text)
    for key, value in js.items():
        name = key[0]
        if name.startswith(("vllm:kv_tier_", "vllm:cpu_")) or name in (
                "vllm:kv_prefetch_seconds_count",):
            assert ts[key] == pytest.approx(value, rel=1e-12), key
    edges = [k for k in js if k[0] == "vllm:kv_prefetch_seconds_bucket"]
    assert edges and all(k in ts for k in edges)
    assert ts[("vllm:cpu_prefix_cache_hits_total",
               (("model_name", MODEL),))] > 0


def test_tenant_and_overload_samples_equal(texts):
    jax_text, port_text, stats = texts
    js, ts = _samples(jax_text), _samples(port_text)

    def of(samples, prefix):
        return {k: v for k, v in samples.items() if k[0].startswith(prefix)}

    for prefix in ("vllm:tenant_tokens_total", "vllm:tenant_kv_blocks",
                   "vllm:tenant_queue_time_seconds_count",
                   "vllm:brownout_stage", "vllm:brownout_sheds_total",
                   "vllm:fair_share_deficit", "vllm:diagnostic_bundles_total",
                   "vllm:diagnostic_bundles_dropped_total",
                   "vllm:diagnostic_capture_seconds"):
        assert of(ts, prefix) == of(js, prefix), prefix
        assert of(ts, prefix), prefix
    tok = of(ts, "vllm:tenant_tokens_total")
    for phase in ("prefill", "decode"):
        # the tenants' tokens of a phase sum to the accountant's goodput
        # total of that phase (accepted drafts included in decode)
        part = sum(v for (_, lbl), v in tok.items()
                   if dict(lbl)["phase"] == phase)
        assert part == stats["totals"][f"{phase}_tokens"] > 0, phase
    tenants = {dict(lbl)["tenant"] for (_, lbl) in tok}
    assert tenants == {"team-a", "team-b"}
    chip = of(ts, "vllm:tenant_chip_seconds_total")
    assert sum(chip.values()) == pytest.approx(
        stats["dispatch_seconds_total"], rel=1e-9)
    assert set(of(js, "vllm:tenant_chip_seconds_total")) == set(chip)
