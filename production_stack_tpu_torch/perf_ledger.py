"""Durable performance ledger of the engine, a copy of
production_stack_tpu/perf_ledger.py with its record schema, so the
reference's consumers (``tools/perfdiff.py``, stacktop ``--history``,
``last_known_good``) read the port's file unchanged.

Every perf claim the engine makes is otherwise point-in-time: the
``PerfAccountant`` windows end with the process. This module gives them a
durable, append-only JSONL history:

* :class:`PerfLedger` — a :class:`tenancy.UsageLedger` (the same
  size-rotated, thread-safe, IO-never-raises discipline) with record
  helpers: perf journaling must never take the serving path down.
* :func:`fingerprint` / :func:`fingerprint_id` — the config cohort stamp.
  Two records are comparable ONLY when their fingerprints match. The id
  is a short stable hash of the canonical fingerprint JSON. The port's
  engine leaves ``jax_version`` empty and adds ``framework`` and
  ``torch_version`` through ``extra``, so a port cohort never mixes with
  a JAX one.
* :func:`engine_snapshot_record` / :func:`bench_record` — the two producer
  schemas, sharing the envelope {ts, kind, fingerprint, fingerprint_id,
  marks}. Engine records carry the windowed goodput and cost-model marks,
  journaled every ``--perf-ledger-interval`` seconds and once on drain.
* :func:`read_records` / :func:`group_by_cohort` / :func:`last_known_good`
  — the consumer side. Corrupt lines (a crash mid-append, a truncated
  rotation) are skipped and counted, never fatal.

No torch import here: reading a ledger needs no device.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from production_stack_tpu_torch.tenancy import UsageLedger

# schema version for forward-compat: consumers ignore records whose
# major version they do not understand instead of misreading them
SCHEMA = 1

ENGINE_KIND = "engine_snapshot"
BENCH_KIND = "bench"


# -- config fingerprint (the comparability cohort) --------------------------

def fingerprint(*, model: str = "", role: str = "unified",
                tensor_parallel: int = 1, attention_impl: str = "",
                dtype: str = "", quantization: str = "",
                speculative: bool = False, n_chips: int = 1,
                jax_version: str = "", platform: str = "",
                chip: str = "", extra: Optional[Mapping] = None) -> Dict:
    """Canonical config-cohort stamp for a perf record.

    Only fields that change the performance envelope belong here —
    adding a field splits every historical cohort, so the set is
    deliberately small and every producer fills what it knows (missing
    jax/chip identifiers degrade the cohort, they don't fail it)."""
    fp = {
        "schema": SCHEMA,
        "model": str(model or ""),
        "role": str(role or "unified"),
        "tensor_parallel": int(tensor_parallel or 1),
        "attention_impl": str(attention_impl or ""),
        "dtype": str(dtype or ""),
        "quantization": str(quantization or ""),
        "speculative": bool(speculative),
        "n_chips": int(n_chips or 1),
        "jax_version": str(jax_version or ""),
        "platform": str(platform or ""),
        "chip": str(chip or ""),
    }
    if extra:
        for k, v in sorted(extra.items()):
            fp.setdefault(str(k), v)
    return fp


def fingerprint_id(fp: Mapping) -> str:
    """Short stable id of a fingerprint — the cohort key tools group by."""
    canon = json.dumps(dict(fp), sort_keys=True, default=str)
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()[:12]


# -- record builders --------------------------------------------------------

def _envelope(kind: str, ts: float, fp: Mapping) -> Dict:
    return {
        "schema": SCHEMA,
        "kind": kind,
        "ts": float(ts),
        "fingerprint": dict(fp),
        "fingerprint_id": fingerprint_id(fp),
    }


def engine_snapshot_record(ts: float, fp: Mapping, marks: Mapping, *,
                           reason: str = "interval") -> Dict:
    """One periodic (or drain-time) engine journal entry.

    ``marks`` is the flat windowed-goodput dict the accountant exports
    (mfu, hbm_bw_util, prefill_tps, decode_tps, costmodel ratios,
    dispatch/compile totals, ...); ``reason`` records why the entry
    exists ("interval" | "drain")."""
    rec = _envelope(ENGINE_KIND, ts, fp)
    rec["reason"] = str(reason)
    rec["marks"] = dict(marks)
    return rec


def bench_record(ts: float, fp: Mapping, artifact: Mapping) -> Dict:
    """One bench run — ok or infra_failure — in the shared schema.

    Successful runs carry the headline marks (value tok/s/chip plus the
    scenario summaries); infra failures carry status/failure_class and
    the claim telemetry (attempts, total wait, pool state) so the
    trajectory records *why* the mark is missing."""
    rec = _envelope(BENCH_KIND, ts, fp)
    status = str(artifact.get("status", "ok"))
    rec["status"] = status
    marks: Dict[str, object] = {}
    if status == "ok":
        if artifact.get("value") is not None:
            marks["value_tok_s_chip"] = artifact.get("value")
        for name, block in sorted((artifact.get("scenarios") or {}).items()):
            if isinstance(block, Mapping):
                for key in ("tok_s_chip", "mfu", "p50_ms", "p99_ms"):
                    if block.get(key) is not None:
                        marks[f"{name}.{key}"] = block[key]
    else:
        rec["failure_class"] = str(artifact.get("failure_class", "unknown"))
        for key in ("attempts", "claim_window_s", "pool_state"):
            if artifact.get(key) is not None:
                rec[key] = artifact[key]
    rec["marks"] = marks
    return rec


def marks_from_engine_stats(stats: Mapping) -> Dict:
    """Flatten one ``LLMEngine.stats()`` document into ledger marks.

    Two families on purpose: throughput/utilization marks (meaningful
    per cohort on real hardware) and the CPU-stable invariants the CI
    gate pins (dispatch counts, scheduled-token identity, recompile
    count, stream utilization)."""
    marks: Dict[str, object] = {}
    for key in ("prompt_tokens_total", "generation_tokens_total",
                "ragged_dispatches_total", "ragged_live_tokens_total",
                "ragged_stream_utilization"):
        if stats.get(key) is not None:
            marks[key] = stats[key]
    perf = stats.get("perf") or {}
    for key in ("mfu", "hbm_bw_util", "ici_bw_util", "prefill_tps",
                "decode_tps", "chips", "compile_seconds_total",
                "unexpected_recompiles", "dispatches_total"):
        if perf.get(key) is not None:
            marks[key] = perf[key]
    cm = perf.get("costmodel") or {}
    if cm:
        marks["costmodel_drift_ratio"] = dict(cm.get("drift_ratio") or {})
        marks["costmodel_predicted_seconds"] = dict(
            cm.get("predicted_seconds") or {})
        marks["costmodel_measured_seconds"] = dict(
            cm.get("measured_seconds") or {})
        marks["costmodel_episodes"] = cm.get("episodes", 0)
    return marks


# -- the ledger itself ------------------------------------------------------

class PerfLedger(UsageLedger):
    """Durable perf history: a :class:`tenancy.UsageLedger` whose records
    follow the envelope above. Identical rotation/locking/IO-error
    discipline — journaling must never fail a request or a drain."""

    def append_engine_snapshot(self, ts: float, fp: Mapping,
                               marks: Mapping, *,
                               reason: str = "interval") -> bool:
        return self.append(engine_snapshot_record(ts, fp, marks,
                                                  reason=reason))

    def append_bench(self, ts: float, fp: Mapping,
                     artifact: Mapping) -> bool:
        return self.append(bench_record(ts, fp, artifact))


# -- consumers --------------------------------------------------------------

def read_records(path: str, *, include_backups: bool = True,
                 backups: int = 3) -> Tuple[List[Dict], int]:
    """Read a ledger back, oldest first, tolerating damage.

    Returns ``(records, skipped)`` where ``skipped`` counts lines that
    were not valid JSON objects (crash mid-append, truncated rotation).
    With ``include_backups`` the rotated generations ``<path>.N`` are
    read first (they are older), so one call sees the whole retained
    history."""
    paths: List[str] = []
    if include_backups:
        for i in range(max(int(backups), 1), 0, -1):
            paths.append(f"{path}.{i}")
    paths.append(path)
    records: List[Dict] = []
    skipped = 0
    for p in paths:
        try:
            with open(p, "r", encoding="utf-8") as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                skipped += 1
                continue
            if not isinstance(rec, dict) or "kind" not in rec:
                skipped += 1
                continue
            records.append(rec)
    return records, skipped


def group_by_cohort(records: Iterable[Mapping]) -> Dict[str, List[Dict]]:
    """Bucket records by fingerprint id, preserving order within each."""
    out: Dict[str, List[Dict]] = {}
    for rec in records:
        fpid = str(rec.get("fingerprint_id") or "")
        if not fpid and isinstance(rec.get("fingerprint"), Mapping):
            fpid = fingerprint_id(rec["fingerprint"])
        out.setdefault(fpid or "unknown", []).append(dict(rec))
    return out


def last_known_good(records: Iterable[Mapping],
                    fpid: str) -> Optional[Dict]:
    """The newest non-failed record in a cohort, or None.

    "Good" means an engine snapshot or a bench run whose status is
    "ok" — infra failures never become the baseline, they only date
    how stale the baseline is. The caller can compare the returned
    record's ``ts`` against now to report staleness."""
    best: Optional[Dict] = None
    for rec in records:
        if str(rec.get("fingerprint_id") or "") != fpid:
            continue
        kind = rec.get("kind")
        if kind == BENCH_KIND and rec.get("status") != "ok":
            continue
        if kind not in (BENCH_KIND, ENGINE_KIND):
            continue
        if best is None or float(rec.get("ts") or 0) >= float(best.get("ts") or 0):
            best = dict(rec)
    return best
