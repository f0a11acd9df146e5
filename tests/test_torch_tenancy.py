"""The port's tenancy.py against the JAX package's, on the CPU.

Every function gets the same inputs, made from a numpy seed or taken from
a table, and must give the same result (floats within 1e-12):
``resolve_tenant`` over headers and bodies of every precedence level,
``sanitize_tenant`` and ``hash_api_key``, the top-K folds of mappings and
records (the reserved ``other`` and ``_canary`` rows among them),
``split_shares`` with its conservation, and ``UsageLedger``'s
rotation, file by file, and its counted write errors.
"""

import json
import os

import numpy as np
import pytest

from production_stack_tpu import tenancy as ref
from production_stack_tpu_torch import tenancy as mine

HEADERS_BODIES = [
    ({}, {}),
    ({"x-tenant-id": "team-a"}, {"user": "bob"}),
    ({"x-tenant-id": "  te am/<b>!  "}, None),
    ({"x-tenant-id": "!!!"}, {"user": "bob"}),
    ({"x-tenant-id": ""}, {"user": "  alice@example.com "}),
    (None, {"user": 42}),
    (None, {"user": "x" * 200}),
    ({"authorization": "Bearer sk-secret"}, {}),
    ({"Authorization": "bearer   sk-other  "}, {"user": ""}),
    ({"authorization": "Bearer"}, None),
    ({"authorization": "Bearer "}, {"user": "%%%"}),
    ({"authorization": "raw-token"}, None),
    ({"x-tenant-id": "_canary", "x-canary": "1"}, None),
    ({"x-tenant-id": "other"}, {"user": "u"}),
    (None, None),
]


@pytest.mark.parametrize("headers, body", HEADERS_BODIES)
def test_resolve_tenant_matches_reference(headers, body):
    assert mine.resolve_tenant(headers, body) == ref.resolve_tenant(
        headers, body)
    assert mine.resolve_tenant(headers, body, header_name="x-org") == \
        ref.resolve_tenant(headers, body, header_name="x-org")


def test_constants_match_reference():
    for name in ("ANONYMOUS", "OTHER", "TENANT_HEADER", "CANARY_TENANT",
                 "CANARY_HEADER", "DEFAULT_TOP_K", "_RESERVED", "_MAX_LEN"):
        assert getattr(mine, name) == getattr(ref, name), name


@pytest.mark.parametrize("seed", range(4))
def test_sanitize_and_hash_match_reference(seed):
    rng = np.random.default_rng(seed)
    alphabet = list("abcXYZ019._:-/ <>\"'\\\n\të漢")
    for _ in range(200):
        raw = "".join(rng.choice(alphabet, int(rng.integers(0, 90))))
        assert mine.sanitize_tenant(raw) == ref.sanitize_tenant(raw)
        assert mine.hash_api_key(raw) == ref.hash_api_key(raw)
        assert mine.hash_api_key("Bearer " + raw) == ref.hash_api_key(
            "Bearer " + raw)
    assert mine.sanitize_tenant(None) is ref.sanitize_tenant(None) is None


def _mapping(rng, n):
    out = {f"t{i}": float(rng.choice([0.0, rng.uniform(0, 100)]))
           for i in range(n)}
    if rng.random() < 0.4:
        out["other"] = float(rng.uniform(0, 10))
    if rng.random() < 0.4:
        out["_canary"] = float(rng.uniform(0, 10))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_fold_top_k_matches_reference(seed):
    rng = np.random.default_rng(10 + seed)
    for _ in range(60):
        values = _mapping(rng, int(rng.integers(0, 15)))
        k = int(rng.integers(0, 10))
        want, got = ref.fold_top_k(values, k), mine.fold_top_k(values, k)
        assert got.keys() == want.keys()
        for t in want:
            assert got[t] == pytest.approx(want[t], rel=1e-12, abs=1e-12)
        assert sum(got.values()) == pytest.approx(sum(values.values()),
                                                  rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_fold_records_matches_reference(seed):
    rng = np.random.default_rng(20 + seed)
    for _ in range(40):
        records = {t: {"chip_seconds": v,
                       "prefill_tokens": int(rng.integers(0, 1000)),
                       "decode_tokens": int(rng.integers(0, 1000)),
                       "label": "text is not summed"}
                   for t, v in _mapping(rng, int(rng.integers(0, 14))).items()}
        k = int(rng.integers(0, 8))
        want = ref.fold_records(records, k)
        got = mine.fold_records(records, k)
        assert got.keys() == want.keys()
        for t in want:
            assert got[t].keys() == want[t].keys()
            for key in want[t]:
                if isinstance(want[t][key], float):
                    assert got[t][key] == pytest.approx(
                        want[t][key], rel=1e-12, abs=1e-12)
                else:
                    assert got[t][key] == want[t][key]
        weight_key = "decode_tokens"
        assert mine.fold_records(records, k, weight_key) == \
            ref.fold_records(records, k, weight_key)


@pytest.mark.parametrize("seed", range(6))
def test_split_shares_matches_reference_and_conserves(seed):
    rng = np.random.default_rng(30 + seed)
    for _ in range(100):
        weights = {f"t{i}": float(rng.uniform(0, 50))
                   for i in range(int(rng.integers(0, 9)))}
        if rng.random() < 0.1:
            weights = {t: 0.0 for t in weights}
        total = float(rng.uniform(0, 3))
        want, got = ref.split_shares(total, weights), mine.split_shares(
            total, weights)
        assert got.keys() == want.keys()
        for t in want:
            assert got[t] == pytest.approx(want[t], rel=1e-12, abs=1e-12)
        if got:
            # the largest share takes the residual of the others
            assert sum(got.values()) == pytest.approx(total, rel=1e-12,
                                                      abs=1e-15)


def _ledger_records(seed, n):
    rng = np.random.default_rng(seed)
    return [{"ts": 1.7e9 + i, "tenant": f"t{int(rng.integers(0, 4))}",
             "model": "m", "request_id": f"cmpl-{i}",
             "prompt_tokens": int(rng.integers(1, 5000)),
             "output_tokens": int(rng.integers(0, 500)),
             "chip_seconds": float(rng.uniform(0, 1)),
             "pad": "x" * int(rng.integers(0, 400))} for i in range(n)]


@pytest.mark.parametrize("max_bytes, backups", [(1 << 12, 3), (6000, 1),
                                                (1 << 20, 2)])
def test_usage_ledger_rotation_matches_reference(tmp_path, max_bytes,
                                                 backups):
    recs = _ledger_records(max_bytes, 120)
    dirs = {}
    for name, mod in (("ref", ref), ("mine", mine)):
        d = tmp_path / name
        d.mkdir()
        ledger = mod.UsageLedger(str(d / "usage.jsonl"), max_bytes=max_bytes,
                                 backups=backups)
        assert all(ledger.append(r) for r in recs)
        stats = ledger.stats()
        stats.pop("path")
        dirs[name] = (stats, {p: (d / p).read_bytes()
                              for p in sorted(os.listdir(d))})
    assert dirs["mine"] == dirs["ref"]
    stats, files = dirs["mine"]
    assert stats["records_written"] == 120
    if max_bytes < (1 << 20):
        assert stats["rotations"] > 0 and len(files) == backups + 1
    lines = [json.loads(line) for data in files.values()
             for line in data.decode().splitlines()]
    assert len(lines) <= 120 and lines[0].keys() == recs[0].keys()


def test_usage_ledger_counts_io_errors(tmp_path):
    out = []
    for mod in (ref, mine):
        ledger = mod.UsageLedger(str(tmp_path / "missing" / "usage.jsonl"))
        assert ledger.append({"tenant": "a"}) is False
        s = ledger.stats()
        out.append((s["records_written"], s["write_errors"], s["rotations"],
                    s["max_bytes"]))
    assert out[0] == out[1] == (0, 1, 0, 16 << 20)
