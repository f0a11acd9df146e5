"""Tenant attribution primitives: a copy of production_stack_tpu/tenancy.py.

The port keeps its own copy (it imports nothing of the JAX package, not
even its JAX-free modules). The four pieces every attribution surface
uses:

* :func:`resolve_tenant` — one identity precedence for the whole stack:
  an explicit ``x-tenant-id`` header wins, then the OpenAI ``user`` body
  field, then a hash of the API key, then ``"anonymous"``. The router
  resolves once at admission and stamps the result as ``x-tenant-id`` on
  the outbound engine request, so both tiers agree; an engine hit
  directly still attributes via the same precedence.
* :func:`fold_top_k` / :func:`fold_records` — the bounded-cardinality
  policy: every *export* of a per-tenant mapping (Prometheus labels,
  /debug documents) passes through a deterministic top-K fold with the
  remainder summed under ``tenant="other"``, so a tenant churn can never
  mint unbounded label values.
* :func:`split_shares` — exact-conservation proportional split: the
  parts sum to the total *bit-exactly* (largest share absorbs the float
  residual), which is what makes "per-tenant chip-seconds sum to total
  dispatch seconds" an invariant instead of an approximation.
* :class:`UsageLedger` — a durable, size-rotated JSONL ledger of
  per-request usage records (tenant, model, tokens by phase,
  chip-seconds, lifecycle stamps). Append-only, thread-safe, and IO
  failures are counted rather than raised: billing must never take the
  serving path down.

Attribution is observe-only: nothing here is read by scheduling or
routing, and tenant identity never reaches a device tensor (host-side
metadata only). Standard library only.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
from typing import Dict, Mapping, Optional

ANONYMOUS = "anonymous"
OTHER = "other"
TENANT_HEADER = "x-tenant-id"
# the correctness-canary plane's reserved identity: the router stamps
# its synthetic probes with this tenant (plus the x-canary marker
# header), so canary usage is attributed separately and NEVER folded
# into a real tenant's rows or the "other" bucket — real tenants'
# totals are bit-identical with the prober on or off, while the
# conservation invariant (parts sum to total) still holds with the
# _canary row included.
CANARY_TENANT = "_canary"
CANARY_HEADER = "x-canary"
# identities that never compete for a top-K slot and never merge into
# the fold bucket: they are kept as their own rows in every export
_RESERVED = frozenset({OTHER, CANARY_TENANT})
DEFAULT_TOP_K = 8

# label-safe tenant ids: printable, short, no label-injection characters.
# Anything else is stripped; an id that sanitizes to nothing falls through
# to the next precedence level.
_SAFE = re.compile(r"[^A-Za-z0-9._:\-]+")
_MAX_LEN = 64


def sanitize_tenant(raw) -> Optional[str]:
    """Normalize a candidate tenant id to a label-safe token, or None."""
    if raw is None:
        return None
    s = _SAFE.sub("", str(raw).strip())[:_MAX_LEN]
    return s or None


def hash_api_key(authorization: str) -> Optional[str]:
    """Stable pseudonymous tenant id from an Authorization header. The
    raw key must never become a label value; a short digest is enough to
    group a key's traffic without being reversible."""
    if not authorization:
        return None
    token = authorization.strip()
    if token.lower().startswith("bearer "):
        token = token[7:].strip()
    if not token or token.lower() == "bearer":
        return None  # a bare scheme carries no credential to group by
    return "key-" + hashlib.sha256(token.encode()).hexdigest()[:12]


def resolve_tenant(headers: Optional[Mapping] = None,
                   body: Optional[Mapping] = None,
                   header_name: str = TENANT_HEADER) -> str:
    """Identity precedence (highest wins):

    1. explicit ``x-tenant-id`` header (the router stamps its resolution
       here, so engines inherit it across tiers — and across the P→D
       disaggregation hop),
    2. OpenAI ``user`` field in the request body,
    3. hash of the API key (``Authorization`` header),
    4. ``"anonymous"``.
    """
    if headers is not None:
        t = sanitize_tenant(headers.get(header_name))
        if t:
            return t
    if body is not None:
        user = body.get("user")
        if isinstance(user, str):
            t = sanitize_tenant(user)
            if t:
                return t
    if headers is not None:
        t = hash_api_key(headers.get("authorization")
                         or headers.get("Authorization") or "")
        if t:
            return t
    return ANONYMOUS


# -- bounded cardinality ----------------------------------------------------

def fold_top_k(values: Mapping[str, float], k: int = DEFAULT_TOP_K,
               other: str = OTHER) -> Dict[str, float]:
    """Keep the K largest entries, sum the rest under ``other``.

    Deterministic (ties break by name) and conserving: the folded
    mapping's total equals the input's. A pre-existing ``other`` entry
    never competes for a top-K slot — it is already the fold bucket.
    The reserved ``_canary`` identity (the router's synthetic probes)
    likewise keeps its own row: canary usage is never merged into
    ``other``, so real tenants' folded values are identical with the
    prober on or off."""
    reserved = {other} | _RESERVED
    pool = {t: v for t, v in values.items() if t not in reserved}
    keep = sorted(pool, key=lambda t: (-pool[t], t))[: max(int(k), 0)]
    out = {t: pool[t] for t in keep}
    rest = sum(v for t, v in pool.items() if t not in out)
    rest += values.get(other, 0)
    if rest or (other in values):
        out[other] = rest
    if CANARY_TENANT in values and CANARY_TENANT != other:
        out[CANARY_TENANT] = values[CANARY_TENANT]
    return out


def fold_records(records: Mapping[str, Mapping[str, float]],
                 k: int = DEFAULT_TOP_K, weight_key: str = "chip_seconds",
                 other: str = OTHER) -> Dict[str, Dict[str, float]]:
    """:func:`fold_top_k` for per-tenant record dicts: rank by
    ``weight_key``, fold the remainder by summing every numeric field —
    each field's fleet total is conserved across the fold. The reserved
    ``_canary`` row is carried through unfolded, same as
    :func:`fold_top_k`."""
    reserved = {other} | _RESERVED
    pool = {t: dict(r) for t, r in records.items() if t not in reserved}
    keep = sorted(pool, key=lambda t: (-float(pool[t].get(weight_key, 0)), t)
                  )[: max(int(k), 0)]
    out = {t: pool[t] for t in keep}
    folded: Dict[str, float] = dict(records.get(other) or {})
    rest = False
    for t, rec in pool.items():
        if t in out:
            continue
        rest = True
        for key, val in rec.items():
            if isinstance(val, (int, float)):
                folded[key] = folded.get(key, 0) + val
    if rest or (other in records):
        out[other] = folded
    if CANARY_TENANT in records and CANARY_TENANT != other:
        out[CANARY_TENANT] = dict(records[CANARY_TENANT])
    return out


def split_shares(total: float,
                 weights: Mapping[str, float]) -> Dict[str, float]:
    """Split ``total`` proportionally to ``weights`` with *exact*
    conservation: the largest-weight key takes ``total - sum(others)``,
    so ``sum(parts) == total`` bit-for-bit however float rounding lands.
    Zero/negative aggregate weight attributes nothing (empty dict)."""
    wsum = sum(weights.values())
    if wsum <= 0 or not weights:
        return {}
    # residual goes to the largest share: relative error stays smallest
    order = sorted(weights, key=lambda t: (weights[t], t))
    out: Dict[str, float] = {}
    assigned = 0.0
    for t in order[:-1]:
        part = total * (weights[t] / wsum)
        out[t] = part
        assigned += part
    out[order[-1]] = total - assigned
    return out


# -- durable usage ledger ---------------------------------------------------

class UsageLedger:
    """Rotating JSONL ledger of per-request usage records.

    One ``json.dumps`` line per finished request; when the live file
    exceeds ``max_bytes`` it is rotated to ``<path>.1`` (shifting older
    generations up to ``backups``). Writes are serialized under a lock —
    the engine's finish path and HTTP handlers may both emit. IO errors
    increment ``write_errors`` instead of raising: metering must never
    fail a request."""

    def __init__(self, path: str, max_bytes: int = 16 << 20,
                 backups: int = 3):
        self.path = path
        self.max_bytes = max(int(max_bytes), 1 << 12)
        self.backups = max(int(backups), 1)
        self._lock = threading.Lock()
        self.records_written = 0
        self.write_errors = 0
        self.rotations = 0

    def append(self, record: Mapping) -> bool:
        line = json.dumps(record, sort_keys=True, default=str) + "\n"
        with self._lock:
            try:
                self._maybe_rotate(len(line))
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line)
                self.records_written += 1
                return True
            except OSError:
                self.write_errors += 1
                return False

    def _maybe_rotate(self, incoming: int) -> None:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return  # no file yet
        if size + incoming <= self.max_bytes:
            return
        for i in range(self.backups - 1, 0, -1):
            src, dst = f"{self.path}.{i}", f"{self.path}.{i + 1}"
            if os.path.exists(src):
                os.replace(src, dst)
        os.replace(self.path, f"{self.path}.1")
        self.rotations += 1

    def stats(self) -> Dict[str, object]:
        return {
            "path": self.path,
            "max_bytes": self.max_bytes,
            "records_written": self.records_written,
            "write_errors": self.write_errors,
            "rotations": self.rotations,
        }
