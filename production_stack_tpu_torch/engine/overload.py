"""Staged brownout degradation: the overload safety valve.

A copy of production_stack_tpu/engine/overload.py (standard library only).
The stack can *measure* overload from several directions — burn-rate page
flags (router/slo.py), the HBM gauge (engine/perf_accounting.py), the
bounded admission queue (engine/scheduler.py), the stuck-step watchdog
(engine/server.py) — but measurement alone just documents the outage.
This module closes the loop: a small hysteretic controller walks a
ladder of staged degradation while pressure is sustained, and walks back
down only after N consecutive calm evaluations (mirroring
``ScaleAdvisor``'s ``down_stable`` hysteresis, router/scale_advisor.py).

Stages (each includes the ones below it):

========  ==============================================================
stage 0   healthy — no degradation
stage 1   shed speculative-decode grants (drafts are optional work;
          reclaiming their stream-budget share is free quality-wise)
stage 2   clamp per-request ``max_tokens`` and pause warm-tier KV
          prefetch (bound tail work; stop optional HBM/host traffic)
stage 3   shed NEW admissions from over-weight tenants entirely (the
          tenants consuming more than their fair share absorb the 429s;
          in-budget tenants keep flowing)
========  ==============================================================

The controller is a pure, clock-injected state machine: ``evaluate`` is
the only mutation, takes explicit signals + ``now``, and never reads
wall time or device state itself — both tiers (engine server thread,
router asyncio worker) drive it from their own loops, and tests drive
it from a virtual clock. Stage transitions never change what a device
step sees: every action is host-side admission/grant policy, so no new
step signature can follow from one.

Exported as ``vllm:brownout_stage`` (gauge) with each shed counted in
``vllm:brownout_sheds_total{reason}``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional

MAX_STAGE = 3

# shed reason labels (bounded: the label set is this closed vocabulary)
SHED_SPEC = "spec"
SHED_MAX_TOKENS = "max_tokens"
SHED_PREFETCH = "prefetch"
SHED_TENANT = "tenant"


@dataclasses.dataclass
class BrownoutConfig:
    """Thresholds + hysteresis for the staged controller. Defaults are
    deliberately conservative: sustained pressure on ANY signal for
    ``up_evals`` consecutive evaluations steps one stage up; ``calm_evals``
    consecutive quiet evaluations step one stage down."""

    enabled: bool = False
    queue_high: float = 0.5     # waiting/max_queue_len fraction that is hot
    hbm_high: float = 0.92      # HBM used/total fraction that is hot
    interval: float = 2.0       # seconds between evaluations (caller-paced)
    up_evals: int = 2           # consecutive hot evals per stage up
    calm_evals: int = 3         # consecutive calm evals per stage down
    max_stage: int = MAX_STAGE
    max_tokens_clamp: int = 256  # stage-2 per-request max_tokens ceiling


@dataclasses.dataclass
class PressureSignals:
    """One evaluation's worth of pressure, tier-agnostic. The engine
    fills queue/hbm/stall from its scheduler + accountant + watchdog;
    the router fills queue (fleet admission depth) and burn_page from
    the SLO tracker's fast-burn page flag."""

    queue_fraction: float = 0.0   # admission-queue depth / bound (0-1+)
    hbm_fraction: float = 0.0     # HBM used / total (0 when unknown)
    watchdog_stalled: bool = False
    burn_page: bool = False       # SLO fast-burn page flag is firing


class BrownoutController:
    """Hysteretic stage machine. ``evaluate(signals, now)`` returns the
    stage after applying this evaluation; everything else is read-only.

    Hysteresis mirrors ScaleAdvisor: pressure must be *sustained*
    (``up_evals`` consecutive hot evaluations) before each step up, and
    recovery must be *sustained* (``calm_evals`` consecutive calm
    evaluations) before each step down — a single noisy sample can
    neither brown the fleet out nor un-brown it mid-incident."""

    def __init__(self, config: Optional[BrownoutConfig] = None):
        self.config = config or BrownoutConfig()
        self.stage = 0
        self._hot_streak = 0
        self._calm_streak = 0
        self.transitions = 0          # stage changes since boot
        self.last_change: float = 0.0
        self.last_reasons: List[str] = []
        self.sheds: Dict[str, int] = {}   # reason -> count (counter source)

    # -- evaluation ----------------------------------------------------------
    def hot_reasons(self, sig: PressureSignals) -> List[str]:
        """Which signals are past their thresholds (empty = calm)."""
        cfg = self.config
        reasons = []
        if sig.queue_fraction >= cfg.queue_high > 0:
            reasons.append("queue_depth")
        if sig.hbm_fraction >= cfg.hbm_high > 0:
            reasons.append("hbm_pressure")
        if sig.watchdog_stalled:
            reasons.append("watchdog_stall")
        if sig.burn_page:
            reasons.append("burn_page")
        return reasons

    def evaluate(self, sig: PressureSignals, now: float) -> int:
        if not self.config.enabled:
            return 0
        reasons = self.hot_reasons(sig)
        self.last_reasons = reasons
        if reasons:
            self._calm_streak = 0
            self._hot_streak += 1
            if (self._hot_streak >= max(self.config.up_evals, 1)
                    and self.stage < min(self.config.max_stage, MAX_STAGE)):
                self.stage += 1
                self.transitions += 1
                self.last_change = now
                self._hot_streak = 0  # each further stage needs fresh proof
        else:
            self._hot_streak = 0
            self._calm_streak += 1
            if (self._calm_streak >= max(self.config.calm_evals, 1)
                    and self.stage > 0):
                self.stage -= 1
                self.transitions += 1
                self.last_change = now
                self._calm_streak = 0  # each further step needs fresh calm
        return self.stage

    # -- stage actions -------------------------------------------------------
    @property
    def shed_spec(self) -> bool:
        """Stage 1+: speculative-decode grants go to zero."""
        return self.stage >= 1

    @property
    def max_tokens_clamp(self) -> int:
        """Stage 2+: per-request max_tokens ceiling (0 = no clamp)."""
        return self.config.max_tokens_clamp if self.stage >= 2 else 0

    @property
    def pause_prefetch(self) -> bool:
        """Stage 2+: stop launching new warm-tier KV prefetches (the
        sequence falls back to recompute — correct, just not prefetched)."""
        return self.stage >= 2

    @property
    def shed_overweight(self) -> bool:
        """Stage 3: refuse NEW admissions from over-weight tenants."""
        return self.stage >= 3

    def record_shed(self, reason: str, n: int = 1) -> None:
        self.sheds[reason] = self.sheds.get(reason, 0) + n

    def snapshot(self) -> dict:
        return {
            "enabled": self.config.enabled,
            "stage": self.stage,
            "hot_streak": self._hot_streak,
            "calm_streak": self._calm_streak,
            "transitions": self.transitions,
            "last_change": self.last_change,
            "last_reasons": list(self.last_reasons),
            "sheds": dict(self.sheds),
            "actions": {
                "shed_spec": self.shed_spec,
                "max_tokens_clamp": self.max_tokens_clamp,
                "pause_prefetch": self.pause_prefetch,
                "shed_overweight": self.shed_overweight,
            },
        }


def overweight_tenants(loads: Mapping[str, float],
                       weights: Optional[Mapping[str, float]] = None,
                       slack: float = 1.5) -> List[str]:
    """Tenants whose observed load share exceeds ``slack`` x their weight
    share — the stage-3 shed set.

    ``loads`` is any recent per-tenant load measure (live+waiting seqs,
    windowed requests, tokens); ``weights`` defaults to equal. Pure and
    deterministic so both tiers (and the traffic simulator) compute the
    same answer from their own load views. A lone tenant is never
    over-weight: shedding the only consumer degrades service for no one's
    benefit."""
    active = {t: v for t, v in loads.items() if v > 0}
    if len(active) < 2:
        return []
    total = sum(active.values())
    if total <= 0:
        return []
    w = {t: float((weights or {}).get(t, 1.0)) for t in active}
    wsum = sum(v for v in w.values() if v > 0)
    if wsum <= 0:
        return []
    out = []
    for t, load in active.items():
        share = load / total
        fair = max(w[t], 0.0) / wsum
        if share > slack * fair:
            out.append(t)
    return sorted(out)
