"""Straggler detection & mitigation policy (host-side; copy of
``repro.ft.straggler``).

On a 1000+ node fleet the dominant failure-adjacent mode is not crashes but
*slow* steps: a degraded chip/host or a congested DCI link stretches the
synchronous step for everyone. The monitor keeps an EWMA/variance estimate of
step time and flags outliers; the policy escalates:

  observe -> warn (z > warn_z) -> mitigate (z > act_z for `patience` steps)

Mitigation actions are returned as recommendations for the launcher:
  'checkpoint_and_rebalance' — snapshot (ft/checkpoint.py) and restart minus
  the slow host (elastic re-mesh, ft/elastic.py). On TPU slices the
  replacement path is a reschedule; there is no in-step work stealing in a
  synchronous SPMD step, which is why checkpoint/restart speed is the real
  straggler mitigation and why AsyncCheckpointer keeps snapshots cheap.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StragglerConfig:
    alpha: float = 0.1       # EWMA weight
    warn_z: float = 3.0
    act_z: float = 6.0
    patience: int = 3        # consecutive slow steps before acting
    warmup_steps: int = 10   # ignore compile/first-step noise


class StragglerMonitor:
    def __init__(self, cfg: StragglerConfig | None = None):
        self.cfg = cfg or StragglerConfig()
        self.mean: float | None = None
        self.var: float = 0.0
        self.n = 0
        self.slow_streak = 0
        self.events: list[tuple[int, str, float]] = []

    def record(self, step: int, seconds: float) -> str:
        """Returns 'ok' | 'warn' | 'checkpoint_and_rebalance'."""
        self.n += 1
        if self.n <= self.cfg.warmup_steps:
            # warmup: seed the estimate, never flag
            if self.mean is None:
                self.mean = seconds
            a = 0.5
            self.mean = (1 - a) * self.mean + a * seconds
            self.var = (1 - a) * self.var + a * (seconds - self.mean) ** 2
            return "ok"
        std = max(self.var ** 0.5, 1e-3 * self.mean)
        z = (seconds - self.mean) / std
        if z <= self.cfg.warn_z:
            # outlier-robust EWMA: straggler samples must not inflate the
            # baseline, or persistent slowdowns would self-normalize
            a = self.cfg.alpha
            self.mean = (1 - a) * self.mean + a * seconds
            self.var = (1 - a) * self.var + a * (seconds - self.mean) ** 2
        if z > self.cfg.act_z:
            self.slow_streak += 1
            if self.slow_streak >= self.cfg.patience:
                self.events.append((step, "act", z))
                self.slow_streak = 0
                return "checkpoint_and_rebalance"
            self.events.append((step, "slow", z))
            return "warn"
        if z > self.cfg.warn_z:
            self.events.append((step, "warn", z))
            self.slow_streak = 0
            return "warn"
        self.slow_streak = 0
        return "ok"
