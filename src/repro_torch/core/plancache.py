"""Persistent GEMM plan cache — §5.3.1 plan reuse across process lifetimes.

A copy of ``repro.core.plancache`` for the PyTorch port: the same key
schema, JSON v2 file format, balance snapshots and warm/lazy counters, so a
file written by either package loads in the other.

Solved balanced plans are pure functions of (hw generation, M, K, N, dtypes,
layout): nothing about a plan depends on process state, so re-solving them
every server start is wasted startup latency. This cache backs the in-memory
plan dict with a versioned JSON file; a server warm-up (``plan_model``) can
pre-solve every signature a model will issue, persist them, and the next
process start serves all plans from disk with zero solver invocations.

The counters split solver work into *warm* (inside a declared warm-up phase)
and *lazy* (a signature the warm-up missed, solved on first hit) so "zero
lazy solves after warm-up" is a checkable property, not a hope.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile

from repro_torch.kernels.ops import GemmPlan

# Bump whenever the key schema, plan schema, or solver semantics change in a
# way that invalidates previously persisted plans.
# v2: entries carry the solver's balance snapshot (modeled t_comp/t_mem at
# solve time) so the attribution auditor can detect drift after restarts.
PLAN_CACHE_VERSION = 2

PlanKey = tuple  # (hw, M, K, N, in_dtype, out_dtype, b_layout)


@dataclasses.dataclass(frozen=True)
class BalanceSnapshot:
    """Modeled compute/memory seconds of a plan at the moment it was solved,
    persisted beside it (the reference's balance auditor compares them with
    a fresh model evaluation to find drifted plans)."""

    t_comp: float
    t_mem: float


def plan_key(
    hw_name: str, M: int, K: int, N: int,
    in_dtype: str, out_dtype: str, b_layout: str,
) -> PlanKey:
    return (hw_name, int(M), int(K), int(N), in_dtype, out_dtype, b_layout)


def _key_str(key: PlanKey) -> str:
    return "|".join(str(p) for p in key)


def _key_from_str(s: str) -> PlanKey | None:
    parts = s.split("|")
    if len(parts) != 7:
        return None
    hw, M, K, N, din, dout, layout = parts
    try:
        return plan_key(hw, int(M), int(K), int(N), din, dout, layout)
    except ValueError:
        return None


@dataclasses.dataclass
class PlanCacheStats:
    hits: int = 0
    misses: int = 0
    warm_solves: int = 0
    lazy_solves: int = 0
    loaded: int = 0

    def snapshot(self) -> "PlanCacheStats":
        return dataclasses.replace(self)

    def __str__(self) -> str:
        return (f"hits={self.hits} misses={self.misses} "
                f"warm_solves={self.warm_solves} "
                f"lazy_solves={self.lazy_solves} loaded={self.loaded}")


class PlanCache:
    """In-memory plan dict with an optional on-disk JSON backend.

    ``path=None`` is a pure in-memory cache (the default context's mode —
    tests and libraries never touch the filesystem). With a path, ``load()``
    pulls previously solved plans and ``save()`` persists the current set
    atomically (write-temp + rename).
    """

    def __init__(self, path: str | None = None):
        self.path = path
        self.entries: dict[PlanKey, GemmPlan] = {}
        # solve-time model evaluation per entry (may lag `entries` when a
        # cache is hand-perturbed — exactly what the auditor detects)
        self.balance: dict[PlanKey, BalanceSnapshot] = {}
        self.stats = PlanCacheStats()
        self._warming = 0
        # distinct keys consulted during the current/most recent warm-up
        self.warm_keys: set[PlanKey] = set()

    # ------------------------------------------------------------ lookup
    def get(self, key: PlanKey) -> GemmPlan | None:
        plan = self.entries.get(key)
        if plan is None:
            self.stats.misses += 1
        else:
            self.stats.hits += 1
        if self._warming:
            self.warm_keys.add(key)
        return plan

    def put(self, key: PlanKey, plan: GemmPlan,
            balance: BalanceSnapshot | None = None) -> GemmPlan:
        self.entries[key] = plan
        if balance is not None:
            self.balance[key] = balance
        if self._warming:
            self.stats.warm_solves += 1
        else:
            self.stats.lazy_solves += 1
        return plan

    @contextlib.contextmanager
    def warmup(self):
        """Solver work inside this block counts as warm-up, not lazy;
        ``warm_keys`` collects the distinct signatures consulted."""
        if not self._warming:
            self.warm_keys = set()
        self._warming += 1
        try:
            yield self
        finally:
            self._warming -= 1

    # ------------------------------------------------------------- disk
    def load(self, path: str | None = None) -> int:
        """Merge plans from disk; returns how many entries were loaded.

        A missing file, unreadable JSON, or a version mismatch loads zero
        entries (version bumps invalidate the whole file by design).
        """
        path = path or self.path
        if not path or not os.path.exists(path):
            return 0
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            return 0
        if payload.get("version") != PLAN_CACHE_VERSION:
            return 0
        n = 0
        for key_s, rec in payload.get("plans", {}).items():
            key = _key_from_str(key_s)
            if key is None or not isinstance(rec, dict):
                continue
            try:
                plan = GemmPlan(bm=int(rec["bm"]), bk=int(rec["bk"]),
                                bn=int(rec["bn"]))
            except (KeyError, TypeError, ValueError):
                continue
            if plan.bm <= 0 or plan.bk <= 0 or plan.bn <= 0:
                continue  # a hand-edited/corrupt plan would crash the kernel
            if key not in self.entries:
                self.entries[key] = plan
                try:
                    self.balance[key] = BalanceSnapshot(
                        t_comp=float(rec["t_comp"]),
                        t_mem=float(rec["t_mem"]))
                except (KeyError, TypeError, ValueError):
                    pass  # snapshot-less entries stay auditable-as-unknown
                n += 1
        self.stats.loaded += n
        return n

    def save(self, path: str | None = None) -> str | None:
        """Atomically persist all entries; returns the path written."""
        path = path or self.path
        if not path:
            return None
        def _rec(k: PlanKey, p: GemmPlan) -> dict:
            rec: dict = {"bm": p.bm, "bk": p.bk, "bn": p.bn}
            snap = self.balance.get(k)
            if snap is not None:
                rec["t_comp"] = snap.t_comp
                rec["t_mem"] = snap.t_mem
            return rec

        payload = {
            "version": PLAN_CACHE_VERSION,
            "plans": {
                _key_str(k): _rec(k, p)
                for k, p in sorted(self.entries.items(),
                                   key=lambda kv: _key_str(kv[0]))
            },
        }
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, path)
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise
        return path


def default_cache_path() -> str:
    """Where launchers persist plans unless told otherwise."""
    env = os.environ.get("REPRO_TORCH_PLAN_CACHE")
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "plancache.json")
