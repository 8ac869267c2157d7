"""Balance auditor — per-signature GEMM attribution against the analytic
model (port of ``repro.obs.attrib``).

The paper's claim is analytic *balance*: the solver picks tiles where
T_comp ≈ T_mem (§4.5.2). The flight recorder times serving *phases*;
``core/balance`` and ``core/perfmodel`` predict per-*plan* compute and
memory seconds. This module joins the two: per GEMM signature, is the
engine compute-bound, memory-bound, or *mispredicted* (drifted)?

Mechanics
---------
The port's ``plan_for`` is consulted on eager calls and on the plan
warm-up's meta-device calls, never inside a CUDA-graph replay, so
per-signature device seconds cannot be read off a clock. Instead:

1. **Profiles** — during the engine's plan warm-up, each step runs on the
   meta device under :meth:`AttributionLedger.capture`, which hangs a
   dispatch listener on ``core.gemm`` and records how often each
   ``plan_key`` is consulted by that step: what one execution of the
   phase launches (the port runs its layers in a Python loop, so a layer
   signature counts once a layer; the reference's ``lax.scan`` traces the
   layer body once).
2. **Dispatch counts** — the engine bumps a plain integer per step
   execution on the hot path (:meth:`dispatch`; no clock reads).
3. **Join** — at the end of a run, the measured per-phase seconds (on
   the card the device phases' CUDA-event seconds,
   ``Tracer.device_durations``) are apportioned across signatures in
   proportion to ``dispatches × profile count × modeled t_total``. By
   construction the per-signature seconds reconcile with the phase
   totals; the reconciliation error is exported.

Drift rule
----------
Every solved plan stores a ``BalanceSnapshot`` (modeled t_comp / t_mem at
solve time). A signature is **drifted** when the current model evaluation
of its *cached* plan deviates from that snapshot by more than ``tol``
(relative t_total or balance ratio): perturbed entries, stale disk caches,
hand-edited plans. Drifted warm plans are re-solve candidates for
``autotune.refine_cached_plans(..., resolve=True)`` (``--rebalance-drifted``).
"""
from __future__ import annotations

import collections
import contextlib

from repro_torch.configs.base import torch_dtype
from repro_torch.core import balance, gemm, perfmodel as pm
from repro_torch.core.context import resolve_hw
from repro_torch.core.plancache import PlanKey, _key_str

# Phases whose measured seconds are GEMM device work and therefore
# attributable. The tracer may know more phases (sample, bind, expire…);
# those are host-side and stay out of the reconciliation basis.
GEMM_PHASES = ("admit", "prefill-chunk", "decode", "spec-draft", "spec-verify")


def _phase_of(tag: str) -> str:
    """Capture tags may be bucketed ('prefill-chunk@8'); the tracer merges
    all buckets under one phase name."""
    return tag.split("@", 1)[0]


class AttributionLedger:
    """Accumulates phase→signature profiles and dispatch counts, then joins
    them against measured phase durations and the analytic model."""

    def __init__(self, *, tol: float = 0.25, top_k: int = 8):
        self.tol = float(tol)
        self.top_k = int(top_k)
        # tag -> {plan_key: consultations per one execution of the phase fn}
        self.profiles: dict[str, dict[PlanKey, int]] = {}
        # tag -> number of runtime executions of the phase fn
        self.dispatches: dict[str, int] = {}
        # (key, plan) -> GemmEstimate; invalidates itself when an entry's
        # plan changes (perturbation, refinement)
        self._est_cache: dict[tuple, pm.GemmEstimate] = {}
        self._drifted: list[PlanKey] = []

    # ------------------------------------------------------------- capture
    @contextlib.contextmanager
    def capture(self, tag: str):
        """Record every ``plan_for`` consultation inside the block as the
        signature profile of phase ``tag`` (replacing any prior profile —
        re-warming re-captures)."""
        prof: collections.Counter = collections.Counter()

        def listener(key, plan):
            prof[key] += 1

        gemm.add_dispatch_listener(listener)
        try:
            yield
        finally:
            gemm.remove_dispatch_listener(listener)
            self.profiles[tag] = dict(prof)

    def dispatch(self, tag: str, n: int = 1) -> None:
        """Hot-path counter: one runtime execution of phase ``tag``."""
        self.dispatches[tag] = self.dispatches.get(tag, 0) + n

    def reset_run(self) -> None:
        """Clear per-run dispatch counts; warm-up profiles persist."""
        self.dispatches = {}
        self._drifted = []

    # ------------------------------------------------------------- model
    def _estimate(self, key: PlanKey, plan) -> pm.GemmEstimate:
        ck = (key, plan)
        est = self._est_cache.get(ck)
        if est is None:
            hw_name, M, K, N, din, dout, layout = key
            est = pm.estimate_gemm(
                resolve_hw(hw_name), M, K, N, plan.bm, plan.bk, plan.bn,
                in_dtype=torch_dtype(din), out_dtype=torch_dtype(dout),
                b_layout=layout)
            self._est_cache[ck] = est
        return est

    def _attribute(self, phase_durations: dict[str, list[float]], cache):
        """Apportion measured phase seconds across signatures.

        Returns (device_s, calls, traced_s) where traced_s is the summed
        duration of attributable GEMM phases — the reconciliation basis.
        Reads ``cache.entries`` directly (never ``get``) so auditing cannot
        perturb hit/miss counters or steady-state assertions.
        """
        totals = {p: sum(d) for p, d in phase_durations.items()
                  if p in GEMM_PHASES and d}
        by_phase: dict[str, list[str]] = collections.defaultdict(list)
        for tag, prof in self.profiles.items():
            if prof and self.dispatches.get(tag):
                by_phase[_phase_of(tag)].append(tag)
        device_s: dict[PlanKey, float] = collections.defaultdict(float)
        calls: dict[PlanKey, int] = collections.defaultdict(int)
        for phase, total in totals.items():
            tags = by_phase.get(phase, [])
            # weight per tag: executions × modeled seconds per execution
            weights = {}
            for tag in tags:
                per_exec = 0.0
                for key, count in self.profiles[tag].items():
                    plan = cache.entries.get(key)
                    if plan is not None:
                        per_exec += count * self._estimate(key, plan).t_total
                weights[tag] = self.dispatches[tag] * per_exec
            wsum = sum(weights.values())
            if wsum <= 0:
                continue  # unattributable phase → shows up as recon error
            for tag in tags:
                tag_s = total * weights[tag] / wsum
                prof = self.profiles[tag]
                kw = {key: count * self._estimate(key, cache.entries[key]).t_total
                      for key, count in prof.items()
                      if cache.entries.get(key) is not None}
                ksum = sum(kw.values())
                for key, count in prof.items():
                    if key in kw:
                        calls[key] += self.dispatches[tag] * count
                        if ksum > 0:
                            device_s[key] += tag_s * kw[key] / ksum
        return device_s, calls, sum(totals.values())

    def _classify(self, key: PlanKey, cache) -> dict:
        """Model-side view of one signature: bound class + drift verdict."""
        plan = cache.entries[key]
        est = self._estimate(key, plan)
        ratio = None if est.t_mem <= 0 else est.t_comp / est.t_mem
        snap = cache.balance.get(key)
        ratio_dev = time_dev = None
        if snap is not None:
            sr = snap.ratio
            if ratio is not None and sr:
                ratio_dev = abs(ratio - sr) / sr
            if snap.t_total > 0:
                time_dev = abs(est.t_total - snap.t_total) / snap.t_total
        drifted = bool(
            snap is not None
            and ((ratio_dev is not None and ratio_dev > self.tol)
                 or (time_dev is not None and time_dev > self.tol)))
        return {
            "plan": plan, "est": est, "ratio": ratio, "snap": snap,
            "ratio_dev": ratio_dev, "time_dev": time_dev,
            "bound": "compute" if est.t_comp >= est.t_mem else "memory",
            "drifted": drifted,
        }

    # ----------------------------------------------------------- summaries
    def class_seconds(self, phase_durations, *, cache) -> dict[str, float]:
        """Cheap device-seconds-by-bound-class split for counter tracks."""
        device_s, _, _ = self._attribute(phase_durations, cache)
        out = {"compute": 0.0, "memory": 0.0, "drifted": 0.0}
        for key, s in device_s.items():
            c = self._classify(key, cache)
            out["drifted" if c["drifted"] else c["bound"]] += s
        return out

    def summarize(self, phase_durations, *, cache, suggest: bool = True) -> dict:
        """Full attribution report — the metrics.json ``attribution`` section.

        ``suggest=True`` re-solves drifted signatures from the model (direct
        ``solve_exhaustive``; no cache counters touched) to propose a
        replacement plan and its modeled gain.
        """
        device_s, calls, traced_s = self._attribute(phase_durations, cache)
        keys = set(device_s) | {
            k for tag, prof in self.profiles.items()
            if self.dispatches.get(tag) for k in prof}
        keys = [k for k in keys if k in cache.entries]
        attributed = sum(device_s.values())
        bound_s = {"compute": 0.0, "memory": 0.0, "drifted": 0.0}
        rows = []
        drifted_keys: list[PlanKey] = []
        for key in keys:
            c = self._classify(key, cache)
            est, snap = c["est"], c["snap"]
            s = device_s.get(key, 0.0)
            n = calls.get(key, 0)
            bound_s["drifted" if c["drifted"] else c["bound"]] += s
            if c["drifted"]:
                drifted_keys.append(key)
            sugg = {"bm": None, "bk": None, "bn": None, "gain": None}
            if c["drifted"] and suggest:
                hw_name, M, K, N, din, dout, layout = key
                res = balance.solve_exhaustive(
                    M, K, N, hw=resolve_hw(hw_name),
                    in_dtype=torch_dtype(din), out_dtype=torch_dtype(dout),
                    b_layout=layout)
                step = res.chosen_step
                if step is not None:
                    sugg = {"bm": res.plan.bm, "bk": res.plan.bk,
                            "bn": res.plan.bn,
                            "gain": (None if step.t_total <= 0
                                     else est.t_total / step.t_total)}
            per_call = None if n == 0 else s / n
            rows.append({
                "key": _key_str(key),
                "hw": key[0], "m": key[1], "k": key[2], "n": key[3],
                "in_dtype": key[4], "out_dtype": key[5], "layout": key[6],
                "bm": c["plan"].bm, "bk": c["plan"].bk, "bn": c["plan"].bn,
                "calls": n,
                "device_s": s,
                "share": None if attributed <= 0 else s / attributed,
                "t_comp_s": est.t_comp,
                "t_mem_s": est.t_mem,
                "t_total_s": est.t_total,
                "balance_ratio": c["ratio"],
                "snapshot_ratio": None if snap is None else snap.ratio,
                "snapshot_t_total_s": None if snap is None else snap.t_total,
                "ratio_deviation": c["ratio_dev"],
                "time_deviation": c["time_dev"],
                "bound": c["bound"],
                "drifted": c["drifted"],
                "measured_per_call_s": per_call,
                # advisory only (the h100 model is not calibrated):
                # never a drift trigger
                "measured_vs_modeled": (
                    None if per_call is None or est.t_total <= 0
                    else per_call / est.t_total),
                "suggested_bm": sugg["bm"], "suggested_bk": sugg["bk"],
                "suggested_bn": sugg["bn"], "suggested_gain": sugg["gain"],
            })
        rows.sort(key=lambda r: (-r["device_s"], r["key"]))
        self._drifted = sorted(drifted_keys)
        total_bound = sum(bound_s.values())
        return {
            "tol": self.tol,
            "top_k": self.top_k,
            "signatures": len(rows),
            "attributed_device_s": attributed,
            "traced_device_s": traced_s,
            "unattributed_device_s": max(0.0, traced_s - attributed),
            "reconciliation_error": (
                None if traced_s <= 0
                else abs(attributed - traced_s) / traced_s),
            "bound_s": bound_s,
            "bound_share": {
                k: (None if total_bound <= 0 else v / total_bound)
                for k, v in bound_s.items()},
            "drifted_count": len(drifted_keys),
            "drifted": [_key_str(k) for k in self._drifted],
            "by_device_s": rows[: self.top_k],
        }

    def drifted_keys(self) -> list[PlanKey]:
        """Plan keys the last :meth:`summarize` flagged — the re-solve
        candidate list for ``autotune.refine_cached_plans``."""
        return list(self._drifted)
