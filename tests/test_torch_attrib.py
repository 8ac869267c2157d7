"""The port's balance auditor (``repro_torch.obs.attrib``), plan-cache
maintenance (``PlanCache.update``, solver listeners, balance snapshots)
and ``core.gemm``'s dispatch listeners against the reference's, on the
CPU.

* ``AttributionLedger.summarize`` / ``class_seconds``: equal to the
  reference's for equal profiles, dispatches and durations (under a TPU
  spec, so both caches hold the same plans), drift, its suggestion and the
  ``--rebalance-drifted`` restoration included; reconciliation error 0
  within 1e-9 (one float sum against another of the same terms).
* The engine's ledger: the same signatures as the reference engine's;
  ``calls`` a layer's count times ``n_layers`` for a layer signature (the
  port's warm-up runs the layers in a Python loop, the reference's
  ``lax.scan`` traces the body once) and equal for the unembed; fed the
  port's profiles, the reference's ledger summarizes exactly as the
  port's.
"""
import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import configs as RC
from repro import models as RM
from repro import serve as RS
from repro.core import gemm as RG
from repro.core.autotune import model_measure_fn as r_model_measure
from repro.core.autotune import refine_cached_plans as r_refine
from repro.core.context import use_context as r_use_context
from repro.core.plancache import BalanceSnapshot as RSnap
from repro.core.plancache import PlanCache as RPlanCache
from repro.kernels.ops import GemmPlan as RPlan
from repro.launch.mesh import make_local_mesh
from repro.obs import AttributionLedger as RLedger
from repro.obs import Tracer as RTracer
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch import serve as TS
from repro_torch.core import gemm as TG
from repro_torch.core.autotune import model_measure_fn as t_model_measure
from repro_torch.core.autotune import refine_cached_plans as t_refine
from repro_torch.core.context import use_context as t_use_context
from repro_torch.core.plancache import BalanceSnapshot as TSnap
from repro_torch.core.plancache import PlanCache as TPlanCache
from repro_torch.core.plancache import _key_str
from repro_torch.kernels.ops import GemmPlan as TPlan
from repro_torch.obs import GEMM_PHASES, PHASES, AttributionLedger, Tracer

HW = "tpu_v6e"
SHAPES = [(8, 64, 128), (8, 64, 512), (4, 64, 64), (32, 256, 384),
          (128, 512, 256), (512, 2560, 2560)]


def _caches(dtype="float32"):
    """A reference and a port plan cache, each solved for SHAPES under
    the TPU spec (the same plans and snapshots)."""
    rc, tc = RPlanCache(), TPlanCache()
    with r_use_context(plan_cache=rc, hw=HW):
        for m, k, n in SHAPES:
            RG.plan_for(m, k, n, in_dtype=jnp.dtype(dtype))
    with t_use_context(plan_cache=tc, hw=HW):
        for m, k, n in SHAPES:
            TG.plan_for(m, k, n, in_dtype=getattr(torch, dtype))
    return rc, tc


def _same_cache(rc, tc) -> None:
    assert {k: (p.bm, p.bk, p.bn) for k, p in tc.entries.items()} == \
        {k: (p.bm, p.bk, p.bn) for k, p in rc.entries.items()}
    assert {k: (s.t_comp, s.t_mem) for k, s in tc.balance.items()} == \
        {k: (s.t_comp, s.t_mem) for k, s in rc.balance.items()}


def _ledger_inputs(keys, seed: int):
    """Seeded profiles over the phase tags, dispatch counts and phase
    durations (host phases and an unprofiled device phase included)."""
    rng = np.random.default_rng(seed)
    tags = ["decode", "prefill-chunk@8", "prefill-chunk@32", "admit",
            "spec-verify"]
    profiles = {t: {keys[i]: int(rng.integers(1, 5))
                    for i in rng.choice(len(keys), size=3, replace=False)}
                for t in tags}
    dispatches = {t: int(rng.integers(0, 20)) for t in tags}
    durs = {p: [float(x) for x in rng.exponential(0.01, rng.integers(1, 6))]
            for p in ("decode", "prefill-chunk", "admit", "spec-verify",
                      "spec-draft", "sample", "bind")}
    return profiles, dispatches, durs


@pytest.mark.parametrize("perturb", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_summarize_matches_reference(seed, perturb):
    rc, tc = _caches()
    keys = sorted(rc.entries)
    profiles, dispatches, durs = _ledger_inputs(keys, seed)
    k = keys[seed % len(keys)]
    if perturb:  # double one plan's bk behind the auditor's back
        p = rc.entries[k]
        rc.entries[k] = RPlan(bm=p.bm, bk=2 * p.bk, bn=p.bn)
        tc.entries[k] = TPlan(bm=p.bm, bk=2 * p.bk, bn=p.bn)
    want, got = RLedger(tol=0.25, top_k=4), AttributionLedger(tol=0.25,
                                                                top_k=4)
    for led in (want, got):
        led.profiles = {t: dict(p) for t, p in profiles.items()}
        led.dispatches = dict(dispatches)
    a = got.summarize(durs, cache=tc)
    b = want.summarize(durs, cache=rc)
    assert a == b
    assert got.drifted_keys() == want.drifted_keys()
    assert got.class_seconds(durs, cache=tc) == \
        want.class_seconds(durs, cache=rc)
    live_keys = {k for t, prof in profiles.items() if dispatches[t]
                 for k in prof}
    assert a["drifted_count"] == int(perturb and k in live_keys)
    # a device phase none of whose tags ran (spec-draft never does) is the
    # unattributed time
    live = {t.split("@")[0] for t, n in dispatches.items() if n}
    assert a["unattributed_device_s"] == pytest.approx(
        sum(sum(d) for p, d in durs.items()
            if p in GEMM_PHASES and p not in live), rel=1e-9)


def test_rebalance_restores_drifted_plans_like_the_reference():
    rc, tc = _caches()
    keys = sorted(rc.entries)
    orig = dict(rc.entries)
    for k in keys[:3]:
        p = rc.entries[k]
        rc.entries[k] = RPlan(bm=p.bm, bk=2 * p.bk, bn=p.bn)
        tc.entries[k] = TPlan(bm=p.bm, bk=2 * p.bk, bn=p.bn)
    want, got = RLedger(), AttributionLedger()
    for led in (want, got):
        led.profiles = {"decode": {k: 1 for k in keys}}
        led.dispatches = {"decode": 3}
    durs = {"decode": [0.5, 0.25, 0.125]}
    assert got.summarize(durs, cache=tc) == want.summarize(durs, cache=rc)
    drifted = got.drifted_keys()
    assert drifted == want.drifted_keys() and len(drifted) >= 1
    rs = r_refine(rc, keys=want.drifted_keys(), resolve=True,
                  measure_factory=lambda M, K, N, **kw: r_model_measure(
                      M, K, N, hw=HW, **kw))
    ts = t_refine(tc, keys=drifted, resolve=True,
                  measure_factory=lambda M, K, N, **kw: t_model_measure(
                      M, K, N, hw=HW, **kw))
    assert ts == rs and ts["refined"] >= 1
    _same_cache(rc, tc)
    s = got.summarize(durs, cache=tc)
    assert s == want.summarize(durs, cache=rc)
    assert s["drifted_count"] == 0
    assert all(tc.entries[k] == TPlan(orig[k].bm, orig[k].bk, orig[k].bn)
               for k in drifted)


def test_ledger_capture_counts_plan_for_consultations():
    led = AttributionLedger()
    with t_use_context(plan_cache=TPlanCache(), hw=HW):
        with led.capture("decode"):
            TG.plan_for(8, 64, 128, in_dtype=torch.float32)
            TG.plan_for(8, 64, 128, in_dtype=torch.float32)
            TG.plan_for(4, 64, 64, in_dtype=torch.float32)
    assert TG._dispatch_listeners == []
    prof = led.profiles["decode"]
    assert sorted(prof.values()) == [1, 2]
    led.dispatch("decode")
    led.dispatch("decode", 4)
    assert led.dispatches == {"decode": 5}
    led.reset_run()
    assert led.dispatches == {} and led.profiles


def test_dispatch_listener_sees_hits_and_misses_like_the_reference():
    seen = {"r": [], "t": []}
    rl = lambda key, plan: seen["r"].append((key, (plan.bm, plan.bk,
                                                   plan.bn)))
    tl = lambda key, plan: seen["t"].append((key, (plan.bm, plan.bk,
                                                   plan.bn)))
    RG.add_dispatch_listener(rl)
    TG.add_dispatch_listener(tl)
    try:
        with r_use_context(plan_cache=RPlanCache(), hw=HW):
            for m, k, n in SHAPES + SHAPES[:2]:
                RG.plan_for(m, k, n, in_dtype=jnp.bfloat16)
        with t_use_context(plan_cache=TPlanCache(), hw=HW):
            for m, k, n in SHAPES + SHAPES[:2]:
                TG.plan_for(m, k, n, in_dtype=torch.bfloat16)
    finally:
        RG.remove_dispatch_listener(rl)
        TG.remove_dispatch_listener(tl)
        TG.remove_dispatch_listener(tl)  # a second removal is a no-op
    assert seen["t"] == seen["r"] and len(seen["t"]) == len(SHAPES) + 2


def test_plan_cache_update_and_listeners_match_reference(tmp_path):
    key = (HW, 8, 64, 128, "float32", "float32", "row")
    events = {"r": [], "t": []}
    caches = {"r": RPlanCache(), "t": TPlanCache()}
    plan = {"r": RPlan, "t": TPlan}
    snap = {"r": RSnap, "t": TSnap}
    for side, c in caches.items():
        c.add_listener(lambda ev, k, side=side: events[side].append((ev, k)))
        c.get(key)
        with c.warmup():
            c.put(key, plan[side](8, 128, 128), balance=snap[side](1.0, 2.0))
        c.put(("x",) + key[1:], plan[side](8, 128, 128))
        before = c.stats.snapshot()
        c.update(key, plan[side](16, 128, 128),
                 balance=snap[side](2.0, 1.0))
        assert c.entries[key].bm == 16 and c.balance[key].t_comp == 2.0
        c.update(key, plan[side](8, 128, 128))
        assert key not in c.balance
        after = c.stats.snapshot()
        assert (after.hits, after.misses, after.warm_solves,
                after.lazy_solves) == (before.hits, before.misses,
                                       before.warm_solves,
                                       before.lazy_solves)
    assert events["t"] == events["r"] == [
        ("miss", key), ("warm_solve", key), ("lazy_solve", ("x",) + key[1:])]
    s = TSnap(t_comp=1e-7, t_mem=2e-7)
    assert s.t_total == 2e-7 and s.ratio == pytest.approx(0.5)
    assert TSnap(t_comp=1.0, t_mem=0.0).ratio is None
    # snapshots round-trip through the JSON both packages read
    path = tmp_path / "plans.json"
    c = TPlanCache(path=str(path))
    c.put(key, TPlan(8, 128, 128), balance=s)
    c.save()
    r = RPlanCache(path=str(path))
    assert r.load() == 1 and r.balance[key].ratio == pytest.approx(0.5)


def test_gemm_phases_are_tracer_device_phases():
    assert all(PHASES[p] == "device" for p in GEMM_PHASES)
    assert {p for p, kind in PHASES.items() if kind == "device"} == \
        set(GEMM_PHASES)


# ------------------------------------------------------------ the engine
@pytest.fixture(scope="module")
def setup():
    rcfg = RC.smoke(RC.get_config("qwen1.5-4b"))
    tcfg = TC.ModelConfig(**dataclasses.asdict(rcfg))
    rparams = RM.init(jax.random.PRNGKey(3), rcfg)
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, rparams),
                                      tcfg, "cpu")
    return rcfg, tcfg, rparams, tparams


def _engine_kw(pkg):
    return dict(num_slots=2, max_len=20, prompt_pad=8, kv_block_size=4,
                num_kv_blocks=14, prefill_chunk=4, clock=pkg.SimClock(1e-3))


def _trace(pkg, vocab):
    return pkg.synthetic_trace(5, vocab_size=vocab, prompt_lens=[8, 3, 6],
                               max_new_tokens=[4, 2, 3], seed=7)


@pytest.mark.parametrize("spec", [False, True])
def test_engine_attribution_matches_reference(setup, spec):
    rcfg, tcfg, rparams, tparams = setup
    V = rcfg.vocab_size
    rkw, tkw = _engine_kw(RS), _engine_kw(TS)
    if spec:
        rkw.update(spec_draft_cfg=rcfg, spec_draft_params=rparams, spec_k=2)
        tkw.update(spec_draft_cfg=tcfg, spec_draft_params=tparams, spec_k=2)
    with r_use_context(plan_cache=RPlanCache(), hw=HW):
        reng = RS.ServeEngine(rcfg, make_local_mesh(), rparams,
                              tracer=RTracer(), **rkw)
        reng.plan_warmup()
        rm = reng.run(_trace(RS, V))
    tcache = TPlanCache()
    with t_use_context(plan_cache=tcache, hw=HW):
        teng = TS.ServeEngine(tcfg, tparams, tracer=Tracer(), **tkw)
        teng.plan_warmup()
        tm = teng.run(_trace(TS, V))
    assert dict(teng.dispatches) == dict(reng.attrib.dispatches)
    assert set(teng.attrib.profiles) == set(reng.attrib.profiles)
    L, unembed_n = tcfg.n_layers, tcfg.padded_vocab
    for tag, prof in reng.attrib.profiles.items():
        assert set(teng.attrib.profiles[tag]) == set(prof), tag
        for key, n in prof.items():
            per = 1 if key[3] == unembed_n else L
            assert teng.attrib.profiles[tag][key] == per * n, (tag, key)
    ta, ra = tm.attribution, rm.attribution
    assert ta["signatures"] == ra["signatures"]
    assert ta["reconciliation_error"] == pytest.approx(0.0, abs=1e-9)
    assert ra["reconciliation_error"] == pytest.approx(0.0, abs=1e-9)
    # the reference's ledger on the port's profiles, dispatches and spans
    # summarizes exactly as the port's
    rc = RPlanCache()
    for k, p in tcache.entries.items():
        rc.entries[k] = RPlan(p.bm, p.bk, p.bn)
        s = tcache.balance[k]
        rc.balance[k] = RSnap(s.t_comp, s.t_mem)
    led = RLedger(tol=teng.attrib.tol)
    led.profiles = {t: dict(p) for t, p in teng.attrib.profiles.items()}
    led.dispatches = dict(teng.attrib.dispatches)
    durs = teng.tracer.device_durations()
    assert led.summarize(durs, cache=rc) == \
        teng.attrib.summarize(durs, cache=tcache) == ta
    gauges = teng.registry.collect()
    assert gauges["repro_attrib_signatures"] == ta["signatures"]
    assert gauges["repro_attrib_drifted"] == 0.0


def test_engine_flags_a_perturbed_plan_and_rebalance_restores_it(setup):
    """Perturb one warm plan, run: the auditor flags exactly it; the
    model re-solve restores the solver's plan and its snapshot; a rerun
    is clean, with zero lazy solves throughout."""
    _, tcfg, _, tparams = setup
    cache = TPlanCache()
    with t_use_context(plan_cache=cache):
        engine = TS.ServeEngine(tcfg, tparams, tracer=Tracer(),
                                **_engine_kw(TS))
        engine.plan_warmup()
        key = max(cache.entries, key=lambda k: (k[1], k[3]))
        original = cache.entries[key]
        cache.entries[key] = TPlan(bm=original.bm, bk=original.bk * 2,
                                   bn=original.bn)
        m = engine.run(_trace(TS, tcfg.vocab_size))
        assert m.plan_cache["steady_state"] is True
        assert m.attribution["drifted"] == [_key_str(key)]
        assert engine.attrib.drifted_keys() == [key]
        assert engine.registry.collect()["repro_attrib_drifted"] == 1.0
        stats = t_refine(cache, keys=engine.attrib.drifted_keys(),
                         resolve=True,
                         measure_factory=lambda M, K, N, **kw:
                         t_model_measure(M, K, N, hw=key[0], **kw))
        assert stats["refined"] == 1 and cache.entries[key] == original
        engine.reset()
        warm = cache.stats.snapshot()
        m2 = engine.run(_trace(TS, tcfg.vocab_size))
        assert m2.attribution["drifted_count"] == 0
        assert cache.stats.lazy_solves == warm.lazy_solves
        assert json.loads(m2.to_json())["attribution"]["drifted"] == []
