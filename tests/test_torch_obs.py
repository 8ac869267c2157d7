"""The port's flight recorder and counter registry (``repro_torch.obs``)
against the reference's (``repro.obs``), on the CPU.

* Tracer: the same seeded call scripts under the same injected fake clock
  (rings that wrap included) give equal ``to_chrome()``,
  ``phase_summary()`` and ``phase_durations()``, exactly (the clock's
  readings are sums of one step, so no tolerance applies); without a card
  ``device_durations()`` is the host durations.
* Registry: the same seeded operations give equal ``snapshot()`` lists and
  Prometheus text, exactly.
* ``validate_chrome_trace``: the same verdict on the same objects.
* The traced engine under ``SimClock``: token for token and metric for
  metric equal to an untraced run; its span names and counts a tick,
  request events and registry names equal the reference engine's; the
  metrics JSON's ``timing`` / ``attribution`` sections fit the reference's
  golden schema; the speculative engine's spans reconcile with its
  ``SpecStats`` and its ``serve_spec`` gauges are published.
* The launcher with every new flag on ``--device cpu``, its output read by
  ``tools/validate_trace.py`` and ``tools/serve_doctor.py``.
"""
import collections
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax

from repro import configs as RC
from repro import models as RM
from repro import obs as RO
from repro import serve as RS
from repro.core.context import use_context as r_use_context
from repro.core.plancache import PlanCache as RPlanCache
from repro.launch.mesh import make_local_mesh
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch import obs as TO
from repro_torch import serve as TS
from repro_torch.core.context import use_context as t_use_context
from repro_torch.core.plancache import PlanCache as TPlanCache
from repro_torch.launch import serve as tserve
from test_metrics_schema import GOLDEN, match, walk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    """Deterministic tracer clock: advances ``step`` a reading."""

    def __init__(self, step=0.25):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


def _script(seed: int, n: int = 120) -> list[tuple]:
    """A seeded sequence of tracer calls: spans (with and without slots
    and args), external spans, instants, counters and request lifecycles
    (preempt / resume / rewind / finish of open and closed requests)."""
    rng = np.random.default_rng(seed)
    names = sorted(TO.PHASES)
    ops = []
    for i in range(n):
        r = rng.integers(0, 8)
        req = int(rng.integers(0, 6))
        if r == 0:
            ops.append(("tick", i))
        elif r == 1:
            slot = None if rng.integers(0, 2) else int(rng.integers(0, 4))
            ops.append(("phase", names[rng.integers(0, len(names))], slot,
                        {"n": int(rng.integers(0, 9))} if slot else {}))
        elif r == 2:
            t0 = float(rng.integers(0, 100)) / 4
            ops.append(("span", names[rng.integers(0, len(names))], t0,
                        t0 + float(rng.integers(0, 8)) / 8))
        elif r == 3:
            ops.append(("instant", "plan-miss", {"key": f"k{req}"}))
        elif r == 4:
            ops.append(("counter", "pool", {"in_use": int(rng.integers(9)),
                                            "free": float(req)}))
        else:
            ev = RO.trace.REQUEST_EVENTS[rng.integers(
                0, len(RO.trace.REQUEST_EVENTS))]
            ops.append(("req", ev, req, {"slot": int(rng.integers(0, 4))}))
    return ops


def _play(tr, ops) -> None:
    for op in ops:
        kind = op[0]
        if kind == "tick":
            tr.set_tick(op[1])
        elif kind == "phase":
            with tr.phase(op[1], slot=op[2], **op[3]):
                pass
        elif kind == "span":
            tr.phase_span(op[1], op[2], op[3])
        elif kind == "instant":
            tr.instant(op[1], **op[2])
        elif kind == "counter":
            tr.counter(op[1], op[2])
        else:
            tr.request_event(op[1], op[2], **op[3])


@pytest.mark.parametrize("ring", [8, 64, 65536])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracer_matches_reference(seed, ring):
    ops = _script(seed)
    want = RO.Tracer(ring_events=ring, clock=FakeClock())
    got = TO.Tracer(ring_events=ring, clock=FakeClock())
    _play(want, ops)
    _play(got, ops)
    assert got.to_chrome() == want.to_chrome()
    assert got.phase_summary() == want.phase_summary()
    assert got.phase_durations() == want.phase_durations()
    assert got.events_dropped == want.events_dropped
    if ring == 8:
        assert got.events_dropped > 0
    # without a card a device phase's time is its host time
    got.time_device("cpu")
    assert got.device_durations() is got.phase_durations()
    assert got.device_mark() is None
    # the export gets the same verdict (a random script may leave async
    # spans unbalanced, which both must reject alike)
    assert _verdict(TO.validate_chrome_trace, got.to_chrome()) == \
        _verdict(RO.validate_chrome_trace, want.to_chrome())


def _verdict(validate, obj):
    try:
        return validate(obj)
    except ValueError as e:
        return str(e)


def test_tracer_reset_and_save_match_reference(tmp_path):
    ops = _script(5, n=40)
    want, got = RO.Tracer(clock=FakeClock()), TO.Tracer(clock=FakeClock())
    for tr in (want, got):
        _play(tr, ops)
        tr.reset()
        _play(tr, ops[:20])
    a = want.save(tmp_path / "r.json")
    b = got.save(tmp_path / "t.json")
    assert a == b
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "r.json").read_text())


def test_null_tracer_is_inert_and_reads_no_clock(monkeypatch):
    import time as _time

    def bomb():
        raise AssertionError("NullTracer read a clock")

    monkeypatch.setattr(_time, "perf_counter", bomb)
    monkeypatch.setattr(_time, "monotonic", bomb)
    tr = TO.NULL_TRACER
    assert tr.enabled is False
    assert tr.phase("decode") is tr.phase("sample", slot=1, n=2)
    tr.reset()
    tr.set_tick(3)
    tr.time_device("cpu")
    with tr.phase("decode", slot=0):
        pass
    tr.phase_span("spec-draft", 0.0, 1.0, marks=(tr.device_mark(), None))
    tr.instant("plan-miss", key="k")
    tr.counter("pool", {"in_use": 1})
    tr.request_event("submit", 1)
    assert tr.device_mark() is None
    assert tr.phase_durations() == tr.device_durations() == {}
    assert tr.phase_summary() == {}
    assert tr.__dict__ == {}


def test_glossary_and_request_events_match_reference():
    assert TO.PHASES == RO.PHASES
    assert TO.trace.REQUEST_EVENTS == RO.trace.REQUEST_EVENTS
    assert TO.GEMM_PHASES == RO.GEMM_PHASES


MALFORMED = [
    {"foo": []},
    {"traceEvents": [{"name": "x", "ph": "X", "ts": 0, "dur": -1,
                      "cat": "phase"}]},
    {"traceEvents": [{"name": "request", "ph": "e", "ts": 0, "id": "1"}]},
    {"traceEvents": [{"name": "c", "ph": "C", "ts": 0,
                      "args": {"x": "oops"}}]},
    {"traceEvents": [{"name": "r", "ph": "b", "ts": 0}]},
    {"traceEvents": [{"ph": "X", "ts": 0, "dur": 1}]},
    {"traceEvents": [{"name": "r", "ph": "b", "ts": 0, "id": 1}]},
]


@pytest.mark.parametrize("obj", MALFORMED)
def test_validator_rejects_what_the_reference_rejects(obj):
    with pytest.raises(ValueError) as want:
        RO.validate_chrome_trace(obj)
    with pytest.raises(ValueError) as got:
        TO.validate_chrome_trace(obj)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(require_phases=("decode",)),
                                dict(min_requests=1),
                                dict(min_preempts=1)])
def test_validator_floors_match_reference(kw):
    obj = {"traceEvents": []}
    with pytest.raises(ValueError) as want:
        RO.validate_chrome_trace(obj, **kw)
    with pytest.raises(ValueError) as got:
        TO.validate_chrome_trace(obj, **kw)
    assert str(got.value) == str(want.value)


def _registry_ops(reg, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(60):
        r = rng.integers(0, 6)
        name = f"m{rng.integers(0, 4)}"
        if r == 0:
            reg.counter(f"c_{name}", "a counter").inc(float(rng.integers(5)))
        elif r == 1:
            g = reg.gauge(f"g_{name}", "a gauge\nwith \\ escapes")
            g.set(float(rng.normal()))
            g.inc(0.5)
            g.dec(0.25)
        elif r == 2:
            h = reg.histogram(f"h_{name}", "seconds")
            for v in rng.exponential(0.01, size=rng.integers(1, 5)):
                h.observe(float(v))
        elif r == 3:
            reg.histogram("h_custom", buckets=(0.5, 2.0, 8.0)).observe(
                float(rng.integers(0, 10)))
        elif r == 4:
            out.append(reg.ingest("serve", {
                "ticks": int(rng.integers(100)), "ok": bool(rng.integers(2)),
                "name": "skipped", "none": None,
                "nested": {"a": float(rng.normal()), "b": {"c": i}}}))
        else:
            out.append(reg.snapshot(tick=i))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_matches_reference(seed):
    want, got = RO.Registry(), TO.Registry()
    assert _registry_ops(got, seed) == _registry_ops(want, seed)
    assert got.snapshots == want.snapshots
    assert got.collect() == want.collect()
    assert got.to_prometheus_text() == want.to_prometheus_text()
    with pytest.raises(TypeError):
        got.gauge("c_m0")
    with pytest.raises(ValueError):
        got.counter("c_x").inc(-1)


@pytest.mark.parametrize("name", ["a.b-c", "9lives", "", "ok_name:x",
                                  "sp ace/slash"])
def test_prom_name_matches_reference(name):
    assert TO.prom_name(name) == RO.prom_name(name)


# ------------------------------------------------------------ the engine
@pytest.fixture(scope="module")
def setup():
    rcfg = RC.smoke(RC.get_config("qwen1.5-4b"))
    tcfg = TC.ModelConfig(**dataclasses.asdict(rcfg))
    rparams = RM.init(jax.random.PRNGKey(3), rcfg)
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, rparams),
                                      tcfg, "cpu")
    return rcfg, tcfg, rparams, tparams


def _modes(pkg, vocab: int):
    """(engine keyword arguments, requests) of the compared modes, from
    ``pkg``'s generators with the same seeds: contiguous lanes; paged with
    the prefix cache, the TTFT budget and a pool tight enough to reclaim;
    paged with the preemptive priority policy."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, size=6) for _ in range(3)]
    return {
        "contiguous": (
            dict(num_slots=2, max_len=16, prompt_pad=8,
                 clock=pkg.SimClock(1e-3)),
            lambda: pkg.synthetic_trace(5, vocab_size=vocab,
                                        prompt_lens=[8, 4, 6],
                                        max_new_tokens=[4, 2, 3], seed=7)),
        "paged_prefix": (
            dict(num_slots=2, max_len=16, prompt_pad=8, kv_block_size=4,
                 num_kv_blocks=9, prefill_chunk=4, prefix_cache=True,
                 ttft_target_ms=5.0, max_prefill_chunks=2,
                 clock=pkg.SimClock(1e-3)),
            lambda: pkg.synthetic_trace(6, vocab_size=vocab,
                                        prompt_lens=[8, 6],
                                        max_new_tokens=[4, 3], seed=2)),
        "paged_preemptive": (
            dict(num_slots=1, max_len=24, prompt_pad=8, kv_block_size=4,
                 num_kv_blocks=13, sched_policy="priority",
                 clock=pkg.SimClock(1e-4)),
            lambda: [pkg.Request(prompt=prompts[0], max_new_tokens=10,
                                 priority=0),
                     pkg.Request(prompt=prompts[1], max_new_tokens=3,
                                 priority=5, arrival_s=0.002),
                     pkg.Request(prompt=prompts[2], max_new_tokens=4,
                                 priority=2, arrival_s=0.003)]),
    }


def _traced_run(pkg, engine_fn, reqs, tracer, interval=3):
    engine = engine_fn(tracer=tracer, metrics_interval_ticks=interval)
    engine.plan_warmup()
    m = engine.run(reqs)
    return engine, m


def _tick_spans(tr) -> collections.Counter:
    return collections.Counter((e["tick"], e["name"], e["slot"])
                               for e in tr.events if e["kind"] == "phase")


def _request_events(tr, ids) -> list:
    return [(e["event"], ids[e["req"]], e["tick"],
             {k: v for k, v in (e["args"] or {}).items()})
            for e in tr.events if e["kind"] == "request"]


def _metric_names(reg) -> list:
    return sorted(line.split()[0].split("{")[0]
                  for line in reg.to_prometheus_text().splitlines()
                  if not line.startswith("#"))


@pytest.mark.parametrize("mode", ["contiguous", "paged_prefix",
                                  "paged_preemptive"])
def test_traced_engine_matches_reference_engine(setup, mode):
    """The same weights, requests, SimClock and fake tracer clock: the
    port's spans by tick, name and slot, its request events, its
    ``timing`` section (host spans at one fake-clock step each) and its
    registry's metric names equal the reference engine's."""
    rcfg, tcfg, rparams, tparams = setup
    V = rcfg.vocab_size
    rkw, rreqs = _modes(RS, V)[mode]
    tkw, treqs = _modes(TS, V)[mode]
    rtr, ttr = RO.Tracer(clock=FakeClock()), TO.Tracer(clock=FakeClock())
    r_in, t_in = rreqs(), treqs()
    with r_use_context(plan_cache=RPlanCache()):
        reng, rm = _traced_run(RS, lambda **k: RS.ServeEngine(
            rcfg, make_local_mesh(), rparams, **rkw, **k), r_in, rtr)
    with t_use_context(hw="tpu_v5e", plan_cache=TPlanCache()):
        teng, tm = _traced_run(TS, lambda **k: TS.ServeEngine(
            tcfg, tparams, **tkw, **k), t_in, ttr)
    assert _tick_spans(ttr) == _tick_spans(rtr)
    rids = {r.request_id: i for i, r in enumerate(r_in)}
    tids = {r.request_id: i for i, r in enumerate(t_in)}
    assert _request_events(ttr, tids) == _request_events(rtr, rids)
    assert tm.timing == rm.timing
    assert dict(teng.dispatches) == dict(reng.attrib.dispatches)
    assert _metric_names(teng.registry) == _metric_names(reng.registry)
    assert len(teng.registry.snapshots) == len(reng.registry.snapshots)
    if mode == "paged_prefix":
        assert "reclaim" in tm.timing["phases"]
    if mode == "paged_preemptive":
        assert TO.validate_chrome_trace(ttr.to_chrome(),
                                        min_preempts=1)["preempts"] >= 1


def test_traced_run_equals_untraced_run(setup):
    """The zero-cost-when-off contract under SimClock: attaching a tracer
    changes neither the tokens nor any untimed section of the metrics."""
    _, tcfg, _, tparams = setup

    def go(tracer):
        kw, reqs = _modes(TS, tcfg.vocab_size)["paged_prefix"]
        with t_use_context(plan_cache=TPlanCache()):
            engine = TS.ServeEngine(tcfg, tparams, tracer=tracer,
                                    **kw)
            engine.plan_warmup()
            m = engine.run(reqs())
        toks = sorted((st.request.prompt.tobytes(), tuple(st.tokens))
                      for st in engine.finished)
        d = m.to_dict()
        for r in d["requests"]:
            r.pop("request_id")  # a process-wide counter
        return engine, toks, d

    off_engine, off_toks, off_d = go(None)
    assert off_engine.tracer is TO.NULL_TRACER
    _, on_toks, on_d = go(TO.Tracer())
    assert on_toks == off_toks
    assert "timing" not in off_d and "attribution" not in off_d
    timing = on_d.pop("timing")
    on_d.pop("attribution")
    assert on_d == off_d
    for name in ("expire", "bind", "prefill-chunk", "decode", "sample"):
        assert timing["phases"][name]["count"] > 0, name


def test_traced_metrics_json_fits_the_golden_schema(setup, tmp_path):
    """The traced run's ``timing`` and ``attribution`` sections have the
    reference's key set: every leaf matches a golden pattern and type, and
    the sections' top-level keys equal the reference engine's."""
    rcfg, tcfg, rparams, tparams = setup
    kw, reqs = _modes(TS, tcfg.vocab_size)["paged_prefix"]
    rkw, rreqs = _modes(RS, rcfg.vocab_size)["paged_prefix"]
    with t_use_context(plan_cache=TPlanCache()):
        _, m = _traced_run(TS, lambda **k: TS.ServeEngine(
            tcfg, tparams, **kw, **k), reqs(), TO.Tracer())
    with r_use_context(plan_cache=RPlanCache()):
        _, rm = _traced_run(RS, lambda **k: RS.ServeEngine(
            rcfg, make_local_mesh(), rparams, **rkw, **k), rreqs(),
            RO.Tracer())
    d = json.loads(m.to_json())
    want = json.loads(rm.to_json())
    assert set(d) == set(want)
    for section in ("timing", "attribution"):
        assert set(d[section]) == set(want[section]), section
    assert set(d["attribution"]["by_device_s"][0]) == \
        set(want["attribution"]["by_device_s"][0])
    seen = set()
    for path, value in walk(d):
        pattern = match(path)
        assert pattern is not None, f"unknown metrics key: {path}"
        assert type(value) in GOLDEN[pattern], (path, value)
        seen.add(pattern)
    assert "timing.phases.*.p99_s" in seen
    assert "attribution.reconciliation_error" in seen


def test_spec_spans_reconcile_with_spec_stats(setup, tmp_path):
    """spec-draft / spec-verify spans carry the clock readings that feed
    ``SpecStats.draft_s`` / ``verify_s`` (equal within 1e-9 relative: one
    sum against another of the same floats), one pair a round; the
    draft's admissions are ``admit`` spans inside ``bind``; the
    registry holds the ``repro_serve_spec_*`` gauges."""
    _, tcfg, _, tparams = setup
    tr = TO.Tracer()
    with t_use_context(plan_cache=TPlanCache()):
        engine = TS.ServeEngine(tcfg, tparams, num_slots=2, max_len=24,
                                prompt_pad=8, kv_block_size=8, tracer=tr,
                                spec_draft_cfg=tcfg,
                                spec_draft_params=tparams, spec_k=2,
                                metrics_interval_ticks=2)
        engine.plan_warmup()
        m = engine.run(TS.synthetic_trace(3, vocab_size=tcfg.vocab_size,
                                          prompt_lens=[8, 4, 6],
                                          max_new_tokens=[4, 6, 3], seed=7))
    sp = m.speculation
    durs = tr.phase_durations()
    assert sp["rounds"] > 0
    assert sum(durs["spec-draft"]) == pytest.approx(sp["draft_s"], rel=1e-9)
    assert sum(durs["spec-verify"]) == pytest.approx(sp["verify_s"],
                                                     rel=1e-9)
    assert len(durs["spec-draft"]) == len(durs["spec-verify"]) \
        == engine.dispatches["spec-verify"]
    assert len(durs["admit"]) == engine.dispatches["admit"] == 3
    text = engine.registry.to_prometheus_text()
    assert f"repro_serve_spec_rounds {sp['rounds']}" in text
    assert "repro_serve_spec_acceptance_rate" in text
    att = m.attribution
    assert att["reconciliation_error"] == pytest.approx(0.0, abs=1e-9)
    # the saved trace (rewind events included) is JSON and validates
    obj = json.loads(json.dumps(tr.save(tmp_path / "spec.json")))
    info = TO.validate_chrome_trace(obj, require_phases=(
        "admit", "spec-draft", "spec-verify", "sample"), min_requests=3)
    assert info["completed_requests"] == 3


def test_serve_cli_with_every_new_flag_feeds_the_tools(tmp_path):
    """The launcher with --trace-out, --trace-ring-events,
    --metrics-interval-ticks, --measure-plans, --attrib-tol and
    --rebalance-drifted on the CPU; the reference's tools read its trace
    and metrics JSON."""
    t, m = tmp_path / "t.json", tmp_path / "m.json"
    res = tserve.main(["--smoke", "--engine", "--kv-block-size", "4",
                       "--device", "cpu", "--plan-cache", "",
                       "--trace-out", str(t), "--trace-ring-events", "4096",
                       "--metrics-json", str(m),
                       "--metrics-interval-ticks", "2", "--measure-plans",
                       "--attrib-tol", "0.25", "--rebalance-drifted"])
    assert res["lazy_solves"] == 0 and res["misses"] == 0
    stats = res["measured"]["stats"]
    assert stats["measured"] > 0 and stats["skipped"] == 0
    assert stats["refined"] + stats["kept"] == len(
        res["context"].plan_cache.warm_keys)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "validate_trace.py"),
         str(t), "--require-phases", "expire,bind,prefill-chunk,decode,sample",
         "--min-requests", "8"], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "8 completed requests" in out.stdout
    doc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "serve_doctor.py"),
         str(m), "--trace", str(t), "--max-reconciliation-error", "1e-9"],
        capture_output=True, text=True, env=env, timeout=300)
    assert doc.returncode == 0, doc.stdout + doc.stderr
    assert "Balance attribution" in doc.stdout
    prom = (tmp_path / "m.json.prom").read_text()
    assert "repro_serve_phase_decode_seconds_bucket" in prom
    assert "repro_plan_cache_lazy_solves 0" in prom
    with pytest.raises(SystemExit):
        tserve.main(["--smoke", "--engine", "--kv-block-size", "4",
                     "--device", "cpu", "--plan-cache", "",
                     "--rebalance-drifted"])


def test_device_timing_resolves_event_pairs_once(monkeypatch):
    """The device-time path with the CUDA calls stood in for (this host has
    no card): device phases' spans (and external spans given marks) record
    event pairs, host phases none; reading ``device_durations`` resolves
    every pending pair after one synchronize, puts each span's device ms in
    its args, and leaves ``phase_durations`` / ``phase_summary`` the host
    spans; a mark inside a graph capture raises."""
    import torch

    syncs, capturing = [], [False]

    class Event:
        made = 0

        def __init__(self, enable_timing=False):
            assert enable_timing
            Event.made += 1
            self.n = Event.made

        def record(self, stream=None):
            pass

        def elapsed_time(self, end):  # ms: 2 per event between the pair
            return 2.0 * (end.n - self.n)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(a))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    tr = TO.Tracer(clock=FakeClock(0.5))
    tr.time_device("cuda")
    with tr.phase("decode"):
        pass
    with tr.phase("sample"):
        pass
    m0 = tr.device_mark()
    m1 = tr.device_mark()
    tr.phase_span("spec-draft", 1.0, 4.0, marks=(m0, m1))
    with tr.phase("prefill-chunk", slot=1):
        with tr.phase("bind"):
            pass
    assert Event.made == 6 and syncs == []
    dev = tr.device_durations()
    assert len(syncs) == 1
    assert dev["decode"] == [0.002] and dev["spec-draft"] == [0.002]
    assert dev["prefill-chunk"] == [0.002]
    assert dev["sample"] == tr.phase_durations()["sample"] == [0.5]
    assert tr.phase_durations()["decode"] == [0.5]
    assert tr.phase_summary()["device_s"] == 0.5 + 3.0 + 1.5
    tr.device_durations()
    assert len(syncs) == 1  # nothing pending: no second synchronize
    spans = {e["name"]: e for e in tr.to_chrome()["traceEvents"]
             if e.get("cat") == "phase"}
    assert spans["decode"]["args"]["device_ms"] == 2.0
    assert "device_ms" not in spans["sample"]["args"]
    capturing[0] = True
    with pytest.raises(RuntimeError, match="captured"):
        with tr.phase("decode"):
            pass
