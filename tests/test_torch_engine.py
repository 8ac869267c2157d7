"""The port's continuous-batching engine against the reference's, on the
CPU, from the same weights (``interop.params_from_jax``) and the same
seeded traces under the deterministic ``SimClock``.

Three modes: contiguous per-slot lanes; paged with the prefix cache and
the TTFT budget controller; paged with the preemptive priority policy.
Both engines must give the same admission, preemption and eviction
sequence (every finished request's lane, ticks, finish reason,
preemptions and cached prefix, and the aggregate counters) and the same
tokens wherever the reference's top-2 logit margin exceeds the f32
tolerance of ``tests/test_torch_lm.py`` (1e-4; below it the two
summation orders may pick either token). Also: the plan warm-up leaves
serving zero lazy solves, the metrics JSON fits the reference's golden
schema, the CLI's ``--engine`` runs in-process, and the CUDA-graph
capture helper's CPU behaviour and launch accounting.
"""
import dataclasses
import json

import numpy as np
import pytest
import jax
import torch

from repro import configs as RC
from repro import models as RM
from repro import serve as RS
from repro.core.context import use_context as r_use_context
from repro.core.plancache import PlanCache as RPlanCache
from repro.launch.mesh import make_local_mesh
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch import serve as TS
from repro_torch.core.context import use_context as t_use_context
from repro_torch.core.plancache import PlanCache as TPlanCache
from repro_torch.core.plancache import PlanCacheColdError
from repro_torch.kernels import decode_matvec, matmul
from repro_torch.launch import serve as tserve
from repro_torch.train import graphs
from test_metrics_schema import GOLDEN, match, walk

TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    rcfg = RC.smoke(RC.get_config("qwen1.5-4b"))
    tcfg = TC.ModelConfig(**dataclasses.asdict(rcfg))
    rparams = RM.init(jax.random.PRNGKey(3), rcfg)
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, rparams),
                                      tcfg, "cpu")
    return rcfg, tcfg, rparams, tparams


def _mode(pkg, name: str, vocab: int):
    """(engine keyword arguments, trace) of one mode, built from ``pkg``'s
    trace generators (the same seeds on both sides)."""
    if name == "contiguous":
        return (dict(num_slots=2, max_len=16, prompt_pad=8,
                     clock=pkg.SimClock(1e-3)),
                pkg.synthetic_trace(5, vocab_size=vocab,
                                    prompt_lens=[8, 4, 6],
                                    max_new_tokens=[4, 2, 3], seed=7))
    if name == "paged_prefix":
        return (dict(num_slots=2, max_len=20, prompt_pad=8, kv_block_size=4,
                     num_kv_blocks=14, prefill_chunk=4, prefix_cache=True,
                     ttft_target_ms=5.0, max_prefill_chunks=2,
                     clock=pkg.SimClock(1e-3)),
                pkg.shared_prefix_trace(6, vocab_size=vocab, header_len=8,
                                        tail_lens=[1, 3],
                                        max_new_tokens=[5, 3], seed=1))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, size=6) for _ in range(3)]
    return (dict(num_slots=1, max_len=24, prompt_pad=8, kv_block_size=4,
                 num_kv_blocks=13, sched_policy="priority",
                 clock=pkg.SimClock(1e-4)),
            [pkg.Request(prompt=prompts[0], max_new_tokens=10, priority=0),
             pkg.Request(prompt=prompts[1], max_new_tokens=3, priority=5,
                         arrival_s=0.002),
             pkg.Request(prompt=prompts[2], max_new_tokens=4, priority=2,
                         arrival_s=0.003)])


def _record_samples(engine, vocab: int) -> list:
    """Wrap the engine's sampler: (request id, token, top-2 margin, top-1
    value) for every sampled token, in order."""
    log = []
    sample = engine._sample

    def recorded(row, st):
        tok = sample(row, st)
        top = np.sort(np.asarray(row[:vocab], np.float64))[-2:]
        log.append((st.request.request_id, tok, top[1] - top[0], top[1]))
        return tok

    engine._sample = recorded
    return log


def _run(engine, trace, vocab: int):
    log = _record_samples(engine, vocab)
    engine.plan_warmup()
    m = engine.run(trace)
    ids = {r.request_id: i for i, r in enumerate(trace)}
    seq = [(ids[st.request.request_id], st.slot, st.admitted_tick,
            st.first_token_tick, st.finished_tick, st.finish_reason,
            st.preemptions, st.cached_tokens) for st in engine.finished]
    tokens = {ids[st.request.request_id]: st.tokens
              for st in engine.finished}
    agg = m.to_dict()["aggregate"]
    return seq, tokens, agg, [(ids[r], *rest) for r, *rest in log], m


@pytest.mark.parametrize("mode", ["contiguous", "paged_prefix",
                                  "paged_preemptive"])
def test_engine_matches_reference_under_simclock(setup, mode):
    rcfg, tcfg, rparams, tparams = setup
    V = rcfg.vocab_size
    rkw, rtrace = _mode(RS, mode, V)
    tkw, ttrace = _mode(TS, mode, V)
    with r_use_context(plan_cache=RPlanCache()):
        want = _run(RS.ServeEngine(rcfg, make_local_mesh(), rparams, **rkw),
                    rtrace, V)
    with t_use_context(plan_cache=TPlanCache()):
        got = _run(TS.ServeEngine(tcfg, tparams, **tkw), ttrace, V)
    assert got[0] == want[0]            # admission / eviction sequence
    assert got[2] == want[2]            # aggregate counters and rates
    if mode == "paged_preemptive":
        assert got[2]["preemptions"] >= 1
    if mode == "paged_prefix":
        assert got[4].prefix_cache["hit_tokens"] > 0
        assert got[4].budget["observations"] == len(ttrace)
    # tokens: equal up to each request's first near-tie in the reference
    sure = {}
    for idx, _, margin, top in want[3]:
        sure.setdefault(idx, []).append(margin > TOL * (1 + abs(top)))
    compared = 0
    for idx, toks in want[1].items():
        n = len(toks) if all(sure[idx]) else sure[idx].index(False)
        assert got[1][idx][:n] == toks[:n]
        compared += n
    assert compared >= 0.9 * sum(len(t) for t in want[1].values())


def test_plan_warmup_then_run_makes_zero_lazy_solves(setup):
    _, tcfg, _, tparams = setup
    cache = TPlanCache()
    with t_use_context(plan_cache=cache):
        engine = TS.ServeEngine(tcfg, tparams, num_slots=2, max_len=24,
                                prompt_pad=8, kv_block_size=4,
                                prefill_chunk=8)
        warm = engine.plan_warmup()
        before = cache.stats.snapshot()
        m = engine.run(TS.synthetic_trace(
            5, vocab_size=tcfg.vocab_size, prompt_lens=[8, 3, 10],
            max_new_tokens=[4, 6], seed=4))
        assert cache.stats.lazy_solves == before.lazy_solves
        assert cache.stats.misses == before.misses
        assert m.plan_cache == {"hits": m.plan_cache["hits"], "misses": 0,
                                "lazy_solves": 0, "warm_solves": 0,
                                "steady_state": True}
        assert warm["signatures"] == warm["solved"] > 0
        assert set(engine.dispatches) == {"decode", "prefill-chunk@2",
                                          "prefill-chunk@4",
                                          "prefill-chunk@8"}
        assert len(engine.finished) == 5
        # a signature the warm-up never saw fails the steady-state check
        with pytest.raises(PlanCacheColdError):
            with cache.expect_steady_state("cold region"):
                from repro_torch.core.gemm import plan_for
                plan_for(3, 64, 96, in_dtype=torch.float32)


def test_metrics_json_matches_the_golden_schema(setup):
    """Every leaf of the port's metrics JSON matches a pattern (and type)
    of the reference's golden schema; the port exports the speculation
    section (``{"enabled": false}`` on these runs) and no traced-run
    sections."""
    _, tcfg, _, tparams = setup
    V = tcfg.vocab_size
    runs = [
        (dict(num_slots=2, max_len=16, prompt_pad=8),
         TS.synthetic_trace(3, vocab_size=V, prompt_lens=[8, 4],
                            max_new_tokens=[4, 2], seed=7)),
        (dict(num_slots=2, max_len=16, prompt_pad=8, kv_block_size=4,
              num_kv_blocks=33, prefix_cache=True, prefix_cache_blocks=8,
              prefill_chunk=4, ttft_target_ms=50.0),
         TS.shared_prefix_trace(3, vocab_size=V, header_len=4,
                                tail_lens=[2, 4], max_new_tokens=[4, 3])),
        (dict(num_slots=2, max_len=24, prompt_pad=8, kv_block_size=4,
              num_kv_blocks=17, prefill_chunk=4, sched_policy="edf",
              clock=TS.SimClock(1e-3)),
         TS.bursty_trace(8, vocab_size=V, burst_size=4, burst_gap_s=0.02,
                         classes=[dict(priority=2, prompt_lens=(6,),
                                       max_new_tokens=(4,),
                                       deadline_slack_s=30.0, weight=1.0),
                                  dict(priority=0, prompt_lens=(8,),
                                       max_new_tokens=(8,),
                                       deadline_slack_s=None, weight=1.0)],
                         seed=0)),
    ]
    seen = set()
    for kw, trace in runs:
        with t_use_context(plan_cache=TPlanCache()):
            engine = TS.ServeEngine(tcfg, tparams, **kw)
            engine.plan_warmup()
            d = json.loads(engine.run(trace).to_json())
        assert set(d) == {"engine", "aggregate", "requests", "slo",
                          "slo_burn", "budget", "block_pool", "kv_cache",
                          "prefix_cache", "speculation", "plan_cache"}
        assert d["speculation"] == {"enabled": False}
        for path, value in walk(d):
            pattern = match(path)
            assert pattern is not None, f"unknown metrics key: {path}"
            assert type(value) in GOLDEN[pattern], (path, value)
            seen.add(pattern)
    assert "kv_cache.bytes_ratio" in seen and "slo.*.p99_ttft_s" in seen
    assert "prefix_cache.hit_rate" in seen and "block_pool.pool_bytes" in seen


def test_serve_cli_engine_runs_in_process(tmp_path):
    out = tmp_path / "serve.json"
    res = tserve.main(["--smoke", "--engine", "--kv-block-size", "4",
                       "--device", "cpu", "--plan-cache", "",
                       "--metrics-json", str(out)])
    assert res["lazy_solves"] == 0 and res["misses"] == 0
    engine, trace = res["engine"], res["trace"]
    assert len(engine.finished) == len(trace) == 8
    assert all(st.finish_reason == "length" and st.tokens
               and all(0 <= t < engine.cfg.vocab_size for t in st.tokens)
               for st in engine.finished)
    assert json.loads(out.read_text())["aggregate"]["generated_tokens"] \
        == res["tokens"] > 0
    with pytest.raises(SystemExit):
        tserve.main(["--smoke", "--engine", "--kv-quantize", "int8",
                     "--device", "cpu"])


def test_captured_step_is_a_pass_through_on_the_cpu():
    seen = []

    def step(params, state, tokens, slot):
        seen.append((tokens, slot))
        state["n"] += 1
        return tokens.sum() + slot

    state = {"n": torch.zeros((), dtype=torch.int64)}
    cap = graphs.CapturedStep(step, "cpu")
    out = cap({}, state, np.array([[1], [2]]), 5)
    assert int(out) == 8 and int(state["n"]) == 1 and not cap.graphs
    tokens, slot = seen[0]
    assert tokens.dtype == slot.dtype == torch.int64
    assert slot.shape == () and tokens.device.type == "cpu"


def test_capture_launch_accounting_and_ticket_sizing(monkeypatch):
    """What a capture and its replays count, and the split-K ticket buffers'
    rules, checked without a card: a capture's own launches are put back,
    each replay adds the graph's launches to ``replayed``; an outgrown
    ticket buffer stays alive, and growing during capture raises."""
    graphs.reset_launches()
    matmul.launches = 3
    with graphs.counted() as made:
        matmul.launches += 4           # what a capture records
        decode_matvec.launches += 2
    assert made == {"matmul": 4, "gemv": 2, "wkv": 0}
    assert graphs.eager_launches() == {"matmul": 3, "gemv": 0, "wkv": 0}

    class FakeGraph:
        replays = 0

        def replay(self):
            self.replays += 1

    g = graphs._Graph(FakeGraph(), [], torch.zeros(2), made)
    for _ in range(5):
        assert g.replay() is g.out
    assert g.graph.replays == g.replays == 5
    assert graphs.replayed == {"matmul": 20, "gemv": 10, "wkv": 0}
    assert graphs.launches() == {"matmul": 23, "gemv": 10, "wkv": 0}
    graphs.reset_launches()
    assert graphs.launches() == {"matmul": 0, "gemv": 0, "wkv": 0}

    store = {}
    cpu = torch.device("cpu")
    first = matmul.grow_tickets(store, cpu, 10)
    assert first.numel() == 4096 and matmul.grow_tickets(store, cpu, 4096) \
        is first
    grown = matmul.grow_tickets(store, cpu, 5000)
    assert grown.numel() == 5000 and int(grown.abs().sum()) == 0
    assert any(t is first for t in matmul._outgrown)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    card = {0: torch.zeros(8, dtype=torch.int32)}
    with pytest.raises(RuntimeError, match="during CUDA graph capture"):
        matmul.grow_tickets(card, torch.device("cuda", 0), 9)
    assert matmul.grow_tickets(card, torch.device("cuda", 0), 8) is card[0]
