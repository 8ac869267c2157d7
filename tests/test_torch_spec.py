"""The port's speculative decoding against the reference's, on the CPU,
from the same weights (``interop.params_from_jax``), lengths, block tables
and seeded traces.

qwen1.5-4b-smoke (2 layers, d_model 64, f32 activations). Tolerances:

* the host-side math (``serve/spec.py``, the scheduler's rewind, the
  stats) is exact: the same numbers in, the same numbers out;
* ``paged_verify_attention`` and ``verify_step``: the two sides differ in
  f32 summation order only, so outputs and logits are held to
  ``tests/test_torch_lm.py``'s 1e-4; the activation-dtype pool to 1e-5
  (K/V of one projection; a null-block write from the wrong row would be
  off by O(1)); the int8 pool's codes equal and its scales within 1e-6
  relative, as ``tests/test_torch_paged_int8.py`` holds them;
* the port's verify logits against k + 1 of its own sequential decode
  steps: the same ops on the same inputs, the GEMMs at another row count,
  so 1e-4 on the bf16-free pool; on the int8 pool the verify pass
  quantizes a block's new tokens at once where decode requantizes the
  block at every token, so the dequantized keys differ by up to a scale
  step: the reference's pinned 0.1 of ``tests/test_paged_kv.py`` for the
  two pool formats;
* the engines under ``SimClock``: the admission sequence, aggregates,
  tokens and the ``speculation`` section (but for its two host-clock
  seconds) equal.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from hypothesis_compat import given, settings, st
from repro import configs as RC
from repro import models as RM
from repro import serve as RS
from repro.core.context import use_context as r_use_context
from repro.core.plancache import PlanCache as RPlanCache
from repro.launch.mesh import make_local_mesh
from repro.layers import attention as RA
from repro.serve import spec as RSP
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch import models as TM
from repro_torch import serve as TS
from repro_torch.core.context import use_context as t_use_context
from repro_torch.core.plancache import PlanCache as TPlanCache
from repro_torch.launch import serve as tserve
from repro_torch.layers import attention as TA
from repro_torch.serve import spec as TSP
from test_torch_engine import _run

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import metrics_diff  # noqa: E402
import serve_doctor  # noqa: E402

TOL = 1e-4
B, MAX_LEN, BS = 3, 16, 4
NB = 13                     # lanes own blocks 1-3, 4-6, 7-9; block 0 null
K = 3                       # speculation depth of the direct tests


@pytest.fixture(scope="module")
def weights():
    rcfg = RC.smoke(RC.get_config("qwen1.5-4b"))
    tcfg = TC.ModelConfig(**dataclasses.asdict(rcfg))
    rp = RM.init(jax.random.PRNGKey(3), rcfg)
    return rcfg, tcfg, rp, interop.params_from_jax(
        jax.tree.map(np.asarray, rp), tcfg, "cpu")


def _i(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64))


# ------------------------------------------------------ host-side math
@settings(max_examples=60, deadline=None)
@given(k=st.integers(1, 6), data=st.data())
def test_accept_prefix_matches_reference(k, data):
    tok = st.integers(0, 4)
    proposed = data.draw(st.lists(tok, min_size=k, max_size=k))
    greedy = np.array(data.draw(st.lists(tok, min_size=k + 1,
                                         max_size=k + 1)))
    assert TSP.accept_prefix(proposed, greedy) == \
        RSP.accept_prefix(proposed, greedy)
    with pytest.raises(ValueError):
        TSP.accept_prefix(proposed, greedy[:k])


@settings(max_examples=60, deadline=None)
@given(k=st.integers(1, 8), j=st.integers(-1, 9),
       length=st.integers(2, 500))
def test_rewind_and_draft_sync_match_reference(k, j, length):
    for fn, args in ((TSP.verify_rewind, (k, j)),
                     (TSP.draft_sync, (length, j, k))):
        rfn = getattr(RSP, fn.__name__)
        try:
            want = rfn(*args)
        except ValueError:
            with pytest.raises(ValueError):
                fn(*args)
            continue
        assert fn(*args) == want


@settings(max_examples=40, deadline=None)
@given(s=st.integers(1, 5), v=st.integers(2, 40), pad=st.integers(0, 8),
       seed=st.integers(0, 2**16), ties=st.booleans())
def test_greedy_rows_matches_reference(s, v, pad, seed, ties):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(s, v + pad)).astype(np.float32)
    if ties:   # first-index tie-break on both sides
        logits = np.round(logits)
    got = TSP.greedy_rows(logits, v)
    np.testing.assert_array_equal(got, RSP.greedy_rows(logits, v))
    assert (got < v).all()


@pytest.mark.parametrize("j", range(K + 2))
def test_scheduler_rewind_arithmetic_matches_reference(j):
    """advance_written(k+1) before a round's commits, rewind(k-j) after:
    the tracked KV length lands on the derived count on both packages (a
    finish truncates the commits: j = k + 1 stands for that round)."""
    k = K
    lens = []
    for pkg in (RS, TS):
        s = pkg.SlotScheduler(1, max_len=64, spec=True,
                              pool=pkg.BlockPool(num_blocks=9, block_size=8))
        s.submit(pkg.Request(prompt=np.arange(5, dtype=np.int32),
                             max_new_tokens=32))
        st_ = s.admit_next()
        s.prefill_advance(st_.slot, 5)
        st_.tokens.append(7)
        s.advance_written(st_.slot, k + 1)
        n_acc = min(j, k)
        st_.tokens.extend(range(n_acc + 1))
        s.rewind(st_.slot, TSP.verify_rewind(k, n_acc))
        assert st_.live_kv_tokens == 5 + len(st_.tokens)
        with pytest.raises(ValueError):
            s.rewind(st_.slot, st_.live_kv_tokens + 1)
        with pytest.raises(ValueError):
            s.advance_written(st_.slot, -1)
        lens.append((st_.kv_written, st_.live_kv_tokens))
        s.preempt(st_.slot)             # tracking restarts at the resume
        assert st_.kv_written == -1
    assert lens[0] == lens[1]


def test_spec_stats_to_dict_matches_reference():
    rounds = [(4, 4, 5), (4, 1, 2), (4, 0, 1), (4, 2, 2)]
    got, want = TSP.SpecStats(spec_k=4), RSP.SpecStats(spec_k=4)
    for r in rounds:
        got.record_round(*r)
        want.record_round(*r)
    got.draft_s = want.draft_s = 0.25
    assert got.to_dict() == want.to_dict()
    assert got.bonus == 3 and got.acceptance_rate == 7 / 16
    assert TSP.SpecStats().to_dict() == RSP.SpecStats().to_dict()


def test_validation_rejects_sampling_under_spec():
    greedy = TS.Request(prompt=np.arange(4, dtype=np.int32),
                        max_new_tokens=4)
    greedy.validate(spec=True)
    hot = TS.Request(prompt=np.arange(4, dtype=np.int32), max_new_tokens=4,
                     temperature=0.7)
    hot.validate()
    with pytest.raises(ValueError, match="speculative"):
        hot.validate(spec=True)
    nucleus = TS.Request(prompt=np.arange(4, dtype=np.int32),
                         max_new_tokens=4, top_p=0.9)
    with pytest.raises(ValueError, match="speculative"):
        nucleus.validate(spec=True)
    s = TS.SlotScheduler(1, max_len=32, spec=True)
    with pytest.raises(ValueError, match="speculative"):
        s.submit(TS.Request(prompt=np.arange(4, dtype=np.int32),
                            max_new_tokens=4, temperature=0.5))


# ------------------------------------------------- the verify pass
def _pool(kv_dtype, rng, n_kv, hd):
    """A random pool (reference and port leaves), its table and lengths:
    lane 0 three tokens short of its table's end (a k + 1 = 4 window
    spills one position past it), lane 1 mid-block, lane 2 inactive."""
    shape = (NB, BS, n_kv, hd)
    if kv_dtype == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.01, 0.1, (NB, n_kv)).astype(np.float32)
        vs = rng.uniform(0.01, 0.1, (NB, n_kv)).astype(np.float32)
    else:
        k = rng.normal(size=shape).astype(np.float32)
        v = rng.normal(size=shape).astype(np.float32)
        ks = vs = None
    table = np.zeros((B, MAX_LEN // BS), np.int32)
    for lane in range(B):
        table[lane, :3] = 1 + 3 * lane + np.arange(3)
    table[0, 3] = 10                       # lane 0 owns its whole table
    length = np.array([MAX_LEN - 3, 6, 2], np.int32)
    r = RA.PagedKVCache(
        k=jnp.asarray(k), v=jnp.asarray(v), table=jnp.asarray(table),
        length=jnp.asarray(length),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs))
    t = TA.PagedKVCache(
        k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()),
        table=torch.from_numpy(table), length=torch.from_numpy(length),
        k_scale=None if ks is None else torch.from_numpy(ks.copy()),
        v_scale=None if vs is None else torch.from_numpy(vs.copy()))
    return r, t


def _assert_pool_equal(t, r):
    if t.k_scale is None:
        for f in ("k", "v"):
            np.testing.assert_allclose(getattr(t, f).numpy(),
                                       np.asarray(getattr(r, f)),
                                       rtol=0, atol=1e-5)
        return
    for f in ("k", "v"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(r, f)))
        np.testing.assert_allclose(getattr(t, f + "_scale").numpy(),
                                   np.asarray(getattr(r, f + "_scale")),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_verify_attention_matches_reference(weights, kv_dtype):
    """One layer's verify pass: the output, and every pool block after its
    writes (lane 0's spill past the table, the inactive lane 2 and the
    padded table entries all land on block 0, whose last row must win on
    both sides; the int8 pool rewrites S // bs + 2 blocks a lane)."""
    rcfg, tcfg, rp, tp = weights
    rng = np.random.default_rng(5)
    r, t = _pool(kv_dtype, rng, rcfg.n_kv_heads, rcfg.head_dim)
    x = rng.normal(size=(B, K + 1, rcfg.d_model)).astype(np.float32)
    active = np.array([1, 1, 0])
    rlp = jax.tree.map(lambda a: a[0], rp["layers"]["attn"])
    tlp = interop.tree_map(lambda a: a[0], tp["layers"]["attn"])
    with r_use_context(plan_cache=RPlanCache()), \
            t_use_context(plan_cache=TPlanCache()):
        want, rc = RA.paged_verify_attention(
            rlp, jnp.asarray(x), r, rope_theta=rcfg.rope_theta,
            active=jnp.asarray(active, jnp.int32))
        got, _ = TA.paged_verify_attention(
            tlp, torch.from_numpy(x), t, rope_theta=tcfg.rope_theta,
            active=_i(active))
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2],
                               rtol=TOL, atol=TOL)
    _assert_pool_equal(t, rc)
    # the lengths are the caller's (lm.verify_step) to advance
    assert t.length.tolist() == [MAX_LEN - 3, 6, 2]


def _prefilled(rcfg, tcfg, rp, tp, kv_dtype):
    """Lanes 0 and 1 prefilled in 4-token chunks on both packages."""
    kw = dict(per_slot=True, kv_block_size=BS, num_kv_blocks=NB,
              kv_dtype=None if kv_dtype == "bf16" else kv_dtype)
    rs = RM.init_decode_state(rcfg, B, MAX_LEN, **kw)
    ts = TM.init_decode_state(tcfg, B, MAX_LEN, device="cpu", **kw)
    rng = np.random.default_rng(11)
    for lane, n_prompt in ((0, 7), (1, 5)):
        prompt = rng.integers(0, rcfg.vocab_size, n_prompt)
        blocks = np.zeros(MAX_LEN // BS, np.int32)
        blocks[:3] = 1 + 3 * lane + np.arange(3)
        for start in range(0, n_prompt, 4):
            n = min(4, n_prompt - start)
            chunk = np.zeros((1, 4), np.int64)
            chunk[0, :n] = prompt[start:start + n]
            _, rs = RM.prefill_chunk(
                rp, jnp.asarray(chunk, jnp.int32), rcfg, rs,
                slot=jnp.asarray(lane, jnp.int32),
                start=jnp.asarray(start, jnp.int32),
                true_len=jnp.asarray(n, jnp.int32),
                blocks=jnp.asarray(blocks))
            TM.prefill_chunk(tp, _i(chunk), tcfg, ts, slot=_i(lane),
                             start=_i(start), true_len=_i(n),
                             blocks=_i(blocks))
    return rs, ts


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_verify_step_matches_reference(weights, kv_dtype):
    """verify_step over 2 layers: logits at every position, the lengths
    (advanced by k + 1 on the active lanes only) and the pool."""
    rcfg, tcfg, rp, tp = weights
    with r_use_context(plan_cache=RPlanCache()), \
            t_use_context(plan_cache=TPlanCache()):
        rs, ts = _prefilled(rcfg, tcfg, rp, tp, kv_dtype)
        toks = np.random.default_rng(2).integers(0, rcfg.vocab_size,
                                                 (B, K + 1))
        active = np.array([1, 1, 0])
        want, rs = RM.verify_step(rp, jnp.asarray(toks, jnp.int32), rcfg,
                                  rs, active=jnp.asarray(active, jnp.int32))
        got, _ = TM.verify_step(tp, _i(toks), tcfg, ts, active=_i(active))
    assert got.shape == (B, K + 1, tcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2],
                               rtol=TOL, atol=TOL)
    assert ts["kv"].length.tolist() == np.asarray(rs["kv"].length).tolist() \
        == [7 + K + 1, 5 + K + 1, 0]
    _assert_pool_equal(ts["kv"], rs["kv"])


def test_verify_step_rejects_non_paged_and_rwkv(weights):
    _, tcfg, _, tp = weights
    state = TM.init_decode_state(tcfg, 2, 8, per_slot=True, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        TM.verify_step(tp, _i(np.zeros((2, 2))), tcfg, state)
    rwkv = TC.smoke(TC.get_config("rwkv6-3b"))
    with pytest.raises(ValueError, match="KV-cache"):
        TM.verify_step({}, _i(np.zeros((2, 2))), rwkv, {})


@pytest.mark.parametrize("kv_dtype,tol", [("bf16", TOL), ("int8", 0.1)])
def test_verify_equals_sequential_decode(weights, kv_dtype, tol):
    """Position i's verify logits against what i + 1 sequential paged
    decode steps fed the same tokens compute, from copies of one state;
    the lengths after both are equal."""
    rcfg, tcfg, rp, tp = weights
    with r_use_context(plan_cache=RPlanCache()), \
            t_use_context(plan_cache=TPlanCache()):
        _, ts = _prefilled(rcfg, tcfg, rp, tp, kv_dtype)
        seq = interop.tree_map(lambda t: t.clone(), ts)
        toks = np.random.default_rng(4).integers(0, tcfg.vocab_size,
                                                 (B, K + 1))
        active = _i([1, 1, 0])
        ver, _ = TM.verify_step(tp, _i(toks), tcfg, ts, active=active)
        steps = [TM.decode_step(tp, _i(toks[:, i:i + 1]), tcfg, seq,
                                active=active)[0] for i in range(K + 1)]
    dec = torch.stack(steps, dim=1)
    err = ((ver - dec).abs() / (1 + dec.abs()))[:2].max().item()
    assert err <= tol, err
    assert ts["kv"].length.tolist() == seq["kv"].length.tolist()


# ------------------------------------------------------------ engines
def _spec_kw(pkg, **kw):
    return dict(num_slots=3, max_len=48, prompt_pad=8, kv_block_size=8,
                prefill_chunk=8, clock=pkg.SimClock(1e-3), **kw)


def _spec_trace(pkg, vocab):
    return pkg.synthetic_trace(5, vocab_size=vocab, prompt_lens=[4, 6, 8],
                               max_new_tokens=[6, 9, 4], seed=11)


@pytest.mark.parametrize("kv_quantize", [None, "int8"])
def test_spec_engine_matches_reference_under_simclock(weights, kv_quantize):
    """The port's speculative engine (draft = target, as the reference's
    own parity test) against the JAX package's: the same admissions,
    tokens and aggregates, and the same speculation section but for the
    host-clock seconds; then against the port's non-speculative engine,
    token for token, with zero lazy solves."""
    rcfg, tcfg, rp, tp = weights
    V = rcfg.vocab_size
    with r_use_context(plan_cache=RPlanCache()):
        want = _run(RS.ServeEngine(
            rcfg, make_local_mesh(), rp, spec_draft_cfg=rcfg,
            spec_draft_params=rp, spec_k=K,
            **_spec_kw(RS, kv_quantize=kv_quantize)), _spec_trace(RS, V), V)
    with t_use_context(plan_cache=TPlanCache()):
        got = _run(TS.ServeEngine(
            tcfg, tp, spec_draft_cfg=tcfg, spec_draft_params=tp, spec_k=K,
            **_spec_kw(TS, kv_quantize=kv_quantize)), _spec_trace(TS, V), V)
        base = _run(TS.ServeEngine(tcfg, tp,
                                   **_spec_kw(TS, kv_quantize=kv_quantize)),
                    _spec_trace(TS, V), V)
    assert got[0] == want[0]            # admission / eviction sequence
    assert got[1] == want[1]            # tokens
    assert got[2] == want[2]            # aggregate counters and rates
    gs, ws = got[4].speculation, want[4].speculation
    clock = ("draft_s", "verify_s")
    assert {k: v for k, v in gs.items() if k not in clock} == \
        {k: v for k, v in ws.items() if k not in clock}
    assert gs["enabled"] and gs["acceptance_rate"] > 0.5
    assert gs["committed_tokens"] == got[2]["generated_tokens"] - 5
    # speculation only decides how many tokens a round commits
    assert got[1] == base[1]
    for m in (got[4], base[4]):
        assert m.plan_cache["lazy_solves"] == 0 and m.plan_cache["misses"] == 0
        assert m.plan_cache["steady_state"]
    d = got[4].to_dict()
    assert d["engine"]["spec"] and d["engine"]["spec_k"] == K
    assert base[4].to_dict()["speculation"] == {"enabled": False}


def test_int8_draft_engine_matches_plain_engine(weights):
    """With an int8 draft (the launcher's default) the proposals change,
    the committed tokens do not: they are the target's own argmaxes."""
    from repro_torch.quant.prequant import quantize_params

    _, tcfg, _, tp = weights
    V = tcfg.vocab_size
    with t_use_context(plan_cache=TPlanCache()):
        eng = TS.ServeEngine(tcfg, tp, spec_draft_cfg=tcfg,
                             spec_draft_params=quantize_params(tp), spec_k=4,
                             spec_draft_quant="int8", **_spec_kw(TS))
        got = _run(eng, _spec_trace(TS, V), V)
        base = _run(TS.ServeEngine(tcfg, tp, **_spec_kw(TS)),
                    _spec_trace(TS, V), V)
    assert got[1] == base[1]
    sp = got[4].speculation
    assert sp["draft_quant"] == "int8" and sp["rounds"] > 0
    assert sp["committed_tokens"] == got[2]["generated_tokens"] - 5
    assert got[4].plan_cache["lazy_solves"] == 0
    # a reset zeroes the draft state in place and the rerun repeats the run
    before = [t.data_ptr() for _, t in interop.tree_items(eng.draft_state)]
    eng.reset()
    assert all(not t.any() for _, t in interop.tree_items(eng.draft_state))
    with t_use_context(plan_cache=TPlanCache()):
        again = _run(eng, _spec_trace(TS, V), V)
    assert again[1] == got[1]
    assert before == [t.data_ptr()
                      for _, t in interop.tree_items(eng.draft_state)]


def test_spec_engine_rejects_incompatible_configs(weights):
    _, tcfg, _, tp = weights
    common = dict(num_slots=2, max_len=32, prompt_pad=8)
    with t_use_context(plan_cache=TPlanCache()):
        with pytest.raises(ValueError, match="paged"):
            TS.ServeEngine(tcfg, tp, spec_draft_cfg=tcfg,
                           spec_draft_params=tp, **common)
        with pytest.raises(ValueError, match="draft"):
            TS.ServeEngine(tcfg, tp, kv_block_size=8, spec_draft_cfg=tcfg,
                           **common)
        with pytest.raises(ValueError, match="greedy|temperature"):
            TS.ServeEngine(tcfg, tp, kv_block_size=8, spec_draft_cfg=tcfg,
                           spec_draft_params=tp, temperature=0.8, **common)
        with pytest.raises(ValueError, match="preempt"):
            TS.ServeEngine(tcfg, tp, kv_block_size=8, spec_draft_cfg=tcfg,
                           spec_draft_params=tp, sched_policy="priority",
                           **common)
        other = dataclasses.replace(tcfg, vocab_size=tcfg.vocab_size - 1)
        with pytest.raises(ValueError, match="vocab"):
            TS.ServeEngine(tcfg, tp, kv_block_size=8, spec_draft_cfg=other,
                           spec_draft_params=tp, **common)
        eng = TS.ServeEngine(tcfg, tp, kv_block_size=8, spec_draft_cfg=tcfg,
                             spec_draft_params=tp, **common)
        with pytest.raises(ValueError, match="prompt_pad"):
            eng.submit(TS.Request(prompt=np.arange(9, dtype=np.int32),
                                  max_new_tokens=2))


@pytest.mark.parametrize("kv", [[], ["--kv-quantize", "int8"]])
def test_serve_cli_spec_engine_runs_in_process(tmp_path, capsys, kv):
    out = tmp_path / "serve.json"
    res = tserve.main(["--smoke", "--engine", "--kv-block-size", "4",
                       "--spec-draft-config", "qwen1.5-4b", "--device",
                       "cpu", "--plan-cache", "", "--gen", "6",
                       "--metrics-json", str(out), *kv])
    printed = capsys.readouterr().out
    assert "[spec] draft=qwen1.5-4b-smoke(int8) k=4" in printed
    assert "lazy_solves=0" in printed.split("[spec]")[1].splitlines()[0]
    assert res["lazy_solves"] == 0 and res["misses"] == 0
    engine, trace = res["engine"], res["trace"]
    assert len(engine.finished) == len(trace) == 8
    assert all(st.finish_reason == "length" and st.tokens
               and all(0 <= t < engine.cfg.vocab_size for t in st.tokens)
               for st in engine.finished)
    sp = json.loads(out.read_text())["speculation"]
    assert sp["enabled"] and sp["draft_quant"] == "int8"
    assert sp["committed_tokens"] == res["tokens"] - len(trace)
    # the reference's tools read the port's JSON as it is
    assert serve_doctor.main([str(out)]) == 0
    assert metrics_diff.main([str(out), str(out), "--sections",
                              "speculation"]) == 0


def test_serve_cli_spec_rejects_what_the_reference_rejects():
    with pytest.raises(SystemExit, match="--kv-block-size"):
        tserve.main(["--smoke", "--engine", "--spec-draft-config",
                     "qwen1.5-4b", "--device", "cpu", "--plan-cache", ""])
    with pytest.raises(SystemExit, match="temperature"):
        tserve.main(["--smoke", "--engine", "--kv-block-size", "4",
                     "--spec-draft-config", "qwen1.5-4b", "--temperature",
                     "0.5", "--device", "cpu", "--plan-cache", ""])
