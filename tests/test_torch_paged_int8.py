"""The port's int8 KV pool (``--kv-quantize int8``) and its engine against
the reference's, on the CPU, from the same weights
(``interop.params_from_jax``), lengths, block tables and seeded traces.

qwen1.5-4b-smoke (2 layers, d_model 64). Tolerances:
* the pool itself: with f32 activations both sides quantize the same K/V
  values up to f32 summation order, and the int8 blocks came out equal
  byte for byte (scales within 1e-6 relative); with bf16 activations a
  K/V element may round to the neighbouring bf16 value on one side and
  its int8 code move (a bf16 ulp is up to 2^-7 of a value: one int8 step
  at the block's absmax, and the rounding one more), and a block's absmax
  with it: codes within 2, 90% of them equal, scales within 1e-2
  relative (with int8 weights too, the dequantized pool is held like the
  logits, below). Block 0, the null block, is held too: duplicate writes
  there keep the last row's block on both sides
  (``layers/attention.py::_quantized_scatter``);
* logits: ``tests/test_torch_paged.py``'s 1e-4 (f32) and 5e-2 (bf16);
  with int8 weights as well and bf16 activations,
  ``tests/test_torch_quant.py``'s |d| <= 0.25 (1 + |logit|);
* the bf16 pool against the int8 pool on the port alone: the reference's
  pinned 0.1 (``tests/test_paged_kv.py``);
* the engines under ``SimClock``: the admission sequence, aggregates and
  the ``kv_cache`` section equal (the scale gauges within 1e-5 relative),
  tokens equal up to each request's first near-tie (top-2 margin under
  1e-4), as ``tests/test_torch_engine.py``.
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
from repro.core.context import use_context as r_use_context
from repro.core.plancache import PlanCache as RPlanCache
from repro.launch.mesh import make_local_mesh
from repro.layers import attention as RA
from repro.quant import prequant as RP
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch import models as TM
from repro_torch import serve as TS
from repro_torch.core.context import use_context as t_use_context
from repro_torch.core.plancache import PlanCache as TPlanCache
from repro_torch.launch import serve as tserve
from repro_torch.layers import attention as TA
from repro_torch.quant import prequant as TP
from test_torch_engine import _run

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, MAX_LEN, BS, NB = 3, 16, 4, 13


def _cfg(dtype: str = "float32"):
    base = dataclasses.replace(RC.smoke(RC.get_config("qwen1.5-4b")),
                               activation_dtype=dtype)
    return base, TC.ModelConfig(**dataclasses.asdict(base))


@pytest.fixture(scope="module")
def weights():
    out = {}
    for dtype in TOL:
        rcfg, tcfg = _cfg(dtype)
        rp = RM.init(jax.random.PRNGKey(3), rcfg)
        out[dtype] = (rcfg, tcfg, rp, interop.params_from_jax(
            jax.tree.map(np.asarray, rp), tcfg, "cpu"))
    return out


def _i(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64))


def _blocks(lane: int) -> np.ndarray:
    row = np.zeros(MAX_LEN // BS, np.int32)
    row[:3] = 1 + 3 * lane + np.arange(3)
    return row


def test_int8_pool_layout_matches_reference(weights):
    rcfg, tcfg, _, _ = weights["float32"]
    kw = dict(per_slot=True, kv_block_size=4, num_kv_blocks=8)
    r = RM.init_decode_state(rcfg, 2, 16, kv_dtype="int8", **kw)["kv"]
    t = TM.init_decode_state(tcfg, 2, 16, kv_dtype="int8", device="cpu",
                             **kw)["kv"]
    for f in ("k", "v", "table", "length", "k_scale", "v_scale"):
        a, b = getattr(t, f), np.asarray(getattr(r, f))
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == b.dtype.name
    assert t.k.dtype == torch.int8
    assert t.k_scale.shape == (tcfg.n_layers, 8, tcfg.n_kv_heads)
    assert (t.k_scale == 1.0).all() and (t.v_scale == 1.0).all()
    plain = TM.init_decode_state(tcfg, 2, 16, device="cpu", **kw)["kv"]
    assert plain.k_scale is None and plain.v_scale is None
    assert plain.k.dtype == tcfg.dtype
    with pytest.raises(ValueError, match="paged"):
        TM.init_decode_state(tcfg, 2, 16, kv_dtype="int8", device="cpu")


def _drive(rcfg, tcfg, rp, tp, rs, ts, steps=4):
    """Two lanes prefilled in 4-token chunks through the block table, then
    ``steps`` masked decode ticks (lane 2 vacant) on both packages; the
    (reference, port) logits of every step."""
    rng = np.random.default_rng(11)
    prompts = {0: rng.integers(0, rcfg.vocab_size, 7),
               1: rng.integers(0, rcfg.vocab_size, 5)}
    errs = []
    for lane, prompt in prompts.items():
        start = 0
        while start < len(prompt):
            n = min(4, len(prompt) - start)
            chunk = np.zeros((1, 4), np.int64)
            chunk[0, :n] = prompt[start:start + n]
            rl, rs = RM.prefill_chunk(
                rp, jnp.asarray(chunk, jnp.int32), rcfg, rs,
                slot=jnp.asarray(lane, jnp.int32),
                start=jnp.asarray(start, jnp.int32),
                true_len=jnp.asarray(n, jnp.int32),
                blocks=jnp.asarray(_blocks(lane)))
            tl, _ = TM.prefill_chunk(tp, _i(chunk), tcfg, ts, slot=_i(lane),
                                     start=_i(start), true_len=_i(n),
                                     blocks=_i(_blocks(lane)))
            errs.append((np.asarray(rl[0]), tl[0].numpy()))
            start += n
    active = np.array([1, 1, 0])
    for _ in range(steps):
        toks = rng.integers(0, rcfg.vocab_size, (B, 1))
        rl, rs = RM.decode_step(rp, jnp.asarray(toks, jnp.int32), rcfg, rs,
                                active=jnp.asarray(active, jnp.int32))
        tl, _ = TM.decode_step(tp, _i(toks), tcfg, ts, active=_i(active))
        errs.append((np.asarray(rl)[:2], tl.numpy()[:2]))
    return rs, errs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w8a8", [False, True])
def test_int8_pool_matches_reference(weights, dtype, w8a8):
    """Chunked prefill and masked decode on the int8 pool: logits, and the
    pool's int8 blocks and scales on every block, the null block
    included (a vacant lane attends to it, and under W8A8 its row enters
    the activation scale all lanes share)."""
    rcfg, tcfg, rp, tp = weights[dtype]
    quant = "int8" if w8a8 else None
    if w8a8:
        rp, tp = RP.quantize_params(rp), TP.quantize_params(tp)
    kw = dict(per_slot=True, kv_block_size=BS, num_kv_blocks=NB,
              kv_dtype="int8")
    rs = RM.init_decode_state(rcfg, B, MAX_LEN, **kw)
    ts = TM.init_decode_state(tcfg, B, MAX_LEN, device="cpu", **kw)
    with r_use_context(quant_mode=quant, plan_cache=RPlanCache()), \
            t_use_context(quant_mode=quant, plan_cache=TPlanCache()):
        rs, logits = _drive(rcfg, tcfg, rp, tp, rs, ts)
    for want, got in logits:
        if w8a8 and dtype == "bfloat16":
            # int8 weights re-quantize every GEMM's input: the bf16 flips
            # move whole int8 steps (test_torch_quant.py's tolerance)
            assert (np.abs(got - want) / (1 + np.abs(want))).max() <= 0.25
        else:
            assert np.abs(got - want).max() <= TOL[dtype]
    r, t = rs["kv"], ts["kv"]
    np.testing.assert_array_equal(t.length.numpy(), np.asarray(r.length))
    for f in ("k", "v"):
        got, want = getattr(t, f).numpy(), np.asarray(getattr(r, f))
        step = np.abs(got.astype(np.int32) - want.astype(np.int32)).max()
        gs = getattr(t, f + "_scale").numpy()
        ws = np.asarray(getattr(r, f + "_scale"))
        if dtype == "float32":
            assert step == 0
            np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
        elif not w8a8:
            assert step <= 2 and (got == want).mean() > 0.9
            np.testing.assert_allclose(gs, ws, rtol=1e-2, atol=0)
        else:
            # the K/V values themselves carry the W8A8 bf16 spread: the
            # dequantized pool is held like the logits
            deq = lambda q, sc: q.astype(np.float32) * sc[:, :, None, :,
                                                          None]
            d_got, d_want = deq(got, gs), deq(want, ws)
            assert (np.abs(d_got - d_want) / (1 + np.abs(d_want))).max() \
                <= 0.25
        assert (ws[:, 1:7] != 1.0).all()  # the two lanes' blocks, written


def test_quantized_scatter_duplicates_keep_the_last_row():
    """Rows bound for one block (the null block, from inactive lanes) all
    write the last such row's merged block, what the reference's scatter
    keeps on the CPU; every block, block 0 included, equals the
    reference's."""
    rng = np.random.default_rng(0)
    pool = rng.integers(-127, 128, (6, 4, 2, 8)).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, (6, 2)).astype(np.float32)
    blk = np.array([3, 0, 5, 0, 0])
    keep = rng.random((5, 4)) < 0.5
    new = ~keep & (rng.random((5, 4)) < 0.5)
    new[:, 0] = True
    newv = rng.normal(size=(5, 4, 2, 8)).astype(np.float32)
    tp, ts = torch.from_numpy(pool.copy()), torch.from_numpy(scales.copy())
    TA._quantized_scatter(tp, ts, torch.from_numpy(blk),
                          torch.from_numpy(keep), torch.from_numpy(new),
                          torch.from_numpy(newv))
    rp, rsc = RA._quantized_scatter(
        jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(blk),
        jnp.asarray(keep), jnp.asarray(new), jnp.asarray(newv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rsc))
    # block 0 holds row 4's values, not rows 1's or 3's
    want, _ = TA.q8.quantize_block(torch.where(
        torch.from_numpy(new[4])[:, None, None], torch.from_numpy(newv[4]),
        torch.where(torch.from_numpy(keep[4])[:, None, None],
                    TA.q8.dequantize_block(torch.from_numpy(pool[0]),
                                           torch.from_numpy(scales[0])),
                    0.0)))
    assert torch.equal(tp[0], want)


def test_paged_decode_int8_logit_parity_pinned(weights):
    """The port alone, bf16-activation pool against int8 pool, teacher
    forced through the same chunks, tables and tokens (the reference's
    ``test_paged_decode_int8_logit_parity_pinned``, pin 0.1)."""
    _, tcfg, _, tp = weights["float32"]
    rng = np.random.default_rng(5)
    plen, gen, max_len, bs = 7, 6, 16, 4
    prompt = rng.integers(0, tcfg.vocab_size, size=plen)

    def run(kv_dtype, feeds=None):
        with t_use_context(plan_cache=TPlanCache()):
            state = TM.init_decode_state(
                tcfg, 2, max_len, per_slot=True, kv_block_size=bs,
                num_kv_blocks=8, kv_dtype=kv_dtype, device="cpu")
            nblk = -(-(plen + gen) // bs)
            blocks = np.zeros(max_len // bs, np.int64)
            blocks[:nblk] = np.arange(1, nblk + 1)
            start = 0
            while start < plen:
                n = min(4, plen - start)
                chunk = np.zeros((1, 4), np.int64)
                chunk[0, :n] = prompt[start:start + n]
                lp, state = TM.prefill_chunk(
                    tp, _i(chunk), tcfg, state, slot=_i(0), start=_i(start),
                    true_len=_i(n), blocks=_i(blocks))
                start += n
            outs = [lp[0, :tcfg.vocab_size].numpy()]
            used = []
            tok = int(outs[0].argmax())
            for i in range(gen - 1):
                t = feeds[i] if feeds is not None else tok
                used.append(t)
                ld, state = TM.decode_step(tp, _i([[t], [0]]), tcfg, state,
                                           active=_i([1, 0]))
                outs.append(ld[0, :tcfg.vocab_size].numpy())
                tok = int(outs[-1].argmax())
        return outs, used, state

    ref_outs, feeds, _ = run(None)
    q_outs, _, q_state = run("int8", feeds)
    for i, (a, b) in enumerate(zip(ref_outs, q_outs)):
        assert float(np.abs(a - b).max()) <= 0.1, f"step {i}"
    kv = q_state["kv"]
    assert kv.k.dtype == torch.int8
    assert (kv.k_scale[:, 1:3] != 1.0).any()


# ------------------------------------------------------------ engine
def _engine_kw(pkg, prefix: bool):
    kw = dict(num_slots=2, max_len=24, prompt_pad=8, kv_block_size=4,
              num_kv_blocks=14, prefill_chunk=4, kv_quantize="int8",
              clock=pkg.SimClock(1e-3))
    if prefix:
        kw.update(prefix_cache=True, num_kv_blocks=20)
    return kw


def _trace(pkg, vocab: int, prefix: bool):
    if prefix:
        return pkg.shared_prefix_trace(6, vocab_size=vocab, header_len=8,
                                       tail_lens=[1, 3],
                                       max_new_tokens=[5, 3], seed=1)
    return pkg.synthetic_trace(5, vocab_size=vocab, prompt_lens=[8, 4, 6],
                               max_new_tokens=[4, 2, 3], seed=7)


@pytest.mark.parametrize("w8a8", [False, True])
@pytest.mark.parametrize("prefix", [False, True])
def test_int8_engine_matches_reference_under_simclock(weights, w8a8, prefix):
    rcfg, tcfg, rp, tp = weights["float32"]
    quant = "int8" if w8a8 else None
    if w8a8:
        rp, tp = RP.quantize_params(rp), TP.quantize_params(tp)
    V = rcfg.vocab_size
    axes = RP.quantize_axes(RM.axes(rcfg)) if w8a8 else None
    with r_use_context(quant_mode=quant, plan_cache=RPlanCache()):
        want = _run(RS.ServeEngine(rcfg, make_local_mesh(), rp,
                                   param_axes=axes, **_engine_kw(RS, prefix)),
                    _trace(RS, V, prefix), V)
    with t_use_context(quant_mode=quant, plan_cache=TPlanCache()):
        got = _run(TS.ServeEngine(tcfg, tp, **_engine_kw(TS, prefix)),
                   _trace(TS, V, prefix), V)
    assert got[0] == want[0]            # admission / eviction sequence
    assert got[2] == want[2]            # aggregate counters and rates
    gk, wk = got[4].kv_cache, want[4].kv_cache
    assert gk.keys() == wk.keys() and gk["kv_dtype"] == "int8"
    for k, v in wk.items():
        if k.startswith("scale_"):
            assert gk[k] == pytest.approx(v, rel=1e-5), k
        else:
            assert gk[k] == v, k
    assert gk["bytes_ratio"] < 0.55 and 0 < gk["scale_k_max"] < 1.0
    assert got[4].block_pool["bytes_per_block"] == gk["bytes_per_block"]
    if prefix:
        assert got[4].prefix_cache["hit_tokens"] > 0
    sure = {}
    for idx, _, margin, top in want[3]:
        sure.setdefault(idx, []).append(margin > 1e-4 * (1 + abs(top)))
    compared = 0
    for idx, toks in want[1].items():
        n = len(toks) if all(sure[idx]) else sure[idx].index(False)
        assert got[1][idx][:n] == toks[:n]
        compared += n
    assert compared >= 0.9 * sum(len(t) for t in want[1].values())


def test_engine_rejects_int8_kv_without_paging(weights):
    _, tcfg, _, tp = weights["float32"]
    with pytest.raises(ValueError, match="paged"):
        TS.ServeEngine(tcfg, tp, num_slots=2, max_len=16, prompt_pad=8,
                       kv_quantize="int8")
    with pytest.raises(ValueError, match="unknown KV cache dtype"):
        TS.ServeEngine(tcfg, tp, num_slots=2, max_len=16, prompt_pad=8,
                       kv_block_size=4, kv_quantize="fp4")


def test_engine_prefix_cache_int8_shared_blocks_exact(weights):
    """A trie hit maps the same int8 blocks and scales into the new
    request's table, a miss re-prefills the header through the same chunk
    sequence: cache on and off give the same tokens exactly (the
    reference's ``test_engine_prefix_cache_int8_shared_blocks_exact``)."""
    _, tcfg, _, tp = weights["float32"]
    kw = dict(num_slots=2, max_len=40, prompt_pad=16, kv_block_size=4,
              num_kv_blocks=40, prefill_chunk=8, kv_quantize="int8")

    def run(prefix):
        with t_use_context(plan_cache=TPlanCache()):
            e = TS.ServeEngine(tcfg, tp, prefix_cache=prefix, **kw)
            e.plan_warmup()
            m = e.run(TS.shared_prefix_trace(
                6, vocab_size=tcfg.vocab_size, header_len=16,
                tail_lens=[2, 3], max_new_tokens=[4, 6], seed=0))
        return {st.request.prompt.tobytes(): st.tokens
                for st in e.finished}, m

    off, _ = run(False)
    on, m = run(True)
    assert on == off
    assert m.prefix_cache["hit_tokens"] > 0 and m.prefix_cache["hit_rate"] > 0.5
    assert m.plan_cache["steady_state"] is True
    assert all(r["cached_tokens"] % 4 == 0 for r in m.requests)


def test_serve_cli_int8_engine_runs_in_process(tmp_path):
    out = tmp_path / "serve.json"
    res = tserve.main(["--smoke", "--engine", "--kv-block-size", "4",
                       "--quantize", "int8", "--kv-quantize", "int8",
                       "--device", "cpu", "--plan-cache", "",
                       "--metrics-json", str(out)])
    assert res["lazy_solves"] == 0 and res["misses"] == 0
    engine, trace = res["engine"], res["trace"]
    assert engine.kv_dtype.value == "int8"
    assert engine.state["kv"].k.dtype == torch.int8
    assert len(engine.finished) == len(trace) == 8
    assert all(st.finish_reason == "length"
               and all(0 <= t < engine.cfg.vocab_size for t in st.tokens)
               for st in engine.finished)
    d = json.loads(out.read_text())
    assert d["engine"]["quant"] == "int8" and d["engine"]["kv_dtype"] == "int8"
    assert d["kv_cache"]["quantized"] is True
    assert d["kv_cache"]["bytes_ratio"] < 0.55
    # a warm rerun resets the pool in place: scales back to 1.0
    engine.reset()
    assert (engine.state["kv"].k_scale == 1.0).all()
    assert not engine.state["kv"].k.any()
