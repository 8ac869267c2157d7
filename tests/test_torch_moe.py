"""The port's MoE family against the reference's, on the CPU, from the same
weights (``interop.params_from_jax``) and the same seeded inputs.

olmoe-1b-7b-smoke (2 layers, d_model 64, 4 experts of width 128, top-2)
and arctic-480b-smoke (the same with ``dense_residual``: a dense FFN
beside the experts), f32 activations. The reference's ``moe_ffn`` runs
with ``mesh=None`` (one shard), as ``tests/test_moe.py`` runs it.
Tolerances:

* ``moe_ffn`` / ``moe_ref``: 1e-5 on ``y`` and on the aux loss. Both
  sides compute in f32 and differ in summation order only; the router
  ranks the same experts (``torch.topk`` and ``lax.top_k`` differ only
  on exact ties, which random f32 router logits make improbable, and the
  skewed routers below separate their top-2 from the rest by far more).
  A slot one side fills and the other drops would be off by a whole
  expert's share (~0.5 here).
* the reference's last-write-wins slot loss is reproduced: with expert 0
  exactly full and no assignment over capacity, one token's expert-0
  contribution is lost on both sides (off ``moe_ref`` by > 0.1, the rest
  within 1e-5).
* ``_positions_in_bucket``: exact.
* the LM's logits and hidden states: ``tests/test_torch_lm.py``'s f32
  1e-4 after 2 layers; the aux loss 1e-5.
* the engines under ``SimClock``: the admission sequence, aggregates and
  tokens equal (W8A8: the tokens up to each request's first reference
  top-2 margin under 1e-4 of the logit, as ``tests/test_torch_paged_int8``
  holds them).
"""
import dataclasses

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
from repro.layers import moe as RMOE
from repro.quant import prequant as RP
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch import models as TM
from repro_torch import serve as TS
from repro_torch.core.context import use_context as t_use_context
from repro_torch.core.gemm import plan_model
from repro_torch.core.plancache import PlanCache as TPlanCache
from repro_torch.launch import serve as tserve
from repro_torch.layers import moe as TMOE
from repro_torch.quant import int8 as TQ
from repro_torch.quant import prequant as TP
from repro_torch.train import servestep
from test_torch_engine import _run

TOL = 1e-4         # LM logits, f32, 2 layers
MOE_TOL = 1e-5     # one moe_ffn call
D, F, E, K = 16, 32, 4, 2


# ------------------------------------------------------------ the layer
def _layer_params(rng, skew: bool = False) -> dict:
    """numpy MoeParams fields; ``skew``: experts 0 and 1 win every token
    whose features are positive, by a wide margin."""
    wr = rng.standard_normal((D, E)).astype(np.float32)
    if skew:
        wr[:, :2] = 5 * np.abs(wr[:, :2])
        wr[:, 2:] = -5 * np.abs(wr[:, 2:])
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(w_router=wr, w_in=n(E, D, F) * D ** -0.5,
                w_gate=n(E, D, F) * D ** -0.5, w_out=n(E, F, D) * F ** -0.5)


def _both(p: dict):
    return (RMOE.MoeParams(**{k: jnp.asarray(v) for k, v in p.items()}),
            TMOE.MoeParams(**{k: torch.from_numpy(v) for k, v in p.items()}))


def _ffn(rp, tp, x, *, mask=None, cf=1.25):
    """(reference y, aux), (port y, aux) as numpy / floats. The reference
    runs jitted (eager shard_map dispatches op by op: seconds a call)."""
    ref = jax.jit(lambda p, x, m: RMOE.moe_ffn(
        p, x, mesh=None, top_k=K, capacity_factor=cf, token_mask=m))
    ry, ra = ref(rp, jnp.asarray(x),
                 None if mask is None else jnp.asarray(mask))
    with t_use_context(plan_cache=TPlanCache()):
        ty, ta = TMOE.moe_ffn(
            tp, torch.from_numpy(x), top_k=K, capacity_factor=cf,
            token_mask=None if mask is None else torch.from_numpy(mask))
    return (np.asarray(ry), float(ra)), (ty.numpy(), float(ta))


# case -> (skewed router, batch, seq, capacity factor, token mask)
CASES = {
    "random": (False, 3, 5, 1.25, False),
    "token_mask": (False, 3, 5, 1.25, True),
    # experts 0 and 1 take all 64 tokens: 64 assignments each against
    # Ce = 56 (level 2 drops), and at 0.5 Cs = 64 of 128 (level 1 drops);
    # masked, ~45 live tokens a expert against Ce = 24 at 0.8
    "overflow_level2": (True, 4, 16, 1.25, False),
    "overflow_level1": (True, 4, 16, 0.5, False),
    "overflow_masked": (True, 4, 16, 0.8, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_matches_reference(case):
    skew, b, s, cf, masked = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    rp, tp = _both(_layer_params(rng, skew))
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    if skew:
        x = np.abs(x)
    mask = rng.random((b, s)) < 0.7 if masked else None
    (ry, ra), (ty, ta) = _ffn(rp, tp, x, mask=mask, cf=cf)
    assert ty.shape == (b, s, D) and ty.dtype == np.float32
    np.testing.assert_allclose(ty, ry, rtol=MOE_TOL, atol=MOE_TOL)
    assert ta == pytest.approx(ra, rel=MOE_TOL, abs=MOE_TOL)
    if masked:
        assert not ty[~mask].any()      # dead tokens return 0
    if skew:
        # capacity bound: some tokens lost expert shares on both sides
        full = RMOE.moe_ref(rp, jnp.asarray(x), top_k=K)
        lost = np.abs(ry - np.asarray(full)).max(-1) > 0.1
        if masked:
            lost &= mask
        assert lost.any()


def test_last_write_wins_slot_loss_is_reproduced():
    """The probe: 8 tokens, top-2 of 4 experts, every token routed to
    experts 0 and 1, so expert 0 is exactly full (Ce = 8) and nothing
    overflows. The level-2 slots left unfilled write zeros onto expert
    0's slot Ce - 1 after the valid write, so token 7's expert-0 share is
    lost: the reference's CPU scatter keeps the last write, and so does
    the port."""
    rng = np.random.default_rng(0)
    p = _layer_params(rng, skew=True)
    rp, tp = _both(p)
    x = np.abs(rng.standard_normal((1, 8, D))).astype(np.float32)
    (ry, ra), (ty, ta) = _ffn(rp, tp, x)
    np.testing.assert_allclose(ty, ry, rtol=MOE_TOL, atol=MOE_TOL)
    assert ta == pytest.approx(ra, rel=MOE_TOL, abs=MOE_TOL)
    full = TMOE.moe_ref(tp, torch.from_numpy(x), top_k=K).numpy()
    off = np.abs(ty - full).max(-1)[0]
    assert off[7] > 0.1
    assert (off[:7] < MOE_TOL).all()
    # the port's own dispatch agrees with the probe's arithmetic: experts
    # 0 and 1 took every token
    _, _, idx = TMOE._top_k_gates(torch.from_numpy(x[0]) @ tp.w_router, K,
                                  True)
    assert sorted(set(idx.flatten().tolist())) == [0, 1]


def test_moe_ref_matches_reference():
    rng = np.random.default_rng(3)
    rp, tp = _both(_layer_params(rng))
    x = rng.standard_normal((2, 6, D)).astype(np.float32)
    want = np.asarray(RMOE.moe_ref(rp, jnp.asarray(x), top_k=K))
    got = TMOE.moe_ref(tp, torch.from_numpy(x), top_k=K).numpy()
    np.testing.assert_allclose(got, want, rtol=MOE_TOL, atol=MOE_TOL)
    # with capacity to spare, moe_ffn is the dense reference but for the
    # last-write-wins slot (expert 0's slot Ce - 1)
    with t_use_context(plan_cache=TPlanCache()):
        y, _ = TMOE.moe_ffn(tp, torch.from_numpy(x), top_k=K,
                            capacity_factor=4.0)
    np.testing.assert_allclose(y.numpy(), got, rtol=MOE_TOL, atol=MOE_TOL)


@settings(max_examples=25, deadline=None)
@given(st.sampled_from([1, 5, 64]), st.integers(1, 9),
       st.integers(0, 2**31 - 1))
def test_positions_in_bucket_property(n, buckets, seed):
    """Each element's running index within its bucket: exactly the
    reference's, and a count of the earlier elements in its bucket (a
    few lengths, so the reference compiles a few shapes)."""
    b = np.random.default_rng(seed).integers(0, buckets, n)
    got = TMOE._positions_in_bucket(torch.from_numpy(b), buckets).numpy()
    want = np.asarray(RMOE._positions_in_bucket(jnp.asarray(b), buckets))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, [int((b[:i] == b[i]).sum()) for i in range(n)])


def test_prequantized_expert_tables_match_reference():
    """Expert tables quantized per expert and output channel on both
    sides: the same int8 codes and scales, and moe_ffn / moe_ref on them
    within 1e-5 (both dequantize at every call); the router stays f32."""
    rng = np.random.default_rng(5)
    rp, tp = _both(_layer_params(rng))
    rq = jax.jit(RP.quantize_params)({"m": rp})["m"]
    tq = TP.quantize_params({"m": tp})["m"]
    assert isinstance(tq.w_in, TQ.QuantizedLinear)
    assert tq.w_router.dtype == torch.float32
    for f in ("w_in", "w_gate", "w_out"):
        a, b = getattr(tq, f), getattr(rq, f)
        assert a.w_q.shape == b.w_q.shape and a.w_q.dtype == torch.int8
        np.testing.assert_array_equal(a.w_q.numpy(), np.asarray(b.w_q))
        np.testing.assert_allclose(a.w_scale.numpy(), np.asarray(b.w_scale),
                                   rtol=1e-6, atol=0)
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    (ry, ra), (ty, ta) = _ffn(rq, tq, x)
    np.testing.assert_allclose(ty, ry, rtol=MOE_TOL, atol=MOE_TOL)
    assert ta == pytest.approx(ra, rel=MOE_TOL, abs=MOE_TOL)
    want = np.asarray(RMOE.moe_ref(rq, jnp.asarray(x), top_k=K))
    got = TMOE.moe_ref(tq, torch.from_numpy(x), top_k=K).numpy()
    np.testing.assert_allclose(got, want, rtol=MOE_TOL, atol=MOE_TOL)


# ------------------------------------------------------------ the model
ARCHS = ["olmoe-1b-7b", "arctic-480b"]


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        rcfg = RC.smoke(RC.get_config(arch))
        tcfg = TC.ModelConfig(**dataclasses.asdict(rcfg))
        rp = RM.init(jax.random.PRNGKey(1), rcfg)
        out[arch] = (rcfg, tcfg, rp, interop.params_from_jax(
            jax.tree.map(np.asarray, rp), tcfg, "cpu"))
    return out


@pytest.fixture(scope="module")
def quantized(models):
    """arch -> the reference's and the port's pre-quantized trees."""
    return {arch: (jax.jit(RP.quantize_params)(rp), TP.quantize_params(tp))
            for arch, (_, _, rp, tp) in models.items()}


def _i(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64))


# the reference's steps, jitted once per config and shape (eager, each
# call traces and compiles its layer scan anew)
_r_prefill = jax.jit(RM.prefill, static_argnums=(2,))
_r_chunk = jax.jit(RM.prefill_chunk, static_argnums=(2,))
_r_decode = jax.jit(RM.decode_step, static_argnums=(2,))
_r_verify = jax.jit(RM.verify_step, static_argnums=(2,))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, arch):
    rcfg, tcfg, rp, tp = models[arch]
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (2, 12))
    with r_use_context(plan_cache=RPlanCache()), \
            t_use_context(plan_cache=TPlanCache()):
        rh, ra = RM.forward(rp, {"tokens": jnp.asarray(toks, jnp.int32)},
                            rcfg)
        th, ta = TM.forward(tp, {"tokens": _i(toks)}, tcfg)
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), rtol=TOL, atol=TOL)
    assert float(ta) == pytest.approx(float(ra), rel=MOE_TOL) and \
        float(ta) > 0
    assert ("mlp" in tp["layers"]) == (arch == "arctic-480b")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(models, arch):
    """The static path: prefill of 8 then 4 decode steps fed the
    reference's greedy tokens (no token mask: every token routes)."""
    rcfg, tcfg, rp, tp = models[arch]
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (3, 8))
    with r_use_context(plan_cache=RPlanCache()), \
            t_use_context(plan_cache=TPlanCache()):
        rs = RM.init_decode_state(rcfg, 3, 13)
        ts = TM.init_decode_state(tcfg, 3, 13, device="cpu")
        lg, rs = _r_prefill(rp, {"tokens": jnp.asarray(toks, jnp.int32)},
                            rcfg, rs)
        want = [np.asarray(lg)]
        got = [TM.prefill(tp, {"tokens": _i(toks)}, tcfg, ts)[0].numpy()]
        for _ in range(4):
            nxt = want[-1][:, :rcfg.vocab_size].argmax(-1)[:, None]
            lg, rs = _r_decode(rp, jnp.asarray(nxt, jnp.int32), rcfg, rs)
            want.append(np.asarray(lg))
            got.append(TM.decode_step(tp, _i(nxt), tcfg, ts)[0].numpy())
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=TOL,
                               atol=TOL)
    assert int(ts["kv"].length) == int(rs["kv"].length) == 12


BS, NB, MAX_LEN = 4, 13, 16
ACTIVE = np.array([1, 1, 0])          # lane 2 vacant
PAGED = [("olmoe-1b-7b", None), ("olmoe-1b-7b", "int8"),
         ("arctic-480b", None)]


@pytest.fixture(scope="module")
def paged(models):
    """(arch, kv_dtype) -> the reference's and the port's paged states
    after lanes 0 and 1 were prefilled in chunks of 4 (lane 1's last
    chunk holds 3 pad positions, which the token mask keeps out of the
    experts' capacity), and each chunk's logits on both sides."""
    out = {}

    def get(arch, kv_dtype):
        if (arch, kv_dtype) in out:
            return out[arch, kv_dtype]
        rcfg, tcfg, rp, tp = models[arch]
        kw = dict(per_slot=True, kv_block_size=BS, num_kv_blocks=NB,
                  kv_dtype=kv_dtype)
        rs = RM.init_decode_state(rcfg, 3, MAX_LEN, **kw)
        ts = TM.init_decode_state(tcfg, 3, MAX_LEN, device="cpu", **kw)
        rng = np.random.default_rng(11)
        want, got = [], []
        with r_use_context(plan_cache=RPlanCache()), \
                t_use_context(plan_cache=TPlanCache()):
            for lane, n_prompt in ((0, 8), (1, 5)):
                prompt = rng.integers(0, rcfg.vocab_size, n_prompt)
                blocks = np.zeros(MAX_LEN // BS, np.int32)
                blocks[:3] = 1 + 3 * lane + np.arange(3)
                for start in range(0, n_prompt, 4):
                    n = min(4, n_prompt - start)
                    chunk = np.zeros((1, 4), np.int64)
                    chunk[0, :n] = prompt[start:start + n]
                    lg, rs = _r_chunk(
                        rp, jnp.asarray(chunk, jnp.int32), rcfg, rs,
                        slot=jnp.asarray(lane, jnp.int32),
                        start=jnp.asarray(start, jnp.int32),
                        true_len=jnp.asarray(n, jnp.int32),
                        blocks=jnp.asarray(blocks))
                    want.append(np.asarray(lg))
                    got.append(TM.prefill_chunk(
                        tp, _i(chunk), tcfg, ts, slot=_i(lane),
                        start=_i(start), true_len=_i(n),
                        blocks=_i(blocks))[0].numpy())
        out[arch, kv_dtype] = (rs, ts, np.stack(want), np.stack(got))
        return out[arch, kv_dtype]

    return get


@pytest.mark.parametrize("arch,kv_dtype", PAGED)
def test_prefill_chunk_matches_reference(paged, arch, kv_dtype):
    rs, ts, want, got = paged(arch, kv_dtype)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert ts["kv"].length.tolist() == np.asarray(rs["kv"].length).tolist() \
        == [8, 5, 0]


@pytest.mark.parametrize("arch,kv_dtype", PAGED)
def test_masked_decode_matches_reference(models, paged, arch, kv_dtype):
    """3 decode ticks after the chunks, lane 2 vacant (active > 0 keeps it
    out of routing): the live lanes' logits and the lengths."""
    rcfg, tcfg, rp, tp = models[arch]
    rs, ts, _, _ = paged(arch, kv_dtype)
    ts = interop.tree_map(lambda t: t.clone(), ts)
    toks = np.random.default_rng(2).integers(0, rcfg.vocab_size, (3, 1))
    with r_use_context(plan_cache=RPlanCache()), \
            t_use_context(plan_cache=TPlanCache()):
        for _ in range(3):
            lg, rs = _r_decode(rp, jnp.asarray(toks, jnp.int32), rcfg, rs,
                               active=jnp.asarray(ACTIVE, jnp.int32))
            tl, _ = TM.decode_step(tp, _i(toks), tcfg, ts, active=_i(ACTIVE))
            np.testing.assert_allclose(tl.numpy()[:2], np.asarray(lg)[:2],
                                       rtol=TOL, atol=TOL)
            toks = np.asarray(lg)[:, :rcfg.vocab_size].argmax(-1)[:, None]
    assert ts["kv"].length.tolist() == np.asarray(rs["kv"].length).tolist() \
        == [11, 8, 0]


@pytest.mark.parametrize("arch,kv_dtype", PAGED)
def test_verify_step_matches_reference(models, paged, arch, kv_dtype):
    """verify_step over k + 1 = 4 tokens a lane after the chunks, lane 2
    vacant (its 4 positions masked out of routing): the live lanes'
    logits at every position, and the lengths."""
    rcfg, tcfg, rp, tp = models[arch]
    rs, ts, _, _ = paged(arch, kv_dtype)
    ts = interop.tree_map(lambda t: t.clone(), ts)
    toks = np.random.default_rng(3).integers(0, rcfg.vocab_size, (3, 4))
    with r_use_context(plan_cache=RPlanCache()), \
            t_use_context(plan_cache=TPlanCache()):
        want, rs = _r_verify(rp, jnp.asarray(toks, jnp.int32), rcfg, rs,
                             active=jnp.asarray(ACTIVE, jnp.int32))
        got, _ = TM.verify_step(tp, _i(toks), tcfg, ts, active=_i(ACTIVE))
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2],
                               rtol=TOL, atol=TOL)
    assert ts["kv"].length.tolist() == np.asarray(rs["kv"].length).tolist() \
        == [12, 9, 0]


# ------------------------------------------------------------ interop
def test_params_from_jax_float_and_int8_moe_trees(models, quantized):
    for arch in ARCHS:
        rcfg, tcfg, rp, tp = models[arch]
        moe = tp["layers"]["moe"]
        assert isinstance(moe, TMOE.MoeParams)
        assert tuple(moe.w_in.shape) == (2, 4, 64, 128)
        assert tuple(moe.w_router.shape) == (2, 64, 4)
        rq, want = quantized[arch]
        got = interop.params_from_jax(jax.tree.map(np.asarray, rq), tcfg,
                                      "cpu")
        for (path, a), (_, b) in zip(interop.tree_items(got),
                                     interop.tree_items(want)):
            if a.dtype == torch.int8:
                assert torch.equal(a, b), path
            else:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
        q = got["layers"]["moe"]
        assert isinstance(q.w_in, TQ.QuantizedLinear)
        assert tuple(q.w_in.w_q.shape) == (2, 4, 128, 64)
        assert tuple(q.w_out.w_scale.shape) == (2, 4, 64)
        assert q.w_router.dtype == torch.float32
    # a float expert table where a quantized one is due is refused
    bad = jax.tree.map(np.asarray, rq)
    lay = dict(bad["layers"])
    lay["moe"] = lay["moe"]._replace(w_in=np.zeros((2, 4, 64, 128),
                                                   np.float32))
    with pytest.raises(ValueError, match="w_in"):
        interop.params_from_jax({**bad, "layers": lay}, tcfg, "cpu")


# ------------------------------------------------------------ engines
def _engine_kw(pkg, **kw):
    return dict(num_slots=2, max_len=24, prompt_pad=8, kv_block_size=4,
                num_kv_blocks=14, prefill_chunk=4, clock=pkg.SimClock(1e-3),
                **kw)


def _trace(pkg, vocab):
    return pkg.synthetic_trace(5, vocab_size=vocab, prompt_lens=[8, 4, 6],
                               max_new_tokens=[4, 2, 3], seed=7)


@pytest.mark.parametrize("w8a8", [False, True])
def test_paged_engine_matches_reference_under_simclock(models, quantized,
                                                       w8a8):
    """The paged engine on olmoe-smoke: float weights and the bf16-free
    pool, and a pre-quantized tree under quant_mode="int8" with the int8
    pool (the reference's test_engine_on_prequantized_moe, paged)."""
    rcfg, tcfg, rp, tp = models["olmoe-1b-7b"]
    quant, kvq, axes = None, None, None
    if w8a8:
        rp, tp = quantized["olmoe-1b-7b"]
        quant, kvq = "int8", "int8"
        axes = RP.quantize_axes(RM.axes(rcfg))
    V = rcfg.vocab_size
    with r_use_context(quant_mode=quant, plan_cache=RPlanCache()):
        want = _run(RS.ServeEngine(rcfg, make_local_mesh(), rp,
                                   param_axes=axes,
                                   **_engine_kw(RS, kv_quantize=kvq)),
                    _trace(RS, V), V)
    with t_use_context(quant_mode=quant, plan_cache=TPlanCache()):
        got = _run(TS.ServeEngine(tcfg, tp, **_engine_kw(TS, kv_quantize=kvq)),
                   _trace(TS, V), V)
    assert got[0] == want[0]            # admission / eviction sequence
    assert got[2] == want[2]            # aggregate counters and rates
    m = got[4]
    assert m.plan_cache["lazy_solves"] == 0 and m.plan_cache["misses"] == 0
    assert m.kv_cache["kv_dtype"] == (kvq or "bfloat16") or not w8a8
    if not w8a8:
        assert got[1] == want[1]        # tokens
        return
    sure = {}
    for idx, _, margin, top in want[3]:
        sure.setdefault(idx, []).append(margin > TOL * (1 + abs(top)))
    compared = 0
    for idx, toks in want[1].items():
        n = len(toks) if all(sure[idx]) else sure[idx].index(False)
        assert got[1][idx][:n] == toks[:n]
        compared += n
    assert compared >= 0.9 * sum(len(t) for t in want[1].values())


def test_spec_engine_on_moe_target_matches_reference(models):
    """Speculative decoding with olmoe-smoke as target and draft (as the
    reference's own parity test pairs them): the same admissions, tokens,
    aggregates and speculation section but for its host-clock seconds."""
    rcfg, tcfg, rp, tp = models["olmoe-1b-7b"]
    V = rcfg.vocab_size
    kw = lambda pkg: dict(num_slots=2, max_len=32, prompt_pad=8,
                          kv_block_size=8, prefill_chunk=8,
                          clock=pkg.SimClock(1e-3), spec_k=3)
    trace = lambda pkg: pkg.synthetic_trace(
        3, vocab_size=V, prompt_lens=[6, 8], max_new_tokens=[9, 6],
        seed=11)
    with r_use_context(plan_cache=RPlanCache()):
        want = _run(RS.ServeEngine(rcfg, make_local_mesh(), rp,
                                   spec_draft_cfg=rcfg, spec_draft_params=rp,
                                   **kw(RS)), trace(RS), V)
    with t_use_context(plan_cache=TPlanCache()):
        got = _run(TS.ServeEngine(tcfg, tp, spec_draft_cfg=tcfg,
                                  spec_draft_params=tp, **kw(TS)),
                   trace(TS), V)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    clock = ("draft_s", "verify_s")
    gs, ws = got[4].speculation, want[4].speculation
    assert {k: v for k, v in gs.items() if k not in clock} == \
        {k: v for k, v in ws.items() if k not in clock}
    assert gs["enabled"] and gs["rounds"] > 0
    assert got[4].plan_cache["lazy_solves"] == 0


def test_engine_factories_accept_the_kv_cache_families():
    moe = TC.smoke(TC.get_config("olmoe-1b-7b"))
    rwkv = TC.smoke(TC.get_config("rwkv6-3b"))
    servestep.make_paged_engine_step(moe, max_len=16, kv_block_size=4,
                                     num_kv_blocks=8, chunk_buckets=(4,),
                                     device="cpu")
    servestep.make_engine_step(moe, max_len=16, prompt_pad=8, device="cpu")
    servestep.make_spec_step(moe, moe, max_len=16, prompt_pad=8, spec_k=2,
                             device="cpu")
    with pytest.raises(ValueError, match="KV-cache family"):
        servestep.make_paged_engine_step(rwkv, max_len=16, kv_block_size=4,
                                         num_kv_blocks=8, chunk_buckets=(4,),
                                         device="cpu")


# ------------------------------------------------------------ planning
@pytest.mark.parametrize("quant", [None, "int8"])
def test_plan_model_at_full_width_leaves_no_lazy_solve(quant):
    """olmoe-1b-7b at its published width and depth on the meta device:
    after plan_model, prefill and decode at the warmed shapes consult
    only warm plans (the router at M = 512 and 4 among them; under int8
    the dynamic router and unembed)."""
    cfg = TC.get_config("olmoe-1b-7b")
    cache = TPlanCache()
    with t_use_context(plan_cache=cache, quant_mode=quant):
        params = TM.init(cfg, device="meta")
        if quant:
            params = TP.quantize_params(params)
        warm = plan_model(cfg, batch=4, prompt_len=128, max_len=145,
                          params=params)
        assert warm["signatures"] == warm["solved"] > 0
        keys = {k[1:4] for k in cache.warm_keys}
        assert (512, 2048, 64) in keys and (4, 2048, 64) in keys
        before = cache.stats.snapshot()
        with cache.expect_steady_state("olmoe serving"):
            st = TM.init_decode_state(cfg, 4, 145, device="meta")
            toks = torch.empty((4, 128), dtype=torch.int64, device="meta")
            _, st = TM.prefill(params, {"tokens": toks}, cfg, st)
            TM.decode_step(params, toks[:, :1], cfg, st)
        assert cache.stats.lazy_solves == before.lazy_solves
        assert cache.stats.misses == before.misses


# ------------------------------------------------------------ the CLI
@pytest.mark.parametrize("engine", [False, True])
def test_serve_cli_olmoe_smoke_runs_in_process(engine):
    args = ["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
            "--plan-cache", "", "--gen", "4"]
    if engine:
        args += ["--engine", "--kv-block-size", "4", "--quantize", "int8",
                 "--kv-quantize", "int8"]
    res = tserve.main(args)
    assert res["lazy_solves"] == 0 and res["misses"] == 0
    vocab = TC.smoke(TC.get_config("olmoe-1b-7b")).vocab_size
    if engine:
        done = res["engine"].finished
        assert len(done) == len(res["trace"]) and all(
            st.tokens and all(0 <= t < vocab for t in st.tokens)
            for st in done)
    else:
        gen = res["generated"]
        assert tuple(gen.shape) == (4, 4) and bool(((gen >= 0)
                                                    & (gen < vocab)).all())
