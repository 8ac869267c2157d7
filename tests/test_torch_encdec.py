"""The port's encoder-decoder family (whisper-base) against the
reference's, on the CPU, from the same numpy-seeded inputs and the same
weights (``interop.params_from_jax``).

* ``layers/attention.py``: ``cross_attention`` and ``self_attention
  (causal=False, use_rope=False)`` (the encoder's), over one KV chunk and
  over a ragged last chunk (40 keys in chunks of 32: the reference pads
  and masks its last chunk, the port slices it), at 1e-5 (one layer call,
  f32).
* whisper-base-smoke (2 encoder and 2 decoder layers, 12 frames): forward,
  prefill + 3 decode steps and the int8 path at 1e-4 (f32 activations),
  and the launcher's greedy tokens (its frames drawn after the prompts
  from the same generator).
* The published width on the meta device: ``plan_model(extras=)`` traces
  the encoder and leaves no lazy solve; the kernels the chip smoke's
  launch rule counts.
* The LM-only entry points refuse the family, as the reference's do, and
  the vision family too.
"""
import dataclasses
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import configs as RC
from repro import models as RM
from repro.core.context import use_context as r_use_context
from repro.core.plancache import PlanCache as RPlanCache
from repro.launch import serve as rserve
from repro.layers import attention as RA
from repro.quant import prequant as RP
from repro.train import servestep as RSS
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch import models as TM
from repro_torch import serve as TS
from repro_torch.core.context import use_context as t_use_context
from repro_torch.core.gemm import plan_model
from repro_torch.core.plancache import PlanCache as TPlanCache
from repro_torch.kernels import decode_matvec as TMV
from repro_torch.kernels import matmul as TMM
from repro_torch.launch import serve as tserve
from repro_torch.layers import attention as TA
from repro_torch.quant import prequant as TP
from repro_torch.train import servestep

TOL = 1e-4         # LM logits, f32
LAYER_TOL = 1e-5   # one layer call
D, H, HD = 32, 4, 8

t = torch.from_numpy


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------ attention
def _attn_params(rng):
    n = lambda *s: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
    p = dict(wq=n(D, H * HD), wk=n(D, H * HD), wv=n(D, H * HD),
             wo=n(H * HD, D), bq=n(H * HD), bk=n(H * HD), bv=n(H * HD))
    return (RA.AttnParams(**{k: jnp.asarray(v) for k, v in p.items()}),
            TA.AttnParams(**{k: t(v) for k, v in p.items()}))


KW = dict(n_heads=H, n_kv_heads=H, head_dim=HD)


@pytest.mark.parametrize("Sk,chunk", [(12, 32), (40, 32)])
def test_cross_attention_matches_reference(Sk, chunk):
    rng = np.random.default_rng(Sk)
    rp, tp = _attn_params(rng)
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    src = rng.standard_normal((2, Sk, D)).astype(np.float32)
    with r_use_context(plan_cache=RPlanCache()), \
            t_use_context(plan_cache=TPlanCache()):
        want = RA.cross_attention(rp, jnp.asarray(x), jnp.asarray(src),
                                  chunk=chunk, **KW)
        got = TA.cross_attention(tp, t(x), t(src), chunk=chunk, **KW)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("S,chunk", [(12, 32), (40, 32)])
@pytest.mark.parametrize("causal,rope", [(False, False), (True, True)])
def test_self_attention_options_match_reference(S, chunk, causal, rope):
    """The encoder's form (non-causal, no rope) and the decoder's, over
    one chunk and a ragged last chunk."""
    rng = np.random.default_rng(S + 2 * causal)
    rp, tp = _attn_params(rng)
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    with r_use_context(plan_cache=RPlanCache()), \
            t_use_context(plan_cache=TPlanCache()):
        want = RA.self_attention(rp, jnp.asarray(x), causal=causal,
                                 use_rope=rope, chunk=chunk, **KW)
        got = TA.self_attention(tp, t(x), causal=causal, use_rope=rope,
                                chunk=chunk, **KW)
    _close(got, want, LAYER_TOL)


def test_self_attention_positions_match_reference():
    rng = np.random.default_rng(7)
    rp, tp = _attn_params(rng)
    x = rng.standard_normal((2, 6, D)).astype(np.float32)
    pos = np.arange(6)[None, :] + np.array([[3], [10]])
    with r_use_context(plan_cache=RPlanCache()), \
            t_use_context(plan_cache=TPlanCache()):
        want = RA.self_attention(rp, jnp.asarray(x), positions=jnp.asarray(
            pos), **KW)
        got = TA.self_attention(tp, t(x), positions=t(pos), **KW)
    _close(got, want, LAYER_TOL)


# ------------------------------------------------------------ the model
def _cfg(**kw):
    base = dataclasses.replace(RC.smoke(RC.get_config("whisper-base")), **kw)
    return base, TC.ModelConfig(**dataclasses.asdict(base))


@pytest.fixture(scope="module")
def whisper():
    rcfg, tcfg = _cfg()
    rp = RM.init(jax.random.PRNGKey(1), rcfg)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, rp), tcfg, "cpu")
    return rcfg, tcfg, rp, tp


def _i(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64))


def _batch(rcfg, rng, B, S):
    toks = rng.integers(0, rcfg.vocab_size, (B, S))
    frames = rng.standard_normal((B, rcfg.encoder_len, rcfg.d_model)).astype(
        np.float32)
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "frames": jnp.asarray(frames)},
            {"tokens": _i(toks), "frames": t(frames)})


_r_prefill = jax.jit(RM.prefill, static_argnums=(2,))
_r_decode = jax.jit(RM.decode_step, static_argnums=(2,))


def test_params_tree_matches_reference(whisper):
    rcfg, tcfg, rp, tp = whisper
    assert set(tp) == {"embed", "enc_norm", "final_norm", "encoder",
                       "decoder"}      # tied: no unembed
    assert set(tp["decoder"]) == {"ln1", "ln2", "ln3", "attn", "cross",
                                  "mlp"}
    assert tp["decoder"]["cross"].bq is not None
    assert tp["encoder"]["mlp"].b_in is not None


def test_forward_matches_reference(whisper):
    rcfg, tcfg, rp, tp = whisper
    rb, tb = _batch(rcfg, np.random.default_rng(0), 2, 9)
    with r_use_context(plan_cache=RPlanCache()), \
            t_use_context(plan_cache=TPlanCache()):
        rh, _ = RM.forward(rp, rb, rcfg)
        th, ta = TM.forward(tp, tb, tcfg)
    _close(th, rh, TOL)
    assert float(ta) == 0.0


def _prefill_decode(rcfg, tcfg, rp, tp, rb, tb, steps, max_len, quant=None):
    B = tb["tokens"].shape[0]
    with r_use_context(plan_cache=RPlanCache(), quant_mode=quant,
                       matmul_backend="xla"), \
            t_use_context(plan_cache=TPlanCache(), quant_mode=quant):
        rs = RM.init_decode_state(rcfg, B, max_len)
        ts = TM.init_decode_state(tcfg, B, max_len, device="cpu")
        lg, rs = _r_prefill(rp, rb, rcfg, rs)
        want = [np.asarray(lg)]
        got = [TM.prefill(tp, tb, tcfg, ts)[0].numpy()]
        for _ in range(steps):
            nxt = want[-1][:, :rcfg.vocab_size].argmax(-1)[:, None]
            lg, rs = _r_decode(rp, jnp.asarray(nxt, jnp.int32), rcfg, rs)
            want.append(np.asarray(lg))
            got.append(TM.decode_step(tp, _i(nxt), tcfg, ts)[0].numpy())
    return np.stack(got), np.stack(want), ts, rs


def test_prefill_and_decode_match_reference(whisper):
    rcfg, tcfg, rp, tp = whisper
    rb, tb = _batch(rcfg, np.random.default_rng(1), 3, 8)
    got, want, ts, rs = _prefill_decode(rcfg, tcfg, rp, tp, rb, tb, 3, 12)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    _close(got, want, TOL)
    assert int(ts["kv"].length) == int(rs["kv"].length) == 11
    _close(ts["enc"], rs["enc"], TOL)
    _close(ts["kv"].v, rs["kv"].v, TOL)


def test_ragged_encoder_chunk_matches_reference():
    """encoder_len 40 in chunks of 32: the encoder and every decode step's
    cross-attention take the chunked form with a ragged last chunk."""
    rcfg, tcfg = _cfg(encoder_len=40, attn_chunk=32)
    rp = RM.init(jax.random.PRNGKey(3), rcfg)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, rp), tcfg, "cpu")
    rb, tb = _batch(rcfg, np.random.default_rng(3), 2, 6)
    got, want, _, _ = _prefill_decode(rcfg, tcfg, rp, tp, rb, tb, 2, 9)
    _close(got, want, TOL)


def test_int8_logits_match_reference(whisper):
    """The prequantized tree (encoder, decoder self- and cross-attention,
    MLPs; the biases stay float in their fields) under
    quant_mode="int8"; the tied unembed stays the float col GEMM, as the
    reference's ``_logits`` calls ``balanced_gemm`` directly."""
    rcfg, tcfg, rp, tp = whisper
    rq, tq = RP.quantize_params(rp), TP.quantize_params(tp)
    n_q = sum(a.dtype == torch.int8 for _, a in interop.tree_items(tq))
    assert n_q == 4 + 2 + 4 + 4 + 2   # enc attn, mlp; dec attn, cross, mlp
    conv = interop.params_from_jax(jax.tree.map(np.asarray, rq), tcfg, "cpu")
    for (path, a), (_, b) in zip(interop.tree_items(conv),
                                 interop.tree_items(tq)):
        if a.dtype == torch.int8:
            assert torch.equal(a, b), path
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    rb, tb = _batch(rcfg, np.random.default_rng(4), 2, 8)
    got, want, _, _ = _prefill_decode(rcfg, tcfg, rq, tq, rb, tb, 3, 12,
                                      quant="int8")
    assert np.isfinite(got).all()
    _close(got, want, TOL)


# ------------------------------------------------------------ the launcher
def _first_row(capsys) -> list[int]:
    out = capsys.readouterr().out
    row = re.search(r"first row: \[([^\]]*)\]", out).group(1)
    return [int(v) for v in row.split()]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_launcher_tokens_match_reference(monkeypatch, capsys, quant):
    """Both launchers on whisper-base-smoke from the reference's weights
    (its ``PRNGKey(0)``, carried into the port's ``models.init``) and the
    frames each draws after its prompts: the first row's greedy tokens,
    and zero lazy solves."""
    rcfg = RC.smoke(RC.get_config("whisper-base"))
    tcfg = TC.smoke(TC.get_config("whisper-base"))
    rp = jax.tree.map(np.asarray, RM.init(jax.random.PRNGKey(0), rcfg))
    argv = ["--arch", "whisper-base", "--smoke", "--plan-cache", "",
            "--gen", "6"] + (["--quantize", quant] if quant else [])
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    rserve.main()
    want = _first_row(capsys)
    own = TM.init

    def init(cfg, *, seed=0, device=None):  # the meta traces stay the port's
        if str(device) == "meta":
            return own(cfg, seed=seed, device=device)
        return interop.params_from_jax(rp, tcfg, device)

    monkeypatch.setattr(TM, "init", init)
    res = tserve.main(argv + ["--device", "cpu"])
    assert res["lazy_solves"] == 0 and res["misses"] == 0
    assert res["generated"][0].tolist() == want == _first_row(capsys)


def test_prefill_input_shapes_match_reference():
    for arch in ("whisper-base", "qwen1.5-4b"):
        rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
        want = RSS.prefill_input_shapes(rcfg, 4, 128)
        got = servestep.prefill_input_shapes(tcfg, 4, 128)
        assert got.keys() == want.keys()
        for k, (shape, dtype) in got.items():
            assert shape == want[k].shape
            assert str(dtype).removeprefix("torch.") == (
                "int64" if k == "tokens" else str(want[k].dtype))


# ------------------------------------------------------------ full width
def _frames(cfg, B=4):
    return {"frames": torch.empty((B, cfg.encoder_len, cfg.d_model),
                                  dtype=torch.float32, device="meta")}


@pytest.mark.parametrize("quant", [None, "int8"])
def test_plan_model_with_extras_leaves_no_lazy_solve(quant):
    """whisper-base at its published width on the meta device:
    plan_model(extras=) traces the encoder (M = 4 x 1500 frames), and
    prefill and decode then consult only warm plans."""
    cfg = TC.get_config("whisper-base")
    cache = TPlanCache()
    with t_use_context(plan_cache=cache, quant_mode=quant):
        params = TM.init(cfg, device="meta")
        if quant:
            params = TP.quantize_params(params)
        warm = plan_model(cfg, batch=4, prompt_len=128, max_len=145,
                          params=params, extras=_frames(cfg))
        assert warm["signatures"] == warm["solved"] > 0
        keys = {k[1:4] for k in cache.warm_keys}
        assert (6000, 512, 512) in keys and (4, 512, 51968) in keys
        before = cache.stats.snapshot()
        with cache.expect_steady_state("whisper serving"):
            st = TM.init_decode_state(cfg, 4, 145, device="meta")
            toks = torch.empty((4, 128), dtype=torch.int64, device="meta")
            _, st = TM.prefill(params, {"tokens": toks, **_frames(cfg)},
                               cfg, st)
            TM.decode_step(params, toks[:, :1], cfg, st)
        assert cache.stats.lazy_solves == before.lazy_solves
        assert cache.stats.misses == before.misses


@pytest.mark.parametrize("quant", [None, "int8"])
def test_full_width_launch_counts_on_meta(monkeypatch, quant):
    """whisper-base's path at batch 4, prompt 128, 1500 frames (the chip
    smoke's phase 11), counted per call on the meta device. Prefill: the
    encoder 6 fat GEMMs a layer (q, k, v + bias, wo, MLP in + bias + gelu
    and out + bias at M = 6000), the decoder 10 (self q/k/v/wo, cross q,
    k/v from the frames, wo, the MLP), the tied unembed on the GEMV. A
    decode step: 8 fat (self and cross q/k/v + bias, the MLP) and 2 GEMVs
    (both wo) a layer and the unembed. int8: every projection fat, the
    tied unembed still the float GEMV."""
    counts = {"matmul": 0, "gemv": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(TMM, "matmul", spy("matmul", TMM.matmul))
    monkeypatch.setattr(TMV, "decode_matvec", spy("gemv", TMV.decode_matvec))
    cfg = TC.get_config("whisper-base")
    with t_use_context(hw="h100", plan_cache=TPlanCache(), quant_mode=quant):
        params = TM.init(cfg, device="meta")
        if quant:
            params = TP.quantize_params(params)
        state = TM.init_decode_state(cfg, 4, 129, device="meta")
        TM.prefill(params, {"tokens": torch.empty(
            (4, 128), dtype=torch.int64, device="meta"), **_frames(cfg)},
            cfg, state)
        first = dict(counts)
        TM.decode_step(params, torch.empty((4, 1), dtype=torch.int64,
                                           device="meta"), cfg, state)
    step = {k: counts[k] - first[k] for k in counts}
    assert first == {"matmul": 6 * 6 + 6 * 10, "gemv": 1}
    assert step == ({"matmul": 10 * 6, "gemv": 1} if quant
                    else {"matmul": 8 * 6, "gemv": 2 * 6 + 1})


# ------------------------------------------------------------ refusals
def test_lm_entry_points_refuse_the_encdec_family(whisper):
    rcfg, tcfg, rp, tp = whisper
    z = lambda *s: torch.zeros(s, dtype=torch.int64)
    for pkg, cfg, dev in ((RM, rcfg, {}), (TM, tcfg, {"device": "cpu"})):
        for kw, what in ((dict(per_slot=True), "per-slot"),
                         (dict(per_slot=True, kv_block_size=4,
                               num_kv_blocks=4), "paged"),
                         (dict(kv_dtype="int8"), "quantized KV")):
            with pytest.raises(ValueError, match=what):
                pkg.init_decode_state(cfg, 2, 8, **kw, **dev)
    rb, tb = _batch(rcfg, np.random.default_rng(5), 2, 4)
    ts = TM.init_decode_state(tcfg, 2, 8, device="cpu")
    rs = RM.init_decode_state(rcfg, 2, 8)
    with pytest.raises(ValueError, match="last_pos"):
        TM.prefill(tp, tb, tcfg, ts, last_pos=z())
    with pytest.raises(ValueError, match="last_pos"):
        RM.prefill(rp, rb, rcfg, rs, last_pos=0)
    for fn, kw in ((TM.prefill_chunk, dict(slot=z(), start=z(),
                                           true_len=z(), blocks=z(2))),
                   (TM.verify_step, {}), (TM.decode_step, {"active": z(2)})):
        with pytest.raises(ValueError, match="encdec"):
            fn(tp, z(2, 1), tcfg, ts, **kw)
    for fn, kw in ((RM.prefill_chunk, dict(slot=0, start=0, true_len=1,
                                           blocks=jnp.zeros(2, jnp.int32))),
                   (RM.verify_step, {}),
                   (RM.decode_step, {"active": jnp.ones(2, jnp.int32)})):
        with pytest.raises(ValueError, match="encdec"):
            fn(rp, jnp.zeros((2, 1), jnp.int32), rcfg, rs, **kw)
    for make in (
            lambda: servestep.make_paged_engine_step(
                tcfg, max_len=16, kv_block_size=4, num_kv_blocks=8,
                chunk_buckets=(4,), device="cpu"),
            lambda: TS.ServeEngine(tcfg, tp, num_slots=2, max_len=16,
                                   prompt_pad=8),
            lambda: TS.ServeEngine(tcfg, tp, num_slots=2, max_len=16,
                                   prompt_pad=8, kv_block_size=4)):
        with pytest.raises(ValueError, match="encdec"):
            make()


def test_lm_only_entry_points_refuse_the_vision_family():
    """The vision family is ported (tests/test_torch_vision.py); the
    engine's LM-only entry points refuse it with ValueError, as they
    refuse encdec."""
    cfg = TC.smoke(TC.get_config("llama-3.2-vision-11b"))
    params = TM.init(cfg, device="meta")
    state = TM.init_decode_state(cfg, 1, 8, device="meta")
    z = lambda *s: torch.zeros(s, dtype=torch.int64, device="meta")
    for call in (lambda: TM.prefill_chunk(params, z(1, 4), cfg, state,
                                          slot=z(), start=z(), true_len=z(),
                                          blocks=z(2)),
                 lambda: TM.verify_step(params, z(1, 2), cfg, state),
                 lambda: TM.decode_step(params, z(1, 1), cfg, state,
                                        active=z(1)),
                 lambda: TM.init_decode_state(cfg, 1, 8, per_slot=True,
                                              device="meta")):
        with pytest.raises(ValueError, match="vlm"):
            call()
