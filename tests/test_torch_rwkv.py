"""The port's RWKV-6 family against the reference's, on the CPU, from the
same numpy-seeded inputs and the same weights (``interop.params_from_jax``).

* WKV: the port's ``wkv_chunk_parallel`` (the plain version of the CUDA
  kernel ``csrc/wkv.cu``) and its CPU wrapper ``kernels.wkv.wkv`` against
  the reference's ``wkv_chunk_parallel`` and its Pallas kernel run in
  interpret mode, on the reference test's shapes at rtol = atol = 2e-4
  (``tests/test_kernels_wkv.py``'s own); the adversarial decay range
  against the token scan at 1e-3, that test's own.
* Layers: ``time_mix`` on both WKV branches (T = 64 takes the chunk form,
  T = 9 the token scan), with and without a carried state and shift, and
  ``channel_mix``; f32 activations at 1e-4 (only summation order differs),
  bf16 at 5e-2 (an intermediate may round to the neighbouring bf16 value
  on one side), the tolerances of ``tests/test_torch_lm.py``.
* Model: ``init_lm``'s tree, the interop round trip, prefill plus 3 decode
  steps, ``serve_batch``'s greedy tokens and ``plan_model``'s signatures
  on rwkv6-3b-smoke (2 layers, d_model 64, 4 heads of 16); the launch
  counts of the full-width path, traced on the meta device.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import configs as RC
from repro import models as RM
from repro.core import gemm as RG
from repro.core.context import use_context as r_use_context
from repro.core.plancache import PlanCache as RPlanCache
from repro.kernels import wkv as RK
from repro.layers import rwkv as RR
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch import models as TM
from repro_torch.core import gemm as TG
from repro_torch.core.context import use_context as t_use_context
from repro_torch.core.plancache import PlanCache as TPlanCache
from repro_torch.kernels import decode_matvec as TMV
from repro_torch.kernels import matmul as TMM
from repro_torch.kernels import wkv as TK
from repro_torch.launch.serve import serve_batch
from repro_torch.layers import rwkv as TR

t = torch.from_numpy
WKV_SHAPES = [(1, 1, 32, 64), (2, 3, 128, 64), (1, 2, 96, 128)]


def _wkv_inputs(B, H, T, N, seed=0, w0_range=(-6, 1)):
    """As tests/test_kernels_wkv.py makes them, as numpy f32 arrays."""
    rng = np.random.default_rng(seed)
    r, k, v = [rng.normal(size=(B, H, T, N)).astype(np.float32)
               for _ in range(3)]
    wl = (-np.exp(rng.uniform(*w0_range, size=(B, H, T, N)))).astype(
        np.float32)
    u = (rng.normal(size=(H, N)) * 0.3).astype(np.float32)
    s0 = (rng.normal(size=(B, H, N, N)) * 0.1).astype(np.float32)
    return r, k, v, wl, u, s0


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _bh(x):
    return x.reshape(-1, *x.shape[2:])


def _u_rows(u, B):
    H, N = u.shape
    return np.array(np.broadcast_to(u[None], (B, H, N)).reshape(B * H, N))


@pytest.mark.parametrize("B,H,T,N", WKV_SHAPES)
def test_wkv_chunk_parallel_matches_reference(B, H, T, N):
    r, k, v, wl, u, s0 = _wkv_inputs(B, H, T, N, seed=B * 7 + T)
    want_y, want_s = RR.wkv_chunk_parallel(*map(jnp.asarray, (
        r, k, v, wl, u, s0)), chunk=RK.CHUNK)
    got_y, got_s = TR.wkv_chunk_parallel(*map(t, (r, k, v, wl, u, s0)))
    _close(got_y, want_y, 2e-4)
    _close(got_s, want_s, 2e-4)
    # and against the reference's Pallas kernel, run in interpret mode
    ky, ks = RK.wkv(*map(jnp.asarray, (_bh(r), _bh(k), _bh(v), _bh(wl),
                                       _u_rows(u, B), _bh(s0))),
                    interpret=True)
    _close(_bh(got_y.numpy()), ky, 2e-4)
    _close(_bh(got_s.numpy()), ks, 2e-4)


@pytest.mark.parametrize("B,H,T,N", WKV_SHAPES)
def test_wkv_wrapper_on_cpu_matches_reference_kernel(B, H, T, N):
    r, k, v, wl, u, s0 = _wkv_inputs(B, H, T, N, seed=B * 7 + T)
    args = (_bh(r), _bh(k), _bh(v), _bh(wl), _u_rows(u, B), _bh(s0))
    want_y, want_s = RK.wkv(*map(jnp.asarray, args), interpret=True)
    launches = TK.launches
    got_y, got_s = TK.wkv(*map(t, args))
    assert TK.launches == launches  # the plain version is not a launch
    assert got_y.shape == (B * H, T, N) and got_s.shape == (B * H, N, N)
    _close(got_y, want_y, 2e-4)
    _close(got_s, want_s, 2e-4)
    # on the meta device: the outputs' shapes only
    my, ms = TK.wkv(*(t(a).to("meta") for a in args))
    assert my.shape == got_y.shape and ms.shape == got_s.shape
    assert ms.dtype == torch.float32


def test_wkv_wrapper_rejects_ragged_T():
    r, k, v, wl, u, s0 = _wkv_inputs(1, 1, 32, 64)
    cut = lambda x: t(np.ascontiguousarray(x.reshape(1, 32, 64)[:, :30]))
    with pytest.raises(ValueError, match="multiple"):
        TK.wkv(cut(r), cut(k), cut(v), cut(wl), t(u.reshape(1, 64)),
               t(s0.reshape(1, 64, 64)))
    with pytest.raises(ValueError, match="multiple"):
        TK.wkv(*(x.to("meta") for x in (cut(r), cut(k), cut(v), cut(wl))),
               t(u.reshape(1, 64)).to("meta"),
               t(s0.reshape(1, 64, 64)).to("meta"))


def test_chunk_parallel_matches_token_scan_adversarial_decay():
    """The factored intra-chunk form stays exact across the full decay
    spectrum: the port's chunk form against the port's and the reference's
    token scans."""
    B, H, T, N = 1, 2, 64, 32
    r, k, v, wl, u, s0 = _wkv_inputs(B, H, T, N, seed=3, w0_range=(-8, 1.2))
    y_par, s_par = TR.wkv_chunk_parallel(*map(t, (r, k, v, wl, u, s0)))
    ub = np.broadcast_to(u, (B, H, N))
    S, rS, ys, rys = t(s0), jnp.asarray(s0), [], []
    for i in range(T):
        step = [x[:, :, i] for x in (r, k, v, np.exp(wl))] + [ub]
        S, y = TR._wkv_step(S, tuple(t(np.array(x)) for x in step))
        rS, ry = RR._wkv_step(rS, tuple(jnp.asarray(x) for x in step))
        ys.append(y)
        rys.append(ry)
    _close(torch.stack(ys, 2), jnp.stack(rys, 2), 1e-5)
    _close(S, rS, 1e-5)
    _close(y_par, torch.stack(ys, 2), 1e-3)
    _close(s_par, S, 1e-3)


# ------------------------------------------------------------------ layers
D_MODEL, HEADS, D_FF = 64, 4, 128


def _layer_params(seed):
    """Reference-initialised layer weights with the constants (mu, w0, u,
    the group-norm affine) replaced by numpy draws, so every term matters;
    returned for both packages."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    d = D_MODEL
    tm = RR.init_time_mix(k1, d)._replace(
        mu=jnp.asarray(rng.uniform(0, 1, (5, d)), jnp.float32),
        w0=jnp.asarray(rng.uniform(-8, 1, d), jnp.float32),
        u=jnp.asarray(rng.normal(size=d) * 0.3, jnp.float32),
        ln_g=jnp.asarray(rng.uniform(0.5, 1.5, d), jnp.float32),
        ln_b=jnp.asarray(rng.normal(size=d) * 0.1, jnp.float32))
    cmx = RR.init_channel_mix(k2, d, D_FF)._replace(
        mu_k=jnp.asarray(rng.uniform(0, 1, d), jnp.float32),
        mu_r=jnp.asarray(rng.uniform(0, 1, d), jnp.float32))
    port = lambda p, cls: cls(*(interop.to_tensor(np.asarray(x), "cpu")
                                for x in p))
    return (tm, cmx), (port(tm, TR.RwkvTimeMixParams),
                       port(cmx, TR.RwkvChannelMixParams))


def _acts(rng, shape, dtype_name):
    x = rng.normal(size=shape).astype(np.float32)
    jx = jnp.asarray(x, dtype_name)
    return jx, interop.to_tensor(np.asarray(jx), "cpu")


TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("T", [64, 9])
def test_time_mix_and_channel_mix_match_reference(T, carried, dtype_name):
    (rtm, rcm), (ttm, tcm) = _layer_params(T + carried)
    rng = np.random.default_rng(100 + T)
    B, H, N = 2, HEADS, D_MODEL // HEADS
    jx, tx = _acts(rng, (B, T, D_MODEL), dtype_name)
    kw_r, kw_t = {}, {}
    if carried:
        s0 = (rng.normal(size=(B, H, N, N)) * 0.1).astype(np.float32)
        jp, tp = _acts(rng, (B, D_MODEL), dtype_name)
        kw_r = dict(state=jnp.asarray(s0), x_prev=jp)
        kw_t = dict(state=t(s0), x_prev=tp)
    tol = TOL[dtype_name]
    with r_use_context(plan_cache=RPlanCache()):
        rout, (rstate, rlast) = RR.time_mix(rtm, jx, n_heads=H, **kw_r)
        rcout, rclast = RR.channel_mix(rcm, jx, x_prev=kw_r.get("x_prev"))
    with t_use_context(plan_cache=TPlanCache()):
        tout, (tstate, tlast) = TR.time_mix(ttm, tx, n_heads=H, **kw_t)
        tcout, tclast = TR.channel_mix(tcm, tx, x_prev=kw_t.get("x_prev"))
    assert tout.dtype == tcout.dtype == tx.dtype
    assert tstate.dtype == torch.float32 and tstate.shape == (B, H, N, N)
    for got, want in ((tout, rout), (tstate, rstate), (tcout, rcout)):
        _close(got.float(), np.asarray(want, np.float32), tol)
    assert torch.equal(tlast, tx[:, -1]) and torch.equal(tclast, tx[:, -1])


def test_time_mix_chunk_branch_launches_the_wkv_wrapper(monkeypatch):
    """T % 32 == 0 and T > 32 goes through ``kernels.wkv.wkv_heads`` with
    the (B, T, H, N) projections as they are; T = 32 and T = 9 take the
    token scan, as the reference's branch rule says."""
    (_, _), (ttm, _) = _layer_params(0)
    calls = []
    real = TK.wkv_heads
    monkeypatch.setattr(TK, "wkv_heads", lambda *a: calls.append(
        [tuple(x.shape) for x in a[:4]]) or real(*a))
    rng = np.random.default_rng(0)
    with t_use_context(plan_cache=TPlanCache()):
        for T in (64, 32, 9, 96):
            TR.time_mix(ttm, t(rng.normal(size=(2, T, D_MODEL)).astype(
                np.float32)), n_heads=HEADS)
    N = D_MODEL // HEADS
    assert calls == [[(2, 64, HEADS, N)] * 4, [(2, 96, HEADS, N)] * 4]


# ------------------------------------------------------------------ model
def _cfg(dtype_name="float32"):
    base = RC.smoke(RC.get_config("rwkv6-3b"))
    if dtype_name != "float32":
        base = dataclasses.replace(base, activation_dtype=dtype_name)
    return base, TC.ModelConfig(**dataclasses.asdict(base))


def _weights(rcfg, tcfg, seed=0):
    rparams = RM.init(jax.random.PRNGKey(seed), rcfg)
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, rparams),
                                      tcfg, "cpu")
    return rparams, tparams


def _jax_path(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name", getattr(
        k, "idx", k)))) for k in path)


@pytest.mark.parametrize("arch_variant", ["smoke", "full"])
def test_init_lm_tree_matches_reference_eval_shape(arch_variant):
    rcfg = RC.get_config("rwkv6-3b")
    if arch_variant == "smoke":
        rcfg = RC.smoke(rcfg)
    tcfg = TC.ModelConfig(**dataclasses.asdict(rcfg))
    shapes = jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0), rcfg))
    want = {_jax_path(p): (tuple(x.shape), x.dtype.name)
            for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    tree = TM.init(tcfg, device="meta")
    got = {p: (tuple(x.shape), TC.dtype_name(x.dtype))
           for p, x in interop.tree_items(tree)}
    assert got == want
    for cls in ("RwkvTimeMixParams", "RwkvChannelMixParams"):
        assert getattr(TR, cls)._fields == getattr(RR, cls)._fields
    n = TM.param_count(tree)
    assert n == sum(int(np.prod(s)) for s, _ in want.values())
    if arch_variant == "full":
        assert n == 3_094_533_120


def test_init_lm_has_the_reference_constants():
    rcfg, tcfg = _cfg()
    want = jax.tree.map(np.asarray, RM.init(jax.random.PRNGKey(0), rcfg))
    got = TM.init(tcfg, seed=0, device="cpu")
    for part, names in (("tmix", ("mu", "w0", "u", "ln_g", "ln_b")),
                        ("cmix", ("mu_k", "mu_r"))):
        for name in names:
            np.testing.assert_array_equal(
                getattr(got["layers"][part], name).numpy(),
                getattr(want["layers"][part], name))
    tm = got["layers"]["tmix"]
    for name in ("lora_a", "lora_b", "w_lora_a", "w_lora_b"):
        assert float(getattr(tm, name).std()) == pytest.approx(0.01, rel=0.15)
    assert float(tm.wr.std()) == pytest.approx(D_MODEL ** -0.5, rel=0.1)
    again = TM.init(tcfg, seed=0, device="cpu")
    assert torch.equal(again["layers"]["tmix"].wk, tm.wk)


def test_interop_round_trip_is_exact():
    rcfg, tcfg = _cfg("bfloat16")
    rparams, tparams = _weights(rcfg, tcfg)
    assert isinstance(tparams["layers"]["tmix"], TR.RwkvTimeMixParams)
    assert isinstance(tparams["layers"]["cmix"], TR.RwkvChannelMixParams)
    back = dict(interop.tree_items(interop.tree_map(
        lambda x: x.float().numpy(), tparams)))
    for p, x in jax.tree_util.tree_flatten_with_path(rparams)[0]:
        np.testing.assert_array_equal(back[_jax_path(p)],
                                      np.asarray(x, np.float32))
    broken = jax.tree.map(np.asarray, rparams)
    broken["layers"]["tmix"] = broken["layers"]["tmix"]._replace(
        u=broken["layers"]["tmix"].u[:, :-1])
    with pytest.raises(ValueError, match="tmix/u"):
        interop.params_from_jax(broken, tcfg, "cpu")


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [64, 9])
def test_prefill_and_decode_match_reference(S, dtype_name):
    rcfg, tcfg = _cfg(dtype_name)
    B, steps = 2, 3
    rparams, tparams = _weights(rcfg, tcfg, seed=S)
    tokens = np.random.default_rng(7).integers(0, rcfg.vocab_size, (B, S))
    tol = TOL[dtype_name]
    with r_use_context(matmul_backend="interpret", plan_cache=RPlanCache()):
        rstate = RM.init_decode_state(rcfg, B, S + steps + 1)
        rlog, rstate = RM.prefill(rparams, {"tokens": jnp.asarray(
            tokens, jnp.int32)}, rcfg, rstate)
        want = [np.asarray(rlog)]
        fed = []
        for _ in range(steps):
            fed.append(np.asarray(jnp.argmax(rlog[:, :rcfg.vocab_size], -1)))
            rlog, rstate = RM.decode_step(
                rparams, jnp.asarray(fed[-1][:, None], jnp.int32), rcfg,
                rstate)
            want.append(np.asarray(rlog))
    with t_use_context(plan_cache=TPlanCache()):
        tstate = TM.init_decode_state(tcfg, B, S + steps + 1, device="cpu")
        # prefill starts from zero state whatever it is given
        for x in tstate.values():
            x.fill_(1.0)
        tlog, tstate = TM.prefill(tparams, {"tokens": t(tokens)}, tcfg,
                                  tstate)
        got = [tlog.numpy()]
        for tok in fed:
            tlog, tstate = TM.decode_step(tparams, t(
                tok[:, None].astype(np.int64)), tcfg, tstate)
            got.append(tlog.numpy())
    for key in ("wkv", "att_shift", "ffn_shift"):
        assert tstate[key].shape == rstate[key].shape
        assert TC.dtype_name(tstate[key].dtype) == rstate[key].dtype.name
        got_s = tstate[key].float().numpy()
        want_s = np.asarray(rstate[key], np.float32)
        if dtype_name == "float32":
            _close(got_s, want_s, tol)
        else:
            # the WKV state sums k v^T over the prompt, k and v rounded to
            # bf16: one rounding flip upstream moves a small element by
            # ~2**-8 |k||v|, so the state is held as a whole, to a few bf16
            # epsilons (2**-8) of relative Frobenius error (0.4-0.8% seen)
            err = np.linalg.norm(got_s - want_s) / np.linalg.norm(want_s)
            assert err < 2e-2, (key, err)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, rcfg.padded_vocab)
        assert g.dtype == np.float32
        _close(g, w, tol)


def test_forward_matches_reference():
    rcfg, tcfg = _cfg()
    rparams, tparams = _weights(rcfg, tcfg, seed=2)
    tokens = np.random.default_rng(5).integers(0, rcfg.vocab_size, (2, 64))
    want, _ = RM.forward(rparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                         rcfg)
    with t_use_context(plan_cache=TPlanCache()):
        got, aux = TM.forward(tparams, {"tokens": t(tokens)}, tcfg)
    assert float(aux) == 0.0
    _close(got, want, 1e-4)


def test_serve_batch_greedy_tokens_match_reference():
    rcfg, tcfg = _cfg()
    B, S, gen = 2, 64, 6
    rparams, tparams = _weights(rcfg, tcfg, seed=1)
    prompts = np.random.default_rng(3).integers(0, rcfg.vocab_size, (B, S))
    rstate = RM.init_decode_state(rcfg, B, S + gen + 1)
    rlog, rstate = RM.prefill(rparams, {"tokens": jnp.asarray(
        prompts, jnp.int32)}, rcfg, rstate)
    want = []
    for _ in range(gen):
        tok = jnp.argmax(rlog[:, :rcfg.vocab_size], -1).astype(jnp.int32)
        want.append(np.asarray(tok))
        rlog, rstate = RM.decode_step(rparams, tok[:, None], rcfg, rstate)
    with t_use_context(plan_cache=TPlanCache()):
        got = serve_batch(tcfg, tparams, t(prompts), gen_len=gen,
                          max_len=S + gen + 1)
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))


@pytest.mark.parametrize("prompt_len", [64, 9])
def test_plan_model_signatures_match_reference(prompt_len):
    rcfg, tcfg = _cfg()
    kw = dict(batch=2, prompt_len=prompt_len, max_len=prompt_len + 5)
    with r_use_context(plan_cache=RPlanCache()):
        want = RG.plan_model(rcfg, **kw)
    cache = TPlanCache()
    with t_use_context(hw="h100", plan_cache=cache):
        got = TG.plan_model(tcfg, **kw)
    assert got["signatures"] == want["signatures"] == got["solved"] == 13
    assert cache.stats.lazy_solves == 0


def test_full_width_launch_counts_on_meta(monkeypatch):
    """The kernels the rwkv6-3b path reaches at batch 4, prompt 128 (the
    chip smoke's phase 4), counted per call on the meta device: prefill 11
    fat GEMMs a layer and the last-token unembed on the GEMV; a decode step
    3 fat GEMMs (w_lora_a N = 32, w_lora_b K = 32, cmix wk + relu) and 8
    GEMVs a layer plus the unembed; one WKV launch a prefill layer."""
    counts = {"matmul": 0, "gemv": 0, "wkv": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(TMM, "matmul", spy("matmul", TMM.matmul))
    monkeypatch.setattr(TMV, "decode_matvec", spy("gemv", TMV.decode_matvec))
    monkeypatch.setattr(TK, "wkv", spy("wkv", TK.wkv))
    cfg = TC.get_config("rwkv6-3b")
    L = cfg.n_layers
    B, P = 4, 128
    with t_use_context(hw="h100", plan_cache=TPlanCache()):
        params = TM.init(cfg, device="meta")
        state = TM.init_decode_state(cfg, B, P + 1, device="meta")
        TM.prefill(params, {"tokens": torch.empty(
            (B, P), dtype=torch.int64, device="meta")}, cfg, state)
        assert counts == {"matmul": 11 * L, "gemv": 1, "wkv": L}
        TM.decode_step(params, torch.empty((B, 1), dtype=torch.int64,
                                           device="meta"), cfg, state)
    assert counts == {"matmul": 11 * L + 3 * L, "gemv": 1 + 8 * L + 1,
                      "wkv": L}


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-1.2b",
                                  "whisper-base", "llama-3.2-vision-11b"])
def test_other_families_build_on_meta(arch):
    """The moe, hybrid, encdec and vision families join dense and rwkv:
    each builds its weights and decode state on the meta device."""
    cfg = TC.smoke(TC.get_config(arch))
    params = TM.init(cfg, device="meta")
    state = TM.init_decode_state(cfg, 1, 8, device="meta")
    assert TM.param_count(params) > 0
    assert all(t.device.type == "meta"
               for _, t in interop.tree_items(state))