"""The port's hybrid family (zamba2: Mamba-2 layers and one shared
attention + MLP block) against the reference's, on the CPU, from the same
numpy-seeded inputs and the same weights (``interop.params_from_jax``).

* ``layers/mamba.py``: ``_causal_conv``, ``_ssd_step`` and
  ``mamba_block`` (T 1, 5, 64, 65, 128 and 130, from zeros and from a
  carried state, and strong decays: the port's scan in chunks of 64, the
  last one padded, the reference's token scan or, at 128, its
  chunked, checkpointed one) at 1e-5 (one layer call, f32: only
  summation order differs); under grad the port's backward keeps one SSM
  state a group of 16 chunks (counted through ``saved_tensors_hooks``),
  the token loop one a token.
* zamba2-1.2b-smoke at 4 layers (the shared block at layers 0 and 2):
  forward, prefill + 3 decode steps and the int8 path at 1e-4 (f32
  activations, ``tests/test_torch_lm.py``'s and
  ``tests/test_torch_quant.py``'s), the launcher's greedy tokens, and
  decoding past ``max_len`` (qwen1.5-4b-smoke too: the 0-d cache writes at
  its last slot, as ``dynamic_update_slice`` clamps).
* The published width on the meta device: ``plan_model`` leaves no lazy
  solve, and the kernels the chip smoke's launch rule counts.
* The engine's entry points refuse the family, as the reference's do.
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
from repro.layers import mamba as RMB
from repro.quant import prequant as RP
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
from repro_torch.layers import mamba as TMB
from repro_torch.quant import int8 as TQ
from repro_torch.quant import prequant as TP
from repro_torch.train import servestep

TOL = 1e-4         # LM logits, f32, 4 layers
LAYER_TOL = 1e-5   # one layer call
D, N, P = 32, 8, 8  # d_model, d_state, head_dim: d_inner 64, 8 heads

t = torch.from_numpy


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------ the layer
def _mamba_params(rng) -> dict:
    d_inner, H = RMB.dims(D, N, head_dim=P)
    n = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    return dict(
        w_in=n(D, 2 * d_inner + 2 * N + H, scale=D ** -0.5),
        conv_w=n(RMB.CONV_K, d_inner + 2 * N, scale=0.5),
        conv_b=n(d_inner + 2 * N, scale=0.1),
        a_log=np.log(np.linspace(1.0, 16.0, H)).astype(np.float32),
        d_skip=n(H, scale=0.5) + 1,
        dt_bias=n(H) - 3,
        norm_g=n(d_inner, scale=0.1) + 1,
        w_out=n(d_inner, D, scale=d_inner ** -0.5))


def _both(p: dict):
    return (RMB.MambaParams(**{k: jnp.asarray(v) for k, v in p.items()}),
            TMB.MambaParams(**{k: t(v) for k, v in p.items()}))


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(0)
    C = 40
    x, pre = (rng.standard_normal((2, 7, C)).astype(np.float32),
              rng.standard_normal((2, 3, C)).astype(np.float32))
    w = rng.standard_normal((RMB.CONV_K, C)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    want, wtail = RMB._causal_conv(*map(jnp.asarray, (x, w, b, pre)))
    got, gtail = TMB._causal_conv(*map(t, (x, w, b, pre)))
    _close(got, want, LAYER_TOL)
    np.testing.assert_array_equal(gtail.numpy(), np.asarray(wtail))


def test_ssd_step_matches_reference():
    rng = np.random.default_rng(1)
    B, H = 3, 4
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    state, xh, Bt, Ct = f(B, H, P, N), f(B, H, P), f(B, N), f(B, N)
    dt, a, d_skip = np.abs(f(B, H)), np.abs(f(H)), f(H)
    inputs = (xh, Bt, Ct, dt, a, d_skip)
    wnew, wy = RMB._ssd_step(jnp.asarray(state),
                             tuple(map(jnp.asarray, inputs)))
    gnew, gy = TMB._ssd_step(t(state), *map(t, inputs))
    _close(gnew, wnew, LAYER_TOL)
    _close(gy, wy, LAYER_TOL)


@pytest.mark.parametrize("T,carried,strong", [
    (T, carried, False) for T in (1, 5, 64, 65, 128, 130)
    for carried in (False, True)] + [(130, True, True)])
def test_mamba_block_matches_reference(T, carried, strong):
    """From zeros and from a carried state. The port's scan: T = 1 one
    step, else chunks of 64 (65 and 130 end in a padded chunk); the
    reference's: the token scan, or at 128 its chunked scan (T % 64 == 0,
    T > 64). ``strong``: dt near 3 (the bias at +3) on a up to 16, a
    decay of e^-48 a token: the chunk's segment sums underflow to 0."""
    rng = np.random.default_rng(T + carried)
    p = _mamba_params(rng)
    if strong:
        p["dt_bias"] = p["dt_bias"] + 6
    rp, tp = _both(p)
    x = rng.standard_normal((2, T, D)).astype(np.float32)
    rs = ts = None
    if carried:
        d_inner, H = RMB.dims(D, N, head_dim=P)
        ssm = (rng.standard_normal((2, H, P, N)) * 0.3).astype(np.float32)
        conv = rng.standard_normal((2, 3, d_inner + 2 * N)).astype(
            np.float32)
        rs = RMB.MambaState(ssm=jnp.asarray(ssm), conv=jnp.asarray(conv))
        ts = TMB.MambaState(ssm=t(ssm), conv=t(conv))
    with r_use_context(plan_cache=RPlanCache()):
        want, wst = jax.jit(lambda p, x, s: RMB.mamba_block(
            p, x, d_state=N, head_dim=P, state=s))(rp, jnp.asarray(x), rs)
    with t_use_context(plan_cache=TPlanCache()):
        got, gst = TMB.mamba_block(tp, t(x), d_state=N, head_dim=P,
                                   state=ts)
    _close(got, want, LAYER_TOL)
    _close(gst.ssm, wst.ssm, LAYER_TOL)
    _close(gst.conv, wst.conv, LAYER_TOL)  # w_in's last 3 rows


def _token_scan(h, xh, Bf, Cf, dt, a, d_skip):
    """The recurrence one ``_ssd_step`` a token: the chunked scan's
    oracle."""
    ys = []
    for i in range(xh.shape[1]):
        h, y = TMB._ssd_step(h, xh[:, i], Bf[:, i], Cf[:, i], dt[:, i], a,
                             d_skip)
        ys.append(y)
    return torch.stack(ys, dim=1), h


def _saved_states(fn, shape) -> int:
    """Run ``fn`` under grad and count the tensors of ``shape`` (an SSM
    state's) that autograd saves for the backward."""
    n = [0]

    def pack(t):
        n[0] += tuple(t.shape) == shape
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return n[0]


@pytest.mark.parametrize("T", [512, 2 * 1024 + 64])
def test_scan_backward_keeps_one_state_a_group(T, monkeypatch):
    """Under grad, ``mamba_block`` saves one SSM state (B, H, P, N) a group
    of 16 chunks of 64 tokens (the state its recompute starts from) and no
    other: 1 at T = 512, 3 at 2112, within the reference's one a chunk
    (ceil(T / 64): 8, 33). The token loop saves one a token (the state its
    decay multiplies; the new state that ``C`` reads is kept reshaped
    besides): 512 at T = 512, where the gradients agree."""
    rng = np.random.default_rng(7)
    _, tp = _both(_mamba_params(rng))
    _, H = RMB.dims(D, N, head_dim=P)
    B = 2
    x = t(rng.standard_normal((B, T, D)).astype(np.float32))
    scans = {"chunks": TMB._scan, "tokens": _token_scan}
    saved, grads = {}, {}
    for name, scan in scans.items() if T == 512 else [("chunks",
                                                          TMB._scan)]:
        monkeypatch.setattr(TMB, "_scan", scan)
        leaves = TMB.MambaParams(*(v.clone().requires_grad_() for v in tp))
        out = {}

        def run():
            with t_use_context(plan_cache=TPlanCache()):
                out["y"], _ = TMB.mamba_block(leaves, x, d_state=N,
                                              head_dim=P)

        saved[name] = _saved_states(run, (B, H, P, N))
        out["y"].square().sum().backward()
        grads[name] = [v.grad for v in leaves]
    per_group = TMB.CHUNK * TMB.GROUP
    assert saved["chunks"] == -(-T // per_group) <= -(-T // TMB.CHUNK)
    if T == 512:
        assert saved["tokens"] == T
        for g, w in zip(grads["chunks"], grads["tokens"]):
            _close(g, w, LAYER_TOL * float(w.abs().max()))


def test_init_mamba_shapes_match_reference():
    want = RMB.init_mamba(jax.random.PRNGKey(0), D, N, head_dim=P)
    got = TMB.init_mamba(None, D, N, head_dim=P, lead=(3,), device="meta")
    for f in TMB.MambaParams._fields:
        w, g = getattr(want, f), getattr(got, f)
        assert tuple(g.shape) == (3, *w.shape) and g.dtype == torch.float32
    real = TMB.init_mamba(torch.Generator().manual_seed(0), D, N,
                          head_dim=P, device="cpu")
    for f in ("a_log", "d_skip", "dt_bias", "norm_g", "conv_b"):
        _close(getattr(real, f), getattr(want, f), 1e-6)


# ------------------------------------------------------------ the model
def _cfg(arch: str = "zamba2-1.2b", **kw):
    base = RC.smoke(RC.get_config(arch))
    if base.family == "hybrid":
        base = dataclasses.replace(base, n_layers=4)
    base = dataclasses.replace(base, **kw)
    return base, TC.ModelConfig(**dataclasses.asdict(base))


@pytest.fixture(scope="module")
def zamba():
    rcfg, tcfg = _cfg()
    rp = RM.init(jax.random.PRNGKey(1), rcfg)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, rp), tcfg, "cpu")
    return rcfg, tcfg, rp, tp


_r_prefill = jax.jit(RM.prefill, static_argnums=(2,))
_r_decode = jax.jit(RM.decode_step, static_argnums=(2,))


def _i(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64))


def test_params_tree_matches_reference(zamba):
    rcfg, tcfg, rp, tp = zamba
    assert set(tp) == {"embed", "final_norm", "unembed", "layers", "shared"}
    assert set(tp["layers"]) == {"ln1", "mamba"}
    assert isinstance(tp["layers"]["mamba"], TMB.MambaParams)
    # d_inner 128, 8 heads of 16, d_state 16: N = 2 * 128 + 2 * 16 + 8
    assert tuple(tp["layers"]["mamba"].w_in.shape) == (4, 64, 296)
    meta = TM.init(tcfg, device="meta")
    assert dict((k, tuple(v.shape)) for k, v in interop.tree_items(meta)) \
        == dict((k, tuple(v.shape)) for k, v in interop.tree_items(tp))


def test_forward_matches_reference(zamba):
    rcfg, tcfg, rp, tp = zamba
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (2, 12))
    with r_use_context(plan_cache=RPlanCache()), \
            t_use_context(plan_cache=TPlanCache()):
        rh, _ = RM.forward(rp, {"tokens": jnp.asarray(toks, jnp.int32)},
                           rcfg)
        th, ta = TM.forward(tp, {"tokens": _i(toks)}, tcfg)
    _close(th, rh, TOL)
    assert float(ta) == 0.0


def _prefill_decode(rcfg, tcfg, rp, tp, toks, steps, max_len, quant=None):
    """Logits of prefill then ``steps`` decode steps fed the reference's
    greedy tokens, on both sides: (port, reference), stacked."""
    B = toks.shape[0]
    with r_use_context(plan_cache=RPlanCache(), quant_mode=quant,
                       matmul_backend="xla"), \
            t_use_context(plan_cache=TPlanCache(), quant_mode=quant):
        rs = RM.init_decode_state(rcfg, B, max_len)
        ts = TM.init_decode_state(tcfg, B, max_len, device="cpu")
        lg, rs = _r_prefill(rp, {"tokens": jnp.asarray(toks, jnp.int32)},
                            rcfg, rs)
        want = [np.asarray(lg)]
        got = [TM.prefill(tp, {"tokens": _i(toks)}, tcfg, ts)[0].numpy()]
        for _ in range(steps):
            nxt = want[-1][:, :rcfg.vocab_size].argmax(-1)[:, None]
            lg, rs = _r_decode(rp, jnp.asarray(nxt, jnp.int32), rcfg, rs)
            want.append(np.asarray(lg))
            got.append(TM.decode_step(tp, _i(nxt), tcfg, ts)[0].numpy())
    return np.stack(got), np.stack(want), ts, rs


def test_prefill_and_decode_match_reference(zamba):
    rcfg, tcfg, rp, tp = zamba
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (3, 8))
    got, want, ts, rs = _prefill_decode(rcfg, tcfg, rp, tp, toks, 3, 12)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    _close(got, want, TOL)
    assert int(ts["kv"].length) == int(rs["kv"].length) == 11
    for key in ("ssm", "conv"):
        _close(ts[key], rs[key], TOL)
    # only the shared block's layers (0 and 2) wrote their KV slots
    k = ts["kv"].k
    assert k[0].abs().sum() > 0 and k[2].abs().sum() > 0
    assert not k[1].any() and not k[3].any()
    _close(k, rs["kv"].k, TOL)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "zamba2-1.2b"])
def test_decode_past_max_len_matches_reference(arch):
    """max_len 5, a prompt of 4 and three decode steps: the second and
    third write past the cache; both packages write at its last slot and
    attend to every slot."""
    rcfg, tcfg = _cfg(arch)
    rp = RM.init(jax.random.PRNGKey(2), rcfg)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, rp), tcfg, "cpu")
    toks = np.random.default_rng(2).integers(0, rcfg.vocab_size, (2, 4))
    got, want, ts, rs = _prefill_decode(rcfg, tcfg, rp, tp, toks, 3, 5)
    assert np.isfinite(got).all()
    _close(got, want, TOL)
    assert int(ts["kv"].length) == int(rs["kv"].length) == 7
    _close(ts["kv"].k, rs["kv"].k, TOL)


def test_int8_logits_match_reference(zamba):
    """The prequantized tree (Mamba's w_in / w_out, the shared block's
    seven projections) under quant_mode="int8", the unembed dynamic:
    prefill of 8 and 3 decode steps, f32 activations, at
    tests/test_torch_quant.py's 1e-4."""
    rcfg, tcfg, rp, tp = zamba
    rq, tq = jax.jit(RP.quantize_params)(rp), TP.quantize_params(tp)
    m = tq["layers"]["mamba"]
    assert isinstance(m.w_in, TQ.QuantizedLinear) and \
        isinstance(m.w_out, TQ.QuantizedLinear)
    assert m.conv_w.dtype == torch.float32
    for (path, a), (_, b) in zip(
            interop.tree_items(interop.params_from_jax(
                jax.tree.map(np.asarray, rq), tcfg, "cpu")),
            interop.tree_items(tq)):
        if a.dtype == torch.int8:
            assert torch.equal(a, b), path
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    toks = np.random.default_rng(3).integers(0, rcfg.vocab_size, (2, 8))
    got, want, _, _ = _prefill_decode(rcfg, tcfg, rq, tq, toks, 3, 12,
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
    """Both launchers on zamba2-1.2b-smoke from the reference's weights
    (its ``PRNGKey(0)``, carried into the port's ``models.init``): the
    first row's greedy tokens, and zero lazy solves."""
    rcfg = RC.smoke(RC.get_config("zamba2-1.2b"))
    tcfg = TC.smoke(TC.get_config("zamba2-1.2b"))
    rp = jax.tree.map(np.asarray, RM.init(jax.random.PRNGKey(0), rcfg))
    argv = ["--arch", "zamba2-1.2b", "--smoke", "--plan-cache", "",
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


# ------------------------------------------------------------ full width
def test_plan_model_at_full_width_leaves_no_lazy_solve():
    """zamba2-1.2b at its published width and depth on the meta device:
    after plan_model, prefill and decode consult only warm plans (w_in's
    ragged N = 8384 among them)."""
    cfg = TC.get_config("zamba2-1.2b")
    cache = TPlanCache()
    with t_use_context(plan_cache=cache):
        warm = plan_model(cfg, batch=4, prompt_len=128, max_len=145)
        assert warm["signatures"] == warm["solved"] > 0
        keys = {k[1:4] for k in cache.warm_keys}
        assert (512, 2048, 8384) in keys and (4, 2048, 8384) in keys
        before = cache.stats.snapshot()
        with cache.expect_steady_state("zamba2 serving"):
            params = TM.init(cfg, device="meta")
            st = TM.init_decode_state(cfg, 4, 145, device="meta")
            toks = torch.empty((4, 128), dtype=torch.int64, device="meta")
            _, st = TM.prefill(params, {"tokens": toks}, cfg, st)
            TM.decode_step(params, toks[:, :1], cfg, st)
        assert cache.stats.lazy_solves == before.lazy_solves
        assert cache.stats.misses == before.misses


@pytest.mark.parametrize("quant", [None, "int8"])
def test_full_width_launch_counts_on_meta(monkeypatch, quant):
    """The kernels zamba2-1.2b's path reaches at batch 4, prompt 128 (the
    chip smoke's phase 10), counted per call on the meta device: 38 Mamba
    layers of 2 projections, 7 shared-block calls (layers 0, 6, ..., 36)
    of 7 GEMMs and the unembed. Prefill: all on the fat GEMM but the
    last-token unembed (GEMV); a decode step: the shared block's gate
    (silu) fat, every other projection on the GEMV. int8: every GEMM on
    the fat GEMM (out_scale), the unembed dynamic."""
    counts = {"matmul": 0, "gemv": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(TMM, "matmul", spy("matmul", TMM.matmul))
    monkeypatch.setattr(TMV, "decode_matvec", spy("gemv", TMV.decode_matvec))
    cfg = TC.get_config("zamba2-1.2b")
    with t_use_context(hw="h100", plan_cache=TPlanCache(), quant_mode=quant):
        params = TM.init(cfg, device="meta")
        if quant:
            params = TP.quantize_params(params)
        state = TM.init_decode_state(cfg, 4, 129, device="meta")
        TM.prefill(params, {"tokens": torch.empty(
            (4, 128), dtype=torch.int64, device="meta")}, cfg, state)
        first = dict(counts)
        TM.decode_step(params, torch.empty((4, 1), dtype=torch.int64,
                                           device="meta"), cfg, state)
    step = {k: counts[k] - first[k] for k in counts}
    if quant:
        assert first == step == {"matmul": 2 * 38 + 7 * 7 + 1, "gemv": 0}
    else:
        assert first == {"matmul": 2 * 38 + 7 * 7, "gemv": 1}
        assert step == {"matmul": 7, "gemv": 2 * 38 + 7 * 6 + 1}


# ------------------------------------------------------------ refusals
def test_engine_entry_points_refuse_the_hybrid_family(zamba):
    """As the reference: no per-slot or paged state, no chunked prefill,
    no verify pass, no active mask, no engine step factory."""
    rcfg, tcfg, rp, tp = zamba
    z = lambda *s: torch.zeros(s, dtype=torch.int64)
    for pkg, cfg, dev in ((RM, rcfg, {}), (TM, tcfg, {"device": "cpu"})):
        with pytest.raises(ValueError, match="hybrid"):
            pkg.init_decode_state(cfg, 2, 8, per_slot=True, **dev)
        with pytest.raises(ValueError, match="hybrid"):
            pkg.init_decode_state(cfg, 2, 8, per_slot=True, kv_block_size=4,
                                  num_kv_blocks=4, **dev)
    st = TM.init_decode_state(tcfg, 2, 8, device="cpu")
    rst = RM.init_decode_state(rcfg, 2, 8)
    for fn, kw in ((TM.prefill_chunk, dict(slot=z(), start=z(),
                                           true_len=z(), blocks=z(2))),
                   (TM.verify_step, {}), (TM.decode_step, {"active": z(2)})):
        with pytest.raises(ValueError, match="hybrid"):
            fn(tp, z(2, 1), tcfg, st, **kw)
    for fn, kw in ((RM.prefill_chunk, dict(slot=0, start=0, true_len=1,
                                           blocks=jnp.zeros(2, jnp.int32))),
                   (RM.verify_step, {}),
                   (RM.decode_step, {"active": jnp.ones(2, jnp.int32)})):
        with pytest.raises(ValueError, match="hybrid"):
            fn(rp, jnp.zeros((2, 1), jnp.int32), rcfg, rst, **kw)
    for make in (
            lambda: servestep.make_engine_step(tcfg, max_len=16,
                                               prompt_pad=8, device="cpu"),
            lambda: servestep.make_paged_engine_step(
                tcfg, max_len=16, kv_block_size=4, num_kv_blocks=8,
                chunk_buckets=(4,), device="cpu"),
            lambda: servestep.make_spec_step(tcfg, tcfg, max_len=16,
                                             prompt_pad=8, spec_k=2,
                                             device="cpu"),
            lambda: TS.ServeEngine(tcfg, tp, num_slots=2, max_len=16,
                                   prompt_pad=8),
            lambda: TS.ServeEngine(tcfg, tp, num_slots=2, max_len=16,
                                   prompt_pad=8, kv_block_size=4)):
        with pytest.raises(ValueError, match="hybrid"):
            make()
