"""The port's vision family (llama-3.2-vision: groups of self-attention
layers and one tanh-gated cross-attention layer over precomputed image
embeddings) against the reference's, on the CPU, from the same
numpy-seeded inputs and the same weights (``interop.params_from_jax``).

The reference's init sets both gates of every cross layer to zero, so a
cross layer then adds exactly nothing to the logits and a parity test at
init could not see it. Every parity test here sets ``gate_attn`` and
``gate_mlp`` to the same nonzero values (drawn from the test's seed) in
both trees; the launcher keeps the reference's zeros.

* llama-3.2-vision-11b-smoke (4 layers: 2 groups of 1 self layer + 1
  cross layer; 8 image tokens, d 64): the parameter tree, forward,
  prefill + 3 decode steps (logits, the KV cache and ``img``), the
  chunked cross branch (40 image tokens in chunks of 32: a ragged last
  chunk), image embeddings moving the logits, and the int8 path, at 1e-4
  (f32 activations, ``tests/test_torch_encdec.py``'s); the launcher's
  greedy tokens, f32 and int8.
* The published width on the meta device: ``plan_model(extras=)`` leaves
  no lazy solve, and the kernels the chip smoke's launch rule counts.
* Two-level stacked weights quantize per group and layer, one slice at a
  time, bit for bit as the whole leaf at once.
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
from repro_torch.models import vision_lm as TV
from repro_torch.quant import int8 as TQ
from repro_torch.quant import prequant as TP
from repro_torch.train import servestep

TOL = 1e-4         # LM logits, f32
ARCH = "llama-3.2-vision-11b"

t = torch.from_numpy


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _cfg(**kw):
    base = dataclasses.replace(RC.smoke(RC.get_config(ARCH)), **kw)
    return base, TC.ModelConfig(**dataclasses.asdict(base))


def _gated(rp, rcfg, seed):
    """The reference's tree with both gates of every cross layer set to
    nonzero values from ``seed`` (|tanh(gate)| >= 0.46)."""
    rng = np.random.default_rng(seed)
    G = rcfg.n_layers // rcfg.cross_attn_every
    gate = lambda: jnp.asarray(rng.uniform(0.5, 1.5, G)
                               * rng.choice([-1.0, 1.0], G), jnp.float32)
    cross = {**rp["groups"]["cross"], "gate_attn": gate(),
             "gate_mlp": gate()}
    return {**rp, "groups": {**rp["groups"], "cross": cross}}


def _pair(rcfg, tcfg, seed):
    rp = _gated(RM.init(jax.random.PRNGKey(seed), rcfg), rcfg, seed)
    return rp, interop.params_from_jax(jax.tree.map(np.asarray, rp), tcfg,
                                       "cpu")


@pytest.fixture(scope="module")
def vision():
    rcfg, tcfg = _cfg()
    return (rcfg, tcfg, *_pair(rcfg, tcfg, 1))


def _i(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64))


def _batch(rcfg, rng, B, S):
    toks = rng.integers(0, rcfg.vocab_size, (B, S))
    img = rng.standard_normal((B, rcfg.n_image_tokens, rcfg.d_model)).astype(
        np.float32)
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "image_embeds": jnp.asarray(img)},
            {"tokens": _i(toks), "image_embeds": t(img)})


_r_prefill = jax.jit(RM.prefill, static_argnums=(2,))
_r_decode = jax.jit(RM.decode_step, static_argnums=(2,))


# ------------------------------------------------------------ the tree
def test_params_tree_matches_reference(vision):
    """The port's own init against the reference's tree (paths, shapes,
    dtypes; gates zeros), and the converted tree's two levels."""
    rcfg, tcfg, rp, tp = vision
    G, n_self = TV.group_dims(tcfg)
    assert (G, n_self) == (2, 1)
    own = dict(interop.tree_items(TM.init(tcfg, seed=0, device="cpu")))
    ref = dict(interop.tree_items(jax.tree.map(
        np.asarray, RM.init(jax.random.PRNGKey(0), rcfg))))
    assert own.keys() == ref.keys()
    for path, a in own.items():
        assert tuple(a.shape) == ref[path].shape, path
        assert str(a.dtype).removeprefix("torch.") == str(ref[path].dtype)
    for g in ("gate_attn", "gate_mlp"):
        assert torch.equal(own[f"groups/cross/{g}"], torch.zeros(G))
        assert tuple(tp["groups"]["cross"][g].shape) == (G,)
        assert bool((tp["groups"]["cross"][g].abs() >= 0.5).all())
    assert tuple(tp["groups"]["self"]["mlp"].w_in.shape) == (
        G, n_self, tcfg.d_model, tcfg.d_ff)
    assert tuple(tp["groups"]["cross"]["attn"].wk.shape) == (
        G, tcfg.d_model, tcfg.n_kv_heads * tcfg.head_dim)
    bad = jax.tree.map(np.asarray, rp)
    bad["groups"]["cross"]["gate_mlp"] = np.zeros((G + 1,), np.float32)
    with pytest.raises(ValueError, match="gate_mlp"):
        interop.params_from_jax(bad, tcfg, "cpu")


def test_forward_matches_reference(vision):
    rcfg, tcfg, rp, tp = vision
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


def test_prefill_and_decode_match_reference(vision):
    rcfg, tcfg, rp, tp = vision
    rb, tb = _batch(rcfg, np.random.default_rng(1), 3, 8)
    got, want, ts, rs = _prefill_decode(rcfg, tcfg, rp, tp, rb, tb, 3, 12)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    _close(got, want, TOL)
    assert int(ts["kv"].length) == int(rs["kv"].length) == 11
    assert tuple(ts["kv"].k.shape) == rs["kv"].k.shape == (2, 1, 3, 12, 2,
                                                           16)
    _close(ts["img"], rs["img"], TOL)
    _close(ts["kv"].k, rs["kv"].k, TOL)
    _close(ts["kv"].v, rs["kv"].v, TOL)


def test_chunked_cross_branch_matches_reference():
    """40 image tokens in chunks of 32: every cross layer (prefill and each
    decode step) takes the chunked form with a ragged last chunk."""
    rcfg, tcfg = _cfg(n_image_tokens=40, attn_chunk=32)
    rp, tp = _pair(rcfg, tcfg, 3)
    rb, tb = _batch(rcfg, np.random.default_rng(3), 2, 6)
    got, want, _, _ = _prefill_decode(rcfg, tcfg, rp, tp, rb, tb, 2, 9)
    _close(got, want, TOL)


def test_image_embeds_move_the_logits(vision):
    """With nonzero gates other image embeddings move the logits; with the
    reference's zero gates they cannot (tanh(0) * y is exactly 0)."""
    rcfg, tcfg, rp, tp = vision
    _, tb = _batch(rcfg, np.random.default_rng(2), 2, 6)
    other = {**tb, "image_embeds": tb["image_embeds"] + 1.0}
    zero = dict(tp, groups={**tp["groups"], "cross": {
        **tp["groups"]["cross"],
        "gate_attn": torch.zeros_like(tp["groups"]["cross"]["gate_attn"]),
        "gate_mlp": torch.zeros_like(tp["groups"]["cross"]["gate_mlp"])}})
    with t_use_context(plan_cache=TPlanCache()):
        a, b = (TM.forward(tp, x, tcfg)[0] for x in (tb, other))
        assert (a - b).abs().max().item() > 1e-2
        a, b = (TM.forward(zero, x, tcfg)[0] for x in (tb, other))
        assert torch.equal(a, b)


def test_int8_logits_match_reference(vision):
    """The prequantized tree (self and cross attention and MLPs of every
    group; the gates, norms, embed and unembed stay float) under
    quant_mode="int8": the scales equal the reference's, the logits within
    TOL."""
    rcfg, tcfg, rp, tp = vision
    rq, tq = RP.quantize_params(rp), TP.quantize_params(tp)
    n_q = sum(a.dtype == torch.int8 for _, a in interop.tree_items(tq))
    assert n_q == 4 + 3 + 4 + 3   # self attn, mlp; cross attn, mlp
    assert tq["groups"]["cross"]["gate_attn"].dtype == torch.float32
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


def test_two_level_leaves_quantize_slice_by_slice():
    """A (G, n_self, K, N) weight quantizes one (K, N) slice at a time:
    equal, bit for bit, to each slice quantized alone and to the whole
    leaf's per-channel quantization."""
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 3, 40, 24)).astype(np.float32))
    w[1, 2, :, 5] = 0.0   # an all-zero channel keeps scale 1.0
    got = TQ.quantize_linear(w)
    assert tuple(got.w_q.shape) == (2, 3, 24, 40)
    assert tuple(got.w_scale.shape) == (2, 3, 24)
    assert got.w_q.is_contiguous()
    whole = TQ._safe_scale(w.abs().amax(dim=-2))
    assert torch.equal(got.w_scale, whole)
    assert torch.equal(got.w_q, TQ.quantize(w, whole[..., None, :])
                       .transpose(-1, -2))
    for g in range(2):
        for j in range(3):
            one = TQ.quantize_linear(w[g, j])
            assert torch.equal(got.w_q[g, j], one.w_q)
            assert torch.equal(got.w_scale[g, j], one.w_scale)
    assert float(got.w_scale[1, 2, 5]) == 1.0


# ------------------------------------------------------------ the launcher
def _first_row(capsys) -> list[int]:
    out = capsys.readouterr().out
    row = re.search(r"first row: \[([^\]]*)\]", out).group(1)
    return [int(v) for v in row.split()]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_launcher_tokens_match_reference(monkeypatch, capsys, quant):
    """Both launchers on llama-3.2-vision-11b-smoke from the reference's
    weights (its ``PRNGKey(0)``, gates zero, carried into the port's
    ``models.init``) and the image embeddings each draws after its
    prompts: the first row's greedy tokens, and zero lazy solves."""
    rcfg = RC.smoke(RC.get_config(ARCH))
    tcfg = TC.smoke(TC.get_config(ARCH))
    rp = jax.tree.map(np.asarray, RM.init(jax.random.PRNGKey(0), rcfg))
    argv = ["--arch", ARCH, "--smoke", "--plan-cache", "", "--gen", "6"] + (
        ["--quantize", quant] if quant else [])
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
    for cfg_of in (lambda pkg: pkg.get_config(ARCH),
                   lambda pkg: pkg.smoke(pkg.get_config(ARCH))):
        rcfg, tcfg = cfg_of(RC), cfg_of(TC)
        want = RSS.prefill_input_shapes(rcfg, 4, 128)
        got = servestep.prefill_input_shapes(tcfg, 4, 128)
        assert got.keys() == want.keys() == {"tokens", "image_embeds"}
        for k, (shape, dtype) in got.items():
            assert shape == want[k].shape
            assert str(dtype).removeprefix("torch.") == (
                "int64" if k == "tokens" else str(want[k].dtype))


# ------------------------------------------------------------ full width
def _images(cfg, B=4):
    return {"image_embeds": torch.empty((B, cfg.n_image_tokens, cfg.d_model),
                                        dtype=torch.float32, device="meta")}


@pytest.mark.parametrize("quant", [None, "int8"])
def test_plan_model_with_extras_leaves_no_lazy_solve(quant):
    """llama-3.2-vision-11b at its published width on the meta device:
    plan_model(extras=) traces the cross K/V at M = 4 x 1600 image tokens,
    and prefill and decode then consult only warm plans."""
    cfg = TC.get_config(ARCH)
    cache = TPlanCache()
    with t_use_context(plan_cache=cache, quant_mode=quant):
        params = TM.init(cfg, device="meta")
        if quant:
            params = TP.quantize_params(params)
        warm = plan_model(cfg, batch=4, prompt_len=128, max_len=145,
                          params=params, extras=_images(cfg))
        assert warm["signatures"] == warm["solved"] > 0
        keys = {k[1:4] for k in cache.warm_keys}
        assert {(6400, 4096, 1024), (4, 4096, 128256), (512, 4096, 14336),
                (4, 4096, 14336)} <= keys
        before = cache.stats.snapshot()
        with cache.expect_steady_state("vision serving"):
            st = TM.init_decode_state(cfg, 4, 145, device="meta")
            toks = torch.empty((4, 128), dtype=torch.int64, device="meta")
            _, st = TM.prefill(params, {"tokens": toks, **_images(cfg)},
                               cfg, st)
            TM.decode_step(params, toks[:, :1], cfg, st)
        assert cache.stats.lazy_solves == before.lazy_solves
        assert cache.stats.misses == before.misses


@pytest.mark.parametrize("quant", [None, "int8"])
def test_full_width_launch_counts_on_meta(monkeypatch, quant):
    """llama-3.2-vision-11b's path at batch 4, prompt 128, 1600 image
    tokens (the chip smoke's phase 12), counted per call on the meta
    device. Prefill: 7 fat GEMMs a layer (a self layer's q, k, v, wo and
    MLP at M = 512; a cross layer's q, wo and MLP at 512, its k and v at M
    = 6400), the last-token unembed on the GEMV. A decode step: a self
    layer's gate (silu) fat and q, k, v, wo, w_in, w_out on the GEMV; a
    cross layer's gate and k, v (M = 6400) fat and q, wo, w_in, w_out on
    the GEMV; the unembed on the GEMV. int8: every GEMM fat, the unembed
    dynamic."""
    counts = {"matmul": 0, "gemv": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(TMM, "matmul", spy("matmul", TMM.matmul))
    monkeypatch.setattr(TMV, "decode_matvec", spy("gemv", TMV.decode_matvec))
    cfg = TC.get_config(ARCH)
    with t_use_context(hw="h100", plan_cache=TPlanCache(), quant_mode=quant):
        params = TM.init(cfg, device="meta")
        if quant:
            params = TP.quantize_params(params)
        state = TM.init_decode_state(cfg, 4, 129, device="meta")
        TM.prefill(params, {"tokens": torch.empty(
            (4, 128), dtype=torch.int64, device="meta"), **_images(cfg)},
            cfg, state)
        first = dict(counts)
        TM.decode_step(params, torch.empty((4, 1), dtype=torch.int64,
                                           device="meta"), cfg, state)
    step = {k: counts[k] - first[k] for k in counts}
    if quant:
        assert first == step == {"matmul": 281, "gemv": 0}
    else:
        assert first == {"matmul": 280, "gemv": 1}
        assert step == {"matmul": 32 + 3 * 8, "gemv": 6 * 32 + 4 * 8 + 1}
    # the chip smoke's rule for the whole run: prefill and 16 steps
    run = {k: first[k] + 16 * step[k] for k in counts}
    assert run == ({"matmul": 4777, "gemv": 0} if quant
                   else {"matmul": 1176, "gemv": 3601})


# ------------------------------------------------------------ refusals
def test_lm_entry_points_refuse_the_vision_family(vision):
    rcfg, tcfg, rp, tp = vision
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
    with pytest.raises(ValueError, match="last_pos"):
        TM.prefill(tp, tb, tcfg, ts, last_pos=z())
    for fn, kw in ((TM.prefill_chunk, dict(slot=z(), start=z(),
                                           true_len=z(), blocks=z(2))),
                   (TM.verify_step, {}), (TM.decode_step, {"active": z(2)})):
        with pytest.raises(ValueError, match="vlm"):
            fn(tp, z(2, 1), tcfg, ts, **kw)
    for make in (
            lambda: servestep.make_paged_engine_step(
                tcfg, max_len=16, kv_block_size=4, num_kv_blocks=8,
                chunk_buckets=(4,), device="cpu"),
            lambda: TS.ServeEngine(tcfg, tp, num_slots=2, max_len=16,
                                   prompt_pad=8),
            lambda: TS.ServeEngine(tcfg, tp, num_slots=2, max_len=16,
                                   prompt_pad=8, kv_block_size=4)):
        with pytest.raises(ValueError, match="vlm"):
            make()
