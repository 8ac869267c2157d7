"""The port's dense LM against the reference's, on the CPU, from the same
weights (``interop.params_from_jax``).

Variants of qwen1.5-4b-smoke (2 layers, d_model 64):
* ``f32``  — as ``smoke()`` gives it (f32 activations);
* ``tied``, ``relu2`` — the smoke configs of the other dense archs at f32:
  command-r-plus (tied embeddings: the unembed is the col-layout GEMM on
  the (V, d) table; GQA with 2 KV heads) and nemotron-4 (non-gated
  squared-ReLU MLP, the activation in the GEMM epilogue);
* ``bf16`` — bf16 activations, f32 weights: every projection is the mixed
  bf16 x f32 GEMM of the real config;
* ``wide`` — bf16, d_model 256, head_dim 64, d_ff 512, prompt 72: wide
  enough that decode's wo / w_in / w_out / unembed take the GEMV kernel's
  path (K >= 256) and prefill's take the fat kernel's (M = 144 > 128).

The reference runs under ``matmul_backend="interpret"``, so its Pallas
kernel bodies execute. Tolerances: with f32 activations both sides compute
in f32 and differ only in summation order (rtol = atol = 1e-4 on the
logits after 2 layers); with bf16 activations an intermediate may round to
the neighbouring bf16 value on one side and the flip propagates, so the
logits are held to the repo's bf16 kernel tolerance, rtol = atol = 5e-2.
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
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch import models as TM
from repro_torch.core import gemm as TG
from repro_torch.core.context import use_context as t_use_context
from repro_torch.core.plancache import PlanCache as TPlanCache
from repro_torch.launch.serve import serve_batch


def _cfg(variant: str):
    arch = {"tied": "command-r-plus-104b", "relu2": "nemotron-4-15b"}.get(
        variant, "qwen1.5-4b")
    base = RC.smoke(RC.get_config(arch))
    if variant == "bf16":
        base = dataclasses.replace(base, activation_dtype="bfloat16")
    elif variant == "wide":
        base = dataclasses.replace(base, activation_dtype="bfloat16",
                                   d_model=256, head_dim=64, d_ff=512)
    return base, TC.ModelConfig(**dataclasses.asdict(base))


PROMPT = {"f32": 8, "tied": 8, "relu2": 8, "bf16": 8, "wide": 72}
TOL = {"f32": 1e-4, "tied": 1e-4, "relu2": 1e-4, "bf16": 5e-2, "wide": 5e-2}


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
    rcfg = RC.get_config("qwen1.5-4b")
    if arch_variant == "smoke":
        rcfg = RC.smoke(rcfg)
    tcfg = TC.ModelConfig(**dataclasses.asdict(rcfg))
    shapes = jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0), rcfg))
    want = {_jax_path(p): (tuple(x.shape), x.dtype.name)
            for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {p: (tuple(t.shape), TC.dtype_name(t.dtype))
           for p, t in interop.tree_items(TM.init(tcfg, device="meta"))}
    assert got == want
    assert TM.param_count(TM.init(tcfg, device="meta")) == sum(
        int(np.prod(s)) for s, _ in want.values())


def test_init_lm_draws_from_its_generator():
    _, tcfg = _cfg("f32")
    a = TM.init(tcfg, seed=3, device="cpu")
    b = TM.init(tcfg, seed=3, device="cpu")
    c = TM.init(tcfg, seed=4, device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    assert float(a["layers"]["attn"].wq.std()) == pytest.approx(
        tcfg.d_model ** -0.5, rel=0.1)


def test_interop_round_trip_is_exact():
    rcfg, tcfg = _cfg("bf16")
    rparams, tparams = _weights(rcfg, tcfg)
    back = dict(interop.tree_items(interop.tree_map(
        lambda t: t.float().numpy(), tparams)))
    for p, x in jax.tree_util.tree_flatten_with_path(rparams)[0]:
        np.testing.assert_array_equal(back[_jax_path(p)],
                                      np.asarray(x, np.float32))
    broken = jax.tree.map(np.asarray, rparams)
    del broken["unembed"]
    with pytest.raises(ValueError, match="missing"):
        interop.params_from_jax(broken, tcfg, "cpu")


@pytest.mark.parametrize("variant", ["f32", "tied", "relu2", "bf16", "wide"])
def test_prefill_and_decode_match_reference(variant):
    rcfg, tcfg = _cfg(variant)
    B, S, steps = 2, PROMPT[variant], 4
    rparams, tparams = _weights(rcfg, tcfg)
    tokens = np.random.default_rng(7).integers(0, rcfg.vocab_size, (B, S))
    tol = TOL[variant]
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
        tlog, tstate = TM.prefill(tparams, {"tokens": torch.from_numpy(
            tokens)}, tcfg, tstate)
        got = [tlog.numpy()]
        for tok in fed:
            tlog, tstate = TM.decode_step(tparams, torch.from_numpy(
                tok[:, None].astype(np.int64)), tcfg, tstate)
            got.append(tlog.numpy())
    assert tstate["kv"].length == S + steps
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, rcfg.padded_vocab)
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def test_serve_batch_greedy_tokens_match_reference():
    rcfg, tcfg = _cfg("f32")
    B, S, gen = 2, 8, 6
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
        got = serve_batch(tcfg, tparams, torch.from_numpy(prompts),
                          gen_len=gen, max_len=S + gen + 1)
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))


@pytest.mark.parametrize("variant", ["f32", "wide"])
def test_plan_model_signatures_match_reference(variant):
    rcfg, tcfg = _cfg(variant)
    kw = dict(batch=4, prompt_len=PROMPT[variant], max_len=PROMPT[variant] + 9)
    with r_use_context(plan_cache=RPlanCache()):
        want = RG.plan_model(rcfg, **kw)
    cache = TPlanCache()
    with t_use_context(hw="h100", plan_cache=cache):
        got = TG.plan_model(tcfg, **kw)
        # a second warm-up finds every signature in the cache
        again = TG.plan_model(tcfg, **kw)
    assert got["signatures"] == want["signatures"] == got["solved"]
    assert again == {"signatures": got["signatures"], "solved": 0,
                     "from_cache": got["signatures"]}
    assert cache.stats.lazy_solves == 0


def test_forward_matches_reference():
    rcfg, tcfg = _cfg("f32")
    rparams, tparams = _weights(rcfg, tcfg, seed=2)
    tokens = np.random.default_rng(5).integers(0, rcfg.vocab_size, (2, 40))
    want, _ = RM.forward(rparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                         rcfg)
    with t_use_context(plan_cache=TPlanCache()):
        got, aux = TM.forward(tparams, {"tokens": torch.from_numpy(tokens)},
                              tcfg)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_layer_functions_match_reference():
    """Norms, rotary and the chunked (online-softmax) attention that
    prompts longer than ``attn_chunk`` take, on the same numpy inputs;
    f32 throughout, so only summation order differs (1e-5)."""
    from repro.layers import attention as RA
    from repro.layers import common as RCm
    from repro_torch.layers import attention as TA
    from repro_torch.layers import common as TCm

    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    g, b = rng.normal(size=16).astype(np.float32), rng.normal(
        size=16).astype(np.float32)
    t = torch.from_numpy
    close = lambda got, want: np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    close(TCm.rms_norm(t(x), t(g)), RCm.rms_norm(jnp.asarray(x), g))
    close(TCm.layer_norm(t(x), t(g), t(b)),
          RCm.layer_norm(jnp.asarray(x), g, b))
    pos = np.arange(40)[None, :]
    rs, rc = RCm.rotary_embedding(jnp.asarray(pos), 16, 10000.0)
    ts, tc = TCm.rotary_embedding(t(pos), 16, 10000.0)
    close(ts, rs)
    close(TCm.apply_rotary(t(x), ts, tc), RCm.apply_rotary(
        jnp.asarray(x), rs, rc))
    q, k, v = (rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
               for _ in range(3))
    want = RA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, chunk=16)
    close(TA.chunked_attention(t(q), t(k), t(v), causal=True, chunk=16), want)
    close(TA.attention_core(t(q), t(k), t(v), causal=True, chunk=16), want)
    close(TA.plain_attention(t(q), t(k), t(v), causal=True), want)
