"""The port's training path against the reference's, on the CPU.

* ``core.gemm.balanced_gemm`` under autograd against ``jax.vjp`` of the
  reference's (``backend="xla"``: the reference's Pallas kernels have no
  reverse-mode rule), on every dispatch case: the fat GEMM with a bias,
  with silu and with gelu in the epilogue, the col layout (a tied
  unembed), the f32 out, the skinny GEMV, bf16 and f32 activations; and
  which planned entry point each backward product takes;
* the optimizers (one update each, from the same parameters, gradients
  and state), ``schedule`` and ``clip_by_global_norm``;
* ``data.synthetic``: batches equal to the reference's bit for bit;
* ``lm_loss`` with masked and out-of-range labels, value and gradients;
* the train step from ``interop.state_from_jax``, 5 steps, against the
  reference's ``make_train_step`` on a 1 x 1 local mesh (remat off, full
  and ``remat_policy="dots"``);
* "dots" against "full" and no remat bit for bit, on the dense, hybrid,
  encoder-decoder and vision families, with no product launched again;
* the launches a step makes through the planned entry points (forward,
  the remat recompute and the backward), the rule chip_smoke.py phase 13b
  holds the card to.

Tolerances. f32: both sides compute in f32 from the same inputs in another
summation order, so a result differs by a few ulps of its largest partial
sum: rtol 1e-5 with atol 1e-5 of the leaf's largest magnitude (GEMM
gradients, the optimizers' updates, the loss and its gradients), and over
5 train steps each moment leaf (m, v) within 1e-5 of its largest
magnitude, the losses and gradient norms within rtol 1e-5. A parameter
leaf gets 1e-5 of its largest magnitude plus 1e-2 of the sum of the
learning rates: Adam divides each gradient element by its own RMS, so an
element whose gradient is small against its leaf's largest carries the
leaf-scale summation error, relatively larger, into a step of size lr
(qwen's key bias moved 6.4e-8 against a 4.5e-5 sum of learning rates).
bf16: an output rounded to bf16 may land on the neighbouring value, one
bf16 ulp = 2**-7 of the largest magnitude.
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
from repro.data import synthetic as RS
from repro.launch.mesh import make_local_mesh
from repro.train import optimizer as RO
from repro.train.trainstep import make_train_step as r_make_train_step
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch import models as TM
from repro_torch.core import gemm as TG
from repro_torch.core.context import use_context
from repro_torch.core.plancache import PlanCache
from repro_torch.data import synthetic as TS
from repro_torch.kernels import build, wkv
from repro_torch.train import optimizer as TO
from repro_torch.train.trainstep import make_train_step, microbatch_count

JNP = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}
TORCH = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _t(x: np.ndarray, dtype: str) -> torch.Tensor:
    return interop.to_tensor(np.asarray(jnp.asarray(x, JNP[dtype])), "cpu")


def _close(got, want, dtype: str, what: str = "") -> None:
    got = got.detach().double().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    peak = max(1e-30, float(np.abs(want).max()))
    if dtype == "bfloat16":
        atol, rtol = 2.0 ** -7 * max(1.0, peak), 0.0
    else:
        atol, rtol = 1e-5 * peak, 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _through_gemm_fn(t: torch.Tensor) -> bool:
    """``t``'s graph reaches the balanced GEMM's autograd Function (behind
    the reshape of the leading dims)."""
    fn = t.grad_fn
    while fn is not None and type(fn).__name__ != "_BalancedGemmBackward":
        fn = fn.next_functions[0][0] if fn.next_functions else None
    return fn is not None


# --------------------------------------------------------- balanced_gemm
# (M, K, N): fat shapes have M > 128; the skinny one takes the GEMV
# (M <= 128, K >= 256, N >= 128, no epilogue) forward and for its dA
GEMM_CASES = {
    "bias": dict(shape=(2, 80, 96, 160), bias=True),
    "silu": dict(shape=(2, 80, 96, 160), activation="silu"),
    "gelu_bias": dict(shape=(2, 80, 96, 160), bias=True, activation="gelu"),
    "col_f32_out": dict(shape=(2, 80, 96, 200), layout="col",
                        out="float32"),
    "f32_out": dict(shape=(2, 80, 96, 160), out="float32"),
    "skinny": dict(shape=(1, 8, 256, 384)),
}


@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(GEMM_CASES))
def test_balanced_gemm_gradients_match_jax(case, act_dtype, monkeypatch):
    c = GEMM_CASES[case]
    B, S, K, N = c["shape"]
    layout = c.get("layout", "row")
    out = c.get("out", act_dtype)
    rng = np.random.default_rng(7)
    a = rng.standard_normal((B, S, K)).astype(np.float32)
    b = (rng.standard_normal((N, K) if layout == "col" else (K, N))
         * K ** -0.5).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32) if c.get("bias") \
        else None
    ct = rng.standard_normal((B, S, N)).astype(np.float32)
    kw = dict(b_layout=layout, activation=c.get("activation"))

    def rfn(a, b, bias):
        return RG.balanced_gemm(a, b, bias, out_dtype=JNP[out],
                                backend="xla", **kw)

    ra = jnp.asarray(a, JNP[act_dtype])
    args = (ra, jnp.asarray(b), None if bias is None else jnp.asarray(bias))
    want, vjp = jax.vjp(rfn, *args)
    w_da, w_db, w_dbias = vjp(jnp.asarray(ct, JNP[out]))

    calls = {"fat": 0, "gemv": 0}
    for name, key in (("balanced_matmul", "fat"), ("decode_matvec", "gemv")):
        fn = getattr(TG.ops, name)

        def counted(*x, _fn=fn, _key=key, **y):
            calls[_key] += 1
            return _fn(*x, **y)
        monkeypatch.setattr(TG.ops, name, counted)
    ta = _t(a, act_dtype).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    tbias = None if bias is None else torch.from_numpy(bias).requires_grad_()
    with use_context(plan_cache=PlanCache()):
        got = TG.balanced_gemm(ta, tb, tbias, out_dtype=TORCH[out], **kw)
        assert _through_gemm_fn(got)
        forward = dict(calls)
        got.backward(_t(ct, out))
    _close(got, want, out, "value")
    # dA is cast to A's dtype; dB and d_bias stay f32 (the parameters')
    _close(ta.grad, w_da, act_dtype, "dA")
    _close(tb.grad, w_db, "float32", "dB")
    if bias is not None:
        _close(tbias.grad, w_dbias, "float32", "d_bias")
    skinny = case == "skinny"
    epilogue = bias is not None or c.get("activation") is not None
    assert forward == ({"fat": 0, "gemv": 1} if skinny
                       else {"fat": 1, "gemv": 0})
    # backward: dA (the GEMV when skinny), dB, and the recomputed
    # pre-activation of an activation epilogue
    back = {"fat": 1 + (c.get("activation") is not None),
            "gemv": 0}
    back["gemv" if skinny and not epilogue else "fat"] += 1
    assert {k: calls[k] - forward[k] for k in calls} == back


def test_backward_runs_under_the_forward_context():
    """Autograd runs the backward of CUDA tensors (and the remat recompute)
    on a device thread of its own, which the GEMM context does not reach:
    here the backward runs on another thread, and every plan it asks for,
    the recomputed layers' and the backward products', lands in the
    forward's plan cache under the forward's hw."""
    import threading

    _, tcfg = _pair(remat=True)
    params = TM.init(tcfg, device="cpu")
    for _, p in interop.tree_items(params):
        p.requires_grad_(True)
    batch = {k: torch.as_tensor(v) for k, v in
             TS.batch_for(tcfg, 32, 2, 0).items()}
    batch["tokens"] = batch["tokens"].long()
    default = TG.current_context().plan_cache
    before = len(default.entries)
    with use_context(hw="tpu_v5e", plan_cache=PlanCache()) as ctx:
        hidden, aux = TM.forward(params, batch, tcfg)
        loss = TM.lm_loss(params, hidden, batch["labels"], tcfg) + aux
        forward_keys = set(ctx.plan_cache.entries)
    seen = []
    TG.add_dispatch_listener(lambda key, plan: seen.append(key))
    try:
        t = threading.Thread(target=loss.backward)
        t.start()
        t.join()
    finally:
        TG._dispatch_listeners.clear()
    assert len(default.entries) == before
    assert seen and set(seen) <= set(ctx.plan_cache.entries)
    assert set(ctx.plan_cache.entries) > forward_keys  # dA, dB signatures
    assert {k[0] for k in seen} == {"tpu_v5e"}
    assert all(p.grad is not None for _, p in interop.tree_items(params))


def test_balanced_gemm_refuses_out_scale_under_grad():
    a = torch.randn(4, 64, requires_grad=True)
    b = torch.randn(64, 128)
    with pytest.raises(ValueError, match="out_scale"):
        TG.balanced_gemm(a, b, out_scale=torch.ones(128))
    with torch.no_grad():  # inference: the int8 path as before
        TG.balanced_gemm(a, b, out_scale=torch.ones(128))


def test_no_grad_forward_is_unchanged():
    """The Function's forward is today's dispatch, bit for bit."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((130, 96)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((96, 160)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(160).astype(np.float32))
    with use_context(plan_cache=PlanCache()):
        plain = TG.balanced_gemm(a, b, bias, activation="silu")
        graded = TG.balanced_gemm(a.requires_grad_(), b, bias,
                                  activation="silu")
    assert _through_gemm_fn(graded)
    assert torch.equal(plain, graded.detach())


def test_kernel_wrappers_refuse_autograd():
    """The CUDA branch of the GEMM wrappers calls this before a launch
    (the WKV wrappers take :class:`WkvFn` under autograd instead): a
    tensor that requires grad under grad mode raises (chip_smoke.py phase
    13 checks the raise on the card); under no_grad, or with no input
    requiring grad, it passes."""
    x = torch.ones(2, requires_grad=True)
    why = "call core.gemm.balanced_gemm, whose backward launches the kernels"
    with pytest.raises(RuntimeError, match="balanced_gemm"):
        build.refuse_autograd("matmul kernel", (x, None), why)
    with torch.no_grad():
        build.refuse_autograd("matmul kernel", (x,), why)
    build.refuse_autograd("matmul kernel", (x.detach(),), why)


def test_wkv_heads_on_cpu_stays_differentiable():
    B, T, H, N = 1, 32, 2, 16
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(B, T, H, N, generator=g, requires_grad=True)
               for _ in range(3))
    log_w = -torch.rand(B, T, H, N, generator=g)
    y, s = wkv.wkv_heads(r, k, v, log_w, torch.randn(H, N, generator=g),
                         torch.zeros(B, H, N, N))
    (y.sum() + s.sum()).backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (r, k, v))


# --------------------------------------------------------- optimizers
def _opt_tree(rng):
    return {"w": rng.standard_normal((16, 24)).astype(np.float32),
            "b": rng.standard_normal(24).astype(np.float32),
            "stack": rng.standard_normal((3, 8, 12)).astype(np.float32)}


OPT_CASES = {
    "adamw": RO.OptConfig(warmup_steps=2),
    "adafactor": RO.OptConfig(name="adafactor", b1=0.0,
                              state_dtype="bfloat16", warmup_steps=2),
    "adafactor_momentum": RO.OptConfig(name="adafactor", b1=0.9,
                                       warmup_steps=2),
    "adamw_clipped": RO.OptConfig(grad_clip=0.5, warmup_steps=2),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_updates_match_reference(case):
    rcfg = OPT_CASES[case]
    tcfg = TO.OptConfig(**dataclasses.asdict(rcfg))
    rng = np.random.default_rng(11)
    params = _opt_tree(rng)
    ropt, topt = RO.make_optimizer(rcfg), TO.make_optimizer(tcfg)
    rp = jax.tree.map(jnp.asarray, params)
    rstate = ropt.init(rp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = topt.init(tp)
    for step in range(2):
        grads = {k: (rng.standard_normal(v.shape) * 3).astype(np.float32)
                 for k, v in params.items()}
        rp, rstate, rnorm = ropt.update(
            rp, jax.tree.map(jnp.asarray, grads), rstate,
            jnp.asarray(step, jnp.int32))
        tp, tstate, tnorm = topt.update(
            tp, {k: torch.from_numpy(v.copy()) for k, v in grads.items()},
            tstate, torch.tensor(step, dtype=torch.int32))
        np.testing.assert_allclose(float(tnorm), float(rnorm), rtol=1e-6)
    want = {"params": rp, "opt": rstate}
    got = interop.tree_map(lambda t: t, {"params": tp, "opt": tstate})
    wl = dict((p, x) for p, x in _jax_items(want))
    for path, t in interop.tree_items(got):
        dt = "bfloat16" if t.dtype == torch.bfloat16 else "float32"
        _close(t, wl[path], dt, path)


def _jax_items(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    key = lambda k: str(getattr(k, "key", getattr(k, "name", getattr(
        k, "idx", k))))
    return [("/".join(key(k) for k in path), x) for path, x in flat]


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 400])
def test_schedule_matches_reference(step):
    cfg = RO.OptConfig()
    want = float(RO.schedule(cfg, jnp.asarray(step, jnp.int32)))
    got = float(TO.schedule(TO.OptConfig(), torch.tensor(step)))
    np.testing.assert_allclose(got, want, rtol=1e-7)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = _opt_tree(np.random.default_rng(5))
    rt, rn = RO.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                    max_norm)
    tt, tn = TO.clip_by_global_norm(
        {k: torch.from_numpy(v.copy()) for k, v in tree.items()}, max_norm)
    np.testing.assert_allclose(float(tn), float(rn), rtol=1e-6)
    for k in tree:
        _close(tt[k], rt[k], "float32", k)


# --------------------------------------------------------- data
@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_synthetic_batches_equal_reference(hosts):
    kw = dict(vocab_size=503, seq_len=24, global_batch=8, seed=3)
    rsrc = RS.SyntheticLM(RS.DataConfig(**kw))
    tsrc = TS.SyntheticLM(TS.DataConfig(**kw))
    for step in (0, 1, 7):
        for h in range(hosts):
            want = rsrc.batch(step, host_index=h, host_count=hosts)
            got = tsrc.batch(step, host_index=h, host_count=hosts)
            assert want.keys() == got.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    s0, b0 = next(tsrc.batches(5))
    assert s0 == 5
    np.testing.assert_array_equal(b0["tokens"], rsrc.batch(5)["tokens"])


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "whisper-base",
                                  "llama-3.2-vision-11b"])
def test_batch_for_equals_reference(arch):
    rcfg = RC.smoke(RC.get_config(arch))
    tcfg = TC.ModelConfig(**dataclasses.asdict(rcfg))
    for step in (0, 3):
        want = RS.batch_for(rcfg, 16, 4, step, seed=1)
        got = TS.batch_for(tcfg, 16, 4, step, seed=1)
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# --------------------------------------------------------- lm_loss
def _pair(arch="qwen1.5-4b", **over):
    rcfg = dataclasses.replace(RC.smoke(RC.get_config(arch)), **over)
    return rcfg, TC.ModelConfig(**dataclasses.asdict(rcfg))


@pytest.mark.parametrize("S", [64, 40])  # 2 chunks of 32; one of 40
def test_lm_loss_matches_reference(S):
    rcfg, tcfg = _pair()
    rparams = RM.init(jax.random.PRNGKey(0), rcfg)
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, rparams),
                                      tcfg, "cpu")
    rng = np.random.default_rng(9)
    hidden = rng.standard_normal((2, S, rcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, rcfg.vocab_size, (2, S)).astype(np.int32)
    labels[0, :5] = -1                       # masked
    labels[1, :3] = rcfg.vocab_size          # padded-vocab ids: masked
    labels[1, 3:5] = rcfg.padded_vocab + 7   # beyond the table: clipped
    rl = lambda h, u: RM.lm_loss({**rparams, "unembed": u}, h,
                                 jnp.asarray(labels), rcfg)
    want, (wh, wu) = jax.value_and_grad(rl, argnums=(0, 1))(
        jnp.asarray(hidden), rparams["unembed"])
    th = torch.from_numpy(hidden).requires_grad_()
    tu = tparams["unembed"].requires_grad_()
    with use_context(plan_cache=PlanCache()):
        got = TM.lm_loss({**tparams, "unembed": tu}, th,
                         torch.from_numpy(labels), tcfg)
        got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    _close(th.grad, wh, "float32", "d_hidden")
    _close(tu.grad, wu, "float32", "d_unembed")


def _count_gemms(monkeypatch) -> dict[str, int]:
    """The planned entry points' calls (the kernels' launches on a card)."""
    calls = {"fat": 0, "gemv": 0}
    for name, key in (("balanced_matmul", "fat"), ("decode_matvec", "gemv")):
        fn = getattr(TG.ops, name)

        def counted(*x, _fn=fn, _key=key, **y):
            calls[_key] += 1
            return _fn(*x, **y)
        monkeypatch.setattr(TG.ops, name, counted)
    return calls


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "zamba2-1.2b",
                                  "whisper-base", "llama-3.2-vision-11b"])
def test_remat_dots_equals_full_bit_for_bit(arch, monkeypatch):
    """``remat_policy="dots"`` (the products' outputs kept, the rest
    recomputed) gives the loss and every leaf's gradient of "full" remat
    and of no remat bit for bit, and its backward launches no forward
    product again: its launches are no remat's, "full"'s less one forward
    of the layers' products (the loss chunks' unembed is recomputed under
    every policy, as the reference's ``jax.checkpoint`` of its loss scan
    does)."""
    from repro_torch.data import synthetic as TSyn
    _, tcfg = _pair(arch)
    params = TM.init(tcfg, seed=3, device="cpu")
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in TSyn.batch_for(tcfg, 32, 2, 0).items()}
    calls = _count_gemms(monkeypatch)
    out, launches, forward = {}, {}, {}
    for policy in ("off", "full", "dots"):
        cfg = dataclasses.replace(tcfg, remat=policy != "off",
                                  remat_policy="full" if policy == "off"
                                  else policy)
        p = interop.tree_map(lambda t: t.detach().clone().requires_grad_(),
                             params)
        calls.update(fat=0, gemv=0)
        with use_context(plan_cache=PlanCache()):
            hidden, aux = TM.forward(p, batch, cfg)
            forward[policy] = dict(calls)
            loss = TM.lm_loss(p, hidden, batch["labels"], cfg) + aux
            loss.backward()
        launches[policy] = dict(calls)
        out[policy] = (loss.detach(), {
            k: torch.zeros_like(t) if t.grad is None else t.grad
            for k, t in interop.tree_items(p)})
    for policy in ("full", "dots"):
        assert torch.equal(out[policy][0], out["off"][0]), policy
        for k, g in out["off"][1].items():
            assert torch.equal(out[policy][1][k], g), (policy, k)
    assert launches["dots"] == launches["off"]
    again = {k: launches["full"][k] - launches["dots"][k] for k in calls}
    assert again == forward["full"] and sum(again.values()) > 0, again


def test_remat_refuses_an_unknown_policy():
    _, tcfg = _pair(remat=True, remat_policy="selective")
    params = TM.init(tcfg, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with torch.no_grad():  # serving: no remat, no refusal
        TM.forward(params, {"tokens": tokens}, tcfg)
    with pytest.raises(ValueError, match="selective"):
        TM.forward(params, {"tokens": tokens}, tcfg)


# --------------------------------------------------------- train step
STEP_CASES = {
    "qwen": ("qwen1.5-4b", {}),
    "qwen_remat": ("qwen1.5-4b", {"remat": True}),
    "qwen_remat_dots": ("qwen1.5-4b", {"remat": True,
                                       "remat_policy": "dots"}),
    "qwen_microbatches": ("qwen1.5-4b", {"microbatches": 2}),
    "olmoe": ("olmoe-1b-7b", {}),
}
STEPS, BATCH, SEQ = 5, 4, 32


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_reference(case):
    arch, over = STEP_CASES[case]
    rcfg, tcfg = _pair(arch, **over)
    mesh = make_local_mesh(data=1, model=1)
    rart = r_make_train_step(rcfg, mesh, global_batch=BATCH, seq_len=SEQ)
    with mesh:
        rstate = rart.init_fn(jax.random.PRNGKey(0))
    tstate = interop.state_from_jax(jax.tree.map(np.asarray, rstate), tcfg,
                                    "cpu")
    tart = make_train_step(tcfg, global_batch=BATCH, seq_len=SEQ,
                           device="cpu")
    assert microbatch_count(tcfg, BATCH) == over.get("microbatches", 1)
    lrs = []
    with use_context(plan_cache=PlanCache()):
        for step in range(STEPS):
            batch = RS.batch_for(rcfg, SEQ, BATCH, step)
            with mesh:
                rstate, rm = rart.step_fn(
                    rstate, {k: jnp.asarray(v) for k, v in batch.items()})
            tstate, tm = tart.step_fn(tstate, batch)
            for k in ("loss", "ce", "aux", "grad_norm"):
                np.testing.assert_allclose(float(tm[k]), float(rm[k]),
                                           rtol=1e-5, atol=1e-7,
                                           err_msg=f"step {step} {k}")
            assert int(tm["step"]) == int(rm["step"]) == step
            lrs.append(float(RO.schedule(RO.OptConfig(), jnp.asarray(step))))
    assert int(tstate["step"]) == STEPS
    want = dict(_jax_items({"params": rstate["params"],
                            "opt": rstate["opt"]}))
    got = dict(interop.tree_items({"params": tstate["params"],
                                   "opt": tstate["opt"]}))
    assert got.keys() == want.keys()
    for path, t in got.items():
        w = np.asarray(want[path], np.float64)
        d = np.abs(t.detach().double().numpy() - w).max()
        lim = 1e-5 * np.abs(w).max()
        if path.startswith("params"):
            lim += 1e-2 * sum(lrs)
        assert d <= lim, (path, d, lim)
    assert all(t.grad is None for _, t in interop.tree_items(
        tstate["params"]))


def _launch_rule(cfg, M: int, remat: bool, chunks: int) -> dict[str, int]:
    """Planned GEMM calls of one step of a dense qwen-style model (q, k, v
    with bias, wo, the SwiGLU gate with silu, w_in, w_out; untied unembed)
    with M rows a step: the forward (a layer's 7 and the unembed per loss
    chunk), the remat recompute (the layers if ``remat``, and every loss
    chunk), the backward (dA and dB of each, and the gate's recomputed
    pre-activation). Decode-shaped (M <= 128 and K, N wide): wo, w_in,
    w_out and the unembed go to the GEMV forward and every dA there."""
    L = cfg.n_layers
    skinny = M <= 128 and cfg.d_model >= 256
    fwd_fat, fwd_gemv = (4, 3) if skinny else (7, 0)
    head = {"gemv": 1, "fat": 0} if skinny else {"gemv": 0, "fat": 1}
    fwd = {"fat": L * fwd_fat + chunks * head["fat"],
           "gemv": L * fwd_gemv + chunks * head["gemv"]}
    rec = {k: (L * (fwd_fat if k == "fat" else fwd_gemv) if remat else 0)
           + chunks * head[k] for k in fwd}
    # backward: 7 dB + the gate recompute fat; 7 dA (GEMV when skinny);
    # the unembed's dA and dB
    bwd = {"fat": L * (8 + (0 if skinny else 7)) + chunks * (1 if skinny
                                                              else 2),
           "gemv": (L * 7 + chunks) if skinny else 0}
    return {k: fwd[k] + rec[k] + bwd[k] for k in fwd}


@pytest.mark.parametrize("batch,seq,remat", [(2, 80, True), (1, 64, True),
                                             (1, 64, False), (2, 80, "dots"),
                                             (1, 64, "dots")])
def test_train_step_launch_rule(batch, seq, remat, monkeypatch):
    """The planned entry points a step calls, against the rule; at d_model
    256 the GEMV's K >= 256 holds, so batch 1 x 64 takes it. "dots": the
    layers' products are not launched again (the rule without remat)."""
    _, tcfg = _pair(d_model=256, head_dim=64, d_ff=512, remat=bool(remat),
                    remat_policy="dots" if remat == "dots" else "full",
                    loss_chunk=64)
    calls = _count_gemms(monkeypatch)
    art = make_train_step(tcfg, global_batch=batch, seq_len=seq,
                          device="cpu")
    state = art.init_fn(0)
    with use_context(plan_cache=PlanCache()):
        state, m = art.step_fn(state, TS.batch_for(tcfg, seq, batch, 0))
    c = min(tcfg.loss_chunk, seq)
    chunks = seq // c if seq % c == 0 else 1
    assert calls == _launch_rule(tcfg, batch * seq, remat is True, chunks)
    assert np.isfinite(float(m["loss"]))
