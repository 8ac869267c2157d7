"""Training the rwkv, hybrid, encoder-decoder, vision and MoE families with
the port, on the CPU, against the reference.

* The WKV recurrence's gradient: ``torch.autograd.grad`` through the
  port's ``kernels.wkv.wkv_heads`` (on the CPU its plain version, whose
  autograd gradient is ``wkv_bwd_ref``, the backward kernel's plain
  version) against ``jax.vjp`` of the reference's
  ``repro.layers.rwkv.wkv_chunk_parallel``, from the same numpy inputs: T
  = 64 and 96, a nonzero initial state, a loss on y and on the final
  state, and decays that reach the ``min(., 60)`` clamp;
* the backward kernel's algebra (``csrc/wkv.cu`` ``wkv_bwd_kernel``: the
  chunks in reverse from the forward's chunk-start states, dS carried,
  the log decay's gradient as a reverse exclusive cumsum) in plain torch,
  against ``wkv_bwd_ref`` in f64, and :class:`WkvFn`'s plumbing (layouts,
  the saved states, du summed over b, bf16 gradients, an unused final
  state) with that algebra standing in for the kernels;
* 5 AdamW steps from ``interop.state_from_jax`` against the reference's
  ``make_train_step``: rwkv at seq 32 (the token scan) and 64 (the chunked
  WKV), zamba2 at seq 32 and 128 (the reference's chunked, checkpointed
  SSM scan), whisper, vision with and without remat;
* remat on and off give the same loss and gradients bit for bit (whisper,
  vision); the launcher takes a step of every family; the rwkv step's
  launches through the planned GEMM entry points and the WKV wrapper
  against ``chip_smoke.py``'s rule, which phases 20b and 20c hold the
  card to.

Tolerances. The WKV gradient: f32 on both sides in another order, 2e-4 of
each gradient's peak (the forward's tolerance, ``tests/test_kernels_wkv.py``).
The train steps as ``tests/test_torch_train.py`` holds qwen (1e-5: the
loss, the gradient norm and each moment leaf relative to its peak; a
parameter leaf 1e-5 of its peak plus 1e-2 of the summed learning rates),
except rwkv's gradient-derived numbers: evaluated in f64 (the port with
every f32 widened, the reference under ``jax_enable_x64``) the two sides'
gradients agree to 2.1e-13 of each leaf's peak, but in f32 each side lies
up to 3.5e-4 (the reference) and 1.5e-4 (the port) from that value at seq
32, both on the channel-mix's ``wr`` (``tools/rwkv_grad_f64.py``; PERF.md
section 6): rounding, not a departure. So an rwkv gradient, its norm and
Adam's m are held to 5e-4 (both sides' departures added) and v, a
squared gradient, to 1e-3. The loss agrees to 1e-5 on every family.

Whisper's unrotated key biases (the encoder's self-attention and the
decoder's cross-attention: no rope): a key bias adds the same q . bk to
every score of a row, which the softmax takes away, so the port's gradient
is exactly 0 and the reference's ~1e-11 from rounding: the departure
documented in ROADMAP section 3. Their moments are asserted exactly 0
and their parameters moved by the weight decay alone; every other leaf
is held to the reference.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import configs as RC
from repro.data import synthetic as RS
from repro.launch.mesh import make_local_mesh
from repro.layers import rwkv as RR
from repro.train import optimizer as RO
from repro.train.trainstep import make_train_step as r_make_train_step
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch import models as TM
from repro_torch.core import gemm as TG
from repro_torch.core.context import use_context
from repro_torch.core.plancache import PlanCache
from repro_torch.data import synthetic as TS
from repro_torch.kernels import wkv as TK
from repro_torch.launch import train as launch_train
from repro_torch.train.trainstep import make_train_step

C = TK.CHUNK
WKV_TOL = 2e-4


def _peak_close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    peak = max(1e-30, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * peak, (what, err, tol * peak)


# ------------------------------------------------- the WKV gradient
def _wkv_inputs(B, H, T, N, seed, clamp=False):
    """(B, T, H, N) r, k, v, log decay; u (H, N); state (B, H, N, N); the
    cotangents of y and of the final state. ``clamp``: decays of e^-4 to
    e^-6 a step in the second half of every chunk, so that mid - ci
    passes 60 there (the clamp acts) while the first half stays mild."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    r, k, v = f(B, T, H, N), f(B, T, H, N), f(B, T, H, N)
    wl = -np.exp(rng.uniform(-6, 1, size=(B, T, H, N)))
    if clamp:
        strong = -np.exp(rng.uniform(1.4, 1.8, size=(B, T, H, N)))
        wl = np.where((np.arange(T) % C >= C // 2)[None, :, None, None],
                      strong, wl)
    u = f(H, N) * 0.3
    s0 = f(B, H, N, N) * 0.1
    return (r, k, v, wl.astype(np.float32), u, s0, f(B, T, H, N),
            f(B, H, N, N))


def _clamp_acts(wl) -> bool:
    """Whether min(mid - ci, 60) clips anywhere (the (B, T, H, N) log
    decay, chunk by chunk)."""
    B, T, H, N = wl.shape
    w = wl.reshape(B, T // C, C, H, N).astype(np.float64)
    ci = np.cumsum(w, axis=2)
    mid = (ci - w)[:, :, C // 2][:, :, None]
    return bool((mid - ci > 60).any())


@pytest.mark.parametrize("T,clamp", [(64, False), (96, False), (64, True),
                                     (96, True)])
def test_wkv_gradient_matches_reference(T, clamp):
    B, H, N = 2, 2, 16
    r, k, v, wl, u, s0, gy, gs = _wkv_inputs(B, H, T, N, seed=T + clamp,
                                             clamp=clamp)
    assert _clamp_acts(wl) == clamp
    bh = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    _, vjp = jax.vjp(lambda *a: RR.wkv_chunk_parallel(*a, chunk=C),
                     bh(r), bh(k), bh(v), bh(wl), jnp.asarray(u),
                     jnp.asarray(s0))
    want = vjp((bh(gy), jnp.asarray(gs)))
    want = [np.asarray(w.transpose(0, 2, 1, 3)) if w.ndim == 4 and
            w.shape[1] == H and w.shape[2] == T else np.asarray(w)
            for w in want]
    xs = [torch.from_numpy(x).requires_grad_() for x in (r, k, v, wl, u, s0)]
    y, s = TK.wkv_heads(*xs)
    got = torch.autograd.grad((y, s), xs, (torch.from_numpy(gy),
                                           torch.from_numpy(gs)))
    for name, g, w in zip(("r", "k", "v", "log_w", "u", "state"), got, want):
        assert tuple(g.shape) == w.shape, name
        _peak_close(g, w, WKV_TOL, name)


# ------------------------------------------- the backward kernel's algebra
def _bwd_algebra(r, k, v, wl, u, states, dy, ds):
    """``csrc/wkv.cu``'s backward on the (BH, T, N) layout: the chunks in
    reverse, each from its chunk-start state ``states[:, c]``, every tile
    recomputed, dS carried, the log decay's gradient as a reverse
    exclusive cumsum of its per-step terms. Returns what ``wkv_bwd_ref``
    returns."""
    BH, T, N = r.shape
    dr, dk, dv, dwl = (torch.zeros_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    dS = torch.zeros_like(states[:, 0]) if ds is None else ds.clone()
    lower = torch.tril(torch.ones(C, C, dtype=r.dtype), -1)
    for c in reversed(range(T // C)):
        sl = slice(c * C, (c + 1) * C)
        R, K, V, W, DY = (x[:, sl] for x in (r, k, v, wl, dy))
        S = states[:, c]
        cl = torch.cumsum(W, 1) - W
        ci = cl + W
        ce, mid = ci[:, -1:], cl[:, C // 2:C // 2 + 1]
        xki, xkd = mid - ci, ce - ci
        re, rm = R * torch.exp(cl), R * torch.exp(cl - mid)
        ki = K * torch.exp(torch.clamp(xki, max=60.0))
        kd = K * torch.exp(torch.clamp(xkd, max=0.0))
        A = torch.einsum("btn,bsn->bts", rm, ki) * lower
        dA = torch.einsum("btm,bsm->bts", DY, V) * lower
        D = (R * u[:, None] * K).sum(-1, keepdim=True)
        dD = (DY * V).sum(-1, keepdim=True)
        dre = torch.einsum("btm,bnm->btn", DY, S)
        dkd = torch.einsum("bsm,bnm->bsn", V, dS)
        drm = torch.einsum("bts,bsn->btn", dA, ki)
        dki = torch.einsum("bts,btn->bsn", dA, rm)
        dv[:, sl] = (torch.einsum("bts,btm->bsm", A, DY) + D * DY
                     + torch.einsum("bsn,bnm->bsm", kd, dS))
        dr[:, sl] = (dre * torch.exp(cl) + drm * torch.exp(cl - mid)
                     + dD * u[:, None] * K)
        dk[:, sl] = (dki * torch.exp(torch.clamp(xki, max=60.0))
                     + dkd * torch.exp(torch.clamp(xkd, max=0.0))
                     + dD * u[:, None] * R)
        du += (dD * R * K).sum(1)
        gki = torch.where(xki <= 60, dki * ki, 0.0)
        gkd = torch.where(xkd <= 0, dkd * kd, 0.0)
        dci = -gki - gkd
        dce = (torch.exp(ce[:, 0]) * (S * dS).sum(-1) + gkd.sum(1))
        dmid = (gki - drm * rm).sum(1)
        step = dre * re + drm * rm + dci       # d cl, with ci = cl + wl
        after = torch.flip(torch.cumsum(torch.flip(step, [1]), 1), [1]) - step
        first = (torch.arange(C) < C // 2)[None, :, None]
        dwl[:, sl] = dci + after + dce[:, None] + first * dmid[:, None]
        dS = torch.exp(ce[:, 0])[..., None] * dS + torch.einsum(
            "btn,btm->bnm", re, DY)
    return dr, dk, dv, dwl, du, dS


def _chunk_states(r, k, v, wl, u, s0):
    """(BH, T / C, N, N): the state each chunk starts from."""
    out, S = [s0], s0
    for c in range(r.shape[1] // C - 1):
        sl = slice(c * C, (c + 1) * C)
        _, S = TK.wkv_ref(r[:, sl], k[:, sl], v[:, sl], wl[:, sl], u, S)
        out.append(S)
    return torch.stack(out, 1)


def _bh_inputs(BH, T, N, seed, dtype=torch.float64, clamp=False):
    B, H = 1, BH
    r, k, v, wl, u, s0, gy, gs = _wkv_inputs(B, H, T, N, seed, clamp)
    bh = lambda x: torch.from_numpy(x).to(dtype).transpose(1, 2).reshape(
        BH, T, N).contiguous()
    return (bh(r), bh(k), bh(v), bh(wl), torch.from_numpy(u).to(dtype),
            torch.from_numpy(s0).to(dtype).reshape(BH, N, N), bh(gy),
            torch.from_numpy(gs).to(dtype).reshape(BH, N, N))


@pytest.mark.parametrize("T,N,clamp,with_ds", [(64, 16, False, True),
                                               (96, 32, True, True),
                                               (64, 16, True, False)])
def test_backward_algebra_matches_wkv_bwd_ref(T, N, clamp, with_ds):
    r, k, v, wl, u, s0, dy, ds = _bh_inputs(3, T, N, seed=T + N,
                                            clamp=clamp)
    ds = ds if with_ds else None
    want = TK.wkv_bwd_ref(r, k, v, wl, u, s0, dy, ds)
    got = _bwd_algebra(r, k, v, wl, u, _chunk_states(r, k, v, wl, u, s0),
                       dy, ds)
    for name, g, w in zip(("r", "k", "v", "wl", "u", "state"), got, want):
        _peak_close(g, w.double(), 1e-12, name)


def _fake_kernels(monkeypatch):
    """``_launch`` and ``_launch_bwd`` replaced by CPU versions that read
    and write their tensors through the strides the wrappers pass (the
    plain forward chunk by chunk, the backward's algebra)."""
    def rows(t, st, B, H, T, N):
        return torch.as_strided(t, (B, H, T, N), (*st, 1),
                                t.storage_offset())

    def launch(r, k, v, wl, u, state, y, s_out, *, B, H, T, N, strides,
               ms, states=None):
        rr, kk, vv, ww, yy = (rows(t, st, B, H, T, N)
                              for t, st in zip((r, k, v, wl, y), strides))
        flat = lambda t: t.float().reshape(B * H, T, N)
        uu = u.reshape(-1, N)[torch.arange(B * H) % u.reshape(-1, N).shape[0]]
        S = state.reshape(B * H, N, N).float()
        if states is not None:
            states.view(B * H, T // C, N, N).copy_(_chunk_states(
                flat(rr), flat(kk), flat(vv), flat(ww), uu, S))
        y_, s_ = TK.wkv_ref(flat(rr), flat(kk), flat(vv), flat(ww), uu, S)
        yy.copy_(y_.reshape(B, H, T, N))
        s_out.copy_(s_.reshape(s_out.shape))
        TK.launches += 1

    def launch_bwd(r, k, v, wl, u, states, dy, ds, grads, du_rows, ds0, *,
                   B, H, T, N, strides):
        ins = [rows(t, st, B, H, T, N).float().reshape(B * H, T, N)
               for t, st in zip((r, k, v, wl, dy), strides)]
        uu = u.reshape(-1, N)[torch.arange(B * H) % u.reshape(-1, N).shape[0]]
        out = _bwd_algebra(*ins[:4], uu, states.reshape(B * H, T // C, N, N),
                           ins[4], None if ds is None else
                           ds.reshape(B * H, N, N))
        for g, o in zip(grads, out[:4]):
            rows(g, strides[5], B, H, T, N).copy_(o.reshape(B, H, T, N))
        du_rows.copy_(out[4].reshape(B, H, N))
        if ds0 is not None:
            ds0.copy_(out[5].reshape(ds0.shape))
        TK.bwd_launches += 1

    monkeypatch.setattr(TK, "_launch", launch)
    monkeypatch.setattr(TK, "_launch_bwd", launch_bwd)


@pytest.mark.parametrize("heads,dtype,with_ds,state_grad", [
    (True, torch.float32, True, True), (True, torch.bfloat16, True, False),
    (False, torch.float32, False, True)])
def test_wkv_function_plumbing(monkeypatch, heads, dtype, with_ds,
                               state_grad):
    """:class:`WkvFn` with the kernels replaced by their algebra on the
    CPU: the gradients autograd gets back equal ``wkv_bwd_ref``'s (bf16
    inputs: theirs rounded to bf16), in each input's dtype and shape."""
    _fake_kernels(monkeypatch)
    B, H, T, N = 2, 3, 64, 16
    r, k, v, wl, u, s0, gy, gs = (torch.from_numpy(x) for x in _wkv_inputs(
        B, H, T, N, seed=5))
    if not heads:
        bh = lambda x: x.transpose(1, 2).reshape(B * H, T, N).contiguous()
        r, k, v, wl, gy = map(bh, (r, k, v, wl, gy))
        u = u[None].expand(B, H, N).reshape(B * H, N).contiguous()
        s0, gs = s0.reshape(B * H, N, N), gs.reshape(B * H, N, N)
    r, k, v = (x.to(dtype) for x in (r, k, v))
    xs = [x.clone().requires_grad_(i != 5 or state_grad)
          for i, x in enumerate((r, k, v, wl, u, s0))]
    before = (TK.launches, TK.bwd_launches)
    y, s = TK.WkvFn.apply(*xs, heads, None)
    outs, cots = ((y, s), (gy, gs)) if with_ds else ((y,), (gy,))
    need = [x for x in xs if x.requires_grad]
    got = torch.autograd.grad(outs, need, cots)
    assert (TK.launches, TK.bwd_launches) == (before[0] + 1, before[1] + 1)
    plain = [x.detach().float().requires_grad_(x.requires_grad) for x in xs]
    y2, s2 = (TK.wkv_heads if heads else TK.wkv)(*plain)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    want = torch.autograd.grad((y2, s2) if with_ds else (y2,),
                               [x for x in plain if x.requires_grad], cots)
    for g, w, x in zip(got, want, need):
        assert g.dtype == x.dtype and g.shape == x.shape
        tol = 2.0 ** -8 if g.dtype == torch.bfloat16 else 1e-5
        _peak_close(g.float().numpy(), w.numpy(), tol)


# ------------------------------------------------------------ train steps
def _pair(arch, **over):
    rcfg = dataclasses.replace(RC.smoke(RC.get_config(arch)), **over)
    return rcfg, TC.ModelConfig(**dataclasses.asdict(rcfg))


def _jax_items(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    key = lambda k: str(getattr(k, "key", getattr(k, "name", getattr(
        k, "idx", k))))
    return [("/".join(key(k) for k in path), x) for path, x in flat]


# arch, config overrides, seq, tolerance of gradient-derived numbers (the
# gradient norm and Adam's m; v takes twice it)
STEP_CASES = {
    "rwkv_seq32": ("rwkv6-3b", {}, 32, 5e-4),
    "rwkv_seq64": ("rwkv6-3b", {}, 64, 5e-4),
    "zamba2": ("zamba2-1.2b", {}, 32, 1e-5),
    # T % 64 == 0 and T > 64: the reference's chunked, checkpointed scan
    "zamba2_seq128": ("zamba2-1.2b", {}, 128, 1e-5),
    "whisper": ("whisper-base", {}, 32, 1e-5),
    "vision": ("llama-3.2-vision-11b", {}, 32, 1e-5),
    "vision_remat": ("llama-3.2-vision-11b", {"remat": True}, 32, 1e-5),
}
STEPS, BATCH = 5, 4
# the documented departure (ROADMAP section 3): the port's gradient of
# these leaves is exactly 0
ZERO_GRAD = {"whisper": ("encoder/attn/bk", "decoder/cross/bk")}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_reference(case):
    arch, over, seq, tol = STEP_CASES[case]
    rcfg, tcfg = _pair(arch, **over)
    mesh = make_local_mesh(data=1, model=1)
    rart = r_make_train_step(rcfg, mesh, global_batch=BATCH, seq_len=seq)
    with mesh:
        rstate = rart.init_fn(jax.random.PRNGKey(0))
    tstate = interop.state_from_jax(jax.tree.map(np.asarray, rstate), tcfg,
                                    "cpu")
    tart = make_train_step(tcfg, global_batch=BATCH, seq_len=seq,
                           device="cpu")
    lrs = []
    with use_context(plan_cache=PlanCache()):
        for step in range(STEPS):
            batch = RS.batch_for(rcfg, seq, BATCH, step)
            with mesh:
                rstate, rm = rart.step_fn(
                    rstate, {k: jnp.asarray(v) for k, v in batch.items()})
            tstate, tm = tart.step_fn(tstate, batch)
            for k, rtol in (("loss", 1e-5), ("ce", 1e-5), ("aux", 1e-5),
                            ("grad_norm", tol)):
                np.testing.assert_allclose(float(tm[k]), float(rm[k]),
                                           rtol=rtol, atol=1e-7,
                                           err_msg=f"step {step} {k}")
            lrs.append(float(RO.schedule(RO.OptConfig(), jnp.asarray(step))))
    want = dict(_jax_items({"params": rstate["params"],
                            "opt": rstate["opt"]}))
    got = dict(interop.tree_items({"params": tstate["params"],
                                   "opt": tstate["opt"]}))
    assert got.keys() == want.keys()
    zero = ZERO_GRAD.get(case, ())
    for path, t in got.items():
        t = t.detach().double().numpy()
        w = np.asarray(want[path], np.float64)
        if path.endswith(zero) and zero:
            if path.startswith("opt"):   # m and v of a zero gradient
                assert not t.any(), path
            continue
        if path.startswith("params"):
            lim = 1e-5 * np.abs(w).max() + 1e-2 * sum(lrs)
        else:
            lim = (2 * tol if "/v/" in f"/{path}/" else tol) * np.abs(w).max()
        assert np.abs(t - w).max() <= lim, (path, np.abs(t - w).max(), lim)
    if zero:   # the parameter moved by the decoupled weight decay alone
        from repro_torch.train import optimizer as TO
        wd = TO.OptConfig().weight_decay
        init = dict(interop.tree_items(interop.state_from_jax(
            jax.tree.map(np.asarray, rart.init_fn(jax.random.PRNGKey(0))),
            tcfg, "cpu")["params"]))
        for path, t in interop.tree_items(tstate["params"]):
            if path.endswith(zero):
                want_p = init[path].double().numpy() * np.prod(
                    [1 - lr * wd for lr in lrs])
                np.testing.assert_allclose(t.detach().double().numpy(),
                                           want_p, rtol=1e-6, atol=0)


# ------------------------------------------------------------------ remat
@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-11b"])
def test_remat_gives_the_same_gradients_bit_for_bit(arch):
    _, tcfg = _pair(arch)
    params = TM.init(tcfg, seed=3, device="cpu")
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in TS.batch_for(tcfg, 32, 2, 0).items()}
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        p = interop.tree_map(lambda t: t.detach().clone().requires_grad_(),
                             params)
        with use_context(plan_cache=PlanCache()):
            hidden, aux = TM.forward(p, batch, cfg)
            loss = TM.lm_loss(p, hidden, batch["labels"], cfg) + aux
            loss.backward()
        # a leaf off the graph (whisper's detached unrotated key biases)
        # has no .grad: the step takes it as zeros
        out[remat] = (loss.detach(), {
            k: torch.zeros_like(t) if t.grad is None else t.grad
            for k, t in interop.tree_items(p)})
    assert torch.equal(out[False][0], out[True][0])
    for k, g in out[False][1].items():
        assert torch.equal(g, out[True][1][k]), k


def test_remat_recomputes_each_layer(monkeypatch):
    """With remat the backward runs each encoder and decoder layer's
    forward again (whisper) and each group's (vision): the attention
    calls a step makes double."""
    from repro_torch.layers import attention as attn
    calls = {"n": 0}
    real = attn.self_attention

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)
    monkeypatch.setattr(attn, "self_attention", counted)
    for arch, per_pass in (("whisper-base", 2 + 2), ("llama-3.2-vision-11b",
                                                     2)):
        _, tcfg = _pair(arch)
        params = TM.init(tcfg, device="cpu")
        batch = {k: torch.from_numpy(np.asarray(v))
                 for k, v in TS.batch_for(tcfg, 32, 2, 0).items()}
        for remat, want in ((False, per_pass), (True, 2 * per_pass)):
            calls["n"] = 0
            cfg = dataclasses.replace(tcfg, remat=remat)
            p = interop.tree_map(lambda t: t.requires_grad_(), params)
            with use_context(plan_cache=PlanCache()):
                hidden, _ = TM.forward(p, batch, cfg)
                hidden.float().sum().backward()
            assert calls["n"] == want, (arch, remat, calls["n"])
            with torch.no_grad():   # serving: no remat, one pass
                calls["n"] = 0
                TM.forward(params, batch, cfg)
                assert calls["n"] == per_pass


# --------------------------------------------------------------- launcher
@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b", "whisper-base",
                                  "llama-3.2-vision-11b", "olmoe-1b-7b"])
def test_launcher_trains_every_family_on_the_cpu(arch, tmp_path):
    out = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--plan-cache", "", "--steps", "2",
                             "--batch", "2", "--seq", "64",
                             "--ckpt-every", "0", "--record-out",
                             str(tmp_path / "rec.pt")])
    assert len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"])) and all(
        np.isfinite(out["grad_norms"]))
    rec = torch.load(tmp_path / "rec.pt")
    assert set(rec["launches"]) == {"matmul", "gemv", "wkv", "wkv_bwd"}


# ------------------------------------------------------ the rwkv launches
def _rwkv_rule(cfg, batch: int, seq: int, remat: bool) -> dict[str, int]:
    """``chip_smoke.py``'s rule for phases 20b and 20c, held here on the
    CPU: the planned GEMM calls of one rwkv step and the WKV's launches."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke._rwkv_train_rule(cfg, batch, seq, remat)


@pytest.mark.parametrize("batch,remat", [(4, False), (4, True), (2, True)])
def test_rwkv_train_step_launch_rule(batch, remat, monkeypatch):
    """The planned entry points one rwkv step calls at d_model 256 (so the
    GEMV's K >= 256 holds for w_lora_b's dB, as at full width; 2
    microbatches of batch / 2 x 128 rows: at 128 the forward's products
    with no epilogue and their dA take the GEMV too), and the WKV wrapper:
    one call a layer a pass (forward, and remat's recompute)."""
    _, tcfg = _pair("rwkv6-3b", d_model=256, n_heads=4, n_kv_heads=4,
                    head_dim=64, d_ff=512, remat=remat, microbatches=2)
    calls = {"fat": 0, "gemv": 0, "wkv": 0}
    for mod, name, key in ((TG.ops, "balanced_matmul", "fat"),
                           (TG.ops, "decode_matvec", "gemv"),
                           (TK, "wkv_heads", "wkv")):
        fn = getattr(mod, name)

        def counted(*x, _fn=fn, _key=key, **y):
            calls[_key] += 1
            return _fn(*x, **y)
        monkeypatch.setattr(mod, name, counted)
    art = make_train_step(tcfg, global_batch=batch, seq_len=128,
                          device="cpu")
    state = art.init_fn(0)
    with use_context(plan_cache=PlanCache()):
        state, m = art.step_fn(state, TS.batch_for(tcfg, 128, batch, 0))
    want = _rwkv_rule(tcfg, batch, 128, remat)
    assert calls == {"fat": want["matmul"], "gemv": want["gemv"],
                     "wkv": want["wkv"]}
    assert want["wkv"] == 2 * tcfg.n_layers * (2 if remat else 1)
    assert want["wkv_bwd"] == 2 * tcfg.n_layers and want["gemv"] > 0
    assert np.isfinite(float(m["loss"]))


# -------------------------------------------- an f32-activation step's tiles
@pytest.mark.parametrize("M,K,N,act", [(128, 2560, 8960, "relu"),
                                       (256, 2560, 8960, "relu"),
                                       (128, 2560, 2560, None)])
def test_f32_backward_tiles_fit_the_card(M, K, N, act, monkeypatch):
    """A product with f32 activations under grad, on the h100 plans: every
    fat-kernel launch of its forward and backward (the pre-activation's
    recompute too) takes a tile whose shared memory fits a block's, and the
    recompute takes the forward's tile. At 128 rows with an activation
    (rwkv's channel-mix ``wk`` in an f32 step) the recompute once took the
    unsolved default tile (128, 512, 128), 528 KB on the CUDA cores."""
    from repro_torch.core.hwregistry import get_hw
    from repro_torch.kernels import matmul as TMM

    tiles, real = [], TMM.matmul

    def spy(a, b, *x, bm, bk, bn, b_layout="row", **y):
        r = TMM.route(a.shape[0], a.dtype, b.dtype, b_layout)
        tiles.append((r, (bm, bk, bn), TMM.smem_bytes(r, bm, bk, bn,
                                                      b.dtype)))
        return real(a, b, *x, bm=bm, bk=bk, bn=bn, b_layout=b_layout, **y)

    monkeypatch.setattr(TMM, "matmul", spy)
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(M, K, generator=gen).requires_grad_()
    b = (torch.randn(K, N, generator=gen) / K**0.5).requires_grad_()
    with use_context(hw="h100", plan_cache=PlanCache()):
        out = TG.balanced_gemm(a, b, activation=act)
        n_fwd = len(tiles)
        out.sum().backward()
    have = get_hw("h100").vmem_bytes
    assert tiles and all(need <= have for _, _, need in tiles), tiles
    if act is not None:
        assert n_fwd == 1 and tiles[1][:2] == tiles[0][:2], tiles
    want = torch.relu(a @ b) if act else a @ b
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4)
