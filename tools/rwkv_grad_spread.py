#!/usr/bin/env python3
"""How far rwkv6-3b's bf16 training gradients lie from its f32 ones, and
where the gap arises: the setup of ``chip_smoke.py``'s phase 20c (2 layers
at full width, batch 1 x seq 128, the weights of seed 1, ``data.synthetic``
step 0), the port's plain path on the CPU.

Each run is the loss's gradient (``train.trainstep.make_loss_fn``) with
bf16 or f32 activations. Printed, each leaf as the relative L2 of one
gradient against another (the worst leaves):

* rounding: f32 against f32 with the embedding scaled by 1 + 2^-20, and
  bf16 against bf16 so scaled; each against itself with every GEMM and
  GEMV output perturbed by 2^-18 of itself in f32, before its rounding
  (``chip_smoke._jittered_gemms``: another summation order's f32 error, as
  the card's kernels have), four draws; the bf16 leaves that no draw
  moves by 0.025 or more;
* bf16, and the jittered bf16, against f32: how much of a bf16 gradient
  is rounding;
* where: the WKV output's gradient, bf16 against f32, token by token in
  each layer, and the per-head variance of the WKV output at tokens 0 and
  1 (the group norm's eps is 1e-5);
* the same with the bonus ``u`` set to 0.5 in every layer instead of its
  zero init.

  PYTHONPATH=src python tools/rwkv_grad_spread.py    # ~1 min, ~8 GB
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

import torch

from repro_torch import configs as C
from repro_torch import interop, models
from repro_torch.core.context import use_context
from repro_torch.core.plancache import PlanCache
from repro_torch.data.synthetic import batch_for
from repro_torch.layers import rwkv
from repro_torch.train.trainstep import make_loss_fn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import _jittered_gemms  # noqa: E402

BATCH, SEQ, LAYERS, SEED = 1, 128, 2, 1
JITTER = 2.0**-18


def _grads(base, params0, batch, act, *, scale=1.0, jitter=0.0, seed=0,
           u=None):
    """One loss gradient: (loss, {leaf: f64 gradient}, [per layer: the WKV
    output and its gradient])."""
    cfg = dataclasses.replace(base, activation_dtype=act, remat=False)
    p = interop.tree_map(lambda t: t.clone(), params0)
    p["embed"].mul_(scale)
    if u is not None:
        p["layers"]["tmix"] = p["layers"]["tmix"]._replace(
            u=torch.full_like(p["layers"]["tmix"].u, u))
    for _, t in interop.tree_items(p):
        t.requires_grad_()
    wkv_out, real_heads = [], rwkv.wkv_kernel.wkv_heads

    def heads(*a, **k):
        y, s = real_heads(*a, **k)
        y.retain_grad()
        wkv_out.append(y)
        return y, s

    rwkv.wkv_kernel.wkv_heads = heads
    try:
        with use_context(hw="h100", plan_cache=PlanCache()), (
                _jittered_gemms(torch, jitter, cfg.dtype, seed) if jitter
                else contextlib.nullcontext()):
            loss, _ = make_loss_fn(cfg)(p, batch)
            loss.backward()
    finally:
        rwkv.wkv_kernel.wkv_heads = real_heads
    return (float(loss),
            {k: t.grad.double() for k, t in interop.tree_items(p)},
            [(y.detach().double()[0], y.grad.double()[0]) for y in wkv_out])


def _rel(x, y):
    return ((x - y).norm() / y.norm().clamp_min(1e-300)).item()


def _worst(a, ref, n=5):
    w = sorted(((_rel(a[1][k], ref[1][k]), k) for k in ref[1]), reverse=True)
    return (f"loss {abs(a[0] - ref[0]) / abs(ref[0]):.3g}; "
            + ", ".join(f"{k} {e:.3g}" for e, k in w[:n]))


def main() -> int:
    torch.set_num_threads(8)
    base = dataclasses.replace(C.get_config("rwkv6-3b"), n_layers=LAYERS)
    params0 = models.init(base, seed=SEED, device="cpu")
    batch = {k: torch.as_tensor(v)
             for k, v in batch_for(base, SEQ, BATCH, 0).items()}
    run = lambda act, **k: _grads(base, params0, batch, act, **k)
    f32, bf16 = run("float32"), run("bfloat16")
    show = lambda name, a, ref: print(f"{name}: {_worst(a, ref)}", flush=True)
    show("f32, embedding x (1 + 2^-20) / f32",
         run("float32", scale=1 + 2**-20), f32)
    show("bf16, embedding x (1 + 2^-20) / bf16",
         run("bfloat16", scale=1 + 2**-20), bf16)
    show("bf16 / f32", bf16, f32)
    moved = dict.fromkeys(f32[1], 0.0)  # by the bf16 draws, the most
    for seed in range(4):  # one run at a time: each holds ~4 GB
        show(f"f32, GEMMs jittered (seed {seed}) / f32",
             run("float32", jitter=JITTER, seed=seed), f32)
        j = run("bfloat16", jitter=JITTER, seed=seed)
        show(f"bf16, GEMMs jittered (seed {seed}) / bf16", j, bf16)
        show(f"bf16, GEMMs jittered (seed {seed}) / f32", j, f32)
        moved = {k: max(m, _rel(j[1][k], bf16[1][k]))
                 for k, m in moved.items()}
        del j
    print("bf16 leaves that no draw moves by 0.025 or more: "
          + ", ".join(f"{k} {m:.3g}" for k, m in moved.items() if m < 0.025))
    print("gradient norms f32 / bf16: " + ", ".join(
        f"{k} {f32[1][k].norm():.4g} / {bf16[1][k].norm():.4g}"
        for k in ("layers/tmix/u", "layers/tmix/ln_b", "layers/tmix/mu",
                  "layers/cmix/mu_k")))
    for layer in reversed(range(LAYERS)):
        (y, dy_b), (_, dy_f) = bf16[2][layer], f32[2][layer]
        per_tok = ((dy_b - dy_f).flatten(1).norm(dim=1)
                   / dy_f.flatten(1).norm(dim=1))
        var = y.var(-1, correction=0)  # (T, H)
        print(f"layer {layer} (backward order): the WKV output's gradient, "
              f"bf16 against f32: token 0 {per_tok[0]:.3g}, token 1 "
              f"{per_tok[1]:.3g}, tokens 2+ median {per_tok[2:].median():.3g}"
              f"; its f32 norm token 0 {dy_f[0].norm():.4g}, token 1 "
              f"{dy_f[1].norm():.4g}, tokens 2+ median "
              f"{dy_f[2:].flatten(1).norm(dim=1).median():.4g}; the WKV "
              f"output's per-head variance: token 0 max {var[0].max():.3g}, "
              f"token 1 median {var[1].median():.3g}", flush=True)
    f32u, bf16u = run("float32", u=0.5), run("bfloat16", u=0.5)
    print(f"u = 0.5, bf16 / f32: {_worst(bf16u, f32u)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
