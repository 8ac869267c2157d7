"""Where the rwkv train step's f32 gradient gap between the port and the
reference comes from: each side's per-leaf gradient of the training loss
at rwkv6-3b's smoke config (batch 4, ``data.synthetic`` step 0, the
reference's seed-0 init carried across), in f32 and in f64, each in a
process of its own.

* the reference in f64: ``jax.grad`` under ``jax_enable_x64`` with the
  config's dtypes and every ``jnp.float32`` / ``jnp.int32`` the code
  names widened to 64 bits;
* the port in f64: its plain (CPU) path with ``torch.float32`` and
  ``Tensor.float`` widened to f64 (the GEMMs' plain versions compute in
  ``torch.float32``, so they follow).

Prints, for each sequence length and leaf, the largest difference over
the leaf's f64 peak: port f64 against reference f64 (the same function?),
port f32 and reference f32 against their f64 (each side's rounding), and
port f32 against reference f32 (the gap the train-step test sees).

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/rwkv_grad_f64.py [SEQ ...]

(~1 min for seq 32 and 64.)
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np

ARCH = "rwkv6-3b"
BATCH = 4


def _ref(seq: int, x64: bool, out: str) -> None:
    import jax

    if x64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from repro import configs as RC
    from repro import models as RM
    from repro.data import synthetic as RS
    from repro.train.trainstep import make_loss_fn

    cfg = RC.smoke(RC.get_config(ARCH))
    params = jax.tree.map(np.asarray, RM.init(jax.random.PRNGKey(0), cfg))
    batch = RS.batch_for(cfg, seq, BATCH, 0)
    if x64:
        jnp.float32, jnp.int32 = jnp.float64, jnp.int64
        cfg = dataclasses.replace(cfg, param_dtype="float64",
                                  activation_dtype="float64")
        wide = lambda a: a.astype({np.dtype(np.float32): np.float64,
                                   np.dtype(np.int32): np.int64}.get(
                                       a.dtype, a.dtype))
        params, batch = jax.tree.map(wide, params), jax.tree.map(wide, batch)
    (loss, _), g = jax.value_and_grad(make_loss_fn(cfg, None), has_aux=True)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    flat, _ = jax.tree_util.tree_flatten_with_path(g)
    key = lambda k: str(getattr(k, "key", getattr(k, "name", k)))
    np.savez(out, loss=float(loss), **{
        "/".join(key(k) for k in p): np.asarray(x, np.float64)
        for p, x in flat})


def _port(seq: int, x64: bool, out: str) -> None:
    import jax
    import torch

    from repro import configs as RC
    from repro import models as RM
    from repro_torch import configs as TC
    from repro_torch import interop
    from repro_torch.core.context import use_context
    from repro_torch.core.plancache import PlanCache
    from repro_torch.data import synthetic as TS
    from repro_torch.train.trainstep import make_loss_fn

    rcfg = RC.smoke(RC.get_config(ARCH))
    cfg = TC.ModelConfig(**dataclasses.asdict(rcfg))
    params = interop.params_from_jax(jax.tree.map(np.asarray, RM.init(
        jax.random.PRNGKey(0), rcfg)), cfg, "cpu")
    if x64:
        torch.float32 = torch.float64
        torch.set_default_dtype(torch.float64)
        torch.Tensor.float = lambda self, *a, **k: self.double()
        cfg = dataclasses.replace(cfg, param_dtype="float64",
                                  activation_dtype="float64")
        params = interop.tree_map(
            lambda t: t.double() if t.is_floating_point() else t, params)
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in TS.batch_for(cfg, seq, BATCH, 0).items()}
    params = interop.tree_map(lambda t: t.requires_grad_(), params)
    with use_context(plan_cache=PlanCache()):
        loss, _ = make_loss_fn(cfg)(params, batch)
        loss.backward()
    np.savez(out, loss=float(loss), **{
        k: t.grad.detach().double().numpy()
        for k, t in interop.tree_items(params)})


def main(seqs) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = lambda side, seq, x64: os.path.join(
            tmp, f"{side}_{seq}_{int(x64)}.npz")
        procs = [subprocess.Popen([sys.executable, __file__, "--side", side,
                                   str(seq), str(int(x64)),
                                   path(side, seq, x64)], env=env)
                 for seq in seqs for side in ("ref", "port")
                 for x64 in (False, True)]
        if any(p.wait() for p in procs):
            raise SystemExit("an evaluation failed")
        for seq in seqs:
            d = {f"{side}{int(x64)}": dict(np.load(path(side, seq, x64)))
                 for side in ("ref", "port") for x64 in (False, True)}
            keys = sorted(k for k in d["ref1"] if k != "loss")
            norm = {w: np.sqrt(sum((d[w][k] ** 2).sum() for k in keys))
                    for w in d}
            print(f"seq {seq}: losses " + ", ".join(
                f"{w} {float(d[w]['loss']):.10g}" for w in d)
                + "; gradient norms " + ", ".join(
                    f"{w} {v:.10g}" for w, v in norm.items()))
            print(f"  {'leaf':24s} port64-ref64 port32-port64 ref32-ref64 "
                  "port32-ref32 (of the f64 peak)")
            for k in keys:
                peak = np.abs(d["ref1"][k]).max() or 1.0
                e = lambda a, b: np.abs(d[a][k] - d[b][k]).max() / peak
                print(f"  {k:24s} {e('port1', 'ref1'):12.3g} "
                      f"{e('port0', 'port1'):13.3g} {e('ref0', 'ref1'):11.3g}"
                      f" {e('port0', 'ref0'):12.3g}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--side"]:
        side, seq, x64, out = sys.argv[2:6]
        (_ref if side == "ref" else _port)(int(seq), x64 == "1", out)
    else:
        main([int(s) for s in sys.argv[1:]] or [32, 64])
